"""K12, HAT's fused LN + CAB convs in the PyTorch port: its plain
version (what the wrapper runs on CPU tensors) against the JAX
package's ``fused_ln_cab_convs`` in interpret mode and its
``_reference``, its gradients against ``jax.vjp``, the kernel's weight
packing emulated in fp32, and HAB's CAB branch through it.  fp32 on the
CPU; bound 3e-5 max abs forward, 2e-4 (x) and 1e-3 (parameters) on
gradients."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import TOL

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(b, h, w, c, cm, seed):
    """Seeded K12 operands in the JAX layout (conv kernels [3, 3, Cin,
    Cout])."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    return dict(x=f(b, h, w, c), g=1 + f(c, sc=0.1), b=f(c, sc=0.1),
                k1=f(3, 3, c, cm, sc=(9 * c) ** -0.5), c1=f(cm, sc=0.1),
                k2=f(3, 3, cm, c, sc=(9 * cm) ** -0.5), c2=f(c, sc=0.1))


_NAMES = ("x", "g", "b", "k1", "c1", "k2", "c2")
# H not a multiple of the JAX kernel's 32-row chunks; Cmid not a
# multiple of 8 (HAT-S's compress 24 gives 6, HAT-SRx4's 60)
_CASES = [((2, 37, 9, 24, 5), "H37-Cmid5"), ((1, 13, 20, 30, 10), "H13-Cmid10"),
          ((1, 40, 7, 18, 6), "H40-Cmid6")]


@pytest.mark.parametrize("shape", [s for s, _ in _CASES], ids=[i for _, i in _CASES])
def test_plain_matches_jax_kernel_and_reference(shape):
    from tpu_superresolution_tpu.ops.pallas import cab_conv as jcc
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels.cab_conv import fused_ln_cab_convs

    a = _case(*shape, seed=sum(shape))
    jargs = [jnp.asarray(a[k]) for k in _NAMES]
    want = np.asarray(jcc.fused_ln_cab_convs(*jargs, interpret=True))
    oracle = np.asarray(jcc._reference(*jargs))
    reset_counters()
    got = fused_ln_cab_convs(*(_t(a[k]) for k in _NAMES)).numpy()
    assert not any(read_counters().values())
    assert got.shape == want.shape == shape[:3] + (shape[3],)
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - oracle).max() <= TOL


def test_gradients_match_jax_vjp():
    """Autograd of the plain version (K12's backward on CUDA) against
    jax.vjp of the JAX kernel's custom_vjp."""
    from tpu_superresolution_tpu.ops.pallas import cab_conv as jcc
    from tpu_superresolution_torch.kernels.cab_conv import fused_ln_cab_convs

    a = _case(2, 37, 9, 24, 5, seed=11)
    ct = np.random.default_rng(12).standard_normal(a["x"].shape).astype(np.float32)
    fn = lambda *p: jcc.fused_ln_cab_convs(*p, interpret=True)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a[k]) for k in _NAMES))
    want = [np.asarray(g) for g in vjp(jnp.asarray(ct))]
    args = [_t(a[k]).requires_grad_() for k in _NAMES]
    fused_ln_cab_convs(*args).backward(_t(ct))
    for k, t, w in zip(_NAMES, args, want):
        bound = 2e-4 if k == "x" else 1e-3
        assert np.abs(t.grad.numpy() - w).max() <= bound, k


def test_autograd_function_backward_is_autograd_of_the_plain_version():
    """CabConvsFunction.backward (what runs after K12 on CUDA), fed a
    context as autograd would: the plain version's gradients, None where
    none is wanted."""
    from tpu_superresolution_torch.kernels.cab_conv import (
        CabConvsFunction,
        fused_ln_cab_convs_plain,
    )

    a = _case(1, 9, 11, 16, 6, seed=13)
    args = [_t(a[k]) for k in _NAMES]
    ct = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(14))
    needs = (True, True, False, True, True, False, True)
    ctx = types.SimpleNamespace(saved_tensors=tuple(args), needs_input_grad=needs)
    got = CabConvsFunction.backward(ctx, ct)
    leaves = [t.clone().requires_grad_(n) for t, n in zip(args, needs)]
    fused_ln_cab_convs_plain(*leaves).backward(ct)
    for i, (g, n) in enumerate(zip(got, needs)):
        if not n:
            assert g is None, i
        else:
            assert torch.allclose(g, leaves[i].grad, atol=1e-6), i


@pytest.mark.parametrize("c,cm", [(180, 60), (96, 32), (144, 6)])
def test_packed_layout_computes_the_plain_function(c, cm):
    """K12's packed operands (tap-major [9 * CK, CMP] and [9 * CMP, CK],
    channels zero-padded to multiples of 16), used as the kernel's
    implicit GEMM uses them and computed in fp32, give the plain
    version's output on bf16-representable weights."""
    import torch.nn.functional as F

    from tpu_superresolution_torch.kernels.cab_conv import fused_ln_cab_convs_plain, pack_cab
    from tpu_superresolution_torch.kernels.layernorm import layernorm_plain

    a = {k: _t(v) for k, v in _case(1, 5, 6, c, cm, seed=c).items()}
    for k in ("k1", "k2"):
        a[k] = a[k].to(torch.bfloat16).float()
    p = pack_cab(a["g"], a["b"], a["k1"], a["c1"], a["k2"], a["c2"])
    ck, cmp = -(-c // 16) * 16, -(-cm // 16) * 16
    assert tuple(p.k1.shape) == (9 * ck, cmp) and tuple(p.k2.shape) == (9 * cmp, ck)

    def conv(t, w, bias, kdim):  # sum over taps of the shifted map times the tap's rows
        tp = F.pad(t, (0, 0, 1, 1, 1, 1))
        h, wd = t.shape[1], t.shape[2]
        out = bias.expand(t.shape[0], h, wd, -1).clone()
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            out = out + tp[:, dy:dy + h, dx:dx + wd] @ w[tap * kdim:(tap + 1) * kdim].float()
        return out

    ln = F.pad(layernorm_plain(a["x"], p.g, p.b), (0, ck - c))
    y1 = F.gelu(conv(ln, p.k1, p.c1, ck))
    got = conv(y1, p.k2, p.c2, cmp)[..., :c]
    want = fused_ln_cab_convs_plain(*(a[k] for k in _NAMES))
    assert (got - want).abs().max() <= 1e-4


def test_hab_cab_branch_is_k12_of_the_pre_norm_input():
    """HAB's CAB branch: the SE gate of K12's function on the pre-norm x
    with HAB's norm1, equal to the reference composition (LN1, conv,
    exact GELU, conv, SE gate) and launching nothing on the CPU."""
    import torch.nn.functional as F

    from tpu_superresolution_torch.core.config import HATConfig, build_model
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.models.blocks import conv_nhwc

    model = build_model(HATConfig(embed_dim=30, depths=(2,), num_heads=(2,), squeeze_factor=6))
    model.reset_parameters(torch.Generator().manual_seed(15))
    hab = model.layers[0].residual_group.blocks[1]
    cab = hab.conv_block
    x = torch.randn(2, 14, 21, 30, generator=torch.Generator().manual_seed(16))
    with torch.no_grad():
        for p in hab.norm1.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(17)))
        reset_counters()
        got = cab(x, hab.norm1)
        assert not any(read_counters().values())
        y = F.gelu(conv_nhwc(cab.cab[0], hab.norm1(x, True)))
        want = cab.cab[3](conv_nhwc(cab.cab[2], y))
        assert (got - want).abs().max() <= TOL
        assert torch.equal(cab(x, hab.norm1, plain=True), got)
