"""K1 with branch scales and K5 (the Swin block backward): the port's
plain versions against the JAX package's ``fused_swin_block`` run in
interpret mode (its custom_vjp backward is ``_mega_backward``, the
Pallas K5), and the plain K5 against autograd of the plain K1.  fp32 on
the CPU; bounds atol 2e-4 / rtol 1e-3 on gradients (the JAX package's
own kernel-vs-vjp bound, tests/test_fused_attention.py) and 3e-5 on the
forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels_plain import _block_params, _port_weights, _t
from tests.util_torchport import TOL

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
SCALES = np.array([[1.25, 0.0], [1.0, 1.25]], np.float32)
B, H, W, WS = 2, 16, 24, 8


def _jax_block(p, shift, gelu_approx, scales):
    """x -> the JAX fused block on x (shift applied around it), as a
    function of (x, 12 weights, gathered bias) for jax.vjp."""
    from tpu_superresolution_tpu.ops.pallas.fused_block import fused_swin_block
    from tpu_superresolution_tpu.ops.window import cyclic_shift, cyclic_unshift, shift_attn_mask

    c = p["wqkv"].shape[0]
    mask = shift_attn_mask(H, W, WS, shift) if shift else None
    scale = (c // p["nh"]) ** -0.5

    def f(x, *args):
        *weights, bias = args
        out = fused_swin_block(cyclic_shift(x, shift), *weights, bias, WS, mask, scale,
                               gelu_approx, interpret=True,
                               branch_scales=None if scales is None else jnp.asarray(scales))
        return cyclic_unshift(out, shift)

    return f


def _gathered_bias(p):
    from tpu_superresolution_tpu.ops.window import relative_position_index

    n = WS * WS
    bias = p["table"][relative_position_index(WS).reshape(-1)].reshape(n, n, -1)
    return np.ascontiguousarray(bias.transpose(2, 0, 1))


_JAX_ORDER = ("g1", "b1", "wqkv", "bqkv", "wproj", "bproj", "g2", "b2",
              "wfc1", "bfc1", "wfc2", "bfc2")


def _as_port(name, g):
    """A JAX gradient of weight `name` in the port's [out, in] layout."""
    g = np.asarray(g)
    return g.T if name in ("wqkv", "wproj", "wfc1", "wfc2") else g


def _assert_close(got, want, what):
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=what)


@pytest.mark.parametrize("scales", [None, SCALES], ids=["no-scales", "scales"])
@pytest.mark.parametrize("gelu_approx", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("shift", [0, 4])
def test_k5_plain_matches_jax_mega_backward(shift, gelu_approx, scales):
    from tpu_superresolution_torch.kernels import fused_block, read_counters, reset_counters
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    rng = np.random.default_rng(100 + shift + 10 * gelu_approx + 20 * (scales is None))
    p = _block_params(rng)
    c = p["wqkv"].shape[0]
    x = rng.standard_normal((B, H, W, c)).astype(np.float32)
    ct = rng.standard_normal((B, H, W, c)).astype(np.float32)
    bias = _gathered_bias(p)
    leaves = [jnp.asarray(x)] + [jnp.asarray(p[k]) for k in _JAX_ORDER] + [jnp.asarray(bias)]
    f = _jax_block(p, shift, gelu_approx, scales)
    out, vjp = jax.vjp(f, *leaves)
    jgrads = vjp(jnp.asarray(ct))

    reset_counters()
    w = _port_weights(p)
    tmask = shift_mask_tensor(H, W, WS, shift, torch.device("cpu")) if shift else None
    tsc = None if scales is None else _t(scales)
    fwd = fused_block.fused_windows_block(_t(x), w, WS, shift, tmask, gelu_approx,
                                          branch_scales=tsc)
    assert np.abs(fwd.numpy() - np.asarray(out)).max() <= TOL
    got = fused_block.fused_swin_block_backward(_t(ct), _t(x), w, WS, shift, tmask,
                                                gelu_approx, branch_scales=tsc)
    assert not any(read_counters().values())  # CPU tensors: the plain versions ran

    _assert_close(got.dx.numpy(), np.asarray(jgrads[0]), "dx")
    for name, g in zip(_JAX_ORDER, jgrads[1:13]):
        _assert_close(getattr(got, name).numpy(), _as_port(name, g), name)
    _assert_close(got.rpb.numpy(), np.asarray(jgrads[13]), "rpb")


@pytest.mark.parametrize("shift", [0, 4])
def test_k5_plain_matches_autograd_of_plain_k1(shift):
    """The explicit chain of swin_block_bwd_plain equals torch autograd
    through swin_block_plain (fp32), table gradient included."""
    from tpu_superresolution_torch.kernels.fused_block import (
        GRAD_FIELDS,
        SwinBlockWeights,
        swin_block_bwd_plain,
        swin_block_plain,
    )
    from tpu_superresolution_torch.ops.window import relative_position_bias, shift_mask_tensor

    rng = np.random.default_rng(7 + shift)
    p = _block_params(rng)
    c = p["wqkv"].shape[0]
    w = _port_weights(p)
    x = _t(rng.standard_normal((B, H, W, c)).astype(np.float32)).requires_grad_()
    ct = _t(rng.standard_normal((B, H, W, c)).astype(np.float32))
    mask = shift_mask_tensor(H, W, WS, shift, torch.device("cpu")) if shift else None
    leaves = {k: getattr(w, k).clone().requires_grad_() for k in GRAD_FIELDS[:-1]}
    table = w.table.clone().requires_grad_()
    wl = SwinBlockWeights(table=table, num_heads=w.num_heads, **leaves)
    out = swin_block_plain(x, wl, WS, shift, mask, False, _t(SCALES))
    out.backward(ct)

    got = swin_block_bwd_plain(ct, x.detach(), w, WS, shift, mask, False, _t(SCALES))
    _assert_close(got.dx.numpy(), x.grad.numpy(), "dx")
    for k, leaf in leaves.items():
        _assert_close(getattr(got, k).numpy(), leaf.grad.numpy(), k)
    # d table = the gather's adjoint of d rpb
    t2 = w.table.clone().requires_grad_()
    relative_position_bias(t2, WS).backward(got.rpb)
    _assert_close(t2.grad.numpy(), table.grad.numpy(), "table")


def test_k5_plain_rounds_like_the_kernel_in_bf16():
    """In bf16 the plain K5 stays near its fp32 self (the casts sit where
    the kernel's bf16 operands are); a sanity bound of a few percent of
    each gradient's scale."""
    from tpu_superresolution_torch.kernels.fused_block import GRAD_FIELDS, swin_block_bwd_plain

    rng = np.random.default_rng(3)
    p = _block_params(rng)
    c = p["wqkv"].shape[0]
    w = _port_weights(p)
    x = _t(rng.standard_normal((B, H, W, c)).astype(np.float32))
    ct = _t(rng.standard_normal((B, H, W, c)).astype(np.float32))
    g32 = swin_block_bwd_plain(ct, x, w, WS, 0, None, True, _t(SCALES))
    g16 = swin_block_bwd_plain(ct.bfloat16(), x.bfloat16(), w, WS, 0, None, True, _t(SCALES))
    assert g16.dx.dtype == torch.bfloat16
    for k in ("dx",) + GRAD_FIELDS:
        a, b = getattr(g16, k).float(), getattr(g32, k)
        rel = ((a - b).norm() / b.norm()).item()
        assert rel < 0.05, (k, rel)
