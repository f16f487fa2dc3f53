"""``use_remat`` in the port's SwinIR, HAT and DAT (``models.blocks.
remat_block``: each block's activations recomputed in the backward pass
in training, as the JAX models' ``nn.remat`` of their block classes),
fp32 on the CPU:

- with ``use_remat=True`` the output, the loss and every gradient equal
  those without it bit for bit (the same ops recomputed in the same
  order), and DAT's BatchNorm running statistics after the step too
  (one momentum update a step: the recomputation does not update them);
- fewer tensors are kept for the backward with it;
- against the JAX model with ``use_remat=True`` (train=True): the output
  within 3e-5 of its largest magnitude (the fp32 bound, ROADMAP.md,
  scaled: DAT's outputs here reach 4.9, and the JAX DAT's own output
  moves by 9.8e-5 between ``use_remat`` False and True, as XLA orders
  the recomputed sums anew), DAT's updated ``batch_stats`` and every
  gradient within 3e-5 max abs;
- in eval mode or under ``torch.no_grad`` nothing is recomputed;
- a block that trains on CUDA through a block kernel's autograd function
  is left to it (``trains_on_block_kernel``, by shapes).

Drop path is on for the port-against-port check (the branch scales are
drawn before the blocks, so the recomputation sees the same draw), off
against JAX (the two packages draw from different generators)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dat import perturbed_jax_dat, port_dat, small_dat_config
from tests.test_torch_hat import small_hat_config
from tests.util_torchport import TOL, perturbed_jax_swinir, port_from_jax, small_swinir_config

torch.set_num_threads(1)

FAMILIES = ["swinir", "hat", "dat"]


def _case(family, **kw):
    """(JAX config with use_remat, JAX model, variables, port builder,
    input [B, H, W, 3])."""
    rng = np.random.default_rng(40)
    kw = dict(depths=(2,), num_heads=(2,), **kw)  # one group: the JAX compile is the cost
    if family == "dat":
        cfg = small_dat_config(use_remat=True, **kw)
        jmodel, variables = perturbed_jax_dat(cfg, seed=41)
        x = rng.random((3, 16, 32, 3), dtype=np.float32)
        return cfg, jmodel, variables, lambda c: port_dat(c, variables), x
    cfg = (small_swinir_config if family == "swinir" else small_hat_config)(use_remat=True, **kw)
    jmodel, variables = perturbed_jax_swinir(cfg, (16, 16), seed=42)
    hw = (16, 16) if family == "swinir" else (14, 14)
    x = rng.random((2, *hw, 3), dtype=np.float32)
    return cfg, jmodel, variables, lambda c: port_from_jax(c, variables), x


def _port_step(model, x, hr, generator=None):
    """(output, loss, {name: grad}, {name: buffer}, tensors kept for the
    backward) of one L1 step in train mode."""
    kept = [0]

    def pack(t):
        kept[0] += 1
        return t

    model.train()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = model(torch.from_numpy(x), generator=generator)
        loss = (out - torch.from_numpy(hr)).abs().mean()
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    bufs = {k: b.clone() for k, b in model.named_buffers()}
    return out.detach(), loss.detach(), grads, bufs, kept[0]


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_equals_no_remat_bit_for_bit(family):
    cfg, _, _, port, x = _case(family, drop_path_rate=0.3)
    s = cfg.scale
    hr = np.random.default_rng(43).random((x.shape[0], s * x.shape[1], s * x.shape[2], 3),
                                          dtype=np.float32)
    runs = []
    for remat in (False, True):
        model = port(dataclasses.replace(cfg, use_remat=remat))
        runs.append(_port_step(model, x, hr, torch.Generator().manual_seed(44)))
    (o0, l0, g0, b0, k0), (o1, l1, g1, b1, k1) = runs
    assert torch.equal(o0, o1) and torch.equal(l0, l1)
    assert sorted(g0) == sorted(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k
    assert k1 < k0, (k1, k0)


def _jax_step(cfg, jmodel, variables, x, hr):
    """(output, loss, grads as a port state dict, updated batch_stats or
    None) of the JAX model with train=True."""
    from tpu_superresolution_torch.interop import (
        dat_state_dict_from_jax,
        hat_state_dict_from_jax,
        swinir_state_dict_from_jax,
    )

    has_bn = "batch_stats" in variables

    def loss_fn(params):
        v = dict(variables, params=params)
        if has_bn:
            out, mut = jmodel.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        else:
            out, mut = jmodel.apply(v, jnp.asarray(x), train=True), None
        return jnp.mean(jnp.abs(out - jnp.asarray(hr))), (out, mut)

    (loss, (out, mut)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    gtree = {"params": jax.tree.map(np.asarray, grads)}
    if has_bn:
        gtree["batch_stats"] = variables["batch_stats"]
    bridge = {"swinir": swinir_state_dict_from_jax, "hat": hat_state_dict_from_jax,
              "dat": dat_state_dict_from_jax}[cfg.name]
    return (np.asarray(out), float(loss), bridge(gtree),
            None if mut is None else mut["batch_stats"])


@pytest.mark.parametrize("family", FAMILIES)
def test_remat_matches_jax_remat(family):
    cfg, jmodel, variables, port, x = _case(family, drop_path_rate=0.0)
    s = cfg.scale
    hr = np.random.default_rng(45).random((x.shape[0], s * x.shape[1], s * x.shape[2], 3),
                                          dtype=np.float32)
    want_out, want_loss, want_grads, want_stats = _jax_step(cfg, jmodel, variables, x, hr)
    model = port(cfg)
    assert all(getattr(m, "use_remat", True) for m in model.layers)
    out, loss, grads, _, _ = _port_step(model, x, hr)
    assert float(np.abs(out.numpy() - want_out).max()) <= TOL * max(1.0, np.abs(want_out).max())
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5)
    for name, g in grads.items():
        assert float(np.abs(g.numpy() - want_grads[name]).max()) <= TOL, name
    if want_stats is not None:
        from tpu_superresolution_torch.interop import dat_batch_stats_from_state_dict

        got = dat_batch_stats_from_state_dict(model.state_dict(), variables)
        flat = lambda t: {jax.tree_util.keystr(p): np.asarray(v)
                          for p, v in jax.tree_util.tree_leaves_with_path(t)}
        got, want = flat(got), flat(want_stats)
        assert sorted(got) == sorted(want)
        for k in want:
            assert float(np.abs(got[k] - want[k]).max()) <= TOL, k


@pytest.mark.parametrize("family", FAMILIES)
def test_no_recompute_in_eval_or_without_grad(family, monkeypatch):
    import tpu_superresolution_torch.models.dat as dat_mod
    import tpu_superresolution_torch.models.hat as hat_mod
    import tpu_superresolution_torch.models.swinir as swinir_mod

    cfg, _, _, port, x = _case(family, drop_path_rate=0.0)
    model = port(cfg)

    def refuse(*a):
        raise AssertionError("remat_block called")

    for mod in (swinir_mod, hat_mod, dat_mod):
        monkeypatch.setattr(mod, "remat_block", refuse)
    xt = torch.from_numpy(x)
    model.eval()
    assert torch.isfinite(model(xt)).all()  # eval, with grad
    model.train()
    with torch.no_grad():
        assert torch.isfinite(model(xt)).all()  # train mode, no grad
    with pytest.raises(AssertionError, match="remat_block called"):
        model(xt)


def test_batchnorm_keeps_its_statistics_while_recomputing():
    from tpu_superresolution_torch.models.blocks import BatchNorm, recompute_scope, recomputing

    bn = BatchNorm(4).train()
    x = torch.randn(2, 3, 3, 4, generator=torch.Generator().manual_seed(0))
    versions = bn.running_mean._version, bn.running_var._version
    assert not recomputing()
    with recompute_scope():
        assert recomputing()
        y = bn(x)
    assert (bn.running_mean._version, bn.running_var._version) == versions
    assert torch.equal(bn.running_mean, torch.zeros(4))
    assert torch.equal(y, bn(x))  # the batch statistics normalise either way
    assert not torch.equal(bn.running_mean, torch.zeros(4))


# (block, map side, whether it trains through a block kernel's autograd
# function on CUDA)
BLOCK_ROUTES = [
    ("swinir-m", dict(dim=180, num_heads=6, window_size=8, shift_size=4), 64, True),  # K5
    ("swinir-l", dict(dim=240, num_heads=8, window_size=8, shift_size=0), 64, True),  # K5r
    ("hat-srx4", dict(dim=180, num_heads=6, window_size=16, shift_size=8, compress_ratio=3),
     64, True),  # K5w16 + K12
    ("window-12", dict(dim=180, num_heads=6, window_size=12, shift_size=6), 64, False),
    ("map-6", dict(dim=180, num_heads=6, window_size=8, shift_size=4), 6, False),
    ("hat-cab-convs", dict(dim=180, num_heads=6, window_size=8, shift_size=0,
                           compress_ratio=1), 64, False),  # Cmid 180 past K12's
]


@pytest.mark.parametrize("kw, side, want", [r[1:] for r in BLOCK_ROUTES],
                         ids=[r[0] for r in BLOCK_ROUTES])
def test_block_kernel_routes_are_left_to_their_functions(kw, side, want):
    from tpu_superresolution_torch.models.hat import HAB
    from tpu_superresolution_torch.models.swinir import SwinBlock

    if "compress_ratio" in kw:
        block = HAB(**kw, squeeze_factor=30, conv_scale=0.01, mlp_ratio=2.0, qkv_bias=True,
                    gelu_approximate=False)
    else:
        block = SwinBlock(**kw, mlp_ratio=2.0)
    assert block.trains_on_block_kernel(side, side) is want
