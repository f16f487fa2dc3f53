"""HAT training in the PyTorch port against the JAX package, fp32 on the
CPU (every port kernel runs its plain version there):

- the block backward's plain version with `extra` and branch scales
  (K6's backward at ws 7, K5 with d`extra` at ws 8) against ``jax.vjp``
  of the JAX block kernels in interpret mode (``_packed_backward`` /
  ``_mega_backward``) and of their jnp references;
- every HAT parameter's gradient against ``jax.grad`` of the JAX HAT
  (train=True, drop_path_rate=0), through its module path and through
  its fused kernels in interpret mode, at ws 7 and ws 8;
- a few engine steps against the JAX package's train steps;
- stochastic depth: the branch scales reach the attention and MLP
  residuals and never the CAB term.

Bounds: forwards 3e-5 max abs; block-level gradients atol 2e-4 / rtol
1e-3 (the JAX package's own kernel-vs-vjp bound, as for K5); model
gradients max |diff| <= 1e-3 * max |grad| + 1e-7 (fp32 sums in another
order); loss and grad norm per step rtol 1e-4; parameters after the
steps within 3 lr (the first Adam update is about lr * sign(g))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_hat import small_hat_config
from tests.test_torch_hat_block import _block_weights
from tests.util_torchport import TOL, perturbed_jax_swinir, port_from_jax

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
SCALES = np.array([[1.25, 0.0], [1.0, 1.25]], np.float32)
_JAX_ORDER = ("g1", "b1", "wqkv", "bqkv", "wproj", "bproj", "g2", "b2",
              "wfc1", "bfc1", "wfc2", "bfc2")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _as_port(name, g):
    g = np.asarray(g)
    return g.T if name in ("wqkv", "wproj", "wfc1", "wfc2") else g


def _assert_close(got, want, what):
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=what)


def _assert_grad_close(got, want, name):
    bound = 1e-3 * float(np.abs(want).max()) + 1e-7
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{name}: max |diff| {err:.3e} > {bound:.3e}"


def _jax_block_fn(oracle, ws, shift, b, h, wd, c, nh, gelu_approx):
    """(x, extra, 12 weights, gathered bias) -> the JAX block on the
    unshifted map, through `oracle`: the packed kernel (K6, partition,
    token pad and window-count pad as models/hat.py:330-360 does), its
    jnp reference, or the strip kernel (K1 with extra)."""
    from tpu_superresolution_tpu.ops.pallas import fused_block as jfb
    from tpu_superresolution_tpu.ops.window import (
        cyclic_shift,
        cyclic_unshift,
        shift_attn_mask,
        window_partition,
        window_reverse,
    )

    mask = shift_attn_mask(h, wd, ws, shift) if shift else None
    scale = (c // nh) ** -0.5
    sc = jnp.asarray(SCALES)
    n = ws * ws
    n_win = (h // ws) * (wd // ws)
    npad, wpad = (-n) % 8, (-n_win) % jfb.PACKED_GROUP

    def f(x, extra, *args):
        *weights, bias = args
        xs, es = cyclic_shift(x, shift), cyclic_shift(extra, shift)
        if oracle == "strip":
            out = jfb.fused_swin_block(xs, *weights, bias, ws, mask, scale, gelu_approx,
                                       interpret=True, extra=es, branch_scales=sc)
            return cyclic_unshift(out, shift)
        pads = ((0, 0), (0, wpad), (0, npad), (0, 0))
        part = lambda a: jnp.pad(window_partition(a, ws).reshape(b, n_win, n, c), pads).reshape(
            b * (n_win + wpad), n + npad, c)
        bias_p = jnp.pad(bias, ((0, 0), (0, npad), (0, npad)), constant_values=-1e9)
        mask_p = None if mask is None else np.pad(mask, ((0, wpad), (0, npad), (0, npad)))
        if oracle == "packed":
            outw = jfb.fused_packed_windows_block(part(xs), *weights, bias_p, mask_p, scale,
                                                  gelu_approx, interpret=True, extra=part(es),
                                                  branch_scales=sc)
        else:  # the packed kernel's jnp reference
            outw = jfb._reference_packed(part(xs), *weights, bias_p, sc, mask_p, scale,
                                         gelu_approx, extra=part(es))
        outw = outw.reshape(b, n_win + wpad, n + npad, c)[:, :n_win, :n]
        return cyclic_unshift(window_reverse(outw.reshape(b * n_win, n, c), ws, h, wd), shift)

    return f


_BWD_CASES = [("packed", 7, 0, True), ("packed", 7, 3, False), ("reference", 7, 3, True),
              ("strip", 8, 0, True), ("strip", 8, 4, False)]


@pytest.mark.parametrize("oracle,ws,shift,gelu_approx", _BWD_CASES,
                         ids=[f"{o}-ws{w}-s{s}-{'tanh' if g else 'erf'}"
                              for o, w, s, g in _BWD_CASES])
def test_block_backward_with_extra_matches_jax(oracle, ws, shift, gelu_approx):
    """swin_block_bwd_plain with `extra` and branch scales (what the
    backward wrapper runs on CPU tensors): dx, d extra, every weight
    gradient and the gathered bias's, against jax.vjp of the JAX block."""
    from tpu_superresolution_tpu.ops.window import relative_position_index
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels.fused_block import (
        fused_swin_block_backward,
        fused_windows_block,
    )
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    rng = np.random.default_rng(200 + 10 * ws + shift)
    w, args, table = _block_weights(rng, ws=ws)
    b, h, wd, c, nh = 2, 2 * ws, 3 * ws, 32, 2
    x = rng.standard_normal((b, h, wd, c)).astype(np.float32)
    extra = (0.5 * rng.standard_normal((b, h, wd, c))).astype(np.float32)
    ct = rng.standard_normal((b, h, wd, c)).astype(np.float32)
    n = ws * ws
    bias = table[relative_position_index(ws).reshape(-1)].reshape(n, n, nh).transpose(2, 0, 1)
    f = _jax_block_fn(oracle, ws, shift, b, h, wd, c, nh, gelu_approx)
    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(extra), *args, jnp.asarray(bias))
    jgrads = vjp(jnp.asarray(ct))

    reset_counters()
    tmask = shift_mask_tensor(h, wd, ws, shift, torch.device("cpu")) if shift else None
    fwd = fused_windows_block(_t(x), w, ws, shift, tmask, gelu_approx, extra=_t(extra),
                              branch_scales=_t(SCALES))
    assert np.abs(fwd.numpy() - np.asarray(out)).max() <= TOL
    got = fused_swin_block_backward(_t(ct), _t(x), w, ws, shift, tmask, gelu_approx,
                                    branch_scales=_t(SCALES), extra=_t(extra))
    assert not any(read_counters().values())  # CPU tensors: the plain versions ran
    _assert_close(got.dx.numpy(), np.asarray(jgrads[0]), "dx")
    _assert_close(got.extra.numpy(), np.asarray(jgrads[1]), "dextra")
    for name, g in zip(_JAX_ORDER, jgrads[2:14]):
        _assert_close(getattr(got, name).numpy(), _as_port(name, g), name)
    _assert_close(got.rpb.numpy(), np.asarray(jgrads[14]), "rpb")


def test_block_backward_without_extra_has_no_extra_gradient():
    from tpu_superresolution_torch.kernels.fused_block import fused_swin_block_backward

    rng = np.random.default_rng(3)
    w, _, _ = _block_weights(rng, ws=7)
    x = _t(rng.standard_normal((1, 14, 14, 32)).astype(np.float32))
    got = fused_swin_block_backward(torch.ones_like(x), x, w, 7, 0, None, True)
    assert got.extra is None and got.dx.shape == x.shape


_MODEL_CASES = [(dict(), (14, 14)),
                (dict(attention_impl="fused", gelu_approximate=True), (14, 21)),
                (dict(window_size=8), (16, 16)),
                (dict(window_size=8, attention_impl="fused", gelu_approximate=True), (16, 16)),
                (dict(window_size=16), (20, 24))]


@pytest.mark.parametrize("overrides,hw", _MODEL_CASES,
                         ids=["jnp-ws7", "jax-kernels-ws7", "jnp-ws8", "jax-kernels-ws8",
                              "jnp-ws16"])
def test_hat_gradients_match_jax(overrides, hw):
    """Every parameter's gradient of an L1 loss through the port's HAT in
    train mode (drop path off) against jax.grad of the JAX HAT with
    train=True: its module path, or its fused kernels in interpret mode
    (K6 / K1 with `extra` and their Pallas backwards, K8 and its
    backward).  At ws 16 (upstream HAT-SRx4's window, reflect-padded to
    32 x 32 with the shift on) the port's HABs take the K7 route and its
    OCABs the fused route (K8's plain version), against the JAX module
    path."""
    from tpu_superresolution_torch.interop import hat_state_dict_from_jax

    cfg = small_hat_config(drop_path_rate=0.0, **overrides)
    jmodel, variables = perturbed_jax_swinir(cfg, (14, 14), seed=17)
    rng = np.random.default_rng(18)
    lr = rng.random((2, hw[0], hw[1], 3), dtype=np.float32)
    hr = rng.random((2, 4 * hw[0], 4 * hw[1], 3), dtype=np.float32)

    def loss_fn(params):
        out = jmodel.apply({"params": params}, jnp.asarray(lr), train=True)
        return jnp.mean(jnp.abs(out.astype(jnp.float32) - jnp.asarray(hr)))

    jloss, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    want = hat_state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)})

    model = port_from_jax(cfg, variables).train()
    takes_k8 = [layer.residual_group.overlap_attn.takes_k8() for layer in model.layers]
    assert all(takes_k8)
    loss = (model(torch.from_numpy(lr)) - torch.from_numpy(hr)).abs().mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in model.named_parameters():
        assert p.grad is not None, f"{name} got no gradient"
        assert torch.isfinite(p.grad).all(), name
        _assert_grad_close(p.grad.numpy(), want[name], name)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_hat_train_steps_match_jax(n_steps):
    """Engine steps (L1, AdamW with weight decay, cosine schedule, clip)
    against the JAX package's make_train_step on the same batches."""
    from tpu_superresolution_tpu.core.config import TrainConfig as JaxTrainConfig
    from tpu_superresolution_tpu.core.config import build_model as jax_build_model
    from tpu_superresolution_tpu.train.engine import build_optimizer as jax_build_optimizer
    from tpu_superresolution_tpu.train.engine import create_train_state as jax_create_state
    from tpu_superresolution_tpu.train.engine import make_train_step as jax_make_train_step
    from tpu_superresolution_torch.core.config import TrainConfig
    from tpu_superresolution_torch.interop import hat_state_dict_from_jax
    from tpu_superresolution_torch.train.engine import (
        build_optimizer,
        create_train_state,
        make_train_step,
    )

    base = dict(epochs=2, batch_size=2, loss="l1", lr=2e-4, weight_decay=0.05,
                scheduler="cosine", min_lr=2e-5, grad_clip_norm=0.05, finetune=True)
    jtcfg, tcfg = JaxTrainConfig(**base), TrainConfig(**base)
    cfg = small_hat_config(drop_path_rate=0.0)
    _, variables = perturbed_jax_swinir(cfg, (14, 14), seed=21)
    steps_per_epoch = 2
    jmodel = jax_build_model(cfg)
    jparams = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jax_create_state(jmodel, jparams, {},
                              jax_build_optimizer(jtcfg, steps_per_epoch, jparams))
    jstep = jax_make_train_step(jmodel, jtcfg.loss, "native_lr", 4, None, False)

    model = port_from_jax(cfg, variables)
    opt, sched = build_optimizer(tcfg, steps_per_epoch, model)
    state = create_train_state(model, opt, sched, tcfg.grad_clip_norm)
    step = make_train_step(tcfg.loss, "native_lr", 4, None, False)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for i in range(n_steps):
        rng = np.random.default_rng(100 + i)
        lr = rng.random((2, 14, 14, 3), dtype=np.float32)
        hr = rng.random((2, 56, 56, 3), dtype=np.float32)
        jstate, jm = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr), jax.random.key(i))
        m = step(state, lr, hr, torch.Generator().manual_seed(i))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        assert bool(m["finite"]) and bool(jm["finite"])
    assert state.step == int(jstate.step) == n_steps
    jparams = hat_state_dict_from_jax({"params": jax.tree.map(np.asarray, jstate.params)})
    moved = 0
    for name, p in model.state_dict().items():
        diff = float(np.abs(p.numpy() - jparams[name]).max())
        assert diff <= 3 * tcfg.lr, f"{name}: {diff:.3e} > 3 lr"
        moved += not torch.equal(p, start[name])
    assert moved == len(start)  # every parameter was updated


def _small_port_hat(**kw):
    from tpu_superresolution_torch.core.config import HATConfig, build_model

    base = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), squeeze_factor=6, num_feat=16,
                conv_scale=0.3)
    base.update(kw)
    model = build_model(HATConfig(**base))
    model.reset_parameters(torch.Generator().manual_seed(5))
    return model


@pytest.mark.parametrize("m1,m2", [(0.0, 0.0), (0.0, 2.0), (2.0, 0.0)])
def test_stochastic_depth_scales_attention_and_mlp_not_the_cab_term(m1, m2):
    """A HAB with branch scales (m1, m2): m1 multiplies the attention
    residual, m2 the MLP residual, and the CAB term always enters whole,
    as hat_arch.py:307-308 and the JAX HAB (models/hat.py:296-301)."""
    from tpu_superresolution_torch.kernels.fused_block import swin_block_plain

    model = _small_port_hat()
    hab = model.layers[0].residual_group.blocks[1]  # a shifted block
    x = torch.randn(2, 14, 14, 24, generator=torch.Generator().manual_seed(1))
    scales = torch.tensor([[m1, m2], [m1, m2]])
    with torch.no_grad():
        got = hab(x, branch_scales=scales)
        extra = hab.conv_block(x, hab.norm1) * hab.conv_scale  # CAB on LN1(x), K12's function
        want = swin_block_plain(x, hab.block_weights(), 7, 3, hab_mask(hab, x), False, scales,
                                extra)
        assert torch.allclose(got, want, atol=1e-6)
        if m1 == 0.0 and m2 == 0.0:  # both branches dropped: x + the CAB term, exactly
            assert torch.allclose(got, x + extra, atol=1e-6)
        # the CAB term is in the output whatever the scales
        assert (got - swin_block_plain(x, hab.block_weights(), 7, 3, hab_mask(hab, x), False,
                                       scales)).abs().max() > 1e-3


def hab_mask(hab, x):
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    return shift_mask_tensor(x.shape[1], x.shape[2], hab.window_size, hab.shift_size, x.device)


def test_train_mode_draws_branch_scales_per_hab():
    """train() draws [depth, B, 2] scales per layer from the generator
    (linear rates 0 -> drop_path_rate over all HABs, the first block
    never dropped); eval() and drop_path_rate 0 draw none."""
    model = _small_port_hat(drop_path_rate=0.5)
    np.testing.assert_allclose(model.drop_path_rates(), np.linspace(0, 0.5, 4), rtol=1e-6)
    model.train()
    scales = model.sample_branch_scales(3, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(s.shape) for s in scales] == [(2, 3, 2), (2, 3, 2)]
    assert torch.all(scales[0][0] == 1.0)
    allowed = torch.tensor([0.0] + [1 / (1 - r) for r in model.drop_path_rates()])
    for v in torch.cat([s.reshape(-1) for s in scales]).unique():
        assert torch.isclose(allowed, v).any(), float(v)
    x = torch.rand(2, 14, 14, 3)
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(0))
        b = model(x, generator=torch.Generator().manual_seed(0))
        c = model(x, generator=torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    assert model.sample_branch_scales(3, None, "cpu") is None
    assert _small_port_hat(drop_path_rate=0.0).train().sample_branch_scales(3, None, "cpu") is None


@pytest.mark.parametrize("oracle,shift", [("packed", 3), ("packed", 0)],
                         ids=["packed-ws7-s3", "packed-ws7-s0"])
def test_k6b_schedule_emulated_matches_jax_packed_backward(oracle, shift):
    """K6b's schedule on Hopper (csrc/swin_block_bwd.cu at ws 7, written
    out in torch ops on the forward's packed stream:
    tests/test_torch_swin_backward.py::block_bwd_emulated) against
    jax.vjp of the JAX package's ``fused_packed_windows_block`` in
    interpret mode (its backward is ``_packed_backward``) with `extra` and
    branch scales: dx, d extra, every weight gradient and the gathered
    bias's (atol 2e-4 / rtol 1e-3)."""
    from tests.test_torch_swin_backward import block_bwd_emulated
    from tpu_superresolution_tpu.ops.window import relative_position_index
    from tpu_superresolution_torch.kernels.fused_block import pack_block_tiles

    ws = 7
    rng = np.random.default_rng(300 + shift)
    w, args, table = _block_weights(rng, ws=ws)
    b, h, wd, c, nh = 2, 2 * ws, 3 * ws, 32, 2
    x = rng.standard_normal((b, h, wd, c)).astype(np.float32)
    extra = (0.5 * rng.standard_normal((b, h, wd, c))).astype(np.float32)
    ct = rng.standard_normal((b, h, wd, c)).astype(np.float32)
    n = ws * ws
    bias = table[relative_position_index(ws).reshape(-1)].reshape(n, n, nh).transpose(2, 0, 1)
    f = _jax_block_fn(oracle, ws, shift, b, h, wd, c, nh, True)
    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(extra), *args, jnp.asarray(bias))
    jgrads = vjp(jnp.asarray(ct))
    p = pack_block_tiles(w, dtype=torch.float32)
    dx, dex, got, _ = block_bwd_emulated(_t(ct), _t(x), p, ws, shift, shift > 0, True,
                                         _t(SCALES), _t(extra), grid=2)
    _assert_close(dx.numpy(), np.asarray(jgrads[0]), "dx")
    _assert_close(dex.numpy(), np.asarray(jgrads[1]), "dextra")
    for name, g in zip(_JAX_ORDER, jgrads[2:14]):
        _assert_close(got[name].numpy(), _as_port(name, g), name)
    _assert_close(got["rpb"].numpy(), np.asarray(jgrads[14]), "rpb")
