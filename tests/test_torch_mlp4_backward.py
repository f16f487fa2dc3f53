"""The training kernels at any MLP hidden: HAT at window 16 and width 180
as the JAX train CLI builds it (no ``--mlp_ratio``: mlp 4, hidden 720)
and SwinIR-L at mlp 4 (hidden 960), in the PyTorch port against the JAX
package, fp32 on the CPU:

(a) the port's plain block backward at ws 16, C 180, 6 heads, hidden 720
    (shift 0 and 8, `extra`, branch scales), what K5w16 is held to on the
    card, against jax.vjp of the JAX ``fused_swin_block`` in interpret
    mode (its backward is ``_mega_backward``, the Pallas K5);
(b) K5w16's and K5r's schedules in torch ops on ``pack_block_tiles``'
    stream (``block_bwd16_emulated``, ``block_bwd_k5r_emulated``: 12 and
    15 hidden chunks, the last a quarter or whole; K5b's units grouped
    over them) at hidden 720 and 960 against the plain version and the
    JAX kernel, and K5r at the block kernel's C and heads with hidden 720
    (K5r's cp-256 layout) against the plain version;
(c) the OCAB core's schedules (K8w16 / K8bw16 at (16, 24), K8 / K8b at
    (7, 10)) at C 180, 6 heads, hidden 720, forward and backward, against
    the plain versions and the JAX ``fused_ocab_core`` in interpret mode;
(d) a HAT at ws 16, C 180, 6 heads, mlp 4 (one RHAG of depth 2) in train
    mode against ``jax.value_and_grad`` of the JAX model, weights carried
    across by the interop bridge;
(e) the port's ``train`` CLI with the JAX CLI's flags builds mlp 4, and
    every HAB and OCAB of that model trains on the kernels
    (``trains_on_block_kernel``, ``takes_k8``; shapes only), and a HAT of
    that width exports with its OCAB as K8w16's ``tpu_sr::ocab16`` op.

Bounds: forwards 3e-5 max abs; gradients atol 2e-4 / rtol 1e-3 (the JAX
package's own kernel-vs-vjp bound); model gradients 1e-3 of each
gradient's largest magnitude, as ``tests/test_torch_hat_train.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels_plain import _block_params, _port_weights, _t
from tests.test_torch_swin_backward import _JAX_ORDER, _as_port
from tests.util_torchport import TOL

torch.set_num_threads(2)

GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
SCALES = np.array([[1.25, 0.0], [1.0, 1.25]], np.float32)
C16, NH16, HID16 = 180, 6, 720   # the JAX train CLI's HAT at window 16
C8, NH8, HID8 = 240, 8, 960      # SwinIR-L at mlp 4


def _assert_close(got, want, what):
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=what)


def _gathered_bias(p, ws):
    from tpu_superresolution_tpu.ops.window import relative_position_index

    n = ws * ws
    bias = p["table"][relative_position_index(ws).reshape(-1)].reshape(n, n, -1)
    return np.ascontiguousarray(bias.transpose(2, 0, 1))


def _jax_block_grads(p, x, ct, ws, shift, extra):
    """(forward, gradients) of the JAX fused block in interpret mode, the
    shift around it, branch scales on: x, the 12 weights (JAX layout),
    the gathered bias and, with `extra`, extra's."""
    from tpu_superresolution_tpu.ops.pallas.fused_block import fused_swin_block
    from tpu_superresolution_tpu.ops.window import cyclic_shift, cyclic_unshift, shift_attn_mask

    _, h, w, c = x.shape
    mask = shift_attn_mask(h, w, ws, shift) if shift else None
    scale = (c // p["nh"]) ** -0.5

    def f(x, *args):
        *weights, bias, ex = args
        out = fused_swin_block(cyclic_shift(x, shift), *weights, bias, ws, mask, scale, True,
                               interpret=True,
                               extra=None if ex is None else cyclic_shift(ex, shift),
                               branch_scales=jnp.asarray(SCALES))
        return cyclic_unshift(out, shift)

    leaves = ([jnp.asarray(x)] + [jnp.asarray(p[k]) for k in _JAX_ORDER]
              + [jnp.asarray(_gathered_bias(p, ws))])
    if extra is None:
        out, vjp = jax.vjp(lambda *a: f(*a, None), *leaves)
    else:
        out, vjp = jax.vjp(f, *leaves, jnp.asarray(extra))
    return np.asarray(out), vjp(jnp.asarray(ct))


def _check_jax(dx, grads, jgrads, dextra=None):
    _assert_close(dx.numpy(), np.asarray(jgrads[0]), "dx vs JAX")
    for name, g in zip(_JAX_ORDER, jgrads[1:13]):
        _assert_close(grads[name].numpy(), _as_port(name, g), f"{name} vs JAX")
    _assert_close(grads["rpb"].numpy(), np.asarray(jgrads[13]), "rpb vs JAX")
    if dextra is not None:
        _assert_close(dextra.numpy(), np.asarray(jgrads[14]), "dextra vs JAX")


def _check_plain(dx, grads, want, dextra=None):
    from tpu_superresolution_torch.kernels.fused_block import GRAD_FIELDS

    _assert_close(dx.numpy(), want.dx.numpy(), "dx vs plain")
    if dextra is not None:
        _assert_close(dextra.numpy(), want.extra.numpy(), "dextra vs plain")
    for k in GRAD_FIELDS:
        _assert_close(grads[k].numpy(), getattr(want, k).numpy(), f"{k} vs plain")


# ------------------------------------------------- (a), (b) K5w16, ws 16
WS16_SHAPE = (2, 32, 32)  # 8 windows of 256 tokens


@pytest.fixture(scope="module")
def ws16_case():
    """Per shift (0 and 8): the block's JAX-layout parameters, x, ct,
    extra and the JAX fused block's forward and gradients at C 180, 6
    heads, hidden 720."""
    cases = {}
    for shift in (0, 8):
        rng = np.random.default_rng(720 + shift)
        p = _block_params(rng, c=C16, nh=NH16, hidden=HID16, ws=16)
        shape = WS16_SHAPE + (C16,)
        x = rng.standard_normal(shape).astype(np.float32)
        ct = rng.standard_normal(shape).astype(np.float32)
        extra = (0.3 * rng.standard_normal(shape)).astype(np.float32)
        cases[shift] = (p, x, ct, extra, *_jax_block_grads(p, x, ct, 16, shift, extra))
    return cases


@pytest.mark.parametrize("shift", [0, 8])
def test_ws16_plain_backward_at_hidden_720_matches_jax_mega_backward(ws16_case, shift):
    """(a): the port's plain block backward (what K5w16 is held to on the
    card) at the JAX train CLI's HAT widths, with `extra` and branch
    scales, against jax.vjp of the JAX fused block in interpret mode; the
    block takes K5w16 on the card (``k5w16_ok``)."""
    from tpu_superresolution_torch.kernels import fused_block, read_counters, reset_counters
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    assert fused_block.k5w16_ok(16, C16, NH16, HID16)
    assert fused_block.block_route(16, C16, NH16, HID16) == "window_attention"
    p, x, ct, extra, out, jgrads = ws16_case[shift]
    _, h, w, _ = x.shape
    reset_counters()
    wts = _port_weights(p)
    mask = shift_mask_tensor(h, w, 16, shift, torch.device("cpu")) if shift else None
    fwd = fused_block.swin_block_plain(_t(x), wts, 16, shift, mask, True, _t(SCALES), _t(extra))
    assert np.abs(fwd.numpy() - out).max() <= TOL
    got = fused_block.fused_swin_block_backward(_t(ct), _t(x), wts, 16, shift, mask, True,
                                                branch_scales=_t(SCALES), extra=_t(extra))
    assert not any(read_counters().values())  # CPU tensors: the plain version ran
    grads = {k: getattr(got, k) for k in fused_block.GRAD_FIELDS}
    _check_jax(got.dx, grads, jgrads, got.extra)


@pytest.mark.parametrize("shift", [0, 8])
def test_k5w16_schedule_at_hidden_720_matches_plain_and_jax(ws16_case, shift):
    """(b): K5w16's schedule (K5a's three modes with 12 hidden chunks, the
    last a quarter real; the attention kernels' passes; K5b's units over
    four groups of fc2's X tiles; the fold) on the forward's packed
    stream at C 180 / hidden 720, against the plain version and the JAX
    kernel; K5b writes every stream and bias entry once."""
    from tests.test_torch_swin_backward_ws16 import block_bwd16_emulated
    from tpu_superresolution_torch.kernels.fused_block import (
        bwd_plan,
        pack_block_tiles,
        swin_block_bwd_plain,
    )
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    p, x, ct, extra, _, jgrads = ws16_case[shift]
    _, h, w, _ = x.shape
    wts = _port_weights(p)
    pk = pack_block_tiles(wts, dtype=torch.float32)
    plan = bwd_plan(C16, NH16, HID16)
    assert (pk.layout.cp, pk.layout.chunks, plan.units) == (192, 12, 36)
    assert pk.tiles.numel() == plan.stream_len
    dx, dex, got, written = block_bwd16_emulated(_t(ct), _t(x), pk, shift, shift > 0, True,
                                                 _t(SCALES), _t(extra), grid=5, splits=3, cph=1)
    assert torch.equal(written, torch.ones_like(written))
    mask = shift_mask_tensor(h, w, 16, shift, torch.device("cpu")) if shift else None
    want = swin_block_bwd_plain(_t(ct), _t(x), wts, 16, shift, mask, True, _t(SCALES), _t(extra))
    _check_plain(dx, got, want, dex)
    _check_jax(dx, got, jgrads, dex)


# ---------------------------------------------------------- (b) K5r, ws 8
@pytest.mark.parametrize("shift", [0, 4])
def test_k5r_schedule_at_hidden_960_matches_plain_and_jax(shift):
    """(b): K5r's schedule (K5a's cp-256 modes with 15 hidden chunks,
    dy2's halves against dh1 read back; the attention over stages of four
    windows; K5b's units over five groups of fc2's X tiles) on the
    forward's packed stream at SwinIR-L's widths at mlp 4, against the
    plain version and the JAX kernel; `extra` at shift 4."""
    from tests.test_torch_swin_backward_wide import block_bwd_k5r_emulated
    from tpu_superresolution_torch.kernels.fused_block import (
        bwd_plan,
        k5r_ok,
        pack_block_tiles,
        swin_block_bwd_plain,
    )
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    assert k5r_ok(8, C8, NH8, HID8)
    rng = np.random.default_rng(960 + shift)
    p = _block_params(rng, c=C8, nh=NH8, hidden=HID8, ws=8)
    shape = (2, 16, 16, C8)
    x = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    extra = (0.3 * rng.standard_normal(shape)).astype(np.float32) if shift else None
    _, jgrads = _jax_block_grads(p, x, ct, 8, shift, extra)
    wts = _port_weights(p)
    pk = pack_block_tiles(wts, dtype=torch.float32)
    plan = bwd_plan(C8, NH8, HID8)
    assert (pk.layout.cp, pk.layout.chunks, plan.units) == (256, 15, 82)
    tex = None if extra is None else _t(extra)
    dx, dex, got, written = block_bwd_k5r_emulated(_t(ct), _t(x), pk, shift, shift > 0, True,
                                                   _t(SCALES), tex, grid=3, splits=3, cph=2)
    assert torch.equal(written, torch.ones_like(written))
    mask = shift_mask_tensor(16, 16, 8, shift, torch.device("cpu")) if shift else None
    want = swin_block_bwd_plain(_t(ct), _t(x), wts, 8, shift, mask, True, _t(SCALES), tex)
    _check_plain(dx, got, want, dex)
    _check_jax(dx, got, jgrads, dex)


def test_k5r_schedule_at_block_widths_hidden_720_matches_plain():
    """A ws-8 block within the block kernel's C and heads whose hidden
    (720) is past the forward kernel's: the K7 route, trained by K5r on
    its cp-256 layout (``stream_layout(..., k5r=True)``); the schedule
    against the plain version, with `extra`, shift 4 and an odd window
    count (the last unit pair's idle twin)."""
    from tests.test_torch_swin_backward_wide import block_bwd_k5r_emulated
    from tpu_superresolution_torch.kernels.fused_block import (
        block_route,
        k5r_ok,
        pack_block_tiles,
        swin_block_bwd_plain,
    )
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    assert block_route(8, C16, NH16, HID16) == "window_attention" and k5r_ok(8, C16, NH16, HID16)
    rng = np.random.default_rng(7208)
    p = _block_params(rng, c=C16, nh=NH16, hidden=HID16, ws=8)
    shape = (1, 8, 24, C16)
    x, ct, extra = (_t(s * rng.standard_normal(shape).astype(np.float32)) for s in (1, 1, 0.3))
    wts = _port_weights(p)
    pk = pack_block_tiles(wts, dtype=torch.float32)
    assert (pk.layout.cp, pk.layout.pw, pk.layout.chunks) == (256, 128, 12)
    scales = _t(SCALES)[-1:]
    dx, dex, got, written = block_bwd_k5r_emulated(ct, x, pk, 4, True, True, scales, extra,
                                                   grid=2, splits=2, cph=1)
    assert torch.equal(written, torch.ones_like(written))
    mask = shift_mask_tensor(8, 24, 8, 4, torch.device("cpu"))
    _check_plain(dx, got, swin_block_bwd_plain(ct, x, wts, 8, 4, mask, True, scales, extra), dex)


# ------------------------------------------------------------- (c) OCAB
def _ocab_jax_core(nh, bw, gelu_approx):
    """(q, k, v, sw, 8 weights, bias) -> the JAX core in interpret mode
    (tokens padded to multiples of 8 as models/hat.py OCAB._fused pads,
    -1e9 on the pad bias entries)."""
    from tpu_superresolution_tpu.ops.pallas import fused_ocab

    def f(q, k, v, sw, *args):
        *weights, bias = args
        nq, nk, c = q.shape[1], k.shape[1], q.shape[2]
        nqp, nkp = nq + (-nq) % 8, nk + (-nk) % 8
        pad = lambda a, n: jnp.pad(a, ((0, 0), (0, n - a.shape[1]), (0, 0)))
        bias_p = jnp.pad(bias, ((0, 0), (0, nqp - nq), (0, nkp - nk)), constant_values=-1e9)
        out = fused_ocab.fused_ocab_core(pad(q, nqp), pad(k, nkp), pad(v, nkp), pad(sw, nqp),
                                         *weights, bias_p, nh, c // nh, gelu_approx=gelu_approx,
                                         interpret=True, group=bw)
        return out[:, :nq]

    return f


_OCAB_CASES = {16: 2, 7: 4}  # ws -> windows (ows 24 / 10)


def _ocab_case(ws, seed):
    """The schedule of csrc/ocab16.cu (ws 16) or csrc/ocab_bwd.cu (ws 7)
    in torch ops on a seeded case at C 180, 6 heads, hidden 720 (tanh
    GELU), its inputs, the JAX core's arguments and the JAX core."""
    from tests.test_torch_ocab import _W_ORDER, _case
    from tests.test_torch_ocab import _port_weights as ocab_weights
    from tests.test_torch_ocab_wg import _Schedule as Schedule7
    from tests.test_torch_ocab_ws16_wg import _Schedule as Schedule16

    bw = _OCAB_CASES[ws]
    acts, w, bias, nh = _case(seed, ws=ws, c=C16, nh=NH16, hidden=HID16, bw=bw)
    ct = np.random.default_rng(seed + 1).standard_normal(acts["sw"].shape).astype(np.float32)
    pw = ocab_weights(w, nh)
    schedule = Schedule16 if ws == 16 else Schedule7
    s = schedule(*(_t(acts[k]) for k in ("q", "k", "v", "sw")), pw, _t(bias), True)
    args = ([jnp.asarray(acts[k]) for k in ("q", "k", "v", "sw")]
            + [jnp.asarray(w[k]) for k in _W_ORDER] + [jnp.asarray(bias)])
    return s, acts, pw, bias, ct, args, _ocab_jax_core(nh, bw, True)


@pytest.mark.parametrize("ws", [16, 7])
def test_ocab_schedule_forward_at_hidden_720_matches_plain_and_jax(ws):
    """(c): K8w16's (ws 16) / K8's (ws 7: 49 tokens in 64 rows) forward
    schedule, the attention and K5a's OCAB tail with fc2 summed over 12
    hidden chunks in fp32, at C 180 / hidden 720, against the plain
    version and the JAX kernel; ``ocab_ok`` takes the shape."""
    from tests.test_torch_ocab_fwd_wg import _tail_forward
    from tpu_superresolution_torch.kernels.fused_ocab import ocab_core_plain, ocab_ok

    assert ocab_ok(ws, ws + ws // 2, C16, NH16, HID16)
    s, acts, pw, bias, _, args, jax_core = _ocab_case(ws, 7200 + ws)
    assert s.plan.block.chunks == 12 and s.plan.block.cp == 192
    o, _ = s.attention_forward()
    got = (s.tail_forward(o) if ws == 16 else _tail_forward(s, o)).numpy()
    plain = ocab_core_plain(*(_t(acts[k]) for k in ("q", "k", "v", "sw")), pw, _t(bias),
                            True).numpy()
    want = np.asarray(jax_core(*args))
    assert np.abs(got - plain).max() <= TOL
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("ws", [16, 7])
def test_ocab_schedule_backward_at_hidden_720_matches_plain_and_jax(ws):
    """(c): K8bw16's (ws 16) / K8b's (ws 7) backward schedule (K5a's
    middle over 12 hidden chunks, the attention backward's passes and
    bias-gradient partials, K5b's splits) at C 180 / hidden 720: dq, dk,
    dv, dsw, every weight gradient and the bias gradient against
    ``ocab_core_bwd_plain`` and jax.vjp of the JAX core."""
    from tests.test_torch_ocab import _LINEAR, _W_ORDER
    from tpu_superresolution_torch.kernels.fused_ocab import ocab_core_bwd_plain

    s, acts, pw, bias, ct, args, jax_core = _ocab_case(ws, 7300 + ws)
    o, stat = s.attention_forward()
    dsw, do, drow, ops = s.middle(_t(ct), o)
    dq, dk, dv, dbias = s.attention_backward(do, drow, stat)
    got = dict(dq=s.back_to_tokens(dq), dk=s.back_to_tokens(dk), dv=s.back_to_tokens(dv),
               dsw=dsw, bias=dbias, **s.weight_grads(ops))
    plain = ocab_core_bwd_plain(_t(ct), *(_t(acts[k]) for k in ("q", "k", "v", "sw")), pw,
                                _t(bias), True)
    _, vjp = jax.vjp(jax_core, *args)
    jg = vjp(jnp.asarray(ct))
    jax_grads = dict(zip(("dq", "dk", "dv", "dsw"), jg[:4]))
    jax_grads.update({k: np.asarray(g).T if k in _LINEAR else g
                      for k, g in zip(_W_ORDER, jg[4:12])})
    jax_grads["bias"] = jg[12]
    for name, g in got.items():
        _assert_close(g.numpy(), getattr(plain, name).numpy(), f"{name} vs plain")
        _assert_close(g.numpy(), np.asarray(jax_grads[name]), f"{name} vs JAX")


# ---------------------------------------------------------- (d) the model
def test_hat_ws16_mlp4_gradients_match_jax():
    """(d): a HAT at window 16, C 180, 6 heads, mlp 4 (hidden 720), one
    RHAG of depth 2, reflect-padded to 32 x 32 so that the second HAB
    shifts, in train mode (drop path off): the L1 loss and every
    parameter's gradient against jax.value_and_grad of the JAX HAT with
    train=True; the port's HABs take the K7 route (trained by K5w16 on
    the card) and its OCAB the fused route (K8w16 / K8bw16 there)."""
    from tests.test_torch_hat import small_hat_config
    from tests.test_torch_hat_train import _assert_grad_close
    from tests.util_torchport import perturbed_jax_swinir, port_from_jax
    from tpu_superresolution_torch.interop import hat_state_dict_from_jax

    cfg = small_hat_config(embed_dim=C16, depths=(2,), num_heads=(NH16,), window_size=16,
                           mlp_ratio=4.0, squeeze_factor=30, gelu_approximate=True,
                           drop_path_rate=0.0)
    jmodel, variables = perturbed_jax_swinir(cfg, (16, 16), seed=27)
    rng = np.random.default_rng(28)
    lr = rng.random((2, 20, 24, 3), dtype=np.float32)
    hr = rng.random((2, 80, 96, 3), dtype=np.float32)

    def loss_fn(params):
        out = jmodel.apply({"params": params}, jnp.asarray(lr), train=True)
        return jnp.mean(jnp.abs(out.astype(jnp.float32) - jnp.asarray(hr)))

    jloss, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    want = hat_state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)})
    model = port_from_jax(cfg, variables).train()
    layer = model.layers[0].residual_group
    assert [b.trains_on_block_kernel(32, 32) for b in layer.blocks] == [True, True]
    assert layer.overlap_attn.takes_k8() and layer.overlap_attn.mlp.fc1.out_features == HID16
    loss = (model(torch.from_numpy(lr)) - torch.from_numpy(hr)).abs().mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert sorted(n for n, _ in model.named_parameters()) == sorted(want)
    for name, prm in model.named_parameters():
        assert prm.grad is not None and torch.isfinite(prm.grad).all(), name
        _assert_grad_close(prm.grad.numpy(), want[name], name)


# ------------------------------------------------------- (e) CLI, export
JAX_CLI_HAT_FLAGS = ["--model", "hat", "--window_size", "16", "--embed_dim", "180",
                     "--t_depths", "6,6,6,6,6,6", "--t_heads", "6,6,6,6,6,6"]


def test_train_cli_with_the_jax_flags_trains_every_block_on_kernels():
    """(e): the port's ``train`` CLI with the JAX train CLI's flags (no
    ``--mlp_ratio``) builds the JAX CLI's model, mlp 4 (hidden 720), and
    on the train step's 64 x 64 maps every HAB trains on a block kernel's
    autograd function (K7 route, K5w16 backward) and every OCAB on the
    fused route (K8w16 / K8bw16), which serves it too; shapes only."""
    import dataclasses

    from tpu_superresolution_tpu.cli.train import build_argparser as jax_argparser
    from tpu_superresolution_tpu.core.config import HATConfig as JaxHATConfig
    from tpu_superresolution_torch.cli.train import build_argparser, model_config_from_args
    from tpu_superresolution_torch.core.config import build_model

    flags = ["--data_root", "d", "--scale", "X4"] + JAX_CLI_HAT_FLAGS
    cfg = model_config_from_args(build_argparser().parse_args(flags))
    # the JAX CLI's model: HATConfig(scale) with these four fields replaced
    # (cli/train.py main); it has no --mlp_ratio
    jargs = jax_argparser().parse_args(flags)
    with pytest.raises(SystemExit):
        jax_argparser().parse_args(flags + ["--mlp_ratio", "2"])
    jcfg = dataclasses.replace(
        JaxHATConfig(scale=4), embed_dim=jargs.embed_dim, window_size=jargs.window_size,
        depths=tuple(int(d) for d in jargs.t_depths.split(",")),
        num_heads=tuple(int(h) for h in jargs.t_heads.split(",")))
    fields = ("window_size", "embed_dim", "depths", "num_heads", "mlp_ratio", "overlap_ratio",
              "compress_ratio", "squeeze_factor", "gelu_approximate", "qkv_bias")
    assert {k: getattr(cfg, k) for k in fields} == {k: getattr(jcfg, k) for k in fields}
    assert (cfg.window_size, cfg.embed_dim, cfg.mlp_ratio) == (16, 180, 4.0)
    with torch.device("meta"):
        model = build_model(cfg)
    habs = [b for layer in model.layers for b in layer.residual_group.blocks]
    ocabs = [layer.residual_group.overlap_attn for layer in model.layers]
    assert len(habs) == 36 and len(ocabs) == 6
    assert {b.mlp.fc1.out_features for b in habs} == {720}
    assert all(b.trains_on_block_kernel(64, 64) for b in habs)
    assert all(o.takes_k8() for o in ocabs)
    assert all(o.eval().takes_fused() for o in ocabs)


def test_mlp4_hat_exports_with_k8w16(monkeypatch):
    """A HAT at window 16, C 180, mlp 4 exported on the meta device: its
    OCAB is one ``tpu_sr::ocab16`` node (K8w16 at hidden 720; before, the
    module path: K15 and its LN2's K2), each HAB K2 + K7 + K1t and K12."""
    from tests.test_torch_port_export import _program_launches
    from tpu_superresolution_torch.core.config import HATConfig, build_model
    from tpu_superresolution_torch.kernels import _lib

    cfg = HATConfig(window_size=16, embed_dim=C16, depths=(2,), num_heads=(NH16,),
                    squeeze_factor=30)
    assert cfg.mlp_ratio == 4.0
    with torch.device("meta"):
        model = build_model(cfg).eval()
    x = torch.empty((1, 32, 32, 3), device="meta")
    with monkeypatch.context() as m:
        m.setattr(_lib, "exporting", lambda: True)
        with torch.no_grad():
            model(x)
    with torch.no_grad():
        program = torch.export.export(model, (x,), strict=False)
    assert _program_launches(program) == dict(K1t=2, K7=2, K12=2, K8w16=1, K2=5, K3=3, K4=1)
