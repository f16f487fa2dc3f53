"""The window-size-generic Swin block of the PyTorch port (K1 at ws 8,
K6 at ws 7, with HAT's `extra` term): its argument checks, which run on
any device, and its plain version against the JAX package's block
kernels in interpret mode (K1 with `extra`, K6 on partitioned and
token-padded windows, K13 on the spatial map), fp32 on the CPU, bound
3e-5 max abs; and SwinIR at window 7 against the JAX einsum path and
its K7 kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import (
    TOL,
    jax_forward,
    perturbed_jax_swinir,
    port_forward,
    port_from_jax,
    small_swinir_config,
)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------- the block kernel's checks


def _block_weights(rng, c=32, nh=2, hidden=64, ws=7):
    """Port block weights ([out, in]) and the JAX kernels' argument list
    ([in, out]) of one seeded block."""
    from tpu_superresolution_torch.kernels.fused_block import SwinBlockWeights

    n = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    p = dict(g1=1 + n(c, sc=0.1), b1=n(c, sc=0.1),
             wqkv=n(c, 3 * c, sc=c ** -0.5), bqkv=n(3 * c, sc=0.1),
             wproj=n(c, c, sc=c ** -0.5), bproj=n(c, sc=0.1),
             g2=1 + n(c, sc=0.1), b2=n(c, sc=0.1),
             wfc1=n(c, hidden, sc=c ** -0.5), bfc1=n(hidden, sc=0.1),
             wfc2=n(hidden, c, sc=hidden ** -0.5), bfc2=n(c, sc=0.1))
    table = n((2 * ws - 1) ** 2, nh)
    order = ("g1", "b1", "wqkv", "bqkv", "wproj", "bproj", "g2", "b2",
             "wfc1", "bfc1", "wfc2", "bfc2")
    lin = ("wqkv", "wproj", "wfc1", "wfc2")
    w = SwinBlockWeights(table=_t(table), num_heads=nh,
                         **{k: _t(p[k].T if k in lin else p[k]) for k in order})
    return w, [jnp.asarray(p[k]) for k in order], table


@pytest.mark.parametrize("ws,ok", [(7, True), (8, True), (16, False), (6, False)])
def test_block_args_accept_ws_7_and_8_only(ws, ok):
    """The generic wrapper's argument check (shapes only: it runs here)
    takes ws 7 and 8 and names the window of anything else."""
    from tpu_superresolution_torch.kernels.fused_block import check_block_args

    w, _, _ = _block_weights(np.random.default_rng(ws), ws=ws)
    shape = (2, 2 * ws, 3 * ws, 32)
    if ok:
        check_block_args(shape, w, ws, ws // 2)
    else:
        with pytest.raises(ValueError, match=f"ws={ws}"):
            check_block_args(shape, w, ws, ws // 2)


def test_block_args_reject_widths_and_shapes_outside_the_kernel():
    from tpu_superresolution_torch.kernels.fused_block import check_block_args

    w, _, _ = _block_weights(np.random.default_rng(0), c=32, nh=2, hidden=64, ws=7)
    for shape, shift, match in (((2, 15, 21, 32), 0, "multiples of 7"),
                                ((2, 14, 21, 32), 7, "shift 7"),
                                ((2, 14, 21, 16), 0, "C=32")):
        with pytest.raises(ValueError, match=match):
            check_block_args(shape, w, 7, shift)
    wide, _, _ = _block_weights(np.random.default_rng(1), c=224, nh=7, hidden=448, ws=7)
    with pytest.raises(ValueError, match="C=224"):
        check_block_args((1, 7, 7, 224), wide, 7, 0)
    with pytest.raises(ValueError, match="ws=8"):  # table for ws 7, block run at 8
        check_block_args((2, 16, 24, 32), w, 8, 0)


@pytest.mark.parametrize("ws,c,nh", [(16, 32, 2), (6, 32, 2), (7, 224, 7)])
def test_blocks_the_kernel_refuses_take_the_k7_route(ws, c, nh, monkeypatch):
    """The windows and widths the block kernel's checks above refuse
    are a block route's business, not an error: block_route sends them
    to the K7 route, and a HAB of that shape (on the CPU: each wrapper's
    plain version) runs K7's wrapper once and equals swin_block_plain
    with its CAB term."""
    from tpu_superresolution_torch.kernels.fused_block import block_route, swin_block_plain
    from tpu_superresolution_torch.models import swinir
    from tpu_superresolution_torch.models.hat import HAB
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    assert block_route(ws, c, nh, 2 * c) == "window_attention"
    gen = torch.Generator().manual_seed(ws + c)
    hab = HAB(c, nh, ws, ws // 2, 3, 4, 0.3, 2.0, True, False)
    with torch.no_grad():
        for p in hab.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    calls = []
    real = swinir.fused_window_attention
    monkeypatch.setattr(swinir, "fused_window_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.randn(2, 2 * ws, 3 * ws, c, generator=gen)
    with torch.no_grad():
        got = hab(x)
        extra = hab.conv_block(x, hab.norm1) * hab.conv_scale
        mask = shift_mask_tensor(2 * ws, 3 * ws, ws, ws // 2, x.device)
        want = swin_block_plain(x, hab.block_weights(), ws, ws // 2, mask, False, extra=extra)
    assert calls == [1]
    assert (got - want).abs().max() <= 1e-5


@pytest.mark.parametrize("ws,with_extra,ok", [(8, False, True), (8, True, True),
                                              (7, False, True), (7, True, True),
                                              (6, False, False)])
def test_gradient_check_names_the_training_slice(ws, with_extra, ok):
    """A gradient through the block kernel exists at its windows, ws 8
    (K5) and ws 7 (K6's backward), with or without `extra` (HAT
    training); a window the kernel cannot take raises instead of running
    plain autograd."""
    from tpu_superresolution_torch.kernels.fused_block import check_differentiable

    extra = torch.zeros(1) if with_extra else None
    if ok:
        check_differentiable(ws, extra, "block")
    else:
        with pytest.raises(NotImplementedError, match="ws=6"):
            check_differentiable(ws, extra, "block")


def _jax_block_cases():
    return [("K6 packed", 7, 0), ("K6 packed", 7, 3), ("K13 spatial", 7, 3),
            ("K1 strip", 8, 4)]


@pytest.mark.parametrize("oracle,ws,shift", _jax_block_cases(),
                         ids=[f"{o.split()[0]}-ws{w}-s{s}" for o, w, s in _jax_block_cases()])
def test_block_with_extra_matches_jax_kernels(oracle, ws, shift):
    """swin_block_plain with `extra` and branch scales (what the wrapper
    runs on CPU tensors) against the JAX kernel in interpret mode."""
    from tpu_superresolution_tpu.ops.pallas import fused_block as jfb
    from tpu_superresolution_tpu.ops.window import (
        cyclic_shift,
        cyclic_unshift,
        relative_position_index,
        shift_attn_mask,
        window_partition,
        window_reverse,
    )
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels.fused_block import fused_windows_block
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    rng = np.random.default_rng(ws * 10 + shift)
    w, args, table = _block_weights(rng, ws=ws)
    b, h, wd, c, nh = 2, 2 * ws, 3 * ws, 32, 2
    x = rng.standard_normal((b, h, wd, c)).astype(np.float32)
    extra = (0.5 * rng.standard_normal((b, h, wd, c))).astype(np.float32)
    scales = np.array([[1 / 0.9, 0.0], [1 / 0.9, 1 / 0.9]], np.float32)
    n = ws * ws
    bias = table[relative_position_index(ws).reshape(-1)].reshape(n, n, nh).transpose(2, 0, 1)
    mask = shift_attn_mask(h, wd, ws, shift) if shift else None
    scale = (c // nh) ** -0.5
    xs, es = cyclic_shift(jnp.asarray(x), shift), cyclic_shift(jnp.asarray(extra), shift)
    sc = jnp.asarray(scales)
    if oracle == "K1 strip":
        out = jfb.fused_swin_block(xs, *args, jnp.asarray(bias), ws, mask, scale, True,
                                   interpret=True, extra=es, branch_scales=sc)
    elif oracle == "K13 spatial":
        out = jfb.fused_spatial_windows_block(xs, *args, jnp.asarray(bias), ws, mask, scale,
                                              True, interpret=True, extra=es, branch_scales=sc)
    else:  # the caller's partition, token pad and window-count pad (models/hat.py:330-360)
        n_win = (h // ws) * (wd // ws)
        npad, wpad = (-n) % 8, (-n_win) % jfb.PACKED_GROUP
        pads = ((0, 0), (0, wpad), (0, npad), (0, 0))
        part = lambda a: jnp.pad(window_partition(a, ws).reshape(b, n_win, n, c), pads).reshape(
            b * (n_win + wpad), n + npad, c)
        bias_p = np.pad(bias, ((0, 0), (0, npad), (0, npad)), constant_values=-1e9)
        mask_p = None if mask is None else np.pad(mask, ((0, wpad), (0, npad), (0, npad)))
        outw = jfb.fused_packed_windows_block(part(xs), *args, jnp.asarray(bias_p), mask_p,
                                              scale, True, interpret=True, extra=part(es),
                                              branch_scales=sc)
        outw = outw.reshape(b, n_win + wpad, n + npad, c)[:, :n_win, :n]
        out = window_reverse(outw.reshape(b * n_win, n, c), ws, h, wd)
    want = np.asarray(cyclic_unshift(out, shift))

    reset_counters()
    tmask = shift_mask_tensor(h, wd, ws, shift, torch.device("cpu")) if shift else None
    got = fused_windows_block(_t(x), w, ws, shift, tmask, True, extra=_t(extra),
                              branch_scales=_t(scales)).numpy()
    assert not any(read_counters().values())  # CPU tensors: the plain version ran
    assert np.abs(got - want).max() <= TOL
    # `extra` really moved the block: dropping it changes the output
    without = fused_windows_block(_t(x), w, ws, shift, tmask, True,
                                  branch_scales=_t(scales)).numpy()
    assert np.abs(without - want).max() > 100 * TOL


def test_packed_block_weights_carry_the_window():
    from tpu_superresolution_torch.kernels.fused_block import pack_block_weights

    for ws in (7, 8):
        w, _, _ = _block_weights(np.random.default_rng(ws), ws=ws)
        packed = pack_block_weights(w)
        assert packed.window_size == ws and w.window_size == ws
        assert tuple(packed.rpb.shape) == (2, ws * ws, ws * ws)


@pytest.mark.parametrize("impl", ["jnp", "fused"])
def test_swinir_ws7_matches_jax(impl):
    """SwinIR with window_size=7 (a checkpoint the port used to refuse on
    CUDA): the JAX einsum path and its K7 kernel in interpret mode."""
    cfg = small_swinir_config(window_size=7, attention_impl=impl)
    model, variables = perturbed_jax_swinir(cfg, (14, 21))
    x = np.random.default_rng(2).random((2, 13, 16, 3), dtype=np.float32)
    want = jax_forward(model, variables, x)
    got = port_forward(port_from_jax(cfg, variables), x)
    assert got.shape == want.shape == (2, 52, 64, 3)
    assert np.abs(got - want).max() <= TOL
