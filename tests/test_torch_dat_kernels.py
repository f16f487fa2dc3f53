"""The plain versions of DAT's three kernels in the PyTorch port (K9 the
spatial front, K14 the channel front, K10 the block tail), and its
BatchNorm folding, against the JAX package's Pallas kernels called
directly in interpret mode: the same numpy-seeded inputs, fp32 on the
CPU (where the port's wrappers run their plain versions), bound 3e-5
max abs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import TOL

torch.set_num_threads(1)

B, H, W, C, NH = 2, 16, 32, 32, 2
SPLIT = (4, 8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _front_inputs(seed, num_bias_tables):
    """x, LN1, the qkv Dense (flax [C, 3C]), a folded depthwise kernel
    [3, 3, 1, C] and bias, and `num_bias_tables` [nh/2, N, N] tables."""
    rng = np.random.default_rng(seed)
    n = SPLIT[0] * SPLIT[1]
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    return dict(
        x=f(B, H, W, C), g1=1 + f(C, sc=0.1), b1=f(C, sc=0.1),
        wqkv=f(C, 3 * C, sc=C ** -0.5), bqkv=f(3 * C, sc=0.1),
        wdw=f(3, 3, 1, C, sc=1 / 3), bdw=f(C, sc=0.1),
        biases=[f(NH // 2, n, n, sc=0.5) for _ in range(num_bias_tables)],
        temperature=1 + f(NH, 1, 1, sc=0.3),
    )


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_rect_attention_matches_jax_kernel(shifted):
    """K9's plain version against ``fused_rect_attention`` (its
    pre-rolled inputs and rolled outputs undone here), both branches and
    the conv branch."""
    from tpu_superresolution_tpu.ops.pallas.fused_rect_attn import fused_rect_attention
    from tpu_superresolution_tpu.ops.window import rect_shift_region_ids
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels.fused_rect_attn import RectAttnWeights, rect_attention

    a = _front_inputs(0 + shifted, 2)
    s0, s1 = SPLIT
    sh0, sh1 = s0 // 2, s1 // 2
    x = a["x"]
    xr0 = xr1 = m0 = m1 = None
    if shifted:
        xr0 = jnp.roll(x, (-sh0, -sh1), axis=(1, 2))
        xr1 = jnp.roll(x, (-sh1, -sh0), axis=(1, 2))
        m0 = rect_shift_region_ids(H, W, s0, s1, sh0, sh1)
        m1 = rect_shift_region_ids(H, W, s1, s0, sh1, sh0)
    o0, o1, conv = fused_rect_attention(
        jnp.asarray(x), xr0, xr1, a["g1"], a["b1"], a["wqkv"], a["bqkv"], a["wdw"], a["bdw"],
        a["biases"][0], a["biases"][1], m0, m1, s0, s1, NH, interpret=True)
    if shifted:
        o0 = jnp.roll(o0, (sh0, sh1), axis=(1, 2))
        o1 = jnp.roll(o1, (sh1, sh0), axis=(1, 2))
    want_att = np.concatenate([np.asarray(o0), np.asarray(o1)], axis=-1)

    w = RectAttnWeights(
        g1=_t(a["g1"]), b1=_t(a["b1"]), wqkv=_t(a["wqkv"].T), bqkv=_t(a["bqkv"]),
        wdw=_t(a["wdw"][:, :, 0]), bdw=_t(a["bdw"]), bias0=_t(a["biases"][0]),
        bias1=_t(a["biases"][1]), num_heads=NH, split=SPLIT)
    reset_counters()
    att, cx = rect_attention(_t(x), w, shifted)
    assert not any(read_counters().values())
    assert att.shape == cx.shape == (B, H, W, C)
    assert np.abs(att.numpy() - want_att).max() <= TOL
    assert np.abs(cx.numpy() - np.asarray(conv)).max() <= TOL


def test_channel_attention_matches_jax_kernel():
    """K14's plain version against ``fused_channel_attention``."""
    from tpu_superresolution_tpu.ops.pallas.fused_channel_attn import fused_channel_attention
    from tpu_superresolution_torch.kernels.fused_channel_attn import (
        ChanAttnWeights,
        channel_attention,
    )

    a = _front_inputs(2, 0)
    att_j, conv_j = fused_channel_attention(
        jnp.asarray(a["x"]), a["g1"], a["b1"], a["wqkv"], a["bqkv"], a["temperature"],
        a["wdw"], a["bdw"], NH, interpret=True)
    w = ChanAttnWeights(
        g1=_t(a["g1"]), b1=_t(a["b1"]), wqkv=_t(a["wqkv"].T), bqkv=_t(a["bqkv"]),
        temperature=_t(a["temperature"]), wdw=_t(a["wdw"][:, :, 0]), bdw=_t(a["bdw"]),
        num_heads=NH)
    att, cx = channel_attention(_t(a["x"]), w)
    assert np.abs(att.numpy() - np.asarray(att_j)).max() <= TOL
    assert np.abs(cx.numpy() - np.asarray(conv_j)).max() <= TOL


def test_datb_tail_matches_jax_kernel():
    """K10's plain version against ``fused_datb_tail`` (flax [in, out]
    layouts there, torch [out, in] here)."""
    from tpu_superresolution_tpu.ops.pallas.fused_datb_tail import fused_datb_tail
    from tpu_superresolution_torch.kernels.fused_datb_tail import TailWeights, datb_tail

    rng = np.random.default_rng(3)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    hid, half, m = 2 * C, C, C // 16
    x, u, w_px = f(B, H, W, C), f(B, H, W, C), f(B, H, W, C)
    gate = 1 / (1 + np.exp(-f(B, C)))
    j = dict(sp_w1=f(C, m, sc=C ** -0.5), sp_b1=f(m, sc=0.1), sp_w2=f(m, 1), sp_b2=f(1, sc=0.1),
             wproj=f(C, C, sc=C ** -0.5), bproj=f(C, sc=0.1), g2=1 + f(C, sc=0.1),
             b2=f(C, sc=0.1), wfc1=f(C, hid, sc=C ** -0.5), bfc1=f(hid, sc=0.1),
             gsg=1 + f(half, sc=0.1), bsg=f(half, sc=0.1), wdw=f(3, 3, 1, half, sc=1 / 3),
             bdw=f(half, sc=0.1), wfc2=f(half, C, sc=half ** -0.5), bfc2=f(C, sc=0.1))
    want = fused_datb_tail(*(jnp.asarray(v) for v in (x, u, w_px, gate)),
                           *(jnp.asarray(v) for v in j.values()), interpret=True)
    tw = TailWeights(**{k: _t(v.T if k in ("sp_w1", "sp_w2", "wproj", "wfc1", "wfc2") else v)
                        for k, v in j.items() if k != "wdw"}, wdw=_t(j["wdw"][:, :, 0]))
    got = datb_tail(_t(x), _t(u), _t(w_px), _t(gate), tw)
    assert got.shape == (B, H, W, C)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


def test_bn_folding_matches_jax():
    """The port's fold_bn_into_dense against the JAX package's, on a
    dense kernel [in, out] and on a depthwise kernel [3, 3, C]."""
    from tpu_superresolution_tpu.ops.pallas.fused_datb_tail import fold_bn_into_dense as jfold
    from tpu_superresolution_torch.kernels.fused_datb_tail import fold_bn_into_dense

    rng = np.random.default_rng(4)
    for shape in ((24, 12), (3, 3, 12)):
        wk = rng.standard_normal(shape).astype(np.float32)
        bk, scale, bias, mean = (rng.standard_normal(12).astype(np.float32) for _ in range(4))
        var = (0.5 + rng.random(12)).astype(np.float32)
        jw, jb = jfold(*(jnp.asarray(v) for v in (wk, bk, scale, bias, mean, var)))
        pw, pb = fold_bn_into_dense(*(_t(v) for v in (wk, bk, scale, bias, mean, var)))
        assert np.abs(pw.numpy() - np.asarray(jw)).max() <= 1e-6
        assert np.abs(pb.numpy() - np.asarray(jb)).max() <= 1e-6


def test_rect_geometry_matches_jax():
    """Rect partition / reverse, region ids, the -100 mask, the
    rectangular relative-position index and the offset table."""
    from tpu_superresolution_tpu.models.dat import _rpe_biases
    from tpu_superresolution_tpu.ops import window as jw
    from tpu_superresolution_torch.ops import window as pw

    x = np.random.default_rng(5).standard_normal((2, 16, 24, 3)).astype(np.float32)
    part = pw.rect_window_partition(_t(x), 8, 4)
    np.testing.assert_array_equal(part.numpy(), np.asarray(jw.rect_window_partition(x, 8, 4)))
    np.testing.assert_array_equal(pw.rect_window_reverse(part, 8, 4, 16, 24).numpy(), x)
    for args in ((16, 32, 4, 8, 2, 4), (32, 16, 8, 4, 4, 2), (16, 16, 8, 16 // 2, 4, 0)):
        np.testing.assert_array_equal(pw.rect_shift_region_ids(*args),
                                      jw.rect_shift_region_ids(*args))
        mask = pw.rect_shift_attn_mask(*args)
        np.testing.assert_array_equal(mask, jw.rect_shift_attn_mask(*args))
        assert set(np.unique(mask)) <= {0.0, -100.0}
    for hsp, wsp in ((8, 16), (16, 8), (4, 8)):
        np.testing.assert_array_equal(pw.relative_position_index(hsp, wsp),
                                      jw.relative_position_index(hsp, wsp))
        np.testing.assert_array_equal(pw.rpe_biases(hsp, wsp), _rpe_biases(hsp, wsp))
    np.testing.assert_array_equal(pw.relative_position_index(7), jw.relative_position_index(7))


def test_dat_wrappers_refuse_devices_without_a_kernel():
    """A tensor on neither the CPU nor CUDA gets neither version."""
    from tpu_superresolution_torch.kernels.fused_channel_attn import ChanAttnWeights, channel_attention

    e = torch.empty(4, device="meta")
    w = ChanAttnWeights(g1=e, b1=e, wqkv=torch.empty(12, 4, device="meta"), bqkv=None,
                        temperature=e, wdw=e, bdw=e, num_heads=2)
    with pytest.raises(ValueError, match="no kernel"):
        channel_attention(torch.empty(1, 8, 8, 4, device="meta"), w)
