"""The plain versions of DAT's three kernels in the PyTorch port (K9 the
spatial front, K14 the channel front, K10 the block tail), and its
BatchNorm folding, against the JAX package's Pallas kernels called
directly in interpret mode: the same numpy-seeded inputs, fp32 on the
CPU (where the port's wrappers run their plain versions), bound 3e-5
max abs.  K10's host side too: its envelope and launch plan, and its
band schedule written out in torch ops on the packed operands, against
the plain version and the JAX kernel (3e-5)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.util_torchport import TOL

torch.set_num_threads(1)

B, H, W, C, NH = 2, 16, 32, 32, 2
SPLIT = (4, 8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _front_inputs(seed, num_bias_tables, split=SPLIT, shape=(B, H, W)):
    """x, LN1, the qkv Dense (flax [C, 3C]), a folded depthwise kernel
    [3, 3, 1, C] and bias, and `num_bias_tables` [nh/2, N, N] tables."""
    rng = np.random.default_rng(seed)
    n = split[0] * split[1]
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    return dict(
        x=f(*shape, C), g1=1 + f(C, sc=0.1), b1=f(C, sc=0.1),
        wqkv=f(C, 3 * C, sc=C ** -0.5), bqkv=f(3 * C, sc=0.1),
        wdw=f(3, 3, 1, C, sc=1 / 3), bdw=f(C, sc=0.1),
        biases=[f(NH // 2, n, n, sc=0.5) for _ in range(num_bias_tables)],
        temperature=1 + f(NH, 1, 1, sc=0.3),
    )


# (shifted, split, image [B, H, W]): DAT's split at test size, and the
# published DAT x4's (8, 32), N 256, on an image whose sides are
# multiples of 32
_RECT_CASES = [(False, SPLIT, (B, H, W)), (True, SPLIT, (B, H, W)),
               (False, (8, 32), (1, 64, 64)), (True, (8, 32), (1, 64, 64))]


@pytest.mark.parametrize("shifted,split,shape", _RECT_CASES,
                         ids=["unshifted", "shifted", "split-8x32-unshifted", "split-8x32-shifted"])
def test_rect_attention_matches_jax_kernel(shifted, split, shape):
    """K9's plain version against ``fused_rect_attention`` (its
    pre-rolled inputs and rolled outputs undone here), both branches and
    the conv branch."""
    from tpu_superresolution_tpu.ops.pallas.fused_rect_attn import fused_rect_attention
    from tpu_superresolution_tpu.ops.window import rect_shift_region_ids
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels.fused_rect_attn import RectAttnWeights, rect_attention

    a = _front_inputs(0 + shifted + 7 * (split != SPLIT), 2, split, shape)
    s0, s1 = split
    b, h, wd = shape
    sh0, sh1 = s0 // 2, s1 // 2
    x = a["x"]
    xr0 = xr1 = m0 = m1 = None
    if shifted:
        xr0 = jnp.roll(x, (-sh0, -sh1), axis=(1, 2))
        xr1 = jnp.roll(x, (-sh1, -sh0), axis=(1, 2))
        m0 = rect_shift_region_ids(h, wd, s0, s1, sh0, sh1)
        m1 = rect_shift_region_ids(h, wd, s1, s0, sh1, sh0)
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
        bias1=_t(a["biases"][1]), num_heads=NH, split=split)
    reset_counters()
    att, cx = rect_attention(_t(x), w, shifted)
    assert not any(read_counters().values())
    assert att.shape == cx.shape == (b, h, wd, C)
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


def _tail_case(seed, b, h, w, c, half):
    """x, u, w_px, the sigmoided gate and a tail's weights in the JAX
    package's flax layouts ([in, out]; wdw [3, 3, 1, half])."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    m = c // 16
    x, u, w_px = f(b, h, w, c), f(b, h, w, c), f(b, h, w, c)
    gate = 1 / (1 + np.exp(-f(b, c)))
    j = dict(sp_w1=f(c, m, sc=c ** -0.5), sp_b1=f(m, sc=0.1), sp_w2=f(m, 1), sp_b2=f(1, sc=0.1),
             wproj=f(c, c, sc=c ** -0.5), bproj=f(c, sc=0.1), g2=1 + f(c, sc=0.1),
             b2=f(c, sc=0.1), wfc1=f(c, 2 * half, sc=c ** -0.5), bfc1=f(2 * half, sc=0.1),
             gsg=1 + f(half, sc=0.1), bsg=f(half, sc=0.1), wdw=f(3, 3, 1, half, sc=1 / 3),
             bdw=f(half, sc=0.1), wfc2=f(half, c, sc=half ** -0.5), bfc2=f(c, sc=0.1))
    return (x, u, w_px, gate), j


def _torch_tail_weights(j):
    from tpu_superresolution_torch.kernels.fused_datb_tail import TailWeights

    return TailWeights(**{k: _t(v.T if k in ("sp_w1", "sp_w2", "wproj", "wfc1", "wfc2") else v)
                          for k, v in j.items() if k != "wdw"}, wdw=_t(j["wdw"][:, :, 0]))


def _jax_tail(acts, j):
    from tpu_superresolution_tpu.ops.pallas.fused_datb_tail import fused_datb_tail

    return np.asarray(fused_datb_tail(*(jnp.asarray(v) for v in acts),
                                      *(jnp.asarray(v) for v in j.values()), interpret=True))


@pytest.mark.parametrize("c,half", [(32, 32), (32, 64), (40, 80)],
                         ids=["c32-half32", "c32-half64", "c40-half80"])
def test_datb_tail_matches_jax_kernel(c, half):
    """K10's plain version against ``fused_datb_tail`` (flax [in, out]
    layouts there, torch [out, in] here); the SGFN half C and 2C (the
    published DAT x4's ratio), and a width that is not a multiple of 16."""
    from tpu_superresolution_torch.kernels.fused_datb_tail import datb_tail

    acts, j = _tail_case(3 + c + half, B, H, W, c, half)
    want = _jax_tail(acts, j)
    got = datb_tail(*(_t(v) for v in acts), _torch_tail_weights(j))
    assert got.shape == (B, H, W, c)
    assert np.abs(got.numpy() - want).max() <= TOL


def test_tail_plan_and_envelope():
    """K10's envelope (C <= 192, half <= 384, width <= 16) and its launch
    plan from static shapes: bands of about one unit an SM, strips with a
    halo column past W 64, the weight ring's stages within the shared
    memory at every padded width and half; the wrapper's check names the
    limits."""
    from tpu_superresolution_torch.kernels import fused_datb_tail as ft

    assert ft.tail_ok(180, 180, 11) and ft.tail_ok(180, 360, 11) and ft.tail_ok(192, 384, 12)
    assert not ft.tail_ok(193, 180, 12) and not ft.tail_ok(180, 385, 11)
    assert not ft.tail_ok(180, 180, 17)
    p = ft.tail_plan(25, 64, 64, 180, 180, 132)  # DATConfig()'s tail on the bench batch
    assert (p.cp, p.hp, p.halo, p.seg, p.strips) == (192, 192, 0, 64, 1)
    assert (p.band, p.nbands, p.units, p.grid, p.stages) == (13, 5, 125, 125, 8)
    p = ft.tail_plan(25, 64, 64, 180, 360, 132)  # the published x4's
    assert (p.hp, p.stages, p.grid) == (384, 2, 125) and p.smem <= ft.SMEM_LIMIT
    p = ft.tail_plan(2, 52, 76, 180, 180, 132)
    assert (p.halo, p.seg, p.strips, p.band, p.nbands, p.units) == (1, 62, 2, 2, 26, 104)
    for c in range(16, 193, 16):
        for half in range(16, 385, 16):
            p = ft.tail_plan(1, 8, 8, c, half, 132)
            assert 2 <= p.stages <= ft.MAX_STAGES and p.smem <= ft.SMEM_LIMIT
            assert p.cp % 64 == 0 and p.hp % 64 == 0 and p.cp >= c and p.hp >= half
    with pytest.raises(ValueError, match="outside the kernel"):
        ft.tail_plan(1, 8, 8, 180, 400, 132)
    _, j = _tail_case(9, 1, 1, 1, 208, 104)
    with pytest.raises(ValueError, match="C <= 192, an SGFN half <= 384"):
        ft.check_tail_args((1, 8, 8, 208), _torch_tail_weights(j))


def _tail_emulated(x, u, w_px, gate, pk, plan):
    """K10's schedule in torch ops on its packed operands (fp32): the
    stream's tiles unswizzled in the feeder's order; per unit (image,
    strip, band) the chain on the band's rows and its two halo rows (a
    row outside the image: a zero h2 row), LN_sg's statistics summed over
    64-column chunks, a ring of three h2 rows, row t - 1's output after
    row t's chain, the depthwise conv over tile rows (zero outside the
    tile), the strip's output columns stored.  Returns the output and how
    often each pixel was stored."""
    from tests.test_torch_block_wg import _Stream
    from tpu_superresolution_torch.kernels.fused_datb_tail import LN_EPS, SPP, vec_offsets

    b, h, wd, c = x.shape
    half, cp, hp = pk.half, pk.cp, pk.hp
    kc, hpc = cp // 64, hp // 64
    s = _Stream(pk.tiles)
    sp = torch.cat([s.next(SPP) for _ in range(kc)], 1)
    proj = torch.zeros(cp, cp)
    for i in range(kc):
        for n in range(kc):
            proj[64 * n:64 * n + 64, 64 * i:64 * i + 64] = s.next(64)
    fc1b = torch.cat([torch.cat([s.next(64) for _ in range(kc)], 1) for _ in range(hpc)])
    fc1a, fc2 = [], []
    for _ in range(hpc):
        fc1a.append(torch.cat([s.next(64) for _ in range(kc)], 1))
        fc2.append(torch.cat([s.next(64) for _ in range(kc)]))
    assert s.done()
    fc1a, fc2 = torch.cat(fc1a), torch.cat(fc2, 1)
    o = vec_offsets(cp, hp)
    v = lambda key, n: pk.vec[o[key]:o[key] + n]
    taps = pk.vec[o["wdw"]:o["bdw"]].view(3, 3, hp)
    pad = lambda t: F.pad(t, (0, cp - c))

    def ln(t, g, bb, n):
        mu = t.sum(-1, keepdim=True) / n
        var = ((t * t).sum(-1, keepdim=True) / n - mu * mu).clamp_min(0)
        return (t - mu) * torch.rsqrt(var + LN_EPS) * g + bb

    out = torch.full_like(x, float("nan"))
    stored = torch.zeros(b, h, wd, dtype=torch.int32)
    for un in range(plan.units):
        band, rest = un % plan.nbands, un // plan.nbands
        strip, img = rest % plan.strips, rest // plan.strips
        r0 = band * plan.band
        r1 = min(r0 + plan.band, h)
        cols = strip * plan.seg - plan.halo + torch.arange(64)
        valid = (cols >= 0) & (cols < wd)
        is_out = (cols >= strip * plan.seg) & (cols < min(strip * plan.seg + plan.seg, wd))
        cl = cols.clamp(0, wd - 1)
        ring, ys, x2s = {}, {}, {}
        for t in range(r0 - 1, r1 + 1):
            k = t - r0 + 1
            if not 0 <= t < h:
                ring[k % 3] = torch.zeros(64, hp)
            else:
                row = lambda a: pad(a[img, t, cl] * valid[:, None])
                uu, ww, xx = row(u), row(w_px), row(x)
                pm = F.gelu(uu @ sp.t() + v("spb1", SPP)) @ v("spw2", SPP) + v("spb2", 1)
                sg = uu * pad(gate[img]) + ww * torch.sigmoid(pm)[:, None]
                x2s[k % 2] = xx + sg @ proj.t() + v("bproj", cp)
                ys[k % 2] = ln(x2s[k % 2], v("g2", cp), v("b2", cp), c)
                h2 = F.gelu(ys[k % 2] @ fc1b.t() + pk.vec[o["bfc1"] + hp:o["gsg"]])
                chunks = h2.split(64, -1)
                s1 = sum(ch.sum(-1, keepdim=True) for ch in chunks) / half
                s2 = sum((ch * ch).sum(-1, keepdim=True) for ch in chunks) / half
                rs = torch.rsqrt((s2 - s1 * s1).clamp_min(0) + LN_EPS)
                ring[k % 3] = ((h2 - s1) * rs * v("gsg", hp) + v("bsg", hp)) * valid[:, None]
            if t - 1 < r0:
                continue
            ko = k - 1
            rows = [ring[(ko + 2) % 3], ring[ko % 3], ring[(ko + 1) % 3]]
            d = v("bdw", hp).expand(64, hp).clone()
            for dy in range(3):
                padded = F.pad(rows[dy], (0, 0, 1, 1))  # tile rows outside [0, 64): zero
                for dx in range(3):
                    d = d + padded[dx:dx + 64] * taps[dy, dx]
            g = F.gelu(ys[ko % 2] @ fc1a.t() + v("bfc1", hp)) * d
            y = x2s[ko % 2] + g @ fc2.t() + v("bfc2", cp)
            out[img, t - 1, cols[is_out]] = y[is_out, :c]
            stored[img, t - 1, cols[is_out]] += 1
    return out, stored


_EMULATED = [
    # (b, h, w, c, half, sms): bands, strips, padded widths
    ((2, 9, 70, 40, 80, 5), "w70-two-strips-c40-half80"),
    ((1, 11, 24, 72, 144, 4), "w24-uneven-bands-cp128"),
    ((3, 5, 64, 32, 32, 2), "w64-one-row-tile"),
]


@pytest.mark.parametrize("shape", [s for s, _ in _EMULATED], ids=[i for _, i in _EMULATED])
def test_tail_schedule_emulated_matches_plain(shape):
    """K10's band schedule on its packed operands (``tail_plan``,
    ``pack_tail_weights`` in fp32) reproduces ``datb_tail_plain`` at fp32
    and stores every pixel once."""
    from tpu_superresolution_torch.kernels.fused_datb_tail import (
        datb_tail_plain,
        pack_tail_weights,
        tail_plan,
    )

    b, h, wd, c, half, sms = shape
    acts, j = _tail_case(70 + c, b, h, wd, c, half)
    tw = _torch_tail_weights(j)
    x, u, w_px, gate = (_t(a) for a in acts)
    got, stored = _tail_emulated(x, u, w_px, gate, pack_tail_weights(tw, torch.float32),
                                 tail_plan(b, h, wd, c, half, sms))
    assert torch.equal(stored, torch.ones_like(stored))
    want = datb_tail_plain(x, u, w_px, gate, tw)
    assert (got - want).abs().max().item() <= TOL


def test_tail_schedule_emulated_matches_jax_kernel():
    """The band schedule (two strips of a 70-wide map, bands of 3 rows,
    half 2C) against ``fused_datb_tail`` in interpret mode."""
    from tpu_superresolution_torch.kernels.fused_datb_tail import pack_tail_weights, tail_plan

    b, h, wd, c, half = 1, 16, 70, 40, 80
    acts, j = _tail_case(80, b, h, wd, c, half)
    want = _jax_tail(acts, j)
    x, u, w_px, gate = (_t(a) for a in acts)
    plan = tail_plan(b, h, wd, c, half, 12)
    assert (plan.strips, plan.band) == (2, 3)
    got, _ = _tail_emulated(x, u, w_px, gate,
                            pack_tail_weights(_torch_tail_weights(j), torch.float32), plan)
    assert np.abs(got.numpy() - want).max() <= TOL


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


# ------------------------------------------------ K9 / K14 on Hopper: host side


def _unpack_front(wp, c):
    """The product kernel's weight stream [6, chunks, 96, 64] back to its
    six N tiles [6, 96, C] (fp32; the 128B swizzle is an involution)."""
    from tpu_superresolution_torch.kernels.cab_conv import _swizzle_rows

    w = _swizzle_rows(wp.float())
    return w.transpose(1, 2).reshape(6, 96, -1)[..., :c]


def _table_weights(seed, split, nh=NH, c=C):
    """K9's weights with random DynamicPosBias tables and the dense
    biases gathered from them (``rect_bias_from_table``)."""
    from tpu_superresolution_torch.kernels.fused_rect_attn import (
        RectAttnWeights,
        rect_bias_from_table,
    )

    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: _t(sc * rng.standard_normal(s))
    s0, s1 = split
    tables = [f((2 * s0 - 1) * (2 * s1 - 1), nh // 2, sc=0.5) for _ in range(2)]
    return RectAttnWeights(
        g1=1 + f(c, sc=0.1), b1=f(c, sc=0.1), wqkv=f(3 * c, c, sc=c ** -0.5),
        bqkv=f(3 * c, sc=0.1), wdw=f(3, 3, c, sc=1 / 3), bdw=f(c, sc=0.1),
        bias0=rect_bias_from_table(tables[0], s0, s1),
        bias1=rect_bias_from_table(tables[1], s1, s0), num_heads=nh, split=split,
        table0=tables[0], table1=tables[1])


def _k9_emulated(x, pk, shifted):
    """K9's four launches in torch ops on its packed operands (fp32): the
    product over the padded map's rows (LN1, the unswizzled weight
    stream, zeros at pad rows) into each branch's q|k|v workspace at the
    rows' (window, token) (``front_rows``); per branch the attention over
    (window, head) units with the bias from the table and the token
    codes (position, region), each output row to the pixel the stream
    kernel computes from (window, token); v at true coordinates and the
    conv branch.  Returns (attened_x, conv_x) and how often each output
    pixel was stored per branch."""
    from tpu_superresolution_torch.kernels import fused_rect_attn as fr
    from tpu_superresolution_torch.kernels.layernorm import layernorm_plain

    b, h, wd, c = x.shape
    nhb = pk.num_heads // 2
    half = c // 2
    hd = half // nhb
    hp, wp = fr.padded_size(h, wd, pk.split)
    rows = torch.from_numpy(fr.front_rows(b, h, wd, pk.split, shifted)).reshape(-1, 5)
    xp = F.pad(x, (0, 0, 0, wp - wd, 0, hp - h)).reshape(-1, c)
    y = layernorm_plain(xp, pk.g1, pk.b1, fr.LN_EPS)
    prod = y @ _unpack_front(pk.wp, c).reshape(576, c).t() + pk.bqkv
    prod = torch.where((rows[:, 4] >= 0)[:, None], prod, torch.zeros(()))
    prod = prod.reshape(-1, 3, 2, 3, 32)  # (part, branch, head slot, dim)
    att = torch.zeros(b * h * wd, c)
    stored = torch.zeros(2, b * h * wd, dtype=torch.int32)
    v = torch.zeros(b * h * wd, c)
    real = rows[:, 4] >= 0
    for br, (hsp, wsp, sh, sw) in enumerate(fr.branch_geometry(pk.split, shifted)):
        n = hsp * wsp
        bw = b * hp * wp // n
        ws = torch.full((3, bw, nhb, n, 32), float("nan"))
        ws[:, rows[:, 2 * br], :, rows[:, 2 * br + 1]] = prod[:, :, br, :nhb].reshape(-1, 3, nhb, 32)
        assert not ws.isnan().any()  # every workspace slot written once
        v[rows[real, 4], br * half:(br + 1) * half] = (
            prod[real, 2, br, :nhb, :hd].reshape(-1, half))
        roll = shifted and bool(sh or sw)
        codes = torch.from_numpy(fr.rect_codes(hp, wp, hsp, wsp, sh if roll else 0,
                                               sw if roll else 0)).long()
        pos, reg = codes & 0xFFFF, codes >> 16
        idx = pos[:, :, None] - pos[:, None, :] + (hsp - 1) * (2 * wsp - 1) + wsp - 1
        bias = pk.tables[br][idx].permute(0, 3, 1, 2)  # [n_codes, nhb, N, N]
        if roll:
            bias = bias + torch.where(reg[:, :, None] != reg[:, None, :], -100.0, 0.0)[:, None]
        s = ws[0] @ ws[1].transpose(-1, -2) + bias[torch.arange(bw) % codes.shape[0]]
        o = (torch.softmax(s, -1) @ ws[2])[..., :hd].permute(0, 2, 1, 3)  # [bw, N, nhb, hd]
        # the stream kernel's output addressing: (window, token) -> pixel
        nwx, nwin = wp // wsp, (hp // hsp) * (wp // wsp)
        wi, t = torch.meshgrid(torch.arange(bw), torch.arange(n), indexing="ij")
        img, wrem = wi // nwin, wi % nwin
        yy = ((wrem // nwx) * hsp + t // wsp + (sh if roll else 0)) % hp
        xx = ((wrem % nwx) * wsp + t % wsp + (sw if roll else 0)) % wp
        keep = (yy < h) & (xx < wd)
        pix = (img * h + yy) * wd + xx
        att[pix[keep], br * half:(br + 1) * half] = o[keep].reshape(-1, half)
        stored[br].index_add_(0, pix[keep], torch.ones_like(pix[keep], dtype=torch.int32))
    from tpu_superresolution_torch.kernels.fused_rect_attn import dwconv_gelu_plain

    v = v.reshape(b, h, wd, c)
    conv = dwconv_gelu_plain(v, pk.wdw.reshape(3, 3, c), pk.bdw)
    return att.reshape(b, h, wd, c), conv, stored


_K9_EMULATED = [((2, 16, 32), (4, 16)), ((1, 13, 21), (8, 8)), ((1, 40, 72), (8, 32)),
                ((1, 33, 64), (8, 16))]


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("shape,split", _K9_EMULATED,
                         ids=["b2-16x32-4x16", "13x21-padded-8x8", "40x72-padded-8x32",
                              "33x64-padded-8x16"])
def test_k9_schedule_emulated_matches_plain(shape, split, shifted):
    """K9's Hopper schedule on its packed operands (``pack_rect_weights``:
    the weight stream, the bias tables; ``front_rows``, ``rect_codes``)
    reproduces ``rect_attention_plain`` at fp32 (3e-5), padded maps
    included, and stores every output pixel once per branch."""
    from tpu_superresolution_torch.kernels.fused_rect_attn import (
        pack_rect_weights,
        rect_attention_plain,
    )

    w = _table_weights(20 + shape[1] + 2 * shifted, split)
    x = _t(np.random.default_rng(21).standard_normal((*shape, C)))
    att, conv, stored = _k9_emulated(x, pack_rect_weights(w, torch.float32), shifted)
    assert torch.equal(stored, torch.ones_like(stored))
    want_att, want_conv = rect_attention_plain(x, w, shifted)
    assert (att - want_att).abs().max().item() <= TOL
    assert (conv - want_conv).abs().max().item() <= TOL


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_k9_schedule_emulated_matches_jax_kernel(shifted):
    """The same schedule at the published DAT x4's split (8, 32) against
    ``fused_rect_attention`` in interpret mode (its dense biases gathered
    from the tables)."""
    from tpu_superresolution_tpu.ops.pallas.fused_rect_attn import fused_rect_attention
    from tpu_superresolution_tpu.ops.window import rect_shift_region_ids
    from tpu_superresolution_torch.kernels.fused_rect_attn import pack_rect_weights

    split, (b, h, wd) = (8, 32), (1, 64, 64)
    s0, s1 = split
    w = _table_weights(30 + shifted, split)
    x = np.random.default_rng(31).standard_normal((b, h, wd, C)).astype(np.float32)
    xr0 = xr1 = m0 = m1 = None
    if shifted:
        xr0 = jnp.roll(x, (-(s0 // 2), -(s1 // 2)), axis=(1, 2))
        xr1 = jnp.roll(x, (-(s1 // 2), -(s0 // 2)), axis=(1, 2))
        m0 = rect_shift_region_ids(h, wd, s0, s1, s0 // 2, s1 // 2)
        m1 = rect_shift_region_ids(h, wd, s1, s0, s1 // 2, s0 // 2)
    n = lambda t: t.numpy()
    o0, o1, conv = fused_rect_attention(
        jnp.asarray(x), xr0, xr1, n(w.g1), n(w.b1), n(w.wqkv.t()), n(w.bqkv),
        n(w.wdw)[:, :, None], n(w.bdw), n(w.bias0), n(w.bias1), m0, m1, s0, s1, NH,
        interpret=True)
    if shifted:
        o0 = jnp.roll(o0, (s0 // 2, s1 // 2), axis=(1, 2))
        o1 = jnp.roll(o1, (s1 // 2, s0 // 2), axis=(1, 2))
    att, cx, _ = _k9_emulated(_t(x), pack_rect_weights(w, torch.float32), shifted)
    assert np.abs(att.numpy() - np.concatenate([np.asarray(o0), np.asarray(o1)], -1)).max() <= TOL
    assert np.abs(cx.numpy() - np.asarray(conv)).max() <= TOL


@pytest.mark.parametrize("split", [(4, 8), (8, 16), (8, 32)], ids=["4x8", "8x16", "8x32"])
def test_k9_table_codes_equal_the_dense_bias_and_mask(split):
    """The bias K9 reads, table[pos_i - pos_j + (hsp-1)(2wsp-1) + wsp-1]
    by the token codes, equals ``RectBranch.bias`` (the model's gathered
    [heads, N, N]) element for element in both branches; the codes'
    region bits equal ``rect_shift_region_ids`` on the padded map, so
    their -100 equals ``rect_shift_attn_mask``."""
    from tpu_superresolution_torch.kernels import fused_rect_attn as fr
    from tpu_superresolution_torch.models.dat import RectBranch
    from tpu_superresolution_torch.ops.window import rect_shift_attn_mask, rect_shift_region_ids

    s0, s1 = split
    hp, wp = fr.padded_size(40, 72, split)
    torch.manual_seed(sum(split))
    for br, (hsp, wsp, sh, sw) in enumerate(fr.branch_geometry(split, True)):
        branch = RectBranch(32, 3, hsp, wsp)
        with torch.no_grad():
            for p in branch.parameters():
                p.add_(torch.randn_like(p) * 0.3)
            dense, table = branch.bias(), branch.table()
        assert tuple(table.shape) == ((2 * s0 - 1) * (2 * s1 - 1), 3)
        for shifted in (False, True):
            codes = torch.from_numpy(fr.rect_codes(hp, wp, hsp, wsp, sh if shifted else 0,
                                                   sw if shifted else 0)).long()
            pos, reg = codes & 0xFFFF, codes >> 16
            idx = pos[:, :, None] - pos[:, None, :] + (hsp - 1) * (2 * wsp - 1) + wsp - 1
            got = table[idx].permute(0, 3, 1, 2)
            assert torch.equal(got, dense.expand_as(got))
            if shifted:
                np.testing.assert_array_equal(reg.numpy(),
                                              rect_shift_region_ids(hp, wp, hsp, wsp, sh, sw))
                mask = torch.where(reg[:, :, None] != reg[:, None, :], -100.0, 0.0)
                np.testing.assert_array_equal(mask.numpy(),
                                              rect_shift_attn_mask(hp, wp, hsp, wsp, sh, sw))
            else:
                assert codes.shape == (1, hsp * wsp) and not reg.any()


@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
@pytest.mark.parametrize("split", [(8, 16), (8, 32)], ids=["8x16", "8x32"])
def test_k9_window_order_and_pixel_index(split, shifted):
    """``front_rows`` (the product kernel's row map) against torch ops:
    ids of the padded map's pixels (-1 at pad tokens), rolled by (-sh,
    -sw) and cut by ``rect_window_partition``, give each branch's
    (window, token) of every padded-map row, and its pixel."""
    from tpu_superresolution_torch.kernels import fused_rect_attn as fr

    b, h, wd = 2, 40, 72
    hp, wp = fr.padded_size(h, wd, split)
    rows = fr.front_rows(b, h, wd, split, shifted)
    pos = torch.arange(b * hp * wp).reshape(b, hp, wp, 1)
    yy, xx = torch.arange(hp).view(1, hp, 1), torch.arange(wp).view(1, 1, wp)
    pix = torch.where((yy < h) & (xx < wd), (torch.arange(b).view(b, 1, 1) * h + yy) * wd + xx, -1)
    np.testing.assert_array_equal(rows[..., 4].reshape(-1), pix.reshape(-1).numpy())
    for br, (hsp, wsp, sh, sw) in enumerate(fr.branch_geometry(split, shifted)):
        part = fr.rect_window_partition(torch.roll(pos, (-sh, -sw), (1, 2)), hsp, wsp)[..., 0]
        flat = rows.reshape(-1, 5)
        win, tok = flat[part.reshape(-1).numpy(), 2 * br], flat[part.reshape(-1).numpy(), 2 * br + 1]
        n = hsp * wsp
        np.testing.assert_array_equal(win, np.repeat(np.arange(part.shape[0]), n))
        np.testing.assert_array_equal(tok, np.tile(np.arange(n), part.shape[0]))


def _k14_emulated(x, pk):
    """K14's three launches in torch ops on its packed operands (fp32):
    per 128-token tile of an image, LN1 and the unswizzled weight
    stream's six N tiles (``N_TILE_ORDER``), the tile's partial gram and
    squared norms (zero past the image); the partials summed in tile
    order; the softmax; out = v A^T and the conv branch."""
    from tpu_superresolution_torch.kernels import fused_channel_attn as fc
    from tpu_superresolution_torch.kernels.fused_rect_attn import dwconv_gelu_plain
    from tpu_superresolution_torch.kernels.layernorm import layernorm_plain

    b, h, wd, c = x.shape
    nh = pk.num_heads
    hd = c // nh
    t_img = h * wd
    tpi = fc.tiles_per_image(h, wd)
    w6 = _unpack_front(pk.wp, c)
    b6 = pk.bqkv.reshape(6, 96)
    parts = {}
    for nt, key in enumerate(fc.N_TILE_ORDER):
        parts[key] = (w6[nt], b6[nt])
    wfull = torch.stack([torch.cat([parts[(p, 0)][0], parts[(p, 1)][0]]) for p in range(3)])
    bfull = torch.stack([torch.cat([parts[(p, 0)][1], parts[(p, 1)][1]]) for p in range(3)])
    y = layernorm_plain(x.reshape(b, t_img, c), pk.g1, pk.b1, fc.LN_EPS)
    y = F.pad(y, (0, 0, 0, tpi * 128 - t_img))
    valid = (torch.arange(tpi * 128) < t_img)[None, :, None, None]
    qkv = torch.einsum("btc,pnc->btpn", y, wfull) + bfull  # [B, T', 3, 192]
    qkv = torch.where(valid, qkv, torch.zeros(())).reshape(b, tpi, 128, 3, 6, 32)
    q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
    gram = torch.zeros(b, 6, 32, 32)
    qq, kk = torch.zeros(b, 6, 32), torch.zeros(b, 6, 32)
    for j in range(tpi):  # the partials, summed in tile order
        gram = gram + torch.einsum("bthd,bthe->bhde", q[:, j], k[:, j])
        qq = qq + q[:, j].square().sum(1)
        kk = kk + k[:, j].square().sum(1)
    qn, kn = qq.sqrt().clamp_min(1e-12), kk.sqrt().clamp_min(1e-12)
    sc = gram[:, :nh, :hd, :hd] / (qn[:, :nh, :hd, None] * kn[:, :nh, None, :hd])
    a = torch.softmax(sc * pk.temperature.reshape(nh, 1, 1), -1)
    vv = v.reshape(b, tpi * 128, 6, 32)[:, :t_img, :nh, :hd]
    out = torch.einsum("bhde,bthe->bthd", a, vv).reshape(b, h, wd, c)
    vimg = vv.reshape(b, h, wd, c)
    return out, dwconv_gelu_plain(vimg, pk.wdw.reshape(3, 3, c), pk.bdw)


@pytest.mark.parametrize("shape,nh,jax", [((2, 16, 32), 2, True), ((1, 13, 21), 2, False),
                                         ((2, 20, 27), 4, False)],
                         ids=["b2-16x32", "13x21-ragged-tile", "20x27-4heads"])
def test_k14_schedule_emulated_matches_plain_and_jax(shape, nh, jax):
    """K14's Hopper schedule on its packed operands (128-token tiles, the
    last one past the image; partial grams summed in tile order)
    reproduces ``channel_attention_plain`` at fp32 (3e-5), and
    ``fused_channel_attention`` (interpret mode) at the shape its own
    tests take (the JAX kernel gives no finite output on the ragged
    maps, which the port's kernel takes)."""
    from tpu_superresolution_tpu.ops.pallas.fused_channel_attn import fused_channel_attention
    from tpu_superresolution_torch.kernels.fused_channel_attn import (
        ChanAttnWeights,
        channel_attention_plain,
        pack_chan_weights,
    )

    a = _front_inputs(40 + nh + shape[1], 0, shape=shape)
    a["temperature"] = a["temperature"][:1].repeat(nh, 0)
    w = ChanAttnWeights(
        g1=_t(a["g1"]), b1=_t(a["b1"]), wqkv=_t(a["wqkv"].T), bqkv=_t(a["bqkv"]),
        temperature=_t(a["temperature"]), wdw=_t(a["wdw"][:, :, 0]), bdw=_t(a["bdw"]),
        num_heads=nh)
    att, cx = _k14_emulated(_t(a["x"]), pack_chan_weights(w, torch.float32))
    want_att, want_conv = channel_attention_plain(_t(a["x"]), w)
    assert (att - want_att).abs().max().item() <= TOL
    assert (cx - want_conv).abs().max().item() <= TOL
    if not jax:
        return
    att_j, conv_j = fused_channel_attention(
        jnp.asarray(a["x"]), a["g1"], a["b1"], a["wqkv"], a["bqkv"], a["temperature"],
        a["wdw"], a["bdw"], nh, interpret=True)
    assert np.abs(att.numpy() - np.asarray(att_j)).max() <= TOL
    assert np.abs(cx.numpy() - np.asarray(conv_j)).max() <= TOL


def test_k9_k14_envelope_and_geometry():
    """K9 takes N = s0 s1 <= 256, a multiple of 64, with sides that divide
    each other, and refuses the rest; its geometry array (the stream
    plan at the rect table's size, one product CTA an SM) and K14's."""
    from tpu_superresolution_torch.kernels import fused_channel_attn as fc
    from tpu_superresolution_torch.kernels import fused_rect_attn as fr

    for split in ((8, 16), (16, 8), (8, 32), (4, 16), (8, 8), (8, 24)):
        assert fr.rect_ok(180, 6, split)
    for split in ((4, 8), (16, 32), (8, 12), (12, 16), (6, 32)):
        assert not fr.rect_ok(180, 6, split)
    assert not fr.rect_ok(180, 8, (8, 32)) and not fr.rect_ok(200, 6, (8, 32))
    g = fr.rect_geometry(25, 64, 64, 180, 3, (8, 32), True, 4, 132)[:]
    assert g[:14] == [25, 64, 64, 180, 3, 30, 8, 32, 1, 64, 64, 132, 32, 4]
    assert g[14:] == [32, 1, 8, 4, 1, 44, 16]  # hb, ob, ns, stages, whole, per_head, n_codes
    g = fr.rect_geometry(2, 52, 76, 180, 3, (8, 16), False, 4, 132)[:]
    assert (g[9], g[10], g[11], g[12], g[20]) == (64, 80, 80, 40, 1)
    assert fc.chan_geometry(2, 52, 76, 180, 6, 4, 132)[:] == [2, 52, 76, 180, 6, 62, 31, 4]
    w = _table_weights(50, (8, 32))
    with pytest.raises(ValueError, match="DynamicPosBias tables"):
        import dataclasses

        fr.pack_rect_weights(dataclasses.replace(w, table0=None))
