"""The host side of the Swin block forward kernel on Hopper (K1 at ws 8,
K6 at ws 7: ``csrc/swin_block.cu``), fp32 on the CPU:

- ``block_plan`` decides the instantiation (padded width 96 or 192, head
  dim 16 or 32), the hidden chunks and the ring's stages from static
  shapes only, for every width ``block_route`` sends to "block";
- the weight stream of ``pack_block_tiles`` ([N, 64] 128B-swizzled
  tiles in the consumers' order), unswizzled in torch, gives back the
  weights and biases exactly;
- the [nH, (2ws-1)^2] table read through the token codes rebuilds the
  gathered bias and the shift mask bit for bit;
- the kernel's schedule written out in torch ops (window pairs, the
  second of an odd last pair recomputed and not stored; LN1 on 64 rows,
  pad rows zero; per head qkv from the stream's tiles, Q K^T, the bias
  and mask from the codes, -inf past the keys, softmax, P V into the
  head-padded attention output; the proj in N halves; x1 with `extra`
  and the branch scales; LN2; the MLP in 64-column hidden chunks, fc2
  accumulated over them) reproduces ``swin_block_plain``, and the JAX
  package's block kernels in interpret mode (``fused_swin_block`` at ws
  8, ``fused_packed_windows_block`` at ws 7).

Bound: 3e-5 max abs (fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_hat_block import _block_weights
from tests.util_torchport import TOL

torch.set_num_threads(1)


def _unswizzle(t: torch.Tensor) -> torch.Tensor:
    from tpu_superresolution_torch.kernels.cab_conv import _swizzle_rows

    return _swizzle_rows(t)  # the swizzle is an involution


class _Stream:
    """The feeder's walk over the packed weight stream: [rows, 64] tiles
    one after another, unswizzled."""

    def __init__(self, tiles: torch.Tensor):
        self.tiles, self.at = tiles.float(), 0

    def next(self, rows: int) -> torch.Tensor:
        t = self.tiles[self.at:self.at + rows * 64].reshape(rows, 64)
        self.at += rows * 64
        return _unswizzle(t)

    def done(self) -> bool:
        return self.at == self.tiles.numel()


def _kernel_bias(p, ws, codes_row, hh, shifted):
    """The scores' additive term as the kernel forms it for head hh: rows
    0-63 (pad rows take token 0's code), keys 0-63 (-inf past the
    window): table[hh, pos_i - pos_j + REL0], + -100 where the regions
    differ (shifted only)."""
    nt = ws * ws
    rel0 = (ws - 1) * (2 * ws - 1) + ws - 1
    t = torch.arange(64)
    rc = codes_row[torch.where(t < nt, t, 0)]
    kc = codes_row[torch.where(t < nt, t, 0)]
    bias = p.table[hh][(rc & 0xFFFF)[:, None] - (kc & 0xFFFF)[None, :] + rel0]
    if shifted:
        bias = bias + torch.where((rc[:, None] >> 16) != (kc[None, :] >> 16), -100.0, 0.0)
    return torch.where(t[None, :] < nt, bias, float("-inf"))


def block_wg_emulated(x, p, ws, shift, shifted, gelu_approx, scales=None, extra=None):
    """csrc/swin_block.cu's schedule in fp32 torch ops on the packed
    operands `p` (``pack_block_tiles``); returns the output and the
    number of windows stored."""
    from tpu_superresolution_torch.ops.window import window_token_codes

    plan = p.plan
    b, h, w, c = x.shape
    nt, nh, hdp, k = ws * ws, p.num_heads, plan.hdp, plan.kc * 64
    codes = torch.from_numpy(window_token_codes(h, w, ws, shift if shifted else 0)).long()
    nww, per = w // ws, (h // ws) * (w // ws)
    windows = b * per
    y = torch.full_like(x, float("nan"))
    t = torch.arange(64)
    row_ok = t < nt
    tt = torch.where(row_ok, t, 0)
    stored = 0

    def ln(v, g, bb):  # fast-variance LN over the first C columns, zero past them
        mu = v[..., :c].mean(-1, keepdim=True)
        var = ((v[..., :c] ** 2).mean(-1, keepdim=True) - mu * mu).clamp_min(0)
        out = torch.zeros_like(v)
        out[..., :c] = (v[..., :c] - mu) * torch.rsqrt(var + 1e-5) * g + bb
        return out

    for pr in range(-(-windows // 2)):
        stream = _Stream(p.tiles)
        wins = [2 * pr, 2 * pr + 1]
        active = [wi < windows for wi in wins]
        wins = [wi if ok else windows - 1 for wi, ok in zip(wins, active)]
        xs = torch.zeros(2, 64, k)
        es = torch.zeros(2, 64, k)
        m = torch.ones(2, 2)
        addr = []
        for i, wi in enumerate(wins):
            bi, win = divmod(wi, per)
            wy, wx = divmod(win, nww)
            rr = (wy * ws + tt // ws + shift) % h
            cc = (wx * ws + tt % ws + shift) % w
            addr.append((bi, rr, cc))
            xs[i, :, :c] = torch.where(row_ok[:, None], x[bi, rr, cc], 0.0)
            if extra is not None:
                es[i, :, :c] = torch.where(row_ok[:, None], extra[bi, rr, cc], 0.0)
            if scales is not None:
                m[i] = scales[bi]
        a1 = ln(xs, p.g1, p.b1)
        attn = torch.zeros(2, 64, k)  # head-padded columns hh * hdp + d, zero past the heads
        for hh in range(nh):
            acc = sum(a1[..., 64 * kc:64 * kc + 64] @ stream.next(3 * hdp).T
                      for kc in range(plan.kc))
            q, kk, v = (acc + p.bqkv[hh * 3 * hdp:(hh + 1) * 3 * hdp]).split(hdp, -1)
            s = q @ kk.transpose(1, 2)
            for i, wi in enumerate(wins):
                s[i] = s[i] + _kernel_bias(p, ws, codes[(wi % per) if shifted else 0], hh,
                                           shifted)
            attn[..., hh * hdp:(hh + 1) * hdp] = s.softmax(-1) @ v
        proj = torch.cat([sum(attn[..., 64 * kc:64 * kc + 64] @ stream.next(96).T
                              for kc in range(plan.kc)) for _ in range(plan.halves)], -1)
        x1 = xs[..., :plan.cp] + m[:, 0, None, None] * (proj + p.bproj) + es[..., :plan.cp]
        a2 = F.pad(ln(x1, p.g2, p.b2), (0, k - plan.cp))
        mlp = torch.zeros(2, 64, plan.cp)
        for j in range(plan.chunks):
            hid = sum(a2[..., 64 * kc:64 * kc + 64] @ stream.next(64).T for kc in range(plan.kc))
            hid = F.gelu(hid + p.bfc1[64 * j:64 * j + 64],
                         approximate="tanh" if gelu_approx else "none")
            mlp += torch.cat([hid @ stream.next(96).T for _ in range(plan.halves)], -1)
        out = x1 + m[:, 1, None, None] * (mlp + p.bfc2)
        assert stream.done()  # the pair took the whole stream, in order
        for i, (bi, rr, cc) in enumerate(addr):
            if active[i]:
                y[bi, rr[:nt], cc[:nt]] = out[i, :nt, :c]
                stored += 1
    return y, stored


def _every_block_width():
    """(C, heads, hidden) that block_route sends to "block" (hidden at
    the mlp ratios 2 and 4 and the largest)."""
    from tpu_superresolution_torch.kernels.fused_block import block_route

    out = []
    for heads in range(1, 7):
        for c in range(heads, 193, heads):
            for hidden in sorted({2 * c, min(4 * c, 384), 384}):
                if hidden <= 384 and block_route(8, c, heads, hidden) == "block":
                    out.append((c, heads, hidden))
    return out


_PLANS = [((180, 6, 360), (192, 32, 6, 5)), ((96, 6, 384), (96, 16, 6, 8)),
          ((96, 6, 192), (96, 16, 3, 8)), ((144, 6, 288), (192, 32, 5, 5)),
          ((96, 3, 192), (96, 32, 3, 8)), ((48, 3, 96), (96, 16, 2, 8)),
          ((72, 4, 144), (192, 32, 3, 5)), ((30, 2, 60), (96, 16, 1, 8))]


@pytest.mark.parametrize("shape,want", _PLANS, ids=["-".join(map(str, s)) for s, _ in _PLANS])
def test_block_plan_by_width(shape, want):
    """The instantiation and the ring from the widths alone: hd padded
    to 16 or 32, the width to 96 where C and the padded heads fit, else
    192, 64-column hidden chunks, the stages that fit; the same object on
    every call."""
    from tpu_superresolution_torch.kernels.fused_block import block_plan

    plan = block_plan(*shape)
    assert (plan.cp, plan.hdp, plan.chunks, plan.stages) == want
    assert block_plan(*shape) is plan


def test_block_plan_for_every_block_width():
    """Every width the "block" route takes has a compiled instantiation
    whose heads fit its width, at least two stages and shared memory
    within the limit; past the widths block_plan raises."""
    from tpu_superresolution_torch.kernels import fused_block as fb

    widths = _every_block_width()
    assert len(widths) > 300
    for c, heads, hidden in widths:
        plan = fb.block_plan(c, heads, hidden)
        assert (plan.cp, plan.hdp) in fb.BLOCK_INSTANCES
        assert c <= plan.cp and heads * plan.hdp <= plan.cp and c // heads <= plan.hdp
        assert 2 <= plan.stages <= fb.BLOCK_MAX_STAGES and plan.smem <= fb.BLOCK_SMEM
        assert plan.chunks * fb.BLOCK_HC >= hidden
    for shape in ((198, 6, 396), (224, 7, 448), (192, 4, 384), (96, 6, 400)):
        with pytest.raises(ValueError, match="swin_block kernel takes"):
            fb.block_plan(*shape)


@pytest.mark.parametrize("c,nh,hidden,ws", [(180, 6, 360, 8), (96, 6, 384, 7), (48, 3, 100, 8),
                                            (30, 2, 60, 7)])
def test_block_tiles_unswizzle_to_the_weights(c, nh, hidden, ws):
    """The stream's tiles, unswizzled and reassembled, give back the bf16
    weights exactly (q pre-scaled, head-padded proj inputs, zero padding)
    and the biases, the LN params and the transposed table."""
    from tpu_superresolution_torch.kernels.fused_block import pack_block_tiles

    w, _, table = _block_weights(np.random.default_rng(c + ws), c=c, nh=nh, hidden=hidden, ws=ws)
    p = pack_block_tiles(w)
    plan = p.plan
    hd, hdp, k = c // nh, plan.hdp, plan.kc * 64
    bf = lambda t: t.bfloat16().float()
    s = _Stream(p.tiles)
    qkv = torch.stack([torch.cat([s.next(3 * hdp) for _ in range(plan.kc)], 1)
                       for _ in range(nh)])  # [nh, 3 hdp, k]
    proj = torch.cat([torch.cat([s.next(96) for _ in range(plan.kc)], 1)
                      for _ in range(plan.halves)])  # [cp, k]
    fc1, fc2 = [], []
    for _ in range(plan.chunks):
        fc1.append(torch.cat([s.next(64) for _ in range(plan.kc)], 1))
        fc2.append(torch.cat([s.next(96) for _ in range(plan.halves)]))
    assert s.done()
    fc1, fc2 = torch.cat(fc1), torch.cat(fc2, 1)  # [chunks 64, k], [cp, chunks 64]
    want_qkv = w.wqkv.reshape(3, nh, hd, c).transpose(0, 1).clone()
    want_qkv[:, 0] *= w.scale
    got_qkv = qkv.reshape(nh, 3, hdp, k)
    assert torch.equal(got_qkv[:, :, :hd, :c], bf(want_qkv))
    assert not got_qkv[:, :, hd:].any() and not got_qkv[..., c:].any()
    got_proj = proj[:c, :nh * hdp].reshape(c, nh, hdp)
    assert torch.equal(got_proj[..., :hd], bf(w.wproj.reshape(c, nh, hd)))
    assert not got_proj[..., hd:].any() and not proj[c:].any() and not proj[:, nh * hdp:].any()
    assert torch.equal(fc1[:hidden, :c], bf(w.wfc1)) and not fc1[hidden:].any()
    assert not fc1[:, c:].any()
    assert torch.equal(fc2[:c, :hidden], bf(w.wfc2)) and not fc2[c:].any()
    assert not fc2[:, hidden:].any()
    bq = p.bqkv.reshape(nh, 3, hdp)
    want_bq = w.bqkv.reshape(3, nh, hd).transpose(0, 1).clone()
    want_bq[:, 0] *= w.scale
    assert torch.equal(bq[..., :hd], want_bq) and not bq[..., hd:].any()
    assert torch.equal(p.bproj[:c], w.bproj) and not p.bproj[c:].any()
    assert torch.equal(p.bfc1[:hidden], w.bfc1) and not p.bfc1[hidden:].any()
    assert torch.equal(p.bfc2[:c], w.bfc2) and not p.bfc2[c:].any()
    assert torch.equal(p.table, torch.from_numpy(table).t())
    assert p.tiles.dtype == torch.bfloat16 and p.tiles.numel() * 2 % 16 == 0


@pytest.mark.parametrize("ws,shift", [(7, 0), (7, 3), (7, 4), (8, 0), (8, 3), (8, 4)])
def test_codes_rebuild_bias_and_mask_bit_for_bit(ws, shift):
    """The kernel's additive term (table at the codes' relative index,
    -100 where the codes' regions differ), on every window of a map
    with several windows, equals the gathered bias + shift_attn_mask bit
    for bit on the real tokens, -inf past them."""
    from tpu_superresolution_torch.kernels.fused_block import pack_block_tiles
    from tpu_superresolution_torch.ops.window import (
        relative_position_bias,
        shift_mask_tensor,
        window_token_codes,
    )

    nh = 3
    w, _, _ = _block_weights(np.random.default_rng(ws * 10 + shift), c=48, nh=nh, hidden=96,
                             ws=ws)
    p = pack_block_tiles(w)
    h, wd, nt = 3 * ws, 4 * ws, ws * ws
    codes = torch.from_numpy(window_token_codes(h, wd, ws, shift)).long()
    rpb = relative_position_bias(w.table, ws)  # [nh, N, N]
    mask = shift_mask_tensor(h, wd, ws, shift, torch.device("cpu")) if shift else None
    for win in range(12):
        for hh in range(nh):
            got = _kernel_bias(p, ws, codes[win if shift else 0], hh, shift > 0)
            want = rpb[hh] if mask is None else rpb[hh] + mask[win]
            assert torch.equal(got[:nt, :nt], want)
            assert torch.isneginf(got[:, nt:]).all()


_SCHEDULES = [
    # (b, h, w, c, heads, hidden, ws, shift, extra, scales)
    ((1, 24, 8, 48, 3, 100, 8, 4, True, True), "ws8-odd-windows-extra-scales"),
    ((2, 16, 16, 96, 3, 192, 8, 0, False, False), "ws8-hd32-cp96"),
    ((2, 14, 21, 72, 4, 144, 7, 3, True, False), "ws7-cp192-shifted"),
    ((1, 14, 14, 30, 2, 60, 7, 0, False, True), "ws7-odd-c-pad-rows"),
]


@pytest.mark.parametrize("shape", [s for s, _ in _SCHEDULES], ids=[i for _, i in _SCHEDULES])
def test_block_schedule_emulated_matches_plain(shape):
    """The kernel's schedule in torch (two windows a CTA, per-head qkv,
    hidden chunks, pad rows and keys, `extra`, branch scales) on its
    packed operands reproduces swin_block_plain at fp32, and stores
    every window once."""
    from tpu_superresolution_torch.kernels.fused_block import pack_block_tiles, swin_block_plain
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    b, h, wd, c, nh, hidden, ws, shift, with_extra, with_scales = shape
    rng = np.random.default_rng(c * ws + shift)
    w, _, _ = _block_weights(rng, c=c, nh=nh, hidden=hidden, ws=ws)
    x = torch.from_numpy(rng.standard_normal((b, h, wd, c)).astype(np.float32))
    extra = (torch.from_numpy((0.5 * rng.standard_normal((b, h, wd, c))).astype(np.float32))
             if with_extra else None)
    scales = (torch.tensor([[1 / 0.9, 0.0], [0.0, 1 / 0.9]])[:b] if with_scales else None)
    mask = shift_mask_tensor(h, wd, ws, shift, torch.device("cpu")) if shift else None
    p = pack_block_tiles(w, dtype=torch.float32)
    got, stored = block_wg_emulated(x, p, ws, shift, mask is not None, True, scales, extra)
    want = swin_block_plain(x, w, ws, shift, mask, True, scales, extra)
    assert stored == b * (h // ws) * (wd // ws)
    assert not torch.isnan(got).any()
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("ws,shift", [(8, 4), (7, 3)], ids=["K1-strip-ws8", "K6-packed-ws7"])
def test_block_schedule_emulated_matches_jax_kernels(ws, shift):
    """The kernel's schedule (C 48, 3 heads, two blocks' worth of
    windows, `extra` and branch scales) against the JAX package's block
    kernel in interpret mode: ``fused_swin_block`` at ws 8,
    ``fused_packed_windows_block`` on the caller's partition and token
    pad at ws 7."""
    from tpu_superresolution_tpu.ops.pallas import fused_block as jfb
    from tpu_superresolution_tpu.ops.window import (
        cyclic_shift,
        cyclic_unshift,
        relative_position_index,
        shift_attn_mask,
        window_partition,
        window_reverse,
    )
    from tpu_superresolution_torch.kernels.fused_block import pack_block_tiles

    rng = np.random.default_rng(100 + ws)
    b, h, wd, c, nh, hidden = 2, 2 * ws, 2 * ws, 48, 3, 96
    w, args, table = _block_weights(rng, c=c, nh=nh, hidden=hidden, ws=ws)
    x = rng.standard_normal((b, h, wd, c)).astype(np.float32)
    extra = (0.5 * rng.standard_normal((b, h, wd, c))).astype(np.float32)
    scales = np.array([[1 / 0.9, 0.0], [1 / 0.9, 1 / 0.9]], np.float32)
    n = ws * ws
    bias = table[relative_position_index(ws).reshape(-1)].reshape(n, n, nh).transpose(2, 0, 1)
    mask = shift_attn_mask(h, wd, ws, shift)
    scale = (c // nh) ** -0.5
    xs, es = cyclic_shift(jnp.asarray(x), shift), cyclic_shift(jnp.asarray(extra), shift)
    sc = jnp.asarray(scales)
    if ws == 8:
        out = jfb.fused_swin_block(xs, *args, jnp.asarray(bias), ws, mask, scale, True,
                                   interpret=True, extra=es, branch_scales=sc)
    else:  # the caller's partition, token pad and window-count pad (models/hat.py:330-360)
        n_win = (h // ws) * (wd // ws)
        npad, wpad = (-n) % 8, (-n_win) % jfb.PACKED_GROUP
        pads = ((0, 0), (0, wpad), (0, npad), (0, 0))
        part = lambda a: jnp.pad(window_partition(a, ws).reshape(b, n_win, n, c), pads).reshape(
            b * (n_win + wpad), n + npad, c)
        bias_p = np.pad(bias, ((0, 0), (0, npad), (0, npad)), constant_values=-1e9)
        mask_p = np.pad(mask, ((0, wpad), (0, npad), (0, npad)))
        outw = jfb.fused_packed_windows_block(part(xs), *args, jnp.asarray(bias_p), mask_p,
                                              scale, True, interpret=True, extra=part(es),
                                              branch_scales=sc)
        outw = outw.reshape(b, n_win + wpad, n + npad, c)[:, :n_win, :n]
        out = window_reverse(outw.reshape(b * n_win, n, c), ws, h, wd)
    want = np.asarray(cyclic_unshift(out, shift))
    p = pack_block_tiles(w, dtype=torch.float32)
    got, _ = block_wg_emulated(torch.from_numpy(x), p, ws, shift, True, True,
                               torch.from_numpy(scales), torch.from_numpy(extra))
    assert np.abs(got.numpy() - want).max() <= TOL
