"""K1's tail on Hopper's wgmma (``csrc/swin_tail_wg.cu``, route "wgmma"
of ``fused_block.tail_route``: C <= 256), its host side on the CPU.

The kernel's schedule is written out in torch ops on its packed
operands (``pack_block_tail``'s tile stream in fp32, decoded back from
the swizzled tiles): each pixel's attention row by the loaders' address
formula (window and token of the pixel in the shifted map, the shift's
wrap by one conditional add), units of 64 rows with the rows past the
map zero, LN2's row sums as the two warpgroups' halves, the N split of
fc1 (32 hidden columns a warpgroup a chunk) and fc2 (CP/2 output
channels a warpgroup), fc2 accumulated over every hidden chunk before
``x1 + m2 (acc + bfc2)``.  It is held against the plain version (fp32,
max abs 1e-4: sums in another order over O(1) values) and, through the
K7 route's composition, against the JAX package's K1 in interpret mode
(fp32, ``TOL`` 3e-5, as ``test_k7_route_block_matches_jax_k1``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import TOL

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _weights(rng, c, nh, hidden, ws):
    """JAX-layout parameters ([in, out] kernels) and the port's
    SwinBlockWeights ([out, in]) holding the same values."""
    from tpu_superresolution_torch.kernels.fused_block import SwinBlockWeights

    n = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    p = dict(g1=1 + n(c, sc=0.1), b1=n(c, sc=0.1),
             wqkv=n(c, 3 * c, sc=c ** -0.5), bqkv=n(3 * c, sc=0.1),
             wproj=n(c, c, sc=c ** -0.5), bproj=n(c, sc=0.1),
             g2=1 + n(c, sc=0.1), b2=n(c, sc=0.1),
             wfc1=n(c, hidden, sc=c ** -0.5), bfc1=n(hidden, sc=0.1),
             wfc2=n(hidden, c, sc=hidden ** -0.5), bfc2=n(c, sc=0.1),
             table=n((2 * ws - 1) ** 2, nh, sc=0.5))
    w = SwinBlockWeights(**{k: _t(v.T if k.startswith("w") else v) for k, v in p.items()},
                         num_heads=nh)
    return p, w


def _attn_rows(b, h, wd, ws, shift):
    """The loaders' attention row of every pixel of the flat map (the
    kernel's ``attn_row``)."""
    p = torch.arange(b * h * wd)
    bi, rem = p // (h * wd), p % (h * wd)
    i, j = rem // wd - shift, rem % wd - shift
    i, j = torch.where(i < 0, i + h, i), torch.where(j < 0, j + wd, j)
    wy, wx = i // ws, j // ws
    win = (bi * (h // ws) + wy) * (wd // ws) + wx
    return win * ws * ws + (i - wy * ws) * ws + (j - wx * ws)


def emulate_tail_wg(x, attn, w, ws, shift, gelu_approx, scales=None, extra=None):
    """csrc/swin_tail_wg.cu's schedule in fp32 torch ops on its packed
    operands (the stream packed unrounded)."""
    from tpu_superresolution_torch.kernels.cab_conv import _swizzle_rows
    from tpu_superresolution_torch.kernels.fused_block import (
        LN_EPS,
        TAIL_WG_ROWS,
        gelu,
        pack_block_tail,
        tail_route,
        tail_wg_plan,
    )

    b, h, wd, c = x.shape
    hidden = int(w.wfc1.shape[0])
    assert tail_route(c, hidden) == "wgmma"
    plan = tail_wg_plan(b, h, wd, c, hidden, extra is not None, 132)
    pk = pack_block_tail(w.g2, w.b2, w.wfc1, w.bfc1, w.wfc2, w.bfc2, dtype=torch.float32)
    cp, half, stage = plan.cp, plan.cp // 2, plan.cp * 64
    vec = pk.vec
    g2, b2, bfc2, bfc1 = vec[:cp], vec[cp:2 * cp], vec[2 * cp:3 * cp], vec[3 * cp:]
    rows = b * h * wd
    padded = plan.units * TAIL_WG_ROWS  # rows past the map are zero, never stored
    pad = lambda t: torch.nn.functional.pad(t, (0, cp - c, 0, padded - rows))
    bi = torch.arange(rows) // (h * wd)
    m1 = m2 = torch.ones(rows, 1)
    if scales is not None:
        m1, m2 = scales[bi, 0, None], scales[bi, 1, None]
    x1 = x.reshape(rows, c) + m1 * attn.reshape(-1, c)[_attn_rows(b, h, wd, ws, shift)]
    if extra is not None:
        x1 = x1 + extra.reshape(rows, c)
    x1, m2 = pad(x1), torch.nn.functional.pad(m2, (0, 0, 0, padded - rows))
    # LN2: the two warpgroups' halves of each row's sums, fast variance
    s = x1[:, :half].sum(-1, keepdim=True) + x1[:, half:].sum(-1, keepdim=True)
    sq = (x1[:, :half] ** 2).sum(-1, keepdim=True) + (x1[:, half:] ** 2).sum(-1, keepdim=True)
    mu = s / c
    rs = torch.rsqrt((sq / c - mu * mu).clamp_min(0) + LN_EPS)
    y2 = (x1 - mu) * rs * g2 + b2
    acc = [torch.zeros(padded, half), torch.zeros(padded, half)]
    for jc in range(plan.chunks):
        # stage 2 jc: fc1's CP/64 [64, 64] tiles; stage 2 jc + 1: fc2's [CP, 64]
        t1 = pk.tiles[2 * jc * stage:(2 * jc + 1) * stage].view(cp // 64, 64, 64)
        w1 = _swizzle_rows(t1).permute(1, 0, 2).reshape(64, cp)  # [hidden rows, K]
        w2 = _swizzle_rows(pk.tiles[(2 * jc + 1) * stage:(2 * jc + 2) * stage].view(cp, 64))
        # fc1: warpgroup g the chunk's hidden columns 32 g .. 32 g + 31
        hs = [gelu(y2 @ w1[32 * g:32 * g + 32].t() + bfc1[64 * jc + 32 * g:64 * jc + 32 * g + 32],
                   gelu_approx) for g in (0, 1)]
        hc = torch.cat(hs, dim=1)  # the [64, 64] A chunk both warpgroups read
        for g in (0, 1):  # fc2: warpgroup g output channels g CP/2 ..
            acc[g] = acc[g] + hc @ w2[g * half:(g + 1) * half].t()
    out = x1 + m2 * (torch.cat(acc, dim=1) + bfc2)
    assert torch.isfinite(out).all()
    return out[:rows, :c].reshape(x.shape)


_CASES = [
    # (C, hidden, ws, shift, [B, H, W], extra, scales, gelu tanh)
    (180, 360, 16, 8, (1, 32, 32), True, False, False),   # HAT-SRx4's widths
    (240, 480, 8, 4, (2, 16, 16), False, True, True),     # SwinIR-L's; m2 0 in one sample
    (44, 88, 6, 3, (1, 12, 18), True, True, False),       # ragged: C % 16, 216 rows
    (256, 200, 8, 0, (1, 8, 24), False, False, True),     # the widest, x1 in the workspace
]
_IDS = [f"C{k[0]}-hid{k[1]}-ws{k[2]}-shift{k[3]}" for k in _CASES]


def _inputs(case, seed):
    c, hidden, ws, shift, (b, h, wd), with_extra, with_scales, _ = case
    rng = np.random.default_rng(seed)
    p, w = _weights(rng, c, max(1, c // 30), hidden, ws)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    x, extra = f(b, h, wd, c), f(b, h, wd, c, sc=0.3) if with_extra else None
    attn = f(b * (h // ws) * (wd // ws), ws * ws, c)
    scales = (np.array([[1.25, 0.0], [0.0, 1.25]], np.float32)[:b] if with_scales else None)
    return p, w, x, attn, extra, scales


@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_wg_schedule_on_packed_operands_computes_the_plain_tail(case):
    """The emulated kernel against ``swin_block_tail_plain`` on the same
    K7 output (fp32, 1e-4)."""
    from tpu_superresolution_torch.kernels.fused_block import swin_block_tail_plain

    c, hidden, ws, shift, _, _, _, gelu_approx = case
    _, w, x, attn, extra, scales = _inputs(case, c + ws)
    opt = lambda a: None if a is None else _t(a)
    got = emulate_tail_wg(_t(x), _t(attn), w, ws, shift, gelu_approx, opt(scales), opt(extra))
    want = swin_block_tail_plain(_t(x), _t(attn), w, ws, shift, gelu_approx, opt(scales),
                                 opt(extra))
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-4


@pytest.mark.parametrize("case", _CASES[:3], ids=_IDS[:3])
def test_wg_schedule_in_the_k7_route_matches_jax_k1(case):
    """The K7 route's composition (plain LN1 and attention) with the
    emulated kernel as its tail against the JAX package's whole-block K1
    in interpret mode on the cyclically shifted map (fp32, TOL)."""
    from tpu_superresolution_tpu.ops.pallas.fused_block import fused_swin_block
    from tpu_superresolution_tpu.ops.window import (
        cyclic_shift,
        cyclic_unshift,
        relative_position_index,
        shift_attn_mask,
    )
    from tpu_superresolution_torch.kernels.fused_block import swin_block_plain
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    c, hidden, ws, shift, (b, h, wd), _, _, gelu_approx = case
    p, w, x, _, extra, scales = _inputs(case, 7 * c + ws)
    nh, n = w.num_heads, ws * ws
    bias = p["table"][relative_position_index(ws).reshape(-1)].reshape(n, n, nh)
    mask = shift_attn_mask(h, wd, ws, shift) if shift else None
    args = [jnp.asarray(p[k]) for k in ("g1", "b1", "wqkv", "bqkv", "wproj", "bproj", "g2",
                                        "b2", "wfc1", "bfc1", "wfc2", "bfc2")]
    out = fused_swin_block(
        cyclic_shift(jnp.asarray(x), shift), *args, jnp.asarray(bias.transpose(2, 0, 1)), ws,
        mask, (c // nh) ** -0.5, gelu_approx, interpret=True,
        extra=None if extra is None else cyclic_shift(jnp.asarray(extra), shift),
        branch_scales=None if scales is None else jnp.asarray(scales))
    want = np.asarray(cyclic_unshift(out, shift))

    tmask = shift_mask_tensor(h, wd, ws, shift, torch.device("cpu")) if shift else None
    got = swin_block_plain(
        _t(x), w, ws, shift, tmask, gelu_approx, None if scales is None else _t(scales),
        None if extra is None else _t(extra),
        tail=lambda x, attn, w, ws, shift, ga, sc, ex: emulate_tail_wg(x, attn, w, ws, shift, ga,
                                                                       sc, ex)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


def test_attention_rows_wrap_under_the_shift():
    """Under the shift a pixel row's tokens run consecutively within a
    window and jump where the row crosses a window or wraps at the map's
    edge: the loaders' formula gives the partition's inverse (every
    attention row read once) and the wrap's jump."""
    from tpu_superresolution_torch.ops.window import cyclic_shift, window_partition

    b, h, wd, ws, shift = 2, 12, 18, 6, 3
    rows = _attn_rows(b, h, wd, ws, shift)
    assert sorted(rows.tolist()) == list(range(b * h * wd))
    ids = torch.arange(b * h * wd, dtype=torch.float32).reshape(b, h, wd, 1)
    part = window_partition(cyclic_shift(ids, shift), ws).reshape(-1)
    assert torch.equal(part[rows].long(), torch.arange(b * h * wd))
    first = rows[:wd]  # image row 0 of sample 0: columns 0..2 wrap to the last window
    steps = (first[1:] - first[:-1]).tolist()
    assert steps.count(1) == wd - 1 - 3 and steps[shift - 1] != 1


@pytest.mark.parametrize("c,route", [(180, "wgmma"), (240, "wgmma"), (256, "wgmma"),
                                     (264, "wmma"), (576, "wmma")])
def test_tail_route_by_width(c, route):
    """``tail_route`` from static shapes: the wgmma kernel to C 256 (HAT-
    SRx4's 180, SwinIR-L's 240), the WMMA kernel past it (C 264,
    576); pack_block_tail lays the operands out for that route."""
    from tpu_superresolution_torch.kernels.fused_block import pack_block_tail, tail_route

    hidden = 2 * c
    assert tail_route(c, hidden) == route == tail_route(c, 4 * c)
    z = lambda *s: torch.zeros(*s)
    pk = pack_block_tail(z(c), z(c), z(hidden, c), z(hidden), z(c, hidden), z(c))
    assert pk.route == route


def test_tail_wg_plan_at_the_published_shapes():
    """The plan at HAT-SRx4's bench batch (C 180, extra: 4 ring stages of
    24 KB) and SwinIR-L's (C 240: 3 of 32 KB), 1600 units over 132 SMs,
    within the 227 KB of shared memory; staging rows at 16 (2k + 1)
    bytes; refused past C 256."""
    from tpu_superresolution_torch.kernels.fused_block import TAIL_SMEM, tail_wg_plan

    hat = tail_wg_plan(25, 64, 64, 180, 360, True, 132)
    swl = tail_wg_plan(25, 64, 64, 240, 480, False, 132)
    assert (hat.cp, hat.chunks, hat.rsb, hat.stages) == (192, 6, 368, 4)
    assert (swl.cp, swl.chunks, swl.rsb, swl.stages) == (256, 8, 496, 3)
    for p in (hat, swl, tail_wg_plan(1, 12, 18, 44, 88, True, 132)):
        assert p.smem <= TAIL_SMEM and p.stages >= 2 and p.rsb % 32 == 16
    assert (hat.units, hat.grid) == (1600, 132)
    with pytest.raises(ValueError):
        tail_wg_plan(4, 64, 64, 264, 528, False, 132)
