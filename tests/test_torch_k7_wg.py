"""The host side of K7's Hopper kernels, fp32 on the CPU:
``csrc/window_attn.cu`` (the product: qkv and proj) and
``csrc/window_attn_stream.cu`` (the attention; also K15 / K16's "stream"
route).

- ``product_plan``, ``stream_plan``, ``k15_route`` and ``block_route``
  decide from static shapes only (the same answer on every call, before
  any tensor exists);
- the product's packed, swizzled [N, 64] weight tiles, unswizzled in
  torch, give back the weight and bias exactly;
- the table + token-code form of K7's bias and mask
  (``ops.window.window_token_codes``, decoded as the kernel's arithmetic
  does, ``codes_bias_mask``) rebuilds ``relative_position_bias`` and
  ``shift_mask_tensor`` bit for bit at ws 7, 8, 16 and 32 and every
  shift;
- the kernels' schedules written out in torch ops (the product's
  128-row x N tiles over 64-column chunks into the head-split workspace,
  each (window, head) run swizzled; the attention's CTAs walking (window,
  head) units head-major, whole units or 64-row query tiles against key
  chunks with an online softmax in the log2 domain, the bias from the
  table and codes or dense, P V in passes of 128 columns past 128 dims;
  the proj product) reproduce ``window_attention_plain`` at fp32 3e-5,
  and ``k7_emulated`` runs a model's K7 calls through the wrapper's
  CUDA-tensor code with each launch so computed.

Bound: 3e-5 max abs (fp32)."""

import pytest
import torch
import torch.nn.functional as F

from tests.util_torchport import TOL

torch.set_num_threads(1)

LOG2E = 1.4426950408889634


# ------------------------------------------------------------ emulation


def unpack_product(packed):
    """The padded [n_tiles * N, chunks * 64] fp32 weight and the padded
    bias of a packed product operand: its [N, 64] tiles read back through
    the 128B swizzle (an involution)."""
    from tpu_superresolution_torch.kernels.cab_conv import _swizzle_rows

    nt, chunks, n, bk = packed.wp.shape
    return _swizzle_rows(packed.wp.float()).transpose(1, 2).reshape(nt * n, chunks * bk), packed.b


def _swizzle_index(rows: int, hb: int) -> torch.Tensor:
    """For a run of `rows` x `hb` bf16 stored in the swizzled layout
    (rows of 2 hb bytes, the 16-byte chunk j of row t at j ^ ((2 hb t /
    128) % (2 hb / 16))): the flat position of each (t, e) element."""
    rb = 2 * hb
    t = torch.arange(rows).view(-1, 1)
    e = torch.arange(hb).view(1, -1)
    off = t * rb + 2 * e
    off = off ^ (((off >> 7) & (rb // 16 - 1)) << 4)
    return (off // 2).reshape(-1)


def product_emulated(x, packed, split=None):
    """csrc/window_attn.cu's schedule: 128-row tiles x N tiles, C in
    64-column chunks (zero past C), each chunk's B tile from the packed
    weight, fp32 sums, + bias, one rounding to x's dtype; plain [rows,
    C_out], or with `split` = (BW, N, nH, hdw, hb) the flat head-split
    workspace [3, BW, nH, hdw / hb, N, hb], each run swizzled."""
    from tpu_superresolution_torch.kernels.fused_attention import PRODUCT_BK, PRODUCT_BM

    w, b = unpack_product(packed)
    nt, chunks, n_tile, _ = packed.wp.shape
    rows, c = x.shape
    xp = F.pad(x.float(), (0, chunks * PRODUCT_BK - c, 0, -rows % PRODUCT_BM))
    y = torch.zeros(xp.shape[0], nt * n_tile)
    for m0 in range(0, rows, PRODUCT_BM):
        for t in range(nt):
            acc = torch.zeros(PRODUCT_BM, n_tile)
            for ch in range(chunks):
                a = xp[m0:m0 + PRODUCT_BM, ch * PRODUCT_BK:(ch + 1) * PRODUCT_BK]
                acc += a @ w[t * n_tile:(t + 1) * n_tile, ch * PRODUCT_BK:(ch + 1) * PRODUCT_BK].T
            cols = slice(t * n_tile, (t + 1) * n_tile)
            y[m0:m0 + PRODUCT_BM, cols] = acc + b[cols]
    y = y[:rows, :packed.c_out].to(x.dtype)
    if split is None:
        return y
    bw, ntok, nh, hdw, hb = split
    runs = y.reshape(bw, ntok, 3, nh, hdw // hb, hb).permute(2, 0, 3, 4, 1, 5)
    runs = runs.reshape(-1, ntok * hb)
    out = torch.empty_like(runs)
    out[:, _swizzle_index(ntok, hb)] = runs
    return out.reshape(-1)


def unpack_workspace(ws, bw, ntok, nh, hdw, hb):
    """q, k, v [BW, nH, N, hdw] read back from the head-split workspace."""
    runs = ws.reshape(-1, ntok * hb)[:, _swizzle_index(ntok, hb)]
    runs = runs.reshape(3, bw, nh, hdw // hb, ntok, hb).permute(0, 1, 2, 4, 3, 5)
    return runs.reshape(3, bw, nh, ntok, hdw).unbind(0)


def stream_emulated(q, k, v, bias, mask, scale, per_head, plan, rel=None):
    """csrc/window_attn_stream.cu's schedule on q [BW, nH, Nq, hdw] and k,
    v [BW, nH, Nk, hdw] (zero past hd): CTA (h, g) walks windows g, g +
    G, ... of head h; each unit's 64-row query tiles, in passes of the
    plan's 64 * ob columns of V, against its keys in chunks of 16 ns
    (one chunk a whole unit's item, or item by item), with an online
    softmax in the log2 domain; the bias (times log2 e) from the dense
    [nH, Nq, Nk] `bias` and [nW, Nq, Nk] `mask`, or with `rel` = (table,
    codes, ws, shifted) from the table at pos_q - pos_k + (ws-1)(2ws-1) +
    ws-1 and, where `shifted`, -100 where the codes' regions differ; -inf
    past Nk.  Returns the output [BW, nH, Nq, hdw]."""
    bw, nh, nq, hdw = q.shape
    nk = k.shape[2]
    kc = 16 * plan.ns
    sc = 64 * plan.ob if plan.hb == 64 else plan.hb  # O's columns a pass
    out = torch.full_like(q, float("nan"))
    for cta in range(nh * per_head):
        h, g = divmod(cta, per_head)
        for w in range(g, bw, per_head):
            if rel is not None:
                table, codes, ws, shifted = rel
                cw = codes[w % codes.shape[0]]
                pos, reg = cw & 0xFFFF, cw >> 16
                idx = pos[:, None] - pos[None, :] + (ws - 1) * (2 * ws - 1) + ws - 1
                bl = table[:, h][idx.long()] * LOG2E
                if shifted:
                    bl = bl + torch.where(reg[:, None] != reg[None, :], -100.0, 0.0) * LOG2E
            else:
                bl = bias[h] * LOG2E
                if mask is not None:
                    bl = bl + mask[w % mask.shape[0]] * LOG2E
            for q0 in range(0, nq, 64):
                qt = q[w, h, q0:q0 + 64]
                for c0 in range(0, hdw, sc):
                    o = torch.zeros(qt.shape[0], min(sc, hdw - c0))
                    m = torch.full((qt.shape[0],), float("-inf"))
                    l = torch.zeros(qt.shape[0])
                    for k0 in range(0, nk, kc):
                        s = (qt @ k[w, h, k0:k0 + kc].T * (scale * LOG2E)
                             + bl[q0:q0 + 64, k0:k0 + kc])
                        mn = torch.maximum(m, s.max(1).values)
                        p = torch.exp2(s - mn[:, None])
                        l = l * torch.exp2(m - mn) + p.sum(1)
                        o = o * torch.exp2(m - mn)[:, None] + p @ v[w, h, k0:k0 + kc, c0:c0 + sc]
                        m = mn
                    out[w, h, q0:q0 + 64, c0:c0 + sc] = o / l[:, None]
    return out


def codes_bias_mask(table, codes, ws):
    """The dense [nH, N, N] bias and [n_codes, N, N] mask (None where no
    token has a region label) that K7's rel form computes from the
    [(2ws-1)^2, nH] table and the token codes [n_codes, N]
    (``ops.window.window_token_codes``): the bias at pos_q - pos_k +
    (ws-1)(2ws-1) + ws-1, -100 where the regions differ."""
    pos, reg = codes & 0xFFFF, codes >> 16
    idx = pos[0][:, None] - pos[0][None, :] + (ws - 1) * (2 * ws - 1) + ws - 1
    rpb = table.float()[idx.long()].permute(2, 0, 1).contiguous()
    if not bool((reg != 0).any()):
        return rpb, None
    diff = reg[:, :, None] != reg[:, None, :]
    return rpb, torch.where(diff, -100.0, 0.0).to(torch.float32)



def k7_emulated_launch(xw, packed, mask, codes=None, sms=4):
    """One K7 call, as its three kernels compute it on the card, in fp32
    torch ops: the qkv product into the head-split workspace, the stream
    attention (the rel form where `codes` is given and the weights carry
    the table, its regions masked where the block is shifted: `mask`
    given, as the wrapper decides) into the token-major [BW * N, nH *
    hdw] output, the proj product."""
    from tpu_superresolution_torch.kernels.window_attention import stream_plan, wg_ctas_per_head

    bw, n, c = xw.shape
    nh, hb, hdw = packed.num_heads, packed.hb, packed.hdw
    rel = (packed.table, codes, packed.ws, mask is not None) \
        if codes is not None and packed.table is not None else None
    ws = product_emulated(xw.reshape(bw * n, c), packed.qkv, (bw, n, nh, hdw, hb))
    q, k, v = unpack_workspace(ws, bw, n, nh, hdw, hb)
    plan = stream_plan(n, n, c // nh, packed.ws if rel else 0)
    o = stream_emulated(q, k, v, None if rel else packed.dense_bias(), None if rel else mask,
                        1.0, wg_ctas_per_head(bw, nh, sms), plan, rel)
    att = o.permute(0, 2, 1, 3).reshape(bw * n, nh * hdw)
    return product_emulated(att, packed.proj).reshape(bw, n, c)


@pytest.fixture
def k7_emulated(monkeypatch):
    """K7's kernel path on CPU tensors: the models' K7 calls go through
    the wrapper's CUDA-tensor code (packing in fp32, the autograd
    function in training), each launch computed by
    ``k7_emulated_launch`` and counted."""
    from tpu_superresolution_torch.kernels import fused_attention as fa
    from tpu_superresolution_torch.models import swinir

    real_pack = fa.pack_window_attention
    monkeypatch.setattr(fa, "pack_window_attention",
                        lambda *a, **k: real_pack(*a, **{**k, "dtype": torch.float32}))

    def launch(xw, packed, mask, codes=None):
        fa.launches.count += 1
        return k7_emulated_launch(xw, packed, mask, codes)

    def through_kernel(xw, wqkv, bqkv, wproj, bproj, rpb, mask, packed=None, codes=None):
        scale = (xw.shape[-1] // rpb.shape[0]) ** -0.5
        return fa._kernel_window_attention(xw, wqkv, bqkv, wproj, bproj, rpb, mask, packed,
                                           codes, scale)

    monkeypatch.setattr(fa, "_launch", launch)
    monkeypatch.setattr(swinir, "fused_window_attention", through_kernel)
    fa.launches.reset()


def _k7_case(bw, ws, c, nh, shift, seed):
    """K7 operands on `bw` windows of ws x ws tokens, images of one (bw
    1) or two windows side by side: raw weights, the table, the gathered
    bias, the shift mask and the token codes."""
    from tpu_superresolution_torch.ops.window import (
        relative_position_bias,
        shift_mask_tensor,
        window_codes_tensor,
    )

    g = torch.Generator().manual_seed(seed)
    n = ws * ws
    hw = (ws, ws * min(bw, 2))
    xw = torch.randn(bw, n, c, generator=g)
    wqkv = torch.randn(3 * c, c, generator=g) * c ** -0.5
    bqkv = 0.1 * torch.randn(3 * c, generator=g)
    wproj, bproj = torch.randn(c, c, generator=g) * c ** -0.5, 0.1 * torch.randn(c, generator=g)
    table = 0.5 * torch.randn((2 * ws - 1) ** 2, nh, generator=g)
    rpb = relative_position_bias(table, ws)
    mask = shift_mask_tensor(*hw, ws, shift, torch.device("cpu")) if shift else None
    codes = window_codes_tensor(*hw, ws, shift, torch.device("cpu"))
    return xw, wqkv, bqkv, wproj, bproj, table, rpb, mask, codes


# ------------------------------------------------------------ plans, routes


_PRODUCT_PLANS = [(792, (264, 3)), (540, (192, 3)), (264, (264, 1)), (576, (192, 3)),
                  (180, (192, 1)), (2304, (256, 9)), (7, (16, 1))]


@pytest.mark.parametrize("c_out,want", _PRODUCT_PLANS, ids=[str(c) for c, _ in _PRODUCT_PLANS])
def test_product_plan_by_width(c_out, want):
    """The product's N tiling from the output width alone: compiled tiles
    that cover it, the least padding with each tile's x reload counted."""
    from tpu_superresolution_torch.kernels.fused_attention import PRODUCT_N_TILES, product_plan

    plan = product_plan(c_out)
    assert (plan.n_tile, plan.n_tiles) == want
    assert plan.n_tile in PRODUCT_N_TILES and plan.n_tile * plan.n_tiles >= c_out
    assert product_plan(c_out) is plan  # cached: the same answer on every call


_STREAM_PLANS = [
    # (Nq, Nk, hd, ws): (hb, nb, ob, ns, whole)
    ((256, 256, 30, 16), (32, 1, 1, 8, True)),    # HAT-SRx4's K7
    ((64, 64, 30, 8), (32, 1, 1, 4, True)),       # SwinIR-L's
    ((36, 36, 30, 6), (32, 1, 1, 4, True)),
    ((1024, 1024, 30, 32), (32, 1, 1, 8, False)),  # ws 32: keys stream
    ((1024, 1024, 64, 32), (64, 1, 1, 8, False)),
    ((256, 256, 96, 16), (64, 2, 2, 8, False)),   # hd 96: two 64-dim blocks
    ((64, 64, 132, 8), (64, 3, 2, 8, False)),     # hd 132: P V in two passes
    ((49, 100, 65, 0), (64, 2, 2, 8, True)),      # K15 past 64 dims
]


@pytest.mark.parametrize("shape,want", _STREAM_PLANS, ids=["x".join(map(str, s))
                                                           for s, _ in _STREAM_PLANS])
def test_stream_plan_is_what_the_entry_accepts(shape, want):
    """``stream_plan`` (the one place the attention's launch is decided):
    its head blocks, passes, chunk and item form, and shared memory
    within the limit for the stages it asks, as the C entry checks."""
    from tpu_superresolution_torch.kernels import window_attention as kw

    nq, nk, hd, ws = shape
    plan = kw.stream_plan(*shape)
    assert (plan.hb, plan.nb, plan.ob, plan.ns, plan.whole) == want
    assert plan.nb * plan.hb >= hd and plan.passes == -(-plan.nb // plan.ob)
    assert 1 <= plan.stages <= kw.STREAM_MAX_STAGES and plan.smem <= kw.WG_SMEM_LIMIT
    assert plan.ns in ((4, 8) if plan.ob == 1 else (8,))
    assert plan.ns != 4 or (plan.whole and nk <= 64)
    if plan.whole:
        assert plan.stages >= 2


_ROUTES = [
    # block_route(ws, C, heads, hidden) and the K15 route of its windows
    ((8, 576, 6, 1152), "window_attention"),  # C 576, hd 96
    ((8, 264, 2, 528), "window_attention"),   # hd 132
    ((32, 128, 2, 256), "window_attention"),  # ws 32 at hd 64
    ((16, 180, 6, 360), "window_attention"),  # HAT-SRx4
    ((8, 180, 6, 360), "block"),              # SwinIR-M
]


@pytest.mark.parametrize("shape,route", _ROUTES, ids=[str(s) for s, _ in _ROUTES])
def test_routes_from_static_shapes(shape, route):
    """Routes from the shapes alone: the block route and, for its
    windows, the K15 route, the same on every call."""
    from tpu_superresolution_torch.kernels.fused_block import block_route
    from tpu_superresolution_torch.kernels.window_attention import k15_route

    ws, c, heads, hidden = shape
    assert block_route(*shape) == block_route(*shape) == route
    hd, n = c // heads, ws * ws
    # masked, P rounded once (K15): the stream kernel at every head dim
    assert k15_route(n, n, hd, True) == "stream"


# ------------------------------------------------------------ packing


@pytest.mark.parametrize("c_in,c_out", [(264, 792), (180, 540), (45, 135), (576, 1728),
                                        (520, 8)])
def test_product_tiles_unswizzle_to_the_weight(c_in, c_out):
    """The product's packed tiles [n_tiles, chunks, N, 64], unswizzled,
    give back the bf16 weight and the bias exactly, zero in the padding."""
    from tpu_superresolution_torch.kernels.fused_attention import pack_window_product

    g = torch.Generator().manual_seed(c_in + c_out)
    w = torch.randn(c_out, c_in, generator=g)
    b = torch.randn(c_out, generator=g)
    packed = pack_window_product(w, b)
    wu, bu = unpack_product(packed)
    assert torch.equal(wu[:c_out, :c_in], w.bfloat16().float())
    assert not wu[c_out:].any() and not wu[:, c_in:].any()
    assert torch.equal(bu[:c_out], b) and not bu[c_out:].any()


@pytest.mark.parametrize("ws", [7, 8, 16, 32])
def test_codes_rebuild_bias_and_mask_bit_for_bit(ws):
    """The table + token-code form decoded as the kernel does gives
    ``relative_position_bias`` and ``shift_mask_tensor`` bit for bit, at
    every shift of an image of 3 x 2 windows (none without a shift)."""
    from tpu_superresolution_torch.ops.window import (
        relative_position_bias,
        shift_mask_tensor,
        window_codes_tensor,
    )

    cpu = torch.device("cpu")
    table = torch.randn((2 * ws - 1) ** 2, 3, generator=torch.Generator().manual_seed(ws))
    h, w = 3 * ws, 2 * ws
    for shift in range(ws):
        codes = window_codes_tensor(h, w, ws, shift, cpu)
        assert codes.dtype == torch.int32 and codes.shape[1] == ws * ws
        rpb, mask = codes_bias_mask(table, codes, ws)
        assert torch.equal(rpb, relative_position_bias(table, ws))
        if shift == 0:
            assert mask is None and codes.shape[0] == 1
        else:
            assert torch.equal(mask, shift_mask_tensor(h, w, ws, shift, cpu))


# ------------------------------------------------------------ schedules


_K7_CASES = [
    # (windows, ws, C, heads, shift): the plans' forms
    (4, 8, 48, 2, 4),     # whole units, 64-key chunk, masked
    (2, 16, 60, 2, 8),    # whole units of 256 keys (HAT-SRx4's form), hd 30
    (1, 32, 64, 1, 16),   # ws 32: 64-row query tiles against 256-key chunks
    (4, 8, 192, 2, 4),    # hd 96: two 64-dim blocks, 128-key chunks
    (4, 8, 264, 2, 0),    # hd 132: P V in two passes
    (4, 6, 40, 4, 3),     # N 36, hd 10
]


@pytest.mark.parametrize("case", _K7_CASES, ids=[f"bw{a}-ws{b}-C{c}-h{d}-s{e}"
                                                 for a, b, c, d, e in _K7_CASES])
def test_k7_schedule_emulated_matches_plain(case):
    """The three kernels' schedules in torch (qkv product into the
    swizzled head-split workspace, the stream attention on a card of 4
    SMs, the proj product), with the bias dense and as table + codes,
    reproduce ``window_attention_plain`` at fp32."""
    from tpu_superresolution_torch.kernels.fused_attention import (
        pack_window_attention,
        window_attention_plain,
    )

    bw, ws, c, nh, shift = case
    xw, wqkv, bqkv, wproj, bproj, table, rpb, mask, codes = _k7_case(bw, ws, c, nh, shift, c)
    want = window_attention_plain(xw, wqkv, bqkv, wproj, bproj, rpb, mask, (c // nh) ** -0.5)
    packed = pack_window_attention(wqkv, bqkv, wproj, bproj, rpb, table, ws, dtype=torch.float32)
    for got in (k7_emulated_launch(xw, packed, mask), k7_emulated_launch(xw, packed, mask, codes)):
        assert not torch.isnan(got).any()
        assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("shift", [0, 4])
def test_k7_rel_form_shift_from_the_mask_not_the_codes(monkeypatch, shift):
    """A map of one window takes one row of codes, which carries region
    bits when the codes were built for a shift.  The wrapper tells the
    attention launch that the block is shifted from the caller's mask (not
    from the codes' rows), and the rel form then reproduces the plain
    version with that mask, or unmasked where the mask is None."""
    from tpu_superresolution_torch.kernels import fused_attention as fa
    from tpu_superresolution_torch.ops.window import shift_mask_tensor, window_codes_tensor

    ws, c, nh = 8, 32, 2
    xw, wqkv, bqkv, wproj, bproj, table, rpb, _, _ = _k7_case(1, ws, c, nh, 0, 11)
    cpu = torch.device("cpu")
    codes = window_codes_tensor(ws, ws, ws, 4, cpu)  # one window, region bits set
    assert codes.shape[0] == 1 and bool((codes >> 16).any())
    mask = shift_mask_tensor(ws, ws, ws, shift, cpu) if shift else None
    seen = []
    monkeypatch.setattr(fa, "_launch_product",
                        lambda x, p, split=None: torch.zeros(x.shape[0], p.c_out))
    monkeypatch.setattr(fa, "launch_stream", lambda *a, **k: seen.append(k["shifted"]))
    packed = fa.pack_window_attention(wqkv, bqkv, wproj, bproj, table=table, ws=ws)
    fa._launch(xw.bfloat16(), packed, mask, codes)
    assert seen == [bool(shift)]
    packed = fa.pack_window_attention(wqkv, bqkv, wproj, bproj, rpb, table, ws,
                                      dtype=torch.float32)
    want = fa.window_attention_plain(xw, wqkv, bqkv, wproj, bproj, rpb, mask, (c // nh) ** -0.5)
    got = k7_emulated_launch(xw, packed, mask, codes)
    assert (got - want).abs().max().item() <= TOL


def test_k15_stream_route_emulated_matches_plain():
    """K15's "stream" route (q, k, v [BW, nH, N, hd] repacked, dense
    bias and mask, head-major out) at hd 72 and at a unit of 1024 keys:
    the schedule in torch reproduces the plain version."""
    from tpu_superresolution_torch.kernels.window_attention import (
        fused_window_attention_plain,
        k15_route,
        stream_plan,
    )

    g = torch.Generator().manual_seed(15)
    for bw, nh, nq, nk, hd, n_mask in ((3, 2, 49, 100, 72, 0), (1, 1, 1024, 1024, 40, 1)):
        assert k15_route(nq, nk, hd, bool(n_mask)) == "stream"
        q = torch.randn(bw, nh, nq, hd, generator=g)
        k, v = torch.randn(bw, nh, nk, hd, generator=g), torch.randn(bw, nh, nk, hd, generator=g)
        bias = 0.5 * torch.randn(nh, nq, nk, generator=g)
        mask = (torch.where(torch.rand(n_mask, nq, nk, generator=g) < 0.3, -100.0, 0.0)
                if n_mask else None)
        plan = stream_plan(nq, nk, hd)
        pad = lambda t: F.pad(t, (0, plan.nb * plan.hb - hd))
        got = stream_emulated(pad(q), pad(k), pad(v), bias, mask, hd ** -0.5, 2, plan)[..., :hd]
        want = fused_window_attention_plain(q, k, v, bias, mask, hd ** -0.5)
        assert (got - want).abs().max().item() <= TOL


def test_k7_kernel_path_counts_and_trains(k7_emulated):
    """The wrapper's CUDA-tensor code on the emulated launches: one K7
    count a call, the rel form where codes are given, and in training
    the autograd function whose gradients are the plain version's."""
    from tpu_superresolution_torch.kernels import fused_attention as fa

    xw, wqkv, bqkv, wproj, bproj, table, rpb, mask, codes = _k7_case(4, 8, 48, 2, 4, 3)
    scale = 24 ** -0.5
    want = fa.window_attention_plain(xw, wqkv, bqkv, wproj, bproj, rpb, mask, scale)
    packed = fa.pack_window_attention(wqkv, bqkv, wproj, bproj, table=table, ws=8)
    with torch.no_grad():
        got = fa._kernel_window_attention(xw, wqkv, bqkv, wproj, bproj, None, mask, packed, codes,
                                          scale)
    assert fa.launches.count == 1 and (got - want).abs().max().item() <= TOL
    leaves = [t.clone().requires_grad_() for t in (xw, wqkv, wproj)]
    fa._kernel_window_attention(leaves[0], leaves[1], bqkv, leaves[2], bproj, rpb, mask, None,
                                None, scale).square().sum().backward()
    ref = [t.clone().requires_grad_() for t in (xw, wqkv, wproj)]
    fa.window_attention_plain(ref[0], ref[1], bqkv, ref[2], bproj, rpb, mask,
                              scale).square().sum().backward()
    assert fa.launches.count == 2
    for a, b in zip(leaves, ref):
        assert torch.allclose(a.grad, b.grad, atol=1e-4)
