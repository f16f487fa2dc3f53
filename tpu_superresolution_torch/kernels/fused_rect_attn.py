"""K9 — the front half of DAT's spatial block (CUDA, ``csrc/dat_rect.cu``
with ``csrc/dat_common.cuh`` and ``csrc/window_attn_stream.cu``).

Port of ``tpu_superresolution_tpu/ops/pallas/fused_rect_attn.py::
fused_rect_attention`` (its ``pallas_call`` at :433), which computes
dat_arch.py:247-438 up to the AIM gating:

    y          = LN1(x)                          (fast variance, eps 1e-5)
    q, k, v    = y Wqkv + bqkv                   (q pre-scaled by hd^-0.5)
    attened_x  = [branch 0 on channels 0..C/2-1 | branch 1 on C/2..C-1]
    conv_x     = erf-GELU(dwconv3x3(v) with the inference BatchNorm folded)

Branch 0 attends inside s0 x s1 windows, branch 1 inside s1 x s0 ones,
each with half the heads, a dynamic position bias [nh/2, N, N] and, in
a shifted block, a cyclic shift of (hsp/2, wsp/2) with the additive
-100 mask of the shifted windows (not -inf).  As in the reference
module chain (dat_arch.py:376-385), q, k and v are zero-padded AFTER
the projection to a multiple of max(s0, s1): the pad tokens are real
keys whose score is the bias alone, and the shift mask is built at the
padded size.  The conv branch runs on the true-coordinate v with SAME
zero padding.

One call is one C entry and four CUDA launches: (1) LN1 and the qkv
product, a persistent wgmma kernel over 128-row tiles of the padded map
(``csrc/dat_common.cuh``), which writes each branch's q, k and v
head-split into a workspace in the branch's rolled, padded window order
(``front_rows``), zeros at the pad tokens, and v at true coordinates;
(2, 3) the stream attention (``csrc/window_attn_stream.cu``) once a
branch, its bias the branch's DynamicPosBias table [(2hsp-1)(2wsp-1),
nh/2] resident in shared memory with one int32 code a token
(``rect_codes``: the position and the shift region, so the dense
[nh/2, N, N] bias and the mask are never read), its outputs stored
straight to their pixels; (4) the conv branch over 8 x 16-pixel tiles.
The weights carry the two tables (``RectAttnWeights.table0/1``); their
gather by ``relative_position_index`` is the dense bias the plain
version adds.  It takes even C <= 192, at most 3 heads per branch of hd
<= 32 and N = s0 * s1 <= 256, a multiple of 64, whose sides divide each
other ((8, 16) and the published DAT x4's (8, 32)), any image size, and
raises otherwise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib
from tpu_superresolution_torch.kernels.dwconv import depthwise3x3
from tpu_superresolution_torch.kernels.layernorm import layernorm_plain
from tpu_superresolution_torch.kernels.window_attention import stream_plan, wg_ctas_per_head
from tpu_superresolution_torch.ops.window import (
    rect_mask_tensor,
    rect_shift_region_ids,
    rect_window_partition,
    rect_window_reverse,
    relative_position_index,
)

LN_EPS = 1e-5
# Compile-time sizes of csrc/dat_common.cuh's product kernel.
CP = 192          # padded channels (three 64-column chunks)
HDP = 32          # padded head dim
NHB_MAX = 3       # heads per branch
MAX_TOKENS = 256  # tokens per window (s0 * s1)
PRODUCT_BM = 128  # rows a tile
PRODUCT_BN = 96   # columns an N tile: three head slots of 32
PRODUCT_BK = 64
PRODUCT_CHUNKS = CP // PRODUCT_BK

launches = _lib.LaunchCounter("K9 rect_attention")


@dataclasses.dataclass(frozen=True)
class RectAttnWeights:
    """One spatial block's front: LN1 (`g1`, `b1`), the qkv Linear
    ([3C, C], bias [3C] or None), the conv branch's depthwise kernel
    [3, 3, C] and bias [C] with the inference BatchNorm folded in, the
    two branches' dynamic position biases [nh/2, N, N] (branch 0 for
    s0 x s1 windows, branch 1 for s1 x s0), the head count and the
    split (s0, s1); the kernel reads the biases as the DynamicPosBias
    tables `table0` / `table1` [(2hsp-1)(2wsp-1), nh/2] whose gather
    they are (``rect_bias_from_table``)."""

    g1: torch.Tensor
    b1: torch.Tensor
    wqkv: torch.Tensor
    bqkv: Optional[torch.Tensor]
    wdw: torch.Tensor
    bdw: torch.Tensor
    bias0: torch.Tensor
    bias1: torch.Tensor
    num_heads: int
    split: Tuple[int, int]
    table0: Optional[torch.Tensor] = None
    table1: Optional[torch.Tensor] = None

    @property
    def dim(self) -> int:
        return int(self.wqkv.shape[1])


def rect_bias_from_table(table: torch.Tensor, hsp: int, wsp: int) -> torch.Tensor:
    """The dense bias [heads, N, N] fp32 of an hsp x wsp window: the table
    [(2hsp-1)(2wsp-1), heads] gathered by ``relative_position_index``
    (``models/dat.py::RectBranch.bias``)."""
    n = hsp * wsp
    idx = torch.from_numpy(relative_position_index(hsp, wsp).reshape(-1).astype(np.int64))
    return table.float()[idx.to(table.device)].reshape(n, n, -1).permute(2, 0, 1).contiguous()


def scaled_qkv(wqkv: torch.Tensor, bqkv: Optional[torch.Tensor], scale: float):
    """The qkv weight and bias in fp32 with the q rows scaled by `scale`
    (the kernels' pre-scaled q, ``_prep_branch_weights``)."""
    c = wqkv.shape[1]
    qs = torch.ones(3 * c, device=wqkv.device)
    qs[:c] = scale
    b = None if bqkv is None else bqkv.float() * qs
    return wqkv.float() * qs[:, None], b


def dwconv_gelu_plain(v: torch.Tensor, wdw: torch.Tensor, bdw: torch.Tensor) -> torch.Tensor:
    """erf-GELU(depthwise3x3(v)) in v's dtype (BatchNorm folded into
    wdw, bdw): DAT's conv branch as the kernels compute it."""
    return F.gelu(depthwise3x3(v, wdw, bdw)).to(v.dtype).contiguous()


def _rect_branch(q, k, v, bias, mask, hsp, wsp, nhb):
    """Window attention of one branch on [B, Hp, Wp, C/2] (fp32 scores
    and softmax, q already scaled)."""
    b, hp, wp, cb = q.shape
    hd = cb // nhb
    n = hsp * wsp
    win = lambda t: rect_window_partition(t, hsp, wsp).reshape(-1, n, nhb, hd)
    qw, kw, vw = win(q), win(k), win(v)
    s = torch.einsum("wqhd,wkhd->whqk", qw.float(), kw.float()) + bias.float()[None]
    if mask is not None:
        nwm = mask.shape[0]
        s = (s.reshape(-1, nwm, nhb, n, n) + mask[None, :, None]).reshape(s.shape)
    a = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("whqk,wkhd->wqhd", a, vw).reshape(-1, n, cb)
    return rect_window_reverse(o, hsp, wsp, hp, wp)


def rect_front(x: torch.Tensor, w: RectAttnWeights, shifted: bool, *,
               ln1: Optional[Callable] = None, conv_branch: Optional[Callable] = None,
               attention: Callable = _rect_branch) -> Tuple[torch.Tensor, torch.Tensor]:
    """The front of a DAT spatial block as one composition: (attened_x,
    conv_x), both [B, H, W, C] in x's dtype.  ``y = ln1(x, g1, b1)``, the
    qkv product in x's dtype (q pre-scaled), ``conv_x =
    conv_branch(v)`` on the unpadded v, q, k and v zero-padded to a
    multiple of max(s0, s1), and per branch the cyclic shift and shift
    mask, ``attention(q, k, v, bias, mask, hsp, wsp, heads)`` on the
    branch's [B, Hp, Wp, C/2] maps, the shift back and the crop.  With its
    default steps it is K9's plain version (LayerNorm in fp32, the conv
    branch with BatchNorm folded, scores and softmax in fp32); DAT's
    module chain (``models/dat.py``) passes K2, its conv branch (K11,
    BatchNorm, GELU) and K16."""
    b, h, wd, c = x.shape
    dt = x.dtype
    s0, s1 = w.split
    nhb, half = w.num_heads // 2, c // 2
    wq, bq = scaled_qkv(w.wqkv, w.bqkv, (half // nhb) ** -0.5)
    y = (ln1 or (lambda t, g, bb: layernorm_plain(t, g, bb, LN_EPS)))(x, w.g1, w.b1)
    qkv = F.linear(y, wq.to(dt), None if bq is None else bq.to(dt))
    q, k, v = qkv.split(c, dim=-1)
    conv_x = conv_branch(v) if conv_branch else dwconv_gelu_plain(v, w.wdw, w.bdw)
    ms = max(s0, s1)
    hp, wp = -(-h // ms) * ms, -(-wd // ms) * ms
    if (hp, wp) != (h, wd):  # zeros after the projection (dat_arch.py:376-385)
        q, k, v = (F.pad(t, (0, 0, 0, wp - wd, 0, hp - h)) for t in (q, k, v))
    outs = []
    for idx, (hsp, wsp), bias in ((0, (s0, s1), w.bias0), (1, (s1, s0), w.bias1)):
        sl = slice(idx * half, (idx + 1) * half)
        qi, ki, vi = q[..., sl], k[..., sl], v[..., sl]
        sh, sw = hsp // 2, wsp // 2
        roll = shifted and (sh or sw)
        mask = None
        if roll:
            qi, ki, vi = (torch.roll(t, (-sh, -sw), (1, 2)) for t in (qi, ki, vi))
            mask = rect_mask_tensor(hp, wp, hsp, wsp, sh, sw, x.device)
        o = attention(qi, ki, vi, bias, mask, hsp, wsp, nhb)
        if roll:
            o = torch.roll(o, (sh, sw), (1, 2))
        outs.append(o[:, :h, :wd])
    return torch.cat(outs, dim=-1).contiguous(), conv_x


def rect_attention_plain(x: torch.Tensor, w: RectAttnWeights,
                         shifted: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K9: (attened_x, conv_x), both
    [B, H, W, C] in x's dtype (``rect_front`` with its default steps).
    LayerNorm, qkv and the attention output in x's dtype, scores and
    softmax in fp32, the conv branch in fp32 on v's values (the module
    chain of the JAX package, with the kernel's pre-scaled q and folded
    BatchNorm)."""
    return rect_front(x, w, shifted)


def rect_ok(c: int, num_heads: int, split: Sequence[int]) -> bool:
    """Whether K9 takes a spatial block of C channels, `num_heads` heads
    and `split` (shapes only; every image size runs): even C <= 192, an
    even head count with <= 3 heads per branch of hd <= 32, and N = s0 *
    s1 <= 256 tokens a window, a multiple of 64, with max(s0, s1) a
    multiple of min(s0, s1) (the JAX kernel's splits: (8, 8), (4, 16),
    (8, 16), (8, 32))."""
    s0, s1 = split
    nhb = num_heads // 2
    n = s0 * s1
    return not (c > CP or c % 2 or num_heads % 2 or not 0 < nhb <= NHB_MAX or (c // 2) % nhb
                or (c // 2) // nhb > HDP or not 0 < n <= MAX_TOKENS or n % 64
                or max(s0, s1) % min(s0, s1))


def check_rect_args(shape, w: RectAttnWeights, name: str = "rect_attention") -> None:
    """Raise unless an x of `shape` and the weights fit the kernel."""
    if len(shape) != 4 or shape[3] != w.dim:
        raise ValueError(f"{name}: x {tuple(shape)} is not [B, H, W, {w.dim}]")
    c, nh = w.dim, w.num_heads
    if not rect_ok(c, nh, w.split):
        raise ValueError(
            f"{name}: the kernel takes even C <= {CP}, an even head count with <= {NHB_MAX} "
            f"heads per branch of hd <= {HDP} and s0 * s1 <= {MAX_TOKENS}, a multiple of 64, "
            f"with sides that divide each other; got C={c}, heads={nh}, split={w.split}")


def pack_front_product(w6: torch.Tensor, b6: torch.Tensor,
                       dtype: torch.dtype = torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """The product kernel's weight stream (K9 and K14, ``csrc/
    dat_common.cuh``): w6 [6, 96, C] fp32 (six N tiles of three 32-column
    head slots, in the kernel's N-tile order) as [6, 3, 96, 64] in
    `dtype` (the kernel's bf16, or fp32 for the CPU tests' emulation),
    C zero-padded to 192 (the kernel's three 64-column chunks, whatever
    C), each [96, 64] tile K-major and
    128B-swizzled (16-byte chunk j of row n at j ^ (n % 8)); b6 [6, 96] as
    the fp32 bias [576]."""
    from tpu_superresolution_torch.kernels.cab_conv import _swizzle_rows

    c = int(w6.shape[-1])
    w = F.pad(w6.float(), (0, CP - c))
    w = w.reshape(6, PRODUCT_BN, PRODUCT_CHUNKS, PRODUCT_BK).transpose(1, 2)
    return (_swizzle_rows(w).to(dtype).contiguous(),
            b6.float().reshape(6 * PRODUCT_BN).contiguous())


@dataclasses.dataclass(frozen=True)
class PackedRect:
    """K9's operands: the product's weight tiles ``wp`` [6, 3, 96, 64]
    bf16 (``pack_front_product``; N tile (part, branch) = the branch's
    q, k or v of 3 head slots x 32, q pre-scaled, zero-padded) and its
    fp32 bias [576], the two branches' bias tables [2, (2s0-1)(2s1-1),
    nh/2] fp32, LN1, and the folded depthwise kernel [9, C] and bias."""

    wp: torch.Tensor
    bqkv: torch.Tensor
    tables: torch.Tensor
    g1: torch.Tensor
    b1: torch.Tensor
    wdw: torch.Tensor
    bdw: torch.Tensor
    dim: int
    num_heads: int
    split: Tuple[int, int]


@torch.no_grad()
def pack_rect_weights(w: RectAttnWeights, dtype: torch.dtype = torch.bfloat16) -> PackedRect:
    """Lay a spatial block's front out for K9 (the counterpart of the
    JAX package's ``_prep_branch_weights``; the weight stream in `dtype`,
    fp32 for the CPU tests' emulation); built once per loaded weights at
    inference.  The weights must carry the bias tables."""
    check_rect_args((1, 1, 1, w.dim), w)
    c, nhb = w.dim, w.num_heads // 2
    hd = c // 2 // nhb
    s0, s1 = w.split
    if w.table0 is None or w.table1 is None:
        raise ValueError("rect_attention: K9 reads the branches' DynamicPosBias tables "
                         "(RectAttnWeights.table0 / table1)")
    tsize = (2 * s0 - 1) * (2 * s1 - 1)
    for t in (w.table0, w.table1):
        if tuple(t.shape) != (tsize, nhb):
            raise ValueError(f"rect_attention: table {tuple(t.shape)} is not the "
                             f"[(2s0-1)(2s1-1), nh/2] = [{tsize}, {nhb}] table of split {w.split}")
    wq, bq = scaled_qkv(w.wqkv, w.bqkv, hd ** -0.5)
    if bq is None:
        bq = torch.zeros(3 * c, device=wq.device)
    # [3 parts, 2 branches, heads, hd, in] -> N tiles (part, branch) of 3 x 32
    wq = F.pad(wq.reshape(3, 2, nhb, hd, c), (0, 0, 0, HDP - hd, 0, NHB_MAX - nhb))
    bq = F.pad(bq.reshape(3, 2, nhb, hd), (0, HDP - hd, 0, NHB_MAX - nhb))
    wp, bp = pack_front_product(wq.reshape(6, PRODUCT_BN, c), bq.reshape(6, PRODUCT_BN), dtype)
    return PackedRect(
        wp=wp, bqkv=bp,
        tables=torch.stack([w.table0.float(), w.table1.float()]).contiguous(),
        g1=w.g1.float().contiguous(), b1=w.b1.float().contiguous(),
        wdw=w.wdw.float().reshape(9, c).contiguous(), bdw=w.bdw.float().contiguous(),
        dim=c, num_heads=w.num_heads, split=tuple(w.split))


def padded_size(h: int, w: int, split: Sequence[int]) -> Tuple[int, int]:
    """(Hp, Wp): H and W rounded up to a multiple of max(s0, s1)."""
    ms = max(split)
    return -(-h // ms) * ms, -(-w // ms) * ms


def branch_geometry(split: Sequence[int], shifted: bool):
    """Per branch (hsp, wsp, sh, sw): branch 0's s0 x s1 windows, branch
    1's s1 x s0, rolled by half a window where the block is shifted."""
    s0, s1 = split
    out = []
    for hsp, wsp in ((s0, s1), (s1, s0)):
        out.append((hsp, wsp, hsp // 2 if shifted else 0, wsp // 2 if shifted else 0))
    return out


def rect_codes(hp: int, wp: int, hsp: int, wsp: int, sh: int, sw: int) -> np.ndarray:
    """One int32 code a token of the branch's windows on the padded Hp x
    Wp map: bits 0-15 its position y (2wsp-1) + x in the window, so that
    ``relative_position_index(hsp, wsp)``[i, j] = pos_i - pos_j + (hsp-1)
    (2wsp-1) + wsp-1; bits 16-31, where the block is rolled (sh or sw),
    its ``rect_shift_region_ids`` label on the padded map.  [1, N] when
    not rolled, else [windows an image, N] (window w takes row w % nW)."""
    yy, xx = np.divmod(np.arange(hsp * wsp), wsp)
    pos = (yy * (2 * wsp - 1) + xx).astype(np.int32)[None]
    if not (sh or sw):
        return pos
    return (pos | (rect_shift_region_ids(hp, wp, hsp, wsp, sh, sw) << 16)).astype(np.int32)


@functools.lru_cache(maxsize=64)
def rect_codes_tensor(hp: int, wp: int, hsp: int, wsp: int, sh: int, sw: int,
                      device: torch.device) -> torch.Tensor:
    """``rect_codes`` as an int32 tensor on `device`, built once."""
    return torch.from_numpy(rect_codes(hp, wp, hsp, wsp, sh, sw)).to(device)


def front_rows(b: int, h: int, w: int, split: Sequence[int], shifted: bool) -> np.ndarray:
    """The product kernel's K9 row map (``csrc/dat_common.cuh::row_info``):
    for each row of the tiles (image, pos) of the padded map, pos = y Wp +
    x < Hp Wp (rows past the map are not stored), [B, Hp Wp, 5] int64:
    (window, token) in branch 0's and branch 1's rolled, padded window
    order (``rect_window_partition`` of the rolled map: window (img, wy,
    wx), token (ty, tx)) and the pixel (img H + y) W + x, or -1 at a pad
    token."""
    hp, wp = padded_size(h, w, split)
    y, x = np.divmod(np.arange(hp * wp), wp)
    out = np.empty((b, hp * wp, 5), dtype=np.int64)
    img = np.arange(b)[:, None]
    for br, (hsp, wsp, sh, sw) in enumerate(branch_geometry(split, shifted)):
        pr, pc = (y - sh) % hp, (x - sw) % wp
        wy, wx = pr // hsp, pc // wsp
        out[..., 2 * br] = (img * (hp // hsp) + wy) * (wp // wsp) + wx
        out[..., 2 * br + 1] = (pr % hsp) * wsp + pc % wsp
    real = (y < h) & (x < w)
    out[..., 4] = np.where(real, (img * h + y) * w + x, -1)
    return out


@functools.lru_cache(maxsize=64)
def rect_geometry(b: int, h: int, w: int, c: int, nhb: int, split: Tuple[int, int],
                  roll: bool, vec: int, sms: int) -> ctypes.Array:
    """The C entry's geometry array (``csrc/dat_rect.cu``): the shapes,
    the product's grid (one CTA an SM, at most one a tile) and tiles an
    image, and the stream attention's plan at N = s0 s1 tokens of hd
    dims with the rect table (``window_attention.stream_plan``)."""
    s0, s1 = split
    hp, wp = padded_size(h, w, split)
    n, hd = s0 * s1, c // 2 // nhb
    tpi = -(-hp * wp // PRODUCT_BM)
    plan = stream_plan(n, n, hd, s0, s1)
    bw = b * hp * wp // n
    n_codes = hp * wp // n if roll else 1
    return (ctypes.c_int * 21)(
        b, h, w, c, nhb, hd, s0, s1, int(roll), hp, wp, min(b * tpi, sms), tpi, vec, plan.hb, plan.ob, plan.ns, plan.stages, int(plan.whole),
        wg_ctas_per_head(bw, nhb, sms), n_codes)


def _launch(x: torch.Tensor, pk: PackedRect, shifted: bool):
    b, h, wd, c = x.shape
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    nhb = pk.num_heads // 2
    s0, s1 = pk.split
    vec = 4 if c % 4 == 0 and x.data_ptr() % 8 == 0 else 2
    _lib.check_tensor(x, "x", bf, dev, ndim=4, align=2 * vec)
    tsize = (2 * s0 - 1) * (2 * s1 - 1)
    for name, t, shape, dtype, align in (
            ("wp", pk.wp, (6, PRODUCT_CHUNKS, PRODUCT_BN, PRODUCT_BK), bf, 16),
            ("bqkv", pk.bqkv, (6 * PRODUCT_BN,), f32, 4),
            ("tables", pk.tables, (2, tsize, nhb), f32, 4),
            ("g1", pk.g1, (c,), f32, 4), ("b1", pk.b1, (c,), f32, 4),
            ("wdw", pk.wdw, (9, c), f32, 4), ("bdw", pk.bdw, (c,), f32, 4)):
        _lib.check_tensor(t, name, dtype, dev, shape=shape, align=align)
    hp, wp = padded_size(h, wd, pk.split)
    geo = branch_geometry(pk.split, shifted)
    roll = shifted and any(sh or sw for _, _, sh, sw in geo)
    codes = [rect_codes_tensor(hp, wp, hsp, wsp, sh, sw, dev) for hsp, wsp, sh, sw in geo]
    geom = rect_geometry(b, h, wd, c, nhb, (s0, s1), roll, vec, _lib.sm_count(dev.index))
    out = torch.empty_like(x)
    conv = torch.empty_like(x)
    v = torch.empty_like(x)  # v at true coordinates, for the conv branch
    ws = torch.empty(2, 3 * b * hp * wp * nhb * HDP, dtype=bf, device=dev)
    status = _lib.call(
        x, _lib.library().sr_dat_rect_bf16, x.data_ptr(), out.data_ptr(), conv.data_ptr(),
        v.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(), pk.g1.data_ptr(), pk.b1.data_ptr(),
        pk.wp.data_ptr(), pk.bqkv.data_ptr(), pk.tables.data_ptr(), codes[0].data_ptr(),
        codes[1].data_ptr(), pk.wdw.data_ptr(), pk.bdw.data_ptr(), geom, LN_EPS,
        _lib.stream_of(x))
    _lib.check_status(status, "sr_dat_rect_bf16")
    launches.count += 1
    return out, conv


def rect_attention(x: torch.Tensor, w: RectAttnWeights, shifted: bool,
                   packed: Optional[PackedRect] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(attened_x, conv_x) of a spatial block's front on x [B, H, W, C]:
    the plain version for a CPU tensor, K9 for a CUDA tensor (bf16, any
    H and W; `packed` from ``pack_rect_weights``, built here if None).
    Inference only."""
    if x.device.type == "cpu":
        return rect_attention_plain(x, w, shifted)
    if _lib.exporting():
        from tpu_superresolution_torch.kernels import custom_ops

        check_rect_args(tuple(x.shape), w)
        return custom_ops.rect_attention(x.contiguous(), packed or pack_rect_weights(w), shifted)
    _lib.require_cuda(x, "rect_attention")
    check_rect_args(tuple(x.shape), w)
    return _launch(x.contiguous(), packed or pack_rect_weights(w), shifted)
