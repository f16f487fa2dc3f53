"""K10 — the tail of a DAT block (CUDA, ``csrc/dat_tail.cu``).

Port of ``tpu_superresolution_tpu/ops/pallas/fused_datb_tail.py::
fused_datb_tail`` (its ``pallas_call`` at :374): AIM gating -> proj ->
residual -> LN2 -> SGFN -> residual (dat_arch.py:420-437, :510-527,
:38-90, :559-562).  Both block types use one formula once the inputs are
ordered (``fused_datb_tail.py:13-18``): `u` is gated by the channel
vector and is the source of the per-pixel spatial map, `w_px` is gated
by that map:

    spatial block:  u = attened_x, w_px = conv_x
    channel block:  u = conv_x,    w_px = attened_x

    m    = sigmoid(w2 . erf-GELU(W1 u + b1) + b2)    (BatchNorm folded into W1, b1)
    x2   = x + proj(u * gate + w_px * m)
    h    = erf-GELU(fc1(LN2(x2)));  h1, h2 = the two halves
    out  = x2 + fc2(h1 * (dwconv3x3(LN_sg(h2)) + bdw))

The channel gate (a global mean) comes in as `gate` [B, C], sigmoid
applied.  LN2 and LN_sg use the fast-variance formula (eps 1e-5), both
GELUs the exact erf, and the depthwise conv SAME zero padding.

The kernel (``tail_plan`` decides its launch from the shapes): persistent
CTAs walk bands of image rows of a strip of <= 64 pixels (the whole row
where W <= 64; else 62 output columns and a halo column each side), one
image row a wgmma m64 tile.  The chain up to LN_sg runs once a pixel of
the band and its two halo rows; a ring of three bf16 h2 rows in shared
memory feeds the depthwise conv, LN_sg's statistics come from a first
pass over fc1's h2 chunks, and per 64-channel chunk of the output row's
h1 the conv and the gate product fill a bf16 A chunk of fc2.  Two
consumer warpgroups split every product's N; the weights come from
``pack_tail_weights``' stream of swizzled tiles; x2 sits in a per-CTA
fp32 workspace between a row's chain and its output.  One call is one
CUDA launch.  The kernel takes C <= 192, an SGFN half <= 384 and C // 16
<= 16, any image size, and raises otherwise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib
from tpu_superresolution_torch.kernels.dwconv import depthwise3x3
from tpu_superresolution_torch.kernels.layernorm import layernorm_plain

LN_EPS = 1e-5
BN_EPS = 1e-5
# csrc/dat_tail.cu's limits: channels, SGFN half, spatial-map width
# (C // 16), pixels a tile, weight-ring stages of 8 KB, shared memory.
MAX_C = 192
MAX_HALF = 384
SPP = 16
ROWS = 64
STAGE_BYTES = 8192
MAX_STAGES = 8
SMEM_LIMIT = 232448

launches = _lib.LaunchCounter("K10 datb_tail")


def fold_bn_into_dense(wk, bk, bn_scale, bn_bias, bn_mean, bn_var, eps: float = BN_EPS):
    """Fold an inference BatchNorm (y = (x - mean) / sqrt(var + eps) *
    scale + bias) into the preceding dense / 1x1-conv weights, features
    on the LAST axis of `wk` (the JAX package's ``fold_bn_into_dense``,
    ``fused_datb_tail.py:384-389``)."""
    s = bn_scale * torch.rsqrt(bn_var + eps)
    return wk * s, bk * s + bn_bias - bn_mean * s


@dataclasses.dataclass(frozen=True)
class TailWeights:
    """A block tail's weights in the reference torch layouts ([out, in]
    for the 1x1 convs and Linears): the spatial interaction with its
    BatchNorm folded into `sp_w1` / `sp_b1` ([C//16, C]; `sp_w2` [1,
    C//16], `sp_b2` [1]), proj, LN2, the SGFN's fc1 [2 half, C], sg_norm,
    its depthwise conv [3, 3, half] + bias, and fc2 [C, half]."""

    sp_w1: torch.Tensor
    sp_b1: torch.Tensor
    sp_w2: torch.Tensor
    sp_b2: torch.Tensor
    wproj: torch.Tensor
    bproj: torch.Tensor
    g2: torch.Tensor
    b2: torch.Tensor
    wfc1: torch.Tensor
    bfc1: torch.Tensor
    gsg: torch.Tensor
    bsg: torch.Tensor
    wdw: torch.Tensor
    bdw: torch.Tensor
    wfc2: torch.Tensor
    bfc2: torch.Tensor

    @property
    def dim(self) -> int:
        return int(self.wproj.shape[0])

    @property
    def half(self) -> int:
        return int(self.wfc2.shape[1])


def datb_tail_plain(x: torch.Tensor, u: torch.Tensor, w_px: torch.Tensor, gate: torch.Tensor,
                    w: TailWeights, *, spatial_map: Optional[Callable] = None,
                    ln: Optional[Callable] = None, dwconv: Callable = depthwise3x3,
                    linear: Optional[Callable] = None,
                    branch_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tail of a DAT block as one composition, in x's dtype: the
    per-pixel map ``spatial_map(u)`` [B, H, W, 1], the AIM gating, proj
    (``linear(a, weight, bias)``) and the residual, ``ln`` (LN2), fc1 and
    GELU, ``ln`` (sg_norm) and ``dwconv`` on the gate half, fc2 and the
    residual; the residual stream in fp32, `branch_scales` [B, 2] (drop
    path) on the two residual branches.  With its default steps it is
    K10's plain version: products in fp32 on operands rounded to x's
    dtype where the kernel rounds them (the JAX kernel's casts), h1 and
    the statistics in fp32, the spatial map from the folded weights.
    DAT's module chain (``models/dat.py``) passes its spatial interaction
    (BatchNorm on batch or running statistics), K2, K11 and products in
    x's dtype."""
    dt = x.dtype
    r = lambda t: t.to(dt).float()
    lin = linear or (lambda a, wt, b: F.linear(r(a), r(wt), b.float()))
    ln = ln or (lambda t, g, b: layernorm_plain(t, g, b, LN_EPS))
    if spatial_map is None:
        pm = F.linear(r(F.gelu(lin(u, w.sp_w1, w.sp_b1))), r(w.sp_w2), w.sp_b2.float())
    else:
        pm = spatial_map(u).float()
    sg = u.float() * gate.float()[:, None, None, :] + w_px.float() * torch.sigmoid(pm)
    y = lin(sg, w.wproj, w.bproj).float()
    if branch_scales is not None:
        y = y * branch_scales[:, 0, None, None, None]
    x2 = x.float() + y
    hdn = F.gelu(lin(ln(x2, w.g2, w.b2), w.wfc1, w.bfc1))
    half = w.half
    h2 = r(ln(hdn[..., half:], w.gsg, w.bsg))
    g = hdn[..., :half] * dwconv(h2, w.wdw, w.bdw)
    y = lin(g, w.wfc2, w.bfc2).float()
    if branch_scales is not None:
        y = y * branch_scales[:, 1, None, None, None]
    return (x2 + y).to(dt)




def _pad64(n: int) -> int:
    return -(-n // 64) * 64


def tail_ok(c: int, half: int, width: int) -> bool:
    """Whether K10 takes a block tail of C channels, SGFN half `half` and
    spatial-map width `width` (C // 16) (shapes only; every image size
    runs): C <= 192, half <= 384, width <= 16."""
    return 1 <= c <= MAX_C and 1 <= half <= MAX_HALF and width <= SPP


def check_tail_args(shape, w: TailWeights, name: str = "datb_tail") -> None:
    if len(shape) != 4 or shape[3] != w.dim:
        raise ValueError(f"{name}: x {tuple(shape)} is not [B, H, W, {w.dim}]")
    c, half, m = w.dim, w.half, int(w.sp_w1.shape[0])
    if not tail_ok(c, half, m) or w.wfc1.shape[0] != 2 * half:
        raise ValueError(f"{name}: the kernel takes C <= {MAX_C}, an SGFN half <= {MAX_HALF} "
                         f"and a spatial map width <= {SPP}; got C={c}, half={half}, width={m}")


def vec_offsets(cp: int, hp: int) -> dict:
    """Where each fp32 vector of ``PackedTail.vec`` starts, for padded
    width `cp` and half `hp` (csrc/dat_tail.cu ``vec_offsets``): the
    spatial map's b1 and w2 [16] and b2, bproj, LN2's scale and bias
    [cp], fc1's bias [2 hp] (h1 then h2), sg_norm's scale and bias [hp],
    the depthwise taps [9, hp] and bias [hp], fc2's bias [cp]."""
    o = dict(spb1=0, spw2=16, spb2=32, bproj=36)
    o["g2"] = o["bproj"] + cp
    o["b2"] = o["g2"] + cp
    o["bfc1"] = o["b2"] + cp
    o["gsg"] = o["bfc1"] + 2 * hp
    o["bsg"] = o["gsg"] + hp
    o["wdw"] = o["bsg"] + hp
    o["bdw"] = o["wdw"] + 9 * hp
    o["bfc2"] = o["bdw"] + hp
    o["total"] = o["bfc2"] + cp
    return o


@dataclasses.dataclass(frozen=True)
class TailPlan:
    """K10's launch, from static shapes: the padded width `cp` and half
    `hp` (multiples of 64), the strips of an image row (`halo` 1 where W
    > 64: each strip's tile then holds its `seg` output columns and one
    halo column each side; else one strip of all W), the image rows a
    unit (`band`) and the units, the persistent grid and the weight
    ring's stages."""

    cp: int
    hp: int
    halo: int
    seg: int
    strips: int
    band: int
    nbands: int
    units: int
    grid: int
    stages: int

    @property
    def smem(self) -> int:
        """Shared memory a CTA: the alignment slack, the weight ring, two
        [64, cp] bf16 A buffers, the [64, 64] bf16 gate-product chunk,
        three [64, hp] bf16 h2 rows, the two LayerNorms' row sums of each
        warpgroup, barriers."""
        return (1024 + self.stages * STAGE_BYTES + 2 * ROWS * self.cp * 2 + ROWS * 64 * 2
                + 3 * ROWS * self.hp * 2 + 2 * 2 * ROWS * 8 + 2 * MAX_STAGES * 8)


@functools.lru_cache(maxsize=256)
def tail_plan(b: int, h: int, w: int, c: int, half: int, sms: int) -> TailPlan:
    """K10's launch on x [B, H, W, C] with SGFN half `half` for a card of
    `sms` SMs: bands of ceil(B * strips * H / sms) rows (about one unit
    an SM; a band recomputes the chain on its two halo rows), as many
    8 KB weight stages as shared memory leaves (<= 8; 2 at C 192 / half
    384)."""
    if not tail_ok(c, half, c // 16):
        raise ValueError(f"tail_plan: C={c}, half={half} outside the kernel")
    cp, hp = _pad64(c), _pad64(half)
    halo = int(w > ROWS)
    seg = ROWS - 2 if halo else w
    strips = -(-w // seg)
    band = min(h, max(1, -(-b * strips * h // sms)))
    nbands = -(-h // band)
    units = b * strips * nbands
    fixed = TailPlan(cp, hp, halo, seg, strips, band, nbands, units, 0, 0).smem
    stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) // STAGE_BYTES)
    return TailPlan(cp, hp, halo, seg, strips, band, nbands, units, min(units, sms), stages)


@dataclasses.dataclass(frozen=True)
class PackedTail:
    """K10's operands: `tiles`, the weight stream of [N, 64] K-major
    tiles, each 128B-swizzled (16-byte chunk j of row n at chunk j ^ (n %
    8)), in the kernel's order: the spatial map's W1 ([16, 64] a 64-column
    K chunk), the proj ((K chunk, 64-row N tile)), fc1's h2 half ((64-row
    chunk, K chunk)), then per 64-column chunk of the half fc1's h1 rows
    (its K chunks) and fc2's columns (its N tiles); every weight
    zero-padded to the padded width `cp` and half `hp`.  `vec`: the fp32
    vectors at ``vec_offsets`` (sp_w2 holding values of the stream's
    dtype, as the JAX kernel casts it)."""

    tiles: torch.Tensor
    vec: torch.Tensor
    dim: int
    half: int

    @property
    def cp(self) -> int:
        return _pad64(self.dim)

    @property
    def hp(self) -> int:
        return _pad64(self.half)


@torch.no_grad()
def pack_tail_weights(w: TailWeights, dtype: torch.dtype = torch.bfloat16) -> PackedTail:
    """Lay a block tail out for K10 (once per loaded weights); `dtype`
    the stream's (fp32 for the tests' emulation of the kernel)."""
    from tpu_superresolution_torch.kernels.cab_conv import _swizzle_rows

    check_tail_args((1, 1, 1, w.dim), w)
    c, half, m = w.dim, w.half, int(w.sp_w1.shape[0])
    cp, hp = _pad64(c), _pad64(half)
    kc, hpc = cp // 64, hp // 64
    pad = lambda t, rows, cols: F.pad(t.float(), (0, cols - t.shape[1], 0, rows - t.shape[0]))
    sp, proj = pad(w.sp_w1, SPP, cp), pad(w.wproj, cp, cp)
    fc1a, fc1b = pad(w.wfc1[:half], hp, cp), pad(w.wfc1[half:], hp, cp)
    fc2 = pad(w.wfc2, cp, hp)
    tile = lambda t, r, k, rows=64: t[r * rows:(r + 1) * rows, k * 64:(k + 1) * 64]
    parts = [tile(sp, 0, i, SPP) for i in range(kc)]
    parts += [tile(proj, n, i) for i in range(kc) for n in range(kc)]
    parts += [tile(fc1b, j, i) for j in range(hpc) for i in range(kc)]
    for j in range(hpc):
        parts += [tile(fc1a, j, i) for i in range(kc)] + [tile(fc2, n, j) for n in range(kc)]
    tiles = torch.cat([_swizzle_rows(t.contiguous()).reshape(-1) for t in parts])
    o = vec_offsets(cp, hp)
    vec = torch.zeros(o["total"], device=w.wproj.device)
    for key, t in (("spb1", w.sp_b1), ("spw2", w.sp_w2.reshape(m).to(dtype)),
                   ("spb2", w.sp_b2.reshape(1)), ("bproj", w.bproj), ("g2", w.g2),
                   ("b2", w.b2), ("bfc1", w.bfc1[:half]), ("gsg", w.gsg), ("bsg", w.bsg),
                   ("bdw", w.bdw), ("bfc2", w.bfc2)):
        vec[o[key]:o[key] + t.numel()] = t.float().reshape(-1)
    vec[o["bfc1"] + hp:o["bfc1"] + hp + half] = w.bfc1[half:].float()
    taps = vec[o["wdw"]:o["bdw"]].view(9, hp)
    taps[:, :half] = w.wdw.float().reshape(9, half)
    return PackedTail(tiles=tiles.to(dtype).contiguous(), vec=vec, dim=c, half=half)


@functools.lru_cache(maxsize=256)
def _geometry(b: int, h: int, w: int, c: int, half: int, sms: int) -> ctypes.Array:
    p = tail_plan(b, h, w, c, half, sms)
    return (ctypes.c_int * 15)(b, h, w, c, half, p.cp, p.hp, p.halo, p.seg, p.strips, p.band,
                               p.nbands, p.units, p.grid, p.stages)


def _launch(x, u, w_px, gate, pk: PackedTail) -> torch.Tensor:
    b, h, wd, c = x.shape
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    for name, t in (("x", x), ("u", u), ("w_px", w_px)):
        _lib.check_tensor(t, name, bf, dev, shape=tuple(x.shape), align=4)
    _lib.check_tensor(gate, "gate", f32, dev, shape=(b, c), align=4)
    _lib.check_tensor(pk.tiles, "tiles", bf, dev, ndim=1, align=16)
    _lib.check_tensor(pk.vec, "vec", f32, dev, shape=(vec_offsets(pk.cp, pk.hp)["total"],),
                      align=8)
    geo = _geometry(b, h, wd, c, pk.half, _lib.sm_count(dev.index))
    ws = torch.empty(geo[13] * 2 * ROWS * geo[5], dtype=f32, device=dev)  # grid x 2 rows of x2
    out = torch.empty_like(x)
    status = _lib.call(x, _lib.library().sr_dat_tail_bf16, x.data_ptr(), u.data_ptr(),
                       w_px.data_ptr(), gate.data_ptr(), out.data_ptr(), pk.tiles.data_ptr(),
                       pk.vec.data_ptr(), ws.data_ptr(), geo, LN_EPS, _lib.stream_of(x))
    _lib.check_status(status, "sr_dat_tail_bf16")
    launches.count += 1
    return out


def datb_tail(x: torch.Tensor, u: torch.Tensor, w_px: torch.Tensor, gate: torch.Tensor,
              w: TailWeights, packed: Optional[PackedTail] = None) -> torch.Tensor:
    """The DAT block output for the block input x, the AIM inputs u and
    w_px ([B, H, W, C]) and the sigmoided channel gate [B, C]: the plain
    version for CPU tensors, K10 for CUDA tensors (bf16 x, u, w_px, fp32
    gate; `packed` from ``pack_tail_weights``, built here if None).
    Inference only."""
    if x.device.type == "cpu":
        return datb_tail_plain(x, u, w_px, gate, w)
    if _lib.exporting():
        from tpu_superresolution_torch.kernels import custom_ops

        check_tail_args(tuple(x.shape), w)
        return custom_ops.datb_tail(x.contiguous(), u.contiguous(), w_px.contiguous(),
                                    gate.float().contiguous(), packed or pack_tail_weights(w))
    _lib.require_cuda(x, "datb_tail")
    check_tail_args(tuple(x.shape), w)
    return _launch(x.contiguous(), u.contiguous(), w_px.contiguous(),
                   gate.float().contiguous(), packed or pack_tail_weights(w))
