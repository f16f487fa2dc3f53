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
GELUs the exact erf, and the depthwise conv SAME zero padding.  One CUDA
block computes a 4 x 8 pixel tile: it recomputes the chain up to LN_sg
on the tile's one-pixel halo (6 x 10 pixels, 60 of 64 GEMM rows) from
neighbour reads of x, u and w_px, so nothing but the output leaves the
chip; pixels outside the image are the conv's zero padding.  One call
is one CUDA launch.  The kernel takes C <= 192, an SGFN half <= 192 and
C // 16 <= 16, any image size, and raises otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib
from tpu_superresolution_torch.kernels.dwconv import depthwise3x3
from tpu_superresolution_torch.kernels.layernorm import layernorm_plain

LN_EPS = 1e-5
BN_EPS = 1e-5
# Compile-time sizes of csrc/dat_tail.cu.
CP = 192     # padded channels (C and the SGFN half)
SPP = 16     # padded spatial-interaction width (C // 16)

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


@dataclasses.dataclass(frozen=True)
class PackedTail:
    """K10's operands: bf16 GEMM weights [out, in] zero-padded to the
    kernel's tiles (fc1's two halves at rows 0 and 192), fp32 biases,
    norms and the depthwise kernel [9, half]; `sp_w2` fp32 holding bf16
    values (the JAX kernel casts it)."""

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
    dim: int
    half: int


def tail_ok(c: int, half: int, width: int) -> bool:
    """Whether K10 takes a block tail of C channels, SGFN half `half` and
    spatial-map width `width` (C // 16) (shapes only; every image size
    runs): C <= 192, half <= 192, width <= 16."""
    return c <= CP and half <= CP and width <= SPP


def check_tail_args(shape, w: TailWeights, name: str = "datb_tail") -> None:
    if len(shape) != 4 or shape[3] != w.dim:
        raise ValueError(f"{name}: x {tuple(shape)} is not [B, H, W, {w.dim}]")
    c, half, m = w.dim, w.half, int(w.sp_w1.shape[0])
    if not tail_ok(c, half, m) or w.wfc1.shape[0] != 2 * half:
        raise ValueError(f"{name}: the kernel takes C <= {CP}, an SGFN half <= {CP} and a "
                         f"spatial map width <= {SPP}; got C={c}, half={half}, width={m}")


@torch.no_grad()
def pack_tail_weights(w: TailWeights) -> PackedTail:
    """Lay a block tail out for K10 (once per loaded weights)."""
    check_tail_args((1, 1, 1, w.dim), w)
    c, half, m = w.dim, w.half, int(w.sp_w1.shape[0])
    bf = torch.bfloat16
    pad2 = lambda t, rows, cols: F.pad(t.float(), (0, cols - t.shape[1], 0, rows - t.shape[0]))
    pad1 = lambda t, n: F.pad(t.float(), (0, n - t.shape[0]))
    wfc1 = torch.cat([pad2(w.wfc1[:half], CP, CP), pad2(w.wfc1[half:], CP, CP)])
    bfc1 = torch.cat([pad1(w.bfc1[:half], CP), pad1(w.bfc1[half:], CP)])
    return PackedTail(
        sp_w1=pad2(w.sp_w1, SPP, CP).to(bf).contiguous(), sp_b1=pad1(w.sp_b1, SPP).contiguous(),
        sp_w2=pad1(w.sp_w2.reshape(m).to(bf), SPP).contiguous(),
        sp_b2=w.sp_b2.float().reshape(1).contiguous(),
        wproj=pad2(w.wproj, CP, CP).to(bf).contiguous(), bproj=pad1(w.bproj, CP).contiguous(),
        g2=w.g2.float().contiguous(), b2=w.b2.float().contiguous(),
        wfc1=wfc1.to(bf).contiguous(), bfc1=bfc1.contiguous(),
        gsg=w.gsg.float().contiguous(), bsg=w.bsg.float().contiguous(),
        wdw=w.wdw.float().reshape(9, half).contiguous(), bdw=w.bdw.float().contiguous(),
        wfc2=pad2(w.wfc2, CP, CP).to(bf).contiguous(), bfc2=pad1(w.bfc2, CP).contiguous(),
        dim=c, half=half)


def _launch(x, u, w_px, gate, pk: PackedTail) -> torch.Tensor:
    b, h, wd, c = x.shape
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    half = pk.half
    for name, t in (("x", x), ("u", u), ("w_px", w_px)):
        _lib.check_tensor(t, name, bf, dev, shape=tuple(x.shape), align=4)
    _lib.check_tensor(gate, "gate", f32, dev, shape=(b, c), align=4)
    for name, t, shape, dtype, align in (
            ("sp_w1", pk.sp_w1, (SPP, CP), bf, 32), ("sp_b1", pk.sp_b1, (SPP,), f32, 16),
            ("sp_w2", pk.sp_w2, (SPP,), f32, 16), ("sp_b2", pk.sp_b2, (1,), f32, 4),
            ("wproj", pk.wproj, (CP, CP), bf, 32), ("bproj", pk.bproj, (CP,), f32, 16),
            ("g2", pk.g2, (c,), f32, 4), ("b2", pk.b2, (c,), f32, 4),
            ("wfc1", pk.wfc1, (2 * CP, CP), bf, 32), ("bfc1", pk.bfc1, (2 * CP,), f32, 16),
            ("gsg", pk.gsg, (half,), f32, 4), ("bsg", pk.bsg, (half,), f32, 4),
            ("wdw", pk.wdw, (9, half), f32, 4), ("bdw", pk.bdw, (half,), f32, 4),
            ("wfc2", pk.wfc2, (CP, CP), bf, 32), ("bfc2", pk.bfc2, (CP,), f32, 16)):
        _lib.check_tensor(t, name, dtype, dev, shape=shape, align=align)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        status = _lib.library().sr_dat_tail_bf16(
            x.data_ptr(), u.data_ptr(), w_px.data_ptr(), gate.data_ptr(), out.data_ptr(),
            pk.sp_w1.data_ptr(), pk.sp_b1.data_ptr(), pk.sp_w2.data_ptr(), pk.sp_b2.data_ptr(),
            pk.wproj.data_ptr(), pk.bproj.data_ptr(), pk.g2.data_ptr(), pk.b2.data_ptr(),
            pk.wfc1.data_ptr(), pk.bfc1.data_ptr(), pk.gsg.data_ptr(), pk.bsg.data_ptr(),
            pk.wdw.data_ptr(), pk.bdw.data_ptr(), pk.wfc2.data_ptr(), pk.bfc2.data_ptr(),
            b, h, wd, c, half, LN_EPS, _lib.stream_of(x))
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
    _lib.require_cuda(x, "datb_tail")
    check_tail_args(tuple(x.shape), w)
    return _launch(x.contiguous(), u.contiguous(), w_px.contiguous(),
                   gate.float().contiguous(), packed or pack_tail_weights(w))
