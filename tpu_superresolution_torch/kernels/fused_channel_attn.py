"""K14 — the front half of DAT's channel block (CUDA, ``csrc/dat_channel.cu``
with ``csrc/dat_common.cuh``).

Port of ``tpu_superresolution_tpu/ops/pallas/fused_channel_attn.py::
fused_channel_attention`` (its ``pallas_call`` at :209), which computes
dat_arch.py:441-509 up to the AIM gating:

    y, (q, k, v)   = LN1(x), y Wqkv + bqkv
    A_h            = softmax_e(t_h * G_h[d, e] / (|q_d| |k_e|))   per head h
                     with G_h = q_h^T k_h summed over ALL tokens of the
                     image and |.| the L2 norm over tokens (clamp 1e-12)
    attened_x[t, h*hd + d] = sum_e A_h[d, e] v[t, h*hd + e]
    conv_x         = erf-GELU(dwconv3x3(v) with the inference BatchNorm folded)

The contraction runs over all tokens of an image, so one call makes
three CUDA launches: (1) the product kernel K9 shares
(``csrc/dat_common.cuh``, persistent wgmma over 128-token tiles of each
image): LN1 and the qkv product, v written out, and each tile's partial
block-diagonal gram (six 32 x 32 head blocks, mma.sync) and squared
norms; (2) per image and head, the partials summed in tile order (no
atomics: the result does not depend on scheduling), the normalisation,
temperature and softmax, A rounded to bf16 as the JAX kernel casts it;
(3) per 8 x 16-pixel tile, the conv branch and out = v A^T (mma.sync, A
resident) from one staging of v.  v is kept from (1) rather than
recomputed: the conv branch needs it anyway, and re-reading it costs
one [T, C] bf16 pass where recomputing costs LN1 and a [T, 192] x
[192, 192] product.  The kernel takes C <= 192, at most 6 heads of hd
<= 32 and any image size, and raises otherwise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib
from tpu_superresolution_torch.kernels.fused_rect_attn import (
    PRODUCT_BK,
    PRODUCT_BM,
    PRODUCT_BN,
    PRODUCT_CHUNKS,
    dwconv_gelu_plain,
    pack_front_product,
)
from tpu_superresolution_torch.kernels.layernorm import layernorm_plain

LN_EPS = 1e-5
# Compile-time sizes of csrc/dat_channel.cu.
CP = 192           # padded channels: 6 heads x 32
HDP = 32           # padded head dim
MAX_HEADS = CP // HDP
# The product kernel's N tiles, as (part, group of three head slots): q
# and k of heads 0-2 (then the gram of those heads), of heads 3-5, then v.
N_TILE_ORDER = ((0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (2, 1))

launches = _lib.LaunchCounter("K14 channel_attention")


@dataclasses.dataclass(frozen=True)
class ChanAttnWeights:
    """One channel block's front: LN1, the qkv Linear ([3C, C], bias or
    None), the per-head temperature [nh, 1, 1], and the conv branch's
    depthwise kernel [3, 3, C] and bias [C] with BatchNorm folded."""

    g1: torch.Tensor
    b1: torch.Tensor
    wqkv: torch.Tensor
    bqkv: Optional[torch.Tensor]
    temperature: torch.Tensor
    wdw: torch.Tensor
    bdw: torch.Tensor
    num_heads: int

    @property
    def dim(self) -> int:
        return int(self.wqkv.shape[1])


def _gram_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    temperature: torch.Tensor) -> torch.Tensor:
    """XCiT channel attention on q, k, v [B, T, nh, hd] as K14 computes
    it: the gram, norms and softmax in fp32 on q's and k's values, A cast
    to v's dtype before out = v A^T.  Returns [B, T, nh, hd]."""
    qf, kf = q.float(), k.float()
    gram = torch.einsum("bthd,bthe->bhde", qf, kf)
    qn = qf.square().sum(1).sqrt().clamp_min(1e-12)   # [B, nh, hd]
    kn = kf.square().sum(1).sqrt().clamp_min(1e-12)
    nh = q.shape[2]
    sc = gram / (qn[..., :, None] * kn[..., None, :]) * temperature.float().reshape(nh, 1, 1)
    a = torch.softmax(sc, dim=-1).to(v.dtype)
    return torch.einsum("bhde,bthe->bthd", a, v)


def channel_front(x: torch.Tensor, w: ChanAttnWeights, *, ln1: Optional[Callable] = None,
                  conv_branch: Optional[Callable] = None,
                  attention: Callable = _gram_attention) -> Tuple[torch.Tensor, torch.Tensor]:
    """The front of a DAT channel block as one composition: (attened_x,
    conv_x) in x's dtype.  ``y = ln1(x, g1, b1)``, the qkv product in
    x's dtype, ``attention(q, k, v, temperature)`` on [B, T, nh, hd] and
    ``conv_branch(v)`` on v [B, H, W, C].  With its default steps it is
    K14's plain version; DAT's module chain (``models/dat.py``) passes K2,
    XCiT in the JAX package's "heads" form and its conv branch (K11,
    BatchNorm, GELU)."""
    b, h, wd, c = x.shape
    dt = x.dtype
    nh = w.num_heads
    hd = c // nh
    y = (ln1 or (lambda t, g, bb: layernorm_plain(t, g, bb, LN_EPS)))(x, w.g1, w.b1)
    qkv = F.linear(y, w.wqkv.to(dt), None if w.bqkv is None else w.bqkv.to(dt))
    q, k, v = qkv.reshape(b, h * wd, 3, nh, hd).unbind(2)
    out = attention(q, k, v, w.temperature).reshape(b, h, wd, c)
    v = v.reshape(b, h, wd, c)
    conv_x = conv_branch(v) if conv_branch else dwconv_gelu_plain(v, w.wdw, w.bdw)
    return out.contiguous(), conv_x


def channel_attention_plain(x: torch.Tensor,
                            w: ChanAttnWeights) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K14 (``channel_front`` with its
    default steps): (attened_x, conv_x) in x's dtype.  LN1 and qkv in x's
    dtype; the gram, norms and softmax in fp32 on q's and k's values; A
    cast to x's dtype before out = v A^T (the JAX kernel's casts)."""
    return channel_front(x, w)


@dataclasses.dataclass(frozen=True)
class PackedChan:
    """K14's operands: the product's weight tiles ``wp`` [6, 3, 96, 64]
    bf16 (``fused_rect_attn.pack_front_product``; N tiles in
    ``N_TILE_ORDER``, each three head slots x 32, zero-padded) and its
    fp32 bias [576], the temperature [nh], LN1 and the folded depthwise
    kernel [9, C]."""

    wp: torch.Tensor
    bqkv: torch.Tensor
    temperature: torch.Tensor
    g1: torch.Tensor
    b1: torch.Tensor
    wdw: torch.Tensor
    bdw: torch.Tensor
    dim: int
    num_heads: int


def chan_ok(c: int, num_heads: int) -> bool:
    """Whether K14 takes a channel block of C channels and `num_heads`
    heads (shapes only; every image size runs): even C <= 192 and <= 6
    heads of hd <= 32."""
    return not (c > CP or c % 2 or num_heads < 1 or c % num_heads or c // num_heads > HDP
                or num_heads > MAX_HEADS)


def check_chan_args(shape, w: ChanAttnWeights, name: str = "channel_attention") -> None:
    if len(shape) != 4 or shape[3] != w.dim:
        raise ValueError(f"{name}: x {tuple(shape)} is not [B, H, W, {w.dim}]")
    c, nh = w.dim, w.num_heads
    if not chan_ok(c, nh):
        raise ValueError(f"{name}: the kernel takes even C <= {CP} and <= {MAX_HEADS} heads of "
                         f"hd <= {HDP}; got C={c}, heads={nh}")


@torch.no_grad()
def pack_chan_weights(w: ChanAttnWeights, dtype: torch.dtype = torch.bfloat16) -> PackedChan:
    """Lay a channel block's front out for K14 (once per loaded weights;
    the weight stream in `dtype`, fp32 for the CPU tests' emulation)."""
    check_chan_args((1, 1, 1, w.dim), w)
    c, nh = w.dim, w.num_heads
    hd = c // nh
    bq = torch.zeros(3 * c, device=w.wqkv.device) if w.bqkv is None else w.bqkv.float()
    # [3 parts, 6 head slots, 32, in] -> [3, 2 groups, 3 slots, 32, in]
    wq = F.pad(w.wqkv.float().reshape(3, nh, hd, c), (0, 0, 0, HDP - hd, 0, MAX_HEADS - nh))
    bq = F.pad(bq.reshape(3, nh, hd), (0, HDP - hd, 0, MAX_HEADS - nh))
    wq = wq.reshape(3, 2, PRODUCT_BN, c)
    bq = bq.reshape(3, 2, PRODUCT_BN)
    wp, bp = pack_front_product(torch.stack([wq[p, g] for p, g in N_TILE_ORDER]),
                                torch.stack([bq[p, g] for p, g in N_TILE_ORDER]), dtype)
    return PackedChan(
        wp=wp, bqkv=bp, temperature=w.temperature.float().reshape(nh).contiguous(),
        g1=w.g1.float().contiguous(), b1=w.b1.float().contiguous(),
        wdw=w.wdw.float().reshape(9, c).contiguous(), bdw=w.bdw.float().contiguous(),
        dim=c, num_heads=nh)


def tiles_per_image(h: int, w: int) -> int:
    """The product kernel's 128-token tiles of one image (the partials a
    head's gram sums, in order)."""
    return -(-(h * w) // PRODUCT_BM)


@functools.lru_cache(maxsize=64)
def chan_geometry(b: int, h: int, w: int, c: int, nh: int, vec: int, sms: int) -> ctypes.Array:
    """The C entry's geometry array (``csrc/dat_channel.cu``)."""
    tpi = tiles_per_image(h, w)
    return (ctypes.c_int * 8)(b, h, w, c, nh, min(b * tpi, sms), tpi, vec)


def _launch(x: torch.Tensor, pk: PackedChan):
    b, h, wd, c = x.shape
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    vec = 4 if c % 4 == 0 and x.data_ptr() % 8 == 0 else 2
    _lib.check_tensor(x, "x", bf, dev, ndim=4, align=2 * vec)
    for name, t, shape, dtype, align in (
            ("wp", pk.wp, (6, PRODUCT_CHUNKS, PRODUCT_BN, PRODUCT_BK), bf, 16),
            ("bqkv", pk.bqkv, (6 * PRODUCT_BN,), f32, 4),
            ("temperature", pk.temperature, (pk.num_heads,), f32, 4),
            ("g1", pk.g1, (c,), f32, 4), ("b1", pk.b1, (c,), f32, 4),
            ("wdw", pk.wdw, (9, c), f32, 4), ("bdw", pk.bdw, (c,), f32, 4)):
        _lib.check_tensor(t, name, dtype, dev, shape=shape, align=align)
    tpi = tiles_per_image(h, wd)
    out = torch.empty_like(x)
    conv = torch.empty_like(x)
    v = torch.empty_like(x)
    part_gram = torch.empty(b * tpi * MAX_HEADS * HDP * HDP, dtype=f32, device=dev)
    part_sq = torch.empty(b * tpi * 2 * CP, dtype=f32, device=dev)
    attn = torch.empty(b * MAX_HEADS * HDP * HDP, dtype=f32, device=dev)
    status = _lib.call(
        x, _lib.library().sr_dat_channel_bf16, x.data_ptr(), out.data_ptr(), conv.data_ptr(),
        v.data_ptr(), pk.g1.data_ptr(), pk.b1.data_ptr(), pk.wp.data_ptr(), pk.bqkv.data_ptr(),
        pk.temperature.data_ptr(), pk.wdw.data_ptr(), pk.bdw.data_ptr(), part_gram.data_ptr(),
        part_sq.data_ptr(), attn.data_ptr(),
        chan_geometry(b, h, wd, c, pk.num_heads, vec, _lib.sm_count(dev.index)), LN_EPS,
        _lib.stream_of(x))
    _lib.check_status(status, "sr_dat_channel_bf16")
    launches.count += 1
    return out, conv


def channel_attention(x: torch.Tensor, w: ChanAttnWeights,
                      packed: Optional[PackedChan] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(attened_x, conv_x) of a channel block's front on x [B, H, W, C]:
    the plain version for a CPU tensor, K14 for a CUDA tensor (bf16;
    `packed` from ``pack_chan_weights``, built here if None).  One call
    counts one launch of K14 and makes three CUDA launches.  Inference
    only."""
    if x.device.type == "cpu":
        return channel_attention_plain(x, w)
    if _lib.exporting():
        from tpu_superresolution_torch.kernels import custom_ops

        check_chan_args(tuple(x.shape), w)
        return custom_ops.channel_attention(x.contiguous(), packed or pack_chan_weights(w))
    _lib.require_cuda(x, "channel_attention")
    check_chan_args(tuple(x.shape), w)
    return _launch(x.contiguous(), packed or pack_chan_weights(w))
