"""K9 — the front half of DAT's spatial block (CUDA, ``csrc/dat_rect.cu``).

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

The kernel reads each window's tokens from the spatial map, with the
shift and the zero padding in its address arithmetic, and writes the
outputs at their true coordinates: the JAX package's pre-rolled inputs,
roll-backs and shape gates have no counterpart, and every image size
runs.  One call makes two CUDA launches: the attention kernel (one
block per window and branch, which also writes its half of v) and the
depthwise conv + GELU over v.  It takes C <= 192 (even), s0 * s1 = 128
tokens per window and at most 3 heads per branch of hd <= 32, and
raises otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib
from tpu_superresolution_torch.kernels.dwconv import depthwise3x3
from tpu_superresolution_torch.kernels.layernorm import layernorm_plain
from tpu_superresolution_torch.ops.window import (
    rect_mask_tensor,
    rect_window_partition,
    rect_window_reverse,
)

LN_EPS = 1e-5
# Compile-time sizes of csrc/dat_rect.cu.
CP = 192          # padded channels
HDP = 32          # padded head dim
NHB_MAX = 3       # heads per branch
N_TOK = 128       # tokens per window (s0 * s1)

launches = _lib.LaunchCounter("K9 rect_attention")


@dataclasses.dataclass(frozen=True)
class RectAttnWeights:
    """One spatial block's front: LN1 (`g1`, `b1`), the qkv Linear
    ([3C, C], bias [3C] or None), the conv branch's depthwise kernel
    [3, 3, C] and bias [C] with the inference BatchNorm folded in, the
    two branches' dynamic position biases [nh/2, N, N] (branch 0 for
    s0 x s1 windows, branch 1 for s1 x s0), the head count and the
    split (s0, s1)."""

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

    @property
    def dim(self) -> int:
        return int(self.wqkv.shape[1])


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


@dataclasses.dataclass(frozen=True)
class PackedRect:
    """K9's operands: per branch the [288, 192] bf16 qkv weight ([out,
    in]; parts q, k, v of 3 heads x 32, q pre-scaled, zero-padded) and
    its fp32 bias, the two bias tables [2, nh/2, N, N], LN1, and the
    folded depthwise kernel [9, C] and bias."""

    wqkv: torch.Tensor
    bqkv: torch.Tensor
    bias: torch.Tensor
    g1: torch.Tensor
    b1: torch.Tensor
    wdw: torch.Tensor
    bdw: torch.Tensor
    dim: int
    num_heads: int
    split: Tuple[int, int]


def rect_ok(c: int, num_heads: int, split: Sequence[int]) -> bool:
    """Whether K9 takes a spatial block of C channels, `num_heads` heads
    and `split` (shapes only; every image size runs): even C <= 192, an
    even head count with <= 3 heads per branch of hd <= 32, and s0 * s1 =
    128 tokens a window."""
    s0, s1 = split
    nhb = num_heads // 2
    return not (c > CP or c % 2 or num_heads % 2 or not 0 < nhb <= NHB_MAX or (c // 2) % nhb
                or (c // 2) // nhb > HDP or s0 * s1 != N_TOK)


def check_rect_args(shape, w: RectAttnWeights, name: str = "rect_attention") -> None:
    """Raise unless an x of `shape` and the weights fit the kernel."""
    if len(shape) != 4 or shape[3] != w.dim:
        raise ValueError(f"{name}: x {tuple(shape)} is not [B, H, W, {w.dim}]")
    c, nh = w.dim, w.num_heads
    if not rect_ok(c, nh, w.split):
        raise ValueError(
            f"{name}: the kernel takes even C <= {CP}, an even head count with <= {NHB_MAX} "
            f"heads per branch of hd <= {HDP} and s0 * s1 = {N_TOK}; got C={c}, heads={nh}, "
            f"split={w.split}")


@torch.no_grad()
def pack_rect_weights(w: RectAttnWeights) -> PackedRect:
    """Lay a spatial block's front out for K9 (the counterpart of the
    JAX package's ``_prep_branch_weights``); built once per loaded
    weights at inference."""
    check_rect_args((1, 1, 1, w.dim), w)
    c, nhb = w.dim, w.num_heads // 2
    hd = c // 2 // nhb
    wq, bq = scaled_qkv(w.wqkv, w.bqkv, hd ** -0.5)
    if bq is None:
        bq = torch.zeros(3 * c, device=wq.device)
    # [3 parts, 2 branches, heads, hd, in] -> [2, 3 * 3 * 32, 192]
    wq = F.pad(wq.reshape(3, 2, nhb, hd, c), (0, CP - c, 0, HDP - hd, 0, NHB_MAX - nhb))
    bq = F.pad(bq.reshape(3, 2, nhb, hd), (0, HDP - hd, 0, NHB_MAX - nhb))
    return PackedRect(
        wqkv=wq.transpose(0, 1).reshape(2, 3 * NHB_MAX * HDP, CP).to(torch.bfloat16).contiguous(),
        bqkv=bq.transpose(0, 1).reshape(2, 3 * NHB_MAX * HDP).contiguous(),
        bias=torch.stack([w.bias0.float(), w.bias1.float()]).contiguous(),
        g1=w.g1.float().contiguous(), b1=w.b1.float().contiguous(),
        wdw=w.wdw.float().reshape(9, c).contiguous(), bdw=w.bdw.float().contiguous(),
        dim=c, num_heads=w.num_heads, split=tuple(w.split))


def _launch(x: torch.Tensor, pk: PackedRect, shifted: bool):
    b, h, wd, c = x.shape
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    nhb = pk.num_heads // 2
    _lib.check_tensor(x, "x", bf, dev, ndim=4, align=4)
    for name, t, shape, dtype, align in (
            ("wqkv", pk.wqkv, (2, 3 * NHB_MAX * HDP, CP), bf, 32),
            ("bqkv", pk.bqkv, (2, 3 * NHB_MAX * HDP), f32, 16),
            ("bias", pk.bias, (2, nhb, N_TOK, N_TOK), f32, 16),
            ("g1", pk.g1, (c,), f32, 4), ("b1", pk.b1, (c,), f32, 4),
            ("wdw", pk.wdw, (9, c), f32, 4), ("bdw", pk.bdw, (c,), f32, 4)):
        _lib.check_tensor(t, name, dtype, dev, shape=shape, align=align)
    out = torch.empty_like(x)
    conv = torch.empty_like(x)
    v = torch.empty_like(x)  # v at true coordinates, for the conv branch
    s0, s1 = pk.split
    with torch.cuda.device(dev):
        status = _lib.library().sr_dat_rect_bf16(
            x.data_ptr(), out.data_ptr(), v.data_ptr(), conv.data_ptr(),
            pk.g1.data_ptr(), pk.b1.data_ptr(), pk.wqkv.data_ptr(), pk.bqkv.data_ptr(),
            pk.bias.data_ptr(), pk.wdw.data_ptr(), pk.bdw.data_ptr(),
            b, h, wd, c, nhb, c // 2 // nhb, s0, s1, int(bool(shifted)), LN_EPS,
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
    _lib.require_cuda(x, "rect_attention")
    check_rect_args(tuple(x.shape), w)
    return _launch(x.contiguous(), packed or pack_rect_weights(w), shifted)
