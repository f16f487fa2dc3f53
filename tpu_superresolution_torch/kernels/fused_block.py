"""K1 — the whole Swin transformer block at inference (CUDA,
``csrc/swin_block.cu``).

Port of ``tpu_superresolution_tpu/ops/pallas/fused_block.py``
(``fused_swin_block`` -> ``_mega_forward`` -> ``_kernel``), without the
training-only or TPU-only parts (``extra``, branch scales, sample fold,
roll-absorbing neighbour reads, the MXU row-sum column):

    x1  = x + proj(window_attention(LN1(x)))     (shifted windows)
    out = x1 + fc2(gelu(fc1(LN2(x1))))

The kernel runs one CTA per 8x8 window and applies the cyclic shift in
its address arithmetic, so ``fused_swin_block(x, ..., shift=s)`` equals
``cyclic_unshift(block(cyclic_shift(x, s)), s)``; the plain version
computes exactly that composition.  The kernel takes ws = 8 (N = 64),
C <= 192, heads of hd <= 32 (at most 6) and an MLP hidden <= 384, and
raises otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib
from tpu_superresolution_torch.kernels.layernorm import layernorm_plain
from tpu_superresolution_torch.ops.window import (
    cyclic_shift,
    cyclic_unshift,
    relative_position_bias,
    window_partition,
    window_reverse,
)

# Compile-time sizes of csrc/swin_block.cu.
WS = 8
CP = 192     # padded channels
HDP = 32     # padded head dim
HIDP = 384   # padded MLP hidden
MAX_HEADS = CP // HDP
LN_EPS = 1e-5

launches = _lib.LaunchCounter("K1 swin_block")


@dataclasses.dataclass(frozen=True)
class SwinBlockWeights:
    """One block's raw parameters in the reference torch layout
    (``nn.Linear`` weights are [out, in]; `table` is the
    [(2ws-1)^2, nH] relative-position bias table)."""

    g1: torch.Tensor
    b1: torch.Tensor
    wqkv: torch.Tensor
    bqkv: Optional[torch.Tensor]
    wproj: torch.Tensor
    bproj: torch.Tensor
    g2: torch.Tensor
    b2: torch.Tensor
    wfc1: torch.Tensor
    bfc1: torch.Tensor
    wfc2: torch.Tensor
    bfc2: torch.Tensor
    table: torch.Tensor
    num_heads: int

    @property
    def dim(self) -> int:
        return int(self.wqkv.shape[1])

    @property
    def scale(self) -> float:
        return (self.dim // self.num_heads) ** -0.5


@dataclasses.dataclass(frozen=True)
class PackedSwinBlock:
    """The kernel's operands: bf16 GEMM weights in the [out, in] layout,
    zero-padded to the kernel's tile sizes (q rows pre-scaled by
    hd^-0.5, head dims padded hd -> 32, channels C -> 192), fp32 biases
    and LayerNorm params, and the gathered [nH, 64, 64] relative-position
    bias."""

    wqkv: torch.Tensor   # [3*CP, CP] bf16
    bqkv: torch.Tensor   # [3*CP] fp32
    wproj: torch.Tensor  # [CP, CP] bf16
    bproj: torch.Tensor  # [CP] fp32
    wfc1: torch.Tensor   # [HIDP, CP] bf16
    bfc1: torch.Tensor   # [HIDP] fp32
    wfc2: torch.Tensor   # [CP, HIDP] bf16
    bfc2: torch.Tensor   # [CP] fp32
    g1: torch.Tensor
    b1: torch.Tensor
    g2: torch.Tensor
    b2: torch.Tensor
    rpb: torch.Tensor    # [nH, 64, 64] fp32
    dim: int
    num_heads: int


def check_kernel_limits(w: SwinBlockWeights) -> None:
    c, nh, hidden = w.dim, w.num_heads, int(w.wfc1.shape[0])
    if c > CP or c % nh or c // nh > HDP or nh > MAX_HEADS or hidden > HIDP:
        raise ValueError(
            f"swin_block kernel takes C <= {CP}, hd <= {HDP}, heads <= "
            f"{MAX_HEADS}, hidden <= {HIDP}; got C={c}, heads={nh}, hidden={hidden}"
        )
    if w.table.shape[0] != (2 * WS - 1) ** 2:
        raise ValueError(f"swin_block kernel takes window size {WS} only")


def pack_block_weights(w: SwinBlockWeights) -> PackedSwinBlock:
    """Lay one block's weights out for the kernel (the counterpart of
    the JAX package's ``_prep_weights``).  Built once per loaded
    weights by the caller, not per forward."""
    check_kernel_limits(w)
    c, nh = w.dim, w.num_heads
    hd, hidden = c // nh, int(w.wfc1.shape[0])
    dev = w.wqkv.device
    z = dict(dtype=torch.float32, device=dev)
    bf = torch.bfloat16
    with torch.no_grad():
        # [out, in] layouts (nn.Linear's), zero-padded; heads padded hd -> 32
        wq = w.wqkv.float().reshape(3, nh, hd, c).clone()
        wq[0] *= w.scale
        wqkv = torch.zeros(3, MAX_HEADS, HDP, CP, **z)
        wqkv[:, :nh, :hd, :c] = wq
        bqkv = torch.zeros(3, MAX_HEADS, HDP, **z)
        if w.bqkv is not None:
            bq = w.bqkv.float().reshape(3, nh, hd).clone()
            bq[0] *= w.scale
            bqkv[:, :nh, :hd] = bq
        wproj = torch.zeros(CP, MAX_HEADS, HDP, **z)
        wproj[:c, :nh, :hd] = w.wproj.float().reshape(c, nh, hd)
        bproj = torch.zeros(CP, **z)
        bproj[:c] = w.bproj.float()
        wfc1 = torch.zeros(HIDP, CP, **z)
        wfc1[:hidden, :c] = w.wfc1.float()
        bfc1 = torch.zeros(HIDP, **z)
        bfc1[:hidden] = w.bfc1.float()
        wfc2 = torch.zeros(CP, HIDP, **z)
        wfc2[:c, :hidden] = w.wfc2.float()
        bfc2 = torch.zeros(CP, **z)
        bfc2[:c] = w.bfc2.float()
        return PackedSwinBlock(
            wqkv=wqkv.reshape(3 * CP, CP).to(bf).contiguous(),
            bqkv=bqkv.reshape(-1).contiguous(),
            wproj=wproj.reshape(CP, CP).to(bf).contiguous(),
            bproj=bproj,
            wfc1=wfc1.to(bf).contiguous(),
            bfc1=bfc1,
            wfc2=wfc2.to(bf).contiguous(),
            bfc2=bfc2,
            g1=w.g1.float().contiguous(),
            b1=w.b1.float().contiguous(),
            g2=w.g2.float().contiguous(),
            b2=w.b2.float().contiguous(),
            rpb=relative_position_bias(w.table, WS),
            dim=c,
            num_heads=nh,
        )


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def window_attention_plain(xw, wqkv, bqkv, wproj, bproj, rpb, mask, scale):
    """Plain windowed attention on [B*nW, N, C] windows (port of the
    JAX package's ``fused_attention._reference_impl``): qkv and proj
    in x's dtype, scores and softmax in fp32.  rpb: [nH, N, N];
    mask: [nW, N, N] or None (window w uses mask[w % nW])."""
    bw, n, c = xw.shape
    nh = rpb.shape[0]
    hd = c // nh
    dt = xw.dtype
    qkv = F.linear(xw, wqkv.to(dt), None if bqkv is None else bqkv.to(dt))
    qkv = qkv.reshape(bw, n, 3, nh, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    attn = torch.einsum("wqhd,wkhd->whqk", q.float() * scale, k.float())
    attn = attn + rpb.float()[None]
    if mask is not None:
        nwm = mask.shape[0]
        attn = attn.reshape(bw // nwm, nwm, nh, n, n) + mask.float()[None, :, None]
        attn = attn.reshape(bw, nh, n, n)
    attn = torch.softmax(attn, dim=-1).to(dt)
    out = torch.einsum("whqk,wkhd->wqhd", attn, v.to(dt)).reshape(bw, n, c)
    return F.linear(out, wproj.to(dt), bproj.to(dt))


def swin_block_plain(x: torch.Tensor, w: SwinBlockWeights, ws: int, shift: int,
                     mask: Optional[torch.Tensor], gelu_approx: bool) -> torch.Tensor:
    """The plain PyTorch version (port of ``fused_block._reference_block``
    with the cyclic shift around it): residual stream in fp32, LayerNorm
    and GEMM operands in x's dtype."""
    dt = x.dtype
    xs = cyclic_shift(x, shift)
    b, h, wd, c = xs.shape
    xf = xs.float()
    y = layernorm_plain(xf, w.g1, w.b1, LN_EPS).to(dt)
    attn = window_attention_plain(
        window_partition(y, ws), w.wqkv, w.bqkv, w.wproj, w.bproj,
        relative_position_bias(w.table, ws), mask, w.scale,
    )
    x1 = xf + window_reverse(attn, ws, h, wd).float()
    y2 = layernorm_plain(x1, w.g2, w.b2, LN_EPS).to(dt)
    h1 = F.linear(y2, w.wfc1.to(dt), w.bfc1.to(dt))
    h1 = gelu(h1.float(), gelu_approx).to(dt)
    mlp = F.linear(h1, w.wfc2.to(dt), w.bfc2.to(dt))
    out = (x1 + mlp.float()).to(dt)
    return cyclic_unshift(out, shift)


def fused_swin_block(x: torch.Tensor, w: SwinBlockWeights, ws: int, shift: int,
                     mask: Optional[torch.Tensor], gelu_approx: bool,
                     packed: Optional[PackedSwinBlock] = None) -> torch.Tensor:
    """One Swin block on x [B, H, W, C] with cyclic shift `shift` and the
    shift mask [nW, N, N] built on (H, W).  CPU tensor -> plain version;
    CUDA tensor -> the kernel (bf16 x; `packed` from
    ``pack_block_weights``, packed here when not given)."""
    if x.device.type == "cpu":
        return swin_block_plain(x, w, ws, shift, mask, gelu_approx)
    _lib.require_cuda(x, "fused_swin_block")
    if ws != WS:
        raise ValueError(f"fused_swin_block: the kernel takes ws={WS}, got {ws}")
    _lib.check_tensor(x, "x", torch.bfloat16, x.device, ndim=4, align=2)
    b, h, wd, c = x.shape
    if h % WS or wd % WS:
        raise ValueError(f"fused_swin_block: H, W = {h}, {wd} are not multiples of {WS}")
    if not 0 <= shift < WS:
        raise ValueError(f"fused_swin_block: shift {shift} outside [0, {WS})")
    if packed is None:
        packed = pack_block_weights(w)
    if packed.dim != c:
        raise ValueError(f"fused_swin_block: weights for C={packed.dim}, x has C={c}")
    nh = packed.num_heads
    dev = x.device
    # WMMA reads the bf16 weight tiles straight from global memory (32-byte
    # aligned rows); biases and rpb are read as float4, LayerNorm params
    # as scalars.
    bf, f32 = torch.bfloat16, torch.float32
    for name, t, shape, dtype, align in (
        ("wqkv", packed.wqkv, (3 * CP, CP), bf, 32),
        ("bqkv", packed.bqkv, (3 * CP,), f32, 16),
        ("wproj", packed.wproj, (CP, CP), bf, 32),
        ("bproj", packed.bproj, (CP,), f32, 16),
        ("wfc1", packed.wfc1, (HIDP, CP), bf, 32),
        ("bfc1", packed.bfc1, (HIDP,), f32, 16),
        ("wfc2", packed.wfc2, (CP, HIDP), bf, 32),
        ("bfc2", packed.bfc2, (CP,), f32, 16),
        ("g1", packed.g1, (c,), f32, 4),
        ("b1", packed.b1, (c,), f32, 4),
        ("g2", packed.g2, (c,), f32, 4),
        ("b2", packed.b2, (c,), f32, 4),
        ("rpb", packed.rpb, (nh, WS * WS, WS * WS), f32, 16),
    ):
        _lib.check_tensor(t, name, dtype, dev, shape=shape, align=align)
    n_windows = (h // WS) * (wd // WS)
    if mask is not None:
        _lib.check_tensor(mask, "mask", torch.float32, dev,
                          shape=(n_windows, WS * WS, WS * WS), align=16)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = _lib.library().sr_swin_block_bf16(
            x.data_ptr(), y.data_ptr(),
            packed.g1.data_ptr(), packed.b1.data_ptr(),
            packed.g2.data_ptr(), packed.b2.data_ptr(),
            packed.wqkv.data_ptr(), packed.bqkv.data_ptr(),
            packed.wproj.data_ptr(), packed.bproj.data_ptr(),
            packed.wfc1.data_ptr(), packed.bfc1.data_ptr(),
            packed.wfc2.data_ptr(), packed.bfc2.data_ptr(),
            packed.rpb.data_ptr(), None if mask is None else mask.data_ptr(),
            b, h, wd, c, nh, shift, int(bool(gelu_approx)), LN_EPS,
            _lib.stream_of(x),
        )
    _lib.check_status(status, "sr_swin_block_bf16")
    launches.count += 1
    return y
