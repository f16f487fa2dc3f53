"""K7 — fused window attention: the qkv product, the biased and masked
window softmax attention and the output projection (CUDA,
``csrc/window_attn.cu``).

Port of ``tpu_superresolution_tpu/ops/pallas/fused_attention.py``
(``fused_window_block_attention``, ``pl.pallas_call`` in
``_fused_forward``).  On windowed features xw [BW, N, C]:

    qkv = xw Wqkv^T + bqkv            (q rows pre-scaled by hd^-0.5)
    S_h = q_h k_h^T + rpb[h] + mask[w % nW]     (fp32 softmax)
    out = concat_h(softmax(S_h) v_h) Wproj^T + bproj

Weights are in the reference torch layout (``nn.Linear``'s [out, in]);
`bqkv` None means zeros.  The TPU kernel's window packing (P windows on
one [P*N, P*N] tile with -1e9 off the diagonal) and its token padding to
a multiple of 8 have no counterpart here: the CUDA kernel tiles queries
and keys in 64-row tiles with an online softmax, so it takes any N (36,
49, 64, 144, 256, up to 1024 and beyond), C <= 256, at most 8 heads of
hd <= 32.  Its first launch, the qkv product, also runs alone
(``window_product``, counted as a K7 call) as the qkv and proj products
of the Swin blocks past those widths (the "wide" route,
``fused_block.wide_window_attention``: C <= 512, any output width),
whose attention is K15.

On a CPU tensor the wrapper runs ``window_attention_plain``; on a CUDA
tensor it launches K7 (bf16 xw, fp32 bias and mask), through
``WindowAttentionFunction`` when a gradient is wanted, whose backward is
torch autograd of the plain version, as the JAX package's custom_vjp
differentiates ``_reference_impl`` (``fused_attention.py:307-311``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib

# Limits of csrc/window_attn.cu.
MAX_C = 256
MAX_HEADS = 8
HDP = 32      # padded head dim
Q_TILE = 64   # query and key rows per tile

launches = _lib.LaunchCounter("K7 window_attention")


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


def attention_fits(c: int, nh: int) -> bool:
    """Whether a width of C channels in `nh` heads fits K7 (shapes only,
    so it runs on any device)."""
    return c <= MAX_C and nh <= MAX_HEADS and c % nh == 0 and c // nh <= HDP


def check_attention_limits(c: int, nh: int, name: str = "fused_window_attention") -> None:
    """Raise unless ``attention_fits(c, nh)``."""
    if not attention_fits(c, nh):
        raise ValueError(f"{name}: K7 takes C <= {MAX_C}, heads <= {MAX_HEADS}, hd <= {HDP}; "
                         f"got C={c}, heads={nh} (ROADMAP Queue 3)")


@dataclasses.dataclass(frozen=True)
class PackedWindowAttention:
    """K7's weight operands: bf16 [out, in] GEMM weights with each head's
    dims zero-padded hd -> 32 (q rows pre-scaled by hd^-0.5), input
    channels padded to CK = a multiple of 16, proj rows padded to CO;
    fp32 biases; the gathered [nH, N, N] fp32 bias."""

    wqkv: torch.Tensor   # [3 * nh * 32, CK] bf16
    bqkv: torch.Tensor   # [3 * nh * 32] fp32
    wproj: torch.Tensor  # [CO, nh * 32] bf16
    bproj: torch.Tensor  # [CO] fp32
    rpb: torch.Tensor    # [nh, N, N] fp32
    dim: int
    num_heads: int


def _round16(v: int) -> int:
    return -(-v // 16) * 16


@torch.no_grad()
def pack_window_attention(wqkv, bqkv, wproj, bproj, rpb) -> PackedWindowAttention:
    """Lay the raw weights out for K7 (the counterpart of the JAX
    package's ``_prep_weights``): once per loaded weights at inference,
    on every call in training."""
    nh = int(rpb.shape[0])
    c = int(wqkv.shape[1])
    check_attention_limits(c, nh)
    hd, ck, co = c // nh, _round16(c), _round16(c)
    scale = hd ** -0.5
    dev = wqkv.device
    w = wqkv.float().reshape(3, nh, hd, c).clone()
    w[0] *= scale
    b = (torch.zeros(3, nh, hd, device=dev) if bqkv is None
         else bqkv.float().reshape(3, nh, hd).clone())
    b[0] *= scale
    wp = F.pad(wproj.float().reshape(c, nh, hd), (0, HDP - hd, 0, 0, 0, co - c))
    return PackedWindowAttention(
        wqkv=F.pad(w, (0, ck - c, 0, HDP - hd)).reshape(3 * nh * HDP, ck)
        .to(torch.bfloat16).contiguous(),
        bqkv=F.pad(b, (0, HDP - hd)).reshape(-1).contiguous(),
        wproj=wp.reshape(co, nh * HDP).to(torch.bfloat16).contiguous(),
        bproj=F.pad(bproj.float(), (0, co - c)).contiguous(),
        rpb=rpb.float().contiguous(),
        dim=c,
        num_heads=nh,
    )


def _launch(xw: torch.Tensor, packed: PackedWindowAttention,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The two CUDA launches of one K7 call (the qkv product into a
    workspace, then attention + proj per 64-query tile), counted once."""
    _lib.check_tensor(xw, "xw", torch.bfloat16, xw.device, ndim=3, align=2)
    bw, n, c = xw.shape
    nh = packed.num_heads
    if c != packed.dim:
        raise ValueError(f"fused_window_attention: weights for C={packed.dim}, xw has C={c}")
    dev = xw.device
    a, ck, co = nh * HDP, _round16(c), _round16(c)
    bf, f32 = torch.bfloat16, torch.float32
    for name, t, shape, dtype, align in (
            ("wqkv", packed.wqkv, (3 * a, ck), bf, 32), ("bqkv", packed.bqkv, (3 * a,), f32, 16),
            ("wproj", packed.wproj, (co, a), bf, 32), ("bproj", packed.bproj, (co,), f32, 4),
            ("rpb", packed.rpb, (nh, n, n), f32, 4)):
        _lib.check_tensor(t, name, dtype, dev, shape=shape, align=align)
    n_mask = 0
    if mask is not None:
        n_mask = int(mask.shape[0])
        _lib.check_tensor(mask, "mask", f32, dev, shape=(n_mask, n, n), align=4)
        if n_mask == 0 or bw % n_mask:
            raise ValueError(f"fused_window_attention: {bw} windows are not a whole number of "
                             f"mask periods of {n_mask}")
    out = torch.empty_like(xw)
    qkv = torch.empty(bw * n, 3 * a, dtype=bf, device=dev)
    with torch.cuda.device(dev):
        status = _lib.library().sr_window_attention_bf16(
            xw.data_ptr(), packed.wqkv.data_ptr(), packed.bqkv.data_ptr(),
            packed.wproj.data_ptr(), packed.bproj.data_ptr(), packed.rpb.data_ptr(),
            None if mask is None else mask.data_ptr(), qkv.data_ptr(), out.data_ptr(),
            bw, n, c, nh, n_mask, _lib.stream_of(xw))
    _lib.check_status(status, "sr_window_attention_bf16")
    launches.count += 1
    return out


def qkv_product(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor) -> torch.Tensor:
    """K7's first launch alone (CUDA tensors only): x [rows, CK] bf16
    (CK a multiple of 16, the pad columns zero) times packed [n3, CK]
    bf16 weights plus fp32 bias -> [rows, n3] bf16.  The ws-16 block
    backward's qkv recompute; counted as a K7 call."""
    _lib.require_cuda(x, "qkv_product")
    rows, ck = x.shape
    n3 = int(wqkv.shape[0])
    if ck % 16:
        raise ValueError(f"qkv_product: x's {ck} columns are not packed to a multiple of 16")
    _lib.check_tensor(x, "x", torch.bfloat16, x.device, ndim=2, align=16)
    _lib.check_tensor(wqkv, "wqkv", torch.bfloat16, x.device, shape=(n3, ck), align=32)
    _lib.check_tensor(bqkv, "bqkv", torch.float32, x.device, shape=(n3,), align=16)
    out = torch.empty(rows, n3, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        status = _lib.library().sr_window_product_bf16(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), out.data_ptr(), rows, ck, n3, n3,
            _lib.stream_of(x))
    _lib.check_status(status, "sr_window_product_bf16")
    launches.count += 1
    return out


# K7's first launch as a product of its own: the "wide" route's qkv and
# proj (fused_block.wide_window_attention), input widths up to 512.
MAX_PRODUCT_C = 512


@dataclasses.dataclass(frozen=True)
class PackedProduct:
    """The product launch's operands: the bf16 [out, in] weight
    zero-padded to [N3, CK] (multiples of 16) and the fp32 bias [N3]."""

    w: torch.Tensor  # [N3, CK] bf16
    b: torch.Tensor  # [N3] fp32
    c_in: int
    c_out: int


@torch.no_grad()
def pack_window_product(weight: torch.Tensor, bias: Optional[torch.Tensor],
                        dtype: torch.dtype = torch.bfloat16) -> PackedProduct:
    """Lay an ``nn.Linear`` weight [out, in] and bias (None: zeros) out
    for the product launch (the weight in `dtype`: the kernel's bf16, or
    fp32 for the CPU tests' emulation): once per loaded weights at
    inference, on every call in training."""
    c_out, c_in = int(weight.shape[0]), int(weight.shape[1])
    if c_in > MAX_PRODUCT_C:
        raise ValueError(f"window_product: K7's product takes C <= {MAX_PRODUCT_C} input "
                         f"channels, got {c_in} (ROADMAP Queue 3)")
    n3, ck = _round16(c_out), _round16(c_in)
    b = torch.zeros(c_out, device=weight.device) if bias is None else bias.float()
    return PackedProduct(
        w=F.pad(weight.float(), (0, ck - c_in, 0, n3 - c_out)).to(dtype).contiguous(),
        b=F.pad(b, (0, n3 - c_out)).contiguous(), c_in=c_in, c_out=c_out)


def window_product_plain(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain version of the product launch: ``F.linear`` in x's
    dtype (what ``window_attention_plain`` computes for qkv and proj)."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def _launch_product(x: torch.Tensor, packed: PackedProduct) -> torch.Tensor:
    """One launch of K7's product kernel on x [rows, C_in] bf16, counted
    as a K7 call."""
    rows, c = x.shape
    if c != packed.c_in:
        raise ValueError(f"window_product: weights for C={packed.c_in}, x has C={c}")
    n3 = int(packed.w.shape[0])
    _lib.check_tensor(x, "x", torch.bfloat16, x.device, ndim=2, align=2)
    _lib.check_tensor(packed.w, "w", torch.bfloat16, x.device, shape=(n3, _round16(c)),
                      align=32)
    _lib.check_tensor(packed.b, "b", torch.float32, x.device, shape=(n3,), align=16)
    out = torch.empty(rows, packed.c_out, dtype=torch.bfloat16, device=x.device)
    status = _lib.call(x, _lib.library().sr_window_product_bf16, x.data_ptr(),
                       packed.w.data_ptr(), packed.b.data_ptr(), out.data_ptr(), rows, c, n3,
                       packed.c_out, _lib.stream_of(x))
    _lib.check_status(status, "sr_window_product_bf16")
    launches.count += 1
    return out


class WindowProductFunction(torch.autograd.Function):
    """Forward K7's product launch (weights packed on every call),
    backward autograd of ``window_product_plain``."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight, bias)
        return _launch_product(x, pack_window_product(weight, bias))

    @staticmethod
    def backward(ctx, grad_out):
        return _lib.plain_vjp(window_product_plain, ctx.saved_tensors, ctx.needs_input_grad,
                              grad_out)


def window_product(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                   packed: Optional[PackedProduct] = None) -> torch.Tensor:
    """x [rows, C_in] times an ``nn.Linear`` weight [C_out, C_in] plus
    bias, in K7's first launch (C_in <= 512, any C_out; fp32 sums, one
    rounding): the plain version for CPU tensors, the kernel for CUDA
    tensors, through ``WindowProductFunction`` when a gradient is wanted.
    `packed` (inference only: ``pack_window_product``) skips the
    per-call packing."""
    if x.device.type == "cpu":
        return window_product_plain(x, weight, bias)
    _lib.require_cuda(x, "window_product")
    x = x.contiguous()
    inputs = [x, weight] + ([] if bias is None else [bias])
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return WindowProductFunction.apply(x, weight, bias)
    return _launch_product(x, packed or pack_window_product(weight, bias))


class WindowAttentionFunction(torch.autograd.Function):
    """Forward K7 (weights packed on every call), backward autograd of
    ``window_attention_plain``."""

    @staticmethod
    def forward(ctx, xw, wqkv, bqkv, wproj, bproj, rpb, mask, scale):
        ctx.save_for_backward(xw, wqkv, bqkv, wproj, bproj, rpb, mask)
        ctx.scale = scale
        return _launch(xw, pack_window_attention(wqkv, bqkv, wproj, bproj, rpb), mask)

    @staticmethod
    def backward(ctx, grad_out):
        xw, wqkv, bqkv, wproj, bproj, rpb, mask = ctx.saved_tensors
        return _lib.plain_vjp(window_attention_plain,
                              (xw, wqkv, bqkv, wproj, bproj, rpb, mask, ctx.scale),
                              ctx.needs_input_grad, grad_out)


def fused_window_attention(xw: torch.Tensor, wqkv: torch.Tensor, bqkv: Optional[torch.Tensor],
                           wproj: torch.Tensor, bproj: torch.Tensor,
                           rpb: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                           packed: Optional[PackedWindowAttention] = None) -> torch.Tensor:
    """K7 on xw [BW, N, C] with the gathered bias rpb [nH, N, N] and the
    shift mask [nW, N, N] or None (window w uses mask[w % nW]); the
    scale is hd^-0.5.  CPU tensor -> plain version; CUDA tensor -> the
    kernel, through ``WindowAttentionFunction`` when a gradient is
    wanted.  `packed` (inference only) skips the per-call packing and
    holds the bias: rpb may then be None."""
    if rpb is None:
        rpb = packed.rpb
    c, nh = int(xw.shape[-1]), int(rpb.shape[0])
    scale = (c // nh) ** -0.5
    if xw.device.type == "cpu":
        return window_attention_plain(xw, wqkv, bqkv, wproj, bproj, rpb, mask, scale)
    _lib.require_cuda(xw, "fused_window_attention")
    check_attention_limits(c, nh)
    xw = xw.contiguous()
    inputs = [xw, wqkv, wproj, bproj, rpb] + ([] if bqkv is None else [bqkv])
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return WindowAttentionFunction.apply(xw, wqkv, bqkv, wproj, bproj, rpb, mask, scale)
    if packed is None:
        packed = pack_window_attention(wqkv, bqkv, wproj, bproj, rpb)
    return _launch(xw, packed, mask)
