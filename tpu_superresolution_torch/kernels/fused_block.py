"""The whole Swin transformer block forward (CUDA,
``csrc/swin_block.cu``) for window size 8 (K1) and 7 (K6), and its
backward (CUDA, ``csrc/swin_block_bwd.cu``) for window size 8 (K5) and
7 (K6's backward), both with HAT's additive term `extra`.

The forward kernel computes, per window, with the cyclic shift in its
address arithmetic:

    x1  = x + m1 * proj(window_attention(LN1(x))) + extra
    out = x1 + m2 * fc2(gelu(fc1(LN2(x1))))

where (m1, m2) are the per-sample stochastic-depth branch scales
(``branch_scales`` [B, 2] fp32; None means 1, and the kernel then does
exactly its inference arithmetic) and `extra` (None, or [B, H, W, C] in
x's frame) is HAT's ``conv_scale * CAB`` branch, unscaled.  It ports
three Pallas kernels of ``tpu_superresolution_tpu/ops/pallas/
fused_block.py`` that compute this function: ``fused_swin_block``
(strip mode, K1), ``fused_packed_windows_block`` (K6: windows
partitioned and token-padded by the caller) and
``fused_spatial_windows_block`` (K13: window rows read from the spatial
map).  The CUDA kernel reads windows from the spatial map, so one
instantiation per window size serves all three; the TPU-only parts
(sample fold, roll-absorbing neighbour reads, the MXU row-sum column)
have no counterpart.  ``fused_windows_block(x, ..., shift=s)`` equals
``cyclic_unshift(block(cyclic_shift(x, s)), s)``; the plain version
computes exactly that composition.  The kernels take ws 7 or 8, C <=
192, heads of hd <= 32 (at most 6), an MLP hidden <= 384 and
qkv_bias=True, and raise otherwise.

Which blocks take the kernel is decided by ``block_route`` from static
shapes alone, the same on every call and device: ws 7 or 8 within those
widths -> "block"; any other window (6, 12, 16, ...), C up to 256, up to
8 heads of hd <= 32, or no qkv bias -> "window_attention"; wider blocks
raise.  The "window_attention" route computes K1's function in three
hand-written kernels: K2 for LN1, then (after the cyclic shift and the
window partition as plain gathers) K7 for the qkv product, attention
and proj, then K1's tail (``csrc/swin_tail.cu``: the attention residual
read back through the window reverse and unshift in its addressing,
`extra`, LN2, the MLP and its residual, in K1's arithmetic).  Both
routes and the plain version are one composition, ``swin_block_plain``,
whose steps the route swaps for the kernels' wrappers.  One
divergence: the JAX package runs ws 16 (upstream HAT-SRx4) through K1
as one kernel; here a 256-token window does not fit the whole-block
kernel's single-CTA, 64-row design, which already holds ~209 KB of
shared memory at ws 8 (``csrc/swin_block.cu``), so it takes three.  A
single fused ws-16 block is queued in ROADMAP.

The backward ports ``_bwd_kernel`` as ``_mega_backward`` (K5) and
``_packed_backward`` (K6) call it: recompute the forward, chain the
cotangent, and return dx, the 13 parameter gradients and, when the
forward had `extra`, its gradient (dx1, the cotangent of the attention
residual).  Training on CUDA goes through ``SwinBlockFunction``: its
forward is K1 / K6 and its backward K5 / K6's backward, with the
gradients mapped from the kernels' packed layout back to the raw
``[out, in]`` parameters here (the counterpart of
``fused_block.py:1098-1105``).  Its ws-7 backward launches count as
K6b.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib
from tpu_superresolution_torch.kernels.fused_attention import (
    check_attention_limits,
    window_attention_plain,
)
from tpu_superresolution_torch.kernels.layernorm import layernorm_plain
from tpu_superresolution_torch.ops.window import (
    cyclic_shift,
    cyclic_unshift,
    relative_position_bias,
    window_partition,
    window_reverse,
)

# Compile-time sizes of csrc/swin_block.cu and csrc/swin_block_bwd.cu.
KERNEL_WINDOWS = (7, 8)  # window sizes of the forward and backward kernels
CP = 192     # padded channels
HDP = 32     # padded head dim
HIDP = 384   # padded MLP hidden
MAX_HEADS = CP // HDP
LN_EPS = 1e-5
N_TOK = 64   # token rows per window in the kernels (ws^2, padded)
TAIL_MAX_C = 256  # channels of csrc/swin_tail.cu (any MLP hidden)

launches = _lib.LaunchCounter("K1 swin_block ws8")
launches_ws7 = _lib.LaunchCounter("K6 swin_block ws7")
launches_bwd = _lib.LaunchCounter("K5 swin_block_bwd")
launches_bwd_ws7 = _lib.LaunchCounter("K6b swin_block_bwd ws7")
launches_tail = _lib.LaunchCounter("K1t swin_block_tail")
# the counters of the forward and backward kernels for each window size
FORWARD_COUNTERS = {8: launches, 7: launches_ws7}
BACKWARD_COUNTERS = {8: launches_bwd, 7: launches_bwd_ws7}


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

    @property
    def window_size(self) -> int:
        """ws of the [(2ws-1)^2, nH] bias table."""
        side = round(int(self.table.shape[0]) ** 0.5)
        return (side + 1) // 2


# The differentiable tensors of a block, in the order SwinBlockFunction
# takes them and SwinBlockGrads returns their gradients.
GRAD_FIELDS = ("g1", "b1", "wqkv", "bqkv", "wproj", "bproj", "g2", "b2",
               "wfc1", "bfc1", "wfc2", "bfc2", "rpb")


@dataclasses.dataclass(frozen=True)
class SwinBlockGrads:
    """dx and the 13 parameter gradients of one block in raw weight
    space (fp32), with `rpb` the gradient of the gathered [nH, N, N]
    bias (the scatter back to the table is the gather's autograd), and
    `extra` the gradient of the forward's `extra` (None without one)."""

    dx: torch.Tensor
    g1: torch.Tensor
    b1: torch.Tensor
    wqkv: torch.Tensor
    bqkv: torch.Tensor
    wproj: torch.Tensor
    bproj: torch.Tensor
    g2: torch.Tensor
    b2: torch.Tensor
    wfc1: torch.Tensor
    bfc1: torch.Tensor
    wfc2: torch.Tensor
    bfc2: torch.Tensor
    rpb: torch.Tensor
    extra: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class PackedSwinBlock:
    """The kernels' operands: bf16 GEMM weights in the [out, in] layout,
    zero-padded to the kernel's tile sizes (q rows pre-scaled by
    hd^-0.5, head dims padded hd -> 32, channels C -> 192), fp32 biases
    and LayerNorm params, and the gathered [nH, N, N] relative-position
    bias of the window size (N = ws^2)."""

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
    rpb: torch.Tensor    # [nH, ws^2, ws^2] fp32
    dim: int
    num_heads: int
    hidden: int
    window_size: int


def check_kernel_limits(w: SwinBlockWeights) -> None:
    """Raise unless the block's widths and window fit the kernels."""
    c, nh, hidden = w.dim, w.num_heads, int(w.wfc1.shape[0])
    if c > CP or c % nh or c // nh > HDP or nh > MAX_HEADS or hidden > HIDP:
        raise ValueError(
            f"swin_block kernel takes C <= {CP}, hd <= {HDP}, heads <= "
            f"{MAX_HEADS}, hidden <= {HIDP}; got C={c}, heads={nh}, hidden={hidden}"
        )
    ws = w.window_size
    if ws not in KERNEL_WINDOWS or w.table.shape[0] != (2 * ws - 1) ** 2:
        raise ValueError(
            f"swin_block kernel takes window sizes {KERNEL_WINDOWS}; the bias table "
            f"{tuple(w.table.shape)} is for ws={ws}"
        )
    if w.bqkv is None:
        raise ValueError("swin_block kernel takes qkv_bias=True only")


def block_route(ws: int, c: int, heads: int, hidden: int, qkv_bias: bool = True) -> str:
    """The route of a Swin block of window `ws`, C channels, `heads`
    heads and MLP hidden width `hidden`: "block" (the block kernel, K1 /
    K6 forward, K5 / K6b backward) or "window_attention" (K2 for LN1, K7,
    K1's tail kernel; any hidden width).  Shapes only: it runs on any
    device and gives the same answer on every call.  Raises ValueError
    when neither route takes the block."""
    if (ws in KERNEL_WINDOWS and qkv_bias and c <= CP and c % heads == 0 and c // heads <= HDP
            and heads <= MAX_HEADS and hidden <= HIDP):
        return "block"
    check_attention_limits(c, heads, "swin block")
    return "window_attention"


def check_block_args(shape: Sequence[int], w: SwinBlockWeights, ws: int, shift: int,
                     name: str = "fused_windows_block") -> None:
    """Raise unless an x of `shape` [B, H, W, C] with window `ws` and
    `shift` and the weights `w` fit the forward kernel (shapes only, so
    it runs on any device)."""
    if ws not in KERNEL_WINDOWS:
        raise ValueError(f"{name}: the kernel takes ws in {KERNEL_WINDOWS}, got ws={ws} "
                         f"(x {tuple(shape)})")
    if len(shape) != 4:
        raise ValueError(f"{name}: x must be [B, H, W, C], got {tuple(shape)}")
    if shape[1] % ws or shape[2] % ws:
        raise ValueError(f"{name}: H, W = {shape[1]}, {shape[2]} are not multiples of {ws}")
    if not 0 <= shift < ws:
        raise ValueError(f"{name}: shift {shift} outside [0, {ws})")
    if w.window_size != ws:
        raise ValueError(f"{name}: bias table for ws={w.window_size}, block run at ws={ws}")
    if shape[3] != w.dim:
        raise ValueError(f"{name}: weights for C={w.dim}, x has C={shape[3]}")
    check_kernel_limits(w)


def check_differentiable(ws: int, extra: Optional[torch.Tensor], name: str) -> None:
    """The backward kernel takes the forward's windows (K5 at ws 8, K6's
    backward at ws 7), with or without `extra`; raise for any other."""
    if ws not in KERNEL_WINDOWS:
        raise NotImplementedError(
            f"{name}: no backward kernel for ws={ws}"
            f"{' with extra' if extra is not None else ''} on CUDA: the backward takes ws in "
            f"{KERNEL_WINDOWS}; run under torch.no_grad(), or on the CPU"
        )


@torch.no_grad()
def pack_block_weights(w: SwinBlockWeights, rpb: Optional[torch.Tensor] = None) -> PackedSwinBlock:
    """Lay one block's weights out for the kernels (the counterpart of
    the JAX package's ``_prep_weights``).  At inference the caller
    builds it once per loaded weights; in training once per step.
    `rpb`: the gathered bias, when the caller already has it."""
    check_kernel_limits(w)
    c, nh = w.dim, w.num_heads
    hd, hidden = c // nh, int(w.wfc1.shape[0])
    bf = torch.bfloat16
    ph, pd, pc = MAX_HEADS - nh, HDP - hd, CP - c

    def scale_q(t):  # [3, ...] with the q rows pre-scaled
        t = t.float()
        return torch.cat([t[:1] * w.scale, t[1:]])

    # [out, in] layouts (nn.Linear's), zero-padded with one F.pad each
    # (training packs all 36 blocks on every step: few ops per tensor)
    wqkv = F.pad(scale_q(w.wqkv.reshape(3, nh, hd, c)), (0, pc, 0, pd, 0, ph))
    bqkv = F.pad(scale_q(w.bqkv.reshape(3, nh, hd)), (0, pd, 0, ph))
    wproj = F.pad(w.wproj.reshape(c, nh, hd), (0, pd, 0, ph, 0, pc))
    if rpb is None:
        rpb = relative_position_bias(w.table, w.window_size)
    return PackedSwinBlock(
        wqkv=wqkv.reshape(3 * CP, CP).to(bf),
        bqkv=bqkv.reshape(-1),
        wproj=wproj.reshape(CP, CP).to(bf),
        bproj=F.pad(w.bproj.float(), (0, pc)),
        wfc1=F.pad(w.wfc1, (0, pc, 0, HIDP - hidden)).to(bf),
        bfc1=F.pad(w.bfc1.float(), (0, HIDP - hidden)),
        wfc2=F.pad(w.wfc2, (0, HIDP - hidden, 0, pc)).to(bf),
        bfc2=F.pad(w.bfc2.float(), (0, pc)),
        g1=w.g1.float().contiguous(),
        b1=w.b1.float().contiguous(),
        g2=w.g2.float().contiguous(),
        b2=w.b2.float().contiguous(),
        rpb=rpb.float().contiguous(),
        dim=c,
        num_heads=nh,
        hidden=hidden,
        window_size=w.window_size,
    )


def gelu(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if approximate else "none")


def gelu_grad(x: torch.Tensor, approximate: bool) -> torch.Tensor:
    """d gelu(x) / dx of either variant (``fused_block._gelu_grad``, with
    torch's exact erf where the JAX kernel uses the A&S polynomial)."""
    if approximate:
        k = 0.7978845608028654  # sqrt(2 / pi)
        th = torch.tanh(k * (x + 0.044715 * x * x * x))
        return 0.5 * (1.0 + th) + 0.5 * x * (1.0 - th * th) * k * (1.0 + 3.0 * 0.044715 * x * x)
    phi = 0.5 * (1.0 + torch.erf(x * 0.7071067811865476))
    return phi + x * torch.exp(-0.5 * x * x) * 0.3989422804014327


def _window_scales(scales: Optional[torch.Tensor], b: int, n_windows: int, dev):
    """Per-window (m1, m2) columns [B*nW, 1, 1] of the [B, 2] scales."""
    if scales is None:
        one = torch.ones(b * n_windows, 1, 1, device=dev)
        return one, one
    s = scales.float().to(dev).repeat_interleave(n_windows, dim=0)
    return s[:, 0, None, None], s[:, 1, None, None]


def _tail_plain(x, attn, extra, scales, g2, b2, wfc1, bfc1, wfc2, bfc2, ws, shift,
                gelu_approx):
    """``swin_block_tail_plain`` on its tensors one by one (what the tail
    kernel's autograd function differentiates)."""
    dt = x.dtype
    _, h, wd, _ = x.shape
    m1 = m2 = 1.0
    if scales is not None:
        s = scales.float().to(x.device)
        m1, m2 = s[:, 0, None, None, None], s[:, 1, None, None, None]
    x1 = x.float() + cyclic_unshift(window_reverse(attn, ws, h, wd), shift).float() * m1
    if extra is not None:
        x1 = x1 + extra.float()
    y2 = layernorm_plain(x1, g2, b2, LN_EPS).to(dt)
    h1 = F.linear(y2, wfc1.to(dt), bfc1.to(dt))
    h1 = gelu(h1.float(), gelu_approx).to(dt)
    mlp = F.linear(h1, wfc2.to(dt), bfc2.to(dt))
    return (x1 + mlp.float() * m2).to(dt)


def swin_block_tail_plain(x: torch.Tensor, attn: torch.Tensor, w: SwinBlockWeights, ws: int,
                          shift: int, gelu_approx: bool,
                          branch_scales: Optional[torch.Tensor] = None,
                          extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version of K1's tail (``csrc/swin_tail.cu``): a
    Swin block after its window attention, in x's frame.  `attn` [B*nW,
    N, C] is the attention output on the windows of x cyclically shifted
    by `shift`; the residual stream is fp32, LN2 and the GEMM operands in
    x's dtype, branch scales [B, 2] multiply the attention and MLP
    residuals, `extra` [B, H, W, C] is added unscaled to the first."""
    return _tail_plain(x, attn, extra, branch_scales, w.g2, w.b2, w.wfc1, w.bfc1, w.wfc2,
                       w.bfc2, ws, shift, gelu_approx)


def _window_attention_of(xw: torch.Tensor, w: SwinBlockWeights, ws: int,
                         mask: Optional[torch.Tensor]) -> torch.Tensor:
    return window_attention_plain(xw, w.wqkv, w.bqkv, w.wproj, w.bproj,
                                  relative_position_bias(w.table, ws), mask, w.scale)


def swin_block_plain(x: torch.Tensor, w: SwinBlockWeights, ws: int, shift: int,
                     mask: Optional[torch.Tensor], gelu_approx: bool,
                     branch_scales: Optional[torch.Tensor] = None,
                     extra: Optional[torch.Tensor] = None, *,
                     ln1: Callable = layernorm_plain,
                     attention: Callable = _window_attention_of,
                     tail: Callable = swin_block_tail_plain) -> torch.Tensor:
    """A Swin block at any window, as one composition: ``ln1(x, g1,
    b1)``, the cyclic shift and window partition, ``attention(xw, w, ws,
    mask)`` on [B*nW, N, C], then ``tail(x, attn, w, ws, shift,
    gelu_approx, branch_scales, extra)``.  With its default steps it is
    the plain PyTorch version of K1 and K6 (port of
    ``fused_block._reference_block`` / ``_reference_packed`` with the
    cyclic shift around it): residual stream in fp32, LayerNorm and GEMM
    operands in x's dtype, branch scales [B, 2] on the attention and MLP
    residuals, `extra` (x's frame) added unscaled to the attention
    residual.  The K7 route (``models/swinir.py``) passes the wrappers of
    K2, K7 and K1's tail kernel."""
    y = ln1(x, w.g1, w.b1)
    attn = attention(window_partition(cyclic_shift(y, shift), ws), w, ws, mask)
    return tail(x, attn, w, ws, shift, gelu_approx, branch_scales, extra)


@dataclasses.dataclass(frozen=True)
class PackedBlockTail:
    """The tail kernel's operands: bf16 [out, in] MLP weights zero-padded
    to multiples of 16 (CK = C, HK = hidden rounded up), fp32 biases
    padded alike, fp32 LN2 params."""

    wfc1: torch.Tensor  # [HK, CK] bf16
    bfc1: torch.Tensor  # [HK] fp32
    wfc2: torch.Tensor  # [CK, HK] bf16
    bfc2: torch.Tensor  # [CK] fp32
    g2: torch.Tensor
    b2: torch.Tensor
    dim: int
    hidden: int


def _round16(v: int) -> int:
    return -(-v // 16) * 16


@torch.no_grad()
def pack_block_tail(g2, b2, wfc1, bfc1, wfc2, bfc2) -> PackedBlockTail:
    """Lay the raw LN2 and MLP weights out for the tail kernel: once per
    loaded weights at inference, on every call in training."""
    hidden, c = int(wfc1.shape[0]), int(wfc1.shape[1])
    if c > TAIL_MAX_C:
        raise ValueError(f"fused_block_tail: the kernel takes C <= {TAIL_MAX_C}, got C={c} "
                         f"(ROADMAP Queue 3)")
    ck, hk = _round16(c), _round16(hidden)
    bf = torch.bfloat16
    return PackedBlockTail(
        wfc1=F.pad(wfc1.float(), (0, ck - c, 0, hk - hidden)).to(bf).contiguous(),
        bfc1=F.pad(bfc1.float(), (0, hk - hidden)).contiguous(),
        wfc2=F.pad(wfc2.float(), (0, hk - hidden, 0, ck - c)).to(bf).contiguous(),
        bfc2=F.pad(bfc2.float(), (0, ck - c)).contiguous(),
        g2=g2.float().contiguous(), b2=b2.float().contiguous(), dim=c, hidden=hidden)


def _launch_tail(x, attn, packed: PackedBlockTail, ws, shift, gelu_approx, scales,
                 extra) -> torch.Tensor:
    """One launch of the tail kernel, counted as K1t."""
    name = "fused_block_tail"
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    _lib.check_tensor(x, "x", bf, dev, ndim=4, align=2)
    b, h, wd, c = x.shape
    if c != packed.dim:
        raise ValueError(f"{name}: weights for C={packed.dim}, x has C={c}")
    if ws < 1 or h % ws or wd % ws or not 0 <= shift < ws:
        raise ValueError(f"{name}: x {tuple(x.shape)} is not whole windows of {ws} with a "
                         f"shift in [0, {ws}) (shift {shift})")
    ck, hk = _round16(c), _round16(packed.hidden)
    windows = b * (h // ws) * (wd // ws)
    for tname, t, shape, dtype, align in (
            ("attn", attn, (windows, ws * ws, c), bf, 2),
            ("wfc1", packed.wfc1, (hk, ck), bf, 32), ("bfc1", packed.bfc1, (hk,), f32, 16),
            ("wfc2", packed.wfc2, (ck, hk), bf, 32), ("bfc2", packed.bfc2, (ck,), f32, 16),
            ("g2", packed.g2, (c,), f32, 4), ("b2", packed.b2, (c,), f32, 4)):
        _lib.check_tensor(t, tname, dtype, dev, shape=shape, align=align)
    if extra is not None:
        _lib.check_tensor(extra, "extra", bf, dev, shape=tuple(x.shape), align=2)
    if scales is not None:
        _lib.check_tensor(scales, "branch_scales", f32, dev, shape=(b, 2), align=4)
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        status = _lib.library().sr_swin_tail_bf16(
            x.data_ptr(), attn.data_ptr(), _ptr(extra), y.data_ptr(),
            packed.g2.data_ptr(), packed.b2.data_ptr(), packed.wfc1.data_ptr(),
            packed.bfc1.data_ptr(), packed.wfc2.data_ptr(), packed.bfc2.data_ptr(),
            _ptr(scales), b, h, wd, c, packed.hidden, ws, shift, int(bool(gelu_approx)), LN_EPS,
            _lib.stream_of(x))
    _lib.check_status(status, "sr_swin_tail_bf16")
    launches_tail.count += 1
    return y


class BlockTailFunction(torch.autograd.Function):
    """Forward K1's tail kernel (weights packed on every call), backward
    autograd of its plain version."""

    @staticmethod
    def forward(ctx, x, attn, extra, scales, g2, b2, wfc1, bfc1, wfc2, bfc2, ws, shift,
                gelu_approx):
        ctx.save_for_backward(x, attn, extra, scales, g2, b2, wfc1, bfc1, wfc2, bfc2)
        ctx.meta = (ws, shift, gelu_approx)
        return _launch_tail(x, attn, pack_block_tail(g2, b2, wfc1, bfc1, wfc2, bfc2), ws, shift,
                            gelu_approx, scales, extra)

    @staticmethod
    def backward(ctx, grad_out):
        return _lib.plain_vjp(_tail_plain, tuple(ctx.saved_tensors) + ctx.meta,
                              ctx.needs_input_grad, grad_out)


def fused_block_tail(x: torch.Tensor, attn: torch.Tensor, w: SwinBlockWeights, ws: int,
                     shift: int, gelu_approx: bool,
                     branch_scales: Optional[torch.Tensor] = None,
                     extra: Optional[torch.Tensor] = None,
                     packed: Optional[PackedBlockTail] = None) -> torch.Tensor:
    """K1's tail on the K7 route (see ``swin_block_tail_plain``).  CPU
    tensor -> plain version; CUDA tensor -> the kernel (bf16 x, attn and
    extra, fp32 branch scales), through ``BlockTailFunction`` when a
    gradient is wanted.  `packed` (inference only) skips the per-call
    packing."""
    params = (w.g2, w.b2, w.wfc1, w.bfc1, w.wfc2, w.bfc2)
    if x.device.type == "cpu":
        return _tail_plain(x, attn, extra, branch_scales, *params, ws, shift, gelu_approx)
    _lib.require_cuda(x, "fused_block_tail")
    x, attn = x.contiguous(), attn.contiguous()
    if extra is not None:
        extra = extra.contiguous()
    if branch_scales is not None:
        branch_scales = branch_scales.float().contiguous()
    inputs = (x, attn) + params + (() if extra is None else (extra,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return BlockTailFunction.apply(x, attn, extra, branch_scales, *params, ws, shift,
                                       gelu_approx)
    if packed is None:
        packed = pack_block_tail(*params)
    return _launch_tail(x, attn, packed, ws, shift, gelu_approx, branch_scales, extra)



def _ln_stats(x32: torch.Tensor):
    mu = x32.mean(-1, keepdim=True)
    var = ((x32 * x32).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    r = torch.rsqrt(var + LN_EPS)
    return (x32 - mu) * r, r


def _ln_backward(dy, n, r, g):
    """LayerNorm backward in the fast-variance form
    (``fused_block.py:643-650``): (dx, dgamma, dbeta)."""
    dyg = dy * g
    dx = r * (dyg - dyg.mean(-1, keepdim=True) - n * (dyg * n).mean(-1, keepdim=True))
    return dx, (dy * n).sum(0), dy.sum(0)


def swin_block_bwd_plain(ct: torch.Tensor, x: torch.Tensor, w: SwinBlockWeights, ws: int,
                         shift: int, mask: Optional[torch.Tensor], gelu_approx: bool,
                         branch_scales: Optional[torch.Tensor] = None,
                         extra: Optional[torch.Tensor] = None) -> SwinBlockGrads:
    """The plain PyTorch version of K5 and K6's backward, any ws
    (``fused_block._bwd_kernel``'s math, written out): recompute the
    forward (`extra`, in x's frame, added unscaled to the attention
    residual), then chain the cotangent `ct` through MLP, LN2, proj,
    attention, qkv and LN1; d`extra` is dx1.  GEMM operands
    are cast to x's dtype at the kernel's points (yc, qkv, A, o, y2c,
    gelu output, dmlp, dh1, dattn, do, dS, dqkv) and multiplied in fp32,
    as the kernel's bf16 tensor-core products with fp32 accumulation do.
    The q weights are pre-scaled by hd^-0.5 before the cast, as the
    kernel's packing does."""
    cdt = x.dtype
    c, nh = w.dim, w.num_heads
    hd, scale = c // nh, w.scale
    f = lambda t: t.to(cdt).float()  # round to the compute dtype
    xs = window_partition(cyclic_shift(x, shift).float(), ws)   # [BW, N, C]
    cts = window_partition(cyclic_shift(ct, shift).float(), ws)
    bw, n, _ = xs.shape
    b = x.shape[0]
    m1, m2 = _window_scales(branch_scales, b, bw // b, x.device)
    wq = w.wqkv.float().reshape(3, c, c).clone()
    wq[0] *= scale
    wq = f(wq.reshape(3 * c, c))
    bq = w.bqkv.float().reshape(3, c).clone()
    bq[0] *= scale
    bq = bq.reshape(3 * c)
    wp, wf1, wf2 = f(w.wproj), f(w.wfc1), f(w.wfc2)
    rpb = relative_position_bias(w.table, ws)

    # ---- forward recompute ----
    n1, r1 = _ln_stats(xs)
    yc = f(n1 * w.g1.float() + w.b1.float())
    qkv = f(yc @ wq.t() + bq).reshape(bw, n, 3, nh, hd)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]           # [BW, N, nh, hd]
    s = torch.einsum("wqhd,wkhd->whqk", q, k) + rpb.float()[None]
    if mask is not None:
        nwm = mask.shape[0]
        s = (s.reshape(bw // nwm, nwm, nh, n, n) + mask.float()[None, :, None]).reshape(s.shape)
    a = torch.softmax(s, dim=-1)                                 # fp32 [BW, nh, N, N]
    ac = f(a)
    o = f(torch.einsum("whqk,wkhd->wqhd", ac, v)).reshape(bw, n, c)
    x1 = xs + (o @ wp.t() + w.bproj.float()) * m1
    if extra is not None:
        x1 = x1 + window_partition(cyclic_shift(extra, shift).float(), ws)
    n2, r2 = _ln_stats(x1)
    y2c = f(n2 * w.g2.float() + w.b2.float())
    h1 = y2c @ wf1.t() + w.bfc1.float()
    act = f(gelu(h1, gelu_approx))

    # ---- backward ----
    tok = lambda t: t.reshape(bw * n, -1)
    dmlp = f(cts * m2)
    dwfc2 = tok(dmlp).t() @ tok(act)
    dbfc2 = tok(dmlp).sum(0)
    dh1 = f((dmlp @ wf2) * gelu_grad(h1, gelu_approx))
    dwfc1 = tok(dh1).t() @ tok(y2c)
    dbfc1 = tok(dh1).sum(0)
    dy2 = dh1 @ wf1
    dx1, dg2, db2 = _ln_backward(tok(dy2), tok(n2), tok(r2), w.g2.float())
    dx1 = tok(cts) + dx1
    dattn = f(dx1.reshape(bw, n, c) * m1)
    dwproj = tok(dattn).t() @ tok(o)
    dbproj = tok(dattn).sum(0)
    do = f(dattn @ wp).reshape(bw, n, nh, hd)
    dv = f(torch.einsum("whqk,wqhd->wkhd", ac, do))
    da = torch.einsum("wqhd,wkhd->whqk", do, v)
    ds = a * (da - (da * a).sum(-1, keepdim=True))
    drpb = ds.sum(0)
    dsc = f(ds)
    dq = f(torch.einsum("whqk,wkhd->wqhd", dsc, k))
    dk = f(torch.einsum("whqk,wqhd->wkhd", dsc, q))
    dqkv = torch.stack([dq, dk, dv], dim=2).reshape(bw, n, 3 * c)
    dwqkv = (tok(dqkv).t() @ tok(yc)).reshape(3, c, c)
    dbqkv = tok(dqkv).sum(0).reshape(3, c)
    dwqkv[0] *= scale
    dbqkv[0] *= scale
    dy = dqkv @ wq
    dxf, dg1, db1 = _ln_backward(tok(dy), tok(n1), tok(r1), w.g1.float())
    h, wd = x.shape[1], x.shape[2]
    to_map = lambda t: cyclic_unshift(window_reverse(t.reshape(bw, n, c), ws, h, wd), shift).to(cdt)
    return SwinBlockGrads(
        dx=to_map(dx1 + dxf), g1=dg1, b1=db1, wqkv=dwqkv.reshape(3 * c, c),
        bqkv=dbqkv.reshape(3 * c), wproj=dwproj, bproj=dbproj, g2=dg2, b2=db2, wfc1=dwfc1,
        bfc1=dbfc1, wfc2=dwfc2, bfc2=dbfc2, rpb=drpb,
        extra=None if extra is None else to_map(dx1),
    )


def _check_block_input(x: torch.Tensor, w: SwinBlockWeights, ws: int, shift: int,
                       name: str) -> None:
    _lib.require_cuda(x, name)
    check_block_args(tuple(x.shape), w, ws, shift, name)
    _lib.check_tensor(x, "x", torch.bfloat16, x.device, ndim=4, align=2)


def _check_packed(packed: PackedSwinBlock, x: torch.Tensor, mask, scales, name: str,
                  extra: Optional[torch.Tensor] = None) -> None:
    b, h, wd, c = x.shape
    if packed.dim != c:
        raise ValueError(f"{name}: weights for C={packed.dim}, x has C={c}")
    dev = x.device
    ws = packed.window_size
    n = ws * ws
    # WMMA reads the bf16 weight tiles straight from global memory (32-byte
    # aligned rows); biases are read as float4, LayerNorm params as
    # scalars, rpb and mask as float4 rows at ws = 8 and as scalars at 7.
    bf, f32 = torch.bfloat16, torch.float32
    table_align = 16 if n % 8 == 0 else 4
    for tname, t, shape, dtype, align in (
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
        ("rpb", packed.rpb, (packed.num_heads, n, n), f32, table_align),
    ):
        _lib.check_tensor(t, tname, dtype, dev, shape=shape, align=align)
    if mask is not None:
        n_windows = (h // ws) * (wd // ws)
        _lib.check_tensor(mask, "mask", f32, dev, shape=(n_windows, n, n), align=table_align)
    if scales is not None:
        _lib.check_tensor(scales, "branch_scales", f32, dev, shape=(b, 2), align=4)
    if extra is not None:
        _lib.check_tensor(extra, "extra", bf, dev, shape=tuple(x.shape), align=2)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_block(x, packed: PackedSwinBlock, shift, mask, gelu_approx, scales,
                  extra=None) -> torch.Tensor:
    """Launch the forward kernel's instantiation for packed.window_size
    (ws 8: K1, ws 7: K6) and count the launch on that kernel."""
    _check_packed(packed, x, mask, scales, "fused_windows_block", extra)
    b, h, wd, c = x.shape
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = _lib.library().sr_swin_block_bf16(
            x.data_ptr(), _ptr(extra), y.data_ptr(),
            packed.g1.data_ptr(), packed.b1.data_ptr(),
            packed.g2.data_ptr(), packed.b2.data_ptr(),
            packed.wqkv.data_ptr(), packed.bqkv.data_ptr(),
            packed.wproj.data_ptr(), packed.bproj.data_ptr(),
            packed.wfc1.data_ptr(), packed.bfc1.data_ptr(),
            packed.wfc2.data_ptr(), packed.bfc2.data_ptr(),
            packed.rpb.data_ptr(), _ptr(mask), _ptr(scales),
            b, h, wd, c, packed.num_heads, packed.window_size, shift,
            int(bool(gelu_approx)), LN_EPS, _lib.stream_of(x),
        )
    _lib.check_status(status, "sr_swin_block_bf16")
    FORWARD_COUNTERS[packed.window_size].count += 1
    return y


# K5's split-K reduction: at most this many row chunks per weight GEMM.
K5_MAX_SPLITS = 16
K5_MIN_ROWS_PER_SPLIT = 512
# Per-window partial sums written by K5a: LN g1, b1, g2, b2 (CP each),
# then the bias sums bqkv (3CP), bproj (CP), bfc1 (HIDP), bfc2 (CP);
# the per-head dS [nh, ws^2, ws^2] follows.
_VEC_OFFSETS = {"g1": 0, "b1": CP, "g2": 2 * CP, "b2": 3 * CP, "bqkv": 4 * CP,
                "bproj": 7 * CP, "bfc1": 8 * CP, "bfc2": 8 * CP + HIDP}
_VEC_SIZES = {"bqkv": 3 * CP, "bfc1": HIDP}
K5_VEC = 9 * CP + HIDP
# Weight-gradient GEMMs of K5b, [out, in] each, concatenated in this order.
_WGRAD_SHAPES = (("wqkv", 3 * CP, CP), ("wproj", CP, CP), ("wfc1", HIDP, CP), ("wfc2", CP, HIDP))
K5_WGRAD = sum(m * n for _, m, n in _WGRAD_SHAPES)
# bf16 operand columns per token row in K5's workspace: yc, qkv, o, y2c,
# act, dmlp, dh1, dattn, dqkv; then fp32 x1 (CP) and h1 (HIDP).
K5_BF16_COLS = CP + 3 * CP + CP + CP + HIDP + CP + HIDP + CP + 3 * CP
K5_F32_COLS = CP + HIDP


def k5_splits(tokens: int) -> Tuple[int, int]:
    """(number of row chunks, rows per chunk) of the split-K weight
    gradient reduction over `tokens` workspace rows (a multiple of 64)."""
    splits = max(1, min(K5_MAX_SPLITS, tokens // K5_MIN_ROWS_PER_SPLIT))
    rows = -(-tokens // splits)
    rows = -(-rows // 64) * 64
    return -(-tokens // rows), rows


def split_vec(vec: torch.Tensor, offsets: dict, sizes: dict) -> dict:
    """The named slices of a reduced per-window partial-sum vector (the
    LayerNorm and bias gradients; CP long unless `sizes` says)."""
    return {name: vec[o:o + sizes.get(name, CP)] for name, o in offsets.items()}


def split_wgrad(wgrad: torch.Tensor, shapes) -> dict:
    """The [out, in] weight gradients concatenated in `shapes` order."""
    out, off = {}, 0
    for name, m, n in shapes:
        out[name] = wgrad[off:off + m * n].reshape(m, n)
        off += m * n
    return out


def _launch_bwd(ct, x, packed: PackedSwinBlock, shift, mask, gelu_approx, scales, extra=None):
    """Run the block backward for packed.window_size (ws 8: K5, ws 7:
    K6's backward): the per-window kernel, the weight-gradient GEMMs and
    the ordered reductions.  Returns (dx, packed-space fp32 gradients,
    d extra or None) and counts the launch on that window's counter."""
    _check_packed(packed, x, mask, scales, "fused_swin_block_backward", extra)
    _lib.check_tensor(ct, "ct", torch.bfloat16, x.device, shape=tuple(x.shape), align=2)
    b, h, wd, c = x.shape
    nh, ws = packed.num_heads, packed.window_size
    n = ws * ws
    windows = b * (h // ws) * (wd // ws)
    tokens = windows * N_TOK  # workspace rows
    splits, rows = k5_splits(tokens)
    dev = x.device
    dx = torch.empty_like(x)
    dextra = None if extra is None else torch.empty_like(x)
    ws16 = torch.empty(tokens * K5_BF16_COLS, dtype=torch.bfloat16, device=dev)
    ws32 = torch.empty(tokens * K5_F32_COLS, dtype=torch.float32, device=dev)
    vec_len = K5_VEC + nh * n * n
    part_win = torch.empty(windows * vec_len, dtype=torch.float32, device=dev)
    part_w = torch.empty(splits * K5_WGRAD, dtype=torch.float32, device=dev)
    vec = torch.empty(vec_len, dtype=torch.float32, device=dev)
    wgrad = torch.empty(K5_WGRAD, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = _lib.library().sr_swin_block_bwd_bf16(
            ct.data_ptr(), x.data_ptr(), _ptr(extra), dx.data_ptr(), _ptr(dextra),
            packed.g1.data_ptr(), packed.b1.data_ptr(),
            packed.g2.data_ptr(), packed.b2.data_ptr(),
            packed.wqkv.data_ptr(), packed.bqkv.data_ptr(),
            packed.wproj.data_ptr(), packed.bproj.data_ptr(),
            packed.wfc1.data_ptr(), packed.bfc1.data_ptr(),
            packed.wfc2.data_ptr(), packed.bfc2.data_ptr(),
            packed.rpb.data_ptr(), _ptr(mask), _ptr(scales),
            ws16.data_ptr(), ws32.data_ptr(), part_win.data_ptr(), part_w.data_ptr(),
            vec.data_ptr(), wgrad.data_ptr(),
            b, h, wd, c, nh, ws, shift, int(bool(gelu_approx)), LN_EPS, splits, rows,
            _lib.stream_of(x),
        )
    _lib.check_status(status, "sr_swin_block_bwd_bf16")
    BACKWARD_COUNTERS[ws].count += 1
    g = split_wgrad(wgrad, _WGRAD_SHAPES)
    g.update(split_vec(vec, _VEC_OFFSETS, _VEC_SIZES))
    g["rpb"] = vec[K5_VEC:].reshape(nh, n, n)
    return dx, g, dextra


def unpack_block_grads(g: dict, packed: PackedSwinBlock, scale: float) -> dict:
    """Packed-layout gradients -> raw [out, in] parameter gradients:
    drop the head-dim and channel padding and carry the q pre-scale
    (``fused_block.py:1098-1105``)."""
    c, nh, hidden = packed.dim, packed.num_heads, packed.hidden
    hd = c // nh
    # (g is this launch's fresh output: scaling it in place is safe)
    dwqkv = g["wqkv"].reshape(3, MAX_HEADS, HDP, CP)[:, :nh, :hd, :c].reshape(3, c, c)
    dbqkv = g["bqkv"].reshape(3, MAX_HEADS, HDP)[:, :nh, :hd].reshape(3, c)
    dwqkv[0] *= scale
    dbqkv[0] *= scale
    return dict(
        g1=g["g1"][:c], b1=g["b1"][:c], g2=g["g2"][:c], b2=g["b2"][:c],
        wqkv=dwqkv.reshape(3 * c, c), bqkv=dbqkv.reshape(3 * c),
        wproj=unpack_proj_grad(g["wproj"], c, nh),
        bproj=g["bproj"][:c],
        wfc1=g["wfc1"][:hidden, :c], bfc1=g["bfc1"][:hidden],
        wfc2=g["wfc2"][:c, :hidden], bfc2=g["bfc2"][:c],
        rpb=g["rpb"],
    )


def unpack_proj_grad(g: torch.Tensor, c: int, nh: int) -> torch.Tensor:
    """[CP, CP] packed proj gradient (input columns head-padded) -> the
    raw [c, c] one."""
    return g.reshape(CP, MAX_HEADS, HDP)[:c, :nh, :c // nh].reshape(c, c)


def fused_swin_block_backward(ct: torch.Tensor, x: torch.Tensor, w: SwinBlockWeights, ws: int,
                              shift: int, mask: Optional[torch.Tensor], gelu_approx: bool,
                              branch_scales: Optional[torch.Tensor] = None,
                              packed: Optional[PackedSwinBlock] = None,
                              extra: Optional[torch.Tensor] = None) -> SwinBlockGrads:
    """The backward of one Swin block for the cotangent `ct` (K5 at ws 8,
    K6's backward at ws 7; d`extra` when the forward had `extra`).  CPU
    tensors -> plain version; CUDA tensors -> the kernel (bf16 ct, x and
    extra, fp32 branch scales), gradients in raw weight space."""
    if x.device.type == "cpu":
        return swin_block_bwd_plain(ct, x, w, ws, shift, mask, gelu_approx, branch_scales, extra)
    _check_block_input(x, w, ws, shift, "fused_swin_block_backward")
    if branch_scales is not None:
        branch_scales = branch_scales.float().contiguous()
    if packed is None:
        packed = pack_block_weights(w)
    if extra is not None:
        extra = extra.contiguous()
    dx, g, dextra = _launch_bwd(ct.contiguous(), x, packed, shift, mask, gelu_approx,
                                branch_scales, extra)
    return SwinBlockGrads(dx=dx, extra=dextra, **unpack_block_grads(g, packed, w.scale))


class SwinBlockFunction(torch.autograd.Function):
    """One Swin block on CUDA whose forward is K1 / K6 and whose backward
    is K5 / K6's backward.  Inputs: x, the branch scales (or None),
    `extra` (or None), then the 13 tensors of GRAD_FIELDS (raw weights
    and the gathered bias); the weights are packed for the kernels on
    every call."""

    @staticmethod
    def forward(ctx, x, scales, extra, meta, *params):
        shift, mask, gelu_approx, num_heads, table = meta
        raw = dict(zip(GRAD_FIELDS, params))
        rpb = raw.pop("rpb")
        w = SwinBlockWeights(table=table, num_heads=num_heads, **raw)
        packed = pack_block_weights(w, rpb=rpb)
        ctx.save_for_backward(x, scales, extra)
        ctx.block = (w.scale, packed, shift, mask, gelu_approx)
        return _launch_block(x, packed, shift, mask, gelu_approx, scales, extra)

    @staticmethod
    def backward(ctx, ct):
        x, scales, extra = ctx.saved_tensors
        scale, packed, shift, mask, gelu_approx = ctx.block
        dx, g, dextra = _launch_bwd(ct.to(x.dtype).contiguous(), x, packed, shift, mask,
                                    gelu_approx, scales, extra)
        raw = unpack_block_grads(g, packed, scale)
        return (dx, None, dextra, None) + tuple(raw[k] for k in GRAD_FIELDS)


def fused_windows_block(x: torch.Tensor, w: SwinBlockWeights, ws: int, shift: int,
                        mask: Optional[torch.Tensor], gelu_approx: bool,
                        extra: Optional[torch.Tensor] = None,
                        packed: Optional[PackedSwinBlock] = None,
                        branch_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Swin block on x [B, H, W, C] with window `ws`, cyclic shift
    `shift`, the shift mask [nW, ws^2, ws^2] built on (H, W), the
    optional additive term `extra` [B, H, W, C] (x's frame) and branch
    scales [B, 2].  CPU tensor -> plain version (differentiable by
    autograd); CUDA tensor -> the kernel (bf16 x and extra): K1 at ws 8,
    K6 at ws 7, through ``SwinBlockFunction`` (backward K5 / K6's
    backward, with d`extra`) when a gradient is wanted.  `packed` is
    used for inference only."""
    if x.device.type == "cpu":
        return swin_block_plain(x, w, ws, shift, mask, gelu_approx, branch_scales, extra)
    _check_block_input(x, w, ws, shift, "fused_windows_block")
    if branch_scales is not None:
        branch_scales = branch_scales.float().contiguous()
    if extra is not None:
        extra = extra.contiguous()
    params = [getattr(w, k) for k in GRAD_FIELDS[:-1]]
    inputs = [x, w.table] + params + ([] if extra is None else [extra])
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        check_differentiable(ws, extra, "fused_windows_block")
        rpb = relative_position_bias(w.table, ws)
        meta = (shift, mask, gelu_approx, w.num_heads, w.table)
        return SwinBlockFunction.apply(x, branch_scales, extra, meta, *params, rpb)
    if packed is None:
        packed = pack_block_weights(w)
    return _launch_block(x, packed, shift, mask, gelu_approx, branch_scales, extra)
