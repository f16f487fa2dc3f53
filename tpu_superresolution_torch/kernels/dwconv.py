"""K11 — depthwise 3x3 convolution (CUDA, ``csrc/dwconv.cu``).

Port of ``tpu_superresolution_tpu/ops/pallas/cab_conv.py::
dwconv3x3_halo`` (its ``pallas_call`` at :506): a depthwise SAME 3x3
convolution with zero padding plus bias on x [B, H, W, C], accumulated
in fp32, the output in x's dtype.  The kernel is [3, 3, C] (the JAX
package's [3, 3, 1, C] without its unit axis; a torch depthwise weight
[C, 1, 3, 3] is ``weight[:, 0].permute(1, 2, 0)``).  DAT runs it on the
module chain's conv branch (on v) and in SGFN's spatial gate.

Two CUDA kernels compute it, chosen by ``dwconv_plan`` from the shapes
(``csrc/dwconv.cu``): "rows" streams image rows, one bulk copy
each, through a ring of shared-memory buffers while a CTA walks down its
band of output rows, where the bands are tall (the published DAT x4's
[25, 64, 64, C]) and the image row W * C is a whole number of 16-byte
pieces; "tiles" (the first design) stages halo tiles for the others (the DAT train
step's [8, 64, 64, C], where its 384 short blocks hide the load latency
that a short band exposes; and views whose data is not 16-byte
aligned).  Both count as K11 and round alike, bit for bit.

The gradient is torch autograd of the plain version, as the JAX package
differentiates its reference (``cab_conv.py:516-528``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib

launches = _lib.LaunchCounter("K11 dwconv3x3")

# csrc/dwconv.cu's "rows" route: threads and row buffers a CTA, the
# shared memory the buffers may take, and the band below which the
# "tiles" kernel is faster (measured on the H100: bands of 4 rows at [8,
# 64, 64, 180] 0.0200 ms back to back against the tiles kernel's 0.0141;
# bands of 13 at [25, 64, 64, 360] 0.1051 against 0.1297; PERF.md).
ROWS_MAX_THREADS = 512
ROWS_MAX_SLOTS = 8
ROWS_SMEM = 232448 - 1024
ROWS_MIN_BAND = 8


@dataclasses.dataclass(frozen=True)
class DwconvPlan:
    """K11's launch: route "rows" or "tiles"; for "rows", the threads a
    CTA, the output rows (`rows`) and columns (`seg`) a CTA owns, the
    input-row buffers (`slots`, `slot_elems` bf16 each), the grid and the
    output rows a step (`step`: 2, whose middle input rows are read once
    for both)."""

    route: str
    threads: int = 0
    rows: int = 0
    seg: int = 0
    slots: int = 0
    slot_elems: int = 0
    grid: int = 0
    step: int = 2


def _slot_elems(seg: int, c: int) -> int:
    # a segment of `seg` columns with one pixel each side, widened to
    # 8-element boundaries at both ends, rounded up to 64 elements
    return -(-((seg + 2) * c + 14) // 64) * 64


@functools.lru_cache(maxsize=256)
def dwconv_plan(b: int, h: int, w: int, c: int, sms: int,
                min_band: int = ROWS_MIN_BAND) -> DwconvPlan:
    """The route and launch geometry of K11 on x [B, H, W, C] for a card
    of `sms` SMs, from the shapes alone.  "rows" where an image row is
    whole 16-byte pieces (W * C % 8 == 0), C / gcd(C, 8) <= 512 (a CTA's
    threads are a multiple of it, so each thread keeps fixed channels),
    four row buffers of at least 8 / gcd(C, 8) columns fit, and the band
    sized for about one CTA an SM has at least `min_band` rows:
    the segment is all of W where four buffers fit, else the widest that
    does."""
    g = math.gcd(c, 8)
    phases = c // g
    if (w * c) % 8 or phases > ROWS_MAX_THREADS:
        return DwconvPlan("tiles")
    step = 8 // g  # columns: a segment's start stays on a 16-byte boundary
    max_bytes = ROWS_SMEM // 4
    seg = w
    if _slot_elems(seg, c) * 2 > max_bytes:
        widest = (max_bytes // 2 - 14) // c - 2
        widest -= widest % step
        if widest < step:
            return DwconvPlan("tiles")
        n = -(-w // widest)  # as few segments as fit, of even widths
        seg = min(widest, -(-(-(-w // n)) // step) * step)
    slot_elems = _slot_elems(seg, c)
    slots = min(ROWS_MAX_SLOTS, ROWS_SMEM // (2 * slot_elems))
    segs = -(-w // seg)
    rows = min(h, max(1, -(-b * h * segs // sms)))
    if rows < min_band:
        return DwconvPlan("tiles")
    grid = b * -(-h // rows) * segs
    return DwconvPlan("rows", phases * (ROWS_MAX_THREADS // phases), rows, seg, slots,
                      slot_elems, grid)


def depthwise3x3(t: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise SAME 3x3 of t [B, H, W, C] (k [3, 3, C], bias [C]) in
    fp32 on t's values, returned in fp32."""
    y = F.conv2d(t.float().permute(0, 3, 1, 2), k.float().permute(2, 0, 1)[:, None],
                 b.float(), padding=1, groups=t.shape[-1])
    return y.permute(0, 2, 3, 1)


def dwconv3x3_plain(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K11: fp32 accumulation, x's dtype."""
    return depthwise3x3(x, k, b).to(x.dtype).contiguous()


@functools.lru_cache(maxsize=256)
def _geometry(b: int, h: int, w: int, c: int, sms: int, route: Optional[str]) -> ctypes.Array:
    """The C entry's geometry array: ``dwconv_plan``'s, or the "tiles"
    kernel's (threads 0), or the "rows" kernel's at any band height."""
    p = dwconv_plan(b, h, w, c, sms, 1 if route == "rows" else ROWS_MIN_BAND)
    if route == "tiles" or p.route == "tiles":
        return (ctypes.c_int * 10)(b, h, w, c, 0, 0, 0, 0, 0, 1)
    return (ctypes.c_int * 10)(b, h, w, c, p.threads, p.rows, p.seg, p.slots, p.slot_elems,
                               p.step)


def _launch(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor,
            route: Optional[str] = None) -> torch.Tensor:
    """K11 on x [B, H, W, C] bf16 with taps k [3, 3, C] or [9, C] and bias
    [C] (fp32; converted where they are not), on `route`'s kernel
    (``dwconv_plan``'s by default; "rows" or "tiles" forces one where it
    takes the shape: chip_smoke.py times the two and checks them against
    each other).  Its host work is a few microseconds against ~20 of
    device time at the DAT train step's shape, so the common case takes
    one cheap test."""
    bsz, h, w, c = x.shape
    dev = x.device
    if k.dim() == 3:
        k = k.reshape(9, c)
    if not (k.dtype == b.dtype == torch.float32 and k.is_contiguous() and b.is_contiguous()):
        k, b = k.float().contiguous(), b.float().contiguous()
    xp, kp, bp = x.data_ptr(), k.data_ptr(), b.data_ptr()
    if not (x.dtype == torch.bfloat16 and x.is_contiguous() and k.shape == (9, c)
            and b.shape == (c,) and k.get_device() == b.get_device() == x.get_device()
            and xp % 2 == 0 and kp % 4 == 0 and bp % 4 == 0):
        # the checks name what is wrong
        _lib.check_tensor(x, "x", torch.bfloat16, dev, ndim=4, align=2)
        _lib.check_tensor(k, "kernel", torch.float32, dev, shape=(9, c), align=4)
        _lib.check_tensor(b, "bias", torch.float32, dev, shape=(c,), align=4)
    out = torch.empty_like(x)
    status = _lib.call(x, _lib.library().sr_dwconv3x3_bf16, xp, kp, bp, out.data_ptr(),
                       _geometry(bsz, h, w, c, _lib.sm_count(dev.index), route),
                       _lib.stream_of(x))
    _lib.check_status(status, "sr_dwconv3x3_bf16")
    launches.count += 1
    return out


class DWConv3x3Function(torch.autograd.Function):
    """Forward K11, backward autograd of ``dwconv3x3_plain``."""

    @staticmethod
    def forward(ctx, x, k, b):
        ctx.save_for_backward(x, k, b)
        return _launch(x, k, b)

    @staticmethod
    def backward(ctx, grad_out):
        return _lib.plain_vjp(dwconv3x3_plain, ctx.saved_tensors, ctx.needs_input_grad,
                              grad_out)


def dwconv3x3(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 + bias of x [B, H, W, C] with k [3, 3, C] and b [C]:
    the plain version for a CPU tensor, K11 for a CUDA tensor (bf16 x),
    through ``DWConv3x3Function`` when a gradient is wanted."""
    if x.device.type == "cpu":
        return dwconv3x3_plain(x, k, b)
    c = x.shape[-1]
    if x.dim() != 4 or k.shape != (3, 3, c) or b.shape != (c,):
        raise ValueError(f"dwconv3x3: x {tuple(x.shape)}, kernel {tuple(k.shape)}, bias "
                         f"{tuple(b.shape)} are not [B, H, W, C], [3, 3, C], [C]")
    if _lib.exporting():
        return torch.ops.tpu_sr.dwconv3x3(x.contiguous(), k, b)
    _lib.require_cuda(x, "dwconv3x3")
    if not x.is_contiguous():
        x = x.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or k.requires_grad or b.requires_grad):
        return DWConv3x3Function.apply(x, k, b)
    return _launch(x, k, b)
