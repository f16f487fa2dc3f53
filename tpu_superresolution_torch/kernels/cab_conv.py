"""K3 + K4 — NHWC direct convolution (CUDA, ``csrc/conv.cu``); K12 —
HAT's CAB front, LayerNorm -> conv3x3 -> exact GELU -> conv3x3 in one
pass (CUDA, ``csrc/cab_fused.cu``).

K3 and K4 port ``tpu_superresolution_tpu/ops/pallas/cab_conv.py``:
``conv3x3_halo`` (K3: SAME 3x3, pad 1; ``pallas_call`` at :307) and
``conv_halo`` (K4: any kh x kw with an asymmetric zero pad whose output
keeps the input's H x W; :418).  Weights keep the JAX package's ``[kh,
kw, Cin, Cout]`` layout at the public functions.  One implicit-GEMM
kernel file serves both, on Hopper's wgmma with fp32 accumulators in
registers: a persistent CTA an SM, warpgroup 0 filling an mbarrier ring,
two consumer warpgroups of 64 output rows each, K steps of one tap and
one 64-channel chunk.  What bounds it on the H100 is feeding the tensor
cores (L2 traffic, the activation gather, a barrier round trip a ring
stage), not device memory; its two routes, chosen from static shapes by
``conv_route``, answer that differently:

- "halo" (8 x 16-pixel blocks, 8 x 24 where that pads the image's width
  less): each chunk's halo is gathered once and
  every tap's operand is a window of it, read by wgmma in place; the
  weight tiles of up to 288 / N taps come in one bulk copy a stage;
- "flat" (128 consecutive pixels of the flattened b*h*w index; the C-180
  trunk's N 192 and kernels too wide for the halo): every (tap, chunk)
  step gathers its activation tile.

The weight is packed once for the kernel (``pack_conv_weight``: one
128B-swizzled [N, 64] tile a (N tile, chunk, tap)); at inference the
packing is cached beside the module's parameters (``Conv3x3``'s
``DerivedCache``, ``ComposedUpsample.packed``); under autograd the
wrapper packs on every call, on the card, in the same library call.
Unlike the JAX package it has no shape gate and takes every shape (any Cin/Cout, any image size).  ``conv_tiled_plain``
writes both routes' schedules out in plain ops for the CPU tests.
Training differentiates through ``ConvFunction``: forward K3 or K4,
backward torch autograd of the plain version (cuDNN's conv backward), as
the JAX package's K3/K4 backwards are XLA vjps (``cab_conv.py:324-327``,
``:435-437``).

K12 ports ``fused_ln_cab_convs`` (``cab_conv.py:531``, ``pl.pallas_call``
at ``:209``): y = conv3x3(gelu_erf(conv3x3(LN(x)))) with SAME zero
padding of the LN output and of conv2's input; the SE gate stays
outside.  The JAX package keeps it off by default (``ENABLE = False``, a
TPU VMEM switch); the port runs it for every HAB's CAB on CUDA.  Its
kernel is K3's machinery fused, two launches counted once: LN's
statistics of every pixel, then a persistent CTA walking 14 x 14 output
blocks, whose producer warpgroup normalises the block's 18 x 18 input
halo (zero outside the image) chunk by chunk into swizzled halo buffers
and streams both convs' packed weight taps through an mbarrier ring;
two consumer warpgroups run conv1 as wgmma on the 16 x 16 pixels around
the block (each tap's operand a window of the halo, read in place), the
GELU in registers into a y1 buffer zeroed outside the image, and conv2
on the block (``cab_plan`` picks the N tiles).  Its gradient is
``CabConvsFunction``: forward K12, backward torch autograd of
``fused_ln_cab_convs_plain``, as the JAX custom_vjp differentiates
``_reference`` (``cab_conv.py:548-550``).  The kernel takes C <= 256 and
Cmid <= 128, as the JAX kernel does (Cmid 65-128: conv1 at N 128, y1 in
two 64-channel chunks, conv2 reducing over both); past those widths
``cab_route`` sends the CAB to
``ln_cab_convs``, the same function as K2 + K3 (with the GELU in its
epilogue) + K3.  The JAX package's erf is an A&S polynomial, the port's
torch's erf.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib
from tpu_superresolution_torch.kernels.layernorm import EPS, layernorm, layernorm_plain

Pad = Tuple[Tuple[int, int], Tuple[int, int]]

launches_conv3x3 = _lib.LaunchCounter("K3 conv3x3")
launches_conv_k = _lib.LaunchCounter("K4 conv_k")
launches_ln_cab = _lib.LaunchCounter("K12 ln_cab_convs")

# Limits of csrc/cab_fused.cu.
CAB_MAX_C = 256   # csrc/cab_fused.cu: channels (four 64-channel chunks)
CAB_MAX_MID = 128  # and Cmid (y1 in one or two 64-channel chunks)


def conv_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
               pad: Pad, gelu: bool = False) -> torch.Tensor:
    """The plain PyTorch version: x [B, H, W, Cin], kernel [kh, kw, Cin,
    Cout], bias [Cout]; zero pad ((top, bottom), (left, right)); the
    conv runs in x's dtype, like the JAX package's XLA conv.  `gelu`:
    then the exact-erf GELU in fp32, rounded to x's dtype (the kernel
    applies it before its one rounding)."""
    (pt, pb), (pl, pr) = pad
    xn = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xn, kernel.permute(3, 2, 0, 1).to(x.dtype))
    y = (y.permute(0, 2, 3, 1) + bias.to(x.dtype)).contiguous()
    return F.gelu(y.float()).to(x.dtype) if gelu else y


# csrc/conv.cu: output pixels a CTA (the flat route's 128 consecutive
# pixels; the halo route's block, 8 rows x 16 by default), channels a K
# step, the N tile widths it is compiled for (wgmma names N in the
# instruction) and the shared memory a CTA may use.
CONV_BM = 128
CONV_TH, CONV_TW = 8, 16
CONV_BK = 64
CONV_N_TILES = (16, 32, 48, 64, 96, 128, 192, 256)
_SMEM_MAX = 232448


def taps_per_stage(n_tile: int) -> int:
    """Taps a halo-route B stage carries (csrc/conv.cu ``taps_per_stage``)."""
    return max(1, 288 // n_tile)


def halo_stages(n_tile: int, kh: int, kw: int, cwg: int = 2) -> int:
    """The B ring stages the halo route fits (csrc/conv.cu
    ``halo_stages``): each stage ``taps_per_stage`` taps' [N, 64] weight
    tiles, beside two chunk buffers of a block's halo ((8 + kh - 1) x
    (8 cwg + kw - 1) pixels of 128 bytes) and the staging tile (64 cwg
    rows); at most 8, 0 when fewer than 2 fit."""
    halo = -(-((CONV_TH + kh - 1) * (8 * cwg + kw - 1) * 128) // 1024) * 1024
    fixed = 1024 + 2 * halo + 64 * cwg * n_tile * 2 + n_tile * 4 + 32
    s = (_SMEM_MAX - fixed) // (taps_per_stage(n_tile) * n_tile * 128 + 16)
    return 0 if s < 2 else min(s, 8)


def halo_block_width(n_tile: int, kh: int, kw: int, w: int) -> int:
    """The halo route's block width on an image of width `w` (csrc/conv.cu
    ``launch_halo``): 24 pixels (three consumer warpgroups, N <= 128)
    where that pads the width less than 16 does and fits, else 16."""
    if n_tile <= 128 and -(-w // 24) * 24 < -(-w // 16) * 16 and halo_stages(n_tile, kh, kw, 3):
        return 24
    return CONV_TW


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How csrc/conv.cu runs one conv shape: `route` "halo" (8 x 16- or
    8 x 24-pixel blocks, each chunk's halo gathered once and every tap's
    operand a window of it) or "flat" (128 consecutive pixels, every tap
    gathered),
    N tiles of `n_tile` output channels (`n_tiles` of them), activation
    copies of `vec` bf16 (at an x aligned to 2 * vec bytes)."""

    route: str
    n_tile: int
    n_tiles: int
    vec: int

    def describe(self, vec: Optional[int] = None) -> str:
        v = self.vec if vec is None else vec
        copy = f"cp.async {2 * v} B" if v > 1 else "element loads"
        return f"{self.route}, wgmma N {self.n_tile} x {self.n_tiles}, A {copy}"


@functools.lru_cache(maxsize=256)
def conv_route(cin: int, cout: int, kh: int, kw: int) -> ConvPlan:
    """K3/K4's plan from static shapes: Cout rounded up to the narrowest
    compiled N tile, in as few tiles of at most 256 as it takes; the
    widest copy (8, 4, 2 or 1 bf16) that divides Cin; the route:

    - "flat" for 3x3 convs of N 192 and 256 (the C-180 trunk, SwinIR-L's
      240) with 8-byte or wider copies, where it measured faster on the
      H100 (0.208 against 0.224 ms at [25,64,64,180] -> 180, 0.281
      against 0.302 at SwinIR-L's 240 -> 240): there a step's weight tile
      outweighs its activation tile, so the halo saves little traffic
      and costs a wait per chunk;
    - "flat" where the halo route's shared memory does not hold two B
      stages (square kernels from 10 x 10 taps at N 256, 12 x 12 at N
      96-192, 14 x 14 at N 16-48);
    - "halo" everywhere else."""
    n_tiles = -(-cout // CONV_N_TILES[-1])
    per_tile = -(-cout // n_tiles)
    n_tile = next(n for n in CONV_N_TILES if n >= per_tile)
    vec = next(v for v in (8, 4, 2, 1) if cin % v == 0)
    flat = (n_tile >= 192 and kh * kw <= 9 and vec >= 4) or not halo_stages(n_tile, kh, kw)
    return ConvPlan(route="flat" if flat else "halo", n_tile=n_tile, n_tiles=n_tiles, vec=vec)


@dataclasses.dataclass(frozen=True)
class PackedConv:
    """The weight as csrc/conv.cu reads it: one [N, 64] tile a (N tile,
    64-channel chunk, tap), in that order (a chunk's taps contiguous),
    Cin zero-padded to a multiple of 64 and Cout to the N tiles; each tile
    K-major (row n: the 64 channels of output channel n, 128 bytes) and
    stored 128B-swizzled (16-byte chunk j of row n at chunk j ^ (n % 8)),
    so that one bulk copy puts it in shared memory as wgmma reads it.
    ``wp`` is [n_tiles, chunks * kh * kw, n_tile, 64]."""

    wp: torch.Tensor
    plan: ConvPlan
    kh: int
    kw: int
    cin: int
    cout: int


def _swizzle_rows(t: torch.Tensor) -> torch.Tensor:
    """The 128B swizzle of [..., rows, 64] tiles: row n's 16-byte chunk j
    (8 values) moves to chunk j ^ (n % 8) (an involution: it also
    undoes itself)."""
    rows = t.shape[-2]
    src = torch.arange(8).view(1, 8) ^ (torch.arange(rows) % 8).view(rows, 1)  # [rows, 8]
    idx = src.to(t.device).view(rows, 8, 1).expand(rows, 8, 8)
    chunks = t.reshape(*t.shape[:-1], 8, 8)
    return torch.gather(chunks, -2, idx.expand(*chunks.shape)).reshape(t.shape)


@functools.lru_cache(maxsize=64)
def _pack_index(kh: int, kw: int, cin: int, cout: int, device: torch.device) -> torch.Tensor:
    """For each element of the packed weight, its index in the flattened
    [kh, kw, Cin, Cout] kernel, or kh * kw * Cin * Cout (a zero appended
    to it) for the padding: the packing is then one gather."""
    plan = conv_route(cin, cout, kh, kw)
    chunks = -(-cin // CONV_BK)
    n = torch.arange(plan.n_tiles * plan.n_tile).view(-1, 1, 1, 1)
    tap = torch.arange(kh * kw).view(1, -1, 1, 1)
    ci = torch.arange(chunks * CONV_BK).view(1, 1, chunks, CONV_BK)  # channel of (chunk, k)
    idx = (tap * cin + ci) * cout + n  # [npad, taps, chunks, 64]
    idx = torch.where((n < cout) & (ci < cin), idx, kh * kw * cin * cout)
    idx = idx.transpose(1, 2).reshape(plan.n_tiles, plan.n_tile, chunks * kh * kw, CONV_BK)
    return _swizzle_rows(idx.transpose(1, 2)).contiguous().to(device)


@torch.no_grad()
def pack_conv_weight(kernel: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> PackedConv:
    kh, kw, cin, cout = (int(d) for d in kernel.shape)
    flat = F.pad(kernel.detach().reshape(-1).to(dtype), (0, 1))
    idx = _pack_index(kh, kw, cin, cout, flat.device)
    return PackedConv(wp=flat[idx], plan=conv_route(cin, cout, kh, kw), kh=kh, kw=kw, cin=cin,
                      cout=cout)


def conv_tiled_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, pad: Pad,
                     route: Optional[str] = None) -> torch.Tensor:
    """K3/K4's tile schedule written out in plain ops, on the route
    ``conv_route`` picks (or `route`): the packed weight, each [N, 64]
    B tile read back through the swizzle; fp32 products summed in the
    kernel's order, + bias, one rounding to x's dtype.

    - "flat": 128-pixel tiles over the flattened b*h*w index (rows past
      the tensor read zeros); per (tap, chunk) step, tap-major, each row's
      source pixel m + dy*W + dx gathered with the zero halo.
    - "halo": 8 x TW-pixel blocks of one image (TW 16 or 24,
      ``halo_block_width``); per 64-channel chunk the block's (8 + kh - 1)
      x (TW + kw - 1) halo gathered once (zero outside the image and past
      Cin), then per tap each 8 x 8 part's A operand is the halo window at
      row dy * (TW + kw - 1) + dx (+ 8 per part to the right), 8 rows of 8
      pixels (wgmma reads it in place)."""
    (pt, _), (pl, _) = pad
    b, h, w, cin = x.shape
    kh, kw, _, cout = kernel.shape
    packed = pack_conv_weight(kernel.to(x.dtype), torch.float32)
    plan = packed.plan
    route = route or plan.route
    chunks = -(-cin // CONV_BK)
    bt = _swizzle_rows(packed.wp).transpose(1, 2).reshape(-1, kh * kw * chunks, CONV_BK)
    # bt[n, c * taps + tap, k]: output channel n's weights at (chunk, tap)
    xs = F.pad(x.float(), (0, chunks * CONV_BK - cin))
    if route == "flat":
        m_total = b * h * w
        tiles = -(-m_total // CONV_BM)
        m = torch.arange(tiles * CONV_BM)
        rem = m % (h * w)
        yy, xx = rem // w, rem % w
        flat = xs.reshape(m_total, -1)
        acc = torch.zeros(tiles, CONV_BM, bt.shape[0])
        for tap in range(kh * kw):
            dy, dx = tap // kw - pt, tap % kw - pl
            ok = (m < m_total) & (yy + dy >= 0) & (yy + dy < h) & (xx + dx >= 0) & (xx + dx < w)
            a = torch.where(ok[:, None], flat[torch.where(ok, m + dy * w + dx, 0)], 0.0)
            for c in range(chunks):
                acc += a[:, c * CONV_BK:(c + 1) * CONV_BK].reshape(tiles, CONV_BM, CONV_BK) \
                    @ bt[:, c * kh * kw + tap].T
        y = acc.reshape(-1, bt.shape[0])[:m_total]
    else:
        tw = halo_block_width(plan.n_tile, kh, kw, w)
        ty, tx = -(-h // CONV_TH), -(-w // tw)
        hh, hw = CONV_TH + kh - 1, tw + kw - 1
        # every block's halo at once: zero-pad the image by the kernel's
        # reach and the blocks' overhang, then unfold
        xp = F.pad(xs, (0, 0, pl, tx * tw - w + kw - 1 - pl,
                        pt, ty * CONV_TH - h + kh - 1 - pt))
        halo = xp.unfold(1, hh, CONV_TH).unfold(2, hw, tw)  # [b, ty, tx, C64, hh, hw]
        halo = halo.permute(0, 1, 2, 4, 5, 3).reshape(-1, hh * hw, chunks * CONV_BK)
        acc = torch.zeros(halo.shape[0], CONV_TH * tw, bt.shape[0])
        r = torch.arange(CONV_TH * tw)
        rows = (r // tw) * hw + r % tw  # block pixel r's halo row at tap (0, 0)
        for c in range(chunks):
            hc = halo[..., c * CONV_BK:(c + 1) * CONV_BK]
            for tap in range(kh * kw):
                win = hc[:, rows + (tap // kw) * hw + tap % kw]  # [blocks, 8 tw, 64]
                acc += win @ bt[:, c * kh * kw + tap].T
        acc = acc.reshape(b, ty, tx, CONV_TH, tw, -1).permute(0, 1, 3, 2, 4, 5)
        y = acc.reshape(b, ty * CONV_TH, tx * tw, -1)[:, :h, :w].reshape(b * h * w, -1)
    y = y[:, :cout] + bias.float()
    return y.to(x.dtype).reshape(b, h, w, cout)


def _launch(x, kernel, bias, pad: Pad, name: str,
            packed: Optional[PackedConv] = None, gelu: bool = False) -> torch.Tensor:
    _lib.require_cuda(x, name)
    kh, kw = int(kernel.shape[0]), int(kernel.shape[1])
    (pt, pb), (pl, pr) = pad
    if pt + pb != kh - 1 or pl + pr != kw - 1 or min(pt, pb, pl, pr) < 0:
        raise ValueError(f"{name}: pad {pad} does not keep H x W for a {kh}x{kw} kernel")
    _lib.check_tensor(x, "x", torch.bfloat16, x.device, ndim=4, align=2)
    b, h, w, cin = x.shape
    cout = int(kernel.shape[3])
    if packed is None:
        # pack on the card, in the same call (what pack_conv_weight computes)
        _lib.check_tensor(kernel, "kernel", torch.bfloat16, x.device,
                          shape=(kh, kw, cin, cout), align=2)
        plan, src = conv_route(cin, cout, kh, kw), kernel.data_ptr()
        wp = torch.empty((plan.n_tiles, -(-cin // CONV_BK) * kh * kw, plan.n_tile, CONV_BK),
                         dtype=torch.bfloat16, device=x.device)
    elif (packed.kh, packed.kw, packed.cin, packed.cout) != (kh, kw, cin, cout):
        raise ValueError(f"{name}: weights packed for "
                         f"{(packed.kh, packed.kw, packed.cin, packed.cout)}, kernel is "
                         f"{(kh, kw, cin, cout)}")
    elif packed.wp.device != x.device:
        raise ValueError(f"{name}: packed weight on {packed.wp.device}, x on {x.device}")
    else:
        # (pack_conv_weight makes wp contiguous bf16 of the plan's shape)
        plan, src, wp = packed.plan, None, packed.wp
    _lib.check_tensor(bias, "bias", torch.float32, x.device, shape=(cout,), align=4)
    vec = conv_vec(x, plan)
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), wp.data_ptr(), bias.data_ptr(), y.data_ptr(),
            b, h, w, cin, cout, kh, kw, pt, pl, plan.n_tile, plan.n_tiles, vec,
            int(plan.route == "halo"), int(gelu), src, _lib.stream_of(x))
    fn = _lib.library().sr_conv_bf16
    if x.device.index == torch.cuda.current_device():
        status = fn(*args)
    else:
        with torch.cuda.device(x.device):
            status = fn(*args)
    _lib.check_status(status, name)
    (launches_conv3x3 if name == "conv3x3" else launches_conv_k).count += 1
    return y


def conv_vec(x: torch.Tensor, plan: ConvPlan) -> int:
    """The plan's activation copy width, narrowed while x's data pointer
    is not aligned to it (a view at an odd offset)."""
    vec = plan.vec
    while vec > 1 and x.data_ptr() % (2 * vec):
        vec //= 2
    return vec


class ConvFunction(torch.autograd.Function):
    """Forward K3 / K4 (the weight packed on the card on every call),
    backward autograd of ``conv_plain``."""

    @staticmethod
    def forward(ctx, x, kernel, bias, pad, name, gelu=False):
        ctx.save_for_backward(x, kernel, bias)
        ctx.pad, ctx.gelu = pad, gelu
        return _launch(x, kernel, bias, pad, name, gelu=gelu)

    @staticmethod
    def backward(ctx, grad_out):
        x, kernel, bias = ctx.saved_tensors
        return _lib.plain_vjp(lambda x, k, b, pad, _name, gelu: conv_plain(x, k, b, pad, gelu),
                              (x, kernel, bias, ctx.pad, None, ctx.gelu), ctx.needs_input_grad,
                              grad_out)


def _conv(x, kernel, bias, pad, name, packed, gelu=False):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kernel, bias)):
        return ConvFunction.apply(x, kernel, bias, pad, name, gelu)
    return _launch(x, kernel, bias, pad, name, packed, gelu)


def conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
            packed: Optional[PackedConv] = None, gelu: bool = False) -> torch.Tensor:
    """K3: SAME 3x3 conv (then, with `gelu`, the exact-erf GELU in the
    kernel's epilogue).  CPU tensor -> plain version; CUDA tensor -> the
    kernel (bf16 x and kernel [3, 3, Cin, Cout], fp32 bias), through
    ``ConvFunction`` when a gradient is wanted.  `packed` (inference
    only: ``pack_conv_weight(kernel)``) skips the per-call packing."""
    if x.device.type == "cpu":
        return conv_plain(x, kernel, bias, ((1, 1), (1, 1)), gelu)
    if tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError(f"conv3x3: kernel {tuple(kernel.shape)} is not 3x3")
    if _lib.exporting():
        return torch.ops.tpu_sr.conv3x3_halo(x, kernel, bias, packed and packed.wp, gelu)
    return _conv(x, kernel, bias, ((1, 1), (1, 1)), "conv3x3", packed, gelu)


def conv_k(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
           pad: Pad, packed: Optional[PackedConv] = None) -> torch.Tensor:
    """K4: kh x kw conv with the asymmetric zero pad
    ((top, bottom), (left, right)), top + bottom == kh - 1.  CPU tensor
    -> plain version; CUDA tensor -> the kernel; `packed` as conv3x3's."""
    if x.device.type == "cpu":
        return conv_plain(x, kernel, bias, pad)
    if _lib.exporting():
        (pt, pb), (pl, pr) = pad
        return torch.ops.tpu_sr.conv_halo(x, kernel, bias, packed and packed.wp,
                                          [pt, pb, pl, pr])
    return _conv(x, kernel, bias, pad, "conv_k", packed)


# ----------------------------------------------------------------- K12


def fused_ln_cab_convs_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                             k1: torch.Tensor, c1: torch.Tensor, k2: torch.Tensor,
                             c2: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K12 (``cab_conv._reference``): x
    [B, H, W, C], LN params g, b [C], k1 [3, 3, C, Cmid], k2 [3, 3, Cmid,
    C] with biases c1, c2; LN output and the convs in x's dtype (each
    conv adds its bias before rounding), the GELU in fp32."""
    dt = x.dtype

    def conv(t, k, c):
        y = F.conv2d(t.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).to(dt), c.to(dt), padding=1)
        return y.permute(0, 2, 3, 1)

    y = conv(layernorm_plain(x, g, b, EPS), k1, c1)
    y = F.gelu(y.float()).to(dt)
    return conv(y, k2, c2).contiguous()


# csrc/cab_fused.cu: its widths, compiled conv1 / conv2 N tiles
CAB_N1 = (16, 32, 64, 128)
CAB_N2 = (48, 64, 96)
CAB_BLOCK = 14  # output pixels a block side


def cab_route(c: int, cmid: int) -> str:
    """The route of HAT's CAB front at C channels and Cmid = C /
    compress_ratio: "K12" (one launch) within K12's widths, else "convs"
    (``ln_cab_convs``: K2, K3, exact-erf GELU, K3, which take any width).
    Shapes only: the same on every call and device."""
    return "K12" if c <= CAB_MAX_C and cmid <= CAB_MAX_MID else "convs"


@dataclasses.dataclass(frozen=True)
class CabPlan:
    """K12's N tiles: conv1's `n1` (Cmid rounded up), conv2's `n2` in
    `passes` passes over C."""

    n1: int
    n2: int
    passes: int


@functools.lru_cache(maxsize=64)
def cab_plan(c: int, cmid: int) -> CabPlan:
    """conv1's narrowest N tile that holds Cmid; conv2's N tile and
    passes with the least padded width, ties to the wider tile (fewer
    passes).  Shapes only."""
    check_cab_limits(c, cmid)
    n1 = next(n for n in CAB_N1 if n >= cmid)
    n2 = min(CAB_N2, key=lambda n: (-(-c // n) * n, -n))
    return CabPlan(n1, n2, -(-c // n2))


def ln_cab_convs(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, k1: torch.Tensor,
                 c1: torch.Tensor, k2: torch.Tensor, c2: torch.Tensor,
                 packed: Tuple[Optional[PackedConv], Optional[PackedConv]] = (None, None)
                 ) -> torch.Tensor:
    """K12's function as the port's own kernels, for CABs past K12's
    widths: K2 (LayerNorm, x's dtype), K3 (conv1 + bias, then the
    exact-erf GELU of ``hat.py:134`` in its epilogue before the one
    rounding), K3 (conv2 + bias); each wrapper's plain version on a CPU
    tensor, so that it equals ``fused_ln_cab_convs_plain`` there.
    `packed` (inference only): the two convs' ``pack_conv_weight``."""
    y = conv3x3(layernorm(x.contiguous(), g, b), k1.contiguous(), c1.float().contiguous(),
                packed[0], gelu=True)
    return conv3x3(y, k2.contiguous(), c2.float().contiguous(), packed[1])


def check_cab_limits(c: int, cmid: int, name: str = "fused_ln_cab_convs") -> None:
    if c > CAB_MAX_C or cmid > CAB_MAX_MID:
        raise ValueError(f"{name}: K12 takes C <= {CAB_MAX_C} and Cmid <= {CAB_MAX_MID}; got "
                         f"C={c}, Cmid={cmid}")


@dataclasses.dataclass(frozen=True)
class PackedCab:
    """K12's operands: conv1's weight as one [N1, 64] tile a (64-channel
    chunk of C, tap) and conv2's as one [N2, 64] tile a (pass, 64-channel
    chunk of Cmid, tap), each K-major and 128B-swizzled (16-byte chunk j
    of row n at j ^ (n % 8)), zero past the channels (``w1`` [chunks, 9,
    N1, 64], ``w2`` [passes * mid chunks, 9, N2, 64], a pass's chunks
    together); fp32 biases padded alike; fp32 LN params."""

    w1: torch.Tensor
    c1: torch.Tensor
    w2: torch.Tensor
    c2: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    dim: int
    mid: int
    plan: CabPlan


def _pack_taps(k: torch.Tensor, n_tile: int, n_tiles: int, dtype: torch.dtype) -> torch.Tensor:
    """A [3, 3, Cin, Cout] kernel as [n_tiles * chunks, 9, n_tile, 64]
    swizzled tiles: tile (N tile or chunk, tap) holds output channels
    n_tile t.. and input channels 64 c.., N tile-major (conv1 has one N
    tile; conv2 one 64-channel chunk of Cmid, or two past Cmid 64)."""
    cin, cout = int(k.shape[2]), int(k.shape[3])
    chunks = -(-cin // CONV_BK)
    w = F.pad(k.detach().float().reshape(9, cin, cout),
              (0, n_tile * n_tiles - cout, 0, chunks * CONV_BK - cin))
    w = w.reshape(9, chunks, CONV_BK, n_tiles, n_tile).permute(3, 1, 0, 4, 2)
    return _swizzle_rows(w.reshape(n_tiles * chunks, 9, n_tile, CONV_BK)).to(dtype).contiguous()


@torch.no_grad()
def pack_cab(g, b, k1, c1, k2, c2, dtype: torch.dtype = torch.bfloat16) -> PackedCab:
    c, cm = int(k1.shape[2]), int(k1.shape[3])
    plan = cab_plan(c, cm)
    return PackedCab(
        w1=_pack_taps(k1, plan.n1, 1, dtype), c1=F.pad(c1.float(), (0, plan.n1 - cm)).contiguous(),
        w2=_pack_taps(k2, plan.n2, plan.passes, dtype),
        c2=F.pad(c2.float(), (0, plan.n2 * plan.passes - c)).contiguous(),
        g=g.float().contiguous(), b=b.float().contiguous(), dim=c, mid=cm, plan=plan)


def _launch_cab(x: torch.Tensor, p: PackedCab) -> torch.Tensor:
    if x.data_ptr() % 16:  # the statistics pass reads 16-byte pieces
        x = x.clone()
    _lib.check_tensor(x, "x", torch.bfloat16, x.device, ndim=4, align=16)
    bsz, h, w, c = x.shape
    if c != p.dim:
        raise ValueError(f"fused_ln_cab_convs: weights for C={p.dim}, x has C={c}")
    plan = p.plan
    if p.w1.device != x.device or p.w1.dtype != torch.bfloat16:
        raise ValueError(f"fused_ln_cab_convs: weights packed as {p.w1.dtype} on "
                         f"{p.w1.device}, x on {x.device}")
    # (pack_cab makes every operand contiguous in the plan's shapes)
    y = torch.empty_like(x)
    stats = torch.empty(bsz * h * w * 2, dtype=torch.float32, device=x.device)  # mean, rstd
    status = _lib.call(x, _lib.library().sr_ln_cab_convs_bf16, x.data_ptr(), p.g.data_ptr(),
                       p.b.data_ptr(), p.w1.data_ptr(), p.c1.data_ptr(), p.w2.data_ptr(),
                       p.c2.data_ptr(), y.data_ptr(), stats.data_ptr(), bsz, h, w, c, p.mid,
                       plan.n1, plan.n2, plan.passes, EPS, _lib.stream_of(x))
    _lib.check_status(status, "sr_ln_cab_convs_bf16")
    launches_ln_cab.count += 1
    return y


class CabConvsFunction(torch.autograd.Function):
    """Forward K12 (weights packed on every call), backward autograd of
    ``fused_ln_cab_convs_plain``."""

    @staticmethod
    def forward(ctx, x, g, b, k1, c1, k2, c2):
        ctx.save_for_backward(x, g, b, k1, c1, k2, c2)
        return _launch_cab(x, pack_cab(g, b, k1, c1, k2, c2))

    @staticmethod
    def backward(ctx, grad_out):
        return _lib.plain_vjp(fused_ln_cab_convs_plain, ctx.saved_tensors, ctx.needs_input_grad,
                              grad_out)


def fused_ln_cab_convs(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, k1: torch.Tensor,
                       c1: torch.Tensor, k2: torch.Tensor, c2: torch.Tensor,
                       packed: Optional[PackedCab] = None) -> torch.Tensor:
    """K12: conv3x3(gelu_erf(conv3x3(LN(x)))) on NHWC x, weights in the
    JAX package's [3, 3, Cin, Cout] layout.  CPU tensor -> plain version;
    CUDA tensor -> the kernel (bf16 x), through ``CabConvsFunction`` when
    a gradient is wanted.  `packed` (inference only) skips the
    per-call packing."""
    if x.device.type == "cpu":
        return fused_ln_cab_convs_plain(x, g, b, k1, c1, k2, c2)
    if _lib.exporting():
        from tpu_superresolution_torch.kernels import custom_ops

        check_cab_limits(int(k1.shape[2]), int(k1.shape[3]))
        return custom_ops.ln_cab_convs(x.contiguous(),
                                       packed or pack_cab(g, b, k1, c1, k2, c2))
    _lib.require_cuda(x, "fused_ln_cab_convs")
    check_cab_limits(int(k1.shape[2]), int(k1.shape[3]))
    x = x.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, g, b, k1, c1, k2, c2)):
        return CabConvsFunction.apply(x, g, b, k1, c1, k2, c2)
    if packed is None:
        packed = pack_cab(g, b, k1, c1, k2, c2)
    return _launch_cab(x, packed)
