"""The whole Swin transformer block forward (CUDA,
``csrc/swin_block.cu``) for window size 8 (K1) and 7 (K6), and its
backward (CUDA, ``csrc/swin_block_bwd.cu``) for window size 8 (K5) and
7 (K6b), both with HAT's additive term `extra`.

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

The forward kernel runs on Hopper's wgmma: a persistent CTA an SM walks
window pairs, two consumer warpgroups a window each (its 64 token rows
one m64 tile), a feeder warp streaming the weights through an mbarrier
ring of 12 KB stages; the products accumulate in registers, where every
epilogue runs (LN1 / LN2, q into Q K^T's A fragments, the softmax with
the bias and mask, P and the GELU'd hidden chunk as the A operands of P V
and fc2).  Its launch plan comes from static shapes alone
(``block_plan``: padded width 96 or 192, head dim 16 or 32, hidden in
64-column chunks, ring stages), and its operands from
``pack_block_tiles``: one stream of [N, 64] 128B-swizzled weight tiles
in the consumers' order, the biases, and the [nH, (2ws-1)^2] bias table
that it reads through the token codes of ``ops.window.window_token_codes``
(the bias and the shift mask, bit for bit, without the dense [nH, N, N]
and [nW, N, N] reads).  The backward reads the same stream (see below),
at ws 16 too.

Which blocks take the kernel is decided by ``block_route`` from static
shapes alone, the same on every call and device: ws 7 or 8 within those
widths -> "block"; every other block (any window, any C, any number of
heads of any head dim, no qkv bias) -> "window_attention", which
computes K1's function in three hand-written kernels: K2 for LN1, then
(after the cyclic shift and the window partition as plain gathers) K7
for the qkv product, attention and proj, then K1's tail
(``csrc/swin_tail.cu``: the attention residual read back through the
window reverse and unshift in its addressing, `extra`, LN2, the MLP and
its residual, in K1's arithmetic).  Only heads that do not divide C
raise, as the JAX block fails on them.  Both routes and the plain
version are one composition, ``swin_block_plain``,
whose steps the route swaps for the kernels' wrappers.  One
divergence: the JAX package runs ws 16 (upstream HAT-SRx4) through K1
as one kernel; here the whole-block kernel holds a window as one 64-row
wgmma tile in a consumer warpgroup, two windows in ~226 KB of shared
memory at width 192 (``csrc/swin_block.cu``), so a 256-token window
takes three kernels.  A single fused ws-16 block is queued in ROADMAP.

The backward ports ``_bwd_kernel`` as ``_mega_backward`` (K5) and
``_packed_backward`` (K6b) call it: recompute the forward, chain the
cotangent, and return dx, the 13 parameter gradients and, when the
forward had `extra`, its gradient (dx1, the cotangent of the attention
residual).  On Hopper it is three launches on ``bwd_plan``'s plan: a
persistent wgmma kernel over window pairs that streams the forward's
own ``pack_block_tiles`` tiles (read K-major for Y W^T, MN-major for
dY W), takes the bias from the table and the token codes, and writes
the dW operand pairs to a workspace of [64, 64] swizzled tiles; a wgmma
GEMM over tokens for dW = dY^T X, split over the windows, in the weight
stream's layout; the ordered sums of the partials.  The gradients come
back in the forward's tile space and ``fold_block_grads`` (the
transpose of ``_tile_indices``' gather) maps them to the raw ``[out,
in]`` parameters (the counterpart of ``fused_block.py:1098-1105``).
Training on CUDA goes through ``SwinBlockFunction``: its forward is K1 /
K6 and its backward K5 / K6b, both on one ``pack_block_tiles`` pack a
step.  Its ws-7 backward launches count as K6b.  A K7-route block that ``tiled_bwd_ok`` takes trains through
``WindowBlockFunction``: forward the route's K2, gathers, K7 and K1t,
backward ``csrc/swin_block_bwd16.cu``: at ws 16 within the block
kernel's widths (``k5w16_ok``: upstream HAT-SRx4's HABs) counted as
K5w16, K5a running the windows' 64-token tiles in three token-local
launches around two attention kernels over (window, head) units
(``bwd16_plan``); at ws 8 past those widths (``k5r_ok``: C <= 256, <= 8
heads of hd <= 32, hidden <= 512, SwinIR-L) counted as K5r, the same
launches with a window one unit and K5a at padded width 256
(``k5r_plan``); both on one ``pack_block_tiles`` pack a step.  At the
route's other shapes the backward is still autograd of the kernels'
plain versions, where the JAX package runs K5 (ws 24, 32, ...; ws 8 /
16 past those widths) or ``_packed_backward`` (ws 6, 12, ...): ROADMAP
Queue 2.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib
from tpu_superresolution_torch.kernels.fused_attention import window_attention_plain
from tpu_superresolution_torch.kernels.layernorm import layernorm_plain
from tpu_superresolution_torch.ops.window import (
    cyclic_shift,
    cyclic_unshift,
    relative_position_bias,
    window_codes_tensor,
    window_partition,
    window_reverse,
)

# Compile-time sizes of csrc/swin_block_bwd.cu (and the forward's limits).
KERNEL_WINDOWS = (7, 8)  # window sizes of the forward and backward kernels
CP = 192     # padded channels
HDP = 32     # padded head dim
HIDP = 384   # padded MLP hidden
MAX_HEADS = CP // HDP
LN_EPS = 1e-5
N_TOK = 64   # token rows per window in the kernels (ws^2, padded)
TAIL_ROWS = (64, 32, 16)  # csrc/swin_tail.cu: pixels a block, the most that fit C
TAIL_SPILL_CTAS = 2       # its CTAs an SM past C 2272 (tail_spills)
TAIL_SMEM = 232448        # both tail kernels' shared memory

launches = _lib.LaunchCounter("K1 swin_block ws8")
launches_ws7 = _lib.LaunchCounter("K6 swin_block ws7")
launches_bwd = _lib.LaunchCounter("K5 swin_block_bwd")
launches_bwd_ws7 = _lib.LaunchCounter("K6b swin_block_bwd ws7")
launches_tail = _lib.LaunchCounter("K1t swin_block_tail")
launches_bwd_w16 = _lib.LaunchCounter("K5w16 swin_block_bwd ws16")
launches_bwd_r = _lib.LaunchCounter("K5r swin_block_bwd ws8 wide")
BWD16_WINDOW = 16  # the window of csrc/swin_block_bwd16.cu
# K5r (csrc/swin_block_bwd16.cu at ws 8): the K7 route's ws-8 blocks past
# the block kernel's widths, on one instantiation: padded width 256, head
# dim 32, the proj's and fc2's N parts of 128 rows
K5R_WINDOW = 8
K5R_CP = 256
K5R_HEADS = 8
K5R_HIDDEN = 512
K5R_PW = 128
BLOCK_PW = 96  # the block kernel's N parts (its "halves")
# the counters of the forward and backward kernels for each window size
FORWARD_COUNTERS = {8: launches, 7: launches_ws7}
BACKWARD_COUNTERS = {8: launches_bwd, 7: launches_bwd_ws7}
# csrc/swin_block.cu (the forward): its instantiations (padded width,
# padded head dim), the hidden chunk, the ring's stages, shared memory
BLOCK_INSTANCES = ((96, 16), (96, 32), (192, 32))
BLOCK_HC = 64
BLOCK_STAGE_BYTES = 12288
BLOCK_MAX_STAGES = 8
BLOCK_SMEM = 232448
BLOCK_TABLE_BYTES = MAX_HEADS * 225 * 4  # [nH, (2ws-1)^2] fp32 at ws <= 8


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


def _block_widths(c: int, heads: int, hidden: int) -> bool:
    """Whether C, the heads and the MLP hidden fit the block kernel."""
    return (c % heads == 0 and c <= CP and c // heads <= HDP and heads <= MAX_HEADS
            and hidden <= HIDP)


def _k5r_widths(c: int, heads: int, hidden: int) -> bool:
    """Whether C, the heads and the MLP hidden fit K5r's instantiation."""
    return (c % heads == 0 and c <= K5R_CP and c // heads <= HDP and heads <= K5R_HEADS
            and hidden <= K5R_HIDDEN)


def _check_widths(w: SwinBlockWeights) -> None:
    c, nh, hidden = w.dim, w.num_heads, int(w.wfc1.shape[0])
    if not _block_widths(c, nh, hidden):
        raise ValueError(
            f"swin_block kernel takes C <= {CP}, hd <= {HDP}, heads <= "
            f"{MAX_HEADS}, hidden <= {HIDP}; got C={c}, heads={nh}, hidden={hidden}"
        )
    if w.bqkv is None:
        raise ValueError("swin_block kernel takes qkv_bias=True only")


def check_kernel_limits(w: SwinBlockWeights) -> None:
    """Raise unless the block's widths and window fit the kernels."""
    _check_widths(w)
    ws = w.window_size
    if ws not in KERNEL_WINDOWS or w.table.shape[0] != (2 * ws - 1) ** 2:
        raise ValueError(
            f"swin_block kernel takes window sizes {KERNEL_WINDOWS}; the bias table "
            f"{tuple(w.table.shape)} is for ws={ws}"
        )


def block_route(ws: int, c: int, heads: int, hidden: int, qkv_bias: bool = True) -> str:
    """The route of a Swin block of window `ws`, C channels, `heads`
    heads and MLP hidden width `hidden`: "block" (the block kernel, K1 /
    K6 forward, K5 / K6b backward) at ws 7 or 8 within its widths, else
    "window_attention" (K2 for LN1, K7, K1's tail kernel; any window,
    width, head count and head dim).  Shapes only: it runs on any device
    and gives the same answer on every call.  Raises ValueError where
    the heads do not divide C (the JAX block fails there too)."""
    if c % heads:
        raise ValueError(f"swin block: {heads} heads do not divide C={c}")
    if ws in KERNEL_WINDOWS and qkv_bias and _block_widths(c, heads, hidden):
        return "block"
    return "window_attention"


def k5w16_ok(ws: int, c: int, heads: int, hidden: int, qkv_bias: bool = True) -> bool:
    """Whether a "window_attention"-route block of window `ws` trains
    through K5 at ws 16 (``WindowBlockFunction``): ws 16 within the block
    kernel's widths.  Shapes only, as ``block_route``."""
    return ws == BWD16_WINDOW and qkv_bias and _block_widths(c, heads, hidden)


def k5r_ok(ws: int, c: int, heads: int, hidden: int, qkv_bias: bool = True) -> bool:
    """Whether a "window_attention"-route block of window `ws` trains
    through K5r (``WindowBlockFunction``): ws 8 past the block kernel's
    widths (so ``block_route`` sends it to the K7 route) within K5r's: C
    <= 256, <= 8 heads of hd <= 32, hidden <= 512 (SwinIR-L: C 240, 8
    heads, hidden 480).  Shapes only, as ``block_route``."""
    return (ws == K5R_WINDOW and qkv_bias and not _block_widths(c, heads, hidden)
            and _k5r_widths(c, heads, hidden))


def tiled_bwd_ok(ws: int, c: int, heads: int, hidden: int, qkv_bias: bool = True) -> bool:
    """Whether a K7-route block trains through ``WindowBlockFunction``
    (backward K5w16 or K5r, ``csrc/swin_block_bwd16.cu``); the rest of
    the route trains through autograd of its kernels' plain versions."""
    return k5w16_ok(ws, c, heads, hidden, qkv_bias) or k5r_ok(ws, c, heads, hidden, qkv_bias)


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
    """The block kernel's backward takes its forward's windows (K5 at ws
    8, K6's backward at ws 7), with or without `extra`; raise for any
    other (a block at ws 16 trains on the K7 route, through K5w16)."""
    if ws not in KERNEL_WINDOWS:
        raise NotImplementedError(
            f"{name}: no block-kernel backward for ws={ws}"
            f"{' with extra' if extra is not None else ''} on CUDA: it takes ws in "
            f"{KERNEL_WINDOWS} (ws {BWD16_WINDOW} trains on the K7 route, through "
            f"WindowBlockFunction); run under torch.no_grad(), or on the CPU"
        )


@dataclasses.dataclass(frozen=True)
class StreamLayout:
    """The layout of ``pack_block_tiles``' weight stream for a block's
    widths: padded width `cp`, padded head dim `hdp`, `kc` 64-column K
    chunks of an A operand, `halves` N parts of `pw` rows of the proj and
    fc2, `chunks` 64-column hidden chunks.  The block kernel (K1 / K6),
    K5a and K5b read it."""

    cp: int
    hdp: int
    kc: int
    halves: int
    chunks: int
    pw: int


@functools.lru_cache(maxsize=64)
def stream_layout(c: int, heads: int, hidden: int) -> StreamLayout:
    """The stream's layout from static shapes alone.  Within the block
    kernel's widths (C <= 192, <= 6 heads of hd <= 32, hidden <= 384) its
    instantiation's: hd padded to 16 or 32, the width to 96 where C and
    the heads' padded dims fit, else 192, N parts of 96 rows.  Past them,
    within K5r's (C <= 256, <= 8 heads of hd <= 32, hidden <= 512), K5r's:
    width 256, hd 32, N parts of 128 rows.  Raises ValueError past
    both."""
    chunks = -(-hidden // BLOCK_HC)
    if _block_widths(c, heads, hidden):
        hdp = 16 if c // heads <= 16 else 32
        cp = 96 if c <= 96 and heads * hdp <= 96 else 192
        return StreamLayout(cp=cp, hdp=hdp, kc=-(-cp // 64), halves=cp // BLOCK_PW,
                            chunks=chunks, pw=BLOCK_PW)
    if _k5r_widths(c, heads, hidden):
        return StreamLayout(cp=K5R_CP, hdp=HDP, kc=K5R_CP // 64, halves=K5R_CP // K5R_PW,
                            chunks=chunks, pw=K5R_PW)
    raise ValueError(f"swin_block kernel takes C <= {CP}, hd <= {HDP}, heads <= {MAX_HEADS}, "
                     f"hidden <= {HIDP} (K5r's backward C <= {K5R_CP}, heads <= {K5R_HEADS}, "
                     f"hidden <= {K5R_HIDDEN}); got C={c}, heads={heads}, hidden={hidden}")


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """How csrc/swin_block.cu runs a block's widths: the instantiation
    (padded width `cp`, 96 or 192; padded head dim `hdp`, 16 or 32),
    `kc` 64-column K chunks of an A operand, `halves` 96-column N halves
    of the proj and fc2, `chunks` 64-column hidden chunks, `stages` ring
    stages of 12 KB and `smem` bytes of shared memory a CTA."""

    cp: int
    hdp: int
    kc: int
    halves: int
    chunks: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=64)
def block_plan(c: int, heads: int, hidden: int) -> BlockPlan:
    """The forward kernel's plan from static shapes alone (its C entry
    only checks it): the stream's layout (``stream_layout``); a window's
    buffers (the A operand, R: the attention output beside x, then x1 in
    fp32; the head's k and v) twice, the bias table and the barriers,
    then as many 12 KB stages as fit, at most 8.  Raises ValueError
    outside the kernel's widths (C <= 192, <= 6 heads of hd <= 32,
    hidden <= 384)."""
    if not _block_widths(c, heads, hidden):
        raise ValueError(f"swin_block kernel takes C <= {CP}, hd <= {HDP}, heads <= "
                         f"{MAX_HEADS}, hidden <= {HIDP}; got C={c}, heads={heads}, "
                         f"hidden={hidden}")
    lay = stream_layout(c, heads, hidden)
    cp, hdp, kc = lay.cp, lay.hdp, lay.kc
    a_bytes = kc * 8192
    r_bytes = -(-max(a_bytes + 128 * cp, 256 * cp) // 1024) * 1024
    fixed = (1024 + 2 * (a_bytes + r_bytes + 2 * 64 * 2 * hdp) + BLOCK_TABLE_BYTES
             + 2 * BLOCK_MAX_STAGES * 8)
    stages = min(BLOCK_MAX_STAGES, (BLOCK_SMEM - fixed) // BLOCK_STAGE_BYTES)
    return BlockPlan(cp=cp, hdp=hdp, kc=kc, halves=lay.halves, chunks=lay.chunks,
                     stages=stages, smem=fixed + stages * BLOCK_STAGE_BYTES)


@dataclasses.dataclass(frozen=True)
class PackedBlockTiles:
    """The forward kernel's operands (``pack_block_tiles``): `tiles`, the
    weight stream of [N, 64] K-major tiles, each 128B-swizzled (16-byte
    chunk j of row n at j ^ (n % 8)), in the order the consumers take
    them: per head, its q, k, v rows (N 3 hdp, q pre-scaled) per
    64-column K chunk; the proj per N part of `layout.pw` rows per K chunk (its
    input columns head-padded, h hdp + d); per 64-column hidden chunk,
    fc1's K chunks then fc2's N parts; zero past the widths.  fp32
    biases (`bqkv` [nH, 3, hdp], `bproj` and `bfc2` [cp], `bfc1` [chunks
    64]), fp32 LN params, and `table`, the relative-position table
    transposed to [nH, (2ws-1)^2]; `layout` the stream's
    (``stream_layout``)."""

    tiles: torch.Tensor
    bqkv: torch.Tensor
    bproj: torch.Tensor
    bfc1: torch.Tensor
    bfc2: torch.Tensor
    g1: torch.Tensor
    b1: torch.Tensor
    g2: torch.Tensor
    b2: torch.Tensor
    table: torch.Tensor
    dim: int
    num_heads: int
    hidden: int
    window_size: int
    layout: StreamLayout


@functools.lru_cache(maxsize=64)
def _tile_indices(c: int, heads: int, hidden: int, device: torch.device):
    """For each element of ``pack_block_tiles``' weight stream and of its
    bias vector, the index in the flat sources it gathers from: weights
    [wqkv (q rows pre-scaled) | wproj | wfc1 | wfc2 | 0], biases [bqkv
    (q pre-scaled) | bproj | bfc1 | bfc2 | 0], the trailing zero for the
    padding; so that packing is a few ops a block (training packs every
    block on every step)."""
    from tpu_superresolution_torch.kernels.cab_conv import _swizzle_rows

    lay = stream_layout(c, heads, hidden)
    hd, hdp, kc, halves, chunks = c // heads, lay.hdp, lay.kc, lay.halves, lay.chunks
    k, n_out, hid, pw = kc * 64, lay.cp, chunks * BLOCK_HC, lay.pw
    zero = 4 * c * c + 2 * hidden * c
    pad = lambda t, p, z=zero: F.pad(t, p, value=z)
    at = lambda n, start: torch.arange(start, start + n)
    wq = pad(at(3 * c * c, 0).reshape(3, heads, hd, c).transpose(0, 1), (0, k - c, 0, hdp - hd))
    qkv = wq.reshape(heads, 3 * hdp, kc, 64).transpose(1, 2)  # [heads, kc, 3 hdp, 64]
    wp = pad(at(c * c, 3 * c * c).reshape(c, heads, hd), (0, hdp - hd)).reshape(c, heads * hdp)
    wp = pad(wp, (0, k - heads * hdp, 0, n_out - c))
    proj = wp.reshape(halves, pw, kc, 64).transpose(1, 2)  # [halves, kc, pw, 64]
    w1 = pad(at(hidden * c, 4 * c * c).reshape(hidden, c), (0, k - c, 0, hid - hidden))
    fc1 = w1.reshape(chunks, BLOCK_HC, kc, 64).transpose(1, 2)  # [chunks, kc, 64, 64]
    w2 = pad(at(c * hidden, 4 * c * c + hidden * c).reshape(c, hidden),
             (0, hid - hidden, 0, n_out - c))
    fc2 = w2.reshape(halves, pw, chunks, 64).permute(2, 0, 1, 3)  # [chunks, halves, pw, 64]
    per_chunk = lambda t: _swizzle_rows(t).reshape(chunks, -1)
    tiles = torch.cat([_swizzle_rows(qkv).reshape(-1), _swizzle_rows(proj).reshape(-1),
                       torch.cat([per_chunk(fc1), per_chunk(fc2)], dim=1).reshape(-1)])
    bz = 5 * c + hidden
    bq = pad(at(3 * c, 0).reshape(3, heads, hd).transpose(0, 1), (0, hdp - hd), bz)
    bias = torch.cat([bq.reshape(-1), pad(at(c, 3 * c), (0, n_out - c), bz),
                      pad(at(hidden, 4 * c), (0, hid - hidden), bz),
                      pad(at(c, 4 * c + hidden), (0, n_out - c), bz)])
    q_scale = torch.ones(3 * c, 1)
    q_scale[:c] = (c // heads) ** -0.5
    return tiles.to(device), bias.to(device), q_scale.to(device)


@torch.no_grad()
def pack_block_tiles(w: SwinBlockWeights, dtype: torch.dtype = torch.bfloat16
                     ) -> PackedBlockTiles:
    """Lay one block's weights out for the forward kernel: once per loaded
    weights at inference (``SwinBlock``'s cache), once per step in
    training (two gathers from the flat weights and biases).  `dtype`
    float32 keeps the weights unrounded (the CPU tests' emulation of the
    kernel).  Takes the block kernel's widths and K5r's
    (``stream_layout``)."""
    if w.bqkv is None:
        raise ValueError("swin_block kernels take qkv_bias=True only")
    c, nh, hidden = w.dim, w.num_heads, int(w.wfc1.shape[0])
    lay = stream_layout(c, nh, hidden)
    dev = w.wqkv.device
    tile_idx, bias_idx, q_scale = _tile_indices(c, nh, hidden, dev)
    f = lambda t: t.detach().float()
    zero = torch.zeros(1, device=dev)
    src = torch.cat([(f(w.wqkv) * q_scale).reshape(-1), f(w.wproj).reshape(-1),
                     f(w.wfc1).reshape(-1), f(w.wfc2).reshape(-1), zero])
    bsrc = torch.cat([f(w.bqkv) * q_scale[:, 0], f(w.bproj), f(w.bfc1), f(w.bfc2), zero])
    bias = bsrc[bias_idx]
    n_q, n_out, hid = nh * 3 * lay.hdp, lay.cp, lay.chunks * BLOCK_HC
    return PackedBlockTiles(
        tiles=src.to(dtype)[tile_idx], bqkv=bias[:n_q], bproj=bias[n_q:n_q + n_out],
        bfc1=bias[n_q + n_out:n_q + n_out + hid], bfc2=bias[n_q + n_out + hid:],
        g1=f(w.g1).contiguous(), b1=f(w.b1).contiguous(), g2=f(w.g2).contiguous(),
        b2=f(w.b2).contiguous(), table=f(w.table).t().contiguous(), dim=c, num_heads=nh,
        hidden=hidden, window_size=w.window_size, layout=lay)


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
    """The WMMA tail kernel's operands (``csrc/swin_tail.cu``, route
    "wmma"): bf16 [out, in] MLP weights zero-padded to multiples of 16
    (CK = C, HK = hidden rounded up), fp32 biases padded alike, fp32 LN2
    params."""

    wfc1: torch.Tensor  # [HK, CK] bf16
    bfc1: torch.Tensor  # [HK] fp32
    wfc2: torch.Tensor  # [CK, HK] bf16
    bfc2: torch.Tensor  # [CK] fp32
    g2: torch.Tensor
    b2: torch.Tensor
    dim: int
    hidden: int
    route = "wmma"


@dataclasses.dataclass(frozen=True)
class PackedTailWg:
    """The wgmma tail kernel's operands (``csrc/swin_tail_wg.cu``, route
    "wgmma"): `tiles`, the weight stream: per 64-column hidden chunk j,
    fc1's rows 64 j .. 64 j + 63 as CP/64 [64, 64] K-major tiles (K chunk
    outer), then fc2's [CP, 64] tile of hidden columns 64 j .., each tile
    128B-swizzled (16-byte chunk i of row n at i ^ (n % 8)), zero past C
    and the hidden width (the chunks an even number); `vec`, fp32 g2, b2,
    bfc2 [CP] and bfc1 [chunks 64], zero-padded."""

    tiles: torch.Tensor
    vec: torch.Tensor
    dim: int
    hidden: int
    route = "wgmma"


TAIL_WG_MAX_C = 256   # csrc/swin_tail_wg.cu: its widths (CP 64 .. 256)
TAIL_WG_STAGES = 8    # its ring's most stages
TAIL_WG_ROWS = 64     # pixels a unit (the wgmma m64)


def tail_route(c: int, hidden: int) -> str:
    """The kernel of K1's tail at C channels and MLP hidden `hidden`:
    "wgmma" (``csrc/swin_tail_wg.cu``) for C <= 256 at any hidden, else
    "wmma" (``csrc/swin_tail.cu``, any C: ``tail_rows``, ``tail_spills``).  Static
    shapes only, the same on every call and device; a launch never
    falls back from one to the other."""
    if c < 1 or hidden < 1:
        raise ValueError(f"tail_route: C={c}, hidden={hidden}")
    return "wgmma" if c <= TAIL_WG_MAX_C else "wmma"


def _pad64(v: int) -> int:
    return -(-v // 64) * 64


def _tail_wg_chunks(hidden: int) -> int:
    """The wgmma tail kernel's 64-column hidden chunks: an even number
    (its MLP runs them in pairs; a last odd chunk is zero)."""
    return -(-hidden // 128) * 2


def _tail_wg_rsb(c: int) -> int:
    """Bytes between two staging rows of the wgmma tail kernel: the row's
    ceil(C / 2) words rounded up to 8 k + 4 (16 (2 k + 1) bytes), so that
    8 rows x 4 words of a warp's reads hit 32 banks."""
    words = -(-c // 2)
    return 4 * (words + (12 - words % 8) % 8)


@dataclasses.dataclass(frozen=True)
class TailWgPlan:
    """How csrc/swin_tail_wg.cu runs one call: padded width `cp`, 64-column
    hidden `chunks` (even), staging row stride `rsb` bytes, `units` of 64 rows
    of the flat map over `grid` persistent CTAs, `stages` ring stages of
    cp x 128 bytes, `smem` bytes of shared memory a CTA."""

    cp: int
    chunks: int
    rsb: int
    units: int
    grid: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=256)
def tail_wg_plan(b: int, h: int, w: int, c: int, hidden: int, extra: bool,
                 sms: int) -> TailWgPlan:
    """The wgmma tail kernel's plan for x [B, H, W, C] (with or without
    `extra`) on a card of `sms` SMs, from static shapes alone (its C
    entry only checks it): the ring gets what shared memory leaves after
    the LN2 / output buffer, two GELU chunks, the staging (x and extra at
    rows of C rounded up to even, attn at `rsb` bytes a row), the row sums
    and g2 / b2 / bfc2, at most 8 stages (C 180 with extra: 4; C 240
    without: 3).  Raises ValueError outside the kernel's widths."""
    if tail_route(c, hidden) != "wgmma":
        raise ValueError(f"tail_wg_plan: C={c} is past the wgmma tail kernel's {TAIL_WG_MAX_C}")
    cp, rsb = _pad64(c), _tail_wg_rsb(c)
    stage = cp * 128
    fixed = (1024 + stage + 2 * 8192 + (2 if extra else 1) * TAIL_WG_ROWS * 2 * (c + c % 2)
             + TAIL_WG_ROWS * rsb + 2 * TAIL_WG_ROWS * 8 + 3 * cp * 4
             + (2 * TAIL_WG_STAGES + 2) * 8)
    stages = min(TAIL_WG_STAGES, (TAIL_SMEM - fixed) // stage)
    units = -(-(b * h * w) // TAIL_WG_ROWS)
    return TailWgPlan(cp=cp, chunks=_tail_wg_chunks(hidden), rsb=rsb, units=units,
                      grid=max(1, min(units, sms)), stages=stages, smem=fixed + stages * stage)


@functools.lru_cache(maxsize=64)
def _tail_wg_indices(c: int, hidden: int, device: torch.device):
    """For each element of ``PackedTailWg``'s `tiles` and `vec`, its index
    in the flat sources [wfc1 | wfc2 | 0] and [g2 | b2 | bfc2 | bfc1 | 0]
    (the trailing zero for the padding): packing is two gathers."""
    from tpu_superresolution_torch.kernels.cab_conv import _swizzle_rows

    cp, chunks = _pad64(c), _tail_wg_chunks(hidden)
    hp, kc = chunks * 64, cp // 64
    zero, vzero = 2 * hidden * c, 3 * c + hidden
    pad = lambda t, p, z: F.pad(t, p, value=z)
    w1 = pad(torch.arange(hidden * c).reshape(hidden, c), (0, cp - c, 0, hp - hidden), zero)
    fc1 = w1.reshape(chunks, 64, kc, 64).transpose(1, 2)  # [chunks, kc, 64 rows, 64 K]
    w2 = pad(torch.arange(hidden * c, 2 * hidden * c).reshape(c, hidden),
             (0, hp - hidden, 0, cp - c), zero)
    fc2 = w2.reshape(cp, chunks, 64).transpose(0, 1)  # [chunks, cp rows, 64 K]
    tiles = torch.cat([_swizzle_rows(fc1).reshape(chunks, -1),
                       _swizzle_rows(fc2).reshape(chunks, -1)], dim=1).reshape(-1)
    vec = torch.cat([pad(torch.arange(i * c, (i + 1) * c), (0, cp - c), vzero) for i in range(3)]
                    + [pad(torch.arange(3 * c, 3 * c + hidden), (0, hp - hidden), vzero)])
    return tiles.to(device), vec.to(device)


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def _tail_smem(c: int, t: int) -> int:
    """The WMMA tail kernel's shared memory at T = t pixels a block: x1
    fp32 and LN2's output bf16 per row, the 128-column hidden chunk, the
    rows' m2 and the warps' epilogue tiles."""
    ck = _round16(c)
    return t * ck * 4 + t * (ck + 8) * 2 + t * 136 * 2 + t * 4 + 8 * 256 * 4


def tail_rows(c: int) -> int:
    """The WMMA tail kernel's pixels a block at C channels: the most of
    64, 32 and 16 whose shared memory fits (C <= 528, 1104 and 2272), and
    16 past that, where x1 and LN2's output go to a global scratch
    (``tail_spills``): any C."""
    return next((t for t in TAIL_ROWS if _tail_smem(c, t) <= TAIL_SMEM), TAIL_ROWS[-1])


def tail_spills(c: int) -> bool:
    """Whether the WMMA tail kernel keeps x1 and LN2's output in a global
    scratch slice a CTA (C past 2272: 16 rows do not fit its shared
    memory), on a persistent grid of TAIL_SPILL_CTAS CTAs an SM."""
    return _tail_smem(c, TAIL_ROWS[-1]) > TAIL_SMEM


def tail_scratch_bytes(c: int) -> int:
    """A spilling CTA's scratch: [16][CK] fp32 x1 and [16][CK + 8] bf16
    LN2 output (csrc/swin_tail.cu scratch_bytes)."""
    ck, t = _round16(c), TAIL_ROWS[-1]
    return t * ck * 4 + t * (ck + 8) * 2


@torch.no_grad()
def pack_block_tail(g2, b2, wfc1, bfc1, wfc2, bfc2, route: Optional[str] = None,
                    dtype: torch.dtype = torch.bfloat16):
    """Lay the raw LN2 and MLP weights out for the tail kernel of `route`
    (default ``tail_route``'s): once per loaded weights at inference, on
    every call in training.  "wgmma": ``PackedTailWg`` by two gathers from
    cached indices, `dtype` the weights' (float32 keeps them unrounded:
    the CPU tests' emulation of the kernel); "wmma": ``PackedBlockTail``."""
    hidden, c = int(wfc1.shape[0]), int(wfc1.shape[1])
    route = route or tail_route(c, hidden)
    f = lambda t: t.detach().float()
    if route == "wgmma":
        if c > TAIL_WG_MAX_C:
            raise ValueError(f"pack_block_tail: C={c} is past the wgmma tail kernel")
        tidx, vidx = _tail_wg_indices(c, hidden, wfc1.device)
        zero = torch.zeros(1, device=wfc1.device)
        src = torch.cat([f(wfc1).reshape(-1), f(wfc2).reshape(-1), zero])
        vsrc = torch.cat([f(g2), f(b2), f(bfc2), f(bfc1), zero])
        return PackedTailWg(tiles=src.to(dtype)[tidx], vec=vsrc[vidx], dim=c, hidden=hidden)
    if route != "wmma":
        raise ValueError(f"pack_block_tail: route {route!r} is neither 'wgmma' nor 'wmma'")
    ck, hk = _round16(c), _round16(hidden)
    bf = torch.bfloat16
    return PackedBlockTail(
        wfc1=F.pad(f(wfc1), (0, ck - c, 0, hk - hidden)).to(bf).contiguous(),
        bfc1=F.pad(f(bfc1), (0, hk - hidden)).contiguous(),
        wfc2=F.pad(f(wfc2), (0, hk - hidden, 0, ck - c)).to(bf).contiguous(),
        bfc2=F.pad(f(bfc2), (0, ck - c)).contiguous(),
        g2=f(g2).contiguous(), b2=f(b2).contiguous(), dim=c, hidden=hidden)


def _check_tail_args(x, attn, packed, ws, shift, scales, extra):
    """The shapes, dtypes and alignments both tail kernels take; returns
    (b, h, w, c)."""
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
    windows = b * (h // ws) * (wd // ws)
    _lib.check_tensor(attn, "attn", bf, dev, shape=(windows, ws * ws, c), align=2)
    if extra is not None:
        _lib.check_tensor(extra, "extra", bf, dev, shape=tuple(x.shape), align=2)
    if scales is not None:
        _lib.check_tensor(scales, "branch_scales", f32, dev, shape=(b, 2), align=4)
    return b, h, wd, c


def _launch_tail_wmma(x, attn, packed: PackedBlockTail, ws, shift, gelu_approx, scales,
                      extra) -> torch.Tensor:
    """One launch of the WMMA tail kernel (``csrc/swin_tail.cu``)."""
    b, h, wd, c = _check_tail_args(x, attn, packed, ws, shift, scales, extra)
    dev = x.device
    bf, f32 = torch.bfloat16, torch.float32
    ck, hk = _round16(c), _round16(packed.hidden)
    for tname, t, shape, dtype, align in (
            ("wfc1", packed.wfc1, (hk, ck), bf, 32), ("bfc1", packed.bfc1, (hk,), f32, 16),
            ("wfc2", packed.wfc2, (ck, hk), bf, 32), ("bfc2", packed.bfc2, (ck,), f32, 16),
            ("g2", packed.g2, (c,), f32, 4), ("b2", packed.b2, (c,), f32, 4)):
        _lib.check_tensor(t, tname, dtype, dev, shape=shape, align=align)
    y = torch.empty_like(x)
    rows, grid, scratch = tail_rows(c), 0, None
    if tail_spills(c):
        grid = max(1, min(-(-(b * h * wd) // rows), TAIL_SPILL_CTAS * _lib.sm_count(dev.index)))
        scratch = torch.empty(grid * tail_scratch_bytes(c), dtype=torch.uint8, device=dev)
        _lib.check_tensor(scratch, "scratch", torch.uint8, dev, align=256)
    status = _lib.call(x, _lib.library().sr_swin_tail_bf16,
                       x.data_ptr(), attn.data_ptr(), _ptr(extra), y.data_ptr(),
                       packed.g2.data_ptr(), packed.b2.data_ptr(), packed.wfc1.data_ptr(),
                       packed.bfc1.data_ptr(), packed.wfc2.data_ptr(), packed.bfc2.data_ptr(),
                       _ptr(scales), _ptr(scratch), b, h, wd, c, packed.hidden, ws, shift,
                       int(bool(gelu_approx)), LN_EPS, rows, grid, _lib.stream_of(x))
    _lib.check_status(status, "sr_swin_tail_bf16")
    return y


@functools.lru_cache(maxsize=256)
def _tail_wg_geometry(b, h, w, c, hidden, extra, ws, shift, gelu_approx, sms):
    p = tail_wg_plan(b, h, w, c, hidden, extra, sms)
    return p, (ctypes.c_int * 14)(b, h, w, c, hidden, p.cp, p.chunks, ws, shift, p.units, p.grid,
                                  p.stages, p.rsb, int(bool(gelu_approx)))


def _launch_tail_wg(x, attn, packed: PackedTailWg, ws, shift, gelu_approx, scales,
                    extra) -> torch.Tensor:
    """One launch of the wgmma tail kernel (``csrc/swin_tail_wg.cu``) on
    ``tail_wg_plan``'s plan."""
    b, h, wd, c = _check_tail_args(x, attn, packed, ws, shift, scales, extra)
    dev = x.device
    plan, geo = _tail_wg_geometry(b, h, wd, c, packed.hidden, extra is not None, ws, shift,
                                  bool(gelu_approx), _lib.sm_count(dev.index))
    _lib.check_tensor(packed.tiles, "tiles", torch.bfloat16, dev,
                      shape=(plan.chunks * 2 * plan.cp * 64,), align=16)
    _lib.check_tensor(packed.vec, "vec", torch.float32, dev,
                      shape=(3 * plan.cp + plan.chunks * 64,), align=16)
    x1ws = (torch.empty(plan.grid * TAIL_WG_ROWS * plan.cp, dtype=torch.float32, device=dev)
            if plan.cp == TAIL_WG_MAX_C else None)
    y = torch.empty_like(x)
    status = _lib.call(x, _lib.library().sr_swin_tail_wg_bf16,
                       x.data_ptr(), attn.data_ptr(), _ptr(extra), y.data_ptr(),
                       packed.tiles.data_ptr(), packed.vec.data_ptr(), _ptr(scales), _ptr(x1ws),
                       geo, LN_EPS, _lib.stream_of(x))
    _lib.check_status(status, "sr_swin_tail_wg_bf16")
    return y


def _launch_tail(x, attn, packed, ws, shift, gelu_approx, scales, extra) -> torch.Tensor:
    """One launch of the tail kernel `packed` was laid out for, counted
    as K1t."""
    launch = _launch_tail_wg if packed.route == "wgmma" else _launch_tail_wmma
    y = launch(x, attn, packed, ws, shift, gelu_approx, scales, extra)
    launches_tail.count += 1
    return y


class BlockTailFunction(torch.autograd.Function):
    """Forward K1's tail kernel of ``tail_route`` (weights packed on every
    call), backward autograd of its plain version."""

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
                     packed: Optional[PackedBlockTail | PackedTailWg] = None) -> torch.Tensor:
    """K1's tail on the K7 route (see ``swin_block_tail_plain``).  CPU
    tensor -> plain version; CUDA tensor -> the kernel ``tail_route``
    names (bf16 x, attn and extra, fp32 branch scales), through
    ``BlockTailFunction`` when a gradient is wanted.  `packed`
    (``pack_block_tail``'s; inference only) skips the per-call packing,
    and its route is the kernel launched."""
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


def _check_tiles(packed: PackedBlockTiles, x: torch.Tensor, scales, name: str,
                 extra: Optional[torch.Tensor] = None) -> None:
    b, h, wd, c = x.shape
    if packed.dim != c:
        raise ValueError(f"{name}: weights for C={packed.dim}, x has C={c}")
    dev = x.device
    plan = packed.layout
    n_tiles = (packed.num_heads * plan.kc * 3 * plan.hdp + plan.halves * plan.kc * plan.pw
               + plan.chunks * (plan.kc * BLOCK_HC + plan.halves * plan.pw)) * 64
    bf, f32 = torch.bfloat16, torch.float32
    # the tiles go by bulk copies (16-byte aligned), the biases as float2
    for tname, t, shape, dtype, align in (
        ("tiles", packed.tiles, (n_tiles,), bf, 16),
        ("bqkv", packed.bqkv, (packed.num_heads * 3 * plan.hdp,), f32, 8),
        ("bproj", packed.bproj, (plan.cp,), f32, 8),
        ("bfc1", packed.bfc1, (plan.chunks * BLOCK_HC,), f32, 8),
        ("bfc2", packed.bfc2, (plan.cp,), f32, 8),
        ("g1", packed.g1, (c,), f32, 4),
        ("b1", packed.b1, (c,), f32, 4),
        ("g2", packed.g2, (c,), f32, 4),
        ("b2", packed.b2, (c,), f32, 4),
        ("table", packed.table, (packed.num_heads, (2 * packed.window_size - 1) ** 2), f32, 4),
    ):
        _lib.check_tensor(t, tname, dtype, dev, shape=shape, align=align)
    align = 4 if c % 2 == 0 else 2  # bf16 pairs as one 4-byte access at even C
    _lib.check_tensor(x, "x", bf, dev, ndim=4, align=align)
    if scales is not None:
        _lib.check_tensor(scales, "branch_scales", f32, dev, shape=(b, 2), align=4)
    if extra is not None:
        _lib.check_tensor(extra, "extra", bf, dev, shape=tuple(x.shape), align=align)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_block(x, packed: PackedBlockTiles, shift, mask, gelu_approx, scales,
                  extra=None) -> torch.Tensor:
    """Launch the forward kernel for packed.window_size (ws 8: K1, ws 7:
    K6) on ``block_plan``'s plan and count the launch on that kernel.
    The bias and the mask come from the table and the map's token codes;
    `mask` (``shift_attn_mask``'s, the models' only one) says only
    whether the windows are masked."""
    _check_tiles(packed, x, scales, "fused_windows_block", extra)
    b, h, wd, c = x.shape
    ws, plan = packed.window_size, block_plan(c, packed.num_heads, packed.hidden)
    shifted = mask is not None and shift > 0
    codes = window_codes_tensor(h, wd, ws, shift if shifted else 0, x.device)
    y = torch.empty_like(x)
    status = _lib.call(
        x, _lib.library().sr_swin_block_bf16,
        x.data_ptr(), _ptr(extra), y.data_ptr(), packed.tiles.data_ptr(),
        packed.bqkv.data_ptr(), packed.bproj.data_ptr(), packed.bfc1.data_ptr(),
        packed.bfc2.data_ptr(), packed.g1.data_ptr(), packed.b1.data_ptr(),
        packed.g2.data_ptr(), packed.b2.data_ptr(), packed.table.data_ptr(),
        codes.data_ptr(), _ptr(scales), b, h, wd, c, packed.num_heads, packed.hidden, ws,
        shift, int(shifted), plan.cp, plan.hdp, plan.stages, int(bool(gelu_approx)), LN_EPS,
        _lib.stream_of(x),
    )
    _lib.check_status(status, "sr_swin_block_bf16")
    FORWARD_COUNTERS[ws].count += 1
    return y


# csrc/swin_block_bwd.cu (K5 / K6b): the per-window kernel's (K5a) consumer
# warpgroups, ring stage, workspace tiles, and the weight-gradient GEMM's
# (K5b) CTAs of 64 x <= 192 output tiles, two an SM
BWD_MAX_STAGES = 8
BWD_STAT_BYTES = 1024
BWD_TILE = 64 * 64    # a workspace tile: [64 tokens, 64] bf16, 128B-swizzled
BWD_WG_NTILES = 3     # X tiles a K5b unit
BWD_WG_PER_SM = 2     # K5b CTAs an SM
# the dW operands of the workspace, in the kernel's order (X, then dY)
BWD_OPERANDS = ("yc", "o", "y2c", "act", "dqkv", "dattn", "dh1", "dmlp")


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How csrc/swin_block_bwd.cu runs a block's widths: the forward's
    stream's layout (`cp`, `hdp`, `kc`, `halves`, `chunks`, `pw` as
    ``stream_layout``), K5a's ring `stages` of `pw` x 128 bytes and shared
    memory `smem` a CTA
    (two windows: the A buffer, the R buffer, the head's q, k, v tiles
    and the softmax statistics each; the bias table, the barriers),
    `op_tiles` the [64, 64] workspace tiles a window of each of
    ``BWD_OPERANDS``, `vec_len` the bias and LayerNorm sums' vector
    (bqkv heads 3 hdp | bproj cp | bfc1 chunks 64 | bfc2 cp | g1 | b1 |
    g2 | b2, cp each), `bias_len` its bias part (``pack_block_tiles``'
    bias layout), `stream_len` the weight stream's elements (the weight
    gradients' layout) and `units` K5b's output tiles."""

    cp: int
    hdp: int
    kc: int
    halves: int
    chunks: int
    stages: int
    smem: int
    op_tiles: Tuple[int, ...]
    vec_len: int
    bias_len: int
    stream_len: int
    units: int
    pw: int

    @property
    def window_bytes(self) -> int:
        """Workspace bytes a window (64 token rows of every operand)."""
        return sum(self.op_tiles) * BWD_TILE * 2


@functools.lru_cache(maxsize=64)
def bwd_plan(c: int, heads: int, hidden: int) -> BwdPlan:
    """The backward kernels' plan from static shapes alone (the C entry
    only checks it): the stream's padded widths (``stream_layout``), then
    two windows' buffers (A and R buffers of cp columns in 64-column
    swizzled chunks, q, k, v tiles [64, hdp], 1 KB of statistics), the
    bias table and the barriers, and as many ring stages (a [pw, 64] tile
    each: 12 KB, 16 KB at K5r's widths) as fit, at most 8.  Raises
    ValueError past K5r's widths (C <= 256, <= 8 heads of hd <= 32,
    hidden <= 512)."""
    lay = stream_layout(c, heads, hidden)
    cp, hdp, kc, halves, chunks, pw = lay.cp, lay.hdp, lay.kc, lay.halves, lay.chunks, lay.pw
    window = 2 * kc * 8192 + 3 * 64 * 2 * hdp + BWD_STAT_BYTES
    fixed = 1024 + 2 * window + BLOCK_TABLE_BYTES + 2 * BWD_MAX_STAGES * 8
    stage = pw * 128
    stages = min(BWD_MAX_STAGES, (BLOCK_SMEM - fixed) // stage)
    q3 = 3 * hdp
    qt = -(-heads * q3 // 64)
    op_tiles = (kc, kc, kc, chunks, qt, kc, chunks, kc)
    bias_len = heads * q3 + 2 * cp + chunks * BLOCK_HC
    stream_len = (heads * kc * q3 * 64 + halves * kc * pw * 64
                  + chunks * (kc * 64 * 64 + halves * pw * 64))
    groups = lambda n: -(-n // BWD_WG_NTILES)
    units = qt * groups(kc) + kc * groups(kc) + chunks * groups(kc) + kc * groups(chunks)
    return BwdPlan(cp=cp, hdp=hdp, kc=kc, halves=halves, chunks=chunks, stages=stages,
                   smem=fixed + stages * stage, op_tiles=op_tiles,
                   vec_len=bias_len + 4 * cp, bias_len=bias_len, stream_len=stream_len,
                   units=units, pw=pw)


def bwd_grid(plan: BwdPlan, windows: int, sms: int) -> Tuple[int, int]:
    """(K5a's CTAs, K5b's splits over the windows) for `windows` windows
    on `sms` SMs: one CTA an SM at most, one window pair each at least;
    about two K5b CTAs an SM."""
    pairs = -(-windows // 2)
    splits = max(1, min(windows, round(BWD_WG_PER_SM * sms / plan.units)))
    return max(1, min(pairs, sms)), splits


def bwd_bytes(plan: BwdPlan, windows: int, heads: int, grid: int, splits: int) -> dict:
    """Bytes of each buffer the backward allocates (the workspace, x1's
    scratch, the partials) at `windows` windows."""
    return {"workspace": windows * plan.window_bytes,
            "x1 scratch": grid * 2 * 64 * plan.cp * 4,
            "LN sums partials": grid * 2 * 4 * 4 * plan.cp * 4,
            "rpb partials": grid * 2 * heads * 64 * 64 * 4,
            "weight partials": splits * (plan.stream_len + plan.bias_len) * 4}


# the raw gradients ``fold_block_grads`` returns, in the order of its flat vector
FOLD_FIELDS = ("wqkv", "wproj", "wfc1", "wfc2", "bqkv", "bproj", "bfc1", "bfc2",
               "g1", "b1", "g2", "b2")


@functools.lru_cache(maxsize=64)
def _fold_indices(c: int, heads: int, hidden: int, device: torch.device):
    """For each raw weight, bias and LN entry (FOLD_FIELDS' order, flat),
    its position in the backward's [weight stream | sums' vector]
    gradient (each real entry sits there exactly once: ``_tile_indices``
    gathers the other way), and the factor it takes (q's pre-scale)."""
    plan = bwd_plan(c, heads, hidden)
    tile_idx, bias_idx, q_scale = _tile_indices(c, heads, hidden, torch.device("cpu"))
    pos = []
    for idx, n_src, base in ((tile_idx, 4 * c * c + 2 * hidden * c, 0),
                             (bias_idx, 5 * c + hidden, plan.stream_len)):
        real = idx < n_src
        p = torch.empty(n_src, dtype=torch.long)
        p[idx[real]] = torch.arange(idx.numel())[real] + base
        pos.append(p)
    ln = plan.stream_len + plan.bias_len + (
        torch.arange(4)[:, None] * plan.cp + torch.arange(c)[None, :]).reshape(-1)
    factor = torch.ones(4 * c * c + 2 * hidden * c + 5 * c + hidden + 4 * c)
    factor[:3 * c * c] = q_scale.expand(3 * c, c).reshape(-1)
    bq = 4 * c * c + 2 * hidden * c
    factor[bq:bq + 3 * c] = q_scale[:, 0]
    return torch.cat(pos + [ln]).to(device), factor.to(device)


def fold_block_grads(gv: torch.Tensor, rpb: torch.Tensor, c: int, heads: int, hidden: int,
                     ws: int) -> dict:
    """The backward's gradients in the forward's tile space -> raw
    [out, in] parameter gradients.  `gv` is [the weight stream's
    gradient | the sums' vector] (``bwd_plan``'s stream_len + vec_len):
    each raw weight's gradient is its entry of the stream's gradient (the
    transpose of ``_tile_indices``' gather, pad entries dropped), the q
    rows times the pre-scale; the biases likewise from the vector's bias
    part, the LN params from its tail; one gather and one multiply.
    d(rpb) [heads, N, N] from the [heads, 64, 64] token-padded one (ws
    7 / 8) or as it is (ws 16: [heads, 256, 256])."""
    idx, factor = _fold_indices(c, heads, hidden, gv.device)
    flat = gv[idx].mul_(factor)
    shapes = dict(wqkv=(3 * c, c), wproj=(c, c), wfc1=(hidden, c), wfc2=(c, hidden),
                  bqkv=(3 * c,), bproj=(c,), bfc1=(hidden,), bfc2=(c,), g1=(c,), b1=(c,),
                  g2=(c,), b2=(c,))
    out, off = {}, 0
    for k in FOLD_FIELDS:
        n = math.prod(shapes[k])
        out[k] = flat[off:off + n].reshape(shapes[k])
        off += n
    n = ws * ws
    out["rpb"] = rpb.reshape(heads, n, n) if n > N_TOK else rpb.reshape(heads, 64, 64)[:, :n, :n]
    return out


def _launch_bwd(ct, x, packed: PackedBlockTiles, shift, mask, gelu_approx, scales, extra=None):
    """Run the block backward for packed.window_size (ws 8: K5, ws 7:
    K6b) on the forward's weight stream: K5a (the per-window kernel),
    K5b (the weight-gradient GEMM) and K5c (the ordered sums) on
    ``bwd_plan``'s plan.  Returns (dx, raw-space fp32 gradients, d extra
    or None) and counts the launch on that window's counter.  `mask`
    (``shift_attn_mask``'s) says only whether the windows are masked:
    the bias and the mask come from the table and the map's codes."""
    name = "fused_swin_block_backward"
    _check_tiles(packed, x, scales, name, extra)
    _lib.check_tensor(ct, "ct", torch.bfloat16, x.device, shape=tuple(x.shape),
                      align=4 if x.shape[3] % 2 == 0 else 2)
    b, h, wd, c = x.shape
    nh, ws, hidden = packed.num_heads, packed.window_size, packed.hidden
    plan = bwd_plan(c, nh, hidden)
    windows = b * (h // ws) * (wd // ws)
    dev = x.device
    grid, splits = bwd_grid(plan, windows, _lib.sm_count(dev.index))
    shifted = mask is not None and shift > 0
    codes = window_codes_tensor(h, wd, ws, shift if shifted else 0, dev)
    dx = torch.empty_like(x)
    dextra = None if extra is None else torch.empty_like(x)
    sizes = bwd_bytes(plan, windows, nh, grid, splits)
    wsp = torch.empty(sizes["workspace"] // 2, dtype=torch.bfloat16, device=dev)
    # one fp32 allocation: x1's scratch, the three partials, then the outputs
    # [the weight stream's gradient | the sums' vector] and d(rpb), 16-byte aligned
    lens = [sizes[k] // 4 for k in ("x1 scratch", "LN sums partials", "rpb partials",
                                    "weight partials")]
    lens += [plan.stream_len + plan.vec_len, nh * 64 * 64]
    lens = [-(-n // 4) * 4 for n in lens]
    x1ws, pvec, prpb, pw, gv, rpb = torch.empty(sum(lens), dtype=torch.float32,
                                                device=dev).split(lens)
    wgrad, vec = gv[:plan.stream_len], gv[plan.stream_len:]
    geo = (ctypes.c_int * 15)(b, h, wd, c, nh, hidden, ws, shift, int(shifted), plan.cp,
                              plan.hdp, plan.stages, int(bool(gelu_approx)), grid, splits)
    status = _lib.call(
        x, _lib.library().sr_swin_block_bwd_bf16,
        ct.data_ptr(), x.data_ptr(), _ptr(extra), dx.data_ptr(), _ptr(dextra),
        packed.tiles.data_ptr(), packed.bqkv.data_ptr(), packed.bproj.data_ptr(),
        packed.bfc1.data_ptr(), packed.bfc2.data_ptr(), packed.g1.data_ptr(),
        packed.b1.data_ptr(), packed.g2.data_ptr(), packed.b2.data_ptr(),
        packed.table.data_ptr(), codes.data_ptr(), _ptr(scales), wsp.data_ptr(),
        x1ws.data_ptr(), pvec.data_ptr(), prpb.data_ptr(), pw.data_ptr(), vec.data_ptr(),
        rpb.data_ptr(), wgrad.data_ptr(), geo, LN_EPS, _lib.stream_of(x))
    _lib.check_status(status, "sr_swin_block_bwd_bf16")
    BACKWARD_COUNTERS[ws].count += 1
    return dx, fold_block_grads(gv, rpb, c, nh, hidden, ws), dextra


def fused_swin_block_backward(ct: torch.Tensor, x: torch.Tensor, w: SwinBlockWeights, ws: int,
                              shift: int, mask: Optional[torch.Tensor], gelu_approx: bool,
                              branch_scales: Optional[torch.Tensor] = None,
                              packed=None,
                              extra: Optional[torch.Tensor] = None) -> SwinBlockGrads:
    """The backward of one Swin block for the cotangent `ct` (K5 at ws 8,
    K6b at ws 7, K5w16 at ws 16, K5r at ws 8 past the block kernel's
    widths; d`extra` when the forward had `extra`).  CPU tensors -> plain
    version; CUDA tensors -> the kernel (bf16 ct, x and extra, fp32
    branch scales), gradients in raw weight space.  `packed`: the
    forward's ``pack_block_tiles(w)`` (built here when None)."""
    if x.device.type == "cpu":
        return swin_block_bwd_plain(ct, x, w, ws, shift, mask, gelu_approx, branch_scales, extra)
    name = "fused_swin_block_backward"
    tiled = ws == BWD16_WINDOW or k5r_ok(ws, w.dim, w.num_heads, int(w.wfc1.shape[0]),
                                         w.bqkv is not None)
    if tiled:
        _lib.require_cuda(x, name)
        check_tiled_bwd_args(tuple(x.shape), w, ws, shift, name)
        _lib.check_tensor(x, "x", torch.bfloat16, x.device, ndim=4, align=2)
    else:
        _check_block_input(x, w, ws, shift, name)
    if branch_scales is not None:
        branch_scales = branch_scales.float().contiguous()
    if extra is not None:
        extra = extra.contiguous()
    packed = packed if packed is not None else pack_block_tiles(w)
    launch = _launch_bwd_tiled if tiled else _launch_bwd
    dx, g, dextra = launch(ct.contiguous(), x, packed, shift, mask, gelu_approx, branch_scales,
                           extra)
    return SwinBlockGrads(dx=dx, extra=dextra, **g)


def check_tiled_bwd_args(shape: Sequence[int], w: SwinBlockWeights, ws: int, shift: int,
                         name: str) -> None:
    """Raise unless an x of `shape` [B, H, W, C] with window `ws`,
    `shift` and the weights `w` fit K5w16 (ws 16, ``k5w16_ok``) or K5r
    (ws 8, ``k5r_ok``); shapes only, so it runs on any device."""
    kernel = {BWD16_WINDOW: "K5w16", K5R_WINDOW: "K5r"}.get(ws)
    if kernel is None:
        raise ValueError(f"{name}: no tiled block backward at ws={ws}")
    if len(shape) != 4 or shape[1] % ws or shape[2] % ws or not 0 <= shift < ws:
        raise ValueError(f"{name}: {kernel} takes x [B, H, W, C] of whole {ws} x {ws} windows "
                         f"and a shift in [0, {ws}); got {tuple(shape)}, shift {shift}")
    if w.window_size != ws or shape[3] != w.dim:
        raise ValueError(f"{name}: weights for C={w.dim}, ws={w.window_size}; x {tuple(shape)} "
                         f"at ws={ws}")
    ok = k5w16_ok if ws == BWD16_WINDOW else k5r_ok
    if not ok(ws, w.dim, w.num_heads, int(w.wfc1.shape[0]), w.bqkv is not None):
        raise ValueError(f"{name}: {kernel} does not take C={w.dim}, heads={w.num_heads}, "
                         f"hidden={int(w.wfc1.shape[0])}, qkv_bias={w.bqkv is not None}")


# csrc/swin_block_bwd16.cu (K5w16, K5r): the attention kernels' bias table
# of one head, and the windows of a stage: one 256-token window at ws 16,
# four 64-token windows at ws 8 (a consumer warpgroup's query tiles
# either way: two)
BWD16_TABLE_BYTES = 4096
TILED_WINDOWS_A_STAGE = {16: 1, 8: 4}
TILED_COUNTERS = {16: launches_bwd_w16, 8: launches_bwd_r}


@dataclasses.dataclass(frozen=True)
class TiledBwdPlan:
    """How csrc/swin_block_bwd16.cu runs a tiled block backward (K5w16 at
    ws 16, K5r at ws 8) over `windows` windows: `block`, K5a's plan
    (``bwd_plan``), whose three token-local launches take the windows'
    `units` 64-token tiles on `grid` CTAs; K5b's `splits` over the units;
    the attention kernels' `cph` CTAs a head, walking `groups` stages of
    `wps` windows (one at ws 16, four at ws 8; `att_units` (window, head)
    units in all) in `rounds` rounds, the last on `tail_ctas` CTAs; their
    shared memory a CTA (`att_fwd_smem`, `att_bwd_smem`: two stages of the
    windows' [ws^2, hdp] head tiles, the backward's with do and the row
    statistics, one head's bias table)."""

    block: BwdPlan
    windows: int
    units: int
    grid: int
    splits: int
    cph: int
    att_units: int
    rounds: int
    tail_ctas: int
    att_fwd_smem: int
    att_bwd_smem: int
    ws: int
    wps: int
    groups: int


def _tiled_plan(ws: int, c: int, heads: int, hidden: int, windows: int, sms: int) -> TiledBwdPlan:
    plan = bwd_plan(c, heads, hidden)
    n = ws * ws
    wps = TILED_WINDOWS_A_STAGE[ws]
    units = n // 64 * windows
    grid, splits = bwd_grid(plan, units, sms)
    groups = -(-windows // wps)
    cph = max(1, min(groups, sms // heads))
    rounds = -(-groups // cph)
    tile = n * 2 * plan.hdp
    smem = lambda stage: 1024 + 2 * stage + BWD16_TABLE_BYTES + 4 * 8
    return TiledBwdPlan(block=plan, windows=windows, units=units, grid=grid, splits=splits, cph=cph,
                     att_units=windows * heads, rounds=rounds,
                     tail_ctas=heads * (groups - (rounds - 1) * cph),
                     att_fwd_smem=smem(wps * 3 * tile),
                     att_bwd_smem=smem(wps * (4 * tile + 3 * n * 4)), ws=ws, wps=wps,
                     groups=groups)


@functools.lru_cache(maxsize=64)
def bwd16_plan(c: int, heads: int, hidden: int, windows: int, sms: int) -> TiledBwdPlan:
    """K5w16's plan from static shapes alone (the C entry only checks
    it).  Raises ValueError outside ``k5w16_ok``'s widths (C <= 192, <= 6
    heads of hd <= 32, hidden <= 384)."""
    if not k5w16_ok(BWD16_WINDOW, c, heads, hidden):
        raise ValueError(f"K5w16 takes C <= {CP}, <= {MAX_HEADS} heads of hd <= {HDP}, hidden "
                         f"<= {HIDP}; got C={c}, heads={heads}, hidden={hidden}")
    return _tiled_plan(BWD16_WINDOW, c, heads, hidden, windows, sms)


@functools.lru_cache(maxsize=64)
def k5r_plan(c: int, heads: int, hidden: int, windows: int, sms: int) -> TiledBwdPlan:
    """K5r's plan from static shapes alone (the C entry only checks it):
    K5a's ws-8 modes at cp 256 / hdp 32 over a unit a window, the
    attention over stages of four windows.  Raises ValueError outside
    ``k5r_ok``'s widths (past the block kernel's, C <= 256, <= 8 heads of
    hd <= 32, hidden <= 512)."""
    if not k5r_ok(K5R_WINDOW, c, heads, hidden):
        raise ValueError(f"K5r takes ws-8 blocks past the block kernel's widths with C <= "
                         f"{K5R_CP}, <= {K5R_HEADS} heads of hd <= {HDP}, hidden <= "
                         f"{K5R_HIDDEN}; got C={c}, heads={heads}, hidden={hidden}")
    return _tiled_plan(K5R_WINDOW, c, heads, hidden, windows, sms)


def tiled_bwd_bytes(p: TiledBwdPlan, heads: int) -> dict:
    """Bytes of each buffer K5w16 / K5r allocates: the dW workspace of
    the units, the head tiles (q, k, v, do), x1's and dx1's per-tile
    scratch (a slice more where the units are odd: the last pair's idle
    twin recomputes into a slice of its own), the row statistics and row term, the LayerNorm sums' partials (the
    middle's and the tail's), the d(rpb) partials (a CTA's [256, 256] a
    head at ws 16, a consumer warpgroup's [64, 64] a head at ws 8) and
    K5b's splits'."""
    plan, n = p.block, p.ws * p.ws
    rpb_rows = p.cph if n > N_TOK else 2 * p.cph
    return {"workspace": p.units * plan.window_bytes,
            "head tiles": p.windows * heads * 4 * n * plan.hdp * 2,
            "dx1 scratch": (p.units + p.units % 2) * 64 * plan.cp * 4,
            "row statistics": p.windows * heads * 3 * n * 4,
            "LN sums partials": 2 * p.grid * 2 * 4 * 4 * plan.cp * 4,
            "rpb partials": rpb_rows * heads * n * n * 4,
            "weight partials": p.splits * (plan.stream_len + plan.bias_len) * 4}


def _launch_bwd_tiled(ct, x, packed: PackedBlockTiles, shift, mask, gelu_approx, scales,
                      extra=None):
    """The tiled block backward on the forward's weight stream (K5w16 at
    ws 16, K5r at ws 8, by packed.window_size): K5a's front, the attention
    forward, K5a's middle, the attention backward, K5a's tail, K5b and K5c
    on ``bwd16_plan`` / ``k5r_plan``'s plan.  Returns (dx, raw-space fp32
    gradients, d extra or None); counts one launch on its counter.
    `mask` (``shift_attn_mask``'s) says only whether the windows are
    masked: the bias and the mask come from the table and the codes."""
    name = "fused_swin_block_backward"
    ws = packed.window_size
    if ws not in TILED_COUNTERS:
        raise ValueError(f"{name}: weights packed for ws={ws}, the tiled backward runs ws 8 / 16")
    _check_tiles(packed, x, scales, name, extra)
    _lib.check_tensor(ct, "ct", torch.bfloat16, x.device, shape=tuple(x.shape),
                      align=4 if x.shape[3] % 2 == 0 else 2)
    b, h, wd, c = x.shape
    nh, hidden = packed.num_heads, packed.hidden
    windows = b * (h // ws) * (wd // ws)
    dev = x.device
    plan_of = bwd16_plan if ws == BWD16_WINDOW else k5r_plan
    p = plan_of(c, nh, hidden, windows, _lib.sm_count(dev.index))
    plan, n = p.block, ws * ws
    shifted = mask is not None and shift > 0
    codes = window_codes_tensor(h, wd, ws, shift if shifted else 0, dev)
    dx = torch.empty_like(x)
    dextra = None if extra is None else torch.empty_like(x)
    sizes = tiled_bwd_bytes(p, nh)
    up = lambda v, m: -(-v // m) * m  # 16-byte aligned pieces
    lens = [up(v, 8) for v in (sizes["workspace"] // 2, windows * nh * 3 * n * plan.hdp,
                               windows * nh * n * plan.hdp)]
    wsp, qkvh, doh = torch.empty(sum(lens), dtype=torch.bfloat16, device=dev).split(lens)
    lens = [up(v, 4) for v in (sizes["dx1 scratch"] // 4, sizes["LN sums partials"] // 4,
                               windows * nh * 2 * n, windows * nh * n, sizes["rpb partials"] // 4,
                               sizes["weight partials"] // 4, plan.stream_len + plan.vec_len,
                               nh * n * n)]
    x1ws, pvec, stat, drow, prpb, pw, gv, rpb = torch.empty(
        sum(lens), dtype=torch.float32, device=dev).split(lens)
    gv, rpb = gv[:plan.stream_len + plan.vec_len], rpb[:nh * n * n]
    wgrad, vec = gv[:plan.stream_len], gv[plan.stream_len:]
    geo = (ctypes.c_int * 16)(b, h, wd, c, nh, hidden, ws, shift, int(shifted), plan.cp,
                              plan.hdp, plan.stages, int(bool(gelu_approx)), p.grid, p.splits,
                              p.cph)
    status = _lib.call(
        x, _lib.library().sr_swin_block_bwd_tiled_bf16,
        ct.data_ptr(), x.data_ptr(), _ptr(extra), dx.data_ptr(), _ptr(dextra),
        packed.tiles.data_ptr(), packed.bqkv.data_ptr(), packed.bproj.data_ptr(),
        packed.bfc1.data_ptr(), packed.bfc2.data_ptr(), packed.g1.data_ptr(),
        packed.b1.data_ptr(), packed.g2.data_ptr(), packed.b2.data_ptr(),
        packed.table.data_ptr(), codes.data_ptr(), _ptr(scales), wsp.data_ptr(),
        qkvh.data_ptr(), doh.data_ptr(), x1ws.data_ptr(), pvec.data_ptr(), stat.data_ptr(),
        drow.data_ptr(), prpb.data_ptr(), pw.data_ptr(), vec.data_ptr(), rpb.data_ptr(),
        wgrad.data_ptr(), geo, LN_EPS, _lib.stream_of(x))
    _lib.check_status(status, "sr_swin_block_bwd_tiled_bf16")
    TILED_COUNTERS[ws].count += 1
    return dx, fold_block_grads(gv, rpb, c, nh, hidden, ws), dextra


class SwinBlockFunction(torch.autograd.Function):
    """One Swin block on CUDA whose forward is K1 / K6 and whose backward
    is K5 / K6b.  Inputs: x, the branch scales (or None), `extra` (or
    None), then the 13 tensors of GRAD_FIELDS (raw weights and the
    gathered bias, whose gradient the gather's autograd scatters to the
    table); the weights are packed once a call (``pack_block_tiles``),
    and the backward reads the forward's pack."""

    @staticmethod
    def forward(ctx, x, scales, extra, meta, *params):
        shift, mask, gelu_approx, num_heads, table = meta
        raw = dict(zip(GRAD_FIELDS[:-1], params))
        packed = pack_block_tiles(SwinBlockWeights(table=table, num_heads=num_heads, **raw))
        ctx.save_for_backward(x, scales, extra)
        ctx.block = (packed, shift, mask, gelu_approx)
        return _launch_block(x, packed, shift, mask, gelu_approx, scales, extra)

    @staticmethod
    def backward(ctx, ct):
        x, scales, extra = ctx.saved_tensors
        packed, shift, mask, gelu_approx = ctx.block
        dx, raw, dextra = _launch_bwd(ct.to(x.dtype).contiguous(), x, packed, shift, mask,
                                      gelu_approx, scales, extra)
        return (dx, None, dextra, None) + tuple(raw[k] for k in GRAD_FIELDS)


def fused_windows_block(x: torch.Tensor, w: SwinBlockWeights, ws: int, shift: int,
                        mask: Optional[torch.Tensor], gelu_approx: bool,
                        extra: Optional[torch.Tensor] = None,
                        packed: Optional[PackedBlockTiles] = None,
                        branch_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Swin block on x [B, H, W, C] with window `ws`, cyclic shift
    `shift`, the shift mask [nW, ws^2, ws^2] built on (H, W), the
    optional additive term `extra` [B, H, W, C] (x's frame) and branch
    scales [B, 2].  CPU tensor -> plain version (differentiable by
    autograd); CUDA tensor -> the kernel (bf16 x and extra): K1 at ws 8,
    K6 at ws 7, through ``SwinBlockFunction`` (backward K5 / K6's
    backward, with d`extra`) when a gradient is wanted.  `packed`
    (``pack_block_tiles(w)``) is used for inference only.  On CUDA the
    kernel rebuilds `mask` (``shift_attn_mask``'s) from the map's token
    codes."""
    if x.device.type == "cpu":
        return swin_block_plain(x, w, ws, shift, mask, gelu_approx, branch_scales, extra)
    if _lib.exporting():
        return _export_block(x, w, ws, shift, mask, gelu_approx, extra, packed, branch_scales)
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
        packed = pack_block_tiles(w)
    return _launch_block(x, packed, shift, mask, gelu_approx, branch_scales, extra)


def _export_block(x, w: SwinBlockWeights, ws, shift, mask, gelu_approx, extra, packed,
                  branch_scales) -> torch.Tensor:
    """K1 as the ``tpu_sr::swin_block`` custom op, while ``torch.export``
    traces an inference forward (``kernels/custom_ops.py``)."""
    from tpu_superresolution_torch.kernels import custom_ops

    if ws != 8 or extra is not None or branch_scales is not None:
        raise NotImplementedError(
            f"fused_windows_block: only K1's inference call (ws 8, no extra, no branch scales) "
            f"has a custom op for torch.export; ws {ws} is "
            f"{'K6' if ws == 7 else 'K1'}{' with extra' if extra is not None else ''}")
    packed = packed if packed is not None else pack_block_tiles(w)
    return custom_ops.swin_block(x, packed, shift, mask is not None and shift > 0, gelu_approx)


class WindowBlockFunction(torch.autograd.Function):
    """A K7-route block that ``tiled_bwd_ok`` takes, on CUDA: forward
    `route(x, w, scales, extra)` (the route's K2, gathers, K7 and K1t, run
    with no graph), backward K5w16 (ws 16) or K5r (ws 8)
    (``_launch_bwd_tiled``).  Inputs as ``SwinBlockFunction``'s; the
    backward packs the weights once (``pack_block_tiles``: both read the
    block kernel's stream)."""

    @staticmethod
    def forward(ctx, x, scales, extra, meta, *params):
        route, shift, mask, gelu_approx, num_heads, table = meta
        raw = dict(zip(GRAD_FIELDS[:-1], params))
        ctx.save_for_backward(x, scales, extra, *params)
        ctx.block = (shift, mask, gelu_approx, num_heads, table)
        return route(x, SwinBlockWeights(table=table, num_heads=num_heads, **raw), scales, extra)

    @staticmethod
    def backward(ctx, ct):
        x, scales, extra, *params = ctx.saved_tensors
        shift, mask, gelu_approx, num_heads, table = ctx.block
        raw = dict(zip(GRAD_FIELDS[:-1], params))
        packed = pack_block_tiles(SwinBlockWeights(table=table, num_heads=num_heads, **raw))
        dx, grads, dextra = _launch_bwd_tiled(ct.to(x.dtype).contiguous(), x, packed, shift,
                                              mask, gelu_approx, scales, extra)
        return (dx, None, dextra, None) + tuple(grads[k] for k in GRAD_FIELDS)


def window_block_tiled(x: torch.Tensor, w: SwinBlockWeights, ws: int, shift: int,
                       mask: Optional[torch.Tensor], gelu_approx: bool,
                       branch_scales: Optional[torch.Tensor], extra: Optional[torch.Tensor],
                       route: Callable) -> torch.Tensor:
    """A K7-route block that ``tiled_bwd_ok`` takes, in training on CUDA
    (bf16 x and extra): ``route(x, w, branch_scales, extra)`` forward,
    K5w16 (ws 16) or K5r (ws 8) backward, with the gathered bias's
    gradient scattered to the table by the gather's autograd."""
    name = "window_block_tiled"
    _lib.require_cuda(x, name)
    check_tiled_bwd_args(tuple(x.shape), w, ws, shift, name)
    x = x.contiguous()
    if branch_scales is not None:
        branch_scales = branch_scales.float().contiguous()
    if extra is not None:
        extra = extra.contiguous()
    params = [getattr(w, k) for k in GRAD_FIELDS[:-1]]
    rpb = relative_position_bias(w.table, ws)
    meta = (route, shift, mask, gelu_approx, w.num_heads, w.table)
    return WindowBlockFunction.apply(x, branch_scales, extra, meta, *params, rpb)
