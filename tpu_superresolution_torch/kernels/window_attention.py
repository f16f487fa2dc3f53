"""K15 and K16 — window attention on pre-split q, k, v (CUDA,
``csrc/batched_attn.cu``, whose attention core ``csrc/window_attn_core.cuh``
they share with K7).

Ports of ``tpu_superresolution_tpu/ops/pallas/window_attention.py``:
``fused_window_attention`` (K15, its ``pallas_call`` at :193) and
``batched_window_attention`` (K16, at :352), with the JAX package's
layout contract:

    q         [B*nW, nH, Nq, hd]
    k, v      [B*nW, nH, Nk, hd]
    bias      [nH, Nq, Nk] fp32
    mask      [nW, Nq, Nk] fp32 or None; window w takes mask[w % nW]
    out       [B*nW, nH, Nq, hd] = softmax(q k^T * scale + bias + mask) v

with fp32 scores and softmax and the output in q's dtype.  K16 is the
square case (Nq = Nk = N) that DAT's rect-window branches run (N = s0 *
s1: 128 at the default split, 256 at the published DAT x4's (8, 32));
their shift mask is additive -100 and the pad tokens of a padded map are
real keys.  K15 is the general case; HAT's OCAB runs it with the ws^2
queries of each window against the ows^2 keys of the overlapping window
around it (the zero rows of the gather at the border are real keys).
Two CUDA kernels compute both, chosen by ``k15_route`` from static
shapes alone (the same answer on every call and device):

- "wgmma" (``csrc/window_attn_wg.cu``): a persistent grid whose
  CTAs walk (window, head) units head-major with their head's fp32 bias
  resident in shared memory, a producer warpgroup filling a ring of q,
  k, v stages under mbarriers, and two consumer warpgroups running
  Hopper's wgmma (S = Q K^T with the whole row of up to 256 keys in
  registers, a plain softmax there, O = P V with P from registers); any
  Nq (64-row query tiles a unit), any Nk (256-key chunks with an online
  softmax past 256), hd <= 64 (heads padded to 16, 32 or 64 dims).  It
  takes every head of 33-64 dims and K15's unmasked shapes of up to 64
  queries and 256 keys (HAT's and hat_fast's OCABs);
- "tiled" (``csrc/batched_attn.cu``, the first design): one 256-thread block per
  (window, head, 64-query tile) on K7's wmma core, keys streamed in
  64-row tiles; hd <= 32.  It keeps the other shapes of hd <= 32 (K16's
  DAT windows, HAT-SRx4's 256 x 576, masked windows), where it is as
  fast or faster.

Each wrapper counts its own launches, whichever kernel runs.  The
gradient is torch autograd of the plain version, as the JAX custom_vjp
differentiates ``window_attention_reference`` (``window_attention.py:
297-309``); the JAX package has no backward for K15 (its HAT trains the
OCAB through K8).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from tpu_superresolution_torch.kernels import _lib

MAX_HD = 64       # heads of up to 64 dims (both routes pad them)
TILED_MAX_HD = 32  # the tiled kernel's padded head dim
# csrc/window_attn_wg.cu: query rows a tile, the fast path's compiled
# 16-key slice counts (the general path's chunk is the last), ring stages
# at most, and a CTA's shared memory
WG_Q_TILE = 64
WG_FAST_SLICES = (4, 7, 8, 9, 12, 16)
WG_KEY_CHUNK = 16 * WG_FAST_SLICES[-1]  # keys a chunk held in registers
WG_MAX_STAGES = 4
WG_SMEM_LIMIT = 232448
# Whether P enters P V as two bf16 parts (~16 significant bits) or
# rounded to bf16 once: K16 feeds DAT's training, whose smallest
# gradients moved with bf16 P; K15 (the OCAB's attention, as the JAX
# module path rounds it) takes the faster form, within the same bound
# (chip_smoke.py's kernels phase times both; PERF.md).
K16_SPLIT_P = True
K15_SPLIT_P = False

launches = _lib.LaunchCounter("K16 batched_window_attention")
launches_rect = _lib.LaunchCounter("K15 fused_window_attention")


def fused_window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                                 scale: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version of K15 and K16 (the JAX package's
    ``window_attention_reference``): fp32 scores, softmax and products,
    the output in q's dtype."""
    s = torch.einsum("whqd,whkd->whqk", q.float() * scale, k.float()) + bias.float()[None]
    if mask is not None:
        idx = torch.arange(q.shape[0], device=q.device) % mask.shape[0]
        s = s + mask.float()[idx][:, None]
    a = torch.softmax(s, dim=-1)
    return torch.einsum("whqk,whkd->whqd", a, v.float()).to(q.dtype)


# K16 computes the square case of the same function
batched_window_attention_plain = fused_window_attention_plain


def wg_head_pad(hd: int) -> int:
    """The wgmma kernel's padded head dim: 16, 32 or 64."""
    return 16 if hd <= 16 else 32 if hd <= 32 else 64


def wg_stage_bytes(nq: int, nk: int, hd: int) -> int:
    """Bytes of one ring stage of the wgmma kernel: a unit's q tile rows
    (Nq rounded up to 64) and k, v rows (Nk rounded up to 16), each row
    the padded head dim in bf16, each part 1024-byte aligned."""
    rows = lambda n, m: -(-n // m) * m
    part = lambda r: -(-r * wg_head_pad(hd) * 2 // 1024) * 1024
    return part(rows(nq, WG_Q_TILE)) + 2 * part(rows(nk, 16))


def wg_fixed_bytes(hd: int) -> int:
    """The wgmma kernel's shared memory besides the ring and the bias
    table: alignment slack, a zero tile, the two consumer warpgroups'
    output staging tiles and the ring's barriers."""
    return 1024 + 2048 + 2 * WG_Q_TILE * wg_head_pad(hd) * 2 + 16 * WG_MAX_STAGES


@dataclasses.dataclass(frozen=True)
class WgPlan:
    """How the wgmma kernel runs one shape, decided here and only
    checked by the C entry: its 16-key slices a chunk (the fast path's
    fewest that hold the keys, else 16), whether it takes the fast path
    (unmasked, P rounded once, Nk <= 256, and the head's padded bias
    table fits beside two ring stages), its ring stages, its consumer
    warpgroups (two where the stages pair up, so that a stage is always
    reused by the same warpgroup), whether both consumers share each
    unit (`split`: where one stage fits and a unit has two or more
    64-row query tiles, each takes alternate tiles), and its shared
    memory."""

    slices: int
    fast: bool
    stages: int
    consumers: int
    split: bool
    smem: int


@functools.lru_cache(maxsize=256)
def wg_plan(nq: int, nk: int, hd: int, masked: bool, split_p: bool) -> Optional[WgPlan]:
    """The wgmma kernel's plan at a shape, or None where one unit's q, k
    and v do not fit its shared memory."""
    fixed = wg_fixed_bytes(hd)
    stage = wg_stage_bytes(nq, nk, hd)
    ns = next((n for n in WG_FAST_SLICES if 16 * n >= nk), 0)
    table = -(-nq // WG_Q_TILE) * WG_Q_TILE * (16 * ns + 8) * 4  # rows 8 banks apart
    fast = bool(ns) and not masked and not split_p and fixed + table + 2 * stage <= WG_SMEM_LIMIT
    bias = table if fast else 0
    stages = min(WG_MAX_STAGES, (WG_SMEM_LIMIT - fixed - bias) // stage)
    if stages < 1:
        return None
    consumers = 2 if stages >= 2 else 1
    stages -= stages % consumers
    split = stages == 1 and nq > WG_Q_TILE
    return WgPlan(ns if fast else WG_FAST_SLICES[-1], fast, stages, 2 if split else consumers,
                  split, fixed + bias + stages * stage)


def wg_ctas_per_head(bw: int, nh: int, sms: int) -> int:
    """The wgmma kernel's CTAs a head: one CTA an SM over the nH heads
    (floor, so that no second wave runs), at least one and at most one a
    window.  CTA (h, g) takes windows g, g + G, ... of head h."""
    return max(1, min(bw, sms // nh))


@functools.lru_cache(maxsize=256)
def k15_route(nq: int, nk: int, hd: int, masked: bool = False, split_p: bool = False) -> str:
    """The kernel for an attention of `nq` queries against `nk` keys in
    heads of `hd` dims, with or without a mask, with P rounded once (K15)
    or in two parts (K16): "wgmma" for heads of 33-64 dims, and for K15's
    unmasked shapes of at most 64 queries and 256 keys (HAT's and
    hat_fast's OCABs); "tiled" (the first design) for the other shapes of hd <= 32
    (K16's DAT windows, HAT-SRx4's 256 x 576, masked windows).  Shapes
    only; raises ValueError, naming the limit, where neither takes the
    shape."""
    if nq < 1 or nk < 1 or hd < 1 or hd > MAX_HD:
        raise ValueError(f"window attention: heads of hd <= {MAX_HD} dims and at least one "
                         f"query and key; got Nq={nq}, Nk={nk}, hd={hd} (ROADMAP Queue 3)")
    if hd <= TILED_MAX_HD and (masked or split_p or nq > WG_Q_TILE or nk > WG_KEY_CHUNK):
        return "tiled"
    if wg_plan(nq, nk, hd, masked, split_p) is None:
        raise ValueError(f"window attention: one (window, head) of Nq={nq} queries and "
                         f"Nk={nk} keys at hd={hd} takes {wg_stage_bytes(nq, nk, hd)} bytes of "
                         f"q, k, v; the wgmma kernel holds at most "
                         f"{WG_SMEM_LIMIT - wg_fixed_bytes(hd)} (ROADMAP Queue 3)")
    return "wgmma"


def _launch(q, k, v, bias, mask, scale, counter, split_p,
            route: Optional[str] = None) -> torch.Tensor:
    """Launch K15 / K16 on `route`'s kernel (``k15_route``'s by default;
    chip_smoke.py times both where both take the shape)."""
    bw, nh, nq, hd = q.shape
    nk = k.shape[2]
    dev = q.device
    bf, f32 = torch.bfloat16, torch.float32
    _lib.check_tensor(q, "q", bf, dev, shape=(bw, nh, nq, hd), align=2)
    for name, t in (("k", k), ("v", v)):
        _lib.check_tensor(t, name, bf, dev, shape=(bw, nh, nk, hd), align=2)
    _lib.check_tensor(bias, "bias", f32, dev, shape=(nh, nq, nk), align=4)
    n_mask = 0
    if mask is not None:
        n_mask = int(mask.shape[0])
        _lib.check_tensor(mask, "mask", f32, dev, shape=(n_mask, nq, nk), align=4)
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), bw, nh, nq, nk, hd,
            n_mask, int(bool(split_p)), float(scale))
    if (route or k15_route(nq, nk, hd, mask is not None, split_p)) == "wgmma":
        name = "sr_window_attention_wg_bf16"
        plan = wg_plan(nq, nk, hd, mask is not None, bool(split_p))
        status = _lib.call(q, _lib.library().sr_window_attention_wg_bf16, *args,
                           wg_ctas_per_head(bw, nh, _lib.sm_count(dev.index)), plan.slices,
                           int(plan.fast), plan.stages, plan.consumers, int(plan.split),
                           _lib.stream_of(q))
    else:
        name = "sr_batched_window_attention_bf16"
        status = _lib.call(q, _lib.library().sr_batched_window_attention_bf16, *args,
                           _lib.stream_of(q))
    _lib.check_status(status, name)
    counter.count += 1
    return out


class BatchedWindowAttentionFunction(torch.autograd.Function):
    """Forward K15 or K16 (the launch counted on `counter`), backward
    autograd of ``fused_window_attention_plain`` (no gradient for the
    mask, a constant of the shapes)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale, counter, split_p):
        ctx.save_for_backward(q, k, v, bias)
        ctx.mask, ctx.scale = mask, scale
        return _launch(q, k, v, bias.float().contiguous(), mask, scale, counter, split_p)

    @staticmethod
    def backward(ctx, grad_out):
        fn = lambda q, k, v, bias: fused_window_attention_plain(q, k, v, bias, ctx.mask,
                                                                ctx.scale)
        return _lib.plain_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:4],
                              grad_out) + (None, None, None, None)


def _attention(q, k, v, bias, mask, scale, counter, split_p, name) -> torch.Tensor:
    if q.device.type == "cpu":
        return fused_window_attention_plain(q, k, v, bias, mask, scale)
    _lib.require_cuda(q, name)
    return _kernel_attention(q, k, v, bias, mask, scale, counter, split_p, name)


def _kernel_attention(q, k, v, bias, mask, scale, counter, split_p, name) -> torch.Tensor:
    """The CUDA tensors' path: check the shapes against the routes'
    limits, then launch (through the autograd function when a gradient
    is wanted)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} are not [B*nW, nH, "
                         f"N, hd]")
    k15_route(q.shape[2], k.shape[2], q.shape[3], mask is not None, split_p)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = None if mask is None else mask.float().contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        return BatchedWindowAttentionFunction.apply(q, k, v, bias, mask, scale, counter,
                                                    split_p)
    return _launch(q, k, v, bias.float().contiguous(), mask, scale, counter, split_p)


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                           scale: float = 1.0) -> torch.Tensor:
    """K15: window attention of q [B*nW, nH, Nq, hd] against k, v [B*nW,
    nH, Nk, hd] with bias [nH, Nq, Nk] and an optional mask [nW, Nq, Nk]
    (window w takes mask[w % nW]): the plain version for CPU tensors, K15
    for CUDA tensors (bf16 q, k, v, hd <= 64; ``k15_route``), through
    ``BatchedWindowAttentionFunction`` when a gradient is wanted."""
    return _attention(q, k, v, bias, mask, scale, launches_rect, K15_SPLIT_P,
                      "fused_window_attention")


def batched_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                             scale: float = 1.0) -> torch.Tensor:
    """K16: ``fused_window_attention``'s square case, q, k, v [B*nW, nH,
    N, hd] with bias [nH, N, N] and an optional mask [nW, N, N] (DAT's
    rect-window branches), counted as K16."""
    return _attention(q, k, v, bias, mask, scale, launches, K16_SPLIT_P,
                      "batched_window_attention")
