"""K15 and K16 — window attention on pre-split q, k, v (CUDA: K16's
``csrc/batched_attn_wg.cu``, K15's ``csrc/window_attn_wg.cu``, and the
tiled ``csrc/batched_attn.cu`` and stream ``csrc/window_attn_stream.cu``
kernels for the other shapes).

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
Four CUDA kernels compute both, chosen by ``k15_route`` from static
shapes alone (the same answer on every call and device); chip_smoke.py's
route check times every kernel that takes a shape at every K15 / K16
row:

- "wgmma" (``csrc/window_attn_wg.cu``): a persistent grid whose CTAs
  walk (window, head) units head-major with their head's fp32 bias
  resident in shared memory as a padded table, a producer warpgroup
  filling a ring of q, k, v stages under mbarriers, and two consumer
  warpgroups running Hopper's wgmma (S = Q K^T with the whole row of up
  to 256 keys in registers, a plain softmax, O = P V with P from
  registers); unmasked units of at most 256 keys with P rounded once,
  hd <= 64 (heads padded to 16, 32 or 64 dims): HAT's and hat_fast's
  OCABs at every head dim;
- "square" (``csrc/batched_attn_wg.cu``): K16 at DAT's windows of N 128
  or 256 tokens (hd <= 64; at N 256 hd <= 32), masked or not, P in three
  bf16 parts: a persistent grid over (head, mask plane, 128-query row
  block) keys, each CTA walking the key's windows with bias[h] +
  mask[m] summed once into a resident fp32 table, a
  producer warpgroup filling an mbarrier ring with a unit's 128 query
  and N key and value rows, and two consumer warpgroups, a 64-row query
  tile each, on wgmma (keys in groups of 128 or 64 with an online
  softmax); ``sq_plan`` decides its launch;
- "tiled" (``csrc/batched_attn.cu``, the first design): one 256-thread
  block per (window, head, 64-query tile) on K7's wmma core, keys
  streamed in 64-row tiles; hd <= 32.  It keeps the other shapes of hd
  <= 32 the wgmma and square kernels do not take but K15's masked ones:
  HAT-SRx4's 256 x 576 and K16 at windows of other than 128 or 256
  tokens;
- "stream" (``csrc/window_attn_stream.cu``, K7's attention kernel): the
  same persistent, head-major wgmma design with the dense bias and mask
  read from device memory, whose ring items are whole units or a 64-row
  query tile and a key chunk (an online softmax across chunks), heads
  padded to 16, 32 or 64 dims or, past 64, in 64-dim blocks with P V in
  passes of up to 128 columns; K15's masked units and every shape of
  more than 32 dims the wgmma and square kernels do not take (masked
  units, K16 at windows of other sizes or at N 256, units of more than
  256 keys, heads past 64 dims), where it is the fastest of the kernels
  that take the shape.
  ``stream_plan`` decides its launch.

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

WG_MAX_HD = 64    # the wgmma kernel's heads (padded to 16, 32 or 64 dims)
TILED_MAX_HD = 32  # the tiled kernel's padded head dim
# csrc/window_attn_wg.cu: query rows a tile, the compiled 16-key slice
# counts a unit, ring stages at most, and a CTA's shared memory
WG_Q_TILE = 64
WG_SLICES = (4, 7, 8, 9, 12, 16)
WG_MAX_KEYS = 16 * WG_SLICES[-1]  # keys a unit, its row of S in registers
WG_MAX_STAGES = 4
WG_SMEM_LIMIT = 232448
# Whether P enters P V split into bf16 parts (two, ~16 significant bits,
# on the tiled and stream kernels; three, fp32's 24, on the square
# kernel) or rounded to bf16 once: K16 feeds DAT's training, whose
# smallest gradients moved with bf16 P; K15 (the OCAB's attention, as the
# JAX module path rounds it) takes the faster form, within the same bound
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
    checked by the C entry: its 16-key slices a unit (the fewest compiled
    that hold the keys), its ring stages (even: two consumer warpgroups,
    each reusing its own stages) and its shared memory (the head's padded
    bias table beside the stages)."""

    slices: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=256)
def wg_plan(nq: int, nk: int, hd: int, masked: bool, split_p: bool) -> Optional[WgPlan]:
    """The wgmma kernel's plan at a shape, or None where it does not take
    it: a mask, split P, more than 64 dims or 256 keys, or a table that
    does not fit beside two stages."""
    if masked or split_p or hd > WG_MAX_HD or nk > WG_MAX_KEYS:
        return None
    fixed = wg_fixed_bytes(hd)
    stage = wg_stage_bytes(nq, nk, hd)
    ns = next(n for n in WG_SLICES if 16 * n >= nk)
    table = -(-nq // WG_Q_TILE) * WG_Q_TILE * (16 * ns + 8) * 4  # rows 8 banks apart
    stages = min(WG_MAX_STAGES, (WG_SMEM_LIMIT - fixed - table) // stage)
    stages -= stages % 2
    if stages < 2:
        return None
    return WgPlan(ns, stages, fixed + table + stages * stage)


def wg_ctas_per_head(bw: int, nh: int, sms: int) -> int:
    """The wgmma kernel's CTAs a head: one CTA an SM over the nH heads
    (floor, so that no second wave runs), at least one and at most one a
    window.  CTA (h, g) takes windows g, g + G, ... of head h."""
    return max(1, min(bw, sms // nh))


# csrc/batched_attn_wg.cu: the windows it takes (N tokens, 16-key slices
# N / 16), query rows a unit (two consumers' 64-row tiles) and ring stages
# at most
SQ_WINDOWS = (128, 256)
SQ_ROWS = 128
SQ_MAX_STAGES = 4


@dataclasses.dataclass(frozen=True)
class SqPlan:
    """How csrc/batched_attn_wg.cu runs K16 at one shape, decided here and
    only checked by the C entry: the window's `ns` 16-key slices, its
    `row_blocks` blocks of 128 query rows (a CTA's key is a head, a mask
    plane and a row block), the ring's `stages` (a (window, head, row
    block) unit each: 128 q rows, N k and v rows) beside the resident
    [128, N + 8] fp32 table of bias + mask, and the shared memory."""

    ns: int
    row_blocks: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=64)
def sq_plan(n: int, hd: int) -> Optional[SqPlan]:
    """The square kernel's plan for windows of `n` tokens in heads of `hd`
    dims, or None where it does not take them: N other than 128 or 256,
    more than 64 dims, or fewer than two stages beside the table (N 256
    at hd past 32)."""
    if n not in SQ_WINDOWS or not 1 <= hd <= WG_MAX_HD:
        return None
    hdp = wg_head_pad(hd)
    fixed = 1024 + 2 * WG_Q_TILE * hdp * 2 + 16 * SQ_MAX_STAGES  # + staging tiles, barriers
    table = SQ_ROWS * (n + 8) * 4
    stage = (SQ_ROWS + 2 * n) * hdp * 2
    stages = min(SQ_MAX_STAGES, (WG_SMEM_LIMIT - fixed - table) // stage)
    if stages < 2:
        return None
    return SqPlan(n // 16, n // SQ_ROWS, stages, fixed + table + stages * stage)


def sq_ctas_per_key(bw: int, keys: int, n_mask: int, sms: int) -> int:
    """The square kernel's CTAs a key (head, mask plane, row block): one
    wave over the keys (floor, at least one), at most the windows of a
    mask plane.  CTA (key, g) takes the plane's windows g, g + G, ..."""
    return max(1, min(max(1, bw // n_mask), sms // keys))


# csrc/window_attn_stream.cu: query rows a tile, ring stages at most
STREAM_Q_TILE = 64
STREAM_MAX_STAGES = 4


def head_block(hd: int) -> int:
    """The stream kernel's head block: 16, 32 or 64 dims (heads past 64
    dims take ceil(hd / 64) blocks of 64)."""
    return 16 if hd <= 16 else 32 if hd <= 32 else 64


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """How csrc/window_attn_stream.cu runs one shape, decided here and
    only checked by the C entry: the head block `hb` and its count `nb`,
    O's 64-dim blocks a pass `ob` (two at hd 65-128, so that P V runs
    once; past 128 dims, passes of 128 columns), 16-key slices a chunk
    `ns` (8: 128-key chunks, the row of S a thread holds in 64 registers;
    4 for a whole unit of at most 64 keys), `whole` (an item is a whole
    (window, head) unit, where two of them fit) or a 64-row query tile
    and one key chunk an item, its ring stages and shared memory."""

    hb: int
    nb: int
    ob: int
    ns: int
    whole: bool
    stages: int
    smem: int

    @property
    def passes(self) -> int:
        return -(-self.nb // self.ob)


def _a1024(n: int) -> int:
    return -(-n // 1024) * 1024


@functools.lru_cache(maxsize=256)
def stream_plan(nq: int, nk: int, hd: int, ws: int = 0, ws_w: int = 0) -> StreamPlan:
    """The stream kernel's plan at a shape; `ws` > 0: the "rel" form (the
    (2ws-1)(2ws_w-1)-entry bias table of a ws x ws_w window resident, ws_w
    0 meaning ws; a token code array an item)."""
    hb = head_block(hd)
    nb = -(-hd // hb)
    ob = 2 if hb == 64 and nb > 1 else 1
    rb = 2 * hb
    nqt = -(-nq // STREAM_Q_TILE)
    table = -(-(2 * ws - 1) * (2 * (ws_w or ws) - 1) * 4 // 16) * 16 if ws else 0
    fixed = 1024 + 2048 + 2 * STREAM_Q_TILE * ob * hb * 2 + table + 16 * STREAM_MAX_STAGES
    # a whole unit: its keys in chunks of 64 (at most 64 keys) or 256 (or
    # 128 past 64 dims), each chunk's rows all allocated (S reads them)
    ns = 4 if ob == 1 and nk <= 64 else 8
    kc = 16 * ns
    nkc = -(-nk // kc)
    codes = _a1024(nkc * kc * 4) if ws else 0
    whole = nb * (_a1024(nqt * STREAM_Q_TILE * rb) + 2 * _a1024(nkc * kc * rb)) + codes
    if fixed + 2 * whole <= WG_SMEM_LIMIT:
        stages = min(STREAM_MAX_STAGES, (WG_SMEM_LIMIT - fixed) // whole)
        return StreamPlan(hb, nb, ob, ns, True, stages, fixed + stages * whole)
    ns = 8
    kc = 16 * ns
    codes = _a1024(-(-nk // kc) * kc * 4) if ws else 0
    item = nb * (_a1024(STREAM_Q_TILE * rb) + 2 * _a1024(kc * rb)) + codes
    stages = min(STREAM_MAX_STAGES, (WG_SMEM_LIMIT - fixed) // item)
    if stages < 1:
        raise ValueError(f"window attention: one item of the stream kernel at hd={hd} "
                         f"({item} bytes) does not fit beside its {fixed} fixed bytes")
    return StreamPlan(hb, nb, ob, ns, False, stages, fixed + stages * item)


@functools.lru_cache(maxsize=256)
def k15_route(nq: int, nk: int, hd: int, masked: bool = False, split_p: bool = False) -> str:
    """The kernel for an attention of `nq` queries against `nk` keys in
    heads of `hd` dims, with or without a mask, with P rounded once (K15)
    or split into parts (K16): "wgmma" where ``wg_plan`` takes the shape
    (unmasked, P rounded once, at most 256 keys: HAT's and hat_fast's
    OCABs); "square" for split P on square windows ``sq_plan``
    takes (K16's DAT windows of 128 and 256 tokens); "tiled" for the
    other shapes of hd <= 32 but K15's masked ones (HAT-SRx4's 256 x 576,
    K16 at other windows); "stream" for the rest (K15's masked units,
    masked units past hd 32, more keys, heads past 64 dims).  Shapes only;
    raises ValueError only for empty shapes."""
    if nq < 1 or nk < 1 or hd < 1:
        raise ValueError(f"window attention: at least one query, key and head dim; got "
                         f"Nq={nq}, Nk={nk}, hd={hd}")
    if wg_plan(nq, nk, hd, masked, split_p) is not None:
        return "wgmma"
    if split_p and nq == nk and sq_plan(nq, hd) is not None:
        return "square"
    if hd <= TILED_MAX_HD and (split_p or not masked):
        return "tiled"
    return "stream"


def launch_stream(q, k, v, bias, mask, codes, out, bw, nh, nq, nk, hd, scale, split_p,
                  ws: int = 0, shifted: bool = False, bulk: bool = False,
                  tokmajor: bool = False) -> None:
    """One launch of csrc/window_attn_stream.cu (plan from
    ``stream_plan``): the K15 / K16 route "stream" (q, k, v [BW, nH, N,
    hd], dense bias and mask, head-major out) or K7's attention (`bulk`:
    q the head-split workspace; `codes` with the table as `bias`: the rel
    form at window `ws`, the codes' regions masked only where `shifted`;
    `tokmajor` out)."""
    plan = stream_plan(nq, nk, hd, ws if codes is not None else 0)
    dev = out.device
    status = _lib.call(
        out, _lib.library().sr_window_attention_stream_bf16, q.data_ptr(),
        None if k is None else k.data_ptr(), None if v is None else v.data_ptr(),
        bias.data_ptr(), None if mask is None else mask.data_ptr(),
        None if codes is None else codes.data_ptr(), out.data_ptr(), bw, nh, nq, nk, hd,
        0 if mask is None else int(mask.shape[0]), 0 if codes is None else int(codes.shape[0]),
        ws, int(bool(shifted)), int(bool(split_p)), float(scale), wg_ctas_per_head(bw, nh, _lib.sm_count(dev.index)),
        plan.hb, plan.ob, plan.ns, plan.stages, int(plan.whole), int(bulk), int(tokmajor), ws,
        None, _lib.stream_of(out))
    _lib.check_status(status, "sr_window_attention_stream_bf16")


def _launch(q, k, v, bias, mask, scale, counter, split_p,
            route: Optional[str] = None) -> torch.Tensor:
    """Launch K15 / K16 on `route`'s kernel (``k15_route``'s by default;
    chip_smoke.py times every kernel that takes the shape)."""
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
    route = route or k15_route(nq, nk, hd, mask is not None, split_p)
    if route == "stream":
        launch_stream(q, k, v, bias, mask, None, out, bw, nh, nq, nk, hd, scale, split_p)
        counter.count += 1
        return out
    if route == "square":
        name = "sr_batched_window_attention_wg_bf16"
        plan = sq_plan(nq, hd) if nq == nk and split_p else None
        if plan is None:
            raise ValueError(f"window attention: the square kernel takes split P on square "
                             f"windows of {SQ_WINDOWS} tokens at hd <= {WG_MAX_HD}; got Nq={nq}, "
                             f"Nk={nk}, hd={hd}{'' if split_p else ' with P rounded once'}")
        keys = nh * max(1, n_mask) * plan.row_blocks
        status = _lib.call(q, _lib.library().sr_batched_window_attention_wg_bf16, q.data_ptr(),
                           k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                           None if mask is None else mask.data_ptr(), out.data_ptr(), bw, nh,
                           nq, hd, n_mask, float(scale),
                           sq_ctas_per_key(bw, keys, max(1, n_mask), _lib.sm_count(dev.index)),
                           plan.stages, _lib.stream_of(q))
    elif route == "wgmma":
        name = "sr_window_attention_wg_bf16"
        plan = wg_plan(nq, nk, hd, mask is not None, bool(split_p))
        if plan is None:
            raise ValueError(f"window attention: the wgmma kernel does not take Nq={nq}, "
                             f"Nk={nk}, hd={hd}{' with a mask' if mask is not None else ''}"
                             f"{' with split P' if split_p else ''}")
        status = _lib.call(q, _lib.library().sr_window_attention_wg_bf16, q.data_ptr(),
                           k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(), bw, nh,
                           nq, nk, hd, float(scale),
                           wg_ctas_per_head(bw, nh, _lib.sm_count(dev.index)), plan.slices,
                           plan.stages, _lib.stream_of(q))
    else:
        name = "sr_batched_window_attention_bf16"
        status = _lib.call(q, _lib.library().sr_batched_window_attention_bf16, q.data_ptr(),
                           k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                           None if mask is None else mask.data_ptr(), out.data_ptr(), bw, nh,
                           nq, nk, hd, n_mask, int(bool(split_p)), float(scale),
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
    if not _lib.exporting():
        _lib.require_cuda(q, name)
    return _kernel_attention(q, k, v, bias, mask, scale, counter, split_p, name)


def _kernel_attention(q, k, v, bias, mask, scale, counter, split_p, name) -> torch.Tensor:
    """The CUDA tensors' path: check the shapes against the routes'
    limits, then launch (through the autograd function when a gradient
    is wanted), or while ``torch.export`` traces call the
    ``tpu_sr::window_attention`` op (``custom_ops.py``)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} are not [B*nW, nH, "
                         f"N, hd]")
    k15_route(q.shape[2], k.shape[2], q.shape[3], mask is not None, split_p)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = None if mask is None else mask.float().contiguous()
    if _lib.exporting():
        return torch.ops.tpu_sr.window_attention(q, k, v, bias.float().contiguous(), mask,
                                                 float(scale), split_p,
                                                 "K15" if counter is launches_rect else "K16")
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
    for CUDA tensors (bf16 q, k, v, any hd; ``k15_route``), through
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
