"""K8 — HAT's fused OCAB core, forward and backward (CUDA,
``csrc/ocab_bwd.cu``; at window 16 ``csrc/ocab16.cu``).

Port of ``tpu_superresolution_tpu/ops/pallas/fused_ocab.py``
(``fused_ocab_core``: ``_fwd_kernel`` and ``_bwd_kernel``), which the
JAX package's OCAB runs when the model runs non-deterministically
(training).  Per query window, with q pre-scaled by hd^-0.5:

    x1  = sw + proj(concat_h softmax(q_h k_h^T + bias[h]) v_h)
    out = x1 + fc2(gelu(fc1(LN2(x1))))

Layout at this module's functions: q, sw [BW, ws^2, C] (window tokens),
k, v [BW, ows^2, C] (the overlapping windows of the gather), bias
[nH, ws^2, ows^2] fp32, weights in the reference torch layout
(``OcabWeights``, ``nn.Linear``'s [out, in]).  The caller keeps the JAX
split: LN1, the qkv product and the overlap gather run outside as plain
ops, whose autograd scatters dk / dv back.  The TPU-only parts (head
padding to 32 lanes, the constant-1.0 "ones lane" row sum, token and
window-count padding to multiples of 8) have no counterpart here: the
kernel pads in shared memory.

On a CPU tensor the wrapper runs ``ocab_core_plain``, differentiable by
autograd; on a CUDA tensor it launches K8 (through ``OcabCoreFunction``
when a gradient is wanted, whose backward is K8's backward, K8b) or
raises.  The kernels take (ws, ows) = (7, 10) or (8, 12)
(``csrc/ocab_bwd.cu``) and (16, 24), upstream HAT's OCAB, at C <= 192,
heads of hd <= 32 (at most 6) and any MLP hidden (``ocab_ok``: K5a
walks the MLP in 64-column chunks); HAT's OCAB trains through them
where they do, and through its module path with K15
(``window_attention.fused_window_attention``) elsewhere.

At ws 7 and 8 K8 and K8b run K8w16 / K8bw16's split on Hopper's wgmma,
on one weight pack (``pack_ocab_tiles``' stream, once a call): the
forward gathers q, k, v head-major (a gather kernel into ``to_heads``'
layout), runs the attention over (window, head) units (O and each row's
max and 1 / sum) and K5a's OCAB tail over units of one window (at ws 7
its 49 tokens in 64 rows), and keeps the head-major operands, O and the
row statistics (``OcabKept``) for the backward: K5a's middle, the
attention backward over (window, head) units, two windows a stage, with
each CTA's bias-gradient partial summed in shared memory, K5b and K5c
(``ocab_bwd_plan`` plans the launches, ``ocab_fwd_bytes`` /
``ocab_bwd_bytes`` size their buffers, each carved from one).

At (16, 24) the core runs on Hopper's wgmma as K8w16 / K8bw16
(``csrc/ocab16.cu``, each wrapper call counted once): q, k and v go
head-major first ([BW, nH, N, hdp] bf16, each row swizzled as the
kernels' shared-memory tiles: ``to_heads`` on window-layout operands,
differentiable, or on the OCAB's path ``fused_ocab_core_map``'s gather
from the qkv map, a launch of the K8w16 call whose backward is one of
the K8bw16 call; ``map_heads_plain`` / ``map_heads_bwd_plain`` are their
plain versions); the forward is the attention over (window, head)
units (O and each row's max and 1 / sum, kept for the backward) and K5a's
OCAB forward tail over 64-token units; the backward K5a's middle, the
attention backward (query-row and key-row passes, a CTA's bias-gradient
partial each), K5b and K5c, on ``pack_ocab_tiles``' weight stream
(``ocab16_plan`` plans the launches, ``ocab16_bytes`` sizes their
buffers).  ``Ocab16Function`` carries a training call on the head-major
operands, with ``OcabHeadsFunction`` (the gather and its backward)
before it on the OCAB's path; serving takes the same forward
(``models.hat.OCAB``).
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
from tpu_superresolution_torch.kernels.fused_block import (
    BWD_TILE,
    CP,
    HDP,
    LN_EPS,
    MAX_HEADS,
    BwdPlan,
    StreamLayout,
    _fold_indices,
    _ln_backward,
    _ln_stats,
    _tile_indices,
    bwd_grid,
    bwd_plan,
    gelu,
    gelu_grad,
    stream_layout,
)

# (ws, ows) pairs the kernels are instantiated for at overlap ratio 0.5:
# HAT's ws 7 and hat_fast's ws 8 (csrc/ocab_bwd.cu), upstream HAT-SRx4's
# ws 16 (csrc/ocab16.cu).
KERNEL_WINDOWS = ((7, 10), (8, 12), (16, 24))
W16 = (16, 24)

launches = _lib.LaunchCounter("K8 ocab")
launches_bwd = _lib.LaunchCounter("K8b ocab_bwd")
launches_w16 = _lib.LaunchCounter("K8w16 ocab ws16")
launches_bwd_w16 = _lib.LaunchCounter("K8bw16 ocab_bwd ws16")


@dataclasses.dataclass(frozen=True)
class OcabWeights:
    """The OCAB parameters K8 consumes, in the reference torch layout."""

    wproj: torch.Tensor
    bproj: torch.Tensor
    g2: torch.Tensor
    b2: torch.Tensor
    wfc1: torch.Tensor
    bfc1: torch.Tensor
    wfc2: torch.Tensor
    bfc2: torch.Tensor
    num_heads: int

    @property
    def dim(self) -> int:
        return int(self.wproj.shape[0])

    @property
    def hidden(self) -> int:
        return int(self.wfc1.shape[0])


# The differentiable weights, in the order OcabCoreFunction takes them.
GRAD_FIELDS = ("wproj", "bproj", "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2")


@dataclasses.dataclass(frozen=True)
class OcabGrads:
    """The gradients of one fused_ocab_core call: of q, k, v and sw (in
    their dtype), of the weights in raw space and of the gathered bias
    [nH, ws^2, ows^2] (fp32)."""

    dq: torch.Tensor
    dk: torch.Tensor
    dv: torch.Tensor
    dsw: torch.Tensor
    wproj: torch.Tensor
    bproj: torch.Tensor
    g2: torch.Tensor
    b2: torch.Tensor
    wfc1: torch.Tensor
    bfc1: torch.Tensor
    wfc2: torch.Tensor
    bfc2: torch.Tensor
    bias: torch.Tensor


def _heads(t: torch.Tensor, nh: int) -> torch.Tensor:
    """[BW, N, C] -> [BW, nH, N, hd]."""
    bw, n, c = t.shape
    return t.reshape(bw, n, nh, c // nh).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """[BW, nH, N, hd] -> [BW, N, C]."""
    bw, nh, n, hd = t.shape
    return t.transpose(1, 2).reshape(bw, n, nh * hd)


def ocab_core_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sw: torch.Tensor,
                    w: OcabWeights, bias: torch.Tensor, gelu_approx: bool) -> torch.Tensor:
    """The plain PyTorch version of K8 (``fused_ocab._fwd_kernel``'s
    arithmetic; ``_reference_core``'s function): scores and softmax in
    fp32, the probabilities, the attention output, LN2's output and the
    GELU output cast to sw's dtype where the kernel casts, products in
    fp32 and the residual stream in fp32."""
    cdt = sw.dtype
    f = lambda t: t.to(cdt).float()  # round to the compute dtype
    nh = w.num_heads
    s = torch.einsum("bhqd,bhkd->bhqk", _heads(q.float(), nh), _heads(k.float(), nh))
    a = torch.softmax(s + bias.float(), dim=-1)
    o = f(_merge(torch.einsum("bhqk,bhkd->bhqd", f(a), _heads(v.float(), nh))))
    x1 = sw.float() + o @ f(w.wproj).t() + w.bproj.float()
    n2, _ = _ln_stats(x1)
    y2 = f(n2 * w.g2.float() + w.b2.float())
    act = f(gelu(y2 @ f(w.wfc1).t() + w.bfc1.float(), gelu_approx))
    return (x1 + act @ f(w.wfc2).t() + w.bfc2.float()).to(cdt)


def ocab_core_bwd_plain(ct: torch.Tensor, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sw: torch.Tensor, w: OcabWeights, bias: torch.Tensor,
                        gelu_approx: bool) -> OcabGrads:
    """The plain PyTorch version of K8's backward
    (``fused_ocab._bwd_kernel``'s math, written out): recompute the
    forward, then chain `ct` through MLP, LN2, proj and attention.  GEMM
    operands are cast to sw's dtype at the kernel's points (A, o, y2,
    gelu output, dmlp, dh1, dattn, do, dS); the bias sums of fc2 and
    proj are over the fp32 cotangents, as in the JAX kernel."""
    cdt = sw.dtype
    f = lambda t: t.to(cdt).float()
    nh = w.num_heads
    bw, nq, c = q.shape
    qh, kh, vh = (_heads(t.float(), nh) for t in (q, k, v))
    wp, wf1, wf2 = f(w.wproj), f(w.wfc1), f(w.wfc2)

    # ---- forward recompute ----
    a = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", qh, kh) + bias.float(), dim=-1)
    ac = f(a)
    o = f(_merge(torch.einsum("bhqk,bhkd->bhqd", ac, vh))).reshape(-1, c)
    x1 = sw.float().reshape(-1, c) + o @ wp.t() + w.bproj.float()
    n2, r2 = _ln_stats(x1)
    y2 = f(n2 * w.g2.float() + w.b2.float())
    h1 = y2 @ wf1.t() + w.bfc1.float()
    act = f(gelu(h1, gelu_approx))

    # ---- backward ----
    ctf = ct.float().reshape(-1, c)
    dmlp = f(ctf)
    dh1 = f((dmlp @ wf2) * gelu_grad(h1, gelu_approx))
    dx1, dg2, db2 = _ln_backward(dh1 @ wf1, n2, r2, w.g2.float())
    dx1 = ctf + dx1
    dattn = f(dx1)
    do = _heads(f(dattn @ wp).reshape(bw, nq, c), nh)
    dv = torch.einsum("bhqk,bhqd->bhkd", ac, do)
    da = torch.einsum("bhqd,bhkd->bhqk", do, vh)
    ds = a * (da - (da * a).sum(-1, keepdim=True))
    dsc = f(ds)
    dq = torch.einsum("bhqk,bhkd->bhqd", dsc, kh)
    dk = torch.einsum("bhqk,bhqd->bhkd", dsc, qh)
    return OcabGrads(
        dq=_merge(dq).to(cdt), dk=_merge(dk).to(cdt), dv=_merge(dv).to(cdt),
        dsw=dx1.reshape(sw.shape).to(cdt),
        wproj=dattn.t() @ o, bproj=dx1.sum(0), g2=dg2, b2=db2,
        wfc1=dh1.t() @ y2, bfc1=dh1.sum(0), wfc2=dmlp.t() @ act, bfc2=ctf.sum(0),
        bias=ds.sum(0),
    )


def ocab_ok(ws: int, ows: int, c: int, nh: int, hidden: int) -> bool:
    """Whether K8 and K8b take an OCAB of window `ws`, overlap window
    `ows`, C channels, `nh` heads and MLP hidden `hidden` (static shapes
    only, so the route is the same on every device): the three (ws, ows)
    of ``KERNEL_WINDOWS``, C <= 192, <= 6 heads of hd <= 32, any hidden
    >= 1 (the stream's chunk count; ``fused_block.stream_layout``)."""
    return ((ws, ows) in KERNEL_WINDOWS and c <= CP and c % nh == 0 and c // nh <= HDP
            and nh <= MAX_HEADS and hidden >= 1)


def check_ocab_args(q_shape, k_shape, sw_shape, w: OcabWeights, bias_shape,
                    name: str = "fused_ocab_core") -> None:
    """Raise unless the shapes and widths fit the kernels (shapes only,
    so it runs on any device)."""
    c, nh, hidden = w.dim, w.num_heads, w.hidden
    if len(q_shape) != 3 or len(k_shape) != 3 or tuple(sw_shape) != tuple(q_shape):
        raise ValueError(f"{name}: q and sw must be [BW, ws^2, C] alike, k [BW, ows^2, C]; "
                         f"got q {tuple(q_shape)}, k {tuple(k_shape)}, sw {tuple(sw_shape)}")
    ws, ows = math.isqrt(q_shape[1]), math.isqrt(k_shape[1])
    if (ws, ows) not in KERNEL_WINDOWS or ws * ws != q_shape[1] or ows * ows != k_shape[1]:
        raise ValueError(f"{name}: the kernel takes (ws, ows) in {KERNEL_WINDOWS}; got "
                         f"{q_shape[1]} queries and {k_shape[1]} keys per window (the OCAB "
                         f"takes K15's module path there)")
    if k_shape[0] != q_shape[0] or k_shape[2] != c or q_shape[2] != c:
        raise ValueError(f"{name}: weights for C={c}; q {tuple(q_shape)}, k {tuple(k_shape)}")
    if not ocab_ok(ws, ows, c, nh, hidden):
        raise ValueError(f"{name}: the kernel takes C <= {CP}, hd <= {HDP}, heads <= "
                         f"{MAX_HEADS}; got C={c}, heads={nh}, hidden={hidden}")
    if tuple(bias_shape) != (nh, q_shape[1], k_shape[1]):
        raise ValueError(f"{name}: bias {tuple(bias_shape)}, expected "
                         f"{(nh, q_shape[1], k_shape[1])}")


# ----------------------------------------------------------------- ws 16
# K8w16 / K8bw16 (csrc/ocab16.cu): 256 queries against 576 keys a window
W16_NQ, W16_NK = W16[0] ** 2, W16[1] ** 2
OCAB16_SMEM = 232448  # a CTA's shared memory at most


def swizzled_positions(n: int, hdp: int) -> torch.Tensor:
    """For each element (row r, dim d) of an [n, hdp] bf16 head tile, in
    row-major order, its element offset in the tile as the kernels store
    it: 2 hdp-byte rows, the 16-byte chunk j of row r at j ^ ((r 2 hdp /
    128) % (2 hdp / 16)) (csrc/hopper.cuh ``swizzled_offset``, the wgmma
    64B / 32B swizzle)."""
    rb = 2 * hdp
    off = torch.arange(n)[:, None] * rb + 2 * torch.arange(hdp)[None, :]
    return ((off ^ (((off >> 7) & (rb // 16 - 1)) << 4)) // 2).reshape(-1)


@functools.lru_cache(maxsize=32)
def _head_index(n: int, c: int, nh: int, hdp: int, device: torch.device) -> torch.Tensor:
    """For each element of the head-major [nH, n, hdp] layout (swizzled
    rows), the flat index of its source in [n, nH, hdp] (hd padded)."""
    pos = swizzled_positions(n, hdp)
    src = (torch.arange(n)[:, None] * nh * hdp + torch.arange(hdp)[None, :]).reshape(-1)
    idx = torch.empty(nh, n * hdp, dtype=torch.long)
    for h in range(nh):
        idx[h, pos] = src + h * hdp
    return idx.reshape(-1).to(device)


def to_heads(t: torch.Tensor, nh: int, hdp: int) -> torch.Tensor:
    """[BW, N, C] -> the kernels' head-major [BW, nH, N, hdp] (hd padded
    with zeros to hdp, each row swizzled), by one pad and one gather, both
    differentiable: autograd takes the gradients in this layout back to
    [BW, N, C]."""
    bw, n, c = t.shape
    hd = c // nh
    tp = t.reshape(bw, n, nh, hd)
    if hd < hdp:
        tp = F.pad(tp, (0, hdp - hd))
    idx = _head_index(n, c, nh, hdp, t.device)
    return tp.reshape(bw, n * nh * hdp).index_select(1, idx).reshape(bw, nh, n, hdp)


def from_heads(th: torch.Tensor, c: int) -> torch.Tensor:
    """``to_heads``' inverse: [BW, nH, N, hdp] -> [BW, N, C]."""
    bw, nh, n, hdp = th.shape
    flat = th.new_zeros(bw, n * nh * hdp)
    flat[:, _head_index(n, c, nh, hdp, th.device)] = th.reshape(bw, -1)
    return flat.reshape(bw, n, nh, hdp)[..., :c // nh].reshape(bw, n, c)


# the qkv map's zero channels (hd padding reads the first) and zero border
# (the overlap windows' p_lo = (ows - ws) // 2 before and after) in
# map_heads_plain's padded copy
_ZERO_CH = 8
_BORDER = (W16[1] - W16[0]) // 2


@functools.lru_cache(maxsize=16)
def _window_head_index(c: int, nh: int, hdp: int, device: torch.device):
    """For q, k and v, (channel, row, column) in an overlap window ([24,
    24, 3C + _ZERO_CH] of the padded qkv map) of each element of its
    head-major operand in the kernels' stored order ([nH, N hdp],
    ``to_heads``' swizzled rows; N = 256 for q, whose window sits at rows
    and columns 4-19 of the overlap window, 576 for k and v).  hd padding
    reads the first zero channel."""
    ws, ows = W16
    hd = c // nh
    out = []
    for part, win in ((0, ws), (1, ows), (2, ows)):
        o = _BORDER if part == 0 else 0
        tok = torch.arange(win * win)
        d = torch.arange(hdp)
        ch = torch.where(d < hd, part * c + torch.arange(nh)[:, None] * hd + d, 3 * c)
        logical = (ch[:, None, :].expand(nh, win * win, hdp),
                   (tok // win + o)[None, :, None].expand(nh, win * win, hdp),
                   (tok % win + o)[None, :, None].expand(nh, win * win, hdp))
        pos = swizzled_positions(win * win, hdp)
        idx = []
        for t in logical:
            stored = torch.empty(nh, win * win * hdp, dtype=torch.long)
            stored[:, pos] = t.reshape(nh, -1)
            idx.append(stored.to(device))
        out.append(tuple(idx))
    return out


def _overlap_sum(a: torch.Tensor) -> torch.Tensor:
    """The adjoint of the overlap windows: [B, nWh, nWw, 24, 24, K] ->
    the padded map [B, 16 nWh + 8, 16 nWw + 8, K], each element the sum
    of the (up to four) windows that hold it, rows then columns, each in
    the windows' order (dense slices, no atomics)."""
    ws, ows = W16
    ov = ows - ws
    b, nwh, nww, _, _, k = a.shape
    t = a.permute(0, 1, 3, 2, 4, 5)  # [B, nWh, 24, nWw, 24, K]
    r = a.new_zeros(b, nwh + 1, ws, nww, ows, k)
    r[:, :nwh] = t[:, :, :ws]
    r[:, 1:, :ov] += t[:, :, ws:]
    r = r.reshape(b, ws * (nwh + 1), nww, ows, k)[:, :ws * nwh + ov]
    g = a.new_zeros(b, ws * nwh + ov, nww + 1, ws, k)
    g[:, :, :nww] = r[:, :, :, :ws]
    g[:, :, 1:, :ov] += r[:, :, :, ws:]
    return g.reshape(b, ws * nwh + ov, ws * (nww + 1), k)[:, :, :ws * nww + ov]


def map_heads_plain(qkv: torch.Tensor, nh: int, hdp: int):
    """The plain version of K8w16's gather (``ocab_heads_kernel``): q, k,
    v of the OCAB straight from the qkv map [B, H, W, 3C] (q pre-scaled;
    H, W multiples of 16) to the head-major operands, one padded copy of
    the map (the overlap's zero border, zero channels) and three gathers
    over its overlap windows (``_window_head_index``): the window
    partition, the two overlap gathers and ``to_heads`` in one.
    Differentiable by autograd."""
    b, h, w, c3 = qkv.shape
    ws, ows = W16
    idx = _window_head_index(c3 // 3, nh, hdp, qkv.device)
    xp = F.pad(qkv, (0, _ZERO_CH, _BORDER, _BORDER, _BORDER, _BORDER))
    win = xp.unfold(1, ows, ws).unfold(2, ows, ws)  # [B, nWh, nWw, 3C + z, 24, 24]
    nw = (h // ws) * (w // ws)
    return tuple(win[:, :, :, ch, ty, tx].reshape(b * nw, nh, -1, hdp) for ch, ty, tx in idx)


def map_heads_bwd_plain(gq: torch.Tensor, gk: torch.Tensor, gv: torch.Tensor, shape,
                        nh: int, hdp: int) -> torch.Tensor:
    """The plain version of the gather's backward
    (``ocab_heads_bwd_kernel``): each operand's gradient written back
    into its windows, the overlaps summed in a fixed order
    (``_overlap_sum``) in fp32 (or wider) and rounded once: the gradient
    of the qkv map `shape`, no atomics."""
    b, h, w, c3 = shape
    ws, ows = W16
    idx = _window_head_index(c3 // 3, nh, hdp, gq.device)
    acc = torch.promote_types(gq.dtype, torch.float32)
    a = torch.zeros(b, h // ws, w // ws, ows, ows, c3 + _ZERO_CH, dtype=acc, device=gq.device)
    # the parts' real entries are distinct; the hd padding's all land on
    # the zero channel, which is dropped
    for g, (ch, ty, tx) in zip((gq, gk, gv), idx):
        a[:, :, :, ty, tx, ch] = g.reshape(b, h // ws, w // ws, nh, -1).to(acc)
    g = _overlap_sum(a)
    return g[:, _BORDER:_BORDER + h, _BORDER:_BORDER + w, :c3].to(gq.dtype).contiguous()


def _launch_heads(qkv: torch.Tensor, nh: int, hdp: int):
    """K8w16's gather on CUDA (``ocab_heads_kernel``; counted with the
    call it belongs to)."""
    b, h, w, c3 = qkv.shape
    nw = b * (h // W16[0]) * (w // W16[0])
    _lib.check_tensor(qkv, "qkv", torch.bfloat16, qkv.device, shape=(b, h, w, c3), align=2)
    q = torch.empty(nw, nh, W16_NQ, hdp, dtype=torch.bfloat16, device=qkv.device)
    k, v = (torch.empty(nw, nh, W16_NK, hdp, dtype=torch.bfloat16, device=qkv.device)
            for _ in range(2))
    status = _lib.call(qkv, _lib.library().sr_ocab16_heads_bf16, qkv.data_ptr(), q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), b, h, w, c3 // 3, nh, hdp,
                       _lib.stream_of(qkv))
    _lib.check_status(status, "sr_ocab16_heads_bf16")
    return q, k, v


def _launch_heads_bwd(gq, gk, gv, shape, nh: int, hdp: int) -> torch.Tensor:
    """The gather's backward on CUDA (``ocab_heads_bwd_kernel``)."""
    b, h, w, c3 = shape
    for name, g, n in (("dq", gq, W16_NQ), ("dk", gk, W16_NK), ("dv", gv, W16_NK)):
        _lib.check_tensor(g, name, torch.bfloat16, gq.device,
                          shape=(b * (h // W16[0]) * (w // W16[0]), nh, n, hdp), align=2)
    out = torch.empty(shape, dtype=torch.bfloat16, device=gq.device)
    status = _lib.call(gq, _lib.library().sr_ocab16_heads_bwd_bf16, gq.data_ptr(),
                       gk.data_ptr(), gv.data_ptr(), out.data_ptr(), b, h, w, c3 // 3, nh, hdp,
                       _lib.stream_of(gq))
    _lib.check_status(status, "sr_ocab16_heads_bwd_bf16")
    return out


@dataclasses.dataclass(frozen=True)
class PackedOcab16:
    """K8w16's / K8bw16's weight operands (``pack_ocab_tiles``): the
    weight stream in ``pack_block_tiles``' layout with its qkv part zero
    (the proj's input columns head-padded h hdp + d), fp32 biases
    (`bproj` and `bfc2` [cp], `bfc1` [chunks 64]) and LN2 parameters;
    `layout` the stream's (``stream_layout``)."""

    tiles: torch.Tensor
    bproj: torch.Tensor
    bfc1: torch.Tensor
    bfc2: torch.Tensor
    g2: torch.Tensor
    b2: torch.Tensor
    dim: int
    num_heads: int
    hidden: int
    layout: StreamLayout


@torch.no_grad()
def pack_ocab_tiles(w: OcabWeights) -> PackedOcab16:
    """Lay the OCAB's weights out for K8w16 / K8bw16: K5a's weight stream
    (``fused_block._tile_indices``' gathers, from a zero qkv block), once
    per call (training packs on every step)."""
    c, nh, hidden = w.dim, w.num_heads, w.hidden
    lay = stream_layout(c, nh, hidden)
    dev = w.wproj.device
    tile_idx, bias_idx, _ = _tile_indices(c, nh, hidden, dev)
    f = lambda t: t.detach().float().reshape(-1)
    zero = torch.zeros(1, device=dev)
    src = torch.cat([torch.zeros(3 * c * c, device=dev), f(w.wproj), f(w.wfc1), f(w.wfc2), zero])
    bsrc = torch.cat([torch.zeros(3 * c, device=dev), f(w.bproj), f(w.bfc1), f(w.bfc2), zero])
    bias = bsrc[bias_idx]
    n_q, cp, hid = nh * 3 * lay.hdp, lay.cp, lay.chunks * 64
    return PackedOcab16(
        tiles=src.to(torch.bfloat16)[tile_idx], bproj=bias[n_q:n_q + cp],
        bfc1=bias[n_q + cp:n_q + cp + hid], bfc2=bias[n_q + cp + hid:],
        g2=f(w.g2).contiguous(), b2=f(w.b2).contiguous(), dim=c, num_heads=nh, hidden=hidden,
        layout=lay)


@dataclasses.dataclass(frozen=True)
class Ocab16Plan:
    """How csrc/ocab16.cu runs `windows` windows: `block`, K5a's plan
    (``fused_block.bwd_plan``: the stream's padded widths, ring stages,
    shared memory), whose OCAB modes take the windows' `units` 64-token
    tiles on `grid` CTAs; K5b's `splits` over the units; the attention
    kernels' `cph` CTAs a head (in the backward each keeps a [256, 576]
    fp32 partial of its head's bias gradient), each walking its windows
    in order (in `rounds` rounds, the last on `tail_ctas` CTAs), with
    `att_fwd_smem`
    / `att_bwd_smem` bytes of shared memory a CTA (two stages of a (window,
    head) unit's head tiles: q, k, v, and for the backward dO and the row
    statistics)."""

    block: BwdPlan
    windows: int
    units: int
    grid: int
    splits: int
    cph: int
    rounds: int
    tail_ctas: int
    att_fwd_smem: int
    att_bwd_smem: int


@functools.lru_cache(maxsize=64)
def ocab16_plan(c: int, heads: int, hidden: int, windows: int, sms: int) -> Ocab16Plan:
    """K8w16's / K8bw16's plan from static shapes alone (the C entries
    only check it).  Raises ValueError outside ``ocab_ok``'s widths."""
    if not ocab_ok(*W16, c, heads, hidden):
        raise ValueError(f"K8w16 takes C <= {CP}, <= {MAX_HEADS} heads of hd <= {HDP}; got "
                         f"C={c}, heads={heads}, hidden={hidden}")
    plan = bwd_plan(c, heads, hidden)
    units = windows * W16_NQ // 64
    grid, splits = bwd_grid(plan, units, sms)
    cph = max(1, min(windows, sms // heads))
    rounds = -(-windows // cph)
    rb = 2 * plan.hdp
    qb, kb = W16_NQ * rb, W16_NK * rb
    smem = lambda stage: 1024 + 2 * stage + 4 * 8
    return Ocab16Plan(block=plan, windows=windows, units=units, grid=grid, splits=splits,
                      cph=cph, rounds=rounds,
                      tail_ctas=heads * (windows - (rounds - 1) * cph),
                      att_fwd_smem=smem(qb + 2 * kb),
                      att_bwd_smem=smem(2 * qb + 2 * kb + 3 * W16_NQ * 4))


def ocab16_bytes(p: Ocab16Plan, heads: int) -> dict:
    """Bytes of each buffer K8w16 and K8bw16 allocate at `p.windows`
    windows, by phase: the forward's O (K5a's workspace operand), row
    statistics and x1 scratch (a slot's); the backward's dW workspace
    (y2c, act, dattn, dh1, dmlp), dO tiles, row term, dx1 scratch, LN2
    sums' partials, the CTAs' bias-gradient partials ([256, 576] fp32 a
    CTA) and K5b's splits'."""
    b, n = p.block, p.windows * heads
    return {"O": p.units * b.kc * BWD_TILE * 2,
            "row statistics": n * 2 * W16_NQ * 4,
            "x1 scratch": p.grid * 2 * 64 * b.cp * 4,
            "workspace": p.units * (3 * b.kc + 2 * b.chunks) * BWD_TILE * 2,
            "dO tiles": n * W16_NQ * b.hdp * 2,
            "row term": n * W16_NQ * 4,
            "dx1 scratch": (p.units + p.units % 2) * 64 * b.cp * 4,
            "LN sums partials": p.grid * 2 * 4 * 4 * b.cp * 4,
            "bias-gradient partials": p.cph * heads * W16_NQ * W16_NK * 4,
            "weight partials": p.splits * (b.stream_len + b.bias_len) * 4}


def _map_of(sw: torch.Tensor):
    """(batch, h, w) of the map sw's windows tile: [B, H, W, C], or the
    window layout [BW, 256, C] as [BW, 16, 16, C]."""
    if sw.dim() == 3:
        return sw.shape[0], W16[0], W16[0]
    return tuple(sw.shape[:3])


def _windows(sw: torch.Tensor) -> int:
    b, h, w = _map_of(sw)
    return b * (h // W16[0]) * (w // W16[0])


def _plan16(sw: torch.Tensor, pk: PackedOcab16) -> Ocab16Plan:
    return ocab16_plan(pk.dim, pk.num_heads, pk.hidden, _windows(sw),
                       _lib.sm_count(sw.device.index))


def _geo16(p: Ocab16Plan, sw: torch.Tensor, pk: PackedOcab16, gelu_approx: bool):
    b = p.block
    return (ctypes.c_int * 13)(*_map_of(sw), pk.dim, pk.num_heads, pk.hidden, b.cp, b.hdp,
                               b.stages, int(bool(gelu_approx)), p.grid, p.splits, p.cph)


def _check_launch16(qh, kh, vh, sw, pk: PackedOcab16, bias, name, ct=None) -> None:
    dev, bf, f32 = sw.device, torch.bfloat16, torch.float32
    nh, hdp, c = pk.num_heads, pk.layout.hdp, pk.dim
    b, h, w = _map_of(sw)
    if h % W16[0] or w % W16[0] or sw.shape[-1] != c or sw.dim() not in (3, 4):
        raise ValueError(f"{name}: sw {tuple(sw.shape)}: the kernel takes [BW, 256, {c}] or a "
                         f"[B, H, W, {c}] map with H and W multiples of {W16[0]}")
    bw = _windows(sw)
    acts = [("q", qh, (bw, nh, W16_NQ, hdp), 16), ("k", kh, (bw, nh, W16_NK, hdp), 16),
            ("v", vh, (bw, nh, W16_NK, hdp), 16), ("sw", sw, tuple(sw.shape), 2)]
    if ct is not None:
        acts.append(("ct", ct, tuple(sw.shape), 2))
    for tname, t, shape, align in acts:
        _lib.check_tensor(t, f"{name}: {tname}", bf, dev, shape=shape, align=align)
    lay = pk.layout
    for tname, t, shape, dtype, align in (
        ("tiles", pk.tiles, None, bf, 16), ("bproj", pk.bproj, (lay.cp,), f32, 8),
        ("bfc1", pk.bfc1, (lay.chunks * 64,), f32, 8), ("bfc2", pk.bfc2, (lay.cp,), f32, 8),
        ("g2", pk.g2, (c,), f32, 4), ("b2", pk.b2, (c,), f32, 4),
        ("bias", bias, (nh, W16_NQ, W16_NK), f32, 16),
    ):
        _lib.check_tensor(t, f"{name}: {tname}", dtype, dev, shape=shape, align=align)


def _launch_fwd16(qh, kh, vh, sw, pk: PackedOcab16, bias, gelu_approx):
    """K8w16 (csrc/ocab16.cu): the attention, then K5a's OCAB forward
    tail, sw (and the output) a [B, H, W, C] map or window layout.
    Returns (out, O as K5a's workspace operand, the row statistics), the
    last two for the backward; counts one launch."""
    _check_launch16(qh, kh, vh, sw, pk, bias, "fused_ocab_core")
    p = _plan16(sw, pk)
    b, nh, dev = p.block, pk.num_heads, sw.device
    out = torch.empty_like(sw)
    # O's columns past the heads' are read as zero (the proj's K)
    alloc = torch.zeros if nh * b.hdp < b.kc * 64 else torch.empty
    o = alloc(p.units * b.kc * BWD_TILE, dtype=torch.bfloat16, device=dev)
    stat = torch.empty(p.windows, nh, 2, W16_NQ, dtype=torch.float32, device=dev)
    x1ws = torch.empty(p.grid * 2 * 64 * b.cp, dtype=torch.float32, device=dev)
    status = _lib.call(
        sw, _lib.library().sr_ocab16_fwd_bf16,
        qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), sw.data_ptr(), out.data_ptr(),
        pk.tiles.data_ptr(), pk.bproj.data_ptr(), pk.bfc1.data_ptr(), pk.bfc2.data_ptr(),
        pk.g2.data_ptr(), pk.b2.data_ptr(), bias.data_ptr(), o.data_ptr(), stat.data_ptr(),
        x1ws.data_ptr(), _geo16(p, sw, pk, gelu_approx), LN_EPS, _lib.stream_of(sw))
    _lib.check_status(status, "sr_ocab16_fwd_bf16")
    launches_w16.count += 1
    return out, o, stat


# the raw gradients K8bw16 returns, from the weight stream's fold
_FOLD16 = ("wproj", "wfc1", "wfc2", "bproj", "bfc1", "bfc2", "g2", "b2")


@functools.lru_cache(maxsize=32)
def _fold16_index(c: int, nh: int, hidden: int, device: torch.device):
    """Positions in K8bw16's [weight stream | sums' vector] gradient of
    each raw entry of _FOLD16 (``fused_block._fold_indices``' map, the
    qkv part dropped: its factors are 1 here), and the fields' shapes."""
    idx, _ = _fold_indices(c, nh, hidden, torch.device("cpu"))
    shapes = dict(wqkv=(3 * c, c), wproj=(c, c), wfc1=(hidden, c), wfc2=(c, hidden),
                  bqkv=(3 * c,), bproj=(c,), bfc1=(hidden,), bfc2=(c,), g1=(c,), b1=(c,),
                  g2=(c,), b2=(c,))
    parts, off = {}, 0
    for k in ("wqkv", "wproj", "wfc1", "wfc2", "bqkv", "bproj", "bfc1", "bfc2",
              "g1", "b1", "g2", "b2"):
        n = math.prod(shapes[k])
        parts[k] = idx[off:off + n]
        off += n
    return (torch.cat([parts[k] for k in _FOLD16]).to(device),
            tuple(shapes[k] for k in _FOLD16))


# ------------------------------------------------------------ K8b, ws 7 / 8
# csrc/ocab_bwd.cu: the attention kernels' consumer warpgroups (a window
# each in a stage) and a unit's query rows
OW_CONS = 2
OW_ROWS = 64


def _ow_part_ld(nk: int) -> int:
    """A consumer's bias-gradient partial's row stride (csrc/ocab_bwd.cu
    part_ld): nk rounded to 8, plus 8 unless that is 8 or 24 mod 32."""
    ld = -(-nk // 8) * 8
    return ld if ld % 32 in (8, 24) else ld + 8


def ocab_win_smem(ws: int, ows: int, hdp: int, backward: bool) -> int:
    """The window attention kernel's shared memory (csrc/ocab_bwd.cu
    OwLayout): two stages of two windows' tiles (q [64, hdp], k and v
    [nk rounded to 64, hdp]; for the backward dO [64, hdp] and 1 KB of row
    statistics), the backward's two [64, part_ld] fp32 partials, four
    barriers."""
    nkp, rb = -(-ows * ows // 64) * 64, 2 * hdp
    win = OW_ROWS * rb + 2 * nkp * rb + ((OW_ROWS * rb + 1024) if backward else 0)
    part = OW_CONS * OW_ROWS * _ow_part_ld(ows * ows) * 4 if backward else 0
    return 1024 + 2 * OW_CONS * win + part + 4 * 8


@dataclasses.dataclass(frozen=True)
class OcabBwdPlan:
    """How csrc/ocab_bwd.cu runs K8 and K8b on `windows` windows of (ws,
    ows): `block`, K5a's plan (``fused_block.bwd_plan``) for the forward's
    tail and the backward's middle over the windows (a unit each) on
    `grid` CTAs; K5b's `splits`; the attention
    kernels' `cph` CTAs a head, CTA f of a head walking windows f, f +
    cph, ... two a stage, with `att_fwd_smem` / `att_bwd_smem` bytes of
    shared memory."""

    block: BwdPlan
    ws: int
    ows: int
    windows: int
    grid: int
    splits: int
    cph: int
    att_fwd_smem: int
    att_bwd_smem: int


@functools.lru_cache(maxsize=64)
def ocab_bwd_plan(ws: int, ows: int, c: int, heads: int, hidden: int, windows: int,
                  sms: int) -> OcabBwdPlan:
    """K8's and K8b's plan from static shapes alone (the C entries only
    check it).  Raises ValueError outside ``ocab_ok`` at (7, 10) and (8,
    12)."""
    if (ws, ows) == W16 or not ocab_ok(ws, ows, c, heads, hidden):
        raise ValueError(f"K8b takes (ws, ows) (7, 10) or (8, 12), C <= {CP}, <= {MAX_HEADS} "
                         f"heads of hd <= {HDP}; got ({ws}, {ows}), C={c}, heads={heads}, "
                         f"hidden={hidden}")
    plan = bwd_plan(c, heads, hidden)
    grid, splits = bwd_grid(plan, windows, sms)
    return OcabBwdPlan(block=plan, ws=ws, ows=ows, windows=windows, grid=grid, splits=splits,
                       cph=max(1, min(windows, sms // heads)),
                       att_fwd_smem=ocab_win_smem(ws, ows, plan.hdp, False),
                       att_bwd_smem=ocab_win_smem(ws, ows, plan.hdp, True))


def ocab_fwd_bytes(p: OcabBwdPlan, heads: int) -> dict:
    """Bytes of each buffer K8 writes at ws 7 / 8, in ``_launch_fwd``'s
    order: the head-major q, k, v, O (K5a's workspace operand) and the
    row statistics, which the backward reads, then the tail's x1 scratch
    (a slot's: [grid][2][64 cp] fp32)."""
    b, n = p.block, p.windows * heads
    return {"head-major q, k, v": n * (p.ws ** 2 + 2 * p.ows ** 2) * b.hdp * 2,
            "O": p.windows * b.kc * BWD_TILE * 2,
            "row statistics": n * 2 * OW_ROWS * 4,
            "x1 scratch": p.grid * 2 * 64 * b.cp * 4}


def ocab_bwd_bytes(p: OcabBwdPlan, heads: int) -> dict:
    """Bytes of each workspace K8b uses, in ``_launch_bwd``'s order: the
    dW workspace (y2c, act, dattn, dh1, dmlp), dO tiles, row term, dx1
    scratch, LN2 sums' partials, the CTAs' bias-gradient partials ([nq,
    nk] fp32 a CTA and head) and K5b's splits'."""
    b, n = p.block, p.windows * heads
    return {"workspace": p.windows * (3 * b.kc + 2 * b.chunks) * BWD_TILE * 2,
            "dO tiles": n * OW_ROWS * b.hdp * 2,
            "row term": n * OW_ROWS * 4,
            "dx1 scratch": (p.windows + p.windows % 2) * 64 * b.cp * 4,
            "LN sums partials": p.grid * 2 * 4 * 4 * b.cp * 4,
            "bias-gradient partials": p.cph * heads * p.ws ** 2 * p.ows ** 2 * 4,
            "weight partials": p.splits * (b.stream_len + b.bias_len) * 4}


def _carve(sizes: dict, dev: torch.device):
    """One uint8 buffer for `sizes`' buffers, each 256-byte aligned, and
    each one's address."""
    at, total = {}, 0
    for key, n in sizes.items():
        at[key], total = total, total + -(-n // 256) * 256
    buf = torch.empty(total, dtype=torch.uint8, device=dev)
    return buf, {key: buf.data_ptr() + off for key, off in at.items()}


@dataclasses.dataclass(frozen=True)
class OcabKept:
    """What K8 at ws 7 / 8 keeps for K8b, in one buffer: the addresses of
    the head-major q, k and v, O and the row statistics."""

    buf: torch.Tensor
    ptrs: tuple


def _fold_grads(gv: torch.Tensor, c: int, nh: int, hidden: int) -> dict:
    """The raw-space gradients of _FOLD16 from a [weight stream | sums]
    gradient vector (K8b's and K8bw16's)."""
    idx, shapes = _fold16_index(c, nh, hidden, gv.device)
    g, off = {}, 0
    flat = gv[idx]
    for k, shape in zip(_FOLD16, shapes):
        n = math.prod(shape)
        g[k] = flat[off:off + n].reshape(shape)
        off += n
    return g


def _ocab_plan(sw: torch.Tensor, nk: int, pk: PackedOcab16) -> OcabBwdPlan:
    bw, nq, c = sw.shape
    return ocab_bwd_plan(math.isqrt(nq), math.isqrt(nk), c, pk.num_heads, pk.hidden, bw,
                         _lib.sm_count(sw.device.index))


def _geo(p: OcabBwdPlan, pk: PackedOcab16, gelu_approx: bool):
    b = p.block
    return (ctypes.c_int * 13)(p.windows, p.ws, p.ows, pk.dim, pk.num_heads, pk.hidden, b.cp,
                               b.hdp, b.stages, int(bool(gelu_approx)), p.grid, p.splits, p.cph)


def _check_launch(sw, pk: PackedOcab16, bias, nk: int, name: str, acts) -> None:
    """Raise unless the window-layout activations `acts` ((name, tensor,
    rows)), the weight pack and the bias fit K8 / K8b."""
    dev, bf, f32 = sw.device, torch.bfloat16, torch.float32
    bw, nq, c = sw.shape
    lay = pk.layout
    for tname, t, rows in acts:
        _lib.check_tensor(t, f"{name}: {tname}", bf, dev, shape=(bw, rows, c), align=2)
    for tname, t, shape, dtype, align in (
        ("tiles", pk.tiles, None, bf, 16), ("bproj", pk.bproj, (lay.cp,), f32, 8),
        ("bfc1", pk.bfc1, (lay.chunks * 64,), f32, 8), ("bfc2", pk.bfc2, (lay.cp,), f32, 8),
        ("g2", pk.g2, (c,), f32, 4), ("b2", pk.b2, (c,), f32, 4),
        ("bias", bias, (pk.num_heads, nq, nk), f32, 8),
    ):
        _lib.check_tensor(t, f"{name}: {tname}", dtype, dev, shape=shape, align=align)


def _weight_ptrs(pk: PackedOcab16, bias):
    return (pk.tiles.data_ptr(), pk.bproj.data_ptr(), pk.bfc1.data_ptr(), pk.bfc2.data_ptr(),
            pk.g2.data_ptr(), pk.b2.data_ptr(), bias.data_ptr())


def _launch_fwd(q, k, v, sw, pk: PackedOcab16, bias, gelu_approx):
    """K8 (csrc/ocab_bwd.cu) at ws 7 and 8 on window-layout operands: the
    gather to head-major q, k, v, the attention (O and the row
    statistics) and K5a's OCAB tail, on ``ocab_bwd_plan``'s plan.  Returns
    (out, ``OcabKept`` for K8b); counts one launch."""
    nk = k.shape[1]
    _check_launch(sw, pk, bias, nk, "fused_ocab_core",
                  (("q", q, q.shape[1]), ("k", k, nk), ("v", v, nk), ("sw", sw, sw.shape[1])))
    p = _ocab_plan(sw, nk, pk)
    b, dev = p.block, sw.device
    sizes = ocab_fwd_bytes(p, pk.num_heads)
    x1 = sizes.pop("x1 scratch")
    buf, at = _carve(sizes, dev)
    if pk.num_heads * b.hdp < b.kc * 64:  # O's columns past the heads' are read as zero
        off = at["O"] - buf.data_ptr()
        buf[off:off + sizes["O"]].zero_()
    # the head-major q, k, v one after another in their buffer
    unit = sw.shape[0] * pk.num_heads * b.hdp * 2
    heads = at["head-major q, k, v"]
    kept = OcabKept(buf, (heads, heads + unit * q.shape[1], heads + unit * (q.shape[1] + nk),
                          at["O"], at["row statistics"]))
    x1ws = torch.empty(x1 // 4, dtype=torch.float32, device=dev)
    out = torch.empty_like(sw)
    status = _lib.call(
        sw, _lib.library().sr_ocab_fwd_bf16, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        sw.data_ptr(), out.data_ptr(), *_weight_ptrs(pk, bias), *kept.ptrs, x1ws.data_ptr(),
        _geo(p, pk, gelu_approx), LN_EPS, _lib.stream_of(sw))
    _lib.check_status(status, "sr_ocab_fwd_bf16")
    launches.count += 1
    return out, kept


def _launch_bwd(ct, sw, nk: int, pk: PackedOcab16, bias, gelu_approx, kept: OcabKept):
    """K8b (csrc/ocab_bwd.cu) at ws 7 and 8 on K8's kept head-major q, k,
    v, O and row statistics (`nk` keys a window): K5a's middle, the
    attention backward, K5b and K5c on ``ocab_bwd_plan``'s plan, the
    workspaces carved from one buffer, dq, dk, dv stored in the window
    layout.  Returns (dq, dk, dv, dsw, raw-space fp32 gradients of
    _FOLD16 with the bias gradient under "bias"); counts one launch."""
    bw, nq, c = sw.shape
    nh, dev = pk.num_heads, sw.device
    _check_launch(sw, pk, bias, nk, "fused_ocab_core backward", (("ct", ct, nq), ("sw", sw, nq)))
    p = _ocab_plan(sw, nk, pk)
    b = p.block
    work, at = _carve(ocab_bwd_bytes(p, nh), dev)
    dq, dsw = torch.empty_like(sw), torch.empty_like(sw)
    dk, dv = (torch.empty(bw, nk, c, dtype=sw.dtype, device=dev) for _ in range(2))
    gv = torch.empty(b.stream_len + b.vec_len, dtype=torch.float32, device=dev)
    dbias = torch.empty(nh, nq, nk, dtype=torch.float32, device=dev)
    status = _lib.call(
        sw, _lib.library().sr_ocab_bwd_bf16, ct.data_ptr(), sw.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dsw.data_ptr(), *_weight_ptrs(pk, bias),
        *kept.ptrs, *at.values(), gv.data_ptr(), dbias.data_ptr(),
        _geo(p, pk, gelu_approx), LN_EPS, _lib.stream_of(sw))
    _lib.check_status(status, "sr_ocab_bwd_bf16")
    del work  # (freed in stream order, after the launches)
    launches_bwd.count += 1
    g = _fold_grads(gv, c, nh, pk.hidden)
    g["bias"] = dbias
    return dq, dk, dv, dsw, g


def _launch_bwd16(ct, qh, kh, vh, sw, pk: PackedOcab16, bias, gelu_approx, o, stat):
    """K8bw16 (csrc/ocab16.cu) on the forward's O and row statistics: K5a's
    middle, the attention backward, K5b, K5c, on ``ocab16_plan``'s plan.
    Returns (dq, dk, dv head-major, dsw, raw-space fp32
    gradients of _FOLD16 with the bias gradient under "bias"); counts one
    launch."""
    _check_launch16(qh, kh, vh, sw, pk, bias, "fused_ocab_core backward", ct)
    p = _plan16(sw, pk)
    b, nh, c, dev = p.block, pk.num_heads, pk.dim, sw.device
    f32 = torch.float32
    sizes = ocab16_bytes(p, nh)
    dq, dk, dv, dsw = (torch.empty_like(t) for t in (qh, kh, vh, sw))
    ws = torch.empty(sizes["workspace"] // 2, dtype=torch.bfloat16, device=dev)
    doh = torch.empty(sizes["dO tiles"] // 2, dtype=torch.bfloat16, device=dev)
    drow, x1ws, pvec, prpb, pw = (torch.empty(sizes[k] // 4, dtype=f32, device=dev) for k in (
        "row term", "dx1 scratch", "LN sums partials", "bias-gradient partials",
        "weight partials"))
    gv = torch.empty(b.stream_len + b.vec_len, dtype=f32, device=dev)
    dbias = torch.empty(nh, W16_NQ, W16_NK, dtype=f32, device=dev)
    status = _lib.call(
        sw, _lib.library().sr_ocab16_bwd_bf16,
        ct.data_ptr(), qh.data_ptr(), kh.data_ptr(), vh.data_ptr(), sw.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dsw.data_ptr(), pk.tiles.data_ptr(),
        pk.bproj.data_ptr(), pk.bfc1.data_ptr(), pk.bfc2.data_ptr(), pk.g2.data_ptr(),
        pk.b2.data_ptr(), bias.data_ptr(), o.data_ptr(), stat.data_ptr(), ws.data_ptr(),
        doh.data_ptr(), drow.data_ptr(), x1ws.data_ptr(), pvec.data_ptr(), prpb.data_ptr(),
        pw.data_ptr(), gv.data_ptr(), dbias.data_ptr(), _geo16(p, sw, pk, gelu_approx), LN_EPS,
        _lib.stream_of(sw))
    _lib.check_status(status, "sr_ocab16_bwd_bf16")
    launches_bwd_w16.count += 1
    g = _fold_grads(gv, c, nh, pk.hidden)
    g["bias"] = dbias
    return dq, dk, dv, dsw, g


class Ocab16Function(torch.autograd.Function):
    """K8w16 on CUDA: forward K8w16, backward K8bw16 on the forward's O
    and row statistics.  Inputs: q, k, v head-major (``to_heads`` from
    the window layout, ``OcabHeadsFunction`` from the qkv map), sw (and
    so the output) in window layout or as a [B, H, W, C] map, the
    gathered bias, (num_heads, gelu_approx), then the weights of
    GRAD_FIELDS; the weights are packed once a call."""

    @staticmethod
    def forward(ctx, qh, kh, vh, sw, bias, meta, *params):
        num_heads, gelu_approx = meta
        pk = pack_ocab_tiles(OcabWeights(num_heads=num_heads, **dict(zip(GRAD_FIELDS, params))))
        out, o, stat = _launch_fwd16(qh, kh, vh, sw, pk, bias, gelu_approx)
        ctx.save_for_backward(qh, kh, vh, sw, bias, o, stat)
        ctx.pk, ctx.gelu_approx = pk, gelu_approx
        return out

    @staticmethod
    def backward(ctx, ct):
        qh, kh, vh, sw, bias, o, stat = ctx.saved_tensors
        dq, dk, dv, dsw, g = _launch_bwd16(ct.to(sw.dtype).contiguous(), qh, kh, vh, sw, ctx.pk,
                                           bias, ctx.gelu_approx, o, stat)
        return (dq, dk, dv, dsw, g["bias"], None) + tuple(g[k] for k in GRAD_FIELDS)


class OcabHeadsFunction(torch.autograd.Function):
    """K8w16's gather on CUDA: the qkv map [B, H, W, 3C] to the head-major
    q, k, v (``ocab_heads_kernel``), backward the gather's backward
    (``ocab_heads_bwd_kernel``), each counted with the K8w16 / K8bw16
    call it precedes / follows.  Inputs: qkv, num_heads, hdp."""

    @staticmethod
    def forward(ctx, qkv, num_heads, hdp):
        ctx.shape, ctx.num_heads, ctx.hdp = qkv.shape, num_heads, hdp
        return _launch_heads(qkv, num_heads, hdp)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        dq, dk, dv = (t.contiguous() for t in (dq, dk, dv))
        return _launch_heads_bwd(dq, dk, dv, ctx.shape, ctx.num_heads, ctx.hdp), None, None


def fused_ocab_core_backward(ct: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, sw: torch.Tensor, w: OcabWeights,
                             bias: torch.Tensor, gelu_approx: bool) -> OcabGrads:
    """K8's backward for the cotangent `ct`: the plain version on CPU
    tensors, the kernel (K8b; at ws 16 K8w16's forward for O and the row
    statistics, then K8bw16) on CUDA tensors, gradients in raw space."""
    if sw.device.type == "cpu":
        return ocab_core_bwd_plain(ct, q, k, v, sw, w, bias, gelu_approx)
    _lib.require_cuda(sw, "fused_ocab_core backward")
    check_ocab_args(q.shape, k.shape, sw.shape, w, bias.shape, "fused_ocab_core backward")
    ct, q, k, v, sw = (t.contiguous() for t in (ct, q, k, v, sw))
    bias = bias.float().contiguous()
    if (math.isqrt(q.shape[1]), math.isqrt(k.shape[1])) == W16:
        pk = pack_ocab_tiles(w)
        qh, kh, vh = (to_heads(t, w.num_heads, pk.layout.hdp) for t in (q, k, v))
        _, o, stat = _launch_fwd16(qh, kh, vh, sw, pk, bias, gelu_approx)
        dq, dk, dv, dsw, g = _launch_bwd16(ct, qh, kh, vh, sw, pk, bias, gelu_approx, o, stat)
        c = w.dim
        return OcabGrads(dq=from_heads(dq, c), dk=from_heads(dk, c), dv=from_heads(dv, c),
                         dsw=dsw, **g)
    pk = pack_ocab_tiles(w)
    _, kept = _launch_fwd(q, k, v, sw, pk, bias, gelu_approx)
    dq, dk, dv, dsw, g = _launch_bwd(ct, sw, k.shape[1], pk, bias, gelu_approx, kept)
    return OcabGrads(dq=dq, dk=dk, dv=dv, dsw=dsw, **g)


class OcabCoreFunction(torch.autograd.Function):
    """K8 on CUDA at ws 7 and 8: forward K8, backward K8b on the
    forward's kept head-major q, k, v, O and row statistics.  Inputs: q,
    k, v, sw, the gathered bias, (num_heads, gelu_approx), then the
    weights of GRAD_FIELDS; the weights are packed once a call
    (``pack_ocab_tiles``), for both."""

    @staticmethod
    def forward(ctx, q, k, v, sw, bias, meta, *params):
        num_heads, gelu_approx = meta
        pk = pack_ocab_tiles(OcabWeights(num_heads=num_heads, **dict(zip(GRAD_FIELDS, params))))
        out, kept = _launch_fwd(q, k, v, sw, pk, bias, gelu_approx)
        ctx.save_for_backward(sw, bias, kept.buf)
        ctx.pk, ctx.ptrs, ctx.nk, ctx.gelu_approx = pk, kept.ptrs, k.shape[1], gelu_approx
        return out

    @staticmethod
    def backward(ctx, ct):
        sw, bias, buf = ctx.saved_tensors
        dq, dk, dv, dsw, g = _launch_bwd(ct.to(sw.dtype).contiguous(), sw, ctx.nk, ctx.pk, bias,
                                         ctx.gelu_approx, OcabKept(buf, ctx.ptrs))
        return (dq, dk, dv, dsw, g["bias"], None) + tuple(g[k] for k in GRAD_FIELDS)


def fused_ocab_core_map(qkv: torch.Tensor, x: torch.Tensor, w: OcabWeights, bias: torch.Tensor,
                        gelu_approx: bool, packed: Optional[PackedOcab16] = None) -> torch.Tensor:
    """K8w16 on the OCAB's maps (CUDA, bf16): qkv [B, H, W, 3C] (q
    pre-scaled) and the residual x [B, H, W, C], H and W multiples of 16;
    returns the core's output as a [B, H, W, C] map.  Its first launch
    gathers the head-major operands from the qkv map (``map_heads_plain``
    is its plain version), and K5a reads x and writes the output in the
    map's layout, so no window partition or reverse runs.  When a
    gradient is wanted, the gather as ``OcabHeadsFunction`` and the core
    as ``Ocab16Function`` (backward K8bw16, then the gather's backward),
    else on `packed` where given."""
    b, h, wd, c = x.shape
    check_ocab_args((b, W16_NQ, c), (b, W16_NK, c), (b, W16_NQ, c), w, bias.shape,
                    "fused_ocab_core_map")
    if tuple(qkv.shape) != (b, h, wd, 3 * c) or h % W16[0] or wd % W16[0]:
        raise ValueError(f"fused_ocab_core_map: qkv {tuple(qkv.shape)}, x {tuple(x.shape)}: "
                         f"expected qkv [B, H, W, 3C] over x's map, H and W multiples of 16")
    qkv, x, bias = qkv.contiguous(), x.contiguous(), bias.float().contiguous()
    if _lib.exporting():
        from tpu_superresolution_torch.kernels import custom_ops

        return custom_ops.ocab16(qkv, x, packed or pack_ocab_tiles(w), bias, gelu_approx)
    _lib.require_cuda(x, "fused_ocab_core_map")
    params = [getattr(w, f) for f in GRAD_FIELDS]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [qkv, x, bias] + params):
        hdp = stream_layout(w.dim, w.num_heads, w.hidden).hdp
        qh, kh, vh = OcabHeadsFunction.apply(qkv, w.num_heads, hdp)
        return Ocab16Function.apply(qh, kh, vh, x, bias, (w.num_heads, gelu_approx), *params)
    pk = packed or pack_ocab_tiles(w)
    qh, kh, vh = _launch_heads(qkv, w.num_heads, pk.layout.hdp)
    return _launch_fwd16(qh, kh, vh, x, pk, bias, gelu_approx)[0]


def fused_ocab_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sw: torch.Tensor,
                    w: OcabWeights, bias: torch.Tensor, gelu_approx: bool,
                    plain: bool = False) -> torch.Tensor:
    """The OCAB core on window-layout q, sw [BW, ws^2, C] and k, v
    [BW, ows^2, C] with the gathered bias [nH, ws^2, ows^2]: the plain
    version on a CPU tensor or with `plain` (differentiable by
    autograd), K8 on a CUDA tensor (bf16 q, k, v, sw), through
    ``OcabCoreFunction`` (backward K8b) when a gradient is wanted; at ws
    16 K8w16 on the head-major operands (``to_heads``), through
    ``Ocab16Function`` (backward K8bw16)."""
    if plain or sw.device.type == "cpu":
        return ocab_core_plain(q, k, v, sw, w, bias, gelu_approx)
    _lib.require_cuda(sw, "fused_ocab_core")
    check_ocab_args(q.shape, k.shape, sw.shape, w, bias.shape)
    q, k, v, sw = (t.contiguous() for t in (q, k, v, sw))
    bias = bias.float().contiguous()
    params = [getattr(w, f) for f in GRAD_FIELDS]
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in [q, k, v, sw, bias] + params)
    if (math.isqrt(q.shape[1]), math.isqrt(k.shape[1])) == W16:
        hdp = stream_layout(w.dim, w.num_heads, w.hidden).hdp
        qh, kh, vh = (to_heads(t, w.num_heads, hdp) for t in (q, k, v))
        if grad:
            return Ocab16Function.apply(qh, kh, vh, sw, bias, (w.num_heads, gelu_approx),
                                        *params)
        return _launch_fwd16(qh, kh, vh, sw, pack_ocab_tiles(w), bias, gelu_approx)[0]
    if grad:
        return OcabCoreFunction.apply(q, k, v, sw, bias, (w.num_heads, gelu_approx), *params)
    return _launch_fwd(q, k, v, sw, pack_ocab_tiles(w), bias, gelu_approx)[0]
