"""K8 — HAT's fused OCAB core, forward and backward (CUDA,
``csrc/ocab.cu``).

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
when a gradient is wanted, whose backward is K8's backward kernel, K8b)
or raises.  The kernels take (ws, ows) = (7, 10) or (8, 12) (one CTA a
window, ``csrc/ocab.cu``) and (16, 24), upstream HAT-SRx4's OCAB
(``csrc/ocab16.cu``: the keys streamed in 64-row tiles; its launches
count as K8w16 and K8bw16), at C <= 192, heads of hd <= 32 (at most 6)
and an MLP hidden <= 384 (``ocab_ok``); HAT's OCAB trains through them
where they do, and through its module path with K15
(``window_attention.fused_window_attention``) elsewhere.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib
from tpu_superresolution_torch.kernels.fused_block import (
    CP,
    HDP,
    HIDP,
    LN_EPS,
    MAX_HEADS,
    N_TOK,
    _ln_backward,
    _ln_stats,
    gelu,
    gelu_grad,
    k5_splits,
    split_vec,
    split_wgrad,
    unpack_proj_grad,
)

# (ws, ows) pairs the kernels are instantiated for at overlap ratio 0.5:
# HAT's ws 7 and hat_fast's ws 8 (csrc/ocab.cu), upstream HAT-SRx4's ws
# 16 (csrc/ocab16.cu).
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


@dataclasses.dataclass(frozen=True)
class PackedOcab:
    """The kernels' weight operands: bf16 [out, in] GEMM weights
    zero-padded to the kernel's widths (proj input columns head-padded
    hd -> 32), fp32 biases and LayerNorm parameters."""

    wproj: torch.Tensor  # [CP, CP] bf16
    bproj: torch.Tensor  # [CP] fp32
    g2: torch.Tensor
    b2: torch.Tensor
    wfc1: torch.Tensor   # [HIDP, CP] bf16
    bfc1: torch.Tensor   # [HIDP] fp32
    wfc2: torch.Tensor   # [CP, HIDP] bf16
    bfc2: torch.Tensor   # [CP] fp32
    dim: int
    num_heads: int
    hidden: int


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
    only, so the route is the same on every device)."""
    return ((ws, ows) in KERNEL_WINDOWS and c <= CP and c % nh == 0 and c // nh <= HDP
            and nh <= MAX_HEADS and hidden <= HIDP)


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
                         f"{MAX_HEADS}, hidden <= {HIDP}; got C={c}, heads={nh}, "
                         f"hidden={hidden}")
    if tuple(bias_shape) != (nh, q_shape[1], k_shape[1]):
        raise ValueError(f"{name}: bias {tuple(bias_shape)}, expected "
                         f"{(nh, q_shape[1], k_shape[1])}")


@torch.no_grad()
def pack_ocab_weights(w: OcabWeights) -> PackedOcab:
    """Lay the OCAB weights out for the kernels (once per call in
    training)."""
    c, nh, hidden = w.dim, w.num_heads, w.hidden
    hd, pc, bf = c // nh, CP - c, torch.bfloat16
    wproj = F.pad(w.wproj.reshape(c, nh, hd), (0, HDP - hd, 0, MAX_HEADS - nh, 0, pc))
    return PackedOcab(
        wproj=wproj.reshape(CP, CP).to(bf),
        bproj=F.pad(w.bproj.float(), (0, pc)),
        g2=w.g2.float().contiguous(), b2=w.b2.float().contiguous(),
        wfc1=F.pad(w.wfc1, (0, pc, 0, HIDP - hidden)).to(bf),
        bfc1=F.pad(w.bfc1.float(), (0, HIDP - hidden)),
        wfc2=F.pad(w.wfc2, (0, HIDP - hidden, 0, pc)).to(bf),
        bfc2=F.pad(w.bfc2.float(), (0, pc)),
        dim=c, num_heads=nh, hidden=hidden,
    )


def _check_launch(q, k, v, sw, packed: PackedOcab, bias, name, ct=None) -> None:
    dev, bf, f32 = sw.device, torch.bfloat16, torch.float32
    bw, nq, c = q.shape
    nk = k.shape[1]
    acts = [("q", q, nq), ("k", k, nk), ("v", v, nk), ("sw", sw, nq)]
    if ct is not None:
        acts.append(("ct", ct, nq))
    for tname, t, rows in acts:
        _lib.check_tensor(t, f"{name}: {tname}", bf, dev, shape=(bw, rows, c), align=2)
    for tname, t, shape, dtype, align in (
        ("wproj", packed.wproj, (CP, CP), bf, 32), ("bproj", packed.bproj, (CP,), f32, 16),
        ("g2", packed.g2, (c,), f32, 4), ("b2", packed.b2, (c,), f32, 4),
        ("wfc1", packed.wfc1, (HIDP, CP), bf, 32), ("bfc1", packed.bfc1, (HIDP,), f32, 16),
        ("wfc2", packed.wfc2, (CP, HIDP), bf, 32), ("bfc2", packed.bfc2, (CP,), f32, 16),
        ("bias", bias, (packed.num_heads, nq, nk), f32, 16 if (nq, nk) == (256, 576) else 4),
    ):
        _lib.check_tensor(t, f"{name}: {tname}", dtype, dev, shape=shape, align=align)


def _weight_ptrs(packed: PackedOcab, bias):
    return (packed.wproj.data_ptr(), packed.bproj.data_ptr(), packed.g2.data_ptr(),
            packed.b2.data_ptr(), packed.wfc1.data_ptr(), packed.bfc1.data_ptr(),
            packed.wfc2.data_ptr(), packed.bfc2.data_ptr(), bias.data_ptr())


def _launch_fwd(q, k, v, sw, packed: PackedOcab, bias, gelu_approx) -> torch.Tensor:
    """K8 (csrc/ocab.cu) at ws 7 and 8, K8w16 (csrc/ocab16.cu) at ws 16."""
    _check_launch(q, k, v, sw, packed, bias, "fused_ocab_core")
    bw, nq, c = q.shape
    ws, ows = math.isqrt(nq), math.isqrt(k.shape[1])
    out = torch.empty_like(sw)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), sw.data_ptr(), out.data_ptr(),
            *_weight_ptrs(packed, bias), bw, c, packed.num_heads)
    with torch.cuda.device(sw.device):
        if (ws, ows) == W16:
            status = _lib.library().sr_ocab16_fwd_bf16(
                *ptrs, int(bool(gelu_approx)), LN_EPS, _lib.stream_of(sw))
        else:
            status = _lib.library().sr_ocab_fwd_bf16(
                *ptrs, ws, ows, int(bool(gelu_approx)), LN_EPS, _lib.stream_of(sw))
    _lib.check_status(status, "sr_ocab_fwd_bf16")
    (launches_w16 if (ws, ows) == W16 else launches).count += 1
    return out


# Per-window partial sums written by K8b's per-window kernel: LN g2, b2,
# the bias sums bproj (CP each), bfc1 (HIDP), bfc2 (CP); the per-head dS
# [nh, ws^2, ows^2] follows.
_VEC_OFFSETS = {"g2": 0, "b2": CP, "bproj": 2 * CP, "bfc1": 3 * CP, "bfc2": 3 * CP + HIDP}
_VEC_SIZES = {"bfc1": HIDP}
K8_VEC = 4 * CP + HIDP
# Weight-gradient products of K8b, [out, in] each, in this order.
_WGRAD_SHAPES = (("wproj", CP, CP), ("wfc1", HIDP, CP), ("wfc2", CP, HIDP))
K8_WGRAD = sum(m * n for _, m, n in _WGRAD_SHAPES)
# bf16 operand columns per query row of the workspace: o, y2c, act, dmlp,
# dh1, dattn; then fp32 x1 (CP) and h1 (HIDP).
K8_BF16_COLS = CP + CP + HIDP + CP + HIDP + CP
K8_F32_COLS = CP + HIDP
# At ws 16 (csrc/ocab16.cu): the same columns and dO (CP) per query row;
# fp32 x1 and h1 for one 64-row tile per window; per-window sums per
# (window, tile), 4 rows a window; dS [nh, 256, 576] per window.
K8W16_BF16_COLS = K8_BF16_COLS + CP
K8W16_TILES = 4


def _launch_bwd(ct, q, k, v, sw, packed: PackedOcab, bias, gelu_approx):
    """K8b (ws 7, 8) or K8bw16 (ws 16): the per-window backward, the
    weight-gradient products and the ordered reductions.  Returns (dq,
    dk, dv, dsw, packed-space fp32 gradients with the bias gradient under
    "bias")."""
    _check_launch(q, k, v, sw, packed, bias, "fused_ocab_core backward", ct)
    bw, nq, c = q.shape
    nk, nh = k.shape[1], packed.num_heads
    ws, ows = math.isqrt(nq), math.isqrt(nk)
    w16 = (ws, ows) == W16
    dev = sw.device
    f32 = torch.float32
    tokens = bw * (nq if w16 else N_TOK)  # workspace rows
    splits, rows = k5_splits(tokens)
    dq, dk, dv, dsw = (torch.empty_like(t) for t in (q, k, v, sw))
    part_w = torch.empty(splits * K8_WGRAD, dtype=f32, device=dev)
    wgrad = torch.empty(K8_WGRAD, dtype=f32, device=dev)
    acts = (ct.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), sw.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dsw.data_ptr(),
            *_weight_ptrs(packed, bias))
    tail = (int(bool(gelu_approx)), LN_EPS, splits, rows, _lib.stream_of(sw))
    if w16:
        ws16 = torch.empty(tokens * K8W16_BF16_COLS, dtype=torch.bfloat16, device=dev)
        ws32 = torch.empty(bw * 64 * K8_F32_COLS, dtype=f32, device=dev)
        part_win = torch.empty(bw * K8W16_TILES * K8_VEC, dtype=f32, device=dev)
        dsp = torch.empty(bw * nh * nq * nk, dtype=f32, device=dev)
        vec = torch.empty(K8_VEC, dtype=f32, device=dev)
        dbias = torch.empty(nh, nq, nk, dtype=f32, device=dev)
        with torch.cuda.device(dev):
            status = _lib.library().sr_ocab16_bwd_bf16(
                *acts, ws16.data_ptr(), ws32.data_ptr(), part_win.data_ptr(), dsp.data_ptr(),
                part_w.data_ptr(), vec.data_ptr(), dbias.data_ptr(), wgrad.data_ptr(),
                bw, c, nh, *tail)
    else:
        ws16 = torch.empty(tokens * K8_BF16_COLS, dtype=torch.bfloat16, device=dev)
        ws32 = torch.empty(tokens * K8_F32_COLS, dtype=f32, device=dev)
        vec_len = K8_VEC + nh * nq * nk
        part_win = torch.empty(bw * vec_len, dtype=f32, device=dev)
        vec = torch.empty(vec_len, dtype=f32, device=dev)
        dbias = vec[K8_VEC:].reshape(nh, nq, nk)
        with torch.cuda.device(dev):
            status = _lib.library().sr_ocab_bwd_bf16(
                *acts, ws16.data_ptr(), ws32.data_ptr(), part_win.data_ptr(), part_w.data_ptr(),
                vec.data_ptr(), wgrad.data_ptr(), bw, c, nh, ws, ows, *tail)
    _lib.check_status(status, "sr_ocab_bwd_bf16")
    (launches_bwd_w16 if w16 else launches_bwd).count += 1
    g = split_wgrad(wgrad, _WGRAD_SHAPES)
    g.update(split_vec(vec, _VEC_OFFSETS, _VEC_SIZES))
    g["bias"] = dbias
    return dq, dk, dv, dsw, g


def unpack_ocab_grads(g: dict, packed: PackedOcab) -> dict:
    """Packed-layout gradients -> raw-space ones (drop the padding)."""
    c, nh, hidden = packed.dim, packed.num_heads, packed.hidden
    return dict(
        wproj=unpack_proj_grad(g["wproj"], c, nh), bproj=g["bproj"][:c],
        g2=g["g2"][:c], b2=g["b2"][:c],
        wfc1=g["wfc1"][:hidden, :c], bfc1=g["bfc1"][:hidden],
        wfc2=g["wfc2"][:c, :hidden], bfc2=g["bfc2"][:c], bias=g["bias"],
    )


def fused_ocab_core_backward(ct: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, sw: torch.Tensor, w: OcabWeights,
                             bias: torch.Tensor, gelu_approx: bool) -> OcabGrads:
    """K8's backward for the cotangent `ct`: the plain version on CPU
    tensors, the kernel (K8b) on CUDA tensors, gradients in raw space."""
    if sw.device.type == "cpu":
        return ocab_core_bwd_plain(ct, q, k, v, sw, w, bias, gelu_approx)
    _lib.require_cuda(sw, "fused_ocab_core backward")
    check_ocab_args(q.shape, k.shape, sw.shape, w, bias.shape, "fused_ocab_core backward")
    packed = pack_ocab_weights(w)
    dq, dk, dv, dsw, g = _launch_bwd(ct.contiguous(), q.contiguous(), k.contiguous(),
                                     v.contiguous(), sw.contiguous(), packed,
                                     bias.float().contiguous(), gelu_approx)
    return OcabGrads(dq=dq, dk=dk, dv=dv, dsw=dsw, **unpack_ocab_grads(g, packed))


class OcabCoreFunction(torch.autograd.Function):
    """K8 on CUDA: forward K8, backward K8b.  Inputs: q, k, v, sw, the
    gathered bias, (num_heads, gelu_approx), then the weights of
    GRAD_FIELDS; the weights are packed for the kernels on every call."""

    @staticmethod
    def forward(ctx, q, k, v, sw, bias, meta, *params):
        num_heads, gelu_approx = meta
        packed = pack_ocab_weights(OcabWeights(num_heads=num_heads,
                                               **dict(zip(GRAD_FIELDS, params))))
        ctx.save_for_backward(q, k, v, sw, bias)
        ctx.packed, ctx.gelu_approx = packed, gelu_approx
        return _launch_fwd(q, k, v, sw, packed, bias, gelu_approx)

    @staticmethod
    def backward(ctx, ct):
        q, k, v, sw, bias = ctx.saved_tensors
        dq, dk, dv, dsw, g = _launch_bwd(ct.to(sw.dtype).contiguous(), q, k, v, sw, ctx.packed,
                                         bias, ctx.gelu_approx)
        raw = unpack_ocab_grads(g, ctx.packed)
        return (dq, dk, dv, dsw, raw["bias"], None) + tuple(raw[k] for k in GRAD_FIELDS)


def fused_ocab_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sw: torch.Tensor,
                    w: OcabWeights, bias: torch.Tensor, gelu_approx: bool,
                    plain: bool = False) -> torch.Tensor:
    """The OCAB core on window-layout q, sw [BW, ws^2, C] and k, v
    [BW, ows^2, C] with the gathered bias [nH, ws^2, ows^2]: the plain
    version on a CPU tensor or with `plain` (differentiable by
    autograd), K8 on a CUDA tensor (bf16 q, k, v, sw), through
    ``OcabCoreFunction`` (backward K8b) when a gradient is wanted."""
    if plain or sw.device.type == "cpu":
        return ocab_core_plain(q, k, v, sw, w, bias, gelu_approx)
    _lib.require_cuda(sw, "fused_ocab_core")
    check_ocab_args(q.shape, k.shape, sw.shape, w, bias.shape)
    q, k, v, sw = (t.contiguous() for t in (q, k, v, sw))
    bias = bias.float().contiguous()
    params = [getattr(w, f) for f in GRAD_FIELDS]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [q, k, v, sw, bias] + params):
        return OcabCoreFunction.apply(q, k, v, sw, bias, (w.num_heads, gelu_approx), *params)
    return _launch_fwd(q, k, v, sw, pack_ocab_weights(w), bias, gelu_approx)
