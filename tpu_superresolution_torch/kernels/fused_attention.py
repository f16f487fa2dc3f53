"""K7 — fused window attention: the qkv product, the biased and masked
window softmax attention and the output projection (CUDA,
``csrc/window_attn.cu``, the product, and ``csrc/window_attn_stream.cu``,
the attention).

Port of ``tpu_superresolution_tpu/ops/pallas/fused_attention.py``
(``fused_window_block_attention``, ``pl.pallas_call`` in
``_fused_forward``).  On windowed features xw [BW, N, C]:

    qkv = xw Wqkv^T + bqkv            (q rows pre-scaled by hd^-0.5)
    S_h = q_h k_h^T + rpb[h] + mask[w % nW]     (fp32 softmax)
    out = concat_h(softmax(S_h) v_h) Wproj^T + bproj

Weights are in the reference torch layout (``nn.Linear``'s [out, in]);
`bqkv` None means zeros.  The TPU kernel's window packing (P windows on
one [P*N, P*N] tile with -1e9 off the diagonal) and its token padding to
a multiple of 8 have no counterpart here.  A K7 call is three CUDA
launches, counted once:

1. the product kernel (a persistent wgmma GEMM fed by an mbarrier ring,
   C in 64-column chunks, so any C) computes qkv
   into a head-split workspace [3, BW, nH, nb, N, hb], each (window,
   head) run in the swizzled layout the attention's wgmma reads (heads
   padded to hb = 16, 32 or 64 dims, past 64 in nb blocks of 64);
2. the stream attention kernel (``window_attention.launch_stream``)
   takes each run by one bulk copy and writes the heads' outputs
   token-major [BW * N, nH * nb * hb]; its bias and mask are either the
   dense [nH, N, N] / [nW, N, N] fp32 arrays or, where the caller gives
   the window's token codes (``ops.window.window_token_codes``) and the
   weights were packed with the relative-position table, the table
   resident in shared memory and one code per token (the same fp32
   values, no [nH, N, N] reads);
3. the product kernel again computes the proj.

So K7 takes any C, any number of heads, any head dim and any window.
``qkv_product`` (the ws-16 block backward's qkv recompute, counted as a
K7 call) runs the product kernel alone; ``window_product_plain`` is its
plain version.

On a CPU tensor the wrapper runs ``window_attention_plain``; on a CUDA
tensor it launches K7 (bf16 xw, fp32 bias and mask), through
``WindowAttentionFunction`` when a gradient is wanted, whose backward is
torch autograd of the plain version, as the JAX package's custom_vjp
differentiates ``_reference_impl`` (``fused_attention.py:307-311``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib
from tpu_superresolution_torch.kernels.window_attention import head_block, launch_stream

launches = _lib.LaunchCounter("K7 window_attention")

# csrc/window_attn.cu: rows a tile, K columns a stage, compiled N tiles
PRODUCT_BM = 128
PRODUCT_BK = 64
PRODUCT_N_TILES = (16, 32, 64, 96, 128, 144, 192, 256, 264)  # 264: two wgmmas, 136 + 128


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


# ------------------------------------------------------------ the product


@dataclasses.dataclass(frozen=True)
class ProductPlan:
    """The product kernel's N tiling of an output width: `n_tiles` tiles
    of `n_tile` columns (a compiled wgmma N)."""

    n_tile: int
    n_tiles: int


@functools.lru_cache(maxsize=256)
def product_plan(c_out: int) -> ProductPlan:
    """The N tiling with the least padded width, counting each tile's
    reload of the 128-row x chunk as 64 more columns (the operands' L2
    traffic, not the tensor cores, bounds these products); ties go to
    fewer tiles.  Shapes only."""
    best = None
    for n_tiles in range(1, -(-c_out // 16) + 1):
        per = -(-c_out // n_tiles)
        if per > PRODUCT_N_TILES[-1]:
            continue
        n = next(t for t in PRODUCT_N_TILES if t >= per)
        cost = (n_tiles * (n + 64), n_tiles)
        if best is None or cost < best[0]:
            best = (cost, ProductPlan(n, n_tiles))
    return best[1]


@dataclasses.dataclass(frozen=True)
class PackedProduct:
    """The product launch's operands: the weight [C_out, C_in] as one
    [N, 64] tile a (N tile, 64-column chunk of C_in), K-major and
    128B-swizzled (16-byte chunk j of row n at j ^ (n % 8)), zero past
    C_in and C_out: ``wp`` [n_tiles, chunks, N, 64]; the fp32 bias padded
    to n_tiles * N."""

    wp: torch.Tensor
    b: torch.Tensor
    c_in: int
    c_out: int
    plan: ProductPlan


@torch.no_grad()
def pack_window_product(weight: torch.Tensor, bias: Optional[torch.Tensor],
                        dtype: torch.dtype = torch.bfloat16) -> PackedProduct:
    """Lay an ``nn.Linear`` weight [out, in] and bias (None: zeros) out
    for the product launch (the weight in `dtype`: the kernel's bf16, or
    fp32 for the CPU tests' emulation): once per loaded weights at
    inference, on every call in training."""
    from tpu_superresolution_torch.kernels.cab_conv import _swizzle_rows

    c_out, c_in = int(weight.shape[0]), int(weight.shape[1])
    plan = product_plan(c_out)
    chunks = -(-c_in // PRODUCT_BK)
    npad = plan.n_tiles * plan.n_tile
    w = F.pad(weight.detach().float(), (0, chunks * PRODUCT_BK - c_in, 0, npad - c_out))
    w = w.reshape(plan.n_tiles, plan.n_tile, chunks, PRODUCT_BK).transpose(1, 2)
    b = torch.zeros(c_out, device=weight.device) if bias is None else bias.detach().float()
    return PackedProduct(wp=_swizzle_rows(w).to(dtype).contiguous(),
                         b=F.pad(b, (0, npad - c_out)).contiguous(), c_in=c_in, c_out=c_out,
                         plan=plan)


def window_product_plain(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain version of the product launch: ``F.linear`` in x's
    dtype (what ``window_attention_plain`` computes for qkv and proj)."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def _vec(x: torch.Tensor, c: int) -> int:
    """The widest x copy (8, 4, 2 or 1 bf16) that divides C and x's
    alignment."""
    return next(v for v in (8, 4, 2, 1) if c % v == 0 and x.data_ptr() % (2 * v) == 0)


def _launch_product(x: torch.Tensor, packed: PackedProduct,
                    split: Optional[Tuple[int, int, int, int, int]] = None) -> torch.Tensor:
    """One launch of the product kernel on x [rows, C_in] bf16: y [rows,
    C_out], or with `split` = (BW, N, nH, hdw, hb) K7's head-split qkv
    workspace (flat, 3 * rows * nH * hdw values)."""
    rows, c = x.shape
    if c != packed.c_in:
        raise ValueError(f"window_product: weights for C={packed.c_in}, x has C={c}")
    plan = packed.plan
    _lib.check_tensor(x, "x", torch.bfloat16, x.device, ndim=2, align=2)
    if packed.wp.device != x.device or packed.wp.dtype != torch.bfloat16:
        raise ValueError(f"window_product: weight packed as {packed.wp.dtype} on "
                         f"{packed.wp.device}, x on {x.device}")
    # (pack_window_product makes wp and b contiguous in the plan's shapes)
    bw = ntok = nh = hdw = hb = 0
    if split is None:
        y = torch.empty(rows, packed.c_out, dtype=torch.bfloat16, device=x.device)
    else:
        bw, ntok, nh, hdw, hb = split
        y = torch.empty(3 * rows * nh * hdw, dtype=torch.bfloat16, device=x.device)
    status = _lib.call(x, _lib.library().sr_window_product_bf16, x.data_ptr(),
                       packed.wp.data_ptr(), packed.b.data_ptr(), y.data_ptr(), rows, c,
                       plan.n_tile, plan.n_tiles, packed.c_out, _vec(x, c), int(split is not None),
                       bw, ntok, nh, hdw, hb, _lib.stream_of(x))
    _lib.check_status(status, "sr_window_product_bf16")
    return y


def qkv_product(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor) -> torch.Tensor:
    """The product launch alone (CUDA tensors only): x [rows, CK] bf16
    times [n3, CK] bf16 weights plus fp32 bias -> [rows, n3] bf16.  The
    ws-16 block backward's qkv recompute; counted as a K7 call."""
    _lib.require_cuda(x, "qkv_product")
    out = _launch_product(x, pack_window_product(wqkv, bqkv))
    launches.count += 1
    return out


# ---------------------------------------------------------- the attention


@dataclasses.dataclass(frozen=True)
class PackedWindowAttention:
    """K7's operands: the qkv product's weight with each head's dims
    zero-padded hd -> hdw = nb * hb and its q rows pre-scaled by
    hd^-0.5 (outputs [3, nH, hdw]), the proj's weight with its input
    columns padded alike ([C, nH * hdw]), and the bias: the gathered
    [nH, N, N] fp32 `rpb` (dense) and/or the [(2ws-1)^2, nH] fp32 `table`
    of window `ws` (the rel form, with the caller's token codes)."""

    qkv: PackedProduct
    proj: PackedProduct
    rpb: Optional[torch.Tensor]
    table: Optional[torch.Tensor]
    ws: int
    dim: int
    num_heads: int

    @property
    def hb(self) -> int:
        return head_block(self.dim // self.num_heads)

    @property
    def hdw(self) -> int:
        hd = self.dim // self.num_heads
        return -(-hd // self.hb) * self.hb

    def dense_bias(self) -> torch.Tensor:
        if self.rpb is not None:
            return self.rpb
        from tpu_superresolution_torch.ops.window import relative_position_bias

        return relative_position_bias(self.table, self.ws)


@torch.no_grad()
def pack_window_attention(wqkv, bqkv, wproj, bproj, rpb=None, table=None, ws: int = 0,
                          dtype: torch.dtype = torch.bfloat16) -> PackedWindowAttention:
    """Lay the raw weights out for K7 (the counterpart of the JAX
    package's ``_prep_weights``): once per loaded weights at inference,
    on every call in training.  Give the gathered bias `rpb` [nH, N, N],
    or the relative-position `table` [(2ws-1)^2, nH] and window `ws` (or
    both)."""
    nh = int(rpb.shape[0]) if rpb is not None else int(table.shape[1])
    c = int(wqkv.shape[1])
    if c % nh:
        raise ValueError(f"fused_window_attention: {nh} heads do not divide C={c}")
    if table is not None and tuple(table.shape) != ((2 * ws - 1) ** 2, nh):
        raise ValueError(f"fused_window_attention: table {tuple(table.shape)} is not the "
                         f"[(2ws-1)^2, nH] table of ws {ws} and {nh} heads")
    hd = c // nh
    hb = head_block(hd)
    hdw = -(-hd // hb) * hb
    dev = wqkv.device
    w = wqkv.detach().float().reshape(3, nh, hd, c).clone()
    w[0] *= hd ** -0.5
    b = (torch.zeros(3, nh, hd, device=dev) if bqkv is None
         else bqkv.detach().float().reshape(3, nh, hd).clone())
    b[0] *= hd ** -0.5
    wq = F.pad(w, (0, 0, 0, hdw - hd)).reshape(3 * nh * hdw, c)
    wp = F.pad(wproj.detach().float().reshape(c, nh, hd), (0, hdw - hd)).reshape(c, nh * hdw)
    return PackedWindowAttention(
        qkv=pack_window_product(wq, F.pad(b, (0, hdw - hd)).reshape(-1), dtype),
        proj=pack_window_product(wp, bproj, dtype),
        rpb=None if rpb is None else rpb.float().contiguous(),
        table=None if table is None else table.detach().float().contiguous(),
        ws=ws, dim=c, num_heads=nh)


def _launch(xw: torch.Tensor, packed: PackedWindowAttention, mask: Optional[torch.Tensor],
            codes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The three CUDA launches of one K7 call (qkv product into the
    head-split workspace, attention, proj product), counted once; the
    rel form where `codes` is given and the weights carry the table."""
    _lib.check_tensor(xw, "xw", torch.bfloat16, xw.device, ndim=3, align=2)
    bw, n, c = xw.shape
    nh, hb, hdw = packed.num_heads, packed.hb, packed.hdw
    if c != packed.dim:
        raise ValueError(f"fused_window_attention: weights for C={packed.dim}, xw has C={c}")
    dev = xw.device
    f32 = torch.float32
    rel = codes is not None and packed.table is not None
    if rel:
        _lib.check_tensor(codes, "codes", torch.int32, dev, ndim=2, align=4)
        if int(codes.shape[1]) != n or packed.ws ** 2 != n or bw % int(codes.shape[0]):
            raise ValueError(f"fused_window_attention: codes {tuple(codes.shape)} for "
                             f"{bw} windows of {n} tokens at ws {packed.ws}")
        bias = packed.table
    else:
        bias = packed.dense_bias()
        _lib.check_tensor(bias, "rpb", f32, dev, shape=(nh, n, n), align=4)
        if mask is not None:
            n_mask = int(mask.shape[0])
            _lib.check_tensor(mask, "mask", f32, dev, shape=(n_mask, n, n), align=4)
            if n_mask == 0 or bw % n_mask:
                raise ValueError(f"fused_window_attention: {bw} windows are not a whole "
                                 f"number of mask periods of {n_mask}")
    qkv = _launch_product(xw.reshape(bw * n, c), packed.qkv, (bw, n, nh, hdw, hb))
    att = torch.empty(bw * n, nh * hdw, dtype=torch.bfloat16, device=dev)
    # the rel form masks the codes' regions where the caller's block is
    # shifted (its mask given), whatever bits the codes carry
    launch_stream(qkv, None, None, bias, None if rel else mask, codes if rel else None, att, bw,
                  nh, n, n, c // nh, 1.0, False, packed.ws if rel else 0,
                  shifted=rel and mask is not None, bulk=True, tokmajor=True)
    out = _launch_product(att, packed.proj)
    launches.count += 1
    return out.reshape(bw, n, c)


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
                           packed: Optional[PackedWindowAttention] = None,
                           codes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7 on xw [BW, N, C] with the gathered bias rpb [nH, N, N] and the
    shift mask [nW, N, N] or None (window w uses mask[w % nW]); the
    scale is hd^-0.5.  CPU tensor -> plain version; CUDA tensor -> the
    kernel, through ``WindowAttentionFunction`` when a gradient is
    wanted.  `packed` (inference only) skips the per-call packing and
    holds the bias: rpb may then be None.  `codes` [n_codes, N] int32
    (``ops.window.window_codes_tensor``, the mask's token codes) with
    weights packed with their table: the kernel's rel form, which then
    reads neither rpb nor mask's values (the codes' regions are masked
    where a mask is given, and ignored where it is None)."""
    c, nh = int(xw.shape[-1]), packed.num_heads if rpb is None else int(rpb.shape[0])
    if c % nh:
        raise ValueError(f"fused_window_attention: {nh} heads do not divide C={c}")
    scale = (c // nh) ** -0.5
    if xw.device.type == "cpu":
        rpb = packed.dense_bias() if rpb is None else rpb
        return window_attention_plain(xw, wqkv, bqkv, wproj, bproj, rpb, mask, scale)
    if _lib.exporting():
        from tpu_superresolution_torch.kernels import custom_ops

        if packed is None:
            packed = pack_window_attention(wqkv, bqkv, wproj, bproj, rpb)
        return custom_ops.window_block_attention(
            xw.contiguous(), packed, None if mask is None else mask.float().contiguous(), codes)
    _lib.require_cuda(xw, "fused_window_attention")
    return _kernel_window_attention(xw, wqkv, bqkv, wproj, bproj, rpb, mask, packed, codes,
                                    scale)


def _kernel_window_attention(xw, wqkv, bqkv, wproj, bproj, rpb, mask, packed, codes, scale):
    """The CUDA tensors' path of ``fused_window_attention``: through the
    autograd function when a gradient is wanted, else the three launches
    on the packed weights."""
    xw = xw.contiguous()
    inputs = [xw, wqkv, wproj, bproj] + ([] if bqkv is None else [bqkv])
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs + [rpb] if t is not None):
        rpb = packed.dense_bias() if rpb is None else rpb
        return WindowAttentionFunction.apply(xw, wqkv, bqkv, wproj, bproj, rpb, mask, scale)
    if packed is None:
        packed = pack_window_attention(wqkv, bqkv, wproj, bproj, rpb)
    return _launch(xw, packed, None if mask is None else mask.float().contiguous(), codes)
