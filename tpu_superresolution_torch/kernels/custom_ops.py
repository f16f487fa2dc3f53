"""The kernels of every inference forward as ``torch.library`` custom
ops, for ``torch.export`` only (``interop/export.py``).

Each kernel a model's eval forward can launch has an op: K1 and K6 (the
Swin block at ws 8 and 7, with HAT's `extra`), K1t (the K7 route's
tail), K2 (LayerNorm), K3 and K4 (the convs), K7 (window attention on
any window and width), K8w16 (HAT-SRx4's OCAB core on the qkv map), K9
and K14 (DAT's spatial and channel fronts), K10 (DAT's block tail), K11
(the depthwise conv), K12 (HAT's CAB) and K15 / K16 (window attention
on pre-split q, k, v).  Their wrappers call these ops only while
``torch.export`` traces (``_lib.exporting()``), after the CPU branch
and before any ctypes work, so that the exported program holds one op
node a counted launch; in eager code the wrappers keep their direct
ctypes calls.  Each op's body is the wrapper's launch function (counted
on the kernel's counter as any launch, a K7, K9, K12 or K14 call once
over its CUDA launches), on the operands the eager path would pass
(packed weights where the eager path caches them: the export captures
the cached packs as constants); scratch workspaces are allocated inside
the body; each ``register_fake`` gives the output's shape, dtype and
contiguity without reading data.  On CPU tensors the ops whose operands
are the plain version's own (K2, K3, K4, K11, K15 / K16) run the plain
versions; the ops on packed weights take CUDA tensors only (the CPU
exports the plain path and never reaches them).  No op falls back to a
plain version when a launch or a build fails.

The training-only kernels (K5, K5r, K5w16, K6b, K8, K8b, K8bw16) have
no op: no eval forward launches them.  Stochastic-depth branch scales
exist only in training and are refused while exporting.

Importing ``tpu_superresolution_torch.kernels`` registers the ops;
nothing is built until the first launch.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch.library import custom_op

from tpu_superresolution_torch.kernels import (
    _lib,
    cab_conv,
    dwconv,
    fused_attention,
    fused_block,
    fused_channel_attn,
    fused_datb_tail,
    fused_ocab,
    fused_rect_attn,
    layernorm,
    window_attention,
)

# the kernels these ops register, by counter key: every kernel an
# inference forward can launch
EXPORTABLE = ("K1", "K1t", "K2", "K3", "K4", "K6", "K7", "K8w16", "K9", "K10", "K11", "K12",
              "K14", "K15", "K16")


def _like(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x, memory_format=torch.contiguous_format)


# ----------------------------------------------------------------- K2


@custom_op("tpu_sr::layernorm", mutates_args=())
def layernorm_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """K2 (``layernorm.layernorm``'s launch)."""
    x = x.contiguous()
    if x.device.type == "cpu":
        return layernorm.layernorm_plain(x, weight, bias, eps)
    return layernorm._launch(x, weight, bias, eps)


@layernorm_op.register_fake
def _(x, weight, bias, eps):
    return _like(x)


# ------------------------------------------------------------- K3, K4


def _conv(x, kernel, bias, wp, pad, name, gelu=False):
    x = x.contiguous()
    if x.device.type == "cpu":
        return cab_conv.conv_plain(x, kernel, bias, pad, gelu)
    packed = None
    if wp is not None:
        kh, kw, cin, cout = (int(d) for d in kernel.shape)
        packed = cab_conv.PackedConv(wp=wp, plan=cab_conv.conv_route(cin, cout, kh, kw), kh=kh,
                                     kw=kw, cin=cin, cout=cout)
    return cab_conv._launch(x, kernel, bias, pad, name, packed, gelu)


def _conv_fake(x, kernel):
    return x.new_empty((*x.shape[:3], kernel.shape[3]))


@custom_op("tpu_sr::conv3x3_halo", mutates_args=())
def conv3x3_op(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
               wp: Optional[torch.Tensor], gelu: bool) -> torch.Tensor:
    """K3 (``cab_conv.conv3x3``'s launch); `wp` the packed weight
    (``pack_conv_weight``) or None (packed on the card in the launch)."""
    return _conv(x, kernel, bias, wp, ((1, 1), (1, 1)), "conv3x3", gelu)


@conv3x3_op.register_fake
def _(x, kernel, bias, wp, gelu):
    return _conv_fake(x, kernel)


@custom_op("tpu_sr::conv_halo", mutates_args=())
def conv_k_op(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
              wp: Optional[torch.Tensor], pad: List[int]) -> torch.Tensor:
    """K4 (``cab_conv.conv_k``'s launch); `pad` [top, bottom, left, right]."""
    return _conv(x, kernel, bias, wp, ((pad[0], pad[1]), (pad[2], pad[3])), "conv_k")


@conv_k_op.register_fake
def _(x, kernel, bias, wp, pad):
    return _conv_fake(x, kernel)


# ------------------------------------------------------------- K1, K6


@custom_op("tpu_sr::swin_block", mutates_args=())
def swin_block_op(x: torch.Tensor, tiles: torch.Tensor, bqkv: torch.Tensor,
                  bproj: torch.Tensor, bfc1: torch.Tensor, bfc2: torch.Tensor,
                  g1: torch.Tensor, b1: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                  table: torch.Tensor, num_heads: int, hidden: int, ws: int, shift: int,
                  masked: bool, gelu_approx: bool,
                  extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 (ws 8) or K6 (ws 7), ``fused_block.fused_windows_block``'s
    launch at inference, on ``pack_block_tiles``' operands; `masked`
    whether the shifted windows take the shift mask; `extra` HAT's CAB
    term (or None)."""
    _lib.require_cuda(x, "tpu_sr::swin_block")
    c = int(x.shape[-1])
    packed = fused_block.PackedBlockTiles(
        tiles=tiles, bqkv=bqkv, bproj=bproj, bfc1=bfc1, bfc2=bfc2, g1=g1, b1=b1, g2=g2, b2=b2,
        table=table, dim=c, num_heads=num_heads, hidden=hidden, window_size=ws,
        layout=fused_block.stream_layout(c, num_heads, hidden))
    return fused_block._launch_block(x.contiguous(), packed, shift, True if masked else None,
                                     gelu_approx, None,
                                     None if extra is None else extra.contiguous())


@swin_block_op.register_fake
def _(x, tiles, bqkv, bproj, bfc1, bfc2, g1, b1, g2, b2, table, num_heads, hidden, ws, shift,
      masked, gelu_approx, extra=None):
    return _like(x)


def swin_block(x: torch.Tensor, packed, shift: int, masked: bool, gelu_approx: bool,
               extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``swin_block_op`` on a ``PackedBlockTiles``."""
    p = packed
    return swin_block_op(x, p.tiles, p.bqkv, p.bproj, p.bfc1, p.bfc2, p.g1, p.b1, p.g2, p.b2,
                         p.table, p.num_heads, p.hidden, p.window_size, shift, masked,
                         gelu_approx, extra)


# ---------------------------------------------------------------- K1t


@custom_op("tpu_sr::swin_block_tail", mutates_args=())
def swin_block_tail_op(x: torch.Tensor, attn: torch.Tensor, extra: Optional[torch.Tensor],
                       packs: List[torch.Tensor], route: str, hidden: int, ws: int, shift: int,
                       gelu_approx: bool) -> torch.Tensor:
    """K1t (``fused_block.fused_block_tail``'s launch at inference) on
    ``pack_block_tail``'s operands for `route`: "wgmma" [tiles, vec],
    "wmma" [wfc1, bfc1, wfc2, bfc2, g2, b2]."""
    _lib.require_cuda(x, "tpu_sr::swin_block_tail")
    c = int(x.shape[-1])
    if route == "wgmma":
        packed = fused_block.PackedTailWg(*packs, dim=c, hidden=hidden)
    else:
        packed = fused_block.PackedBlockTail(*packs, dim=c, hidden=hidden)
    return fused_block._launch_tail(x.contiguous(), attn.contiguous(), packed, ws, shift,
                                    gelu_approx, None,
                                    None if extra is None else extra.contiguous())


@swin_block_tail_op.register_fake
def _(x, attn, extra, packs, route, hidden, ws, shift, gelu_approx):
    return _like(x)


def swin_block_tail(x: torch.Tensor, attn: torch.Tensor, extra: Optional[torch.Tensor],
                    packed, ws: int, shift: int, gelu_approx: bool) -> torch.Tensor:
    """``swin_block_tail_op`` on a ``PackedTailWg`` or ``PackedBlockTail``."""
    p = packed
    packs = ([p.tiles, p.vec] if p.route == "wgmma"
             else [p.wfc1, p.bfc1, p.wfc2, p.bfc2, p.g2, p.b2])
    return swin_block_tail_op(x, attn, extra, packs, p.route, p.hidden, ws, shift, gelu_approx)


# ----------------------------------------------------------------- K7


@custom_op("tpu_sr::window_block_attention", mutates_args=())
def window_block_attention_op(xw: torch.Tensor, qkv_wp: torch.Tensor, qkv_b: torch.Tensor,
                              proj_wp: torch.Tensor, proj_b: torch.Tensor,
                              rpb: Optional[torch.Tensor], table: Optional[torch.Tensor],
                              mask: Optional[torch.Tensor], codes: Optional[torch.Tensor],
                              ws: int, num_heads: int) -> torch.Tensor:
    """K7 (``fused_attention.fused_window_attention``'s three launches at
    inference, counted once) on ``pack_window_attention``'s operands."""
    _lib.require_cuda(xw, "tpu_sr::window_block_attention")
    c = int(xw.shape[-1])
    hb = window_attention.head_block(c // num_heads)
    hdw = -(-(c // num_heads) // hb) * hb
    product = lambda wp, b, c_in, c_out: fused_attention.PackedProduct(
        wp=wp, b=b, c_in=c_in, c_out=c_out, plan=fused_attention.product_plan(c_out))
    packed = fused_attention.PackedWindowAttention(
        qkv=product(qkv_wp, qkv_b, c, 3 * num_heads * hdw),
        proj=product(proj_wp, proj_b, num_heads * hdw, c), rpb=rpb, table=table, ws=ws, dim=c,
        num_heads=num_heads)
    return fused_attention._launch(xw.contiguous(), packed, mask, codes)


@window_block_attention_op.register_fake
def _(xw, qkv_wp, qkv_b, proj_wp, proj_b, rpb, table, mask, codes, ws, num_heads):
    return _like(xw)


def window_block_attention(xw: torch.Tensor, packed, mask: Optional[torch.Tensor],
                           codes: Optional[torch.Tensor]) -> torch.Tensor:
    """``window_block_attention_op`` on a ``PackedWindowAttention``."""
    p = packed
    return window_block_attention_op(xw, p.qkv.wp, p.qkv.b, p.proj.wp, p.proj.b, p.rpb, p.table,
                                     mask, codes, p.ws, p.num_heads)


# ---------------------------------------------------------- K15, K16

_ATTENTION_COUNTERS = {"K15": window_attention.launches_rect, "K16": window_attention.launches}


@custom_op("tpu_sr::window_attention", mutates_args=())
def window_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                        mask: Optional[torch.Tensor], scale: float, split_p: bool,
                        counter: str) -> torch.Tensor:
    """K15 or K16, `counter` naming which (``window_attention``'s launch
    on ``k15_route``'s kernel, counted on that kernel's counter)."""
    if q.device.type == "cpu":
        return window_attention.fused_window_attention_plain(q, k, v, bias, mask, scale)
    return window_attention._launch(
        q.contiguous(), k.contiguous(), v.contiguous(), bias.float().contiguous(),
        None if mask is None else mask.float().contiguous(), scale,
        _ATTENTION_COUNTERS[counter], split_p)


@window_attention_op.register_fake
def _(q, k, v, bias, mask, scale, split_p, counter):
    return _like(q)


# ---------------------------------------------------------------- K12


@custom_op("tpu_sr::ln_cab_convs", mutates_args=())
def ln_cab_convs_op(x: torch.Tensor, w1: torch.Tensor, c1: torch.Tensor, w2: torch.Tensor,
                    c2: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                    mid: int) -> torch.Tensor:
    """K12 (``cab_conv.fused_ln_cab_convs``' two launches at inference,
    counted once) on ``pack_cab``'s operands."""
    _lib.require_cuda(x, "tpu_sr::ln_cab_convs")
    c = int(x.shape[-1])
    packed = cab_conv.PackedCab(w1=w1, c1=c1, w2=w2, c2=c2, g=g, b=b, dim=c, mid=mid,
                                plan=cab_conv.cab_plan(c, mid))
    return cab_conv._launch_cab(x.contiguous(), packed)


@ln_cab_convs_op.register_fake
def _(x, w1, c1, w2, c2, g, b, mid):
    return _like(x)


def ln_cab_convs(x: torch.Tensor, packed) -> torch.Tensor:
    """``ln_cab_convs_op`` on a ``PackedCab``."""
    p = packed
    return ln_cab_convs_op(x, p.w1, p.c1, p.w2, p.c2, p.g, p.b, p.mid)


# -------------------------------------------------------------- K8w16


@custom_op("tpu_sr::ocab16", mutates_args=())
def ocab16_op(qkv: torch.Tensor, x: torch.Tensor, tiles: torch.Tensor, bproj: torch.Tensor,
              bfc1: torch.Tensor, bfc2: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
              bias: torch.Tensor, num_heads: int, hidden: int,
              gelu_approx: bool) -> torch.Tensor:
    """K8w16 (``fused_ocab.fused_ocab_core_map``'s gather and core at
    inference, counted once) on ``pack_ocab_tiles``' operands."""
    _lib.require_cuda(x, "tpu_sr::ocab16")
    c = int(x.shape[-1])
    packed = fused_ocab.PackedOcab16(
        tiles=tiles, bproj=bproj, bfc1=bfc1, bfc2=bfc2, g2=g2, b2=b2, dim=c,
        num_heads=num_heads, hidden=hidden,
        layout=fused_block.stream_layout(c, num_heads, hidden))
    qh, kh, vh = fused_ocab._launch_heads(qkv.contiguous(), num_heads, packed.layout.hdp)
    return fused_ocab._launch_fwd16(qh, kh, vh, x.contiguous(), packed,
                                    bias.float().contiguous(), gelu_approx)[0]


@ocab16_op.register_fake
def _(qkv, x, tiles, bproj, bfc1, bfc2, g2, b2, bias, num_heads, hidden, gelu_approx):
    return _like(x)


def ocab16(qkv: torch.Tensor, x: torch.Tensor, packed, bias: torch.Tensor,
           gelu_approx: bool) -> torch.Tensor:
    """``ocab16_op`` on a ``PackedOcab16``."""
    p = packed
    return ocab16_op(qkv, x, p.tiles, p.bproj, p.bfc1, p.bfc2, p.g2, p.b2, bias, p.num_heads,
                     p.hidden, gelu_approx)


# ---------------------------------------------------------- K9, K14


@custom_op("tpu_sr::rect_attention", mutates_args=())
def rect_attention_op(x: torch.Tensor, wp: torch.Tensor, bqkv: torch.Tensor,
                      tables: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
                      wdw: torch.Tensor, bdw: torch.Tensor, num_heads: int, split: List[int],
                      shifted: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 (``fused_rect_attn.rect_attention``'s four launches, counted
    once) on ``pack_rect_weights``' operands: (attened_x, conv_x)."""
    _lib.require_cuda(x, "tpu_sr::rect_attention")
    packed = fused_rect_attn.PackedRect(wp=wp, bqkv=bqkv, tables=tables, g1=g1, b1=b1, wdw=wdw,
                                        bdw=bdw, dim=int(x.shape[-1]), num_heads=num_heads,
                                        split=(int(split[0]), int(split[1])))
    return fused_rect_attn._launch(x.contiguous(), packed, shifted)


@rect_attention_op.register_fake
def _(x, wp, bqkv, tables, g1, b1, wdw, bdw, num_heads, split, shifted):
    return _like(x), _like(x)


def rect_attention(x: torch.Tensor, packed, shifted: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rect_attention_op`` on a ``PackedRect``."""
    p = packed
    return rect_attention_op(x, p.wp, p.bqkv, p.tables, p.g1, p.b1, p.wdw, p.bdw, p.num_heads,
                             list(p.split), shifted)


@custom_op("tpu_sr::channel_attention", mutates_args=())
def channel_attention_op(x: torch.Tensor, wp: torch.Tensor, bqkv: torch.Tensor,
                         temperature: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
                         wdw: torch.Tensor, bdw: torch.Tensor,
                         num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K14 (``fused_channel_attn.channel_attention``'s three launches,
    counted once) on ``pack_chan_weights``' operands: (attened_x, conv_x)."""
    _lib.require_cuda(x, "tpu_sr::channel_attention")
    packed = fused_channel_attn.PackedChan(wp=wp, bqkv=bqkv, temperature=temperature, g1=g1,
                                           b1=b1, wdw=wdw, bdw=bdw, dim=int(x.shape[-1]),
                                           num_heads=num_heads)
    return fused_channel_attn._launch(x.contiguous(), packed)


@channel_attention_op.register_fake
def _(x, wp, bqkv, temperature, g1, b1, wdw, bdw, num_heads):
    return _like(x), _like(x)


def channel_attention(x: torch.Tensor, packed) -> Tuple[torch.Tensor, torch.Tensor]:
    """``channel_attention_op`` on a ``PackedChan``."""
    p = packed
    return channel_attention_op(x, p.wp, p.bqkv, p.temperature, p.g1, p.b1, p.wdw, p.bdw,
                                p.num_heads)


# ---------------------------------------------------------------- K10


@custom_op("tpu_sr::datb_tail", mutates_args=())
def datb_tail_op(x: torch.Tensor, u: torch.Tensor, w_px: torch.Tensor, gate: torch.Tensor,
                 tiles: torch.Tensor, vec: torch.Tensor, half: int) -> torch.Tensor:
    """K10 (``fused_datb_tail.datb_tail``'s launch) on
    ``pack_tail_weights``' operands."""
    _lib.require_cuda(x, "tpu_sr::datb_tail")
    packed = fused_datb_tail.PackedTail(tiles=tiles, vec=vec, dim=int(x.shape[-1]), half=half)
    return fused_datb_tail._launch(x.contiguous(), u.contiguous(), w_px.contiguous(),
                                   gate.float().contiguous(), packed)


@datb_tail_op.register_fake
def _(x, u, w_px, gate, tiles, vec, half):
    return _like(x)


def datb_tail(x, u, w_px, gate, packed) -> torch.Tensor:
    """``datb_tail_op`` on a ``PackedTail``."""
    return datb_tail_op(x, u, w_px, gate, packed.tiles, packed.vec, packed.half)


# ---------------------------------------------------------------- K11


@custom_op("tpu_sr::dwconv3x3", mutates_args=())
def dwconv3x3_op(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K11 (``dwconv.dwconv3x3``'s launch); k [3, 3, C], b [C]."""
    x = x.contiguous()
    if x.device.type == "cpu":
        return dwconv.dwconv3x3_plain(x, k, b)
    return dwconv._launch(x, k, b)


@dwconv3x3_op.register_fake
def _(x, k, b):
    return _like(x)
