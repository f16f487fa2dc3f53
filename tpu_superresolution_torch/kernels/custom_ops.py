"""The main path's kernels as ``torch.library`` custom ops, for
``torch.export`` only (``interop/export.py``).

SwinIR-M x4 serving runs four kernels: K1 (the Swin block,
``fused_block``), K2 (LayerNorm), K3 (the 3x3 conv) and K4 (the composed
reconstruction conv).  Their wrappers call these ops only while
``torch.export`` traces (``_lib.exporting()``), before any ctypes work,
so that the exported program holds one op node a launch; in eager code
the wrappers keep their direct ctypes calls.  Each op's body is the
wrapper's launch (counted on the kernel's counter as any launch), on
the operands the eager path would pass (packed weights where the eager
path caches them: the export captures the cached packs as constants);
each ``register_fake`` gives the output's shape and dtype.  On CPU
tensors K2, K3 and K4's ops run the plain versions; K1's op takes CUDA
tensors only (the CPU exports the plain path and never reaches it).

Importing ``tpu_superresolution_torch.kernels`` registers the ops;
nothing is built until the first launch.  The other kernels have no op
yet: ``interop.export`` refuses a model on CUDA whose forward launches
one (ROADMAP.md Queue 1 item 5b).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch.library import custom_op

from tpu_superresolution_torch.kernels import _lib, cab_conv, fused_block, layernorm

# the kernels these ops register, by counter key
EXPORTABLE = ("K1", "K2", "K3", "K4")


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
    return torch.empty_like(x, memory_format=torch.contiguous_format)


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


@custom_op("tpu_sr::swin_block", mutates_args=())
def swin_block_op(x: torch.Tensor, tiles: torch.Tensor, bqkv: torch.Tensor,
                  bproj: torch.Tensor, bfc1: torch.Tensor, bfc2: torch.Tensor,
                  g1: torch.Tensor, b1: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                  table: torch.Tensor, num_heads: int, hidden: int, ws: int, shift: int,
                  masked: bool, gelu_approx: bool) -> torch.Tensor:
    """K1 (``fused_block.fused_windows_block``'s launch at inference) on
    ``pack_block_tiles``' operands; `masked` whether the shifted windows
    take the shift mask."""
    _lib.require_cuda(x, "tpu_sr::swin_block")
    c = int(x.shape[-1])
    packed = fused_block.PackedBlockTiles(
        tiles=tiles, bqkv=bqkv, bproj=bproj, bfc1=bfc1, bfc2=bfc2, g1=g1, b1=b1, g2=g2, b2=b2,
        table=table, dim=c, num_heads=num_heads, hidden=hidden, window_size=ws,
        layout=fused_block.stream_layout(c, num_heads, hidden))
    return fused_block._launch_block(x.contiguous(), packed, shift, True if masked else None,
                                     gelu_approx, None)


@swin_block_op.register_fake
def _(x, tiles, bqkv, bproj, bfc1, bfc2, g1, b1, g2, b2, table, num_heads, hidden, ws, shift,
      masked, gelu_approx):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def swin_block(x: torch.Tensor, packed, shift: int, masked: bool,
               gelu_approx: bool) -> torch.Tensor:
    """``swin_block_op`` on a ``PackedBlockTiles``."""
    p = packed
    return swin_block_op(x, p.tiles, p.bqkv, p.bproj, p.bfc1, p.bfc2, p.g1, p.b1, p.g2, p.b2,
                         p.table, p.num_heads, p.hidden, p.window_size, shift, masked,
                         gelu_approx)
