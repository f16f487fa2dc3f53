"""SwinIR inference on NHWC tensors (port of
``tpu_superresolution_tpu/models/swinir.py``; reference
network_swinir.py:618-851).

- Parameters carry the reference state-dict key names, so a reference
  checkpoint (after ``interop.strip_reference_buffers``) and the JAX
  package's ``export_swinir`` output load with ``strict=True``.  The
  reference's ``relative_position_index`` / ``attn_mask`` buffers are
  not parameters here: both are computed from the shapes.
- The trunk stays [B, H, W, C].  Each Swin block takes one of three
  routes, chosen from its static shapes by ``fused_block.block_route``:
  one launch of the block kernel on CUDA (K1 at ws 8, K6 at ws 7; the
  cyclic shift in the kernel's addressing), or, for any other window or
  for widths outside the block kernel (C up to 256, up to 8 heads), K1's
  function in three kernels: K2 for LN1, K7 for the window attention
  (any width, head count, head dim and window; at inference its bias
  and shift mask in the compact table + token-code form) and K1's tail
  kernel for the residuals, LN2 and the MLP (the cyclic shift and window
  partition between them as plain gathers).  The
  LayerNorms outside blocks are K2, the trunk 3x3 convs K3 and the
  composed reconstruction conv K4.  ``conv_first``, the mean shift, the reflect
  pad, pixel shuffles and the exact-mode chain are plain torch, as the
  JAX package leaves them to XLA.
- ``impl="plain"`` runs every kernel's plain version on any device.
- Training: ``model.train()`` draws per-sample stochastic-depth branch
  scales for every block (linear decay to ``drop_path_rate``) from the
  generator given to ``forward``; on CUDA each block's backward is K5
  (K6b at ws 7; on the K7 route K5w16 at ws 16 and K5r at ws 8, e.g.
  SwinIR-L's C 240) and the derived weights (K1 packing, conv layouts,
  the composed reconstruction) are rebuilt inside the graph on every step.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_superresolution_torch.core.config import SwinIRConfig, register_model
from tpu_superresolution_torch.kernels.fused_attention import (
    fused_window_attention,
    pack_window_attention,
    window_attention_plain,
)
from tpu_superresolution_torch.kernels.fused_block import (
    SwinBlockWeights,
    block_route,
    fused_block_tail,
    fused_windows_block,
    pack_block_tail,
    pack_block_tiles,
    swin_block_plain,
    tiled_bwd_ok,
    window_block_tiled,
)
from tpu_superresolution_torch.kernels.layernorm import layernorm
from tpu_superresolution_torch.models.blocks import (
    Conv3x3,
    ConvLeaky,
    DerivedCache,
    Mlp,
    PixelShuffleDirect,
    PixelShuffleUpsample,
    PLayerNorm,
    RGB_MEAN,
    StochasticDepth,
    ThreeConv,
    check_image_size,
    conv_nhwc,
    reference_init,
    remat_block,
    upsample_and_last,
)
from tpu_superresolution_torch.ops.window import (
    relative_position_bias,
    shift_mask_tensor,
    window_codes_tensor,
)

class WindowAttention(nn.Module):
    """W-MSA with learned relative position bias (network_swinir.py:65-145).
    Its forward is the plain path on [B*nW, N, C] windows; inside a
    block, K1 consumes its weights directly."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.dim, self.window_size, self.num_heads = dim, window_size, num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads)
        )

    def forward(self, xw: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        ws = math.isqrt(xw.shape[1])
        return window_attention_plain(
            xw, self.qkv.weight, self.qkv.bias, self.proj.weight, self.proj.bias,
            relative_position_bias(self.relative_position_bias_table, ws), mask,
            (self.dim // self.num_heads) ** -0.5,
        )


class SwinBlock(nn.Module):
    """(Shifted) W-MSA + MLP (network_swinir.py:164-279): the block
    kernel (K1 at ws 8, K6 at ws 7) or the K7 route, by
    ``block_route``; each kernel wrapper runs its plain version on the
    CPU, and ``swin_block_plain`` runs the whole block with plain."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True,
                 gelu_approximate: bool = False):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.gelu_approximate = gelu_approximate
        self.norm1 = PLayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias)
        self.norm2 = PLayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self._packed = DerivedCache()

    def _window(self, h: int, w: int) -> Tuple[int, int]:
        """(window, shift) on an h x w map.  Reference rule
        (network_swinir.py:193-196): no partition/shift when the (padded)
        map is not larger than a window."""
        if min(h, w) <= self.window_size:
            return min(h, w), 0
        return self.window_size, self.shift_size

    def trains_on_block_kernel(self, h: int, w: int) -> bool:
        """Whether a training call on CUDA on an h x w map runs the block
        through a block kernel's autograd function: ``SwinBlockFunction``
        (the "block" route, backward K5 / K6b) or ``WindowBlockFunction``
        (a K7-route block that ``tiled_bwd_ok`` takes, backward K5w16 /
        K5r).  Either keeps only the block's inputs, and its backward
        kernel recomputes the rest, so ``use_remat`` leaves such a block
        to it (``blocks.remat_block``).  Shapes only."""
        ws, _ = self._window(h, w)
        a = self.attn
        shape = (ws, a.qkv.in_features, a.num_heads, self.mlp.fc1.out_features,
                 a.qkv.bias is not None)
        return block_route(*shape) == "block" or tiled_bwd_ok(*shape)

    def block_weights(self) -> SwinBlockWeights:
        a, m = self.attn, self.mlp
        return SwinBlockWeights(
            g1=self.norm1.weight, b1=self.norm1.bias,
            wqkv=a.qkv.weight, bqkv=a.qkv.bias, wproj=a.proj.weight, bproj=a.proj.bias,
            g2=self.norm2.weight, b2=self.norm2.bias,
            wfc1=m.fc1.weight, bfc1=m.fc1.bias, wfc2=m.fc2.weight, bfc2=m.fc2.bias,
            table=a.relative_position_bias_table, num_heads=a.num_heads,
        )

    def forward(self, x: torch.Tensor, plain: bool = False,
                branch_scales: Optional[torch.Tensor] = None,
                extra: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`branch_scales` [B, 2]: the sample's stochastic-depth
        multipliers of the attention and MLP branches (None = 1);
        `extra` [B, H, W, C]: a term added unscaled to the attention
        residual (HAT's CAB branch)."""
        _, h, w, _ = x.shape
        ws, shift = self._window(h, w)
        wts = self.block_weights()
        mask = shift_mask_tensor(h, w, ws, shift, x.device) if shift else None
        if plain:
            return swin_block_plain(x, wts, ws, shift, mask, self.gelu_approximate, branch_scales,
                                    extra)
        route = block_route(ws, wts.dim, wts.num_heads, int(wts.wfc1.shape[0]),
                            wts.bqkv is not None)
        if route != "block":
            return self._window_attention_route(x, wts, ws, shift, mask, branch_scales, extra)
        packed = None
        if x.is_cuda:
            # in training the kernels' autograd function packs on every call
            packed = self._packed.get(list(self.parameters()), x.device,
                                      lambda: pack_block_tiles(wts), lambda: None)
        return fused_windows_block(x, wts, ws, shift, mask, self.gelu_approximate, extra=extra,
                                   packed=packed, branch_scales=branch_scales)

    def _window_attention_route(self, x, wts: SwinBlockWeights, ws: int, shift: int, mask,
                                branch_scales, extra) -> torch.Tensor:
        """K1's function for blocks outside the block kernel:
        ``swin_block_plain``'s composition with K2 for LN1, the cyclic
        shift and window partition as plain gathers, K7 on [B*nW, N, C]
        and K1's tail kernel (attention residual through the window
        reverse and unshift, `extra`, LN2, MLP, residual); each wrapper's
        plain version on the CPU.  At inference on CUDA the kernels'
        weights (with the relative-position table) are packed once per
        loaded weights, and K7 takes the bias and mask as the table and
        the map's token codes.  In training on CUDA a block that
        ``tiled_bwd_ok`` takes (ws 16 within the block kernel's widths; ws 8
        past them, to C 256, 8 heads, hidden 512) runs that composition
        forward and K5w16 / K5r backward (``fused_block.window_block_tiled``);
        elsewhere the backward is autograd of the wrappers."""
        pa = pt = codes = None
        if x.is_cuda:
            def pack():
                return (pack_window_attention(wts.wqkv, wts.bqkv, wts.wproj, wts.bproj,
                                              table=wts.table, ws=ws),
                        pack_block_tail(wts.g2, wts.b2, wts.wfc1, wts.bfc1, wts.wfc2, wts.bfc2))

            pa, pt = self._packed.get(list(self.parameters()), ("k7", ws, x.device), pack,
                                      lambda: (None, None))
            codes = window_codes_tensor(x.shape[1], x.shape[2], ws, shift, x.device)

        def attention(xw, w, ws, mask):
            rpb = None if pa is not None else relative_position_bias(w.table, ws)
            return fused_window_attention(xw, w.wqkv, w.bqkv, w.wproj, w.bproj, rpb, mask,
                                          packed=pa, codes=codes)

        def route(x, w, scales, extra):
            return swin_block_plain(
                x, w, ws, shift, mask, self.gelu_approximate, scales, extra,
                ln1=lambda x, g, b: layernorm(x.contiguous(), g, b), attention=attention,
                tail=functools.partial(fused_block_tail, packed=pt))

        if (x.is_cuda and torch.is_grad_enabled()
                and tiled_bwd_ok(ws, wts.dim, wts.num_heads, int(wts.wfc1.shape[0]),
                                 wts.bqkv is not None)):
            return window_block_tiled(x, wts, ws, shift, mask, self.gelu_approximate,
                                      branch_scales, extra, route)
        return route(x, wts, branch_scales, extra)


class BasicLayer(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    """depth x SwinBlock -> conv -> + input (network_swinir.py:419-482).
    With `use_remat`, each block's activations are recomputed in the
    backward pass in training (``blocks.remat_block``; the JAX model's
    ``nn.remat(SwinBlock)``), except where a block kernel's autograd
    function already does (``SwinBlock.trains_on_block_kernel``); the
    conv stays outside."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, qkv_bias: bool, resi_connection: str,
                 gelu_approximate: bool, use_remat: bool = False):
        super().__init__()
        self.use_remat = use_remat
        self.residual_group = BasicLayer(
            SwinBlock(dim, num_heads, window_size, 0 if j % 2 == 0 else window_size // 2,
                      mlp_ratio, qkv_bias, gelu_approximate)
            for j in range(depth)
        )
        self.conv = Conv3x3(dim, dim) if resi_connection == "1conv" else ThreeConv(dim)

    def forward(self, x: torch.Tensor, plain: bool = False,
                branch_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`branch_scales` [depth, B, 2] or None (no stochastic depth)."""
        res = x
        remat = self.use_remat and self.training and torch.is_grad_enabled()
        for j, blk in enumerate(self.residual_group.blocks):
            scales = None if branch_scales is None else branch_scales[j]
            if remat and not (x.is_cuda and not plain
                              and blk.trains_on_block_kernel(x.shape[1], x.shape[2])):
                x = remat_block(blk, x, plain, scales)
            else:
                x = blk(x, plain, scales)
        return self.conv(x, plain) + res


class PatchEmbed(nn.Module):
    """Holds the patch-embedding LayerNorm (key ``patch_embed.norm``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = PLayerNorm(dim)


class SwinIR(StochasticDepth, nn.Module):
    """Full SwinIR at inference: x [B, H, W, in] -> [B, H*s, W*s, out]."""

    def __init__(self, config: SwinIRConfig, dtype: Optional[torch.dtype] = None,
                 impl: str = "auto"):
        super().__init__()
        if impl not in ("auto", "plain"):
            raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
        cfg = config
        self.config, self.impl = cfg, impl
        self.dtype = torch.float32 if dtype is None else dtype
        c, nf = cfg.embed_dim, cfg.num_feat
        mean = RGB_MEAN if cfg.in_channels == 3 else (0.0,) * cfg.in_channels
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32), persistent=False)

        self.conv_first = nn.Conv2d(cfg.in_channels, c, 3, 1, 1)
        if cfg.patch_norm:
            self.patch_embed = PatchEmbed(c)
        if cfg.ape:
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, cfg.img_size ** 2, c))
        self.layers = nn.ModuleList(
            RSTB(c, d, cfg.num_heads[i], cfg.window_size, cfg.mlp_ratio, cfg.qkv_bias,
                 cfg.resi_connection, cfg.gelu_approximate, cfg.use_remat)
            for i, d in enumerate(cfg.depths)
        )
        self.norm = PLayerNorm(c)
        self.conv_after_body = Conv3x3(c, c) if cfg.resi_connection == "1conv" else ThreeConv(c)

        if cfg.upsampler == "pixelshuffle":
            self.conv_before_upsample = ConvLeaky(c, nf, 0.01)
            self.upsample = PixelShuffleUpsample(cfg.scale, nf)
            self.conv_last = nn.Conv2d(nf, cfg.out_channels, 3, 1, 1)
        elif cfg.upsampler == "pixelshuffledirect":
            self.upsample = PixelShuffleDirect(cfg.scale, c, cfg.out_channels)
        elif cfg.upsampler == "nearest+conv":
            self.conv_before_upsample = ConvLeaky(c, nf, 0.01)
            self.conv_up1 = Conv3x3(nf, nf)
            if cfg.scale == 4:
                self.conv_up2 = Conv3x3(nf, nf)
            self.conv_hr = Conv3x3(nf, nf)
            self.conv_last = nn.Conv2d(nf, cfg.out_channels, 3, 1, 1)
        elif cfg.upsampler == "":
            self.conv_last = nn.Conv2d(c, cfg.out_channels, 3, 1, 1)
        else:
            raise ValueError(f"unknown upsampler {cfg.upsampler!r}")
        self._composed = DerivedCache()
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The reference initialisation (network_swinir.py:_init_weights,
        ``blocks.reference_init``) and the absolute position embedding's
        trunc-normal(0.02); drawn from `generator`."""
        reference_init(self, generator)
        if self.config.ape:
            with torch.no_grad():
                nn.init.trunc_normal_(self.absolute_pos_embed, std=0.02, generator=generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` draws the stochastic-depth masks in train() mode
        (the torch default generator when None); eval() runs none."""
        cfg = self.config
        dt = self.dtype
        plain = self.impl == "plain"
        h_in, w_in = x.shape[1], x.shape[2]
        x = check_image_size(x.to(dt), cfg.window_size)
        mean = self.mean.to(dt)
        x = (x - mean) * cfg.img_range
        x_norm_in = x

        # 1. shallow features
        x = conv_nhwc(self.conv_first, x)
        # 2. deep features
        feats = x
        if cfg.patch_norm:
            feats = self.patch_embed.norm(feats, plain)
        if cfg.ape:
            feats = feats + self.absolute_pos_embed.reshape(
                cfg.img_size, cfg.img_size, -1)[None].to(dt)
        scales = self.sample_branch_scales(x.shape[0], generator, x.device)
        for i, layer in enumerate(self.layers):
            feats = layer(feats, plain, None if scales is None else scales[i])
        feats = self.norm(feats, plain)
        x = self.conv_after_body(feats, plain) + x

        # 3. reconstruction
        if cfg.upsampler == "pixelshuffle":
            x = self.conv_before_upsample(x, plain)
            x = upsample_and_last(x, self.upsample, self.conv_last, cfg.fused_reconstruct,
                                  self._composed, plain)
        elif cfg.upsampler == "pixelshuffledirect":
            x = self.upsample(x)
        elif cfg.upsampler == "nearest+conv":
            x = self.conv_before_upsample(x, plain)
            x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            x = F.leaky_relu(self.conv_up1(x, plain), 0.2)
            if cfg.scale == 4:
                x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                x = F.leaky_relu(self.conv_up2(x, plain), 0.2)
            x = F.leaky_relu(self.conv_hr(x, plain), 0.2)
            x = conv_nhwc(self.conv_last, x)
        else:  # denoise / artifact reduction (network_swinir.py:832-836)
            x = x_norm_in + conv_nhwc(self.conv_last, x)

        x = x / cfg.img_range + mean
        s = cfg.scale if cfg.upsampler else 1
        return x[:, : h_in * s, : w_in * s, :]


def build_swinir(config: SwinIRConfig, dtype=None, impl: str = "auto") -> SwinIR:
    """A SwinIR in eval mode, as the JAX package's ``train=False``
    default: ``model.train()`` turns stochastic depth on."""
    return SwinIR(config, dtype=dtype, impl=impl).eval()


register_model("swinir", SwinIRConfig, build_swinir)

__all__ = ["SwinIR", "SwinBlock", "RSTB", "WindowAttention", "build_swinir"]
