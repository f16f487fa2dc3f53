"""HAT on NHWC tensors, serving and training (port of
``tpu_superresolution_tpu/models/hat.py``; reference
modules/hat_arch.py:710-994).

- Parameters carry the reference state-dict key names, so a reference
  checkpoint (after ``interop.strip_reference_buffers``) and the output
  of the JAX package's ``export_hat`` load with ``strict=True``.  The
  reference's ``relative_position_index_SA`` / ``_OCA`` buffers and the
  shift masks are computed from the shapes here.
- HAB (hat_arch.py:200-310): the CAB conv branch runs outside the block
  — LN1 -> conv3x3 -> exact-erf GELU -> conv3x3 as one K12 launch on
  the pre-norm x (the JAX package's ``cab_conv.fused_ln_cab_convs``,
  off there by default), then the RCAN SE gate in plain ops — and
  enters it as ``extra = conv_scale * CAB``; the rest of the block is
  one launch of the block kernel on CUDA (K6 at ws 7, K1 at ws 8) or,
  at any other window (upstream HAT-SRx4's ws 16) or width, the K7
  route (``SwinBlock._window_attention_route``: K2, K7 and K1's tail
  kernel, which adds `extra`).
- OCAB (hat_arch.py:353-439): the JAX package's fused route
  (``OCAB._fused``: K2 LN1, the qkv product with q pre-scaled, the
  gather as plain ops, then K8, the fused attention -> proj -> LN2 ->
  MLP core) where K8 takes the shapes (``fused_ocab.ocab_ok``: ws 7, 8
  and 16 at C <= 192, hidden <= 384) in training, and at upstream HAT's
  ws 16 at inference too (K8w16: ``OCAB.takes_fused``, chosen on the
  card); else the module path: K2 LN1, the qkv product, the window
  partition and overlap gather, K15 (the rectangular window attention,
  ws^2 queries against ows^2 keys), the proj, K2 LN2 and the MLP (HAT's
  ws 7 and hat_fast's ws 8 at inference, C > 192 everywhere).
- RHAG convs, ``conv_after_body`` and ``conv_before_upsample`` are K3,
  the composed reconstruction K4; ``conv_first``, the mean shift, the
  reflect pad and the exact-mode chain are plain torch.
- ``impl="plain"`` runs every kernel's plain version on any device.
- Training: ``model.train()`` draws per-sample stochastic-depth branch
  scales for every HAB (linear decay to ``drop_path_rate``) from the
  generator given to ``forward``; they scale the attention and MLP
  residuals, never the CAB branch (hat_arch.py:307-308), and the OCAB
  has none.  On CUDA each HAB's backward is K6b (ws 7), K5 (ws 8) or
  K5w16 (ws 16, the K7 route's block: ``fused_block.WindowBlockFunction``),
  with the gradient of `extra`, and each OCAB core's K8b (K8bw16 at ws
  16, on K8w16's saved O and row statistics); K12's backward is
  autograd of its plain version, as are K7's,
  K1t's and K15's where a block or OCAB outside those shapes runs them
  in training.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_superresolution_torch.core.config import (
    HATConfig,
    HATFastConfig,
    register_model,
)
from tpu_superresolution_torch.kernels.cab_conv import (
    cab_route,
    fused_ln_cab_convs,
    fused_ln_cab_convs_plain,
    ln_cab_convs,
    pack_cab,
    pack_conv_weight,
)
from tpu_superresolution_torch.kernels.fused_ocab import (
    GRAD_FIELDS,
    W16,
    OcabWeights,
    fused_ocab_core,
    fused_ocab_core_map,
    ocab_ok,
    pack_ocab_tiles,
)
from tpu_superresolution_torch.kernels.window_attention import (
    fused_window_attention,
    fused_window_attention_plain,
)
from tpu_superresolution_torch.models.blocks import (
    Conv3x3,
    ConvLeaky,
    DerivedCache,
    Mlp,
    PixelShuffleUpsample,
    PLayerNorm,
    RGB_MEAN,
    StochasticDepth,
    check_image_size,
    conv_nhwc,
    hwio,
    reference_init,
    remat_block,
    upsample_and_last,
)
from tpu_superresolution_torch.models.swinir import PatchEmbed, SwinBlock
from tpu_superresolution_torch.ops.window import (
    overlap_windows,
    relative_position_bias_oca,
    window_partition,
    window_reverse,
)


class ChannelAttention(nn.Module):
    """RCAN SE gate (hat_arch.py:41-59): global mean -> 1x1 squeeze ->
    ReLU -> 1x1 excite -> sigmoid, multiplied into the features (keys
    ``attention.1`` / ``attention.3``)."""

    def __init__(self, num_feat: int, squeeze_factor: int):
        super().__init__()
        self.attention = nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(num_feat, num_feat // squeeze_factor, 1),
            nn.ReLU(inplace=True),
            nn.Conv2d(num_feat // squeeze_factor, num_feat, 1),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=(1, 2), keepdim=True)
        y = F.relu(conv_nhwc(self.attention[1], y))
        return x * torch.sigmoid(conv_nhwc(self.attention[3], y))


class CAB(nn.Module):
    """Channel attention block (hat_arch.py:62-75) on HAB's pre-norm x:
    LN1 (HAB's norm1), conv C -> C/compress, exact GELU, conv back to C
    as one K12 call (its plain version on the CPU or with plain) or,
    past K12's widths (``cab_route``), K2 + K3 (the GELU in its
    epilogue) + K3, then the SE gate (keys ``cab.0``, ``cab.2``,
    ``cab.3``)."""

    def __init__(self, num_feat: int, compress_ratio: int, squeeze_factor: int):
        super().__init__()
        mid = num_feat // compress_ratio
        self.cab = nn.Sequential(
            nn.Conv2d(num_feat, mid, 3, 1, 1),
            nn.GELU(),
            nn.Conv2d(mid, num_feat, 3, 1, 1),
            ChannelAttention(num_feat, squeeze_factor),
        )
        self._packed = DerivedCache()

    def forward(self, x: torch.Tensor, norm: PLayerNorm, plain: bool = False) -> torch.Tensor:
        """x: the pre-norm HAB input; `norm`: HAB's norm1."""
        conv1, conv2 = self.cab[0], self.cab[2]
        dt = x.dtype

        def weights():  # the kernels' [kh, kw, Cin, Cout] layout in x's dtype
            return (norm.weight, norm.bias, hwio(conv1.weight).to(dt), conv1.bias,
                    hwio(conv2.weight).to(dt), conv2.bias)

        if plain:
            return self.cab[3](fused_ln_cab_convs_plain(x, *weights()))
        route = cab_route(conv1.in_channels, conv1.out_channels)
        packed = None
        if x.is_cuda:
            # at inference the layouts and the kernels' packing are built
            # once per loaded weights; in training on every call
            def pack():
                w = weights()
                return w, (pack_cab(*w) if route == "K12"
                           else (pack_conv_weight(w[2]), pack_conv_weight(w[4])))

            params = [norm.weight, norm.bias, conv1.weight, conv1.bias, conv2.weight, conv2.bias]
            w, packed = self._packed.get(params, (route, x.device, dt), pack,
                                         lambda: (weights(), None))
        else:
            w = weights()
        if route == "K12":
            y = fused_ln_cab_convs(x, *w, packed=packed)
        else:
            y = ln_cab_convs(x, *w, packed=packed or (None, None))
        return self.cab[3](y)


class HAB(SwinBlock):
    """Hybrid attention block (hat_arch.py:200-310): a Swin block whose
    attention residual also receives ``conv_scale * CAB(LN1(x))``."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 compress_ratio: int, squeeze_factor: int, conv_scale: float,
                 mlp_ratio: float, qkv_bias: bool, gelu_approximate: bool):
        super().__init__(dim, num_heads, window_size, shift_size, mlp_ratio, qkv_bias,
                         gelu_approximate)
        self.conv_block = CAB(dim, compress_ratio, squeeze_factor)
        self.conv_scale = conv_scale

    def trains_on_block_kernel(self, h: int, w: int) -> bool:
        """``SwinBlock.trains_on_block_kernel``, and the CAB on K12, whose
        autograd function (``CabConvsFunction``) keeps only its input: the
        HAB then keeps its input, the CAB's output (the SE gate's input)
        and the CAB term (the block function's `extra`)."""
        conv1 = self.conv_block.cab[0]
        return (cab_route(conv1.in_channels, conv1.out_channels) == "K12"
                and super().trains_on_block_kernel(h, w))

    def forward(self, x: torch.Tensor, plain: bool = False,
                branch_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`branch_scales` [B, 2]: stochastic depth on the attention and
        MLP residuals; the CAB term is never dropped."""
        extra = self.conv_block(x, self.norm1, plain) * self.conv_scale
        return super().forward(x, plain, branch_scales, extra=extra)


class OCAB(nn.Module):
    """Overlapping cross-attention block (hat_arch.py:353-439): q from
    the ws windows, k and v from the enclosing ows windows, then proj,
    residual, LN and MLP — the fused route where ``takes_fused`` (K8 /
    K8w16), else the module path with K15 as its attention."""

    def __init__(self, dim: int, window_size: int, overlap_ratio: float, num_heads: int,
                 qkv_bias: bool, mlp_ratio: float, gelu_approximate: bool):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.overlap_win_size = int(window_size * overlap_ratio) + window_size
        self.gelu_approximate = gelu_approximate
        self.norm1 = PLayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((window_size + self.overlap_win_size - 1) ** 2, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = PLayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self._bias = DerivedCache()
        self._pack = DerivedCache()

    def takes_k8(self) -> bool:
        """Whether training runs the fused route (K8 takes the shapes)."""
        return ocab_ok(self.window_size, self.overlap_win_size, self.proj.in_features,
                       self.num_heads, self.mlp.fc1.out_features)

    def takes_fused(self) -> bool:
        """Whether this call runs the fused route: in training wherever
        K8 takes the shapes, at inference where it takes them at ws 16
        (K8w16; ``ocab_ok`` holds ws 16 to ows 24), as the JAX package's
        INFERENCE_FUSED.  Chosen on the card: at HAT-SRx4's bench batch
        the OCAB's forward is faster fused than on the module path
        (PERF.md, PR 20); ws 7 and 8 keep the module path."""
        return self.takes_k8() and (self.training or self.window_size == 16)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        if self.takes_fused():
            return self._fused(x, plain)
        return self._module(x, plain)

    def bias_oca(self) -> torch.Tensor:
        """The gathered bias [nH, ws^2, ows^2] (cached outside autograd)."""
        table, ws, ows = self.relative_position_bias_table, self.window_size, self.overlap_win_size
        return self._bias.get([table], (ws, ows, table.device),
                              lambda: relative_position_bias_oca(table, ws, ows))

    def qkv_map(self, x: torch.Tensor, plain: bool, prescale: bool) -> torch.Tensor:
        """K2 LN1 and the qkv product: [B, H, W, 3C]; with `prescale` the q
        rows pre-scaled by hd^-0.5 (the fused route's weights, the JAX
        package's ``_prep_weights``)."""
        c, dt = x.shape[-1], x.dtype
        wq, bq = self.qkv.weight, self.qkv.bias
        if prescale:
            qscale = torch.ones(3 * c, device=x.device)
            qscale[:c] = (c // self.num_heads) ** -0.5
            wq, bq = wq * qscale[:, None], None if bq is None else bq * qscale
        return F.linear(self.norm1(x, plain), wq.to(dt), None if bq is None else bq.to(dt))

    def _module(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        """The module path: K2 LN1, the qkv product, the window partition
        and overlap gather, K15, the proj, K2 LN2 and the MLP."""
        return self.module_core(x, self.qkv_map(x, plain, False), plain)

    def module_core(self, x, qkv, plain: bool) -> torch.Tensor:
        """The module path after the qkv product."""
        b, h, w, c = x.shape
        ws, ows, nh = self.window_size, self.overlap_win_size, self.num_heads
        hd, dt = c // nh, x.dtype
        q, k, v = qkv.chunk(3, dim=-1)
        # [B*nW, nH, N, hd]: ws^2 query rows, ows^2 key and value rows
        qw = window_partition(q, ws).reshape(-1, ws * ws, nh, hd).transpose(1, 2)
        kw = overlap_windows(k, ws, ows).reshape(-1, ows * ows, nh, hd).transpose(1, 2)
        vw = overlap_windows(v, ws, ows).reshape(-1, ows * ows, nh, hd).transpose(1, 2)
        attend = fused_window_attention_plain if plain else fused_window_attention
        out = attend(qw, kw, vw, self.bias_oca(), None, hd ** -0.5)
        out = window_reverse(out.transpose(1, 2).reshape(-1, ws * ws, c), ws, h, w)
        x = F.linear(out, self.proj.weight.to(dt), self.proj.bias.to(dt)) + x
        return x + self.mlp(self.norm2(x, plain), self.gelu_approximate)

    def _fused(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        """The JAX package's fused route (``OCAB._fused``): K2 LN1, the
        qkv product with the q rows pre-scaled, the window partition and
        overlap gather as plain ops (their autograd scatters dq, dk, dv
        back), then the attention -> proj -> LN2 -> MLP core as K8
        (``fused_ocab_core``; its plain version with `plain` or on the
        CPU).  At ws 16 on CUDA K8w16 takes the maps themselves
        (``fused_ocab_core_map``: one gather from the qkv map to its
        head-major operands, the residual and output in map layout)."""
        return self.fused_core(x, self.qkv_map(x, plain, True), plain)

    def fused_core(self, x, qkv, plain: bool) -> torch.Tensor:
        """The fused route after the qkv product (q pre-scaled)."""
        b, h, w, c = x.shape
        ws, ows = self.window_size, self.overlap_win_size
        weights = OcabWeights(
            wproj=self.proj.weight, bproj=self.proj.bias, g2=self.norm2.weight,
            b2=self.norm2.bias, wfc1=self.mlp.fc1.weight, bfc1=self.mlp.fc1.bias,
            wfc2=self.mlp.fc2.weight, bfc2=self.mlp.fc2.bias, num_heads=self.num_heads)
        if (ws, ows) == W16 and x.is_cuda and not plain:
            params = [getattr(weights, f) for f in GRAD_FIELDS]
            # K8w16's weight stream, cached outside autograd
            packed = self._pack.get(params, x.device, lambda: pack_ocab_tiles(weights),
                                    lambda: None)
            return fused_ocab_core_map(qkv, x, weights, self.bias_oca(), self.gelu_approximate,
                                       packed)
        q, k, v = qkv.chunk(3, dim=-1)
        out = fused_ocab_core(
            window_partition(q, ws), overlap_windows(k, ws, ows), overlap_windows(v, ws, ows),
            window_partition(x, ws), weights, self.bias_oca(), self.gelu_approximate, plain)
        return window_reverse(out, ws, h, w)


class AttenBlocks(nn.Module):
    """The reference's residual_group: the HABs and the OCAB."""

    def __init__(self, blocks, overlap_attn: OCAB):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.overlap_attn = overlap_attn


class RHAG(nn.Module):
    """Residual hybrid attention group (hat_arch.py:538-620): depth x HAB
    (shift 0, ws//2 alternating) -> OCAB -> conv (K3) -> + input.  With
    ``use_remat``, each HAB's activations are recomputed in the backward
    pass in training (``blocks.remat_block``; the JAX model's
    ``nn.remat(HAB)``), except where its kernels' autograd functions
    already do (``HAB.trains_on_block_kernel``); the OCAB and the conv
    stay outside."""

    def __init__(self, cfg: HATConfig, depth: int, num_heads: int):
        super().__init__()
        c, ws = cfg.embed_dim, cfg.window_size
        self.residual_group = AttenBlocks(
            [HAB(c, num_heads, ws, 0 if j % 2 == 0 else ws // 2, cfg.compress_ratio,
                 cfg.squeeze_factor, cfg.conv_scale, cfg.mlp_ratio, cfg.qkv_bias,
                 cfg.gelu_approximate) for j in range(depth)],
            OCAB(c, ws, cfg.overlap_ratio, num_heads, cfg.qkv_bias, cfg.mlp_ratio,
                 cfg.gelu_approximate),
        )
        self.conv = Conv3x3(c, c) if cfg.resi_connection == "1conv" else None
        self.use_remat = cfg.use_remat

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
        x = self.residual_group.overlap_attn(x, plain)
        if self.conv is not None:
            x = self.conv(x, plain)
        return x + res


class HAT(StochasticDepth, nn.Module):
    """Full HAT: x [B, H, W, in] -> [B, H*s, W*s, out]."""

    def __init__(self, config: HATConfig, dtype: Optional[torch.dtype] = None,
                 impl: str = "auto"):
        super().__init__()
        if impl not in ("auto", "plain"):
            raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
        if config.upsampler != "pixelshuffle":
            raise ValueError(f"HAT has the 'pixelshuffle' reconstruction only, got "
                             f"{config.upsampler!r} (hat_arch.py:864-869)")
        if config.resi_connection not in ("1conv", "identity"):
            raise ValueError(f"unknown resi_connection {config.resi_connection!r}")
        cfg = config
        self.config, self.impl = cfg, impl
        self.dtype = torch.float32 if dtype is None else dtype
        c, nf = cfg.embed_dim, cfg.num_feat
        mean = RGB_MEAN if cfg.in_channels == 3 else (0.0,) * cfg.in_channels
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32), persistent=False)

        self.conv_first = nn.Conv2d(cfg.in_channels, c, 3, 1, 1)
        if cfg.patch_norm:
            self.patch_embed = PatchEmbed(c)
        self.layers = nn.ModuleList(RHAG(cfg, d, cfg.num_heads[i])
                                    for i, d in enumerate(cfg.depths))
        self.norm = PLayerNorm(c)
        if cfg.resi_connection == "1conv":
            self.conv_after_body = Conv3x3(c, c)
        self.conv_before_upsample = ConvLeaky(c, nf, 0.01)
        self.upsample = PixelShuffleUpsample(cfg.scale, nf)
        self.conv_last = nn.Conv2d(nf, cfg.out_channels, 3, 1, 1)
        self._composed = DerivedCache()
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The reference initialisation (hat_arch.py:_init_weights, the
        same rule as SwinIR's), drawn from `generator`."""
        reference_init(self, generator)

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

        x = conv_nhwc(self.conv_first, x)
        feats = self.patch_embed.norm(x, plain) if cfg.patch_norm else x
        scales = self.sample_branch_scales(x.shape[0], generator, x.device)
        for i, layer in enumerate(self.layers):
            feats = layer(feats, plain, None if scales is None else scales[i])
        feats = self.norm(feats, plain)
        if cfg.resi_connection == "1conv":
            feats = self.conv_after_body(feats, plain)
        x = feats + x

        x = self.conv_before_upsample(x, plain)
        x = upsample_and_last(x, self.upsample, self.conv_last, cfg.fused_reconstruct,
                              self._composed, plain)
        x = x / cfg.img_range + mean
        return x[:, : h_in * cfg.scale, : w_in * cfg.scale, :]


def build_hat(config: HATConfig, dtype=None, impl: str = "auto") -> HAT:
    """A HAT in eval mode, as the JAX package's ``train=False`` default:
    ``model.train()`` turns on stochastic depth and the OCAB's training
    route."""
    return HAT(config, dtype=dtype, impl=impl).eval()


register_model("hat", HATConfig, build_hat)
register_model("hat_fast", HATFastConfig, build_hat)

__all__ = ["HAT", "HAB", "OCAB", "CAB", "RHAG", "build_hat"]
