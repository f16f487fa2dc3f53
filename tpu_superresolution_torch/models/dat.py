"""DAT on NHWC tensors, serving (port of
``tpu_superresolution_tpu/models/dat.py``; reference
modules/dat_arch.py:699-859, Chen et al., "Dual Aggregation Transformer
for Image Super-Resolution", ICCV 2023).

- Parameters and buffers carry the reference state-dict key names, so a
  reference checkpoint (after ``interop.strip_reference_buffers``, which
  drops its ``rpe_biases``, ``relative_position_index`` and
  ``attn_mask_*``) and the output of the port's
  ``dat_state_dict_from_jax`` load with ``strict=True``.  BatchNorm runs
  on its running statistics.
- A block alternates (dat_arch.py:538-549): even blocks are spatial
  (two rectangular-window branches, s0 x s1 and s1 x s0, on half the
  channels each), odd blocks channel attention (XCiT).  Shifted spatial
  blocks follow the reference rule (dat_arch.py:290, 389; the JAX
  package's ``DATB``): group i even at j = 2, 6, ...; i odd at j = 0, 4.
- On CUDA every block is three launches: its front (K9 for a spatial
  block, K14 for a channel block), the AIM channel gate in plain torch
  ops (GAP -> 1x1 -> BatchNorm -> erf GELU -> 1x1 -> sigmoid, a [B, C]
  vector, as the JAX package leaves it to XLA), and the tail K10 with
  u = attened_x, w_px = conv_x (spatial) or u = conv_x, w_px =
  attened_x (channel).  BatchNorm is folded into the depthwise and 1x1
  weights, and the dynamic position bias (a small MLP of the parameters
  only) is built once per loaded weights with the kernels' packing
  (``DerivedCache``).  Every image size runs; nothing falls back.
- ``before_RG`` and ``norm`` go through K2, the 3x3 convs of the groups,
  ``conv_after_body`` and ``conv_before_upsample`` through K3, the
  composed reconstruction through K4; ``conv_first``, the mean shift and
  the exact-mode chain are plain torch.  ``impl="plain"`` runs every
  kernel's plain version on any device.
- Serving only: training DAT (BatchNorm batch statistics, drop path,
  the depthwise conv K11) is ROADMAP Queue 1's "DAT training";
  ``model.train()`` raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_superresolution_torch.core.config import DATConfig, register_model
from tpu_superresolution_torch.kernels.fused_channel_attn import (
    ChanAttnWeights,
    channel_attention,
    channel_attention_plain,
    pack_chan_weights,
)
from tpu_superresolution_torch.kernels.fused_datb_tail import (
    TailWeights,
    datb_tail,
    datb_tail_plain,
    fold_bn_into_dense,
    pack_tail_weights,
)
from tpu_superresolution_torch.kernels.fused_rect_attn import (
    RectAttnWeights,
    pack_rect_weights,
    rect_attention,
    rect_attention_plain,
)
from tpu_superresolution_torch.kernels.layernorm import layernorm_plain
from tpu_superresolution_torch.models.blocks import (
    Conv3x3,
    ConvLeaky,
    DerivedCache,
    PixelShuffleDirect,
    PixelShuffleUpsample,
    PLayerNorm,
    RGB_MEAN,
    ThreeConv,
    conv_nhwc,
    reference_init,
    upsample_and_last,
)
from tpu_superresolution_torch.ops.window import relative_position_index, rpe_biases

NOT_PORTED = ("DAT training is not ported: the port serves DAT only (ROADMAP Queue 1, "
              "'DAT training': the module chain with BatchNorm batch statistics, drop path "
              "and K11)")


def do_shift(rg_idx: int, b_idx: int) -> bool:
    """The reference's shift rule for block j of group i (dat_arch.py:290,
    389): i even and j in 2, 6, ...; i odd and j in 0, 4, ...  Only
    spatial (even) blocks qualify."""
    i, j = rg_idx, b_idx
    return (i % 2 == 0 and j > 0 and (j - 2) % 4 == 0) or (i % 2 != 0 and j % 4 == 0)


def bn_eval(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Inference BatchNorm on the last axis, in fp32."""
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return (y - bn.running_mean.float()) * s + bn.bias.float()


def _dense(conv: nn.Conv2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """A 1x1 conv as ([out, in] weight, bias) in fp32."""
    return conv.weight.float().flatten(1), conv.bias.float()


class DynamicPosBias(nn.Module):
    """CrossFormer's dynamic position bias (dat_arch.py:93-130, the
    residual=False path): an MLP over the (dh, dw) offsets of a window.
    Keys ``pos_proj``, ``pos{1,2,3}.0`` (LayerNorm), ``pos{1,2,3}.2``."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.pos_dim = dim // 4
        self.pos_proj = nn.Linear(2, self.pos_dim)
        mlp = lambda out: nn.Sequential(PLayerNorm(self.pos_dim), nn.ReLU(),
                                        nn.Linear(self.pos_dim, out))
        self.pos1, self.pos2, self.pos3 = mlp(self.pos_dim), mlp(self.pos_dim), mlp(num_heads)

    def forward(self, biases: torch.Tensor) -> torch.Tensor:
        x = self.pos_proj(biases)
        for seq in (self.pos1, self.pos2, self.pos3):
            x = seq[2](F.relu(layernorm_plain(x, seq[0].weight, seq[0].bias)))
        return x


class RectBranch(nn.Module):
    """One rect-window branch (the reference's Spatial_Attention): holds
    its DynamicPosBias (key ``pos``); the attention itself is K9."""

    def __init__(self, dim: int, num_heads: int, hsp: int, wsp: int):
        super().__init__()
        self.hsp, self.wsp = hsp, wsp
        self.pos = DynamicPosBias(dim // 4, num_heads)

    def bias(self) -> torch.Tensor:
        """[heads, N, N] fp32 bias of the hsp x wsp window."""
        dev = self.pos.pos_proj.weight.device
        table = self.pos(torch.from_numpy(rpe_biases(self.hsp, self.wsp)).to(dev))
        idx = torch.from_numpy(relative_position_index(self.hsp, self.wsp).reshape(-1)).to(dev)
        n = self.hsp * self.wsp
        return table.float()[idx.long()].reshape(n, n, -1).permute(2, 0, 1).contiguous()


class _AIM(nn.Module):
    """The conv branch and the two interaction maps that both attention
    types share (dat_arch.py:299-316): keys ``dwconv.{0,1}``,
    ``channel_interaction.{1,2,4}``, ``spatial_interaction.{0,1,3}``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Sequential(nn.Conv2d(dim, dim, 3, 1, 1, groups=dim),
                                    nn.BatchNorm2d(dim), nn.GELU())
        self.channel_interaction = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(dim, dim // 8, 1), nn.BatchNorm2d(dim // 8),
            nn.GELU(), nn.Conv2d(dim // 8, dim, 1))
        self.spatial_interaction = nn.Sequential(
            nn.Conv2d(dim, dim // 16, 1), nn.BatchNorm2d(dim // 16), nn.GELU(),
            nn.Conv2d(dim // 16, 1, 1))

    def folded_dwconv(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The conv branch's depthwise kernel [3, 3, C] and bias with the
        inference BatchNorm folded in (conv, then BN)."""
        conv, bn = self.dwconv[0], self.dwconv[1]
        return fold_bn_into_dense(conv.weight.float()[:, 0].permute(1, 2, 0), conv.bias.float(),
                                  bn.weight.float(), bn.bias.float(), bn.running_mean.float(),
                                  bn.running_var.float(), bn.eps)

    def channel_gate(self, t: torch.Tensor) -> torch.Tensor:
        """sigmoid(channel_interaction(t)) as a [B, C] fp32 vector."""
        ci = self.channel_interaction
        w1, b1 = _dense(ci[1])
        w2, b2 = _dense(ci[4])
        y = F.gelu(bn_eval(F.linear(t.float().mean(dim=(1, 2)), w1, b1), ci[2]))
        return torch.sigmoid(F.linear(y, w2, b2))

    def spatial_weights(self):
        """The spatial map's 1x1 convs, BatchNorm folded into the first."""
        si = self.spatial_interaction
        w1, b1 = _dense(si[0])
        bn = si[1]
        w1t, b1 = fold_bn_into_dense(w1.t(), b1, bn.weight.float(), bn.bias.float(),
                                     bn.running_mean.float(), bn.running_var.float(), bn.eps)
        w2, b2 = _dense(si[3])
        return w1t.t(), b1, w2, b2


class SpatialAttention(_AIM):
    """Adaptive spatial attention (dat_arch.py:247-438): keys ``qkv``,
    ``proj``, ``attns.{0,1}.pos`` and the AIM modules."""

    def __init__(self, dim: int, num_heads: int, split: Tuple[int, int], qkv_bias: bool):
        super().__init__(dim)
        s0, s1 = split
        self.num_heads, self.split = num_heads, (s0, s1)
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.attns = nn.ModuleList([RectBranch(dim // 2, num_heads // 2, s0, s1),
                                    RectBranch(dim // 2, num_heads // 2, s1, s0)])

    def front_weights(self, norm1: PLayerNorm) -> RectAttnWeights:
        wdw, bdw = self.folded_dwconv()
        return RectAttnWeights(
            g1=norm1.weight, b1=norm1.bias, wqkv=self.qkv.weight, bqkv=self.qkv.bias,
            wdw=wdw, bdw=bdw, bias0=self.attns[0].bias(), bias1=self.attns[1].bias(),
            num_heads=self.num_heads, split=self.split)


class ChannelAttention(_AIM):
    """Adaptive channel attention (dat_arch.py:441-528): keys
    ``temperature``, ``qkv``, ``proj`` and the AIM modules."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool):
        super().__init__(dim)
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def front_weights(self, norm1: PLayerNorm) -> ChanAttnWeights:
        wdw, bdw = self.folded_dwconv()
        return ChanAttnWeights(
            g1=norm1.weight, b1=norm1.bias, wqkv=self.qkv.weight, bqkv=self.qkv.bias,
            temperature=self.temperature, wdw=wdw, bdw=bdw, num_heads=self.num_heads)


class SpatialGate(nn.Module):
    """SGFN's gate branch: keys ``norm`` and ``conv`` (depthwise 3x3)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = PLayerNorm(dim)
        self.conv = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim)


class SGFN(nn.Module):
    """Spatial-gate FFN (dat_arch.py:38-90): keys ``fc1``, ``sg``, ``fc2``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.sg = SpatialGate(hidden // 2)
        self.fc2 = nn.Linear(hidden // 2, dim)


class DATB(nn.Module):
    """Dual aggregation block (dat_arch.py:531-565): front (K9 or K14),
    the channel gate, tail (K10)."""

    def __init__(self, dim: int, num_heads: int, split: Tuple[int, int], expansion: float,
                 qkv_bias: bool, rg_idx: int, b_idx: int):
        super().__init__()
        self.spatial = b_idx % 2 == 0
        self.shifted = self.spatial and do_shift(rg_idx, b_idx)
        self.norm1 = PLayerNorm(dim)
        self.attn = (SpatialAttention(dim, num_heads, split, qkv_bias) if self.spatial
                     else ChannelAttention(dim, num_heads, qkv_bias))
        self.norm2 = PLayerNorm(dim)
        self.ffn = SGFN(dim, int(dim * expansion))
        self._derived = DerivedCache()

    def tail_weights(self) -> TailWeights:
        sp_w1, sp_b1, sp_w2, sp_b2 = self.attn.spatial_weights()
        f = self.ffn
        return TailWeights(
            sp_w1=sp_w1, sp_b1=sp_b1, sp_w2=sp_w2, sp_b2=sp_b2,
            wproj=self.attn.proj.weight, bproj=self.attn.proj.bias,
            g2=self.norm2.weight, b2=self.norm2.bias, wfc1=f.fc1.weight, bfc1=f.fc1.bias,
            gsg=f.sg.norm.weight, bsg=f.sg.norm.bias,
            wdw=f.sg.conv.weight[:, 0].permute(1, 2, 0), bdw=f.sg.conv.bias,
            wfc2=f.fc2.weight, bfc2=f.fc2.bias)

    def _weights(self, packed: bool):
        """(front, tail) weights and, for the kernels, their packed
        layouts: derived from the parameters and BatchNorm statistics
        once per loaded weights."""
        def build():
            front, tail = self.attn.front_weights(self.norm1), self.tail_weights()
            if not packed:
                return front, tail, None, None
            pack = pack_rect_weights if self.spatial else pack_chan_weights
            return front, tail, pack(front), pack_tail_weights(tail)

        tensors = list(self.parameters()) + list(self.buffers())
        return self._derived.get(tensors, packed, build)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        front, tail, pf, pt = self._weights(packed=not plain and x.is_cuda)
        if self.spatial:
            att, conv = (rect_attention_plain(x, front, self.shifted) if plain
                         else rect_attention(x, front, self.shifted, pf))
            gate, u, w_px = self.attn.channel_gate(conv), att, conv
        else:
            att, conv = (channel_attention_plain(x, front) if plain
                         else channel_attention(x, front, pf))
            gate, u, w_px = self.attn.channel_gate(att), conv, att
        if plain:
            return datb_tail_plain(x, u, w_px, gate, tail)
        return datb_tail(x, u, w_px, gate, tail, pt)


class ResidualGroup(nn.Module):
    """depth x DATB -> conv -> + input (dat_arch.py:568-652): keys
    ``blocks.j`` and ``conv``."""

    def __init__(self, cfg: DATConfig, rg_idx: int):
        super().__init__()
        c = cfg.embed_dim
        self.blocks = nn.ModuleList(
            DATB(c, cfg.num_heads[rg_idx], cfg.split_size, cfg.expansion_factor, cfg.qkv_bias,
                 rg_idx, j) for j in range(cfg.depths[rg_idx]))
        self.conv = Conv3x3(c, c) if cfg.resi_connection == "1conv" else ThreeConv(c)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        res = x
        for blk in self.blocks:
            x = blk(x, plain)
        return self.conv(x, plain) + res


class DAT(nn.Module):
    """Full DAT at inference: x [B, H, W, in] -> [B, H*s, W*s, out]."""

    def __init__(self, config: DATConfig, dtype: Optional[torch.dtype] = None,
                 impl: str = "auto"):
        super().__init__()
        if impl not in ("auto", "plain"):
            raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
        cfg = config
        if cfg.upsampler not in ("pixelshuffle", "pixelshuffledirect"):
            raise ValueError(f"DAT upsampler {cfg.upsampler!r} not supported "
                             "(pixelshuffle | pixelshuffledirect)")
        if cfg.resi_connection not in ("1conv", "3conv"):
            raise ValueError(f"unknown resi_connection {cfg.resi_connection!r}")
        self.config, self.impl = cfg, impl
        self.dtype = torch.float32 if dtype is None else dtype
        c, nf = cfg.embed_dim, cfg.num_feat
        mean = RGB_MEAN if cfg.in_channels == 3 else (0.0,) * cfg.in_channels
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32), persistent=False)

        self.conv_first = nn.Conv2d(cfg.in_channels, c, 3, 1, 1)
        # the reference's Sequential(Rearrange, LayerNorm): key before_RG.1
        self.before_RG = nn.Sequential(nn.Identity(), PLayerNorm(c))
        self.layers = nn.ModuleList(ResidualGroup(cfg, i) for i in range(len(cfg.depths)))
        self.norm = PLayerNorm(c)
        self.conv_after_body = Conv3x3(c, c) if cfg.resi_connection == "1conv" else ThreeConv(c)
        if cfg.upsampler == "pixelshuffle":
            self.conv_before_upsample = ConvLeaky(c, nf, 0.01)
            self.upsample = PixelShuffleUpsample(cfg.scale, nf)
            self.conv_last = nn.Conv2d(nf, cfg.out_channels, 3, 1, 1)
        else:
            self.upsample = PixelShuffleDirect(cfg.scale, c, cfg.out_channels)
        self._composed = DerivedCache()
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The reference initialisation (dat_arch.py:_init_weights: Linear
        trunc-normal(0.02) and zero bias, norms 1 / 0, convs torch's
        default), drawn from `generator`; temperatures 1."""
        reference_init(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, ChannelAttention):
                    m.temperature.fill_(1.0)

    def train(self, mode: bool = True):
        if mode:
            raise NotImplementedError(NOT_PORTED)
        return super().train(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dt = self.dtype
        plain = self.impl == "plain"
        mean = self.mean.to(dt)
        x = (x.to(dt) - mean) * cfg.img_range
        x = conv_nhwc(self.conv_first, x)
        feats = self.before_RG[1](x, plain)
        for layer in self.layers:
            feats = layer(feats, plain)
        feats = self.norm(feats, plain)
        x = self.conv_after_body(feats, plain) + x
        if cfg.upsampler == "pixelshuffle":
            x = self.conv_before_upsample(x, plain)
            x = upsample_and_last(x, self.upsample, self.conv_last, cfg.fused_reconstruct,
                                  self._composed, plain)
        else:
            x = self.upsample(x)
        return x / cfg.img_range + mean


def build_dat(config: DATConfig, dtype=None, impl: str = "auto") -> DAT:
    """A DAT in eval mode (serving only; ``train()`` raises)."""
    return DAT(config, dtype=dtype, impl=impl).eval()


register_model("dat", DATConfig, build_dat)

__all__ = ["DAT", "DATB", "ResidualGroup", "SpatialAttention", "ChannelAttention",
           "DynamicPosBias", "build_dat", "do_shift"]
