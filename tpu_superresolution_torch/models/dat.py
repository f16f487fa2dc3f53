"""DAT on NHWC tensors, serving and training (port of
``tpu_superresolution_tpu/models/dat.py``; reference
modules/dat_arch.py:699-859, Chen et al., "Dual Aggregation Transformer
for Image Super-Resolution", ICCV 2023).

- Parameters and buffers carry the reference state-dict key names, so a
  reference checkpoint (after ``interop.strip_reference_buffers``, which
  drops its ``rpe_biases``, ``relative_position_index`` and
  ``attn_mask_*``) and the output of the port's
  ``dat_state_dict_from_jax`` load with ``strict=True``.
- A block alternates (dat_arch.py:538-549): even blocks are spatial
  (two rectangular-window branches, s0 x s1 and s1 x s0, on half the
  channels each), odd blocks channel attention (XCiT).  Shifted spatial
  blocks follow the reference rule (dat_arch.py:290, 389; the JAX
  package's ``DATB``): group i even at j = 2, 6, ...; i odd at j = 0, 4.
- Each block takes its route from static shapes only (``dat_route``),
  the same on every call, as the JAX package gates its kernels
  (``models/dat.py:733-797``).  At inference its front is K9 (spatial)
  or K14 (channel) where the kernel's limits take the block, with the
  conv branch's BatchNorm folded into the depthwise weights, and its tail
  K10 where that kernel's limits do; the AIM channel gate (GAP -> 1x1 ->
  BatchNorm -> erf GELU -> 1x1 -> sigmoid, a [B, C] vector) is plain
  torch, as the JAX package leaves it to XLA.  Every other front or tail,
  and every block in training, is the module chain (JAX
  ``models/dat.py:160-797``): K2 for LN1, LN2 and sg_norm, the qkv and
  1x1 products in plain torch, the conv branch K11 -> BatchNorm -> erf
  GELU on the unpadded v, q, k and v zero-padded after the projection to
  a multiple of max(s0, s1), K16 for each rect-window branch (cyclic
  shift and -100 mask per branch), XCiT in the JAX package's "heads" form,
  the AIM with both interaction maps, proj, and SGFN with K11 on its gate
  half.  The chain and the kernels' plain versions are one composition
  each (``fused_rect_attn.rect_front``, ``fused_channel_attn.
  channel_front``, ``fused_datb_tail.datb_tail_plain``) with different
  steps passed in.
- BatchNorm (``blocks.BatchNorm``) follows flax's rules: batch mean and
  biased variance in train() mode, updated into the running statistics
  in place with momentum 0.9; the running statistics in eval() mode.  The
  kernels' folded weights are rebuilt after such an update
  (``DerivedCache`` keys on the buffers' version counters).
- Stochastic depth on both residuals of every block, at rates
  ``linspace(0, drop_path_rate, sum(depths))`` (JAX ``models/dat.py:860``).
- ``before_RG`` and ``norm`` go through K2, the 3x3 convs of the groups,
  ``conv_after_body`` and ``conv_before_upsample`` through K3, the
  composed reconstruction through K4; ``conv_first``, the mean shift and
  the exact-mode chain are plain torch.  ``impl="plain"`` runs every
  kernel's plain version on any device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_superresolution_torch.core.config import DATConfig, register_model
from tpu_superresolution_torch.kernels.fused_channel_attn import (
    ChanAttnWeights,
    chan_ok,
    channel_attention,
    channel_attention_plain,
    channel_front,
    pack_chan_weights,
)
from tpu_superresolution_torch.kernels.fused_datb_tail import (
    TailWeights,
    datb_tail,
    datb_tail_plain,
    fold_bn_into_dense,
    pack_tail_weights,
    tail_ok,
)
from tpu_superresolution_torch.kernels.dwconv import dwconv3x3, dwconv3x3_plain
from tpu_superresolution_torch.kernels.fused_rect_attn import (
    RectAttnWeights,
    pack_rect_weights,
    rect_attention,
    rect_attention_plain,
    rect_bias_from_table,
    rect_front,
    rect_ok,
)
from tpu_superresolution_torch.kernels.layernorm import layernorm, layernorm_plain
from tpu_superresolution_torch.kernels.window_attention import (
    batched_window_attention,
    batched_window_attention_plain,
)
from tpu_superresolution_torch.models.blocks import (
    BatchNorm,
    Conv3x3,
    ConvLeaky,
    DerivedCache,
    DWConv3x3,
    PixelShuffleDirect,
    PixelShuffleUpsample,
    PLayerNorm,
    RGB_MEAN,
    StochasticDepth,
    ThreeConv,
    conv_nhwc,
    reference_init,
    upsample_and_last,
)
from tpu_superresolution_torch.ops.window import (
    rect_window_partition,
    rect_window_reverse,
    rpe_biases,
)


def do_shift(rg_idx: int, b_idx: int) -> bool:
    """The reference's shift rule for block j of group i (dat_arch.py:290,
    389): i even and j in 2, 6, ...; i odd and j in 0, 4, ...  Only
    spatial (even) blocks qualify."""
    i, j = rg_idx, b_idx
    return (i % 2 == 0 and j > 0 and (j - 2) % 4 == 0) or (i % 2 != 0 and j % 4 == 0)


def dat_route(spatial: bool, c: int, num_heads: int, split: Sequence[int], hidden: int,
              train: bool) -> Tuple[str, str]:
    """(front, tail) of a DAT block of C channels, `num_heads` heads,
    `split` (s0, s1) and SGFN hidden width `hidden`: the front "K9" (a
    spatial block) or "K14" (a channel block) where that kernel's limits
    take the block, else "chain"; the tail "K10" where its limits take
    the block, else "chain"; in training ("chain", "chain"), as BatchNorm
    then runs on batch statistics that no kernel folds.  Shapes only: it
    runs on any device and gives the same answer on every call."""
    if train:
        return "chain", "chain"
    if spatial:
        front = "K9" if rect_ok(c, num_heads, split) else "chain"
    else:
        front = "K14" if chan_ok(c, num_heads) else "chain"
    return front, "K10" if tail_ok(c, hidden // 2, c // 16) else "chain"


def _dense(conv: nn.Conv2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """A 1x1 conv as ([out, in] weight, bias) in fp32."""
    return conv.weight.float().flatten(1), conv.bias.float()


def _layernorm_step(plain: bool) -> Callable:
    """LayerNorm(t, weight, bias) through K2 (or its plain version)."""
    if plain:
        return layernorm_plain
    return lambda t, g, b: layernorm(t.contiguous(), g, b)


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
    """One rect-window branch (the reference's Spatial_Attention, the JAX
    package's ``SpatialAttentionBranch``): holds its DynamicPosBias (key
    ``pos``).  Its attention is K9's (the kernel route) or K16's on the
    module chain (``rect_branch_attention``)."""

    def __init__(self, dim: int, num_heads: int, hsp: int, wsp: int):
        super().__init__()
        self.hsp, self.wsp = hsp, wsp
        self.pos = DynamicPosBias(dim // 4, num_heads)
        self._derived = DerivedCache()
        self._derived_table = DerivedCache()

    def table(self) -> torch.Tensor:
        """The DynamicPosBias output [(2hsp-1)(2wsp-1), heads] fp32, the
        table K9 keeps resident (``bias`` is its gather): built once per
        loaded weights."""
        def build():
            dev = self.pos.pos_proj.weight.device
            return self.pos(torch.from_numpy(rpe_biases(self.hsp, self.wsp)).to(dev)).float()

        return self._derived_table.get(list(self.pos.parameters()), None, build)

    def bias(self) -> torch.Tensor:
        """[heads, N, N] fp32 bias of the hsp x wsp window, ``table``
        gathered by ``relative_position_index``: built once per loaded
        weights outside autograd, in the graph when a gradient is
        wanted."""
        return self._derived.get(list(self.pos.parameters()), None,
                                 lambda: rect_bias_from_table(self.table(), self.hsp, self.wsp))


def rect_branch_attention(q, k, v, bias, mask, hsp, wsp, heads, attend: Callable):
    """One rect-window branch of the module chain on [B, Hp, Wp, C/2] maps
    (q pre-scaled): partition into [B*nW, heads, N, hd], ``attend(q, k,
    v, bias, mask)`` (K16 or its plain version; window w takes mask[w %
    nW]), reverse (the JAX package's ``SpatialAttentionBranch`` with
    ``attn_impl="pallas"``)."""
    b, hp, wp, cb = q.shape
    n, hd = hsp * wsp, cb // heads
    win = lambda t: rect_window_partition(t, hsp, wsp).reshape(-1, n, heads, hd).transpose(1, 2)
    o = attend(win(q), win(k), win(v), bias, mask)
    return rect_window_reverse(o.transpose(1, 2).reshape(-1, n, cb), hsp, wsp, hp, wp)


def xcit_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               temperature: torch.Tensor) -> torch.Tensor:
    """XCiT channel attention in the JAX package's "heads" form
    (``AdaptiveChannelAttention``, ``CHAN_ATTN_IMPL="heads"``) on q, k, v
    [B, T, nh, hd]: q and k L2-normalised over the tokens in fp32 (eps
    1e-12), the per-head [hd, hd] scores times the temperature, softmax
    in fp32, out = A v; [B, T, nh, hd] in v's dtype."""
    dt = v.dtype
    qn = F.normalize(q.float(), dim=1, eps=1e-12).to(dt)
    kn = F.normalize(k.float(), dim=1, eps=1e-12).to(dt)
    scores = torch.einsum("bthd,bthe->bhde", qn, kn) * temperature.to(dt).reshape(1, -1, 1, 1)
    a = torch.softmax(scores.float(), dim=-1).to(dt)
    return torch.einsum("bhde,bthe->bthd", a, v)


class _AIM(nn.Module):
    """The conv branch and the two interaction maps that both attention
    types share (dat_arch.py:299-316): keys ``dwconv.{0,1}``,
    ``channel_interaction.{1,2,4}``, ``spatial_interaction.{0,1,3}``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Sequential(DWConv3x3(dim), BatchNorm(dim), nn.GELU())
        self.channel_interaction = nn.Sequential(
            nn.AdaptiveAvgPool2d(1), nn.Conv2d(dim, dim // 8, 1), BatchNorm(dim // 8),
            nn.GELU(), nn.Conv2d(dim // 8, dim, 1))
        self.spatial_interaction = nn.Sequential(
            nn.Conv2d(dim, dim // 16, 1), BatchNorm(dim // 16), nn.GELU(),
            nn.Conv2d(dim // 16, 1, 1))

    def conv_branch(self, v: torch.Tensor, plain: bool) -> torch.Tensor:
        """The module chain's conv branch: erf-GELU(BatchNorm(K11(v)))."""
        return F.gelu(self.dwconv[1](self.dwconv[0](v, plain)))

    def folded_dwconv(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The conv branch's depthwise kernel [3, 3, C] and bias with the
        inference BatchNorm folded in (conv, then BN), for K9 and K14."""
        conv, bn = self.dwconv[0], self.dwconv[1]
        return fold_bn_into_dense(conv.taps().float(), conv.bias.float(), bn.weight.float(),
                                  bn.bias.float(), bn.running_mean.float(),
                                  bn.running_var.float(), bn.eps)

    def channel_gate(self, t: torch.Tensor) -> torch.Tensor:
        """sigmoid(channel_interaction(t)) as a [B, C] fp32 vector (its
        BatchNorm's statistics over the batch in training)."""
        ci = self.channel_interaction
        w1, b1 = _dense(ci[1])
        w2, b2 = _dense(ci[4])
        y = F.gelu(ci[2](F.linear(t.float().mean(dim=(1, 2)), w1, b1)))
        return torch.sigmoid(F.linear(y, w2, b2))

    def spatial_map(self, u: torch.Tensor) -> torch.Tensor:
        """spatial_interaction(u): the per-pixel map [B, H, W, 1] before
        its sigmoid, in u's dtype (the module chain's)."""
        si, dt = self.spatial_interaction, u.dtype
        y = F.linear(u, si[0].weight.flatten(1).to(dt), si[0].bias.to(dt))
        y = F.gelu(si[1](y))
        return F.linear(y, si[3].weight.flatten(1).to(dt), si[3].bias.to(dt))

    def spatial_weights(self):
        """The spatial map's 1x1 convs, BatchNorm folded into the first
        (inference, for K10)."""
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

    def _weights(self, norm1: PLayerNorm, wdw=None, bdw=None) -> RectAttnWeights:
        return RectAttnWeights(
            g1=norm1.weight, b1=norm1.bias, wqkv=self.qkv.weight, bqkv=self.qkv.bias,
            wdw=wdw, bdw=bdw, bias0=self.attns[0].bias(), bias1=self.attns[1].bias(),
            num_heads=self.num_heads, split=self.split)

    def front_weights(self, norm1: PLayerNorm) -> RectAttnWeights:
        return dataclasses.replace(self._weights(norm1, *self.folded_dwconv()),
                                   table0=self.attns[0].table(), table1=self.attns[1].table())

    def chain_front(self, x: torch.Tensor, norm1: PLayerNorm, shifted: bool,
                    plain: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """(attened_x, conv_x) on the module chain: K2, qkv, the conv
        branch (K11, BatchNorm, GELU) and K16 per branch."""
        attend = batched_window_attention_plain if plain else batched_window_attention
        return rect_front(x, self._weights(norm1), shifted, ln1=_layernorm_step(plain),
                          conv_branch=lambda v: self.conv_branch(v, plain),
                          attention=functools.partial(rect_branch_attention, attend=attend))


class ChannelAttention(_AIM):
    """Adaptive channel attention (dat_arch.py:441-528): keys
    ``temperature``, ``qkv``, ``proj`` and the AIM modules."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool):
        super().__init__(dim)
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def _weights(self, norm1: PLayerNorm, wdw=None, bdw=None) -> ChanAttnWeights:
        return ChanAttnWeights(
            g1=norm1.weight, b1=norm1.bias, wqkv=self.qkv.weight, bqkv=self.qkv.bias,
            temperature=self.temperature, wdw=wdw, bdw=bdw, num_heads=self.num_heads)

    def front_weights(self, norm1: PLayerNorm) -> ChanAttnWeights:
        return self._weights(norm1, *self.folded_dwconv())

    def chain_front(self, x: torch.Tensor, norm1: PLayerNorm, shifted: bool,
                    plain: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """(attened_x, conv_x) on the module chain: K2, qkv, XCiT in the
        "heads" form and the conv branch (K11, BatchNorm, GELU)."""
        return channel_front(x, self._weights(norm1), ln1=_layernorm_step(plain),
                             conv_branch=lambda v: self.conv_branch(v, plain),
                             attention=xcit_heads)


class SpatialGate(nn.Module):
    """SGFN's gate branch: keys ``norm`` and ``conv`` (depthwise 3x3, K11)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = PLayerNorm(dim)
        self.conv = DWConv3x3(dim)


class SGFN(nn.Module):
    """Spatial-gate FFN (dat_arch.py:38-90): keys ``fc1``, ``sg``, ``fc2``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.sg = SpatialGate(hidden // 2)
        self.fc2 = nn.Linear(hidden // 2, dim)


class DATB(nn.Module):
    """Dual aggregation block (dat_arch.py:531-565): its front (K9, K14 or
    the module chain), the channel gate, its tail (K10 or the module
    chain), as ``dat_route`` decides."""

    def __init__(self, dim: int, num_heads: int, split: Tuple[int, int], expansion: float,
                 qkv_bias: bool, rg_idx: int, b_idx: int):
        super().__init__()
        self.spatial = b_idx % 2 == 0
        self.shifted = self.spatial and do_shift(rg_idx, b_idx)
        self.dim, self.num_heads, self.split = dim, num_heads, tuple(split)
        self.hidden = int(dim * expansion)
        self.norm1 = PLayerNorm(dim)
        self.attn = (SpatialAttention(dim, num_heads, split, qkv_bias) if self.spatial
                     else ChannelAttention(dim, num_heads, qkv_bias))
        self.norm2 = PLayerNorm(dim)
        self.ffn = SGFN(dim, self.hidden)
        self._derived_front = DerivedCache()
        self._derived_tail = DerivedCache()

    def route(self) -> Tuple[str, str]:
        """(front, tail) of this block in its present mode (``dat_route``)."""
        return dat_route(self.spatial, self.dim, self.num_heads, self.split, self.hidden,
                         self.training)

    def tail_weights(self, folded: bool = True) -> TailWeights:
        """The tail's weights: with `folded`, the spatial map's with the
        inference BatchNorm folded in (K10); without, none (the module
        chain runs the spatial interaction itself)."""
        sp = self.attn.spatial_weights() if folded else (None,) * 4
        f = self.ffn
        return TailWeights(
            *sp, wproj=self.attn.proj.weight, bproj=self.attn.proj.bias,
            g2=self.norm2.weight, b2=self.norm2.bias, wfc1=f.fc1.weight, bfc1=f.fc1.bias,
            gsg=f.sg.norm.weight, bsg=f.sg.norm.bias, wdw=f.sg.conv.taps(),
            bdw=f.sg.conv.bias, wfc2=f.fc2.weight, bfc2=f.fc2.bias)

    def _kernel_weights(self, cache: DerivedCache, weights: Callable, pack: Callable,
                        packed: bool):
        """(weights, packed layout or None) derived from the parameters
        and BatchNorm statistics, once per loaded weights at inference."""
        def build():
            w = weights()
            return w, (pack(w) if packed else None)

        return cache.get(list(self.parameters()) + list(self.buffers()), packed, build)

    def _chain_tail(self, x, u, w_px, gate, plain: bool, branch_scales):
        """The module chain's tail: the spatial interaction, AIM gating,
        proj, residual, K2 LN2, fc1, GELU, K2 sg_norm, K11 sg_conv, fc2,
        residual; products in x's dtype, drop path on both residuals."""
        dt = x.dtype
        ln = _layernorm_step(plain)
        dw = dwconv3x3_plain if plain else dwconv3x3
        return datb_tail_plain(
            x, u, w_px, gate, self.tail_weights(folded=False), spatial_map=self.attn.spatial_map,
            ln=lambda t, g, b: ln(t.to(dt), g, b), dwconv=lambda t, k, b: dw(t.to(dt), k, b),
            linear=lambda a, wt, b: F.linear(a.to(dt), wt.to(dt), b.to(dt)),
            branch_scales=branch_scales)

    def forward(self, x: torch.Tensor, plain: bool = False,
                branch_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The block on x [B, H, W, C]; `branch_scales` [B, 2] are the
        stochastic-depth multipliers of the two residuals (training)."""
        front, tail = self.route()
        packed = not plain and x.is_cuda
        if front == "chain":
            att, conv = self.attn.chain_front(x, self.norm1, self.shifted, plain)
        else:
            pack = pack_rect_weights if self.spatial else pack_chan_weights
            fw, pf = self._kernel_weights(self._derived_front,
                                          lambda: self.attn.front_weights(self.norm1), pack,
                                          packed)
            if self.spatial:
                att, conv = (rect_attention_plain(x, fw, self.shifted) if plain
                             else rect_attention(x, fw, self.shifted, pf))
            else:
                att, conv = (channel_attention_plain(x, fw) if plain
                             else channel_attention(x, fw, pf))
        u, w_px = (att, conv) if self.spatial else (conv, att)
        gate = self.attn.channel_gate(w_px)
        if tail == "chain":
            return self._chain_tail(x, u, w_px, gate, plain, branch_scales)
        tw, pt = self._kernel_weights(self._derived_tail, self.tail_weights, pack_tail_weights,
                                      packed)
        if plain:
            return datb_tail_plain(x, u, w_px, gate, tw)
        return datb_tail(x, u, w_px, gate, tw, pt)


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

    def forward(self, x: torch.Tensor, plain: bool = False,
                branch_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
        res = x
        for j, blk in enumerate(self.blocks):
            x = blk(x, plain, None if branch_scales is None else branch_scales[j])
        return self.conv(x, plain) + res


class DAT(StochasticDepth, nn.Module):
    """Full DAT: x [B, H, W, in] -> [B, H*s, W*s, out]."""

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

    def routes(self) -> List[List[Tuple[str, str]]]:
        """Every block's (front, tail) in the present mode, per group."""
        return [[blk.route() for blk in layer.blocks] for layer in self.layers]

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` draws the stochastic-depth masks in train() mode."""
        cfg = self.config
        dt = self.dtype
        plain = self.impl == "plain"
        scales = self.sample_branch_scales(x.shape[0], generator, x.device)
        mean = self.mean.to(dt)
        x = (x.to(dt) - mean) * cfg.img_range
        x = conv_nhwc(self.conv_first, x)
        feats = self.before_RG[1](x, plain)
        for i, layer in enumerate(self.layers):
            feats = layer(feats, plain, None if scales is None else scales[i])
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
    """A DAT in eval mode (``train()`` for training)."""
    return DAT(config, dtype=dtype, impl=impl).eval()


register_model("dat", DATConfig, build_dat)

__all__ = ["DAT", "DATB", "ResidualGroup", "SpatialAttention", "ChannelAttention",
           "DynamicPosBias", "build_dat", "dat_route", "do_shift"]
