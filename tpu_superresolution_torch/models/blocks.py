"""Shared NHWC building blocks (port of
``tpu_superresolution_tpu/models/blocks.py``).

Parameters use the reference torch modules and key names
(``nn.Conv2d`` / ``nn.Linear`` / LayerNorm ``weight`` and ``bias``), so
reference state dicts load with ``strict=True``.  Activations are NHWC.
Modules that the JAX package runs through a Pallas kernel take a `plain`
flag: False calls the kernel wrapper (kernel on CUDA, plain version on
CPU), True calls the plain version on any device.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_superresolution_torch.kernels.cab_conv import conv3x3, conv_plain, pack_conv_weight
from tpu_superresolution_torch.kernels.dwconv import dwconv3x3, dwconv3x3_plain
from tpu_superresolution_torch.kernels.layernorm import layernorm, layernorm_plain
from tpu_superresolution_torch.ops.fused_upsample import (
    chain_pixelshuffle_reconstruct,
    compose_upsample,
    compose_upsample_torch,
    fused_pixelshuffle_reconstruct,
)
from tpu_superresolution_torch.ops.pixelshuffle import pixel_shuffle


# The DIV2K RGB mean that the reference SwinIR and HAT subtract before
# and add after their forwards (3-channel models only).
RGB_MEAN = (0.4488, 0.4371, 0.4040)


class DerivedCache:
    """One tensor bundle derived from a module's parameters (a kernel
    weight layout, a composed conv).  Outside autograd it is built once
    and rebuilt only when the parameters change: the key holds each
    parameter's storage pointer and version counter (``load_state_dict``,
    ``.to()`` and an optimizer step change one of them).  When a gradient
    is wanted it is rebuilt on every call, inside the graph, by
    `build_grad` (default `build`), and never cached.  On the meta device
    (``utils.flops.torch_flops``) `build_grad` builds it, cached as
    outside autograd.  While ``torch.export`` traces (its parameters are
    fake tensors, with no data or storage), the bundle an eager call built
    for the same `tag` is returned as it is and becomes a constant of the
    exported program; without one, `build_grad` traces the derivation
    into the program."""

    def __init__(self):
        self._key = None
        self._value = None

    def get(self, params: Sequence[torch.Tensor], tag, build: Callable,
            build_grad: Optional[Callable] = None):
        if torch.compiler.is_exporting():
            if self._key is not None and self._key[0] == tag:
                return self._value
            return (build_grad or build)()
        if torch.is_grad_enabled() and any(p.requires_grad for p in params):
            return (build_grad or build)()
        key = (tag,) + tuple((p.data_ptr(), p._version) for p in params)
        if key != self._key:
            meta = any(p.is_meta for p in params)
            self._value = (build_grad or build)() if meta else build()
            self._key = key
        return self._value


class _Recompute(threading.local):
    depth = 0


_RECOMPUTE = _Recompute()


def recomputing() -> bool:
    """Whether this thread runs a block again inside the backward pass
    (``remat_block``'s recomputation)."""
    return _RECOMPUTE.depth > 0


@contextlib.contextmanager
def recompute_scope():
    """The scope in which ``recomputing()`` holds."""
    _RECOMPUTE.depth += 1
    try:
        yield
    finally:
        _RECOMPUTE.depth -= 1


def remat_block(block: nn.Module, *args) -> torch.Tensor:
    """``block(*args)`` with its activations recomputed in the backward
    pass instead of kept (the JAX models' ``nn.remat`` of a block class,
    ``use_remat``): ``torch.utils.checkpoint`` non-reentrant.  The
    recomputation runs in ``recomputing()``'s scope, where ``BatchNorm``
    leaves its running statistics alone, as flax's remat discards the
    recomputation's state updates (one momentum step a training step,
    and no second bump of the buffers' version counters, which the
    kernels' folded weights key on).

    The models do not wrap a block that trains through a block kernel's
    autograd function (``SwinBlock.trains_on_block_kernel``): that
    function keeps only the block's inputs and its backward kernel
    recomputes the rest, so the block already is its own recomputation.

    Nothing random is drawn inside a block: the stochastic-depth scales
    come in as a tensor drawn before, so the default generators' state
    need not be kept (``preserve_rng_state=False``)."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), recompute_scope()))


def drop_path_scales(rates: Sequence[float], batch: int,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth as per-block, per-sample branch multipliers
    [len(rates), batch, 2] (attention, MLP): Bernoulli(1 - rate) / (1 -
    rate), and exactly 1 where the rate is 0 (the JAX package samples
    them per block, ``models/swinir.py:259-267``, and hands them to the
    fused block as ``branch_scales``).  Drawn on the host from
    `generator`, so one seed gives one draw on any device."""
    rates_t = torch.tensor(rates, dtype=torch.float32).reshape(-1, 1, 1)
    keep = 1.0 - rates_t
    u = torch.rand(len(rates), batch, 2, generator=generator)
    return torch.where(rates_t > 0, (u < keep).float() / keep, torch.ones(()))


class StochasticDepth:
    """Per-block stochastic depth of the Swin-family models (SwinIR and
    HAT): the rates decay linearly from 0 to ``config.drop_path_rate``
    over all blocks (network_swinir.py:701, hat_arch.py:827; the JAX
    package's ``np.linspace(0, rate, sum(depths))``), and in train() mode
    each forward draws per-sample branch scales for every block."""

    def drop_path_rates(self) -> List[float]:
        depth = sum(self.config.depths)
        rate = self.config.drop_path_rate
        return [rate * i / (depth - 1) if depth > 1 else 0.0 for i in range(depth)]

    def sample_branch_scales(self, batch: int, generator: Optional[torch.Generator],
                             device) -> Optional[List[torch.Tensor]]:
        """Per-layer [depth, B, 2] stochastic-depth multipliers (attention,
        MLP) for one training forward, or None (eval mode, or no drop
        path): drawn on the host from `generator`, moved to the device in
        one copy.  Blocks of rate 0 get exactly 1."""
        rates = self.drop_path_rates()
        if not self.training or not any(r > 0 for r in rates):
            return None
        scales = drop_path_scales(rates, batch, generator)
        if torch.device(device).type == "cuda":  # no host wait for the copy
            scales = scales.pin_memory()
        scales = scales.to(device, non_blocking=True)
        out, start = [], 0
        for d in self.config.depths:
            out.append(scales[start : start + d])
            start += d
        return out


def hwio(weight: torch.Tensor) -> torch.Tensor:
    """torch conv weight [O, I, kh, kw] -> the kernels' [kh, kw, I, O]."""
    return weight.permute(2, 3, 1, 0)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A plain ``nn.Conv2d`` on an NHWC tensor, computed in x's dtype (the
    convs the JAX package leaves to XLA: conv_first, 1x1 convs, the
    exact-mode reconstruction chain)."""
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), bias,
                 padding=conv.padding)
    return y.permute(0, 2, 3, 1).contiguous()


class Conv3x3(nn.Conv2d):
    """``nn.Conv2d(cin, cout, 3, padding=1)`` on NHWC through kernel K3
    (the JAX package's ``Conv3x3`` with impl "halo")."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=1)
        self._derived = DerivedCache()

    def kernel_weights(self, dtype: torch.dtype, device: torch.device):
        """(kernel [3, 3, Cin, Cout] in `dtype`, fp32 bias, K3's packed
        weight or None): the packing is cached with the rest outside
        autograd on a CUDA device, and left to K3's wrapper (every call)
        when a gradient is wanted."""
        def build(pack: bool):
            k = hwio(self.weight).to(dtype).contiguous()
            packed = pack_conv_weight(k) if pack and torch.device(device).type == "cuda" else None
            return k, self.bias.float().contiguous(), packed

        return self._derived.get((self.weight, self.bias), (dtype, device),
                                 lambda: build(True), lambda: build(False))

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        k, b, packed = self.kernel_weights(x.dtype, x.device)
        if plain:
            return conv_plain(x, k, b, ((1, 1), (1, 1)))
        return conv3x3(x, k, b, packed)


class DWConv3x3(nn.Conv2d):
    """``nn.Conv2d(C, C, 3, padding=1, groups=C)`` on NHWC through kernel
    K11 (the JAX package's ``DWConv3x3`` with impl "halo"; reference keys
    ``weight`` [C, 1, 3, 3] and ``bias``), in x's dtype with fp32
    accumulation."""

    def __init__(self, dim: int):
        super().__init__(dim, dim, 3, padding=1, groups=dim)

    def taps(self) -> torch.Tensor:
        """The kernel as [3, 3, C] (the JAX layout without its unit axis)."""
        return self.weight[:, 0].permute(1, 2, 0)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        if plain:
            return dwconv3x3_plain(x, self.taps(), self.bias)
        return dwconv3x3(x, self.taps(), self.bias)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over the last axis of an NHWC (or [B, C]) tensor, to
    flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` rules, which the
    JAX package trains with (reference keys ``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``):

    - in train() mode the batch mean and the biased ("fast") variance
      E[x^2] - E[x]^2, clipped at 0, in fp32 over every axis but the
      last; any batch, one sample included (the variance is then 0);
    - the running statistics are updated in place with that biased
      variance: running = 0.9 running + 0.1 batch (``momentum`` 0.1 in
      torch's sense; torch's own update uses the unbiased variance and
      refuses one value per channel);
    - in eval() mode the running statistics;
    - y = (x - mean) * rsqrt(var + eps) * weight + bias in fp32, returned
      in x's dtype.  ``num_batches_tracked`` is kept for the reference
      layout and not read."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            axes = tuple(range(xf.dim() - 1))
            mean = xf.mean(axes)
            var = (xf.square().mean(axes) - mean.square()).clamp_min(0.0)
            if not recomputing():  # one update a step under remat_block
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
                    self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        scale = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * scale + self.bias.float()).to(x.dtype)


class ConvLeaky(nn.Sequential):
    """Sequential(Conv3x3, LeakyReLU) — the reference's
    ``conv_before_upsample`` (keys ``.0.weight`` / ``.0.bias``)."""

    def __init__(self, in_channels: int, out_channels: int, slope: float):
        super().__init__(Conv3x3(in_channels, out_channels), nn.LeakyReLU(slope))
        self.slope = slope

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return F.leaky_relu(self[0](x, plain), self.slope)


class ThreeConv(nn.Sequential):
    """The "3conv" residual connection: conv3x3 C->C/4, LeakyReLU 0.2,
    conv1x1, LeakyReLU 0.2, conv3x3 C/4->C (network_swinir.py:466-471;
    keys .0 / .2 / .4).  The 1x1 conv is plain, as in the JAX package."""

    def __init__(self, dim: int):
        super().__init__(
            Conv3x3(dim, dim // 4), nn.LeakyReLU(0.2),
            nn.Conv2d(dim // 4, dim // 4, 1), nn.LeakyReLU(0.2),
            Conv3x3(dim // 4, dim),
        )

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        x = F.leaky_relu(self[0](x, plain), 0.2)
        x = F.leaky_relu(conv_nhwc(self[2], x), 0.2)
        return self[4](x, plain)


class PLayerNorm(nn.Module):
    """LayerNorm over the channel axis with the fast-variance formula,
    eps 1e-5, through kernel K2 (reference ``nn.LayerNorm`` key names)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        if plain:
            return layernorm_plain(x, self.weight, self.bias)
        return layernorm(x.contiguous(), self.weight, self.bias)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 (network_swinir.py:14-30).  The Swin block
    kernels and their plain version consume the parameters directly;
    ``forward`` is the plain MLP of HAT's OCAB, in x's dtype with the
    GELU in fp32."""

    def __init__(self, in_features: int, hidden_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features)
        self.fc2 = nn.Linear(hidden_features, in_features)

    def forward(self, x: torch.Tensor, gelu_approximate: bool) -> torch.Tensor:
        dt = x.dtype
        h = F.linear(x, self.fc1.weight.to(dt), self.fc1.bias.to(dt))
        h = F.gelu(h.float(), approximate="tanh" if gelu_approximate else "none").to(dt)
        return F.linear(h, self.fc2.weight.to(dt), self.fc2.bias.to(dt))


def reference_init(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """The reference initialisation of the Swin-family models
    (network_swinir.py / hat_arch.py ``_init_weights``): Linear weights
    and relative-position bias tables trunc-normal(0.02), Linear biases
    0, LayerNorm 1/0, convs torch's default; drawn from `generator`."""
    g = generator
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, generator=g)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Conv2d):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=g)
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                nn.init.uniform_(m.bias, -bound, bound, generator=g)
            elif isinstance(m, PLayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(getattr(m, "relative_position_bias_table", None), nn.Parameter):
                nn.init.trunc_normal_(m.relative_position_bias_table, std=0.02, generator=g)


def _ps_factors(scale: int) -> List[int]:
    if scale & (scale - 1) == 0:
        return [2] * int(math.log2(scale))
    if scale == 3:
        return [3]
    raise ValueError(f"scale {scale} not supported (2^n or 3)")


class PixelShuffleUpsample(nn.Sequential):
    """log2-chained (conv nf -> 4nf, PixelShuffle(2)) upsampler, or the
    x3 variant (reference ``Upsample``, network_swinir.py:572-591; conv
    keys .0, .2, ...).  Plain convs, as the JAX package's ``nn.Conv``."""

    def __init__(self, scale: int, num_feat: int):
        mods: List[nn.Module] = []
        for r in _ps_factors(scale):
            mods += [nn.Conv2d(num_feat, r * r * num_feat, 3, 1, 1), nn.PixelShuffle(r)]
        super().__init__(*mods)

    def stages(self) -> List[Tuple[torch.Tensor, torch.Tensor, int]]:
        """[(kernel [3,3,cin,cout], bias, ps_factor)] of the chain."""
        return [
            (hwio(self[i].weight), self[i].bias, self[i + 1].upscale_factor)
            for i in range(0, len(self), 2)
        ]


class PixelShuffleDirect(nn.Sequential):
    """One conv to s^2 * out channels, one PixelShuffle (reference
    ``UpsampleOneStep``, network_swinir.py:594-615; key .0)."""

    def __init__(self, scale: int, in_features: int, out_features: int):
        super().__init__(nn.Conv2d(in_features, scale * scale * out_features, 3, 1, 1),
                         nn.PixelShuffle(scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(conv_nhwc(self[0], x), self[1].upscale_factor)


def upsample_and_last(x: torch.Tensor, upsample: PixelShuffleUpsample,
                      conv_last: nn.Conv2d, fused: bool, cache: DerivedCache,
                      plain: bool = False) -> torch.Tensor:
    """The 'pixelshuffle' reconstruction tail: the reference chain
    (plain convs), or with `fused` one composed conv (kernel K4) + one
    pixel_shuffle.  The composition is built in numpy once per loaded
    weights at inference, and with torch ops on every call in training
    (so gradients reach ``upsample.*`` and ``conv_last``)."""
    last = (hwio(conv_last.weight), conv_last.bias)
    if not fused or len(upsample) == 0:
        return chain_pixelshuffle_reconstruct(x, upsample.stages(), last, x.dtype)
    params = list(upsample.parameters()) + [conv_last.weight, conv_last.bias]
    comp = cache.get(
        params, (x.dtype, x.device),
        lambda: compose_upsample(upsample.stages(), last, x.dtype, x.device),
        lambda: compose_upsample_torch(upsample.stages(), last, x.dtype),
    )
    return fused_pixelshuffle_reconstruct(x, comp, plain)


def check_image_size(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Reflect-pad H, W of NHWC x up to the next multiple (reference
    network_swinir.py:783-788; reflect excludes the edge pixel)."""
    h, w = x.shape[1], x.shape[2]
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    if not (ph or pw):
        return x
    xn = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="reflect")
    return xn.permute(0, 2, 3, 1).contiguous()
