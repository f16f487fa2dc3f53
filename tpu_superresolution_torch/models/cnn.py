"""Pieces the two CNN families share (MS_ResUNet, UNet2D): the layout,
the convolutions in the compute dtype, BatchNorm on the channel axis
and the initialisation.

The models take and return NHWC like the rest of the port; inside they
run NCHW tensors in the channels-last memory format, so the NHWC input
is a view and cuDNN gets the layout its tensor-core kernels prefer.
Their convolutions are plain torch ops (cuDNN on the card), as the JAX
package leaves them to XLA; parameters stay fp32 and are cast to the
compute dtype, and to channels-last, at each call (one copy either way):
with a one-channel input, whose strides fit both formats, NCHW weights
made cuDNN keep the whole network NCHW and transpose around every
conv."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_superresolution_torch.models.blocks import BatchNorm


def to_nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """NHWC -> NCHW in the channels-last memory format."""
    return x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _weight(m: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    return m.weight.to(dtype=dtype, memory_format=torch.channels_last)


def conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`m` (a ``Conv2d``) on NCHW x in x's dtype."""
    bias = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv2d(x, _weight(m, x.dtype), bias, m.stride, m.padding)


def conv_transpose(m: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    bias = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv_transpose2d(x, _weight(m, x.dtype), bias, m.stride, m.padding)


def batch_norm(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """The port's flax-rules ``BatchNorm`` (fp32 arithmetic, the biased
    running-variance update in train mode) over NCHW x's channels."""
    return bn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def check_impl(impl: str) -> None:
    """The CNNs have no hand-written kernel: "auto" and "plain" compute
    the same ops (the argument is the registry's, for every family)."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")


def cnn_init(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """torch's default initialisation of convs and transposed convs
    (kaiming-uniform a=sqrt(5), bias uniform(+-1/sqrt(fan_in))) drawn
    from `generator`; BatchNorm weight 1, bias 0, running statistics 0 /
    1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
                if m.bias is not None:
                    fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
                    bound = 1.0 / math.sqrt(fan_in)
                    nn.init.uniform_(m.bias, -bound, bound, generator=generator)
            elif isinstance(m, BatchNorm):
                m.reset_parameters()
