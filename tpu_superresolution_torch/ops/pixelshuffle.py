"""Depth-to-space on NHWC with torch's channel order (port of
``tpu_superresolution_tpu/ops/pixelshuffle.py``): channel
``c*r*r + i*r + j`` goes to spatial offset (i, j) of output channel c,
as ``torch.nn.PixelShuffle`` does on NCHW."""

from __future__ import annotations

import torch


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[B, H, W, C*r*r] -> [B, H*r, W*r, C]."""
    b, h, w, crr = x.shape
    if crr % (r * r) != 0:
        raise ValueError(f"channels {crr} not divisible by r^2={r * r}")
    c = crr // (r * r)
    x = x.reshape(b, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c)
