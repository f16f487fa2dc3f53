"""UNet2D, the simple U-Net family (port of
``tpu_superresolution_tpu/models/unet2d.py``; the reference's lost
unet2d.py as notebooks/to_present/cnn.ipynb cells 31-34 document it):
ConvBNAct (conv3x3 -> BatchNorm -> ReLU -> dropout), DoubleConv, Down
(max-pool 2 + DoubleConv), Up (bilinear x2 + 1x1 reduce conv, or a 2x2
stride-2 transposed conv; concat with the skip; DoubleConv), a 1x1 out
conv, and the residual head (results.ipynb cell 13).  A restoration net
on pre-upscaled input, NHWC in and out.

No reference checkpoint exists for this family; the key names follow
the JAX module names with '_' as '.' (``inc.c1.conv``, ``down1.c2.bn``,
``up1.reduce`` or ``up1.ct``, ``up1.c1.conv``, ``outc``).  The
transposed conv is torch's ``ConvTranspose2d``: flax's ``ConvTranspose``
(no kernel transpose, 'SAME') puts the kernel's last tap on the even
output pixel, so the bridge flips the kernel spatially
(``interop.jax_bridge.unet2d_state_dict_from_jax``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_superresolution_torch.core.config import UNet2DConfig, register_model
from tpu_superresolution_torch.models.blocks import BatchNorm
from tpu_superresolution_torch.models.cnn import (
    batch_norm,
    check_impl,
    cnn_init,
    conv,
    conv_transpose,
    to_nchw,
    to_nhwc,
)
from tpu_superresolution_torch.ops.resize import resize_bilinear


class ConvBNAct(nn.Module):
    """conv3x3 (a bias only without a norm) -> BatchNorm -> ReLU ->
    dropout (train mode only)."""

    def __init__(self, cin: int, cout: int, norm: str = "batch", dropout: float = 0.0):
        super().__init__()
        if norm not in ("batch", "none"):
            raise ValueError(f"norm must be 'batch' or 'none', got {norm!r}")
        self.conv = nn.Conv2d(cin, cout, 3, padding=1, bias=norm == "none")
        self.bn = BatchNorm(cout) if norm == "batch" else None
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv(self.conv, x)
        if self.bn is not None:
            x = batch_norm(self.bn, x)
        x = F.relu(x)
        if self.dropout > 0.0:
            x = F.dropout(x, self.dropout, self.training)
        return x


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int, norm: str = "batch", dropout: float = 0.0):
        super().__init__()
        self.c1 = ConvBNAct(cin, cout, norm, dropout)
        self.c2 = ConvBNAct(cout, cout, norm, dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c2(self.c1(x))


class Up(DoubleConv):
    """x2 upsample of the deeper map to `cout` channels (bilinear without
    antialias + 1x1 ``reduce``, or the 2x2 stride-2 ``ct``), concat after
    the skip, DoubleConv."""

    def __init__(self, cin: int, cout: int, bilinear: bool, norm: str, dropout: float):
        super().__init__(2 * cout, cout, norm, dropout)
        if bilinear:
            self.reduce = nn.Conv2d(cin, cout, 1)
        else:
            self.ct = nn.ConvTranspose2d(cin, cout, 2, 2)
        self.bilinear = bilinear

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        if self.bilinear:
            h, w = x.shape[2], x.shape[3]
            x = resize_bilinear(x.permute(0, 2, 3, 1), 2 * h, 2 * w, antialias=False)
            x = conv(self.reduce, x.permute(0, 3, 1, 2))
        else:
            x = conv_transpose(self.ct, x)
        return super().forward(torch.cat([skip, x], dim=1))


class UNet2D(nn.Module):
    """x [B, H, W, in] -> [B, H, W, out]; H and W must be multiples of
    2**depth (the JAX model fails at the skip concat otherwise)."""

    def __init__(self, config: UNet2DConfig, dtype: Optional[torch.dtype] = None,
                 impl: str = "auto"):
        super().__init__()
        check_impl(impl)
        cfg = config
        self.config, self.impl = cfg, impl
        self.dtype = torch.float32 if dtype is None else dtype
        ch = [cfg.base_channels * 2 ** i for i in range(cfg.depth + 1)]
        self.inc = DoubleConv(cfg.in_channels, ch[0], cfg.norm, cfg.dropout)
        for i in range(cfg.depth):
            setattr(self, f"down{i + 1}", DoubleConv(ch[i], ch[i + 1], cfg.norm, cfg.dropout))
        for i in reversed(range(cfg.depth)):
            setattr(self, f"up{cfg.depth - i}",
                    Up(ch[i + 1], ch[i], cfg.bilinear, cfg.norm, cfg.dropout))
        self.outc = nn.Conv2d(ch[0], cfg.out_channels, 1)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        cnn_init(self, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` is unused (dropout draws from torch's generator)."""
        cfg = self.config
        m = 2 ** cfg.depth
        if x.shape[1] % m or x.shape[2] % m:
            raise ValueError(f"UNet2D at depth {cfg.depth} needs H and W divisible by {m}, got "
                             f"{x.shape[1]}x{x.shape[2]} (crop or pad the input)")
        inp = x
        x = self.inc(to_nchw(x, self.dtype))
        skips = []
        for i in range(cfg.depth):
            skips.append(x)
            x = getattr(self, f"down{i + 1}")(F.max_pool2d(x, 2, 2))
        for i in reversed(range(cfg.depth)):
            x = getattr(self, f"up{cfg.depth - i}")(x, skips[i])
        out = to_nhwc(conv(self.outc, x))
        if cfg.residual:
            out = out + inp[..., : cfg.out_channels].to(out.dtype)
        return out


def build_unet2d(config: UNet2DConfig, dtype=None, impl: str = "auto") -> UNet2D:
    """A UNet2D in eval mode (``train()`` for training)."""
    return UNet2D(config, dtype=dtype, impl=impl).eval()


register_model("unet2d", UNet2DConfig, build_unet2d)
