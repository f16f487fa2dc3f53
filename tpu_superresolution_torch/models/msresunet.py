"""MS_ResUNet, the RefineNet-style restoration CNN (port of
``tpu_superresolution_tpu/models/msresunet.py``; reference
modules/ms_resunet.py):

- stem: 5x5 stride-1 conv with **pad 1** (shrinks H, W by 2), BatchNorm,
  ReLU; the head's last 3x3 conv has **pad 2** and grows them back, so
  [B, H, W, 1] -> [B, H, W, 1] (the SR factor is the data pipeline's
  bicubic pre-upscale);
- encoder: 4 Bottleneck stages (expansion 4, BatchNorm) at strides 1, 2,
  2, 2 with 128 / 256 / 512 / 1024 output channels;
- decoder: 4 refine stages (dimred -> RCU adapt [-> joint dimred] (+
  the deeper path) -> ReLU -> chained residual pooling -> RCU -> [out
  dimred]); upsampling by ConvTranspose k4 s2 p1, then a centre crop to
  the skip's size (``dh // 2`` off the top, the rest off the bottom).

Module names and parameter layouts are the reference's (its
setattr-generated ``{i}_conv`` / ``{i}_conv_relu_varout_dimred`` /
``{i}_outvar_dimred`` included), so a reference ``.pth`` loads with
``strict=True``.  24,918,369 parameters at the default config.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_superresolution_torch.core.config import MSResUNetConfig, register_model
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


def _conv3x3(cin: int, cout: int, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=bias)


class RCPB(nn.Module):
    """Chained residual pooling (ms_resunet.py:12-30): n_stages of
    (max-pool 5x5 s1 p2 -> conv3x3), each stage added to the running sum.
    Keys ``{i}_outvar_dimred``."""

    def __init__(self, features: int, n_stages: int = 4):
        super().__init__()
        self.n_stages = n_stages
        for i in range(1, n_stages + 1):
            self.add_module(f"{i}_outvar_dimred", _conv3x3(features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        top = x
        for i in range(1, self.n_stages + 1):
            top = F.max_pool2d(top, 5, 1, 2)  # pads with -inf, as flax's max_pool
            top = conv(getattr(self, f"{i}_outvar_dimred"), top)
            x = top + x
        return x


class RCUBlock(nn.Module):
    """Residual conv unit (ms_resunet.py:35-55): n_blocks x 2 stages of
    ReLU -> conv3x3 with a residual add per block; a bias on the first
    stage only.  Keys ``{i}_conv`` / ``{i}_conv_relu_varout_dimred``."""

    def __init__(self, features: int, n_blocks: int = 2):
        super().__init__()
        self.n_blocks = n_blocks
        for i in range(1, n_blocks + 1):
            self.add_module(f"{i}_conv", _conv3x3(features, features, bias=True))
            self.add_module(f"{i}_conv_relu_varout_dimred", _conv3x3(features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, self.n_blocks + 1):
            residual = x
            x = conv(getattr(self, f"{i}_conv"), F.relu(x))
            x = conv(getattr(self, f"{i}_conv_relu_varout_dimred"), F.relu(x))
            x = x + residual
        return x


class Bottleneck(nn.Module):
    """ResNet bottleneck, expansion 4, BatchNorm (ms_resunet.py:57-93)."""

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
                                         BatchNorm(planes * 4)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(batch_norm(self.bn1, conv(self.conv1, x)))
        out = F.relu(batch_norm(self.bn2, conv(self.conv2, out)))
        out = batch_norm(self.bn3, conv(self.conv3, out))
        residual = x
        if self.downsample is not None:
            residual = batch_norm(self.downsample[1], conv(self.downsample[0], x))
        return F.relu(out + residual)


def crop_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Centre-crop NCHW x to ref's spatial size (ms_resunet.py:151-168):
    ``dh // 2`` rows off the top, the rest off the bottom (likewise for
    the columns)."""
    h, w = x.shape[2], x.shape[3]
    dh, dw = h - ref.shape[2], w - ref.shape[3]
    if dh == 0 and dw == 0:
        return x
    return x[:, :, dh // 2 : h - (dh - dh // 2), dw // 2 : w - (dw - dw // 2)]


class MSResUNet(nn.Module):
    """Full RefineNet (ms_resunet.py:96-264): x [B, H, W, in] -> [B, H, W,
    out], NHWC."""

    def __init__(self, config: MSResUNetConfig, dtype: Optional[torch.dtype] = None,
                 impl: str = "auto"):
        super().__init__()
        check_impl(impl)
        cfg = config
        if len(cfg.layers) != 4 or len(cfg.stage_planes) != 4:
            raise ValueError(f"MS_ResUNet has 4 encoder stages, got layers {cfg.layers} and "
                             f"stage_planes {cfg.stage_planes}")
        self.config, self.impl = cfg, impl
        self.dtype = torch.float32 if dtype is None else dtype
        self.conv1 = nn.Conv2d(cfg.in_channels, cfg.stem_channels, 5, padding=1, bias=False)
        self.bn1 = BatchNorm(cfg.stem_channels)
        cin = cfg.stem_channels
        for si, (planes, blocks, stride) in enumerate(zip(cfg.stage_planes, cfg.layers,
                                                          (1, 2, 2, 2))):
            layer = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                layer.append(Bottleneck(cin, planes, s, bi == 0 and (s != 1 or cin != planes * 4)))
                cin = planes * 4
            self.add_module(f"layer{si + 1}", nn.Sequential(*layer))

        rc = cfg.refine_channels
        skips = [p * 4 for p in cfg.stage_planes][::-1]  # l4, l3, l2, l1
        for k in range(1, 5):
            feats = 256 if k == 1 else rc  # the deepest stage refines at 256
            setattr(self, f"p_ims1d2_outl{k}_dimred", _conv3x3(skips[k - 1], feats))
            setattr(self, f"adapt_stage{k}_b", nn.Sequential(RCUBlock(feats, 2)))
            if k > 1:
                setattr(self, f"adapt_stage{k}_b2_joint_varout_dimred", _conv3x3(feats, feats))
            setattr(self, f"mflow_conv_g{k}_pool", nn.Sequential(RCPB(feats, 4)))
            setattr(self, f"mflow_conv_g{k}_b", nn.Sequential(RCUBlock(feats, 3)))
            if k < 4:
                setattr(self, f"mflow_conv_g{k}_b3_joint_varout_dimred", _conv3x3(feats, rc))
        for k in (4, 3, 2):
            setattr(self, f"upCT{k}", nn.ConvTranspose2d(rc, rc, 4, 2, 1))
        self.clf_conv1 = nn.Conv2d(rc, 64, 5, padding=2)
        self.clf_conv2 = nn.Conv2d(64, cfg.out_channels, 3, padding=2)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        cnn_init(self, generator)

    def _refine(self, k: int, skip: torch.Tensor, deeper: Optional[torch.Tensor]):
        x = conv(getattr(self, f"p_ims1d2_outl{k}_dimred"), skip)
        x = getattr(self, f"adapt_stage{k}_b")(x)
        if k > 1:
            x = conv(getattr(self, f"adapt_stage{k}_b2_joint_varout_dimred"), x)
        if deeper is not None:
            x = x + deeper
        x = F.relu(x)
        x = getattr(self, f"mflow_conv_g{k}_pool")(x)
        x = getattr(self, f"mflow_conv_g{k}_b")(x)
        if k < 4:
            x = conv(getattr(self, f"mflow_conv_g{k}_b3_joint_varout_dimred"), x)
        return x

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`generator` is unused (the CNNs draw nothing in training); the
        train step passes it to every family."""
        x = F.relu(batch_norm(self.bn1, conv(self.conv1, to_nchw(x, self.dtype))))
        feats = []
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
            feats.append(x)
        l1, l2, l3, l4 = feats
        x = None
        for k, skip in ((1, l4), (2, l3), (3, l2), (4, l1)):
            if x is not None:
                x = crop_like(conv_transpose(getattr(self, f"upCT{6 - k}"), x), skip)
            x = self._refine(k, skip, x)
        out = conv(self.clf_conv2, conv(self.clf_conv1, x))
        return to_nhwc(out)


def build_msresunet(config: MSResUNetConfig, dtype=None, impl: str = "auto") -> MSResUNet:
    """An MS_ResUNet in eval mode (``train()`` for training)."""
    return MSResUNet(config, dtype=dtype, impl=impl).eval()


register_model("ms_resunet", MSResUNetConfig, build_msresunet)
