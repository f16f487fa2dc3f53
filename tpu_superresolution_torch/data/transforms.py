"""Paired batch transforms on the device (port of the native-LR part
of ``tpu_superresolution_tpu/data/transforms.py`` and its bicubic
pre-upscale; reference finetune_swinir.py:96-121, sr_transforms.py:
55-63): a scale-aware random crop and per-image flips, applied
identically to the LR / HR pair of each image, and the pre-upscale of
an LR batch to the HR size.

Randomness comes from an explicit ``torch.Generator`` on the host: the
offsets and coin flips are drawn there, the pixels never leave the
device.  It gives other numbers than ``jax.random`` for the same seed,
so the tests hand both packages the same offsets.  The pre-upscale
convention's train crops, blur and normalization are still to port.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from tpu_superresolution_torch.ops.resize import resize_bicubic


def pre_upscale_batch(lr: torch.Tensor, scale: int) -> torch.Tensor:
    """Bicubic, antialiased upscale of LR [B, h, w, C] to [B, h*s, w*s, C]
    (PairUpscaleLRtoHR, sr_transforms.py:55-63)."""
    return resize_bicubic(lr, lr.shape[1] * scale, lr.shape[2] * scale)


def crop_native_at(lr: torch.Tensor, hr: torch.Tensor, tops: Sequence[int],
                   lefts: Sequence[int], lr_patch: int, scale: int):
    """LR crops [p, p] at (tops[i], lefts[i]) and the HR crops [p*s, p*s]
    at the scaled offsets, NHWC."""
    ps = lr_patch * scale
    lr_c = torch.stack([lr[i, t : t + lr_patch, l : l + lr_patch]
                        for i, (t, l) in enumerate(zip(tops, lefts))])
    hr_c = torch.stack([hr[i, t * scale : t * scale + ps, l * scale : l * scale + ps]
                        for i, (t, l) in enumerate(zip(tops, lefts))])
    return lr_c, hr_c


def paired_random_crop_native(lr: torch.Tensor, hr: torch.Tensor, lr_patch: int, scale: int,
                              generator: Optional[torch.Generator] = None):
    """Scale-aware random crop (finetune_swinir.py:96-110): one offset
    per image, uniform over the valid range."""
    b, h, w, _ = lr.shape
    if h < lr_patch or w < lr_patch:
        raise ValueError(f"LR {h}x{w} smaller than lr_patch {lr_patch}")
    tops = torch.randint(0, h - lr_patch + 1, (b,), generator=generator).tolist()
    lefts = torch.randint(0, w - lr_patch + 1, (b,), generator=generator).tolist()
    return crop_native_at(lr, hr, tops, lefts, lr_patch, scale)


def flip_at(x: torch.Tensor, do_h: Sequence[bool], do_v: Sequence[bool]) -> torch.Tensor:
    """Per-image horizontal (W) and vertical (H) flips of NHWC x."""
    out = []
    for i in range(x.shape[0]):
        xi = x[i]
        if do_h[i]:
            xi = xi.flip(1)
        if do_v[i]:
            xi = xi.flip(0)
        out.append(xi)
    return torch.stack(out)


def paired_random_flips(lr: torch.Tensor, hr: torch.Tensor,
                        generator: Optional[torch.Generator] = None,
                        p_h: float = 0.5, p_v: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Coin-flip h / v flips, the same for both members of a pair, per
    image (PairFlips, sr_transforms.py:114-123)."""
    b = lr.shape[0]
    do_h = (torch.rand(b, generator=generator) < p_h).tolist()
    do_v = (torch.rand(b, generator=generator) < p_v).tolist()
    return flip_at(lr, do_h, do_v), flip_at(hr, do_h, do_v)


def make_train_batch_native(lr: torch.Tensor, hr: torch.Tensor, scale: int, lr_patch: int,
                            do_flips: bool = False,
                            generator: Optional[torch.Generator] = None):
    """Native-LR train batch: crop, then optional flips (the SwinIR
    fine-tune path crops only, finetune_swinir.py:112-121)."""
    lr_c, hr_c = paired_random_crop_native(lr, hr, lr_patch, scale, generator)
    if do_flips:
        lr_c, hr_c = paired_random_flips(lr_c, hr_c, generator)
    return lr_c, hr_c
