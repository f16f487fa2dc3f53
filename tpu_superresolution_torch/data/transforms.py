"""Paired batch transforms on the device (port of
``tpu_superresolution_tpu/data/transforms.py``; reference
finetune_swinir.py:96-121, sr_transforms.py:55-152, cnn.ipynb cells 17
and 22), in both conventions:

- **pre_upscale** (the CNN families): LR bicubic-upscaled to the HR
  size, then one random crop at the same coordinates in both members,
  flips, and the paired blur;
- **native_lr** (the transformers): an LR crop and the HR crop at the
  scaled coordinates, flips, the paired blur;

and the dataset normalization (x - mean) / std with its streaming
statistics.

Randomness comes from an explicit ``torch.Generator`` on the host: the
offsets, coin flips and the blur's sigma are drawn there, the pixels
never leave the device.  It gives other numbers than ``jax.random`` for
the same seed, so each random function has an ``_at`` form that takes
its draws, and the tests hand both packages the same ones.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

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


def crop_at(lr: torch.Tensor, hr: torch.Tensor, tops: Sequence[int], lefts: Sequence[int],
            ph: int, pw: int):
    """[ph, pw] crops at (tops[i], lefts[i]) of both equal-size members."""
    crop = lambda x: torch.stack([x[i, t : t + ph, l : l + pw]
                                  for i, (t, l) in enumerate(zip(tops, lefts))])
    return crop(lr), crop(hr)


def paired_random_crop(lr: torch.Tensor, hr: torch.Tensor, patch: int,
                       generator: Optional[torch.Generator] = None):
    """Same-coordinates random crop of an equal-size pair (PairRandomCrop,
    sr_transforms.py:65-112), one offset per image; a patch past the
    image is cut to it, and a patch that covers the image returns the
    pair as it is, drawing nothing."""
    b, h, w, _ = hr.shape
    ph, pw = min(patch, h), min(patch, w)
    if ph == h and pw == w:
        return lr, hr
    tops = torch.randint(0, h - ph + 1, (b,), generator=generator).tolist()
    lefts = torch.randint(0, w - pw + 1, (b,), generator=generator).tolist()
    return crop_at(lr, hr, tops, lefts, ph, pw)


def _gaussian_kernel1d(sigma: float, radius: int) -> torch.Tensor:
    """fp32 1-D gaussian of `radius`, normalized to sum 1."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    s = torch.tensor(sigma, dtype=torch.float32)
    k = torch.exp(-(x ** 2) / (2.0 * s ** 2))
    return k / k.sum()


def _blur_axis(x: torch.Tensor, k, radius: int, axis: int) -> torch.Tensor:
    """One separable pass on NCHW x along H (axis 2) or W (axis 3), with
    reflect padding that excludes the edge pixel: the taps summed in x's
    dtype (no TF32 path on the card)."""
    pad = (0, 0, radius, radius) if axis == 2 else (radius, radius, 0, 0)
    xp = F.pad(x, pad, mode="reflect")
    n = x.shape[axis]
    out = k[0] * xp.narrow(axis, 0, n)
    for t in range(1, 2 * radius + 1):
        out = out + k[t] * xp.narrow(axis, t, n)
    return out


def gaussian_blur(x: torch.Tensor, sigma: float, radius: int = 4) -> torch.Tensor:
    """Separable gaussian blur of NHWC x (torchvision GaussianBlur's
    semantics): H first, then W, the kernel in x's dtype."""
    k = _gaussian_kernel1d(sigma, radius).to(x.dtype).tolist()
    y = x.permute(0, 3, 1, 2)
    y = _blur_axis(_blur_axis(y, k, radius, 2), k, radius, 3)
    return y.permute(0, 2, 3, 1).contiguous()


def paired_blur_at(lr: torch.Tensor, hr: torch.Tensor, do: Sequence[bool], sigma: float):
    """Blur both members of the images where `do` is set, at one `sigma`."""
    if not any(do):
        return lr, hr
    mask = torch.tensor(list(do), device=lr.device).view(-1, 1, 1, 1)
    return (torch.where(mask, gaussian_blur(lr, sigma), lr),
            torch.where(mask, gaussian_blur(hr, sigma), hr))


def paired_random_blur(lr: torch.Tensor, hr: torch.Tensor,
                       generator: Optional[torch.Generator] = None, p: float = 0.5,
                       sigma_range: Tuple[float, float] = (0.1, 2.0)):
    """PairGaussianBlur (cnn.ipynb cell 22): each image blurred with
    probability p, both members alike, at ONE sigma ~ U(sigma_range) for
    the whole batch."""
    do = (torch.rand(lr.shape[0], generator=generator) < p).tolist()
    lo, hi = sigma_range
    sigma = lo + (hi - lo) * float(torch.rand((), generator=generator))
    return paired_blur_at(lr, hr, do, sigma)


def make_train_batch_preupscale(lr: torch.Tensor, hr: torch.Tensor, scale: int, patch: int,
                                do_flips: bool = True,
                                generator: Optional[torch.Generator] = None,
                                do_blur: bool = False):
    """Pre-upscale train batch: upscale LR to HR size -> shared random crop
    -> flips [-> blur] (the notebook pipeline, cnn.ipynb cell 22)."""
    lr_c, hr_c = paired_random_crop(pre_upscale_batch(lr, scale), hr, patch, generator)
    if do_flips:
        lr_c, hr_c = paired_random_flips(lr_c, hr_c, generator)
    if do_blur:
        lr_c, hr_c = paired_random_blur(lr_c, hr_c, generator)
    return lr_c, hr_c


def make_train_batch_native(lr: torch.Tensor, hr: torch.Tensor, scale: int, lr_patch: int,
                            do_flips: bool = False,
                            generator: Optional[torch.Generator] = None,
                            do_blur: bool = False):
    """Native-LR train batch: crop, then optional flips and blur (the
    SwinIR fine-tune path crops only, finetune_swinir.py:112-121)."""
    lr_c, hr_c = paired_random_crop_native(lr, hr, lr_patch, scale, generator)
    if do_flips:
        lr_c, hr_c = paired_random_flips(lr_c, hr_c, generator)
    if do_blur:
        lr_c, hr_c = paired_random_blur(lr_c, hr_c, generator)
    return lr_c, hr_c


def normalize(x, mean: float, std: float):
    """PairNormalize (cnn.ipynb cell 22): (x - mean) / std."""
    return (x - mean) / std


def denormalize(x, mean: float, std: float):
    return x * std + mean


def dataset_mean_std(loader, use_hr: bool = True) -> Tuple[float, float]:
    """Streaming mean / std over a loader's (lr, hr) numpy batches (exact
    moments; the reference's histogram version is cnn.ipynb cell 17):
    the sum of each float32 batch, the squares in float64."""
    s = ss = n = 0.0
    for lr_np, hr_np in loader:
        x = hr_np if use_hr else lr_np
        s += float(x.sum())
        ss += float((x.astype(np.float64) ** 2).sum())
        n += x.size
    mean = s / max(n, 1.0)
    var = ss / max(n, 1.0) - mean * mean
    return mean, float(np.sqrt(max(var, 0.0)))
