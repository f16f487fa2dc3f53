"""PSNR / SSIM with the reference's semantics, in fp32 (port of
``tpu_superresolution_tpu/ops/metrics.py``).

- ``batch_psnr`` (reference train.py:46-56): per image, clamp to [0, 1],
  ``20 log10(max / sqrt(mse + 1e-8))`` -> [B].
- ``psnr`` (reference evaluate.py:24-29): batch mean of
  ``10 log10(max^2 / max(mse, 1e-10))``.
- ``ssim``: ``pytorch_msssim.ssim`` with data_range 1: gaussian window
  11, sigma 1.5, valid (unpadded) separable filtering, K = (0.01, 0.03),
  mean over everything (or per image).

Inputs are NHWC.  The filters are products with banded matrices
(``torch.einsum``), which run in full fp32 on CUDA as well (TF32 is off
for matmuls by default; a cuDNN conv would take TF32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def batch_psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Per-image PSNR in dB, shape [B] (the train-loop variant)."""
    pred = pred.float().clamp(0.0, 1.0)
    target = target.float().clamp(0.0, 1.0)
    mse = ((pred - target) ** 2).reshape(pred.shape[0], -1).mean(dim=1)
    return 20.0 * torch.log10(max_val / torch.sqrt(mse + 1e-8))


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Batch-mean PSNR (the evaluate variant): per-image MSE floored at 1e-10."""
    pred = pred.float().clamp(0.0, 1.0)
    target = target.float().clamp(0.0, 1.0)
    mse = ((pred - target) ** 2).reshape(pred.shape[0], -1).mean(dim=1).clamp_min(1e-10)
    return (10.0 * torch.log10((max_val * max_val) / mse)).mean()


@functools.lru_cache(maxsize=16)
def _gaussian_window(win_size: int, sigma: float) -> np.ndarray:
    """1-D normalised gaussian (pytorch_msssim._fspecial_gauss_1d)."""
    coords = np.arange(win_size, dtype=np.float64) - win_size // 2
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _band(n: int, win_size: int, sigma: float) -> np.ndarray:
    """[n - k + 1, n]: row i holds the window at offset i."""
    win = _gaussian_window(win_size, sigma)
    k = win.shape[0]
    m = np.zeros((n - k + 1, n), np.float32)
    for i in range(n - k + 1):
        m[i, i : i + k] = win
    return m


def _gaussian_filter_valid(x: torch.Tensor, win_size: int, sigma: float) -> torch.Tensor:
    h, w = x.shape[-3], x.shape[-2]
    bh = torch.from_numpy(_band(h, win_size, sigma)).to(x.device)
    bw = torch.from_numpy(_band(w, win_size, sigma)).to(x.device)
    x = torch.einsum("oh,...hwc->...owc", bh, x)
    return torch.einsum("ow,...hwc->...hoc", bw, x)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         win_size: int = 11, win_sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
         size_average: bool = True) -> torch.Tensor:
    """SSIM on NHWC images: a scalar, or per-image [B] values."""
    x, y = pred.float(), target.float()
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    filt = lambda t: _gaussian_filter_valid(t, win_size, win_sigma)
    mu1, mu2 = filt(x), filt(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(x * x) - mu1_sq
    sigma2_sq = filt(y * y) - mu2_sq
    sigma12 = filt(x * y) - mu1_mu2
    cs_map = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2.0 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    per_image = ssim_map.reshape(ssim_map.shape[0], -1).mean(dim=1)
    return per_image.mean() if size_average else per_image
