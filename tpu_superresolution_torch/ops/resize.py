"""Antialiased separable resize with PIL / torchvision parity, as two
matrix products (port of ``tpu_superresolution_tpu/ops/resize.py``).

The reference's degradation-inversion convention bicubic-upscales LR to
the HR size with ``torchvision TF.resize(..., BICUBIC, antialias=True)``
(reference modules/sr_transforms.py:55-63), and its bicubic baseline is
the PSNR / SSIM of that upscale against HR (modules/evaluate.py:114-134):
metric parity needs PIL's antialiased kernel weights, which
``torch.nn.functional.interpolate`` does not reproduce at the borders.

A separable resize is ``out = W_h @ img @ W_w^T``.  The weight matrices
depend only on the (in_size, out_size) pair; they are computed once on
the host in float64 (``_resize_matrix``, cached as numpy) and kept per
device as fp32 tensors (``_resize_matrix_on``, a cache of its own).  The
two contractions are ``torch.einsum`` on NHWC, plain torch ops with no
hand-written kernel.

The products run in full fp32 on CUDA as well: torch leaves TF32 off for
matmuls by default (``torch.backends.cuda.matmul.allow_tf32``), and the
port never turns it on (``ops/metrics.py`` relies on the same default).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Keys cubic kernel, a = -0.5 (the PIL / torchvision / OpenCV convention)."""
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.clip(1.0 - x, 0.0, None)


_KERNELS = {
    "bicubic": (_cubic_kernel, 2.0),
    "bilinear": (_linear_kernel, 1.0),
}


@functools.lru_cache(maxsize=512)
def _resize_matrix(in_size: int, out_size: int, method: str, antialias: bool) -> np.ndarray:
    """[out_size, in_size] row-stochastic weight matrix, PIL semantics
    (ImagingResampleHorizontal's weights): centres at (i + 0.5) * scale,
    the support widened by the downscale factor when antialiasing, edge
    taps dropped and the rest renormalised.  fp32 numpy."""
    kernel, base_support = _KERNELS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0) if antialias else 1.0
    support = base_support * filterscale

    w_mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        js = np.arange(xmin, xmax)
        w = kernel((js - center + 0.5) / filterscale)
        s = w.sum()
        if s != 0:
            w = w / s
        w_mat[i, xmin:xmax] = w
    return w_mat.astype(np.float32)


@functools.lru_cache(maxsize=512)
def _resize_matrix_on(in_size: int, out_size: int, method: str, antialias: bool,
                      device: torch.device) -> torch.Tensor:
    """``_resize_matrix`` as an fp32 tensor on `device`."""
    return torch.from_numpy(_resize_matrix(in_size, out_size, method, antialias)).to(device)


def _apply_separable(img: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor) -> torch.Tensor:
    """img [..., H, W, C] -> [..., H', W', C] by two contractions."""
    out = torch.einsum("oh,...hwc->...owc", wh, img)
    return torch.einsum("ow,...hwc->...hoc", ww, out)


def resize(img: torch.Tensor, out_h: int, out_w: int, method: str = "bicubic",
           antialias: bool = True) -> torch.Tensor:
    """Resize NHWC (or HWC) image(s) to (out_h, out_w), PIL parity.

    Computes in fp32 whatever the input dtype (a metric-bearing op) and
    casts back to a floating input's dtype; other inputs come back fp32.
    """
    if img.dim() < 3:
        raise ValueError(f"expected [..., H, W, C], got shape {tuple(img.shape)}")
    in_h, in_w = img.shape[-3], img.shape[-2]
    x = img.float()
    if (in_h, in_w) != (out_h, out_w):
        wh = _resize_matrix_on(in_h, out_h, method, antialias, x.device)
        ww = _resize_matrix_on(in_w, out_w, method, antialias, x.device)
        x = _apply_separable(x, wh, ww)
    if img.is_floating_point() and img.dtype != torch.float32:
        x = x.to(img.dtype)
    return x


def resize_bicubic(img: torch.Tensor, out_h: int, out_w: int,
                   antialias: bool = True) -> torch.Tensor:
    return resize(img, out_h, out_w, "bicubic", antialias)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int,
                    antialias: bool = True) -> torch.Tensor:
    return resize(img, out_h, out_w, "bilinear", antialias)


def upscale_lr_to_hr(lr: torch.Tensor, scale: int) -> torch.Tensor:
    """PairUpscaleLRtoHR (reference sr_transforms.py:55-63): bicubic,
    antialiased upscale of LR by `scale` (antialias does nothing when
    upscaling; kept for torchvision's exact semantics)."""
    h, w = lr.shape[-3], lr.shape[-2]
    return resize_bicubic(lr, h * scale, w * scale, antialias=True)


def degrade_hr_to_lr(hr: torch.Tensor, scale: int) -> torch.Tensor:
    """Antialiased bicubic downscale of HR by `scale`: the DeepRockSR
    'default' degradation that built LR_default_X{2,4}."""
    h, w = hr.shape[-3], hr.shape[-2]
    return resize_bicubic(hr, h // scale, w // scale, antialias=True)
