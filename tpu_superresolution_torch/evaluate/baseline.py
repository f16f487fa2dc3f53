"""The bicubic baseline: metrics of the bicubic-upscaled LR against HR
(port of ``tpu_superresolution_tpu/evaluate/baseline.py``).

The reference's floor check (evaluate.py:114-134): every trained model
must beat these numbers; published values in BASELINE.md (x2: 36.63 dB
/ 0.8748, x4: 31.42 dB / 0.7043 on the DeepRockSR shuffled2D test split).
"""

from __future__ import annotations

from typing import Dict, Union

import torch

from tpu_superresolution_torch.core.device import resolve_device
from tpu_superresolution_torch.data.transforms import pre_upscale_batch
from tpu_superresolution_torch.ops.metrics import batch_psnr, ssim


def _baseline_batch(lr_up: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """[PSNR sum, SSIM * batch] of one batch, on its device."""
    p01 = lr_up.float().clamp(0.0, 1.0)
    t01 = hr.float().clamp(0.0, 1.0)
    return torch.stack([batch_psnr(lr_up, hr).sum(), ssim(p01, t01) * lr_up.shape[0]])


def bicubic_baseline(loader, scale: int,
                     device: Union[None, str, torch.device] = None) -> Dict[str, float]:
    """Accumulate the baseline PSNR / SSIM over a loader of (lr, hr)
    numpy batches on `device` (the GPU unless the caller asks for the
    CPU), one read-back a batch."""
    device = resolve_device(device)
    psnr_sum = ssim_sum = n = 0.0
    with torch.no_grad():
        for lr_np, hr_np in loader:
            lr = pre_upscale_batch(torch.from_numpy(lr_np).to(device), scale)
            p, s = _baseline_batch(lr, torch.from_numpy(hr_np).to(device)).tolist()
            psnr_sum += p
            ssim_sum += s
            n += lr.shape[0]
    n = max(n, 1.0)
    return {"psnr": psnr_sum / n, "ssim": ssim_sum / n, "n": int(n)}
