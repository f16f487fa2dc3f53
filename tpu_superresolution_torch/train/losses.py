"""Loss functions in fp32 (port of
``tpu_superresolution_tpu/train/losses.py``; reference train.py:40-44
mse | l1, finetune_swinir.py:66-67 l1, cnn.ipynb cell 11 L1 + 0.1 (1 -
SSIM)), each in its batch-mean and per-sample ([B]) form."""

from __future__ import annotations

import torch

from tpu_superresolution_torch.ops.metrics import ssim


def _per_image(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(dim=1)


def l1_loss(pred, target):
    return (pred.float() - target.float()).abs().mean()


def mse_loss(pred, target):
    d = pred.float() - target.float()
    return (d * d).mean()


def l1_ssim_loss(pred, target, ssim_weight: float = 0.1):
    return l1_loss(pred, target) + ssim_weight * (
        1.0 - ssim(pred.clamp(0.0, 1.0), target.clamp(0.0, 1.0)))


def l1_loss_per_sample(pred, target):
    return _per_image((pred.float() - target.float()).abs())


def mse_loss_per_sample(pred, target):
    d = pred.float() - target.float()
    return _per_image(d * d)


def l1_ssim_loss_per_sample(pred, target, ssim_weight: float = 0.1):
    s = ssim(pred.clamp(0.0, 1.0), target.clamp(0.0, 1.0), size_average=False)
    return l1_loss_per_sample(pred, target) + ssim_weight * (1.0 - s)


_LOSSES = {"l1": l1_loss, "mse": mse_loss, "l1_ssim": l1_ssim_loss}
_LOSSES_PER_SAMPLE = {"l1": l1_loss_per_sample, "mse": mse_loss_per_sample,
                      "l1_ssim": l1_ssim_loss_per_sample}


def get_loss(name: str):
    if name not in _LOSSES:
        raise ValueError(f"Unknown loss '{name}'. Options: {sorted(_LOSSES)}")
    return _LOSSES[name]


def get_loss_per_sample(name: str):
    if name not in _LOSSES_PER_SAMPLE:
        raise ValueError(f"Unknown loss '{name}'. Options: {sorted(_LOSSES_PER_SAMPLE)}")
    return _LOSSES_PER_SAMPLE[name]
