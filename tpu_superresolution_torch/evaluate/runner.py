"""The reusable inference entry point (port of
``Evaluator.forward_fn`` and ``tensor_to_pil`` from
``tpu_superresolution_tpu/evaluate/runner.py``).  The dataset
evaluation loop, metrics and the pre-upscale convention of the CNN
families are still to port (ROADMAP.md)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from tpu_superresolution_torch.core.config import EvalConfig
from tpu_superresolution_torch.evaluate.tiling import tiled_forward


def tensor_to_pil(x: np.ndarray, per_image_rescale: bool = False):
    """[H, W, C] float -> PIL image (min-max rescale option, else clamp
    to [0, 1])."""
    from PIL import Image

    x = np.asarray(x, dtype=np.float32)
    if per_image_rescale:
        mn, mx = float(x.min()), float(x.max())
        x = np.zeros_like(x) if mx <= mn + 1e-8 else (x - mn) / (mx - mn)
    else:
        x = np.clip(x, 0.0, 1.0)
    arr = (x * 255.0 + 0.5).astype(np.uint8)
    if arr.shape[-1] == 1:
        return Image.fromarray(arr[..., 0], mode="L")
    return Image.fromarray(arr, mode="RGB")


def save_tensor_as_png(x: np.ndarray, path, per_image_rescale: bool = False):
    tensor_to_pil(x, per_image_rescale).save(str(path))


def _geo(x: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    """One of the 8 dihedral transforms of an NHWC batch (flip, then k
    quarter turns over the spatial axes)."""
    if flip:
        x = x.flip(2)
    if k:
        x = torch.rot90(x, k, dims=(1, 2))
    return x


def _geo_inv(x: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    if k:
        x = torch.rot90(x, -k, dims=(1, 2))
    if flip:
        x = x.flip(2)
    return x


@dataclass
class Evaluator:
    model: nn.Module
    scale: int
    convention: str = "pre_upscale"  # model input convention
    eval_config: EvalConfig = field(default_factory=EvalConfig)

    def forward_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """[B, H, W, C] -> [B, H*s, W*s, C] fp32 (tiling and the x8
        self-ensemble per the eval config), under ``torch.no_grad``."""
        if self.convention != "native_lr":
            raise NotImplementedError(
                "the pre_upscale convention arrives with the CNN families (ROADMAP.md)"
            )
        ecfg = self.eval_config

        def pipeline(lr: torch.Tensor) -> torch.Tensor:
            if ecfg.tile_size:
                out = tiled_forward(self.model, lr, self.scale, ecfg.tile_size,
                                    ecfg.tile_overlap, max_tile_batch=ecfg.max_tile_batch)
            else:
                out = self.model(lr)
            return out.float()

        def run(lr: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                if not ecfg.self_ensemble:
                    return pipeline(lr)
                acc = None
                for k in range(4):
                    for flip in (False, True):
                        o = _geo_inv(pipeline(_geo(lr, k, flip).contiguous()), k, flip)
                        acc = o if acc is None else acc + o
                return acc / 8.0

        return run
