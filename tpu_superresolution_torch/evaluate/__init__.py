"""Evaluation of the port: tiled whole-image inference, the bicubic
baseline and the dataset evaluation loop."""

from .tiling import tiled_forward, tile_grid
from .baseline import bicubic_baseline
from .runner import Evaluator, save_tensor_as_png

__all__ = [
    "tiled_forward",
    "tile_grid",
    "bicubic_baseline",
    "Evaluator",
    "save_tensor_as_png",
]
