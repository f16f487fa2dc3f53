"""MRCCM2D: MATLAB .mat volumes -> a paired 2-D slice dataset (port of
``tpu_superresolution_tpu/data/mrccm.py``; the reference's lost
prepare_mrccm.py / mat_eval_mrccm.py, whose CLIs common_commands.txt:
1-3, 8-11 documents).  The dataset on which the reference reports
UNet2D (results.ipynb cells 53-55).

The JAX package's choices, kept:
- volumes are sliced along axis 0;
- each volume is min-max normalized to [0, 1] before slicing, and the
  slices are stored as 16-bit grayscale PNG;
- ``force_4x`` bicubic-resizes each LR slice to exactly HR / scale
  (``ops/resize.py``, PIL parity);
- slices are split by index, interleaved: i % 10 < 8 train, 8 valid, 9
  test.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def load_mat_volume(path, key: Optional[str] = None) -> np.ndarray:
    """A 3-D array from a .mat file (classic through ``scipy.io``, v7.3
    through h5py, imported only for such a file): `key`, or the largest
    array that is not metadata; a 2-D array becomes one slice."""
    from scipy.io import loadmat

    path = str(path)
    try:
        arrays = {k: v for k, v in loadmat(path).items() if not k.startswith("__")}
    except NotImplementedError:  # v7.3, HDF5-based
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"{path} is a MATLAB v7.3 (HDF5) file, which needs h5py; h5py "
                              "is not installed") from e
        with h5py.File(path, "r") as f:
            arrays = {k: np.asarray(f[k]) for k in f.keys()}
    if not arrays:
        raise ValueError(f"no arrays found in {path}")
    arr = np.asarray(arrays[key] if key is not None
                     else max(arrays.values(), key=lambda a: np.asarray(a).size))
    if arr.ndim == 2:
        arr = arr[None]
    if arr.ndim != 3:
        raise ValueError(f"expected a 2-D/3-D volume in {path}, got {arr.shape}")
    return arr


def normalize_volume(vol: np.ndarray) -> np.ndarray:
    """Min-max to [0, 1] in float64, returned float32 (zeros when flat)."""
    vol = vol.astype(np.float64)
    mn, mx = vol.min(), vol.max()
    if mx <= mn:
        return np.zeros_like(vol, dtype=np.float32)
    return ((vol - mn) / (mx - mn)).astype(np.float32)


def _save_slice_png(slice01: np.ndarray, path: Path) -> None:
    from PIL import Image

    u16 = (np.clip(slice01, 0.0, 1.0) * 65535.0 + 0.5).astype(np.uint16)
    Image.fromarray(u16).save(str(path))


def _split_of(i: int) -> str:
    r = i % 10
    if r < 8:
        return "train"
    return "valid" if r == 8 else "test"


def prepare_mrccm(lr_mat, hr_mats: Dict[str, str], out_root, scale: str = "X4",
                  force_4x: bool = False, limit_slices: Optional[int] = None) -> Dict[str, int]:
    """Write a DeepRockSR-layout paired dataset from .mat volumes: the
    LR volume is shared, each named HR volume contributes its slices,
    paired by index with the LR volume's (``<name>_<i:05d>.png`` and
    ``<name>_<i:05d>x<s>.png``).  Returns the count of pairs a split."""
    from tpu_superresolution_torch.ops.resize import resize_bicubic

    out_root = Path(out_root)
    s = int(scale[1:])
    lr_vol = normalize_volume(load_mat_volume(lr_mat))
    dirs = {}
    for split in ("train", "valid", "test"):
        hr_dir = out_root / "shuffled2D" / f"shuffled2D_{split}_HR"
        lr_dir = out_root / "shuffled2D" / f"shuffled2D_{split}_LR_default_{scale}"
        hr_dir.mkdir(parents=True, exist_ok=True)
        lr_dir.mkdir(parents=True, exist_ok=True)
        dirs[split] = (hr_dir, lr_dir)

    counts = {"train": 0, "valid": 0, "test": 0}
    idx = 0
    for name, hr_path in hr_mats.items():
        hr_vol = normalize_volume(load_mat_volume(hr_path))
        n = min(hr_vol.shape[0], lr_vol.shape[0])
        if limit_slices is not None:
            n = min(n, limit_slices)
        for i in range(n):
            hr_sl, lr_sl = hr_vol[i], lr_vol[i]
            if force_4x:
                th, tw = hr_sl.shape[0] // s, hr_sl.shape[1] // s
                if lr_sl.shape != (th, tw):
                    lr_sl = resize_bicubic(torch.from_numpy(lr_sl[..., None]), th, tw)
                    lr_sl = lr_sl.numpy()[..., 0]
            split = _split_of(idx)
            hr_dir, lr_dir = dirs[split]
            stem = f"{name}_{i:05d}"
            _save_slice_png(hr_sl, hr_dir / f"{stem}.png")
            _save_slice_png(lr_sl, lr_dir / f"{stem}x{s}.png")
            counts[split] += 1
            idx += 1
    return counts


def mat_volume_pairs(lr_mat, hr_mat, limit_pairs: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Paired (lr, hr) slice stacks [N, h, w, 1], float32 in [0, 1], for
    evaluating straight on .mat volumes (mat_eval_mrccm.py)."""
    lr_vol = normalize_volume(load_mat_volume(lr_mat))
    hr_vol = normalize_volume(load_mat_volume(hr_mat))
    n = min(lr_vol.shape[0], hr_vol.shape[0])
    if limit_pairs is not None:
        n = min(n, limit_pairs)
    return lr_vol[:n][..., None], hr_vol[:n][..., None]
