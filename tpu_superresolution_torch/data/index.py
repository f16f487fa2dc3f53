"""Paired LR/HR dataset index, host-side metadata only (port of
``tpu_superresolution_tpu/data/index.py``; reference sr_datasets.py:
31-58): list the HR directory, map stems, and pair every LR file whose
stem, with its x2 / _x2 / -x2 suffix stripped (case-insensitive,
sr_datasets.py:24-29), names an HR file."""

from __future__ import annotations

import re
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

_DEFAULT_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff")


def deeprock_dirs(root: str, split: str, scale: str) -> Tuple[Path, Path]:
    """DeepRockSR-2D layout (sr_datasets.py:14-22):
    root/shuffled2D/shuffled2D_{split}_HR and ..._LR_default_{scale}."""
    rootp = Path(root)
    hr = rootp / "shuffled2D" / f"shuffled2D_{split}_HR"
    lr = rootp / "shuffled2D" / f"shuffled2D_{split}_LR_default_{scale}"
    if not (hr.exists() and lr.exists()):
        raise FileNotFoundError(
            f"HR/LR directories not found for split={split}, scale={scale} under {root}")
    return hr, lr


def strip_lr_suffix(stem: str, scale: str) -> str:
    suf = scale.lower()
    if not suf.startswith("x"):
        suf = "x" + suf
    return re.sub(rf"([_-]?){re.escape(suf)}$", "", stem, flags=re.IGNORECASE)


class PairedIndex:
    """The (lr_path, hr_path) pairs of one dataset split."""

    def __init__(self, root: str, split: str = "train", scale: str = "X2",
                 exts: Sequence[str] = _DEFAULT_EXTS, hr_dir: Optional[str] = None,
                 lr_dir: Optional[str] = None):
        if hr_dir is not None and lr_dir is not None:
            self.hr_dir, self.lr_dir = Path(hr_dir), Path(lr_dir)
        else:
            self.hr_dir, self.lr_dir = deeprock_dirs(root, split, scale)
        self.scale = scale
        exts = tuple(e.lower() for e in exts)
        hr_files = sorted(p for p in self.hr_dir.iterdir() if p.suffix.lower() in exts)
        if not hr_files:
            raise RuntimeError(f"No HR files in {self.hr_dir}")
        hr_map = {p.stem: p for p in hr_files}
        pairs: List[Tuple[Path, Path]] = []
        for p in sorted(p for p in self.lr_dir.iterdir() if p.suffix.lower() in exts):
            hr = hr_map.get(strip_lr_suffix(p.stem, scale))
            if hr is not None:
                pairs.append((p, hr))
        if not pairs:
            raise RuntimeError("No LR<->HR pairs matched by filename stems.")
        self.pairs = pairs

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, i: int) -> Tuple[Path, Path]:
        return self.pairs[i]
