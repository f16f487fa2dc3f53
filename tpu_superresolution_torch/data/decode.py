"""Host-side image decode: PIL -> float32 [0, 1] HWC numpy (port of
``tpu_superresolution_tpu/data/decode.py``; 16-bit modes scale by
65535, RGB -> gray by the ITU-R 601 luma weights torchvision uses)."""

from __future__ import annotations

import numpy as np

_LUMA = np.asarray([0.2989, 0.587, 0.114], dtype=np.float32)


def decode_image(path, grayscale: bool = True, channels: int = 1) -> np.ndarray:
    """Decode a file path or binary stream to float32 [0, 1], [H, W, channels]."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.dtype == np.uint8:
        x = arr.astype(np.float32) / 255.0
    elif arr.dtype == np.uint16 or arr.dtype == np.int32:  # PIL 'I;16' / 'I'
        x = arr.astype(np.float32) / 65535.0
    else:  # float modes: assumed already in [0, 1]
        x = arr.astype(np.float32)
    if x.ndim == 2:
        x = x[:, :, None]
    if x.shape[2] == 4:  # drop alpha
        x = x[:, :, :3]
    if grayscale and x.shape[2] == 3:
        x = (x @ _LUMA)[:, :, None]
    if x.shape[2] == 1 and channels == 3:
        x = np.repeat(x, 3, axis=2)
    elif channels == 1 and x.shape[2] == 3 and not grayscale:
        x = (x @ _LUMA)[:, :, None]
    return x


def load_pair_batch(pairs, grayscale: bool = True, channels: int = 1):
    """Decode [(lr_path, hr_path), ...] into stacked [B, h, w, C] /
    [B, H, W, C] float32 arrays (sizes must be uniform in a batch)."""
    lrs = [decode_image(lp, grayscale, channels) for lp, _ in pairs]
    hrs = [decode_image(hp, grayscale, channels) for _, hp in pairs]
    return np.stack(lrs), np.stack(hrs)
