"""Device policy: the port's entry points run on the GPU.  The CPU is
used only when the caller asks for it (``--device cpu`` on the command
line, ``device="cpu"`` in the API); without a CUDA device anything else
raises."""

from __future__ import annotations

from typing import Union

import torch

NO_CUDA = ("no CUDA device: the entry points of tpu_superresolution_torch run on the GPU; "
           "pass --device cpu (device='cpu' in the API) to run on the CPU")


def default_device() -> torch.device:
    """The GPU; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CUDA)
    return torch.device("cuda")


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """`device` as a torch.device: None means the GPU, and a CUDA device
    on a machine without one raises (never a silent CPU run)."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(NO_CUDA)
    return device
