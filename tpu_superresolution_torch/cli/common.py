"""Plumbing shared by the port's entry points (port of
``tpu_superresolution_tpu/cli/common.py``): the device choice, seeding
and the loader's worker count.

The entry points run on the GPU.  The CPU is used only when the caller
asks for it (``--device cpu`` on the command line, ``device="cpu"`` in
the API); without a CUDA device anything else raises.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
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


def report_device(device: torch.device) -> None:
    if device.type == "cuda":
        print(f"[device] {torch.cuda.get_device_name(device)} x{torch.cuda.device_count()} "
              "(bf16, port kernels)", flush=True)
    else:
        print("[device] cpu (fp32, plain versions of the kernels)", flush=True)


def add_device_flag(ap) -> None:
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default; raises without a GPU) or cpu")


def seed_everything(seed: int) -> torch.Generator:
    """Seed numpy's and torch's global generators (reference
    train.py:34-37) and return a torch.Generator of the same seed, the
    explicit source of the train step's randomness."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def resolve_workers(workers: Optional[int]) -> int:
    if workers is not None:
        return workers
    return min(8, max(2, (os.cpu_count() or 4) // 2))
