"""Plumbing shared by the port's entry points (port of
``tpu_superresolution_tpu/cli/common.py``): the device flag and report
(the policy is ``core/device.py``'s), the ``--dp`` flag's process group,
seeding and the loader's worker count."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_superresolution_torch.core.device import NO_CUDA, resolve_device  # noqa: F401


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


def init_data_parallel(dp: int, device: Optional[str]) -> Tuple[int, torch.device]:
    """(dp, device) for a CLI's ``--dp``: 0 or 1 is one device
    (``resolve_device``), -1 every rank of the launch, N > 1 a process
    group of N ranks, one a device, which ``torchrun --nproc_per_node N``
    starts: each rank takes ``cuda:LOCAL_RANK``, or the CPU with
    ``--device cpu`` (gloo).  Any other launch raises SystemExit; it
    never runs on one device instead."""
    from tpu_superresolution_torch.parallel.mesh import (
        init_multihost,
        launched_world_size,
        local_device,
    )

    world = launched_world_size()
    if dp == -1:
        dp = world
    if dp <= 1:
        return 0, resolve_device(device)
    if world != dp:
        raise SystemExit(f"--dp {dp}: data parallelism runs one process a device; launch "
                         f"{dp} of them with `torchrun --nproc_per_node {dp} -m <this CLI> ... "
                         f"--dp {dp}` (this launch has {world})")
    dev = local_device(device)
    init_multihost(dev)
    return dp, dev
