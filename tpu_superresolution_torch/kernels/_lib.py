"""Build, load and call the port's CUDA kernels.

The sources under ``tpu_superresolution_torch/csrc/`` are compiled by
``nvcc`` into ONE shared library with a plain C interface the first time
a kernel is launched (or when ``build()`` is called), into
``tpu_superresolution_torch/build/``, named by a hash of the sources and
flags so an edited source rebuilds.  Each ``.cu`` is compiled by its own
``nvcc`` process, all started together, and the objects are linked.  The library is loaded with
``ctypes``: every pointer and the stream are passed as ``c_void_p``, and
every entry point returns ``cudaGetLastError()``, which ``check_status``
turns into an exception.

Nothing here runs at import time: importing a kernel module on a machine
with no ``nvcc`` (the CPU test machine) is fine, and only a launch on a
CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: argtypes (pointers and the stream last as c_void_p)
    "sr_layernorm_bf16": [_P, _P, _P, _P, ctypes.c_longlong] + [_I] * 4 + [ctypes.c_float, _P],
    "sr_conv_bf16": [_P, _P, _P, _P] + [_I] * 14 + [_P, _P],
    "sr_swin_block_bf16": [_P] * 15 + [_I] * 13 + [ctypes.c_float, _P],
    "sr_swin_block_bwd_bf16": [_P] * 25 + [ctypes.POINTER(_I), ctypes.c_float, _P],
    "sr_ocab_fwd_bf16": [_P] * 18 + [ctypes.POINTER(_I), ctypes.c_float, _P],
    "sr_ocab_bwd_bf16": [_P] * 27 + [ctypes.POINTER(_I), ctypes.c_float, _P],
    "sr_dat_rect_bf16": [_P] * 15 + [ctypes.POINTER(_I), ctypes.c_float, _P],
    "sr_dat_channel_bf16": [_P] * 14 + [ctypes.POINTER(_I), ctypes.c_float, _P],
    "sr_dat_tail_bf16": [_P] * 8 + [ctypes.POINTER(_I), ctypes.c_float, _P],
    "sr_swin_tail_bf16": [_P] * 12 + [_I] * 8 + [ctypes.c_float, _I, _I, _P],
    "sr_swin_tail_wg_bf16": [_P] * 8 + [ctypes.POINTER(_I), ctypes.c_float, _P],
    "sr_ln_cab_convs_bf16": [_P] * 9 + [_I] * 8 + [ctypes.c_float, _P],
    "sr_dwconv3x3_bf16": [_P] * 4 + [ctypes.POINTER(_I), _P],
    "sr_batched_window_attention_bf16": [_P] * 6 + [_I] * 7 + [ctypes.c_float, _P],
    "sr_batched_window_attention_wg_bf16": [_P] * 6 + [_I] * 5 + [ctypes.c_float] + [_I] * 2
                                           + [_P],
    "sr_window_attention_wg_bf16": [_P] * 5 + [_I] * 5 + [ctypes.c_float] + [_I] * 3 + [_P],
    "sr_window_product_bf16": [_P] * 4 + [ctypes.c_longlong] + [_I] * 11 + [_P],
    "sr_window_attention_stream_bf16": ([_P] * 7 + [_I] * 10 + [ctypes.c_float] + [_I] * 9
                                        + [ctypes.POINTER(_I), _P]),
    "sr_swin_block_bwd_tiled_bf16": [_P] * 29 + [ctypes.POINTER(_I), ctypes.c_float, _P],
    "sr_ocab16_fwd_bf16": [_P] * 15 + [ctypes.POINTER(_I), ctypes.c_float, _P],
    "sr_ocab16_bwd_bf16": [_P] * 27 + [ctypes.POINTER(_I), ctypes.c_float, _P],
    "sr_ocab16_heads_bf16": [_P] * 4 + [_I] * 6 + [_P],
    "sr_ocab16_heads_bwd_bf16": [_P] * 4 + [_I] * 6 + [_P],
}


class LaunchCounter:
    """Counts the launches of one kernel: its wrapper adds one right
    after a successful launch, and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def _sources() -> Tuple[Path, ...]:
    return tuple(sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled at first use "
        "and need the CUDA toolkit (PATH or CUDA_HOME)"
    )


def library_path() -> Path:
    return BUILD_DIR / f"libsr_kernels_{source_hash()}.so"


def build(verbose: bool = False) -> Tuple[Path, float, str]:
    """Compile the kernels unless the library for these sources exists:
    one ``nvcc -c`` per source, all running at once, then one link.
    Returns (path, seconds spent, compiler output).  `verbose` adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel)."""
    out = library_path()
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():  # built by another process while we waited
                return out, time.perf_counter() - t0, ""
            nvcc = find_nvcc()
            objdir = BUILD_DIR / f"obj_{out.stem}_{os.getpid()}"
            objdir.mkdir(exist_ok=True)
            extra = ["-Xptxas", "-v"] if verbose else []
            jobs = []
            for src in (p for p in _sources() if p.suffix == ".cu"):
                obj = objdir / (src.stem + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), *extra, "-c", str(src),
                       "-o", str(obj)]
                jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True)))
            log = []
            failed = []
            for cmd, _, proc in jobs:
                text, _ = proc.communicate()
                log.append(text)
                if proc.returncode != 0:
                    failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
            if failed:
                raise RuntimeError("\n".join(failed))
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp)] + [str(o) for _, o, _ in jobs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
            shutil.rmtree(objdir, ignore_errors=True)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out, time.perf_counter() - t0, "".join(log) + proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_status(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the pointer the C entry
    points take (the raw-stream query where this torch has it: no Stream
    object built on every launch)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(t.device.index)
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device `index` (the persistent grids' size)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def call(t: torch.Tensor, fn, *args) -> int:
    """fn(*args) with t's CUDA device current (entering the device
    context only when another device is current)."""
    if t.device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(t.device):
        return fn(*args)


def check_tensor(
    t: Optional[torch.Tensor],
    name: str,
    dtype: torch.dtype,
    device: torch.device,
    shape: Optional[Sequence[int]] = None,
    ndim: Optional[int] = None,
    align: int = 16,
) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` on `device`
    (with the given shape / rank) whose data pointer is `align`-aligned."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: rank {t.dim()}, expected {ndim}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")


def require_cuda(x: torch.Tensor, name: str) -> None:
    """Kernel wrappers take CPU tensors (plain version) or CUDA tensors
    (the kernel); anything else is an error."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel or plain version for device {x.device}")


def plain_vjp(fn, inputs, needs, grad_out):
    """Gradients of `fn(*inputs)` for `grad_out` by torch autograd of a
    plain version, for the inputs flagged in `needs` (None for the
    others): the backward of the kernels whose TPU counterparts leave
    theirs to XLA."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) if torch.is_tensor(t) else t
                  for t, n in zip(inputs, needs)]
        wanted = [t for t, n in zip(leaves, needs) if n]
        grads = iter(torch.autograd.grad(fn(*leaves), wanted, grad_out) if wanted else ())
    return tuple(next(grads) if n else None for n in needs)
