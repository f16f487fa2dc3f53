"""The native C++ PNG decoder through ctypes (port of
``tpu_superresolution_tpu/data/native_decode.py``).

``native/decoder.cpp`` decodes a whole batch with a C++ thread pool
straight into one float32 [N, H, W, C] buffer, with the pixel semantics
of ``data/decode.py`` (8-bit / 255, 16-bit / 65535, RGB -> gray by the
ITU-R 601 luma weights, alpha dropped, gray -> RGB replicated).  Its C
ABI: ``srn_decode_batch`` and ``srn_probe``.

The port builds its own copy, at first use and never at import, with
``g++ -O3 -fPIC -std=c++17 -shared ... -lpng -lz -pthread`` into the
git-ignored ``tpu_superresolution_torch/build/``, named by a hash of the
source, under an ``fcntl.flock`` so that processes starting together
(test workers, a data loader's first batches) build it once.  Where it
cannot be built or loaded (no ``g++``, no libpng headers), ``available()``
is false and ``unavailable_reason()`` says why; the loader then decodes
with PIL.

``decodes`` counts the successful ``srn_decode_batch`` calls (and the
images they decoded), as the kernels count their launches.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR.parent / "native" / "decoder.cpp"
BUILD_DIR = PACKAGE_DIR / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lpng", "-lz", "-pthread")


class NativeUnavailable(RuntimeError):
    """The native decoder cannot be built or loaded here."""


class DecodeCounter:
    """Counts successful batch decodes and their images (thread-safe: the
    loader decodes from a thread pool)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.images = 0

    def add(self, images: int) -> None:
        with self._lock:
            self.count += 1
            self.images += images

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.images = 0


decodes = DecodeCounter()


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return Path(build_dir) / f"libsrnative_{digest}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``native/decoder.cpp`` into `build_dir` unless the library
    for this source is there; returns its path.  Raises
    ``NativeUnavailable`` when it cannot be built."""
    if not SOURCE.is_file():
        raise NativeUnavailable(f"no source at {SOURCE}")
    out = library_path(build_dir)
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeUnavailable("no C++ compiler (g++ not on PATH, CXX unset)")
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():  # built by another process while we waited
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                lines = proc.stderr.strip().splitlines() or [""]
                first = next((ln for ln in lines if "error" in ln), lines[-1])
                raise NativeUnavailable(f"{cxx} could not build {SOURCE.name} "
                                        f"({proc.returncode}): {first.strip()}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


@functools.lru_cache(maxsize=None)
def _load(build_dir: str) -> Tuple[Optional[ctypes.CDLL], str]:
    """(library, its path) or (None, the reason it is unavailable)."""
    try:
        path = build(Path(build_dir))
        lib = ctypes.CDLL(str(path))
    except (NativeUnavailable, OSError) as e:
        return None, str(e)
    lib.srn_decode_batch.restype = ctypes.c_int
    lib.srn_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.srn_probe.restype = ctypes.c_int
    lib.srn_probe.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 4
    return lib, str(path)


def _lib() -> ctypes.CDLL:
    lib, why = _load(str(BUILD_DIR))
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {why}")
    return lib


def available() -> bool:
    return _load(str(BUILD_DIR))[0] is not None


def unavailable_reason() -> Optional[str]:
    """None when the decoder is available, else why it is not."""
    lib, why = _load(str(BUILD_DIR))
    return None if lib is not None else why


def loaded_path() -> Optional[str]:
    lib, path = _load(str(BUILD_DIR))
    return path if lib is not None else None


def probe(path) -> Tuple[int, int, int, int]:
    """(h, w, channels, bit_depth) of a PNG."""
    h, w, c, b = (ctypes.c_int() for _ in range(4))
    if _lib().srn_probe(str(path).encode(), h, w, c, b) != 0:
        raise IOError(f"srn_probe failed for {path}")
    return h.value, w.value, c.value, b.value


def decode_batch_native(paths: Sequence, out_h: int, out_w: int, grayscale: bool = True,
                        channels: int = 1, num_threads: int = 0) -> np.ndarray:
    """Decode PNGs of one size into float32 [N, out_h, out_w, channels];
    IOError names the first file that failed (missing, not a PNG, or of
    another size)."""
    lib = _lib()
    n = len(paths)
    out = np.empty((n, out_h, out_w, channels), dtype=np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.srn_decode_batch(arr, n, out_h, out_w, 1 if grayscale else 0, channels,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    if rc != 0:
        raise IOError(f"native decode failed for {paths[rc - 1]}")
    decodes.add(n)
    return out
