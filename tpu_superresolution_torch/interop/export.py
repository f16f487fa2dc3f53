"""Model export: a serialized ``torch.export`` program and its parity
check (port of ``tpu_superresolution_tpu/interop/export.py``, whose
StableHLO artifact this replaces; the reference's ONNX deployment path,
model_debug.ipynb cells 12-16: torch.onnx.export + onnxruntime parity,
max abs diff 2.68e-6).

``export_model`` traces an eval-mode forward at one static input shape
(``torch.export.export(..., strict=False)``) and saves it as a ``.pt2``
with ``torch.export.save``; ``load_exported`` loads one back as a
callable, runnable without the model's Python definition (the port's
package still has to be importable: it registers the kernels' ops).

- On the CPU the plain path exports (the wrappers' plain versions).
- On CUDA the program runs the port's kernels as the ``tpu_sr::`` custom
  ops of ``kernels/custom_ops.py``: every kernel an inference forward
  launches (``EXPORTABLE``), so that every family exports (SwinIR at any
  window and width, HAT, ``hat_fast``, HAT-SRx4, DAT on its kernel
  fronts or its module chain, and the CNNs, which launch none).  A
  forward that launches any other kernel (a training-only one: the eval
  forward never does) is refused with its name; its plain path is never
  exported instead.

Before tracing, one eager forward at the input shape fills the caches
the forward reads: the weights' packed layouts and composed convs
(``models.blocks.DerivedCache``), which the program then holds as
constants, so that the loaded program launches what the eager path
launches, on the same operands, and the shape-keyed index tables and
masks, which a cache miss inside the trace would otherwise fill with the
trace's fake tensors.  On CUDA it also builds the kernels and counts the
launches.  The trace runs without gradients, as the warm-up does, so
that it takes the warm-up's path (with gradients, a block that trains on
a backward kernel would take its autograd function and read tables the
warm-up never built).
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_superresolution_torch.kernels import read_counters, reset_counters
from tpu_superresolution_torch.kernels.custom_ops import EXPORTABLE


def _warm_up(model: torch.nn.Module, x: torch.Tensor) -> None:
    """The eager forward at x's shape (the module docstring says why);
    on CUDA, raises when it launched a kernel with no custom op (the
    guard for anything outside ``EXPORTABLE``)."""
    reset_counters()
    with torch.no_grad():
        model(x)
    if x.device.type != "cuda":
        return
    torch.cuda.synchronize(x.device)
    other = {k: n for k, n in read_counters().items() if n and k not in EXPORTABLE}
    reset_counters()
    if other:
        raise NotImplementedError(
            f"export on CUDA: this model's forward launches {sorted(other)}, which have no "
            f"torch.library custom op (the ops stand for the inference kernels "
            f"{list(EXPORTABLE)}; export an eval-mode model)")


def export_model(model: torch.nn.Module, input_shape: Sequence[int],
                 path: Optional[str] = None, dtype: torch.dtype = torch.float32) -> bytes:
    """Export `model`'s eval forward at `input_shape` (NHWC, `dtype`, on
    the model's device) and return the ``.pt2`` bytes (also written to
    `path`)."""
    model = model.eval()
    x = torch.zeros(tuple(input_shape), dtype=dtype, device=next(model.parameters()).device)
    _warm_up(model, x)
    with torch.no_grad():
        program = torch.export.export(model, (x,), strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path is not None:
        Path(path).write_bytes(blob)
    return blob


def load_exported(path_or_bytes) -> Callable[[torch.Tensor], torch.Tensor]:
    """Load an exported program (a ``.pt2`` path or its bytes); returns a
    callable f(x).  (This module's import of ``kernels`` registered the
    ``tpu_sr::`` ops the program calls.)"""
    src = (io.BytesIO(bytes(path_or_bytes)) if isinstance(path_or_bytes, (bytes, bytearray))
           else str(path_or_bytes))
    module = torch.export.load(src).module()
    return lambda x: module(x)


def export_parity(model: torch.nn.Module, input_shape: Sequence[int],
                  dtype: torch.dtype = torch.float32, seed: int = 0) -> Tuple[float, float]:
    """Export -> load -> compare against the live model on a random input
    (the reference's ONNX-parity pattern).  Returns (max abs diff, mean
    abs diff) of the outputs in fp32."""
    fn = load_exported(export_model(model, input_shape, dtype=dtype))
    device = next(model.parameters()).device
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random(tuple(input_shape)).astype(np.float32)).to(device, dtype)
    with torch.no_grad():
        a = fn(x).float()
        b = model.eval()(x).float()
    d = (a - b).abs()
    return float(d.max()), float(d.mean())
