"""Dtype policy (port of ``tpu_superresolution_tpu/core/dtypes.py``):
fp32 parameters; bf16 activations and matmul operands on the GPU; fp32
LayerNorm statistics, softmax, accumulation and outputs for metrics."""

from __future__ import annotations

import torch

PARAM_DTYPE = torch.float32
COMPUTE_DTYPE = torch.bfloat16
OUTPUT_DTYPE = torch.float32


def serving_dtype(device: torch.device) -> torch.dtype:
    """Compute dtype for inference on `device`: bf16 on CUDA (the
    kernels take bf16), fp32 on the CPU (the plain versions, as in the
    parity tests)."""
    return COMPUTE_DTYPE if device.type == "cuda" else torch.float32
