"""K3 + K4 — NHWC direct convolution (CUDA, ``csrc/conv.cu``).

Port of ``tpu_superresolution_tpu/ops/pallas/cab_conv.py``:
``conv3x3_halo`` (K3: SAME 3x3, pad 1) and ``conv_halo`` (K4: any
kh x kw with an asymmetric zero pad whose output keeps the input's
H x W).  Weights keep the JAX package's ``[kh, kw, Cin, Cout]`` layout.
One implicit-GEMM kernel serves both entry points; unlike the JAX
package it has no shape gate and takes every shape (any Cin/Cout, any
image size).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib

Pad = Tuple[Tuple[int, int], Tuple[int, int]]

launches_conv3x3 = _lib.LaunchCounter("K3 conv3x3")
launches_conv_k = _lib.LaunchCounter("K4 conv_k")


def conv_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
               pad: Pad) -> torch.Tensor:
    """The plain PyTorch version: x [B, H, W, Cin], kernel [kh, kw, Cin,
    Cout], bias [Cout]; zero pad ((top, bottom), (left, right)); the
    conv runs in x's dtype, like the JAX package's XLA conv."""
    (pt, pb), (pl, pr) = pad
    xn = F.pad(x.permute(0, 3, 1, 2), (pl, pr, pt, pb))
    y = F.conv2d(xn, kernel.permute(3, 2, 0, 1).to(x.dtype))
    return (y.permute(0, 2, 3, 1) + bias.to(x.dtype)).contiguous()


def _launch(x, kernel, bias, pad: Pad, name: str) -> torch.Tensor:
    _lib.require_cuda(x, name)
    kh, kw = int(kernel.shape[0]), int(kernel.shape[1])
    (pt, pb), (pl, pr) = pad
    if pt + pb != kh - 1 or pl + pr != kw - 1 or min(pt, pb, pl, pr) < 0:
        raise ValueError(f"{name}: pad {pad} does not keep H x W for a {kh}x{kw} kernel")
    _lib.check_tensor(x, "x", torch.bfloat16, x.device, ndim=4, align=2)
    b, h, w, cin = x.shape
    cout = int(kernel.shape[3])
    _lib.check_tensor(kernel, "kernel", torch.bfloat16, x.device,
                      shape=(kh, kw, cin, cout), align=2)
    _lib.check_tensor(bias, "bias", torch.float32, x.device, shape=(cout,), align=4)
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    lib = _lib.library()
    with torch.cuda.device(x.device):
        if name == "conv3x3":
            status = lib.sr_conv3x3_bf16(
                x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), y.data_ptr(),
                b, h, w, cin, cout, _lib.stream_of(x),
            )
        else:
            status = lib.sr_conv_bf16(
                x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), y.data_ptr(),
                b, h, w, cin, cout, kh, kw, pt, pl, _lib.stream_of(x),
            )
    _lib.check_status(status, name)
    return y


def conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K3: SAME 3x3 conv.  CPU tensor -> plain version; CUDA tensor ->
    the kernel (bf16 x and kernel [3, 3, Cin, Cout], fp32 bias)."""
    if x.device.type == "cpu":
        return conv_plain(x, kernel, bias, ((1, 1), (1, 1)))
    if tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError(f"conv3x3: kernel {tuple(kernel.shape)} is not 3x3")
    y = _launch(x, kernel, bias, ((1, 1), (1, 1)), "conv3x3")
    launches_conv3x3.count += 1
    return y


def conv_k(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
           pad: Pad) -> torch.Tensor:
    """K4: kh x kw conv with the asymmetric zero pad
    ((top, bottom), (left, right)), top + bottom == kh - 1.  CPU tensor
    -> plain version; CUDA tensor -> the kernel."""
    if x.device.type == "cpu":
        return conv_plain(x, kernel, bias, pad)
    y = _launch(x, kernel, bias, pad, "conv_k")
    launches_conv_k.count += 1
    return y
