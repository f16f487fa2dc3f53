"""K3 + K4 — NHWC direct convolution (CUDA, ``csrc/conv.cu``).

Port of ``tpu_superresolution_tpu/ops/pallas/cab_conv.py``:
``conv3x3_halo`` (K3: SAME 3x3, pad 1) and ``conv_halo`` (K4: any
kh x kw with an asymmetric zero pad whose output keeps the input's
H x W).  Weights keep the JAX package's ``[kh, kw, Cin, Cout]`` layout.
One implicit-GEMM kernel serves both entry points; unlike the JAX
package it has no shape gate and takes every shape (any Cin/Cout, any
image size).  Training differentiates through ``ConvFunction``: forward
K3 or K4, backward torch autograd of the plain version (cuDNN's conv
backward), as the JAX package's K3/K4 backwards are XLA vjps
(``cab_conv.py:324-327``, ``:435-437``).
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
    (launches_conv3x3 if name == "conv3x3" else launches_conv_k).count += 1
    return y


class ConvFunction(torch.autograd.Function):
    """Forward K3 / K4, backward autograd of ``conv_plain``."""

    @staticmethod
    def forward(ctx, x, kernel, bias, pad, name):
        ctx.save_for_backward(x, kernel, bias)
        ctx.pad = pad
        return _launch(x, kernel, bias, pad, name)

    @staticmethod
    def backward(ctx, grad_out):
        x, kernel, bias = ctx.saved_tensors
        return _lib.plain_vjp(lambda x, k, b, pad, _name: conv_plain(x, k, b, pad),
                         (x, kernel, bias, ctx.pad, None), ctx.needs_input_grad, grad_out)


def _conv(x, kernel, bias, pad, name):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kernel, bias)):
        return ConvFunction.apply(x, kernel, bias, pad, name)
    return _launch(x, kernel, bias, pad, name)


def conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K3: SAME 3x3 conv.  CPU tensor -> plain version; CUDA tensor ->
    the kernel (bf16 x and kernel [3, 3, Cin, Cout], fp32 bias), through
    ``ConvFunction`` when a gradient is wanted."""
    if x.device.type == "cpu":
        return conv_plain(x, kernel, bias, ((1, 1), (1, 1)))
    if tuple(kernel.shape[:2]) != (3, 3):
        raise ValueError(f"conv3x3: kernel {tuple(kernel.shape)} is not 3x3")
    return _conv(x, kernel, bias, ((1, 1), (1, 1)), "conv3x3")


def conv_k(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
           pad: Pad) -> torch.Tensor:
    """K4: kh x kw conv with the asymmetric zero pad
    ((top, bottom), (left, right)), top + bottom == kh - 1.  CPU tensor
    -> plain version; CUDA tensor -> the kernel."""
    if x.device.type == "cpu":
        return conv_plain(x, kernel, bias, pad)
    return _conv(x, kernel, bias, pad, "conv_k")
