"""K11 — depthwise 3x3 convolution (CUDA, ``csrc/dwconv.cu``).

Port of ``tpu_superresolution_tpu/ops/pallas/cab_conv.py::
dwconv3x3_halo`` (its ``pallas_call`` at :506): a depthwise SAME 3x3
convolution with zero padding plus bias on x [B, H, W, C], accumulated
in fp32, the output in x's dtype.  The kernel is [3, 3, C] (the JAX
package's [3, 3, 1, C] without its unit axis; a torch depthwise weight
[C, 1, 3, 3] is ``weight[:, 0].permute(1, 2, 0)``).  DAT runs it on the
module chain's conv branch (on v) and in SGFN's spatial gate.

The gradient is torch autograd of the plain version, as the JAX package
differentiates its reference (``cab_conv.py:516-528``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib

launches = _lib.LaunchCounter("K11 dwconv3x3")


def depthwise3x3(t: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise SAME 3x3 of t [B, H, W, C] (k [3, 3, C], bias [C]) in
    fp32 on t's values, returned in fp32."""
    y = F.conv2d(t.float().permute(0, 3, 1, 2), k.float().permute(2, 0, 1)[:, None],
                 b.float(), padding=1, groups=t.shape[-1])
    return y.permute(0, 2, 3, 1)


def dwconv3x3_plain(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K11: fp32 accumulation, x's dtype."""
    return depthwise3x3(x, k, b).to(x.dtype).contiguous()


def _launch(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    bsz, h, w, c = x.shape
    dev = x.device
    _lib.check_tensor(x, "x", torch.bfloat16, dev, ndim=4, align=2)
    _lib.check_tensor(k, "kernel", torch.float32, dev, shape=(9, c), align=4)
    _lib.check_tensor(b, "bias", torch.float32, dev, shape=(c,), align=4)
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        status = _lib.library().sr_dwconv3x3_bf16(
            x.data_ptr(), k.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, h, w, c,
            _lib.stream_of(x))
    _lib.check_status(status, "sr_dwconv3x3_bf16")
    launches.count += 1
    return out


class DWConv3x3Function(torch.autograd.Function):
    """Forward K11, backward autograd of ``dwconv3x3_plain``."""

    @staticmethod
    def forward(ctx, x, k, b):
        ctx.save_for_backward(x, k, b)
        return _launch(x, k.float().reshape(9, -1).contiguous(), b.float().contiguous())

    @staticmethod
    def backward(ctx, grad_out):
        return _lib.plain_vjp(dwconv3x3_plain, ctx.saved_tensors, ctx.needs_input_grad,
                              grad_out)


def dwconv3x3(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 + bias of x [B, H, W, C] with k [3, 3, C] and b [C]:
    the plain version for a CPU tensor, K11 for a CUDA tensor (bf16 x),
    through ``DWConv3x3Function`` when a gradient is wanted."""
    if x.device.type == "cpu":
        return dwconv3x3_plain(x, k, b)
    _lib.require_cuda(x, "dwconv3x3")
    if x.dim() != 4 or tuple(k.shape) != (3, 3, x.shape[-1]) or tuple(b.shape) != (x.shape[-1],):
        raise ValueError(f"dwconv3x3: x {tuple(x.shape)}, kernel {tuple(k.shape)}, bias "
                         f"{tuple(b.shape)} are not [B, H, W, C], [3, 3, C], [C]")
    x = x.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, k, b)):
        return DWConv3x3Function.apply(x, k, b)
    return _launch(x, k.float().reshape(9, -1).contiguous(), b.float().contiguous())
