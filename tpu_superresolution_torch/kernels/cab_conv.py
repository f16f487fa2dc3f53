"""K3 + K4 — NHWC direct convolution (CUDA, ``csrc/conv.cu``); K12 —
HAT's CAB front, LayerNorm -> conv3x3 -> exact GELU -> conv3x3 in one
pass (CUDA, ``csrc/cab_fused.cu``).

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

K12 ports ``fused_ln_cab_convs`` (``cab_conv.py:531``, ``pl.pallas_call``
at ``:209``): y = conv3x3(gelu_erf(conv3x3(LN(x)))) with SAME zero
padding of the LN output and of conv2's input; the SE gate stays
outside.  The JAX package keeps it off by default (``ENABLE = False``, a
TPU VMEM switch); the port runs it for every HAB's CAB on CUDA.  Its
gradient is ``CabConvsFunction``: forward K12, backward torch autograd
of ``fused_ln_cab_convs_plain``, as the JAX custom_vjp differentiates
``_reference`` (``cab_conv.py:548-550``).  The kernel takes C <= 256 and
Cmid <= 128; the JAX package's erf is an A&S polynomial, the port's
torch's erf.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tpu_superresolution_torch.kernels import _lib
from tpu_superresolution_torch.kernels.layernorm import EPS, layernorm_plain

Pad = Tuple[Tuple[int, int], Tuple[int, int]]

launches_conv3x3 = _lib.LaunchCounter("K3 conv3x3")
launches_conv_k = _lib.LaunchCounter("K4 conv_k")
launches_ln_cab = _lib.LaunchCounter("K12 ln_cab_convs")

# Limits of csrc/cab_fused.cu.
CAB_MAX_C = 256
CAB_MAX_MID = 128


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


# ----------------------------------------------------------------- K12


def fused_ln_cab_convs_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                             k1: torch.Tensor, c1: torch.Tensor, k2: torch.Tensor,
                             c2: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K12 (``cab_conv._reference``): x
    [B, H, W, C], LN params g, b [C], k1 [3, 3, C, Cmid], k2 [3, 3, Cmid,
    C] with biases c1, c2; LN output and the convs in x's dtype (each
    conv adds its bias before rounding), the GELU in fp32."""
    dt = x.dtype

    def conv(t, k, c):
        y = F.conv2d(t.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).to(dt), c.to(dt), padding=1)
        return y.permute(0, 2, 3, 1)

    y = conv(layernorm_plain(x, g, b, EPS), k1, c1)
    y = F.gelu(y.float()).to(dt)
    return conv(y, k2, c2).contiguous()


def check_cab_limits(c: int, cmid: int, name: str = "fused_ln_cab_convs") -> None:
    if c > CAB_MAX_C or cmid > CAB_MAX_MID:
        raise ValueError(f"{name}: K12 takes C <= {CAB_MAX_C} and Cmid <= {CAB_MAX_MID}; got "
                         f"C={c}, Cmid={cmid}")


@dataclasses.dataclass(frozen=True)
class PackedCab:
    """K12's operands: tap-major bf16 conv weights [9 * CK, CMP] and [9 *
    CMP, CK] (channels zero-padded to multiples of 16), fp32 biases
    padded alike, fp32 LN params."""

    k1: torch.Tensor
    c1: torch.Tensor
    k2: torch.Tensor
    c2: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    dim: int
    mid: int


@torch.no_grad()
def pack_cab(g, b, k1, c1, k2, c2) -> PackedCab:
    c, cm = int(k1.shape[2]), int(k1.shape[3])
    check_cab_limits(c, cm)
    ck, cmp = -(-c // 16) * 16, -(-cm // 16) * 16
    bf = torch.bfloat16
    return PackedCab(
        k1=F.pad(k1.float(), (0, cmp - cm, 0, ck - c)).reshape(9 * ck, cmp).to(bf).contiguous(),
        c1=F.pad(c1.float(), (0, cmp - cm)).contiguous(),
        k2=F.pad(k2.float(), (0, ck - c, 0, cmp - cm)).reshape(9 * cmp, ck).to(bf).contiguous(),
        c2=F.pad(c2.float(), (0, ck - c)).contiguous(),
        g=g.float().contiguous(), b=b.float().contiguous(), dim=c, mid=cm)


def _launch_cab(x: torch.Tensor, p: PackedCab) -> torch.Tensor:
    _lib.check_tensor(x, "x", torch.bfloat16, x.device, ndim=4, align=2)
    bsz, h, w, c = x.shape
    if c != p.dim:
        raise ValueError(f"fused_ln_cab_convs: weights for C={p.dim}, x has C={c}")
    ck, cmp = -(-c // 16) * 16, -(-p.mid // 16) * 16
    bf, f32 = torch.bfloat16, torch.float32
    for name, t, shape, dtype, align in (
            ("k1", p.k1, (9 * ck, cmp), bf, 32), ("c1", p.c1, (cmp,), f32, 4),
            ("k2", p.k2, (9 * cmp, ck), bf, 32), ("c2", p.c2, (ck,), f32, 4),
            ("g", p.g, (c,), f32, 4), ("b", p.b, (c,), f32, 4)):
        _lib.check_tensor(t, name, dtype, x.device, shape=shape, align=align)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = _lib.library().sr_ln_cab_convs_bf16(
            x.data_ptr(), p.g.data_ptr(), p.b.data_ptr(), p.k1.data_ptr(), p.c1.data_ptr(),
            p.k2.data_ptr(), p.c2.data_ptr(), y.data_ptr(), bsz, h, w, c, p.mid, EPS,
            _lib.stream_of(x))
    _lib.check_status(status, "sr_ln_cab_convs_bf16")
    launches_ln_cab.count += 1
    return y


class CabConvsFunction(torch.autograd.Function):
    """Forward K12 (weights packed on every call), backward autograd of
    ``fused_ln_cab_convs_plain``."""

    @staticmethod
    def forward(ctx, x, g, b, k1, c1, k2, c2):
        ctx.save_for_backward(x, g, b, k1, c1, k2, c2)
        return _launch_cab(x, pack_cab(g, b, k1, c1, k2, c2))

    @staticmethod
    def backward(ctx, grad_out):
        return _lib.plain_vjp(fused_ln_cab_convs_plain, ctx.saved_tensors, ctx.needs_input_grad,
                              grad_out)


def fused_ln_cab_convs(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, k1: torch.Tensor,
                       c1: torch.Tensor, k2: torch.Tensor, c2: torch.Tensor,
                       packed: Optional[PackedCab] = None) -> torch.Tensor:
    """K12: conv3x3(gelu_erf(conv3x3(LN(x)))) on NHWC x, weights in the
    JAX package's [3, 3, Cin, Cout] layout.  CPU tensor -> plain version;
    CUDA tensor -> the kernel (bf16 x), through ``CabConvsFunction`` when
    a gradient is wanted.  `packed` (inference only) skips the
    per-call packing."""
    if x.device.type == "cpu":
        return fused_ln_cab_convs_plain(x, g, b, k1, c1, k2, c2)
    _lib.require_cuda(x, "fused_ln_cab_convs")
    check_cab_limits(int(k1.shape[2]), int(k1.shape[3]))
    x = x.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, g, b, k1, c1, k2, c2)):
        return CabConvsFunction.apply(x, g, b, k1, c1, k2, c2)
    if packed is None:
        packed = pack_cab(g, b, k1, c1, k2, c2)
    return _launch_cab(x, packed)
