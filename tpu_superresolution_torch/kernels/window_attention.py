"""K16 — batched window attention on pre-split q, k, v (CUDA,
``csrc/batched_attn.cu``, whose attention core ``csrc/window_attn_core.cuh``
it shares with K7).

Port of ``tpu_superresolution_tpu/ops/pallas/window_attention.py::
batched_window_attention`` (its ``pallas_call`` at :352), the JAX
package's layout contract:

    q, k, v   [B*nW, nH, N, hd]
    bias      [nH, N, N] fp32
    mask      [nW, N, N] fp32 or None; window w takes mask[w % nW]
    out       [B*nW, nH, N, hd] = softmax(q k^T * scale + bias + mask) v

with fp32 scores and softmax and the output in q's dtype.  DAT's
rect-window branches run it (N = s0 * s1: 128 at the default split, 256
at the published DAT x4's (8, 32)); their shift mask is additive -100 and
the pad tokens of a padded map are real keys.  The kernel takes any N and
window count and hd <= 32.  The gradient is torch autograd of the plain
version, as the JAX custom_vjp differentiates
``window_attention_reference`` (``window_attention.py:297-309``).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_superresolution_torch.kernels import _lib

HDP = 32  # the kernel pads heads to 32 dims

launches = _lib.LaunchCounter("K16 batched_window_attention")


def batched_window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                                   scale: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version of K16 (the JAX package's
    ``window_attention_reference``): fp32 scores, softmax and products,
    the output in q's dtype."""
    s = torch.einsum("whqd,whkd->whqk", q.float() * scale, k.float()) + bias.float()[None]
    if mask is not None:
        idx = torch.arange(q.shape[0], device=q.device) % mask.shape[0]
        s = s + mask.float()[idx][:, None]
    a = torch.softmax(s, dim=-1)
    return torch.einsum("whqk,whkd->whqd", a, v.float()).to(q.dtype)


def _launch(q, k, v, bias, mask, scale) -> torch.Tensor:
    bw, nh, n, hd = q.shape
    dev = q.device
    bf, f32 = torch.bfloat16, torch.float32
    for name, t in (("q", q), ("k", k), ("v", v)):
        _lib.check_tensor(t, name, bf, dev, shape=(bw, nh, n, hd), align=2)
    _lib.check_tensor(bias, "bias", f32, dev, shape=(nh, n, n), align=4)
    n_mask = 0
    if mask is not None:
        n_mask = int(mask.shape[0])
        _lib.check_tensor(mask, "mask", f32, dev, shape=(n_mask, n, n), align=4)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        status = _lib.library().sr_batched_window_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), bw, nh, n, hd, n_mask,
            float(scale), _lib.stream_of(q))
    _lib.check_status(status, "sr_batched_window_attention_bf16")
    launches.count += 1
    return out


class BatchedWindowAttentionFunction(torch.autograd.Function):
    """Forward K16, backward autograd of ``batched_window_attention_plain``
    (no gradient for the mask, a constant of the shapes)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.mask, ctx.scale = mask, scale
        return _launch(q, k, v, bias.float().contiguous(), mask, scale)

    @staticmethod
    def backward(ctx, grad_out):
        fn = lambda q, k, v, bias: batched_window_attention_plain(q, k, v, bias, ctx.mask,
                                                                  ctx.scale)
        return _lib.plain_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:4],
                              grad_out) + (None, None)


def batched_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                             scale: float = 1.0) -> torch.Tensor:
    """Window attention on q, k, v [B*nW, nH, N, hd] with bias [nH, N, N]
    and an optional mask [nW, N, N] (window w takes mask[w % nW]): the
    plain version for CPU tensors, K16 for CUDA tensors (bf16 q, k, v,
    hd <= 32), through ``BatchedWindowAttentionFunction`` when a gradient
    is wanted."""
    if q.device.type == "cpu":
        return batched_window_attention_plain(q, k, v, bias, mask, scale)
    _lib.require_cuda(q, "batched_window_attention")
    if q.dim() != 4 or q.shape[-1] > HDP:
        raise ValueError(f"batched_window_attention: q {tuple(q.shape)} is not [B*nW, nH, N, "
                         f"hd] with hd <= {HDP}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = None if mask is None else mask.float().contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        return BatchedWindowAttentionFunction.apply(q, k, v, bias, mask, scale)
    return _launch(q, k, v, bias.float().contiguous(), mask, scale)
