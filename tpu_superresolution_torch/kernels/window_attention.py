"""K15 and K16 — window attention on pre-split q, k, v (CUDA,
``csrc/batched_attn.cu``, whose attention core ``csrc/window_attn_core.cuh``
they share with K7).

Ports of ``tpu_superresolution_tpu/ops/pallas/window_attention.py``:
``fused_window_attention`` (K15, its ``pallas_call`` at :193) and
``batched_window_attention`` (K16, at :352), with the JAX package's
layout contract:

    q         [B*nW, nH, Nq, hd]
    k, v      [B*nW, nH, Nk, hd]
    bias      [nH, Nq, Nk] fp32
    mask      [nW, Nq, Nk] fp32 or None; window w takes mask[w % nW]
    out       [B*nW, nH, Nq, hd] = softmax(q k^T * scale + bias + mask) v

with fp32 scores and softmax and the output in q's dtype.  K16 is the
square case (Nq = Nk = N) that DAT's rect-window branches run (N = s0 *
s1: 128 at the default split, 256 at the published DAT x4's (8, 32));
their shift mask is additive -100 and the pad tokens of a padded map are
real keys.  K15 is the general case; HAT's OCAB runs it with the ws^2
queries of each window against the ows^2 keys of the overlapping window
around it (the zero rows of the gather at the border are real keys).
One CUDA kernel computes both, for any Nq, Nk and window count and hd <=
32; each wrapper counts its own launches.  The gradient is torch autograd
of the plain version, as the JAX custom_vjp differentiates
``window_attention_reference`` (``window_attention.py:297-309``); the JAX
package has no backward for K15 (its HAT trains the OCAB through K8).
"""

from __future__ import annotations

from typing import Optional

import torch

from tpu_superresolution_torch.kernels import _lib

HDP = 32  # the kernel pads heads to 32 dims
# Whether P enters P V as two bf16 parts (~16 significant bits) or
# rounded to bf16 once: K16 feeds DAT's training, whose smallest
# gradients moved with bf16 P; K15 (the OCAB's attention, as the JAX
# module path rounds it) takes the faster form, within the same bound
# (chip_smoke.py's kernels phase times both; PERF.md).
K16_SPLIT_P = True
K15_SPLIT_P = False

launches = _lib.LaunchCounter("K16 batched_window_attention")
launches_rect = _lib.LaunchCounter("K15 fused_window_attention")


def fused_window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                                 scale: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version of K15 and K16 (the JAX package's
    ``window_attention_reference``): fp32 scores, softmax and products,
    the output in q's dtype."""
    s = torch.einsum("whqd,whkd->whqk", q.float() * scale, k.float()) + bias.float()[None]
    if mask is not None:
        idx = torch.arange(q.shape[0], device=q.device) % mask.shape[0]
        s = s + mask.float()[idx][:, None]
    a = torch.softmax(s, dim=-1)
    return torch.einsum("whqk,whkd->whqd", a, v.float()).to(q.dtype)


# K16 computes the square case of the same function
batched_window_attention_plain = fused_window_attention_plain


def _launch(q, k, v, bias, mask, scale, counter, split_p) -> torch.Tensor:
    bw, nh, nq, hd = q.shape
    nk = k.shape[2]
    dev = q.device
    bf, f32 = torch.bfloat16, torch.float32
    _lib.check_tensor(q, "q", bf, dev, shape=(bw, nh, nq, hd), align=2)
    for name, t in (("k", k), ("v", v)):
        _lib.check_tensor(t, name, bf, dev, shape=(bw, nh, nk, hd), align=2)
    _lib.check_tensor(bias, "bias", f32, dev, shape=(nh, nq, nk), align=4)
    n_mask = 0
    if mask is not None:
        n_mask = int(mask.shape[0])
        _lib.check_tensor(mask, "mask", f32, dev, shape=(n_mask, nq, nk), align=4)
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        status = _lib.library().sr_batched_window_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), bw, nh, nq, nk, hd,
            n_mask, int(bool(split_p)), float(scale), _lib.stream_of(q))
    _lib.check_status(status, "sr_batched_window_attention_bf16")
    counter.count += 1
    return out


class BatchedWindowAttentionFunction(torch.autograd.Function):
    """Forward K15 or K16 (the launch counted on `counter`), backward
    autograd of ``fused_window_attention_plain`` (no gradient for the
    mask, a constant of the shapes)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, scale, counter, split_p):
        ctx.save_for_backward(q, k, v, bias)
        ctx.mask, ctx.scale = mask, scale
        return _launch(q, k, v, bias.float().contiguous(), mask, scale, counter, split_p)

    @staticmethod
    def backward(ctx, grad_out):
        fn = lambda q, k, v, bias: fused_window_attention_plain(q, k, v, bias, ctx.mask,
                                                                ctx.scale)
        return _lib.plain_vjp(fn, ctx.saved_tensors, ctx.needs_input_grad[:4],
                              grad_out) + (None, None, None, None)


def _attention(q, k, v, bias, mask, scale, counter, split_p, name) -> torch.Tensor:
    if q.device.type == "cpu":
        return fused_window_attention_plain(q, k, v, bias, mask, scale)
    _lib.require_cuda(q, name)
    if q.dim() != 4 or k.dim() != 4 or q.shape[-1] > HDP:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} are not [B*nW, nH, "
                         f"N, hd] with hd <= {HDP}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask = None if mask is None else mask.float().contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        return BatchedWindowAttentionFunction.apply(q, k, v, bias, mask, scale, counter,
                                                    split_p)
    return _launch(q, k, v, bias.float().contiguous(), mask, scale, counter, split_p)


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                           scale: float = 1.0) -> torch.Tensor:
    """K15: window attention of q [B*nW, nH, Nq, hd] against k, v [B*nW,
    nH, Nk, hd] with bias [nH, Nq, Nk] and an optional mask [nW, Nq, Nk]
    (window w takes mask[w % nW]): the plain version for CPU tensors, K15
    for CUDA tensors (bf16 q, k, v, hd <= 32), through
    ``BatchedWindowAttentionFunction`` when a gradient is wanted."""
    return _attention(q, k, v, bias, mask, scale, launches_rect, K15_SPLIT_P,
                      "fused_window_attention")


def batched_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                             scale: float = 1.0) -> torch.Tensor:
    """K16: ``fused_window_attention``'s square case, q, k, v [B*nW, nH,
    N, hd] with bias [nH, N, N] and an optional mask [nW, N, N] (DAT's
    rect-window branches), counted as K16."""
    return _attention(q, k, v, bias, mask, scale, launches, K16_SPLIT_P,
                      "batched_window_attention")
