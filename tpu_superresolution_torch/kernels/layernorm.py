"""K2 — LayerNorm over the last axis (CUDA, ``csrc/layernorm.cu``).

Port of ``tpu_superresolution_tpu/ops/pallas/layernorm.py``
(``pallas_layernorm`` / ``layernorm_spatial``): fp32 statistics with the
fast-variance formula E[x^2] - E[x]^2 clamped at 0, eps 1e-5, output in
the input dtype.  Unlike ``layernorm_spatial``'s 4096-row threshold,
every CUDA tensor goes to the kernel, on ``layernorm_plan``'s schedule
(lanes a row, 4-channel chunks a lane, a persistent grid).  Training
differentiates through ``LayerNormFunction``: forward K2, backward torch
autograd of the plain version, as the JAX package's K2 backward is an
XLA vjp (``layernorm.py:99-105``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from tpu_superresolution_torch.kernels import _lib

EPS = 1e-5
# csrc/layernorm.cu: 4-channel chunks a lane at most (past them, C > 768,
# the wide kernel: a warp a row), lane groups a row, CTAs an SM
MAX_NPL = 6
GROUPS = (4, 8, 16, 32)
WARPS = 8  # a CTA's

launches = _lib.LaunchCounter("K2 layernorm")


def layernorm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float = EPS) -> torch.Tensor:
    """The plain PyTorch version (flax ``nn.LayerNorm`` fast variance,
    ``fused_block._ln``), not torch's two-pass ``layer_norm``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    mu2 = (xf * xf).mean(-1, keepdim=True)
    var = (mu2 - mu * mu).clamp_min(0.0)
    y = (xf - mu) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return y.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class LayerNormPlan:
    """How ``csrc/layernorm.cu`` runs `rows` rows of C channels: `group`
    lanes a row (a warp's band: 32 / group consecutive rows), `npl`
    4-channel chunks a lane (chunk l + group j of the row for the lane's
    place l in its group; 0: the wide kernel, a warp a row), on `grid`
    CTAs of WARPS warps, warp w of the grid taking bands w, w + W, ... of
    the grid's W warps."""

    group: int
    npl: int
    grid: int
    bands: int


@functools.lru_cache(maxsize=256)
def layernorm_plan(rows: int, c: int, sms: int) -> LayerNormPlan:
    """The schedule from static shapes: of the (group, npl) with group *
    npl * 4 >= C and npl <= MAX_NPL, the fewest idle chunk slots, then the
    fewest chunks a lane; four CTAs an SM at <= 3 chunks a lane (their
    registers allow it), else two."""
    chunks = -(-c // 4)
    best = None
    for group in GROUPS:
        npl = -(-chunks // group)
        if npl <= MAX_NPL:
            key = (group * npl - chunks, npl)
            best = min(best, (key, group, npl)) if best else (key, group, npl)
    if best is None:
        group, npl, per_warp = 32, 0, 1
    else:
        _, group, npl = best
        per_warp = 32 // group
    bands = -(-rows // per_warp)
    per_sm = 4 if 0 < npl <= 3 else 2
    grid = max(1, min(-(-bands // WARPS), sms * per_sm))
    return LayerNormPlan(group=group, npl=npl, grid=grid, bands=bands)


class LayerNormFunction(torch.autograd.Function):
    """Forward K2, backward autograd of ``layernorm_plain``."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps = eps
        return _launch(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, grad_out):
        x, weight, bias = ctx.saved_tensors
        return _lib.plain_vjp(layernorm_plain, (x, weight, bias, ctx.eps), ctx.needs_input_grad, grad_out)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = EPS) -> torch.Tensor:
    """LayerNorm of x [..., C]: the plain version for a CPU tensor, the
    kernel for a CUDA tensor (bf16 x, fp32 weight and bias), through
    ``LayerNormFunction`` when a gradient is wanted."""
    if x.device.type == "cpu":
        return layernorm_plain(x, weight, bias, eps)
    if _lib.exporting():
        return torch.ops.tpu_sr.layernorm(x, weight, bias, eps)
    _lib.require_cuda(x, "layernorm")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias)):
        return LayerNormFunction.apply(x, weight, bias, eps)
    return _launch(x, weight, bias, eps)


def _launch(x, weight, bias, eps):
    c = x.shape[-1]
    _lib.check_tensor(x, "x", torch.bfloat16, x.device, align=2)
    _lib.check_tensor(weight, "weight", torch.float32, x.device, shape=(c,), align=4)
    _lib.check_tensor(bias, "bias", torch.float32, x.device, shape=(c,), align=4)
    y = torch.empty_like(x)
    rows = x.numel() // c if c else 0
    p = layernorm_plan(rows, c, _lib.sm_count(x.device.index))
    status = _lib.call(x, _lib.library().sr_layernorm_bf16, x.data_ptr(), weight.data_ptr(),
                       bias.data_ptr(), y.data_ptr(), rows, c, p.group, p.npl, p.grid,
                       float(eps), _lib.stream_of(x))
    _lib.check_status(status, "sr_layernorm_bf16")
    launches.count += 1
    return y
