"""Data-parallel train and eval steps (port of
``tpu_superresolution_tpu/parallel/data_parallel.py``).

Each rank runs the whole step (augmentation on its device -> forward ->
backward) on its rows of the global batch; one SUM all-reduce of a flat
buffer then carries every gradient, the BatchNorm running statistics
and the step's metric sums, and every rank applies the same update to
the same state (clip, AdamW, EMA: ``train.engine.apply_gradients``), so
the replicas stay identical with no broadcast.  The semantics are the
JAX step's, not ``DistributedDataParallel``'s:

- the loss is the exact global weighted mean: each rank's share is
  sum(w * per_sample_loss) / w_total with w_total = psum(sum(w)), and
  the gradients are SUMmed (DDP averages over the world size, which is
  wrong once padding rows carry weight 0);
- the BatchNorm running statistics are averaged over the ranks (SUM,
  then a divide: ``ReduceOp.AVG`` is NCCL's alone), where DDP
  broadcasts rank 0's buffers; each rank normalises over its own rows,
  as inside ``shard_map`` (no ``SyncBatchNorm``);
- each rank's augmentation and stochastic-depth draws are its own, from
  a generator seeded by (a seed every rank draws from the shared
  generator, its rank): JAX's ``fold_in(key, axis_index)``.

The reduced values reach the parameters' gradients and the statistics
through ``copy_`` (``mesh.flat_copy_``), which moves their version
counters, so ``models.blocks.DerivedCache`` rebuilds what it derived from
them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from tpu_superresolution_torch.ops.metrics import batch_psnr
from tpu_superresolution_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum_,
    flat_copy_,
    rank_generator,
)
from tpu_superresolution_torch.train.engine import (
    TrainState,
    _to_device,
    apply_gradients,
    make_aug,
    make_eval_step,
)
from tpu_superresolution_torch.train.losses import get_loss_per_sample


def batch_norm_stats(model: nn.Module):
    """The running statistics of every BatchNorm in `model`, in module
    order (what the JAX package keeps in ``batch_stats``)."""
    out = []
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm) and m.track_running_stats:
            out += [m.running_mean, m.running_var]
    return out


def reduce_step_(state: TrainState, mesh: Mesh, metrics: torch.Tensor) -> torch.Tensor:
    """One SUM all-reduce of [every trainable gradient, every BatchNorm
    running statistic, `metrics`] as a flat fp32 buffer; the gradients
    take the sums, the statistics the means (a parameter with no
    gradient on this rank contributes zeros and gets the sum).  Returns
    the summed `metrics`."""
    params = state.params
    stats = batch_norm_stats(state.model)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    flat = torch.cat([t.detach().reshape(-1).float() for t in grads + stats]
                     + [metrics.float().reshape(-1)])
    all_reduce_sum_(flat, mesh)
    n_g = sum(g.numel() for g in grads)
    n_s = sum(s.numel() for s in stats)
    for p, g in zip(params, grads):
        if p.grad is None:
            p.grad = g
    flat_copy_(grads, flat[:n_g])
    flat_copy_(stats, flat[n_g:n_g + n_s], scale=1.0 / mesh.size)
    return flat[n_g + n_s:]


def make_dp_train_step(loss_name: str, convention: str, scale: int, patch: Optional[int],
                       do_flips: bool, mesh: Mesh, do_blur: bool = False,
                       norm: Optional[Tuple[float, float]] = None):
    """step(state, lr_raw, hr_raw, w, generator) -> metrics (device
    tensors, identical on every rank): the data-parallel counterpart of
    ``train.engine.make_train_step``.

    `lr_raw`, `hr_raw` and `w` are this rank's rows of the global batch
    (``mesh.shard_batch``); `w` weighs each sample (1 real, 0 padding:
    the Trainer pads a ragged batch to a multiple of the mesh by
    wrapping real samples), so loss, gradients and metrics are the exact
    global weighted means.  `generator` is the shared stream every rank
    advances alike."""
    per_sample_loss = get_loss_per_sample(loss_name)
    aug = make_aug(convention, scale, patch, do_flips, do_blur, norm)

    def step(state: TrainState, lr_raw, hr_raw, w,
             generator: Optional[torch.Generator] = None):
        model = state.model
        device = next(model.parameters()).device
        gen = rank_generator(generator, mesh.rank)
        lr, hr = aug(_to_device(lr_raw, device), _to_device(hr_raw, device), gen)
        w = _to_device(w, device).float()
        w_total = all_reduce_sum_(w.sum().reshape(1), mesh)[0]
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        out = model(lr, generator=gen).float()
        hr = hr.float()
        # this rank's share of the global weighted mean; the SUM of the
        # gradients below completes it
        loss_local = (w * per_sample_loss(out, hr)).sum() / w_total
        loss_local.backward()
        psnr_local = (w * batch_psnr(out.detach(), hr)).sum()
        loss, psnr_sum = reduce_step_(state, mesh, torch.stack([loss_local.detach(),
                                                                psnr_local]))
        gnorm = apply_gradients(state)
        return {
            "loss": loss,
            "grad_norm": gnorm,
            "psnr": psnr_sum / w_total,
            "finite": torch.isfinite(loss) & torch.isfinite(gnorm),
        }

    return step


def make_dp_eval_step(loss_name: str, convention: str, scale: Optional[int], mesh: Mesh,
                      norm: Optional[Tuple[float, float]] = None):
    """step(model, lr_raw, hr_raw) -> loss (the mean over the ranks of
    each rank's mean), psnr_sum, ssim_sum and n (sums over the ranks):
    ``train.engine.make_eval_step`` on this rank's rows, then one SUM
    all-reduce."""
    local = make_eval_step(loss_name, convention, scale, norm)

    def step(model: nn.Module, lr_raw, hr_raw):
        m = local(model, lr_raw, hr_raw)
        keys = ("loss", "psnr_sum", "ssim_sum", "n")
        flat = all_reduce_sum_(torch.stack([m[k].float() for k in keys]), mesh)
        out = dict(zip(keys, flat.unbind()))
        out["loss"] = out["loss"] / mesh.size
        return out

    return step
