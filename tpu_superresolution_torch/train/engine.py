"""The training engine (port of ``tpu_superresolution_tpu/train/engine.py``):
optimizer, train and eval steps, and ``Trainer.fit``.

- The train step: paired augmentation on the device, in the model's
  convention (pre-upscale for the CNN families MS_ResUNet and UNet2D:
  upscale -> crop -> flips -> blur; native-LR for the transformers
  SwinIR, HAT, hat_fast and DAT: crop -> flips -> blur), then the
  dataset normalization of both members -> forward (bf16 compute on
  CUDA with fp32 parameters and no loss scaling; fp32 on the CPU) ->
  fp32 loss -> backward -> clip by global norm -> AdamW with the
  schedule -> EMA -> metrics.  On CUDA the transformers' forwards run
  the kernels (``kernels/``): each Swin block or HAB is K1 (ws 8) or K6
  (ws 7) with its backward K5 or K6b, each HAT OCAB core K8 with
  backward K8b, each DAT block its module chain (K2, K11, K16); the
  K2-K4, K11 and K16 backwards are torch autograd of their plain
  versions, as the JAX package leaves those backwards to XLA or to a
  vjp of its reference.  The CNNs are cuDNN convs (the JAX package
  leaves them to XLA).  BatchNorm (DAT, the CNNs) normalizes with the
  batch statistics in train mode and updates its running statistics in
  place, on flax's rules, in fp32.
- Loss and metrics are in the normalized space when the data is
  normalized, as in the JAX package.
- The host reads one scalar per epoch (the mean train loss), not one per
  step: each step's metrics stay on the device until the epoch ends.
- Clipping is ``optax.clip_by_global_norm``'s: g * max / norm when norm
  >= max, with no epsilon in the denominator.  ``torch.optim.AdamW``
  applies the decoupled weight decay as ``optax.adamw`` does.
- Frozen parameters (``train/freeze.py``) have no gradient, so the
  reported grad norm covers the trainable ones (the JAX package reports
  the norm over all of them; the updates are the same).

With `dp_shards` > 1 (-1: every rank) ``Trainer.fit`` runs the
data-parallel steps of ``parallel/`` over a process group of that many
ranks (``torchrun``, one rank a device), as the JAX package runs its
shard_map steps over a device mesh.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from tpu_superresolution_torch.core.config import DataConfig, ModelConfig, TrainConfig
from tpu_superresolution_torch.data import native_decode
from tpu_superresolution_torch.data.transforms import (
    make_train_batch_native,
    make_train_batch_preupscale,
    normalize,
    pre_upscale_batch,
)
from tpu_superresolution_torch.ops.metrics import batch_psnr, ssim
from tpu_superresolution_torch.train.freeze import apply_freeze
from tpu_superresolution_torch.train.losses import get_loss
from tpu_superresolution_torch.train.schedules import build_schedule


@dataclass
class TrainState:
    """The model and its optimizer state; `step` counts applied updates.
    `ema` ({parameter name: tensor}, None = off) is the exponential
    moving average of the parameters that validation and the best
    checkpoints use; buffers (DAT's BatchNorm statistics) are not
    averaged: the EMA parameters run with the live buffers, as the JAX
    package evaluates its EMA params with the live ``batch_stats``."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    grad_clip_norm: float = 1.0
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None
    ema_decay: float = 0.0

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]


def build_optimizer(tcfg: TrainConfig, steps_per_epoch: int, model: nn.Module):
    """(AdamW over the trainable parameters, schedule).  With
    finetune + freeze_regex the matching parameters are frozen first."""
    lr = tcfg.ft_lr if (tcfg.finetune and tcfg.ft_lr is not None) else tcfg.lr
    schedule = build_schedule(tcfg.scheduler, lr, tcfg.epochs, steps_per_epoch, tcfg.min_lr)
    if tcfg.finetune and tcfg.freeze_regex:
        apply_freeze(model, tcfg.freeze_regex)
    params = [p for p in model.parameters() if p.requires_grad]
    # on CUDA the fused implementation: one launch per step, not one per
    # tensor and operation (the step is host-bound, PERF.md)
    fused = bool(params) and all(p.is_cuda for p in params)
    opt = torch.optim.AdamW(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=tcfg.weight_decay, fused=fused or None)
    return opt, schedule


def create_train_state(model: nn.Module, optimizer, schedule, grad_clip_norm: float = 1.0,
                       ema_decay: Optional[float] = None) -> TrainState:
    ema = None
    if ema_decay:
        ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return TrainState(model=model, optimizer=optimizer, schedule=schedule,
                      grad_clip_norm=grad_clip_norm, ema=ema, ema_decay=float(ema_decay or 0.0))


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all elements, on the device (one
    multi-tensor norm launch, not one per tensor)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)).float())


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale `grads` in place to global norm <= max_norm
    (``optax.clip_by_global_norm``); returns the norm before clipping."""
    norm = global_norm(grads)
    if max_norm:
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        torch._foreach_mul_(grads, scale)
    return norm


def apply_gradients(state: TrainState) -> torch.Tensor:
    """Clip, step AdamW at the schedule's rate, update the EMA; returns
    the grad norm before clipping."""
    params = [p for p in state.params if p.grad is not None]
    gnorm = clip_by_global_norm_([p.grad for p in params], state.grad_clip_norm)
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    # the fused AdamW (CUDA) writes the parameters without moving their
    # version counters, which DerivedCache keys the kernels' packed
    # weights on: move them, or a no-grad forward after the step (the
    # validation) would run the weights packed before it
    for p in params:
        torch.autograd.graph.increment_version(p)
    state.step += 1
    if state.ema is not None:
        live = dict(state.model.named_parameters())
        keys = list(state.ema)
        torch._foreach_lerp_([state.ema[k] for k in keys], [live[k].detach() for k in keys],
                             1.0 - state.ema_decay)
    return gnorm


def _to_device(a, device) -> torch.Tensor:
    """Host batch -> device; to CUDA through pinned memory, so the host
    does not wait for the device's queue to drain."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def make_aug(convention: str, scale: int, patch: Optional[int], do_flips: bool,
             do_blur: bool = False, norm: Optional[Tuple[float, float]] = None):
    """aug(lr, hr, generator) -> (lr, hr): the train batch's augmentation
    on the device in the JAX package's order (``engine.make_aug``).
    `patch` None takes the batch as given (already cropped): pre-upscale
    then only upscales, native-LR does nothing; `norm` is (mean, std)."""
    if convention not in ("pre_upscale", "native_lr"):
        raise ValueError(f"convention must be 'pre_upscale' or 'native_lr', got {convention!r}")

    def aug(lr, hr, generator):
        if convention == "pre_upscale":
            if patch is not None:
                lr, hr = make_train_batch_preupscale(lr, hr, scale, patch, do_flips, generator,
                                                     do_blur)
            else:
                lr = pre_upscale_batch(lr, scale)
        elif patch is not None:
            lr, hr = make_train_batch_native(lr, hr, scale, patch, do_flips, generator, do_blur)
        if norm is not None:
            lr, hr = normalize(lr, *norm), normalize(hr, *norm)
        return lr, hr

    return aug


def make_train_step(loss_name: str, convention: str, scale: int, patch: Optional[int],
                    do_flips: bool, do_blur: bool = False,
                    norm: Optional[Tuple[float, float]] = None):
    """step(state, lr_raw, hr_raw, generator) -> metrics (device tensors).

    `generator` draws the crop offsets, flips, the blur and the
    stochastic-depth masks.  `patch` None trains on the batch as given
    (already cropped)."""
    loss_fn = get_loss(loss_name)
    aug = make_aug(convention, scale, patch, do_flips, do_blur, norm)

    def step(state: TrainState, lr_raw, hr_raw, generator: Optional[torch.Generator] = None):
        model = state.model
        device = next(model.parameters()).device
        lr, hr = aug(_to_device(lr_raw, device), _to_device(hr_raw, device), generator)
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        out = model(lr, generator=generator).float()
        hr = hr.float()
        loss = loss_fn(out, hr)
        loss.backward()
        gnorm = apply_gradients(state)
        loss = loss.detach()
        return {
            "loss": loss,
            "grad_norm": gnorm,
            "psnr": batch_psnr(out.detach(), hr).mean(),
            "finite": torch.isfinite(loss) & torch.isfinite(gnorm),
        }

    return step


def make_eval_step(loss_name: str, convention: str, scale: Optional[int] = None,
                   norm: Optional[Tuple[float, float]] = None):
    """step(model, lr_raw, hr_raw) -> loss, psnr_sum, ssim_sum, n
    (device tensors): the whole image (pre-upscaled by `scale` in that
    convention), inputs scrubbed of NaN / Inf (reference train.py:
    157-158), normalized by `norm`, eval mode, no gradient."""
    if convention not in ("pre_upscale", "native_lr"):
        raise ValueError(f"convention must be 'pre_upscale' or 'native_lr', got {convention!r}")
    if convention == "pre_upscale" and not scale:
        raise ValueError("the pre_upscale convention needs the scale")
    loss_fn = get_loss(loss_name)

    @torch.no_grad()
    def step(model: nn.Module, lr_raw, hr_raw):
        device = next(model.parameters()).device
        lr = _to_device(lr_raw, device).float()
        if convention == "pre_upscale":
            lr = pre_upscale_batch(lr, scale)
        scrub = lambda t: torch.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0)
        lr, hr = scrub(lr), scrub(_to_device(hr_raw, device).float())
        if norm is not None:
            lr, hr = normalize(lr, *norm), normalize(hr, *norm)
        model.eval()
        out = model(lr).float()
        n = lr.shape[0]
        return {
            "loss": loss_fn(out, hr),
            "psnr_sum": batch_psnr(out, hr).sum(),
            "ssim_sum": ssim(out.clamp(0.0, 1.0), hr.clamp(0.0, 1.0)) * n,
            "n": torch.tensor(float(n), device=device),
        }

    return step


@dataclass
class Trainer:
    """Epochs, validation every `val_every` epochs (always the last), the
    dual bests by val loss and by val PSNR (finetune_swinir.py:344-371),
    early stopping, the run report and the loss curve (train.py:403-419).
    ``history["native_decodes"]`` counts each epoch's native-decoder
    batch calls during its training loop (0 once the decoded-image cache
    serves the epoch).  With `trace_path`, a chrome-trace timeline
    (``utils.trace.TraceRecorder``) is written there at the end: each
    epoch's span ``epoch {n}`` on the "train" track and ``val {n}`` on
    the "val" track, and the ``train_loss`` and ``val_psnr`` counters,
    the JAX package's events.  A span closes once the host has read the
    value it reports (the epoch's mean loss, the validation sums), as
    the fit loop already does, so the trace adds no synchronisation."""

    model_config: ModelConfig
    data_config: DataConfig
    train_config: TrainConfig
    workdir: str = "."
    log: Callable[[str], None] = print
    trace_path: Optional[str] = None

    history: Dict[str, list] = field(
        default_factory=lambda: {"train": [], "val": [], "native_decodes": []})
    best_val_loss: float = math.inf
    best_val_psnr: float = -math.inf
    _no_improve: int = 0

    def fit(self, state: TrainState, train_loader, valid_loader,
            generator: Optional[torch.Generator] = None) -> TrainState:
        from tpu_superresolution_torch.train.checkpoint import save_checkpoint

        tcfg, dcfg = self.train_config, self.data_config
        os.makedirs(self.workdir, exist_ok=True)
        if generator is None:
            generator = torch.Generator().manual_seed(tcfg.seed)
        patch = dcfg.patch_size if dcfg.convention == "pre_upscale" else dcfg.lr_patch
        norm = (dcfg.norm_mean, dcfg.norm_std) if dcfg.normalizes else None
        eval_step = make_eval_step(tcfg.loss, dcfg.convention, dcfg.scale_int, norm)

        # Data parallelism: dp_shards > 1 runs the data-parallel steps
        # over a mesh of that many ranks (-1: every rank); each rank
        # takes its rows of the same global batch.
        dp = tcfg.dp_shards
        if dp == -1:
            from tpu_superresolution_torch.parallel.mesh import launched_world_size

            dp = launched_world_size()
        dp = dp if dp and dp > 1 else 0
        mesh = None
        writer = True
        if dp:
            from tpu_superresolution_torch.parallel import (
                make_dp_eval_step,
                make_dp_train_step,
                make_mesh,
                replicate,
                shard_batch,
            )
            from tpu_superresolution_torch.parallel.mesh import is_writer

            mesh = make_mesh(dp, next(state.model.parameters()).device)
            writer = is_writer()
            replicate(state, mesh)
            dp_train = make_dp_train_step(tcfg.loss, dcfg.convention, dcfg.scale_int, patch,
                                          dcfg.do_flips, mesh, dcfg.do_blur, norm)
            dp_eval = make_dp_eval_step(tcfg.loss, dcfg.convention, dcfg.scale_int, mesh, norm)
            single_eval = eval_step

            def train_step(st, lr_np, hr_np, gen):
                # a ragged batch is padded to a multiple of dp by wrapping
                # real samples, the pads weighted 0: no sample is dropped
                n = lr_np.shape[0]
                w = np.ones((n + (-n) % dp,), np.float32)
                if len(w) > n:
                    idx = np.arange(len(w)) % n
                    lr_np, hr_np = np.asarray(lr_np)[idx], np.asarray(hr_np)[idx]
                    w[n:] = 0.0
                return dp_train(st, *shard_batch((lr_np, hr_np, w), mesh), gen)

            def eval_step(model, lr_np, hr_np):
                # a ragged val batch runs whole on every rank, no collective
                if lr_np.shape[0] % dp:
                    return single_eval(model, lr_np, hr_np)
                return dp_eval(model, *shard_batch((lr_np, hr_np), mesh))
        else:
            train_step = make_train_step(tcfg.loss, dcfg.convention, dcfg.scale_int, patch,
                                         dcfg.do_flips, dcfg.do_blur, norm)
        # rank 0 alone logs and writes checkpoints, the report, the loss
        # curve and the trace; the others wait at the barrier at the end
        log = self.log if writer else (lambda msg: None)
        if dp:
            log(f"[dp] data-parallel over {dp} devices ({mesh.backend}: one all-reduce of "
                "the gradients a step)")
        eval_model = state.model
        if state.ema is not None:
            eval_model = _model_copy(state.model)

        rec = None
        if self.trace_path and writer:
            from tpu_superresolution_torch.utils.trace import TraceRecorder

            rec = TraceRecorder()

        t_start = time.time()
        for epoch in range(1, tcfg.epochs + 1):
            ep_t0 = rec.elapsed_s if rec else 0.0
            t_ep = time.time()
            losses = []
            data_t = step_t = 0.0
            decodes0 = native_decode.decodes.count
            end = time.time()
            for lr_np, hr_np in train_loader:
                data_t += time.time() - end
                t0 = time.time()
                losses.append(train_step(state, lr_np, hr_np, generator)["loss"])
                step_t += time.time() - t0
                if tcfg.time_log_every and len(losses) % tcfg.time_log_every == 0:
                    k = len(losses)
                    log(f"[{dcfg.scale}][time] batch {k}: data {data_t / k:.3f}s/b "
                        f"step {step_t / k:.3f}s/b")
                end = time.time()
            self.history["native_decodes"].append(native_decode.decodes.count - decodes0)
            n_steps = max(1, len(losses))
            tr_loss = float(torch.stack(losses).mean()) if losses else 0.0
            if not math.isfinite(tr_loss):
                raise RuntimeError("Model produced NaN/Inf loss — lower max_lr / check init")
            t_tr = time.time() - t_ep
            if rec:
                rec.complete(f"epoch {epoch}", ep_t0, t_tr, track="train", loss=tr_loss,
                             data_s_per_batch=data_t / n_steps, step_s_per_batch=step_t / n_steps)
                rec.counter("train_loss", tr_loss)
            self.history["train"].append(tr_loss)

            if not (tcfg.val_every <= 1 or epoch % tcfg.val_every == 0 or epoch == tcfg.epochs):
                self.history["val"].append(None)
                log(f"[{dcfg.scale}] epoch {epoch}: train_loss {tr_loss:.7f} | "
                    f"(data {data_t / n_steps:.3f}/batch {step_t / n_steps:.3f}) | "
                    f"time: train {t_tr:.1f}s (val skipped)")
                continue
            t_val0 = time.time()
            if state.ema is not None:
                eval_model.load_state_dict(ema_state_dict(state))
            agg, n_batches = None, 0
            for lr_np, hr_np in valid_loader:
                m = eval_step(eval_model, lr_np, hr_np)
                agg = m if agg is None else {k: agg[k] + m[k] for k in agg}
                n_batches += 1
            agg = {k: float(v) for k, v in agg.items()} if agg else {
                "loss": 0.0, "psnr_sum": 0.0, "ssim_sum": 0.0, "n": 0.0}
            val_loss = agg["loss"] / max(1, n_batches)
            val_psnr = agg["psnr_sum"] / max(1.0, agg["n"])
            val_ssim = agg["ssim_sum"] / max(1.0, agg["n"])
            t_val = time.time() - t_val0
            if rec:
                rec.complete(f"val {epoch}", rec.elapsed_s - t_val, t_val, track="val",
                             loss=val_loss, psnr=val_psnr, ssim=val_ssim)
                rec.counter("val_psnr", val_psnr)
            self.history["val"].append(val_loss)
            log(f"[{dcfg.scale}] epoch {epoch}: train_loss {tr_loss:.7f}, "
                f"val_loss {val_loss:.7f} | val_PSNR {val_psnr:.2f} dB, "
                f"val_SSIM {val_ssim:.4f} | (data {data_t / n_steps:.3f}/batch "
                f"{step_t / n_steps:.3f}) | time: train {t_tr:.1f}s, val {t_val:.1f}s")
            elapsed = time.time() - t_start
            log(f"[{dcfg.scale}][time] elapsed={elapsed:.0f}s "
                f"ETA~{elapsed / epoch * (tcfg.epochs - epoch):.0f}s")

            improved = val_loss < self.best_val_loss
            if improved:
                self.best_val_loss = val_loss
            if improved and writer:
                save_checkpoint(f"{self.workdir}/best_{dcfg.scale}.pth", state, self.model_config,
                                extra={"epoch": epoch, "best_val_loss": val_loss,
                                       "val_psnr": val_psnr})
                log(f"[ckpt] saved best_{dcfg.scale} (val_loss {val_loss:.7f})")
            if val_psnr > self.best_val_psnr:
                self.best_val_psnr = val_psnr
                if writer:
                    save_checkpoint(f"{self.workdir}/bestpsnr_{dcfg.scale}.pth", state,
                                    self.model_config,
                                    extra={"epoch": epoch, "best_val_psnr": val_psnr,
                                           "val_loss": val_loss})
            self._no_improve = 0 if improved else self._no_improve + 1
            if tcfg.early_stop_patience and self._no_improve >= tcfg.early_stop_patience:
                log(f"[early_stop] no val-loss improvement for {self._no_improve} epochs "
                    f"(patience {tcfg.early_stop_patience}) — stopping at epoch {epoch}")
                break

        if writer:
            self.save_loss_curve(f"{self.workdir}/loss_curve_{dcfg.scale}.png")
            self.save_run_report(f"{self.workdir}/run_{dcfg.scale}.json")
        if rec:
            rec.save(self.trace_path)
            log(f"[trace] saved chrome-trace timeline to {self.trace_path}")
        if mesh is not None:
            torch.distributed.barrier(group=mesh.group)
        return state

    def save_run_report(self, path: str) -> None:
        """Configs, per-epoch history and bests as JSON."""
        report = {
            "model_config": self.model_config.to_dict(),
            "data_config": dataclasses.asdict(self.data_config),
            "train_config": dataclasses.asdict(self.train_config),
            "history": self.history,
            "best_val_loss": self.best_val_loss,
            "best_val_psnr": self.best_val_psnr,
        }
        with open(path, "w") as f:
            json.dump(report, f, indent=1, default=str)
        self.log(f"[report] saved run report to {path}")

    def save_loss_curve(self, path: str) -> None:
        """Loss-curve PNG, when matplotlib is installed."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        epochs = list(range(1, len(self.history["train"]) + 1))
        plt.figure(figsize=(8, 5))
        plt.plot(epochs, self.history["train"], label="train loss")
        vpts = [(e, v) for e, v in zip(epochs, self.history["val"]) if v is not None]
        if vpts:
            plt.plot(*zip(*vpts), label="val loss")
        plt.xlabel("Epoch")
        plt.ylabel("Loss")
        plt.title(f"Train vs Val loss ({self.data_config.scale})")
        plt.grid(True)
        plt.legend()
        plt.tight_layout()
        plt.savefig(path, dpi=150)
        plt.close()
        self.log(f"[plot] saved loss curves to {path}")


def ema_state_dict(state: TrainState) -> Dict[str, torch.Tensor]:
    """The model's state dict with the EMA parameters in place of the
    live ones and the live buffers."""
    return dict(state.model.state_dict(), **state.ema)


def _model_copy(model: nn.Module) -> nn.Module:
    """A second instance of `model` (same config, dtype, impl, device)
    to run the EMA weights in."""
    from tpu_superresolution_torch.core.config import build_model

    copy = build_model(model.config, dtype=model.dtype, impl=model.impl,
                       device=next(model.parameters()).device)
    copy.load_state_dict(model.state_dict())
    return copy.eval()
