"""SwinIR fine-tuning on the GPU (port of
``tpu_superresolution_tpu/cli/finetune.py``; reference
finetune_swinir.py:213-374):

    python -m tpu_superresolution_torch.cli.finetune \\
        --data_root /path/DeepRockSR-2D --scale X4 \\
        --weights 001_classicalSR_DIV2K_s48w8_SwinIR-M_x4.pth

Builds SwinIR-M (window 8, depths [6]x6, embed 180, the reference's
config) or the architecture inferred from a ``.pth`` checkpoint, loads
the weights (a reference checkpoint, or one this CLI wrote), optionally
freezes parameters whose state-dict name matches ``--freeze_regex``,
and trains L1 with AdamW, clip 1.0 and epoch-wise cosine annealing on
native-LR crops, validating every ``--val_every`` epochs and writing
``best_X?.pth`` / ``bestpsnr_X?.pth``, a run report and a loss curve
into ``--workdir``.

Precision: fp32 parameters, bf16 compute on the GPU through the port's
kernels (each Swin block's forward K1 and backward K5), no loss
scaling, fp32 loss and metrics.  The JAX CLI builds its model in fp32,
but on the TPU its matmuls run at bf16 MXU precision anyway.  With
``--device cpu`` everything is fp32 through the kernels' plain versions.

``--trace PATH`` writes a chrome-trace timeline of the epochs
(``utils/trace.py``).  Orbax checkpoints are read after
``python -m tpu_superresolution_tpu.cli.export_torch`` writes them as a
reference ``.pt``.  ``--dp N`` shards each batch across N GPUs, one
process a GPU started by ``torchrun --nproc_per_node N`` (``parallel/``,
as ``cli/train.py``); outside such a launch it exits.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from tpu_superresolution_torch.cli.common import (
    add_device_flag,
    init_data_parallel,
    report_device,
    resolve_workers,
    seed_everything,
)
from tpu_superresolution_torch.core.config import DataConfig, SwinIRConfig, TrainConfig, build_model
from tpu_superresolution_torch.core.dtypes import COMPUTE_DTYPE
from tpu_superresolution_torch.data.index import PairedIndex
from tpu_superresolution_torch.data.loader import Loader
from tpu_superresolution_torch.train.engine import Trainer, build_optimizer, create_train_state

_ARCH_FLAGS = ("embed_dim", "depths", "num_heads", "window_size")


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_root", type=str, required=True)
    ap.add_argument("--scale", type=str, choices=["X2", "X4"], required=True)
    ap.add_argument("--weights", type=str, default=None,
                    help="SwinIR .pth/.pt: an official checkpoint or one this CLI wrote")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--lr_patch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-5)
    ap.add_argument("--weight_decay", type=float, default=0.0)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--freeze_regex", type=str, default=None,
                    help="freeze parameters whose torch state-dict name matches, e.g. "
                         r"'^layers\.[0-2]\.' (a JAX-package regex over Flax paths "
                         "has to be rewritten)")
    ap.add_argument("--scheduler", type=str, choices=["None", "Cosine"], default="Cosine")
    ap.add_argument("--min_lr", type=float, default=2e-6)
    ap.add_argument("--grad_clip", type=float, default=1.0)
    ap.add_argument("--workdir", type=str, default=".")
    ap.add_argument("--trace", type=str, default=None,
                    help="write a chrome-trace (Perfetto) timeline of the epochs here")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel shards, one process a device under torchrun "
                         "(0 = one device, -1 = every rank)")
    ap.add_argument("--early_stop_patience", type=int, default=None,
                    help="stop after N epochs without val-loss improvement")
    ap.add_argument("--ema_decay", type=float, default=0.0,
                    help="EMA of params (e.g. 0.999); validation and best checkpoints "
                         "use the EMA weights. 0 = off")
    ap.add_argument("--val_every", type=int, default=1,
                    help="validate every N epochs (always the last)")
    # architecture overrides (default SwinIR-M; smaller for smoke tests)
    ap.add_argument("--embed_dim", type=int, default=180)
    ap.add_argument("--depths", type=str, default="6,6,6,6,6,6")
    ap.add_argument("--num_heads", type=str, default="6,6,6,6,6,6")
    ap.add_argument("--window_size", type=int, default=8)
    add_device_flag(ap)
    return ap


def model_config_from_args(args, scale_int: int, log=print) -> SwinIRConfig:
    """SwinIR-M or the flags' architecture; with a .pth, the one inferred
    from its tensor shapes (explicit flags must agree with it)."""
    mcfg = SwinIRConfig(
        scale=scale_int, embed_dim=args.embed_dim,
        depths=tuple(int(d) for d in args.depths.split(",")),
        num_heads=tuple(int(h) for h in args.num_heads.split(",")),
        window_size=args.window_size,
    )
    if not (args.weights and args.weights.endswith((".pth", ".pt"))):
        return mcfg
    from tpu_superresolution_torch.interop import (
        infer_swinir_config,
        load_torch_checkpoint,
        strip_reference_buffers,
    )

    inferred = infer_swinir_config(strip_reference_buffers(load_torch_checkpoint(args.weights)),
                                   scale_int)
    ap = build_argparser()
    if all(getattr(args, f) == ap.get_default(f) for f in _ARCH_FLAGS):
        mcfg = dataclasses.replace(inferred, scale=scale_int,
                                   drop_path_rate=mcfg.drop_path_rate)
        log(f"[arch] inferred from checkpoint: embed_dim={mcfg.embed_dim} "
            f"depths={mcfg.depths} heads={mcfg.num_heads} ws={mcfg.window_size} "
            f"upsampler={mcfg.upsampler} fused_reconstruct={mcfg.fused_reconstruct}")
        return mcfg
    mismatch = [(f, getattr(mcfg, f), getattr(inferred, f)) for f in _ARCH_FLAGS
                if getattr(mcfg, f) != getattr(inferred, f)]
    if mismatch:
        raise SystemExit("architecture flags disagree with the checkpoint: " + ", ".join(
            f"{f}: flag {a} vs ckpt {b}" for f, a, b in mismatch))
    return mcfg


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dp, device = init_data_parallel(args.dp, args.device)
    generator = seed_everything(args.seed)
    report_device(device)
    scale_int = 2 if args.scale.upper() == "X2" else 4

    mcfg = model_config_from_args(args, scale_int)
    dcfg = DataConfig(data_root=args.data_root, scale=args.scale, convention="native_lr",
                      lr_patch=args.lr_patch, do_flips=False, grayscale=False, channels=3)
    tcfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, loss="l1", lr=args.lr,
        weight_decay=args.weight_decay, scheduler=args.scheduler.lower(), min_lr=args.min_lr,
        grad_clip_norm=args.grad_clip, seed=args.seed, freeze_regex=args.freeze_regex,
        finetune=True, early_stop_patience=args.early_stop_patience,
        val_every=args.val_every, ema_decay=args.ema_decay or None, dp_shards=dp,
    )
    dtype = COMPUTE_DTYPE if device.type == "cuda" and tcfg.bf16_compute else torch.float32
    model = build_model(mcfg, dtype=dtype)
    if args.weights:
        if not args.weights.endswith((".pth", ".pt")):
            raise SystemExit(f"{args.weights}: the port loads .pth/.pt weights; write an Orbax "
                             "checkpoint as a reference .pt with `python -m "
                             "tpu_superresolution_tpu.cli.export_torch --ckpt DIR --out m.pt`")
        from tpu_superresolution_torch.interop import load_torch_checkpoint, strip_reference_buffers

        sd = strip_reference_buffers(load_torch_checkpoint(args.weights))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        print(f"[weights] loaded torch checkpoint: {args.weights}")
    else:
        model.reset_parameters(torch.Generator().manual_seed(args.seed))
    model.to(device)

    idx_tr = PairedIndex(args.data_root, "train", args.scale)
    idx_va = PairedIndex(args.data_root, "valid", args.scale)
    workers = resolve_workers(args.workers)
    train_loader = Loader(idx_tr, args.batch_size, shuffle=True, drop_last=True,
                          grayscale=False, channels=3, seed=args.seed, num_threads=workers,
                          host_crop_hr=args.lr_patch * scale_int, host_crop_scale=scale_int)
    valid_loader = Loader(idx_va, max(1, args.batch_size // 2), grayscale=False, channels=3,
                          num_threads=workers)

    optimizer, schedule = build_optimizer(tcfg, len(train_loader), model)
    state = create_train_state(model, optimizer, schedule, tcfg.grad_clip_norm, tcfg.ema_decay)
    if args.freeze_regex:
        params = list(model.parameters())
        print(f"[freeze] regex='{args.freeze_regex}', "
              f"trainable={sum(p.requires_grad for p in params)}/{len(params)}")

    t_all = time.time()
    trainer = Trainer(mcfg, dcfg, tcfg, workdir=args.workdir, trace_path=args.trace)
    trainer.fit(state, train_loader, valid_loader, generator)
    print(f"[time] total: {time.time() - t_all:.1f}s")
    print(f"[done] best_val_loss={trainer.best_val_loss:.6f}, "
          f"best_val_psnr={trainer.best_val_psnr:.2f} dB")
    return trainer, state


if __name__ == "__main__":
    main()
