"""Training CLI on the GPU (port of ``tpu_superresolution_tpu/cli/train.py``;
reference train.py:183-423):

    python -m tpu_superresolution_torch.cli.train \\
        --data_root /path/DeepRockSR-2D --scale X4 --epochs 100 \\
        --scheduler Exponential --loss mse --patch_size 100

``--model`` picks a registered family.  The default, as in the JAX CLI,
is ``ms_resunet``; ``unet2d`` (``--base_channels``, ``--depth``,
``--residual``) is the other CNN.  Both train in the pre-upscale
convention: the LR batch bicubic-upscaled to the HR size on the device,
on host-cropped ``--patch_size`` HR patches.  The transformers
``swinir``, ``hat``, ``hat_fast`` and ``dat`` train on native-LR crops
of ``--patch_size`` LR pixels; their overrides ``--embed_dim``,
``--t_depths``, ``--t_heads`` and ``--window_size`` resize the family's
default config, as in the JAX CLI, and ``--mlp_ratio`` (not in the JAX
CLI) its MLP width: HAT's default is 4, upstream HAT-SRx4's 2
(``--window_size 16 --embed_dim 180 --t_depths 6,6,6,6,6,6 --t_heads
6,6,6,6,6,6 --mlp_ratio 2``); an override its config lacks (DAT has no
``--window_size``) exits, and the CNNs refuse all five.

Data: ``--do_blur`` (the paired gaussian blur, p 0.5, one sigma a batch),
``--normalize`` (a pass over the train split's HR images for the mean
and std first; loss and validation metrics are then in the normalized
space), ``--cache_decoded`` (decoded images kept in RAM as uint16 from
the second epoch on, up to ``--cache_limit_gb``); PNGs are decoded by
the native C++ decoder where it builds, else by PIL.

Weights start from the reference initialisation drawn from ``--seed``;
``--resume`` restores a ``.pt`` / ``.pth`` checkpoint this CLI or
``finetune`` wrote (weights, and the optimizer state, step and EMA
unless ``--finetune``).  Each validated epoch may write ``best_X?.pth``
/ ``bestpsnr_X?.pth``; the run report and the loss curve go to
``--workdir``.

Precision: fp32 parameters, bf16 compute on the GPU (through the port's
kernels for the transformers, cuDNN for the CNNs; BatchNorm in fp32), no
loss scaling, fp32 loss and metrics; with ``--device cpu`` everything is
fp32 (the kernels' plain versions).

``--trace PATH`` writes a chrome-trace timeline of the epochs (train and
val spans, loss and PSNR counters; ``utils/trace.py``).

``--dp N`` shards each batch across N GPUs, one process a GPU
(``parallel/``; -1 = every rank of the launch):

    torchrun --nproc_per_node 4 -m tpu_superresolution_torch.cli.train \
        --data_root /path/DeepRockSR-2D --scale X4 --model swinir --dp 4

Every rank reads the same batches and trains on its rows; rank 0 alone
logs and writes the checkpoints, the report and the curve.  ``--dp`` > 1
outside such a launch exits.
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
from tpu_superresolution_torch.core.config import (
    DataConfig,
    TrainConfig,
    build_model,
    model_registry,
)
from tpu_superresolution_torch.core.dtypes import COMPUTE_DTYPE
from tpu_superresolution_torch.data.index import PairedIndex
from tpu_superresolution_torch.data.loader import Loader
from tpu_superresolution_torch.data.transforms import dataset_mean_std
from tpu_superresolution_torch.train.engine import Trainer, build_optimizer, create_train_state

CNN_FAMILIES = ("ms_resunet", "unet2d")
# the transformer overrides, refused for the CNNs (the JAX CLI's rule,
# with the port's --mlp_ratio)
TRANSFORMER_FLAGS = ("embed_dim", "t_depths", "t_heads", "window_size", "mlp_ratio")


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_root", type=str, required=True)
    ap.add_argument("--scale", type=str, choices=["X2", "X4"], required=True)
    ap.add_argument("--model", type=str, default="ms_resunet",
                    help="ms_resunet (default), unet2d, swinir, hat, hat_fast or dat")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--scheduler", type=str,
                    choices=["OneCycle", "Exponential", "Cosine", "None"], default="None")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--loss", type=str, choices=["mse", "l1", "l1_ssim"], default="mse")
    ap.add_argument("--patch_size", type=int, default=100,
                    help="the HR patch of the CNN families (pre-upscale), the LR patch of "
                         "the native-LR transformer families")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight_decay", type=float, default=0.0)
    ap.add_argument("--no_flips", action="store_true")
    ap.add_argument("--do_blur", action="store_true",
                    help="paired gaussian blur augmentation (p 0.5, sigma U(0.1, 2.0) a batch)")
    ap.add_argument("--normalize", action="store_true",
                    help="normalize both members by the train split's HR mean / std")
    ap.add_argument("--early_stop_patience", type=int, default=None,
                    help="stop after N epochs without val-loss improvement")
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--time_log_every", type=int, default=0,
                    help="log within-epoch data/step timing every N batches (0=off)")
    ap.add_argument("--ema_decay", type=float, default=0.0,
                    help="EMA of params (e.g. 0.999); validation and best checkpoints use "
                         "the EMA weights. 0 = off")
    ap.add_argument("--val_every", type=int, default=1,
                    help="validate every N epochs (always the last)")
    ap.add_argument("--resume", type=str, default=None,
                    help=".pt/.pth checkpoint to restore weights (+ optimizer state, step "
                         "and EMA unless --finetune)")
    ap.add_argument("--finetune", action="store_true")
    ap.add_argument("--freeze_regex", type=str, default=None,
                    help="with --finetune: freeze parameters whose torch state-dict name "
                         "matches")
    ap.add_argument("--ft_lr", type=float, default=None)
    ap.add_argument("--workdir", type=str, default=".")
    ap.add_argument("--trace", type=str, default=None,
                    help="write a chrome-trace (Perfetto) timeline of the epochs here")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel shards, one process a device under torchrun "
                         "(0 = one device, -1 = every rank)")
    ap.add_argument("--base_channels", type=int, default=64, help="unet2d width")
    ap.add_argument("--embed_dim", type=int, default=None)
    ap.add_argument("--t_depths", type=str, default=None, help="comma list, e.g. 6,6,6,6")
    ap.add_argument("--t_heads", type=str, default=None)
    ap.add_argument("--window_size", type=int, default=None)
    ap.add_argument("--mlp_ratio", type=float, default=None,
                    help="MLP hidden / embed (HAT's default 4; upstream HAT-SRx4 trains at 2)")
    ap.add_argument("--depth", type=int, default=4, help="unet2d depth (H, W multiples of 2**depth)")
    ap.add_argument("--residual", action="store_true",
                    help="unet2d residual head: predict a correction to the (pre-upscaled) "
                         "input, which starts at the bicubic floor")
    ap.add_argument("--cache_decoded", action="store_true",
                    help="cache decoded images in host RAM (epochs 2+ skip decode)")
    ap.add_argument("--cache_limit_gb", type=float, default=8.0)
    add_device_flag(ap)
    return ap


def model_config_from_args(args):
    """The family's default config at the scale: for UNet2D with
    ``--base_channels``, ``--depth`` and ``--residual``, for the
    transformers resized by their overrides (the JAX CLI's rules)."""
    from tpu_superresolution_torch import models as _models  # noqa: F401  (the registry)
    from tpu_superresolution_torch.core.config import MSResUNetConfig, UNet2DConfig

    scale = int(args.scale[1:])
    if args.model in CNN_FAMILIES:
        passed = [f"--{k}" for k in TRANSFORMER_FLAGS if getattr(args, k) is not None]
        if passed:
            raise SystemExit(f"flag(s) {passed} not valid for model '{args.model}' "
                             "(transformer-only overrides)")
        if args.model == "ms_resunet":
            return MSResUNetConfig(scale=scale)
        return UNet2DConfig(scale=scale, base_channels=args.base_channels, depth=args.depth,
                            residual=args.residual)

    if args.model not in model_registry:
        raise SystemExit(f"--model {args.model}: not a registered family "
                         f"({sorted(model_registry)})")
    cfg_cls, _ = model_registry[args.model]
    mcfg = cfg_cls(scale=scale)
    over = {}
    if args.embed_dim is not None:
        over["embed_dim"] = args.embed_dim
    if args.t_depths is not None:
        over["depths"] = tuple(int(d) for d in args.t_depths.split(","))
    if args.t_heads is not None:
        over["num_heads"] = tuple(int(h) for h in args.t_heads.split(","))
    if args.window_size is not None:
        over["window_size"] = args.window_size
    if args.mlp_ratio is not None:
        over["mlp_ratio"] = args.mlp_ratio
    bad = [k for k in over if not hasattr(mcfg, k)]
    if bad:
        raise SystemExit(f"flag(s) {bad} not valid for model '{args.model}' (its config has no "
                         "such field)")
    return dataclasses.replace(mcfg, **over) if over else mcfg


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dp, device = init_data_parallel(args.dp, args.device)
    generator = seed_everything(args.seed)
    report_device(device)
    t_all = time.time()

    mcfg = model_config_from_args(args)
    scale_int = int(args.scale[1:])
    channels = mcfg.in_channels
    # the CNN families pre-upscale; the transformers upsample themselves
    convention = "native_lr" if mcfg.upsamples_internally else "pre_upscale"
    workers = resolve_workers(args.workers)
    loader_kw = dict(grayscale=channels == 1, channels=channels, num_threads=workers)

    norm_mean = norm_std = None
    if args.normalize:
        stats_loader = Loader(PairedIndex(args.data_root, "train", args.scale), 8, **loader_kw)
        norm_mean, norm_std = dataset_mean_std(stats_loader, use_hr=True)
        print(f"[stats] dataset HR mean={norm_mean:.8f} std={norm_std:.8f}")

    dcfg = DataConfig(data_root=args.data_root, scale=args.scale, convention=convention,
                      patch_size=args.patch_size if convention == "pre_upscale" else None,
                      lr_patch=args.patch_size if convention == "native_lr" else None,
                      do_flips=not args.no_flips, do_blur=args.do_blur, norm_mean=norm_mean,
                      norm_std=norm_std, grayscale=channels == 1, channels=channels)
    tcfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, loss=args.loss, lr=args.lr,
        weight_decay=args.weight_decay, scheduler=args.scheduler.lower(), seed=args.seed,
        freeze_regex=args.freeze_regex, finetune=args.finetune, ft_lr=args.ft_lr,
        early_stop_patience=args.early_stop_patience, time_log_every=args.time_log_every,
        val_every=args.val_every, ema_decay=args.ema_decay or None, dp_shards=dp,
    )

    idx_tr = PairedIndex(args.data_root, "train", args.scale)
    idx_va = PairedIndex(args.data_root, "valid", args.scale)
    # host-side aligned crops: a step uploads patches, not whole images
    # (the on-device pre-upscale crop then takes the whole patch)
    host_crop = args.patch_size if convention == "pre_upscale" else args.patch_size * scale_int
    train_loader = Loader(idx_tr, args.batch_size, shuffle=True, seed=args.seed,
                          host_crop_hr=host_crop, host_crop_scale=scale_int,
                          cache_decoded=args.cache_decoded, cache_limit_gb=args.cache_limit_gb,
                          **loader_kw)
    valid_loader = Loader(idx_va, max(1, args.batch_size // 2), **loader_kw)
    print(f"[cfg] model={args.model} convention={convention} train={len(idx_tr)} "
          f"valid={len(idx_va)} workers={workers}")

    dtype = COMPUTE_DTYPE if device.type == "cuda" and tcfg.bf16_compute else torch.float32
    model = build_model(mcfg, dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    if args.resume:
        from tpu_superresolution_torch.train.checkpoint import load_weights_only

        params, meta = load_weights_only(args.resume)
        model.load_state_dict(params, strict=True)
        print(f"[ckpt] loaded model weights from {args.resume} (epoch {meta.get('epoch')})")
    model.to(device)

    optimizer, schedule = build_optimizer(tcfg, len(train_loader), model)
    state = create_train_state(model, optimizer, schedule, tcfg.grad_clip_norm, tcfg.ema_decay)
    if args.resume and not args.finetune:
        from tpu_superresolution_torch.train.checkpoint import load_checkpoint

        load_checkpoint(args.resume, state)
        print(f"[ckpt] restored optimizer state (step {state.step})")

    trainer = Trainer(mcfg, dcfg, tcfg, workdir=args.workdir, trace_path=args.trace)
    trainer.fit(state, train_loader, valid_loader, generator)
    print(f"[ALL][time] total train time={time.time() - t_all:.1f}s")
    return trainer, state


if __name__ == "__main__":
    main()
