"""Training CLI on the GPU (port of ``tpu_superresolution_tpu/cli/train.py``;
reference train.py:183-423):

    python -m tpu_superresolution_torch.cli.train \\
        --data_root /path/DeepRockSR-2D --scale X4 --model hat \\
        --loss l1 --patch_size 64 --epochs 100

``--model`` picks a registered family: ``swinir``, ``hat``,
``hat_fast`` or ``dat`` (the transformers, trained on native-LR crops of
``--patch_size`` LR pixels); the CNN families ``ms_resunet`` (the JAX
package's default) and ``unet2d`` are still to port (ROADMAP.md Queue 1
item 2) and exit with that message.  The transformer overrides
``--embed_dim``, ``--t_depths``, ``--t_heads`` and ``--window_size``
resize the family's default config, as in the JAX CLI, and
``--mlp_ratio`` (not in the JAX CLI) its MLP width: HAT's default is 4,
upstream HAT-SRx4's 2 (``--window_size 16 --embed_dim 180 --t_depths
6,6,6,6,6,6 --t_heads 6,6,6,6,6,6 --mlp_ratio 2``); an override its
config lacks (DAT has no ``--window_size``) exits.  Weights start from the reference
initialisation drawn from ``--seed``; ``--resume`` restores a ``.pt`` /
``.pth`` checkpoint this CLI or ``finetune`` wrote (weights, and the
optimizer state, step and EMA unless ``--finetune``).  Each validated
epoch may write ``best_X?.pth`` / ``bestpsnr_X?.pth``; the run report and
the loss curve go to ``--workdir``.

Precision: fp32 parameters, bf16 compute on the GPU through the port's
kernels, no loss scaling, fp32 loss and metrics; with ``--device cpu``
everything is fp32 through the kernels' plain versions.

Not ported yet, and refused: ``--do_blur``, ``--normalize``,
``--cache_decoded``, ``--trace`` and ``--dp`` > 1 (the multi-GPU slice).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from tpu_superresolution_torch.cli.common import (
    add_device_flag,
    report_device,
    resolve_device,
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
from tpu_superresolution_torch.train.engine import Trainer, build_optimizer, create_train_state

CNN_FAMILIES = ("ms_resunet", "unet2d")
# flags of the JAX CLI whose features are not ported yet
_REFUSED = {"do_blur": "--do_blur (blur augmentation)",
            "normalize": "--normalize (dataset normalization)",
            "cache_decoded": "--cache_decoded (the decoded-image cache)",
            "trace": "--trace (the chrome-trace timeline)"}


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_root", type=str, required=True)
    ap.add_argument("--scale", type=str, choices=["X2", "X4"], required=True)
    ap.add_argument("--model", type=str, default="ms_resunet",
                    help="swinir, hat, hat_fast or dat (ms_resunet and unet2d are still to "
                         "port)")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--scheduler", type=str,
                    choices=["OneCycle", "Exponential", "Cosine", "None"], default="None")
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--loss", type=str, choices=["mse", "l1", "l1_ssim"], default="mse")
    ap.add_argument("--patch_size", type=int, default=100,
                    help="the LR patch of the native-LR transformer families")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight_decay", type=float, default=0.0)
    ap.add_argument("--no_flips", action="store_true")
    ap.add_argument("--do_blur", action="store_true", help="not ported yet: refused")
    ap.add_argument("--normalize", action="store_true", help="not ported yet: refused")
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
    ap.add_argument("--trace", type=str, default=None, help="not ported yet: refused")
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel shards (0 = one device; more waits for the "
                         "multi-GPU slice)")
    ap.add_argument("--base_channels", type=int, default=64, help="unet2d (not ported yet)")
    ap.add_argument("--embed_dim", type=int, default=None)
    ap.add_argument("--t_depths", type=str, default=None, help="comma list, e.g. 6,6,6,6")
    ap.add_argument("--t_heads", type=str, default=None)
    ap.add_argument("--window_size", type=int, default=None)
    ap.add_argument("--mlp_ratio", type=float, default=None,
                    help="MLP hidden / embed (HAT's default 4; upstream HAT-SRx4 trains at 2)")
    ap.add_argument("--depth", type=int, default=4, help="unet2d (not ported yet)")
    ap.add_argument("--residual", action="store_true", help="unet2d (not ported yet)")
    ap.add_argument("--cache_decoded", action="store_true", help="not ported yet: refused")
    ap.add_argument("--cache_limit_gb", type=float, default=8.0)
    add_device_flag(ap)
    return ap


def model_config_from_args(args):
    """The family's default config at the scale, resized by the
    transformer overrides (the JAX CLI's rule)."""
    if args.model in CNN_FAMILIES:
        raise SystemExit(f"--model {args.model}: the CNN families (ms_resunet, unet2d) are "
                         "still to port (ROADMAP.md Queue 1 item 2); train swinir, hat, "
                         "hat_fast or dat")
    from tpu_superresolution_torch import models as _models  # noqa: F401  (the registry)

    if args.model not in model_registry:
        raise SystemExit(f"--model {args.model}: not a registered family "
                         f"({sorted(model_registry)})")
    cfg_cls, _ = model_registry[args.model]
    mcfg = cfg_cls(scale=int(args.scale[1:]))
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
    for flag, what in _REFUSED.items():
        if getattr(args, flag):
            raise SystemExit(f"{what} is not ported yet (ROADMAP.md Queue 1 item 1)")
    if args.dp not in (0, 1):
        raise SystemExit(f"--dp {args.dp}: data parallelism waits for the multi-GPU slice "
                         "(ROADMAP.md Queue 1 item 5)")
    generator = seed_everything(args.seed)
    device = resolve_device(args.device)
    report_device(device)
    t_all = time.time()

    mcfg = model_config_from_args(args)
    scale_int = int(args.scale[1:])
    channels = mcfg.in_channels
    dcfg = DataConfig(data_root=args.data_root, scale=args.scale, convention="native_lr",
                      patch_size=None, lr_patch=args.patch_size, do_flips=not args.no_flips,
                      grayscale=channels == 1, channels=channels)
    tcfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, loss=args.loss, lr=args.lr,
        weight_decay=args.weight_decay, scheduler=args.scheduler.lower(), seed=args.seed,
        freeze_regex=args.freeze_regex, finetune=args.finetune, ft_lr=args.ft_lr,
        early_stop_patience=args.early_stop_patience, time_log_every=args.time_log_every,
        val_every=args.val_every, ema_decay=args.ema_decay or None, dp_shards=args.dp,
    )

    idx_tr = PairedIndex(args.data_root, "train", args.scale)
    idx_va = PairedIndex(args.data_root, "valid", args.scale)
    workers = resolve_workers(args.workers)
    # host-side aligned crops: a step uploads patches, not whole images
    train_loader = Loader(idx_tr, args.batch_size, shuffle=True, seed=args.seed,
                          grayscale=dcfg.grayscale, channels=channels, num_threads=workers,
                          host_crop_hr=args.patch_size * scale_int, host_crop_scale=scale_int)
    valid_loader = Loader(idx_va, max(1, args.batch_size // 2), grayscale=dcfg.grayscale,
                          channels=channels, num_threads=workers)
    print(f"[cfg] model={args.model} convention=native_lr train={len(idx_tr)} "
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

    trainer = Trainer(mcfg, dcfg, tcfg, workdir=args.workdir)
    trainer.fit(state, train_loader, valid_loader, generator)
    print(f"[ALL][time] total train time={time.time() - t_all:.1f}s")
    return trainer, state


if __name__ == "__main__":
    main()
