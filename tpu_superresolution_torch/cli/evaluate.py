"""Evaluation CLI (port of ``tpu_superresolution_tpu/cli/evaluate.py``;
reference evaluate.py:54-234):

    python -m tpu_superresolution_torch.cli.evaluate \\
        --data_root /path/DeepRockSR-2D --scale X4 --model swinir \\
        --ckpt best_X4.pth --save_n 16 --save_dir preds

Computes the bicubic baseline, evaluates the checkpoint's model on the
test split (whole images or ``--tile`` tiled with overlap blending) and
dumps LR / HR / SR PNG triplets by the save rules.  It runs on the GPU,
in bf16 through the port's kernels, and raises when there is none; with
``--device cpu`` it runs on the CPU in fp32 through their plain
versions.

The checkpoint is a reference ``.pt/.pth`` (the architecture inferred
from the tensor shapes, ``--model`` naming the family) or one written by
``cli/finetune.py`` / ``cli/train.py``, told apart by its "config"
entry (not by the suffix): such a file evaluates with the config it was
trained with, and with its EMA when it kept one.  Orbax directories, the
CNN families and multi-GPU sharding are still to port (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from tpu_superresolution_torch.cli.common import (
    add_device_flag,
    report_device,
    resolve_device,
    resolve_workers,
)
from tpu_superresolution_torch.cli.train import CNN_FAMILIES
from tpu_superresolution_torch.cli.upscale import exact_config, load_any_checkpoint


def load_port_checkpoint(path: str, saved, exact, ema, device: torch.device):
    """A checkpoint of ``train/checkpoint.py`` (`saved`, the dictionary
    read from `path`) into the port: its embedded config (``exact``
    forces the reference-exact semantics) and its parameters, or its EMA
    parameters with the saved buffers.  `ema` None is auto: the EMA when
    the run recorded an ``ema_decay``, since its best checkpoints were
    chosen by validating the EMA weights.  Returns (model_config,
    model)."""
    from tpu_superresolution_torch.core.config import build_model, config_from_dict
    from tpu_superresolution_torch.core.dtypes import serving_dtype
    from tpu_superresolution_torch.train.checkpoint import checked_params

    mcfg = config_from_dict(saved["config"])
    if exact:
        mcfg = exact_config(mcfg)
    state = dict(checked_params(saved, path))
    extra = saved.get("extra", {})
    use_ema = ema
    if use_ema is None:
        use_ema = bool(extra.get("ema_decay"))
        if use_ema:
            print(f"[ckpt] the checkpoint records ema_decay={extra['ema_decay']}: evaluating "
                  "the EMA weights (--no-ema for the raw parameters)")
    if use_ema:
        if saved.get("ema") is None:
            raise SystemExit(f"--ema: no EMA in {path} (train with --ema_decay to keep one)")
        state.update(saved["ema"])  # parameters only; buffers stay the saved ones
        print("[ckpt] using EMA weights")
    model = build_model(mcfg, dtype=serving_dtype(device))
    model.load_state_dict(state, strict=True)
    print(f"[ckpt] {path}: model={mcfg.name} epoch={extra.get('epoch')} "
          f"(exact={bool(exact)})")
    return mcfg, model.to(device).eval()


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scale", type=str, choices=["X2", "X4"], required=True)
    ap.add_argument("--data_root", type=str, required=True)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--model", type=str, default="ms_resunet",
                    choices=["ms_resunet", "unet2d", "swinir", "hat", "dat"],
                    help="architecture of a reference .pt/.pth (the port's own "
                         "checkpoints carry their config and ignore this)")
    ap.add_argument("--ckpt", type=str, required=True,
                    help="a reference .pt/.pth or a checkpoint of the port's finetune / "
                         "train CLI")
    ap.add_argument("--save_dir", type=str, default="preds")
    ap.add_argument("--save_n", type=int, default=16)
    ap.add_argument("--save_every", type=int, default=0)
    ap.add_argument("--save_start", type=int, default=0)
    ap.add_argument("--save_indices", type=str, default="",
                    help="comma-separated indices; overrides save_every")
    ap.add_argument("--rescale_png", action="store_true")
    ap.add_argument("--ema", action=argparse.BooleanOptionalAction, default=None,
                    help="evaluate the EMA weights saved with the checkpoint (--ema_decay "
                         "at train time).  Default (unset): auto, the EMA when the "
                         "checkpoint records an ema_decay; --no-ema forces the raw "
                         "parameters")
    ap.add_argument("--self_ensemble", action="store_true",
                    help="x8 geometric TTA (rot90 x flips, averaged): ~8x the inference cost")
    ap.add_argument("--tile", type=int, default=0,
                    help="tile size for tiled inference (0 = whole image)")
    ap.add_argument("--tile_overlap", type=int, default=16)
    ap.add_argument("--tile_batch", type=int, default=0,
                    help="max tiles per model call (0 = all in one batch); bounds peak "
                         "device memory at whole-image sizes")
    ap.add_argument("--exact", action=argparse.BooleanOptionalAction, default=None,
                    help="reference-exact semantics: no fused reconstruction, erf GELU.  "
                         "Default: ON for reference .pt/.pth checkpoints, OFF for the "
                         "port's own, which evaluate with the semantics of their config "
                         "(those they were trained with)")
    ap.add_argument("--no_baseline", action="store_true")
    ap.add_argument("--report_json", type=str, default="",
                    help="write the result dict (psnr / ssim / mpix_per_s ...) as JSON to "
                         "this path")
    ap.add_argument("--dp", type=int, default=0,
                    help="shard the tile batch across N devices: not ported yet")
    add_device_flag(ap)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.dp not in (0, 1):
        raise SystemExit(f"--dp {args.dp}: sharded inference waits for the multi-GPU slice "
                         "(ROADMAP.md Queue 1 item 5)")
    if Path(args.ckpt).is_dir():
        raise SystemExit(
            f"{args.ckpt}: an Orbax checkpoint directory, which the port does not read "
            "(ROADMAP.md Queue 1 item 1c); write it as a reference .pt with "
            "`python -m tpu_superresolution_tpu.cli.export_torch` and evaluate that")

    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.data.loader import Loader
    from tpu_superresolution_torch.core.config import EvalConfig
    from tpu_superresolution_torch.evaluate.baseline import bicubic_baseline
    from tpu_superresolution_torch.evaluate.runner import Evaluator
    from tpu_superresolution_torch.train.checkpoint import read_checkpoint

    device = resolve_device(args.device)
    report_device(device)
    scale_int = int(args.scale[1:])

    saved = read_checkpoint(args.ckpt)
    if isinstance(saved, dict) and saved.get("config") is not None:
        mcfg, model = load_port_checkpoint(args.ckpt, saved, args.exact, args.ema, device)
    else:
        # a reference checkpoint (e.g. the published best_X4.pth; reference
        # evaluate.py:41-63 loads these): one weight set, inferred shapes
        if args.ema:
            raise SystemExit("--ema applies to the port's own checkpoints only; reference "
                             ".pt/.pth files carry a single weight set")
        if args.model in CNN_FAMILIES:
            raise SystemExit(f"--model {args.model}: the CNN families (ms_resunet, unet2d) are "
                             "still to port (ROADMAP.md Queue 1 item 2); evaluate swinir, hat "
                             "or dat checkpoints")
        exact = True if args.exact is None else args.exact
        mcfg, model = load_any_checkpoint(args.ckpt, args.model, scale_int, exact, device)
        print(f"[ckpt] {args.ckpt}: reference checkpoint, model={mcfg.name} (exact={exact})")

    convention = "native_lr" if mcfg.upsamples_internally else "pre_upscale"
    channels = mcfg.in_channels
    idx_te = PairedIndex(args.data_root, "test", args.scale)
    loader = Loader(idx_te, args.batch_size, grayscale=channels == 1, channels=channels,
                    num_threads=resolve_workers(args.workers))
    print(f"[data] test samples: {len(idx_te)} | steps: {len(loader)}")

    if not args.no_baseline:
        t0 = time.perf_counter()
        base = bicubic_baseline(loader, scale_int, device=device)
        print(f"[baseline] Bicubic PSNR: {base['psnr']:.2f} dB | SSIM: {base['ssim']:.4f} "
              f"({time.perf_counter() - t0:.2f} s)")

    save_indices = tuple(int(s) for s in args.save_indices.split(",") if s.strip())
    ecfg = EvalConfig(
        batch_size=args.batch_size,
        tile_size=args.tile or None,
        tile_overlap=args.tile_overlap,
        max_tile_batch=args.tile_batch or None,
        save_n=args.save_n,
        save_every=args.save_every or None,
        save_start=args.save_start,
        save_indices=save_indices,
        rescale_png=args.rescale_png,
        self_ensemble=args.self_ensemble,
    )
    ev = Evaluator(model, scale_int, convention, ecfg, device=device)
    saving = args.save_n or args.save_every or save_indices
    results = ev.run(loader, save_dir=args.save_dir if saving else None)
    print(f"[result] PSNR {results['psnr']:.2f} dB | SSIM {results['ssim']:.4f} | "
          f"{results['mpix_per_s']:.1f} MPix/s")
    if args.report_json:
        out = {}
        for k, v in results.items():
            try:
                out[k] = float(v)
            except (TypeError, ValueError):
                pass
        with open(args.report_json, "w") as f:
            json.dump(out, f)
        print(f"[report] result json -> {args.report_json}")
    return results


if __name__ == "__main__":
    main()
