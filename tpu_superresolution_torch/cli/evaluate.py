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
trained with, and with its EMA when it kept one.  The CNN families
(``ms_resunet``, the default ``--model``, and ``unet2d``, which has no
reference format) are evaluated on bicubic-pre-upscaled LR, without the
training's normalization, as the JAX CLI does.  Orbax directories are
read after ``tpu_superresolution_tpu.cli.export_torch`` writes them as a
reference ``.pt``.

``--dp N`` (with ``--tile``) splits each image's tile batch across N
GPUs, one process a GPU started by ``torchrun --nproc_per_node N``
(``evaluate/tiling.py::sharded_tiled_forward``); every rank evaluates the
whole test split and rank 0 alone writes the PNGs and the report.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from tpu_superresolution_torch.cli.common import (
    add_device_flag,
    init_data_parallel,
    report_device,
    resolve_workers,
)
from tpu_superresolution_torch.cli.upscale import load_any_checkpoint


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
                    help="shard the tile batch across N devices, one process a device under "
                         "torchrun (requires --tile; -1 = every rank)")
    add_device_flag(ap)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from tpu_superresolution_torch.parallel.mesh import is_writer, launched_world_size

    if not args.tile and (args.dp > 1 or (args.dp == -1 and launched_world_size() > 1)):
        raise SystemExit("--dp requires --tile (sharded tiled inference)")
    if Path(args.ckpt).is_dir():
        raise SystemExit(
            f"{args.ckpt}: an Orbax checkpoint directory, which the port does not read; "
            "write it as a reference .pt with "
            "`python -m tpu_superresolution_tpu.cli.export_torch` and evaluate that")

    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.data.loader import Loader
    from tpu_superresolution_torch.core.config import EvalConfig
    from tpu_superresolution_torch.evaluate.baseline import bicubic_baseline
    from tpu_superresolution_torch.evaluate.runner import Evaluator

    dp, device = init_data_parallel(args.dp, args.device)
    report_device(device)
    scale_int = int(args.scale[1:])

    # the port's own checkpoint (its config) or a reference one (e.g. the
    # published best_X4.pth; reference evaluate.py:41-63 loads these)
    mcfg, model = load_any_checkpoint(args.ckpt, args.model, scale_int, args.exact, device,
                                      ema=args.ema)

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
    mesh = None
    if dp:
        from tpu_superresolution_torch.parallel import make_mesh

        mesh = make_mesh(dp, device)
        print(f"[dp] sharded tiled inference over {dp} devices")
    ev = Evaluator(model, scale_int, convention, ecfg, device=device, mesh=mesh)
    saving = args.save_n or args.save_every or save_indices
    results = ev.run(loader, save_dir=args.save_dir if saving else None)
    print(f"[result] PSNR {results['psnr']:.2f} dB | SSIM {results['ssim']:.4f} | "
          f"{results['mpix_per_s']:.1f} MPix/s")
    if args.report_json and is_writer():
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
