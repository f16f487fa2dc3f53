"""Direct .mat volume evaluation CLI (port of
``tpu_superresolution_tpu/cli/mat_eval.py``; the reference's lost
mat_eval_mrccm.py, whose command line is in common_commands.txt:1-3):

    python -m tpu_superresolution_torch.cli.mat_eval \\
        --hr_mat ILS1.mat --lr_mat ILS_LR.mat --ckpt best_X4.pth \\
        --batch_size 4 --limit_pairs 5

Slices both volumes, runs the checkpointed model slice-wise (whole
slices, or ``--tile`` tiles with overlap blending) and reports PSNR /
SSIM and the bicubic floor.  It runs on the GPU (bf16 through the
port's kernels; raises without one) unless ``--device cpu``.  The JAX
CLI reads Orbax checkpoints; this one reads ``.pt/.pth`` through
``cli.upscale.load_any_checkpoint``: a checkpoint of the port's train /
finetune CLI carries its config (its raw parameters, as the JAX CLI
loads; ``--ema`` for the EMA it kept), a reference one is of the family
``--model`` names (default ``ms_resunet``, the JAX CLI's fallback
config).
"""

from __future__ import annotations

import argparse

from tpu_superresolution_torch.cli.common import add_device_flag, report_device, resolve_device


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--hr_mat", type=str, required=True)
    ap.add_argument("--lr_mat", type=str, required=True)
    ap.add_argument("--ckpt", type=str, required=True,
                    help="a reference .pt/.pth or a checkpoint of the port's train / finetune "
                         "CLI")
    ap.add_argument("--model", type=str, default="ms_resunet",
                    choices=["ms_resunet", "unet2d", "swinir", "hat", "dat"],
                    help="family of a reference .pt/.pth (the port's own carry their config)")
    ap.add_argument("--ema", action=argparse.BooleanOptionalAction, default=False,
                    help="evaluate a port checkpoint's EMA weights (default: its raw "
                         "parameters)")
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--limit_pairs", type=int, default=None)
    ap.add_argument("--scale", type=str, default="X4")
    ap.add_argument("--tile", type=int, default=0)
    ap.add_argument("--tile_overlap", type=int, default=16)
    add_device_flag(ap)
    return ap


def _batches(lr, hr, bs):
    for i in range(0, lr.shape[0], bs):
        yield lr[i : i + bs], hr[i : i + bs]


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from tpu_superresolution_torch.cli.upscale import load_any_checkpoint
    from tpu_superresolution_torch.core.config import EvalConfig
    from tpu_superresolution_torch.data.mrccm import mat_volume_pairs
    from tpu_superresolution_torch.evaluate.baseline import bicubic_baseline
    from tpu_superresolution_torch.evaluate.runner import Evaluator

    device = resolve_device(args.device)
    report_device(device)
    scale_int = int(args.scale[1:])
    lr, hr = mat_volume_pairs(args.lr_mat, args.hr_mat, args.limit_pairs)
    print(f"[data] pairs: {lr.shape[0]} | lr {lr.shape[1:3]} hr {hr.shape[1:3]}")

    mcfg, model = load_any_checkpoint(args.ckpt, args.model, scale_int, device=device,
                                      ema=args.ema)
    convention = "native_lr" if mcfg.upsamples_internally else "pre_upscale"
    base = bicubic_baseline(_batches(lr, hr, args.batch_size), scale_int, device)
    print(f"[baseline] Bicubic PSNR: {base['psnr']:.2f} dB | SSIM: {base['ssim']:.4f}")

    ecfg = EvalConfig(batch_size=args.batch_size, tile_size=args.tile or None,
                      tile_overlap=args.tile_overlap)
    ev = Evaluator(model, scale_int, convention, ecfg, device=device)
    results = ev.run(_batches(lr, hr, args.batch_size))
    print(f"[result] PSNR {results['psnr']:.2f} dB | SSIM {results['ssim']:.4f}")
    return results


if __name__ == "__main__":
    main()
