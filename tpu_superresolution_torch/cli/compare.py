"""Pairwise model comparison reports (port of
``tpu_superresolution_tpu/cli/compare.py``; the reference's lost
``report_creator.ipynb``, whose ``report/*.png`` side-by-side panels such
as ``dat_vs_swinir_x4_3607.png`` are listed in
``.MISSING_LARGE_BLOBS:1-13``):

    python -m tpu_superresolution_torch.cli.compare \\
        --data_root /path/DeepRockSR-2D --scale X4 \\
        --ckpt_a swinir.pth --model_a swinir \\
        --ckpt_b best_X4.pth --indices 3,7 --out_dir report

For each selected test image, writes ``{a}_vs_{b}_x{s}_{stem}.png``, a
labelled side-by-side panel [LR | bicubic | A | B | HR], and prints each
model's PSNR / SSIM over the selection.  Each model runs on the whole
image (untiled), on native-LR input or on the bicubic-pre-upscaled one
by its convention, on the GPU in bf16 through the port's kernels (raises
without one; ``--device cpu`` runs fp32 plain versions).  Checkpoints
load through ``cli.upscale.load_any_checkpoint``: a reference
``.pt/.pth`` of the family ``--model_a`` / ``--model_b`` names, or one of
the port's train / finetune CLI, which carries its config.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from tpu_superresolution_torch.cli.common import add_device_flag, report_device, resolve_device
from tpu_superresolution_torch.cli.upscale import load_any_checkpoint


def _panel(images, labels, pad=8):
    """Horizontally concatenate [H, W, C] float panels with labels
    rendered into a header strip (PIL default font; no extra deps)."""
    from PIL import Image, ImageDraw

    h = max(im.shape[0] for im in images)
    strips = []
    for im in images:
        arr = (np.clip(im, 0, 1) * 255 + 0.5).astype(np.uint8)
        if arr.shape[-1] == 1:
            arr = np.repeat(arr, 3, axis=-1)
        if arr.shape[0] < h:  # upscale LR panels to HR size (nearest)
            r = h // arr.shape[0]
            arr = np.repeat(np.repeat(arr, r, 0), r, 1)
        strips.append(arr)
    w = sum(s.shape[1] for s in strips) + pad * (len(strips) - 1)
    header = 16
    img = Image.fromarray(np.full((h + header, w, 3), 255, np.uint8))
    draw = ImageDraw.Draw(img)
    x0 = 0
    for s, lab in zip(strips, labels):
        img.paste(Image.fromarray(s), (x0, header))
        draw.text((x0 + 2, 2), lab, fill=(0, 0, 0))
        x0 += s.shape[1] + pad
    return img


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_root", type=str, required=True)
    ap.add_argument("--scale", type=str, choices=["X2", "X4"], required=True)
    ap.add_argument("--ckpt_a", type=str, required=True)
    ap.add_argument("--ckpt_b", type=str, required=True)
    ap.add_argument("--model_a", type=str, default="ms_resunet",
                    help="family of a reference .pt/.pth (the port's own checkpoints carry "
                         "their config)")
    ap.add_argument("--model_b", type=str, default="ms_resunet")
    ap.add_argument("--name_a", type=str, default=None, help="panel label")
    ap.add_argument("--name_b", type=str, default=None)
    ap.add_argument("--indices", type=str, default="0",
                    help="comma-separated test-split indices")
    ap.add_argument("--out_dir", type=str, default="report")
    add_device_flag(ap)
    return ap


def main(argv=None):
    """Returns {label: {"psnr": [...], "ssim": [...], "sr": [SR arrays]}}."""
    from tpu_superresolution_torch.data.decode import decode_image
    from tpu_superresolution_torch.data.index import PairedIndex
    from tpu_superresolution_torch.data.transforms import pre_upscale_batch
    from tpu_superresolution_torch.ops.metrics import psnr, ssim

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    report_device(device)
    scale_int = int(args.scale[1:])
    idx = PairedIndex(args.data_root, "test", args.scale)
    indices = [int(s) for s in args.indices.split(",") if s.strip()]
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    sides = []
    for tag, ckpt, mname, name in (("a", args.ckpt_a, args.model_a, args.name_a),
                                   ("b", args.ckpt_b, args.model_b, args.name_b)):
        # a port checkpoint's raw parameters, as the JAX CLI (not its EMA)
        mcfg, model = load_any_checkpoint(ckpt, mname, scale_int, device=device, ema=False)
        label = name or mcfg.name
        sides.append((label, mcfg, model))
        print(f"[ckpt] {tag}: {ckpt} -> {mcfg.name} ({label})")

    stats = {s[0]: {"psnr": [], "ssim": [], "sr": []} for s in sides}
    with torch.no_grad():
        for i in indices:
            lr_path, hr_path = idx.pairs[i]
            ch = sides[0][1].in_channels
            lr = decode_image(lr_path, grayscale=ch == 1, channels=ch)[None]
            hr = decode_image(hr_path, grayscale=ch == 1, channels=ch)[None]
            lr_t = torch.from_numpy(lr).to(device)
            hr_t = torch.from_numpy(hr).to(device)
            bic = pre_upscale_batch(lr_t, scale_int)
            panels, labels = [lr[0], bic[0].float().cpu().numpy()], ["LR", "bicubic"]
            for label, mcfg, model in sides:
                inp = lr_t if mcfg.upsamples_internally else bic
                if inp.shape[-1] != mcfg.in_channels:
                    inp = inp.repeat_interleave(mcfg.in_channels, dim=-1)
                sr = model(inp).float()
                if sr.shape[-1] != hr_t.shape[-1]:
                    sr = sr.mean(dim=-1, keepdim=True)
                p, s = float(psnr(sr, hr_t)), float(ssim(sr, hr_t))
                sr_np = sr.cpu().numpy()
                panels.append(sr_np[0])
                labels.append(label)
                stats[label]["psnr"].append(p)
                stats[label]["ssim"].append(s)
                stats[label]["sr"].append(sr_np[0])
            panels.append(hr[0])
            labels.append("HR")
            stem = Path(hr_path).stem
            name = f"{sides[0][0]}_vs_{sides[1][0]}_x{scale_int}_{stem}.png"
            _panel(panels, labels).save(out_dir / name)
            print(f"[save] {out_dir / name}")

    for label, d in stats.items():
        print(f"[result] {label}: PSNR {np.mean(d['psnr']):.2f} dB | "
              f"SSIM {np.mean(d['ssim']):.4f} (n={len(d['psnr'])})")
    return stats


if __name__ == "__main__":
    main()
