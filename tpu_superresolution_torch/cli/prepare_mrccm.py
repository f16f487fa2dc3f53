"""MRCCM2D dataset preparation CLI (port of
``tpu_superresolution_tpu/cli/prepare_mrccm.py``; the reference's lost
prepare_mrccm.py, documented in common_commands.txt:8-11):

    python -m tpu_superresolution_torch.cli.prepare_mrccm \\
        --lr_mat ILS_LR.mat --hr ILS1=ILS1.mat --hr ILS2=ILS2.mat \\
        --out_root MRCCM2D --force_4x

Writes a DeepRockSR-layout paired PNG dataset (``data/mrccm.py``) that
the train and evaluate CLIs read as they read DeepRockSR.  It runs on
the host only.
"""

from __future__ import annotations

import argparse


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--lr_mat", type=str, required=True)
    ap.add_argument("--hr", action="append", required=True, help="NAME=path.mat (repeatable)")
    ap.add_argument("--out_root", type=str, required=True)
    ap.add_argument("--scale", type=str, default="X4")
    ap.add_argument("--force_4x", action="store_true",
                    help="bicubic-resize LR slices to exactly HR/scale")
    ap.add_argument("--limit_slices", type=int, default=None)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    hr_mats = {}
    for spec in args.hr:
        if "=" not in spec:
            raise SystemExit(f"--hr expects NAME=path, got '{spec}'")
        name, path = spec.split("=", 1)
        hr_mats[name] = path

    from tpu_superresolution_torch.data.mrccm import prepare_mrccm

    counts = prepare_mrccm(args.lr_mat, hr_mats, args.out_root, scale=args.scale,
                           force_4x=args.force_4x, limit_slices=args.limit_slices)
    print(f"[done] wrote {counts} slice pairs under {args.out_root}")
    return counts


if __name__ == "__main__":
    main()
