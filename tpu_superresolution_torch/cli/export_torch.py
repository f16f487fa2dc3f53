"""Write a checkpoint of the port's train / finetune CLI as a
reference-format torch .pt, so that reference users can load the port's
weights directly (port of ``tpu_superresolution_tpu/cli/export_torch.py``,
which does the same for the JAX package's Orbax checkpoints):

    python -m tpu_superresolution_torch.cli.export_torch \\
        --ckpt runs/best_X4.pth --out swinir_x4.pt

The written file is {'params': state_dict}, one of the wrapper forms the
reference's checkpoint unwrap accepts (reference evaluate.py:139-145).
The port's state dict already has the reference's key names, so this
keeps the checkpoint's "params" (BatchNorm running statistics included,
for the families that have them) and drops what only the port reads:
the EMA, the optimizer state, the step, the config and the run's extras.
A reference ``.pt/.pth`` (no "config" entry) is refused: it already is
the reference format.  The file loads back with ``strict=True`` through
``cli.upscale.load_any_checkpoint`` (the architecture inferred from the
tensor shapes, as for any reference checkpoint).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

# the families with a reference checkpoint format (the JAX package's
# exporters: interop/torch_export.py)
REFERENCE_FAMILIES = ("ms_resunet", "swinir", "hat", "dat")


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", type=str, required=True,
                    help="a .pt/.pth of the port's train / finetune CLI (its embedded config "
                         "names the architecture)")
    ap.add_argument("--out", type=str, required=True, help="output .pt path")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from tpu_superresolution_torch.core.config import config_from_dict
    from tpu_superresolution_torch.train.checkpoint import checked_params, read_checkpoint

    saved = read_checkpoint(args.ckpt)
    if not (isinstance(saved, dict) and saved.get("config") is not None):
        raise SystemExit(f"{args.ckpt}: no model config in it, so not a checkpoint of the "
                         "port's train / finetune CLI; a reference .pt/.pth already is the "
                         "reference format")
    mcfg = config_from_dict(saved["config"])
    if mcfg.name not in REFERENCE_FAMILIES:
        raise SystemExit(f"{args.ckpt}: model '{mcfg.name}' has no reference checkpoint format "
                         f"(have: {list(REFERENCE_FAMILIES)})")
    params = {k: v.contiguous() for k, v in checked_params(saved, args.ckpt).items()}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    torch.save({"params": params}, args.out)
    print(f"[export] {args.ckpt} (model={mcfg.name}, "
          f"epoch={saved.get('extra', {}).get('epoch')}) -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
