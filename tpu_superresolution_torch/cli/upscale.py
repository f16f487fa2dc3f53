"""Single-image super-resolution with a checkpoint of any family (port
of ``tpu_superresolution_tpu/cli/upscale.py``):

    python -m tpu_superresolution_torch.cli.upscale \\
        --ckpt model.pth --model swinir --scale X4 --image photo.png

decode -> [bicubic pre-upscale for the CNN families] -> (auto-)tiled
forward -> PNG.  It runs on the GPU, in bf16 (through the port's kernels
for the transformers, cuDNN for the CNNs), and raises when there is
none; with ``--device cpu`` it runs on the CPU in fp32.  The checkpoint
is a reference ``.pt/.pth`` (``--model`` names its family:
``ms_resunet``, the default, ``swinir``, ``hat`` or ``dat``; UNet2D has
no reference format) or one written by ``cli/train.py`` /
``cli/finetune.py``, which carries its config (``--model`` is then
ignored), and whose raw parameters it loads (never its EMA, as the JAX
CLI).  Orbax checkpoints are read after
``tpu_superresolution_tpu.cli.export_torch`` writes them as a reference
``.pt``.  ``--dp N`` splits each image's tile batch across N GPUs, one
process a GPU started by ``torchrun --nproc_per_node N`` (tiling, auto
or ``--tile``, is required); rank 0 alone writes the PNGs.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import Optional

import torch

from tpu_superresolution_torch.cli.common import (
    add_device_flag,
    init_data_parallel,
    report_device,
    resolve_device,
)

# Auto-tiling threshold on the LONG edge: whole-image forward at or
# below it, tiled above it.
AUTO_TILE_MIN_EDGE = 256
AUTO_TILE = 192
AUTO_OVERLAP = 16
AUTO_TILE_BATCH = 8

MODEL_CHOICES = ("ms_resunet", "unet2d", "swinir", "hat", "dat")


def auto_tile(h: int, w: int) -> int:
    """0 (whole image) up to the long-edge threshold, else the tile."""
    return AUTO_TILE if max(h, w) > AUTO_TILE_MIN_EDGE else 0


def exact_config(mcfg):
    """`mcfg` with the reference-exact semantics: no fused reconstruction,
    erf GELU (fields a family does not have are left alone)."""
    fields = {f.name for f in dataclasses.fields(mcfg)}
    return dataclasses.replace(mcfg, **{k: False for k in ("fused_reconstruct",
                                                           "gelu_approximate") if k in fields})


def load_port_checkpoint(path: str, saved, exact, ema, device: torch.device,
                         dtype: Optional[torch.dtype] = None):
    """A checkpoint of ``train/checkpoint.py`` (`saved`, the dictionary
    read from `path`) into the port: its embedded config (``exact``
    forces the reference-exact semantics) and its parameters, or its EMA
    parameters with the saved buffers.  `ema` None is auto (the evaluate
    CLI's default): the EMA when the run recorded an ``ema_decay``, since
    its best checkpoints were chosen by validating the EMA weights.
    Returns (model_config, model)."""
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
            print(f"[ckpt] the checkpoint records ema_decay={extra['ema_decay']}: using the "
                  "EMA weights its best checkpoints were chosen by")
    if use_ema:
        if saved.get("ema") is None:
            raise SystemExit(f"--ema: no EMA in {path} (train with --ema_decay to keep one)")
        state.update(saved["ema"])  # parameters only; buffers stay the saved ones
        print("[ckpt] using EMA weights")
    model = build_model(mcfg, dtype=dtype or serving_dtype(device))
    model.load_state_dict(state, strict=True)
    print(f"[ckpt] {path}: model={mcfg.name} epoch={extra.get('epoch')} "
          f"(exact={bool(exact)})")
    return mcfg, model.to(device).eval()


def load_any_checkpoint(ckpt: str, model_name: str, scale_int: int, exact=None,
                        device: Optional[torch.device] = None,
                        dtype: Optional[torch.dtype] = None, ema=None):
    """Load a ``.pt/.pth`` checkpoint into the port.  Returns
    (model_config, model).

    A checkpoint of the port's train / finetune CLI carries its config
    and loads by ``load_port_checkpoint`` (`ema` None: its EMA when the
    run kept one; `exact` None keeps the semantics it was trained with).
    A reference checkpoint of family `model_name` gets its architecture
    inferred from the tensor shapes; `exact=None` means exact for those:
    no fused reconstruction, erf GELU (DAT's GELUs are always erf).  It
    carries one weight set, so a true `ema` is refused."""
    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.core.dtypes import serving_dtype
    from tpu_superresolution_torch.interop import (
        CONFIG_INFERENCE,
        extract_state_dict,
        strip_reference_buffers,
    )
    from tpu_superresolution_torch.train.checkpoint import read_checkpoint

    if not ckpt.endswith((".pt", ".pth")):
        raise SystemExit(
            f"{ckpt}: the PyTorch port loads .pt/.pth checkpoints only; write an Orbax "
            "checkpoint as a reference .pt with `python -m "
            "tpu_superresolution_tpu.cli.export_torch --ckpt DIR --out m.pt` and load that"
        )
    device = resolve_device(device)
    saved = read_checkpoint(ckpt)
    if isinstance(saved, dict) and saved.get("config") is not None:
        return load_port_checkpoint(ckpt, saved, exact, ema, device, dtype)
    if ema:
        raise SystemExit("--ema applies to the port's own checkpoints only; reference "
                         ".pt/.pth files carry a single weight set")
    if model_name not in CONFIG_INFERENCE:
        raise SystemExit(
            f"--model {model_name}: no reference checkpoint format exists for this family "
            f"({ckpt} carries no config); load a checkpoint of the port's train CLI")
    sd = strip_reference_buffers(extract_state_dict(saved))
    mcfg = CONFIG_INFERENCE[model_name](sd, scale_int)
    if exact is None or exact:
        mcfg = exact_config(mcfg)
    model = build_model(mcfg, dtype=dtype or serving_dtype(device))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    print(f"[ckpt] {ckpt}: reference checkpoint, model={mcfg.name} "
          f"(exact={exact is None or bool(exact)})")
    return mcfg, model.to(device).eval()


def load_for_inference(ckpt: str, model_name: str, scale_arg, exact,
                       device: Optional[torch.device] = None,
                       dtype: Optional[torch.dtype] = None):
    """Shared upscale/serve loading: returns (mcfg, model, scale,
    convention, channels).  `scale_arg` is the CLI's 'X2'/'X4'/None.  A
    port checkpoint loads its raw parameters, not its EMA (the JAX
    ``load_any_checkpoint``'s ``restored["params"]``)."""
    if scale_arg is None:
        raise SystemExit("--scale is required for torch .pt/.pth checkpoints")
    scale_int = int(scale_arg[1:])
    mcfg, model = load_any_checkpoint(ckpt, model_name, scale_int, exact, device, dtype,
                                      ema=False)
    if mcfg.scale != scale_int:
        raise SystemExit(f"checkpoint is X{mcfg.scale} but --scale {scale_arg} was given")
    convention = "native_lr" if mcfg.upsamples_internally else "pre_upscale"
    return mcfg, model, mcfg.scale, convention, mcfg.in_channels


class ForwardCache:
    """Per-(tile, overlap) whole-image forwards sharing one loaded model
    (used by this CLI and cli/serve.py), FIFO-bounded so client-chosen
    tiling configs cannot grow it without bound.  With a data-parallel
    `mesh` the tile batch is split across its ranks."""

    def __init__(self, model, scale, convention, tile_batch, max_entries=8, mesh=None):
        self.model, self.scale, self.convention = model, scale, convention
        self.tile_batch, self.max_entries, self.mesh = tile_batch, max_entries, mesh
        self._cache = {}

    def get(self, tile, overlap):
        from tpu_superresolution_torch.core.config import EvalConfig
        from tpu_superresolution_torch.evaluate.runner import Evaluator

        if not tile and self.mesh is not None:
            raise SystemExit("--dp requires tiling (the image is below the auto-tile "
                             "threshold; pass --tile N)")
        key = (tile, overlap)
        if key not in self._cache:
            if len(self._cache) >= self.max_entries:
                self._cache.pop(next(iter(self._cache)))
            ecfg = EvalConfig(
                batch_size=1,
                tile_size=tile or None,
                tile_overlap=overlap,
                max_tile_batch=self.tile_batch or None,
            )
            self._cache[key] = Evaluator(self.model, self.scale, self.convention, ecfg,
                                         mesh=self.mesh).forward_fn()
        return self._cache[key]


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--image", type=str, nargs="+", required=True, help="input image file(s)")
    ap.add_argument("--ckpt", type=str, required=True,
                    help="a reference .pt/.pth or a checkpoint of the port's train / finetune "
                         "CLI")
    ap.add_argument("--model", type=str, default="ms_resunet", choices=MODEL_CHOICES,
                    help="family of a reference checkpoint (the port's own carry their config)")
    ap.add_argument("--scale", type=str, choices=["X2", "X4"], required=True)
    ap.add_argument("--out", type=str, default=None,
                    help="output file (single input) or directory (default: next to "
                         "each input as <stem>_srNx.png)")
    ap.add_argument("--tile", type=int, default=-1,
                    help=f"-1 = auto (whole image if the long edge is <= "
                         f"{AUTO_TILE_MIN_EDGE}px, else tile {AUTO_TILE}); 0 = whole "
                         "image; N = tile size")
    ap.add_argument("--tile_overlap", type=int, default=AUTO_OVERLAP)
    ap.add_argument("--tile_batch", type=int, default=AUTO_TILE_BATCH,
                    help="max tiles per model call (0 = all in one batch)")
    ap.add_argument("--exact", action=argparse.BooleanOptionalAction, default=None,
                    help="reference-exact semantics (chain reconstruction, erf GELU); "
                         "default ON for torch checkpoints; --no-exact gives the "
                         "serving path (fused reconstruction, tanh GELU)")
    ap.add_argument("--rescale_png", action="store_true",
                    help="min-max rescale the output instead of clamping")
    ap.add_argument("--dp", type=int, default=0,
                    help="shard the tile batch across N devices, one process a device under "
                         "torchrun (requires tiling, auto or explicit; -1 = every rank)")
    add_device_flag(ap)
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)

    from tpu_superresolution_torch.data.decode import decode_image
    from tpu_superresolution_torch.evaluate.runner import save_tensor_as_png
    from tpu_superresolution_torch.parallel.mesh import is_writer

    dp, device = init_data_parallel(args.dp, args.device)
    report_device(device)
    mcfg, model, scale, convention, channels = load_for_inference(
        args.ckpt, args.model, args.scale, args.exact, device
    )
    print(f"[ckpt] {args.ckpt}: model={mcfg.name} scale=X{scale}")

    mesh = None
    if dp:
        from tpu_superresolution_torch.parallel import make_mesh

        mesh = make_mesh(dp, device)
        print(f"[dp] sharded tiled inference over {dp} devices")
    writer = is_writer()  # rank 0 alone writes the PNGs
    multi = len(args.image) > 1
    out_dir = None
    if args.out is not None and (multi or Path(args.out).is_dir()):
        out_dir = Path(args.out)
        if writer:
            out_dir.mkdir(parents=True, exist_ok=True)
    fwd_cache = ForwardCache(model, scale, convention, args.tile_batch, mesh=mesh)

    outs, used_names = [], set()
    for path in args.image:
        p = Path(path)
        img = decode_image(p, grayscale=channels == 1, channels=channels)
        h, w = img.shape[:2]
        tile = args.tile if args.tile >= 0 else auto_tile(h, w)
        fwd = fwd_cache.get(tile, args.tile_overlap)
        t0 = time.time()
        sr = fwd(torch.from_numpy(img)[None].to(device))[0].cpu().numpy()
        dt = time.time() - t0
        if out_dir is not None:
            out_path = out_dir / f"{p.stem}_sr{scale}x.png"
            k = 1
            while str(out_path) in used_names:  # same stem, different dir
                out_path = out_dir / f"{p.stem}_sr{scale}x_{k}.png"
                k += 1
            used_names.add(str(out_path))
        elif args.out is not None:
            out_path = Path(args.out)
        else:
            out_path = p.with_name(f"{p.stem}_sr{scale}x.png")
        if writer:
            save_tensor_as_png(sr, out_path, per_image_rescale=args.rescale_png)
        mode = f"tile {tile}/{args.tile_overlap}" if tile else "whole image"
        print(f"[sr] {p} [{h}x{w}] -> {out_path} [{h * scale}x{w * scale}] "
              f"({mode}, {dt:.1f}s incl. kernel build)")
        outs.append(str(out_path))
    return outs


if __name__ == "__main__":
    main()
