"""Test-set evaluation: metrics, PNG dumps and the inference entry
point (port of ``tpu_superresolution_tpu/evaluate/runner.py``).

Capability parity with the reference evaluate CLI (evaluate.py:54-234):
a peek-batch sanity print, a non-finite prediction raise with its
statistics (:172-178), the bilinear realign when the output size differs
from HR (:181-184), PSNR and SSIM in fp32, per-sample PNG dumps by the
first-N / every-Nth-from-start / explicit-index rules (:63-70, 199-225)
as ``idx_{i:06d}_{lr,hr,sr}.png``, the wall time and MPix/s.  Also the
tiled whole-image forward and the x8 geometric self-ensemble
(``EvalConfig.self_ensemble``).  On a GPU, the MFU of the steady window
against the card's dense bf16 peak (``utils/flops.py``).  With a
data-parallel `mesh` (``parallel.make_mesh``) every rank evaluates the
same batches with the tile batch split across the ranks
(``sharded_tiled_forward``); rank 0 alone writes the PNGs.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from tpu_superresolution_torch.core.config import EvalConfig
from tpu_superresolution_torch.core.device import resolve_device
from tpu_superresolution_torch.data.transforms import pre_upscale_batch
from tpu_superresolution_torch.evaluate.tiling import sharded_tiled_forward, tiled_forward
from tpu_superresolution_torch.ops.metrics import batch_psnr, ssim
from tpu_superresolution_torch.ops.resize import resize_bilinear


def tensor_to_pil(x: np.ndarray, per_image_rescale: bool = False):
    """[H, W, C] float -> PIL image (min-max rescale option, else clamp
    to [0, 1])."""
    from PIL import Image

    x = np.asarray(x, dtype=np.float32)
    if per_image_rescale:
        mn, mx = float(x.min()), float(x.max())
        x = np.zeros_like(x) if mx <= mn + 1e-8 else (x - mn) / (mx - mn)
    else:
        x = np.clip(x, 0.0, 1.0)
    arr = (x * 255.0 + 0.5).astype(np.uint8)
    if arr.shape[-1] == 1:
        return Image.fromarray(arr[..., 0], mode="L")
    return Image.fromarray(arr, mode="RGB")


def save_tensor_as_png(x: np.ndarray, path, per_image_rescale: bool = False):
    tensor_to_pil(x, per_image_rescale).save(str(path))


def _geo(x: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    """One of the 8 dihedral transforms of an NHWC batch (flip, then k
    quarter turns over the spatial axes)."""
    if flip:
        x = x.flip(2)
    if k:
        x = torch.rot90(x, k, dims=(1, 2))
    return x


def _geo_inv(x: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    if k:
        x = torch.rot90(x, -k, dims=(1, 2))
    if flip:
        x = x.flip(2)
    return x


def _save_decision(i: int, cfg: EvalConfig) -> bool:
    """The reference's selection rules (evaluate.py:63-70, 199-207):
    save_indices first, then save_every from save_start, else the first
    save_n samples."""
    if cfg.save_indices:
        return i in cfg.save_indices
    if cfg.save_every:
        return i >= cfg.save_start and (i - cfg.save_start) % cfg.save_every == 0
    return i < cfg.save_n


@dataclass
class Evaluator:
    model: nn.Module
    scale: int
    convention: str = "pre_upscale"  # model input convention
    eval_config: EvalConfig = field(default_factory=EvalConfig)
    log: Callable[[str], None] = print
    # where ``run`` puts the batches: None is the GPU (an error without one)
    device: Union[None, str, torch.device] = None
    mesh: object = None  # parallel.Mesh: shard each image's tile batch across its ranks

    def forward_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """[B, H, W, C] -> [B, H*s, W*s, C] fp32 (the pre-upscale, tiling
        and the x8 self-ensemble per the eval config), under
        ``torch.no_grad``.  With a mesh the tiles are sharded, and an
        untiled config raises (sharding splits the tile batch)."""
        ecfg = self.eval_config
        s = self.scale if self.convention == "native_lr" else 1
        if self.mesh is not None and not ecfg.tile_size:
            raise ValueError("sharded inference needs tiling: set EvalConfig.tile_size")

        def pipeline(lr: torch.Tensor) -> torch.Tensor:
            if self.convention == "pre_upscale":
                lr = pre_upscale_batch(lr, self.scale)
            if self.mesh is not None:
                out = sharded_tiled_forward(self.model, lr, s, ecfg.tile_size,
                                            ecfg.tile_overlap, self.mesh,
                                            max_tile_batch=ecfg.max_tile_batch)
            elif ecfg.tile_size:
                out = tiled_forward(self.model, lr, s, ecfg.tile_size, ecfg.tile_overlap,
                                    max_tile_batch=ecfg.max_tile_batch)
            else:
                out = self.model(lr)
            return out.float()

        def run(lr: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                if not ecfg.self_ensemble:
                    return pipeline(lr)
                # each dihedral variant is pre-upscaled (and tiled) after
                # its rotation, as the JAX package's pipeline does
                acc = None
                for k in range(4):
                    for flip in (False, True):
                        o = _geo_inv(pipeline(_geo(lr, k, flip).contiguous()), k, flip)
                        acc = o if acc is None else acc + o
                return acc / 8.0

        return run

    def run(self, loader, save_dir: Optional[str] = None) -> Dict[str, float]:
        """Evaluate over a loader of (lr, hr) numpy batches: dataset-mean
        PSNR and SSIM, the PNG dumps, ``wall_s``, ``compile_s`` (the first
        call at each new batch shape, which on the GPU holds the kernels'
        build and cuDNN's choice) and ``mpix_per_s``: the output pixels of
        the other batches over the wall time less the whole iterations of
        those first batches, so that only the steady window's work counts,
        over its own time (0 when every batch was a first at its shape;
        the JAX package's counts every batch's pixels over the wall time
        less ``compile_s``).  The metrics stay on the device and are read
        back once a batch.  On a GPU without a mesh also ``flops``, the
        steady window's FLOPs (``utils.flops.torch_flops`` of the whole forward pipeline,
        once a batch shape, after the loop), and ``mfu``, those FLOPs over
        the steady window's time against ``PEAK_BF16_FLOPS``: a lower
        bound on the model's own utilisation, since the window holds the
        metrics, the host copies and the PNG dumps too."""
        ecfg = self.eval_config
        device = resolve_device(self.device)
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
        fwd = self.forward_fn()
        if self.mesh is not None:
            from tpu_superresolution_torch.parallel.mesh import is_writer

            save_dir = save_dir if is_writer() else None
        if save_dir:
            Path(save_dir).mkdir(parents=True, exist_ok=True)

        psnr_sum = ssim_sum = n = 0.0
        steady_pixels = 0
        t0 = time.perf_counter()
        compile_t = first_t = 0.0  # the first calls; the first batches' iterations
        shapes = set()
        steady_shapes: Dict[tuple, int] = {}
        idx = 0
        for lr_np, hr_np in loader:
            ti = time.perf_counter()
            first = lr_np.shape not in shapes
            lr = torch.from_numpy(lr_np).to(device)
            hr = torch.from_numpy(hr_np).to(device, torch.float32)
            if idx == 0:
                self.log(
                    f"[peek] lr min/max: {np.nanmin(lr_np):.4f} {np.nanmax(lr_np):.4f} "
                    f"| hr min/max: {np.nanmin(hr_np):.4f} {np.nanmax(hr_np):.4f} "
                    f"| shapes: {tuple(lr_np.shape)} {tuple(hr_np.shape)}"
                )
            if first:
                # the first call at a batch shape builds and plans: timed
                # apart, and its batch kept out of the steady window
                shapes.add(lr_np.shape)
                sync()
                tc = time.perf_counter()
                out = fwd(lr)
                sync()
                compile_t += time.perf_counter() - tc
            else:
                out = fwd(lr)
            sr = out  # saved before the realign, as the reference does

            # the bilinear realign (evaluate.py:181-184)
            if out.shape[1:3] != hr.shape[1:3]:
                out = resize_bilinear(out, hr.shape[1], hr.shape[2], antialias=False)
            b = lr.shape[0]
            finite, p_sum, s_sum = torch.stack([
                torch.isfinite(sr).all().float(), batch_psnr(out, hr).sum(),
                ssim(out.clamp(0.0, 1.0), hr.clamp(0.0, 1.0)) * b,
            ]).tolist()
            if not finite:  # evaluate.py:172-178
                out_np = sr.cpu().numpy()
                ok = np.isfinite(out_np)
                fv = out_np[ok]
                raise RuntimeError(
                    f"Non-finite predictions: share={1.0 - ok.mean():.4f}, "
                    f"finite_min={fv.min() if fv.size else float('nan')}, "
                    f"finite_max={fv.max() if fv.size else float('nan')}"
                )
            psnr_sum += p_sum
            ssim_sum += s_sum
            n += b

            saves = [i for i in range(b) if save_dir and _save_decision(idx + i, ecfg)]
            if saves:
                lr_vis = (pre_upscale_batch(lr, self.scale) if self.convention == "native_lr"
                          else lr).cpu().numpy()
                hr_np32, sr_np = hr.cpu().numpy(), sr.cpu().numpy()
                for i in saves:
                    stem = Path(save_dir) / f"idx_{idx + i:06d}"
                    save_tensor_as_png(lr_vis[i], f"{stem}_lr.png", ecfg.rescale_png)
                    save_tensor_as_png(hr_np32[i], f"{stem}_hr.png", ecfg.rescale_png)
                    save_tensor_as_png(sr_np[i], f"{stem}_sr.png", ecfg.rescale_png)
            idx += b
            if first:
                first_t += time.perf_counter() - ti
            else:
                steady_pixels += int(np.prod(out.shape[:3]))
                steady_shapes[lr_np.shape] = steady_shapes.get(lr_np.shape, 0) + 1

        wall = time.perf_counter() - t0
        steady = max(wall - first_t, 1e-9)
        results = {
            "psnr": psnr_sum / max(n, 1.0),
            "ssim": ssim_sum / max(n, 1.0),
            "n": int(n),
            "wall_s": wall,
            "compile_s": compile_t,
            "mpix_per_s": steady_pixels / 1e6 / steady,
        }
        if device.type == "cuda" and steady_shapes and self.mesh is None:
            self._add_mfu(results, steady_shapes, steady)
        self.log(
            f"[done] n={results['n']} PSNR {results['psnr']:.2f} dB | "
            f"SSIM {results['ssim']:.4f} | {wall:.1f}s "
            f"({results['mpix_per_s']:.1f} MPix/s steady"
            + (f", MFU {results['mfu']:.2%}" if "mfu" in results else "") + ")"
        )
        return results

    def _add_mfu(self, results: Dict[str, float], steady_shapes: Dict[tuple, int],
                 steady: float) -> None:
        """``flops`` and ``mfu`` into `results`; where the count fails, one
        line that says why, and neither key."""
        from tpu_superresolution_torch.utils.flops import mfu, torch_flops

        def pipeline(model, x):
            return dataclasses.replace(self, model=model).forward_fn()(x)

        try:
            flops = sum(torch_flops(self.model, shape, pipeline) * count
                        for shape, count in steady_shapes.items())
        except Exception as e:
            self.log(f"[mfu] not reported: the FLOP count failed ({type(e).__name__}: {e})")
            return
        results["flops"] = flops
        results["mfu"] = mfu(flops, steady)
