"""Entry points of the port for drivers and smoke checks (the torch
counterpart of the repository's ``__graft_entry__.py``, which drives the
JAX package):

    python -m tpu_superresolution_torch.entry            # entry() once
    python -m tpu_superresolution_torch.entry --dryrun 8 # dryrun_multichip(8)

``entry()`` is the single-device forward of the flagship model;
``dryrun_multichip(n)`` runs the data-parallel paths over n CPU ranks.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

# tiny configs for the dry run (the JAX dry run's): SwinIR x2 at window 4,
# a one-block HAT x2 with non-zero SE widths at embed 16 (with the
# 'pixelshuffle' reconstruction, the port's HAT's only one)
_DRY_SWINIR = dict(scale=2, img_size=16, window_size=4, embed_dim=16, depths=(2,),
                   num_heads=(2,), upsampler="pixelshuffledirect")
_DRY_HAT = dict(scale=2, img_size=16, window_size=4, embed_dim=16, depths=(1,), num_heads=(2,),
                num_feat=16, drop_path_rate=0.0, compress_ratio=2, squeeze_factor=4)


def entry(device: Optional[str] = None):
    """(fn, args): ``fn(*args)`` is the no-grad forward of SwinIR-M x4
    (window 8, depths 6x6, embed 180, the classical config the reference
    fine-tunes) at the serving dtype on a [1, 64, 64, 3] input, with
    weights of seed 0; on the GPU unless `device` is ``"cpu"``."""
    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model
    from tpu_superresolution_torch.core.device import resolve_device
    from tpu_superresolution_torch.core.dtypes import serving_dtype

    dev = resolve_device(device)
    model = build_model(SwinIRConfig(scale=4), dtype=serving_dtype(dev))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    x = torch.zeros((1, 64, 64, 3), dtype=torch.float32, device=dev)

    @torch.no_grad()
    def fn(model, x):
        return model(x)

    return fn, (model, x)


def dryrun_multichip(n_devices: int, timeout_s: float = 600.0) -> None:
    """Run the data-parallel paths over `n_devices` ranks, each a CPU
    process on gloo (as the JAX dry run forces virtual CPU devices): one
    data-parallel train step each of a tiny SwinIR and a tiny HAT on a
    global batch of 2 per rank, then a sharded tiled forward of one
    32^2 image.  Raises if a rank fails; prints one line."""
    from tpu_superresolution_torch.parallel.launch import run_ranks

    outs = run_ranks("tpu_superresolution_torch.entry", n_devices, ["--dryrun_rank"],
                     timeout_s=timeout_s)
    print(outs[0].strip().splitlines()[-1])


def _dryrun_rank(rank: int, world: int, init_method: str) -> None:
    from tpu_superresolution_torch.core.config import (
        HATConfig,
        SwinIRConfig,
        TrainConfig,
        build_model,
    )
    from tpu_superresolution_torch.evaluate.tiling import sharded_tiled_forward
    from tpu_superresolution_torch.parallel import (
        init_multihost,
        make_dp_train_step,
        make_mesh,
        replicate,
        shard_batch,
    )
    from tpu_superresolution_torch.train.engine import build_optimizer, create_train_state

    torch.set_num_threads(1)
    init_multihost("cpu", init_method, world_size=world, rank=rank)
    mesh = make_mesh(world, "cpu")
    rng = np.random.default_rng(0)
    b = 2 * world
    lr = rng.random((b, 16, 16, 3), np.float32)
    hr = rng.random((b, 32, 32, 3), np.float32)
    tcfg = TrainConfig(epochs=1, lr=1e-4, scheduler="none")
    shards = shard_batch((lr, hr, np.ones((b,), np.float32)), mesh)

    losses = {}
    for name, cfg in (("swinir", SwinIRConfig(**_DRY_SWINIR)), ("hat", HATConfig(**_DRY_HAT))):
        model = build_model(cfg)
        model.reset_parameters(torch.Generator().manual_seed(rank))  # replicate() unifies
        opt, sched = build_optimizer(tcfg, 10, model)
        state = replicate(create_train_state(model, opt, sched), mesh)
        step = make_dp_train_step("l1", "native_lr", 2, 8, True, mesh)
        m = step(state, *shards, torch.Generator().manual_seed(1))
        losses[name] = float(m["loss"])
        if not np.isfinite(losses[name]):
            raise RuntimeError(f"{name} dry-run loss not finite: {losses[name]}")
        if name == "swinir":
            swinir = model

    img = torch.from_numpy(rng.random((1, 32, 32, 3), np.float32))
    with torch.no_grad():
        sr = sharded_tiled_forward(swinir.eval(), img, 2, 16, 4, mesh)
    if tuple(sr.shape) != (1, 64, 64, 3) or not bool(torch.isfinite(sr).all()):
        raise RuntimeError(f"sharded tiled output {tuple(sr.shape)} not finite or misshaped")
    print(f"[dryrun_multichip] {world} ranks (gloo, CPU) OK, swinir loss="
          f"{losses['swinir']:.5f}, hat loss={losses['hat']:.5f}, sharded tiled inference OK "
          f"{tuple(sr.shape)}", flush=True)
    torch.distributed.destroy_process_group()


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--dryrun_rank" in argv:
        from tpu_superresolution_torch.parallel.launch import rank_args

        rank, world, init_method, _ = rank_args(argv)
        _dryrun_rank(rank, world, init_method)
    elif "--dryrun" in argv:
        dryrun_multichip(int(argv[argv.index("--dryrun") + 1]))
    else:
        fn, args = entry("cpu" if "--cpu" in argv else None)
        out = fn(*args)
        print("entry:", tuple(out.shape), out.dtype)


if __name__ == "__main__":
    main()
