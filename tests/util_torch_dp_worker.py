"""One rank of ``tests/test_torch_parallel.py``'s CPU worlds, started by
``tpu_superresolution_torch.parallel.launch.run_ranks`` (gloo over a
``file://`` store): reads the setup the test wrote (the port's weights
bridged from the JAX package, the batches), runs its world's checks and
writes what it computed to ``<out>/rank<r>.pt``.  It imports torch and
the port only."""

from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from tpu_superresolution_torch.core.config import TrainConfig, build_model, config_from_dict
from tpu_superresolution_torch.evaluate.tiling import sharded_tiled_forward
from tpu_superresolution_torch.models.blocks import DerivedCache
from tpu_superresolution_torch.parallel import (
    init_multihost,
    make_dp_eval_step,
    make_dp_train_step,
    make_mesh,
    replicate,
    shard_batch,
)
from tpu_superresolution_torch.parallel.data_parallel import batch_norm_stats
from tpu_superresolution_torch.parallel.launch import rank_args
from tpu_superresolution_torch.train.engine import build_optimizer, create_train_state

TCFG = TrainConfig(epochs=1, lr=1e-3, scheduler="none")
EMA = 0.9


def model_from(entry):
    model = build_model(config_from_dict(entry["config"]))
    model.load_state_dict(entry["sd"], strict=True)
    return model


def fresh_state(entry):
    model = model_from(entry)
    opt, sched = build_optimizer(TCFG, 10, model)
    return create_train_state(model, opt, sched, TCFG.grad_clip_norm, EMA)


def detached(sd):
    return {k: v.detach().clone() for k, v in sd.items()}


def train_once(entry, lr, hr, w, mesh):
    """One data-parallel step on the global batch (lr, hr, w) from the
    setup's weights: metrics, parameters and EMA after it."""
    state = replicate(fresh_state(entry), mesh)
    step = make_dp_train_step("mse", "native_lr", 1, None, False, mesh)
    m = step(state, *shard_batch((lr, hr, w), mesh), torch.Generator().manual_seed(3))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state_dict": detached(state.model.state_dict()), "ema": detached(state.ema)}


def bn_step(entry, lr, hr, mesh):
    """The BatchNorm model's step, with the version counters and a
    DerivedCache over its parameters and statistics watched."""
    state = replicate(fresh_state(entry), mesh)
    model = state.model
    stats = batch_norm_stats(model)
    watched = list(model.parameters()) + stats
    # how far a train-mode forward alone moves the statistics' counters
    probe = copy.deepcopy(model).train()
    before = [s._version for s in batch_norm_stats(probe)]
    with torch.no_grad():
        probe(shard_batch(torch.from_numpy(lr), mesh))
    forward_bumps = [s._version - b for s, b in zip(batch_norm_stats(probe), before)]

    builds = []
    cache = DerivedCache()
    with torch.no_grad():
        cache.get(watched, "t", lambda: builds.append(1))
        cache.get(watched, "t", lambda: builds.append(1))
    versions = [t._version for t in watched]
    step = make_dp_train_step("mse", "native_lr", 1, None, False, mesh)
    w = np.ones((lr.shape[0],), np.float32)
    m = step(state, *shard_batch((lr, hr, w), mesh), torch.Generator().manual_seed(4))
    with torch.no_grad():
        cache.get(watched, "t", lambda: builds.append(1))
    n_params = len(list(model.parameters()))
    bumps = [t._version - v for t, v in zip(watched, versions)]
    return {"loss": float(m["loss"]), "state_dict": detached(model.state_dict()),
            "param_bumps": bumps[:n_params], "stat_bumps": bumps[n_params:],
            "forward_bumps": forward_bumps, "builds": len(builds)}


def main():
    rank, world, init_method, rest = rank_args()
    ap = argparse.ArgumentParser()
    ap.add_argument("--setup", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(rest)
    torch.set_num_threads(1)
    setup = torch.load(args.setup, weights_only=False)
    init_multihost("cpu", init_method, world_size=world, rank=rank)
    mesh = make_mesh(world, "cpu")
    res = {"rank": rank, "world": world}

    if world == 2:
        lr, hr = setup["lr"], setup["hr"]
        res["a"] = train_once(setup["unet"], lr, hr, np.ones((lr.shape[0],), np.float32), mesh)
        ev = make_dp_eval_step("mse", "native_lr", 1, mesh)
        res["e"] = {k: float(v) for k, v in ev(model_from(setup["unet"]),
                                                *shard_batch((lr, hr), mesh)).items()}
        # replicate: rank 1 starts from other weights and ends with rank 0's
        model = model_from(setup["unet"])
        if rank:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        tensors = list(model.parameters()) + list(model.buffers())
        versions = [t._version for t in tensors]
        replicate(model, mesh)
        res["replicate"] = {"state_dict": detached(model.state_dict()),
                            "bumps": [t._version - v for t, v in zip(tensors, versions)]}
    if world in (2, 4):
        res["d"] = bn_step(setup["bn"], setup["bn_lr"], setup["bn_hr"], mesh)
    if world == 4:
        lr, hr = setup["lr13"], setup["hr13"]
        n = lr.shape[0]
        idx = np.arange(n + (-n) % world) % n
        w = np.ones((len(idx),), np.float32)
        w[n:] = 0.0
        res["c"] = train_once(setup["unet"], lr[idx], hr[idx], w, mesh)
        sub = make_mesh(2, "cpu")
        try:
            make_mesh(world + 1, "cpu")
            refused = ""
        except ValueError as e:
            refused = str(e)
        res["mesh"] = {"sub_rank": sub.rank, "sub_size": sub.size, "refused": refused}
    if world in (2, 3):
        model = model_from(setup["swinir"]).eval()
        outs = {}
        with torch.no_grad():
            for name, (x, mtb) in setup["tile_cases"].items():
                outs[name] = sharded_tiled_forward(model, torch.from_numpy(x), 4, 8, 2, mesh,
                                                   max_tile_batch=mtb)
        res["f"] = outs
    torch.save(res, f"{args.out}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
