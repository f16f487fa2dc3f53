"""The port's data parallelism (``tpu_superresolution_torch/parallel``,
``evaluate/tiling.py::sharded_tiled_forward``) on the CPU: gloo worlds
of 2, 3 and 4 ranks, each started once (a module-scoped fixture a world
size, ``parallel.launch.run_ranks`` with its own timeout; every rank is
killed on failure) running ``tests/util_torch_dp_worker.py``, against
the JAX package's shard_map steps on conftest's 8-device CPU mesh
(``make_mesh(2)`` / ``make_mesh(4)``, whose shards match the ranks) and
against the port's own single-device steps, with the same weights
(bridged with ``interop/jax_bridge.py``) and batches:

(a) the dp step at world 2 against the JAX dp step (UNet2D with
    ``norm="none"``, mse, deterministic preprocessing): loss, grad norm
    and psnr within 3e-5, parameters and EMA after the step within 1e-6;
(b) the same step against the port's single-device step on the same
    global batch, within 1e-6, every rank holding the same state;
(c) a ragged batch of 13 at world 4, padded with weight-0 wraps, against
    the single-device step on the 13 rows;
(d) a BatchNorm UNet2D at worlds 2 and 4 (one sample a shard at 4)
    against the JAX dp step: running statistics within 3e-5; the step
    moves every parameter's and statistic's version counter (the
    statistics' further than a train forward alone does) and a
    DerivedCache over them rebuilds; ``replicate`` likewise;
(e) the dp eval step's sums against the single-device step's and the
    JAX dp eval step's;
(f) ``sharded_tiled_forward`` at worlds 2 and 3 on tile counts that need
    dummy pads, with and without ``max_tile_batch``, against
    ``tiled_forward`` and the JAX ``sharded_tiled_forward`` within 3e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import TOL, perturbed_jax_swinir, port_from_jax, small_swinir_config

torch.set_num_threads(2)

PARAM_TOL = 1e-6
TILE_CASES = {"b1": (1, None), "b1_mtb2": (1, 2), "b2_mtb3": (2, 3)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX models and variables, the port's weights bridged from them
    and the batches; written where the worlds read them."""
    from tests.test_torch_unet2d import _pair

    rng = np.random.default_rng(11)
    unet = _pair(5, norm="none")
    bn = _pair(6)
    scfg = small_swinir_config(embed_dim=12, depths=(1,), num_heads=(2,), window_size=4,
                               num_feat=8)
    _, svars = perturbed_jax_swinir(scfg, hw=(8, 8), seed=7)
    swinir = port_from_jax(scfg, svars)
    s = {
        "lr": rng.random((4, 16, 16, 1), np.float32),
        "hr": rng.random((4, 16, 16, 1), np.float32),
        "lr13": rng.random((13, 16, 16, 1), np.float32),
        "hr13": rng.random((13, 16, 16, 1), np.float32),
        "bn_lr": rng.standard_normal((4, 16, 16, 1)).astype(np.float32),
        "bn_hr": rng.standard_normal((4, 16, 16, 1)).astype(np.float32),
        "tile_cases": {k: (rng.random((b, 8, 28, 3), np.float32), mtb)
                       for k, (b, mtb) in TILE_CASES.items()},
    }
    for key, (cfg, _, _, port) in (("unet", unet), ("bn", bn)):
        s[key] = {"config": port.config.to_dict(), "sd": port.state_dict()}
    s["swinir"] = {"config": swinir.config.to_dict(), "sd": swinir.state_dict()}
    root = tmp_path_factory.mktemp("dp")
    torch.save(s, root / "setup.pt")
    return root, s, {"unet": unet, "bn": bn, "swinir": (scfg, svars, swinir)}


def _world(root, world):
    from tpu_superresolution_torch.parallel.launch import run_ranks

    out = root / f"world{world}"
    out.mkdir()
    run_ranks("tests.util_torch_dp_worker", world,
              ["--setup", str(root / "setup.pt"), "--out", str(out)], timeout_s=240)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(setup):
    """The three worlds, one after another in a background thread (at
    most four rank processes at a time), while the tests compute the JAX
    references."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(max_workers=1)
    futures = {w: pool.submit(_world, setup[0], w) for w in (2, 4, 3)}
    yield futures
    pool.shutdown(wait=True, cancel_futures=True)


@pytest.fixture(scope="module")
def world2(worlds):
    return worlds[2].result(timeout=300)


@pytest.fixture(scope="module")
def world3(worlds):
    return worlds[3].result(timeout=300)


@pytest.fixture(scope="module")
def world4(worlds):
    return worlds[4].result(timeout=300)


# ------------------------------------------------------------ references


def _jax_state(jmodel, variables, ema=0.9):
    from tpu_superresolution_tpu.core.config import TrainConfig
    from tpu_superresolution_tpu.train.engine import build_optimizer, create_train_state

    tcfg = TrainConfig(epochs=1, lr=1e-3, scheduler="none")
    params = jax.tree.map(lambda a: jnp.array(np.asarray(a)), variables["params"])
    tx = build_optimizer(tcfg, 10, params)
    stats = jax.tree.map(lambda a: jnp.array(np.asarray(a)), variables.get("batch_stats", {}))
    return create_train_state(jmodel, params, stats, tx, ema_decay=ema)


def _jax_dp_step(pair, lr, hr, n_dev, key=3):
    """The JAX package's dp step on make_mesh(n_dev): (metrics, the
    state's parameters and statistics in the port's names, EMA)."""
    from tpu_superresolution_tpu.parallel import (
        make_dp_train_step,
        make_mesh,
        replicate,
        shard_batch,
    )
    from tpu_superresolution_torch.interop import unet2d_state_dict_from_jax

    _, jmodel, variables, _ = pair
    mesh = make_mesh(n_dev)
    state = replicate(_jax_state(jmodel, variables), mesh)
    step = make_dp_train_step(jmodel, "mse", "native_lr", 1, None, False, mesh)
    args = shard_batch((jnp.asarray(lr), jnp.asarray(hr), jnp.ones(lr.shape[0])), mesh)
    state, m = step(state, args[0], args[1], jax.random.key(key), args[2])
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    sd = unet2d_state_dict_from_jax({"params": np_tree(state.params),
                                     "batch_stats": np_tree(state.batch_stats)})
    ema = unet2d_state_dict_from_jax({"params": np_tree(state.ema_params),
                                      "batch_stats": np_tree(state.batch_stats)})
    return {k: float(v) for k, v in m.items()}, sd, ema


def _port_single_step(entry, lr, hr):
    from tests.util_torch_dp_worker import fresh_state
    from tpu_superresolution_torch.train.engine import make_train_step

    state = fresh_state(entry)
    m = make_train_step("mse", "native_lr", 1, None, False)(
        state, lr, hr, torch.Generator().manual_seed(3))
    return {k: float(v) for k, v in m.items()}, state


def _close(got, want, tol, what):
    for k, w in want.items():
        g = got[k].numpy() if torch.is_tensor(got[k]) else np.asarray(got[k])
        assert np.abs(g - np.asarray(w)).max() <= tol, f"{what}: {k}"


def _same_on_every_rank(ranks, key):
    first = ranks[0][key]["state_dict"]
    for r in ranks[1:]:
        for k, v in first.items():
            assert torch.equal(r[key]["state_dict"][k], v), f"rank {r['rank']}: {k}"


# ------------------------------------------------------------------- tests


def test_dp_step_matches_jax_dp_step(setup, worlds, request):
    _, s, pairs = setup
    metrics, sd, ema = _jax_dp_step(pairs["unet"], s["lr"], s["hr"], 2)
    got = request.getfixturevalue("world2")[0]["a"]
    for k in ("loss", "grad_norm", "psnr"):
        assert abs(got["metrics"][k] - metrics[k]) <= 3e-5, (k, got["metrics"][k], metrics[k])
    _close(got["state_dict"], sd, PARAM_TOL, "parameters")
    _close(got["ema"], {k: ema[k] for k in got["ema"]}, PARAM_TOL, "EMA")


def test_dp_step_matches_single_device_step(setup, world2):
    _, s, _ = setup
    metrics, state = _port_single_step(s["unet"], s["lr"], s["hr"])
    _same_on_every_rank(world2, "a")
    got = world2[1]["a"]
    for k in ("loss", "grad_norm", "psnr"):
        assert abs(got["metrics"][k] - metrics[k]) <= PARAM_TOL * max(1.0, abs(metrics[k])), k
    _close(got["state_dict"], state.model.state_dict(), PARAM_TOL, "parameters")
    _close(got["ema"], state.ema, PARAM_TOL, "EMA")


def test_ragged_batch_matches_single_device_step(setup, world4):
    _, s, _ = setup
    metrics, state = _port_single_step(s["unet"], s["lr13"], s["hr13"])
    _same_on_every_rank(world4, "c")
    got = world4[0]["c"]
    for k in ("loss", "grad_norm", "psnr"):
        assert abs(got["metrics"][k] - metrics[k]) <= PARAM_TOL * max(1.0, abs(metrics[k])), k
    _close(got["state_dict"], state.model.state_dict(), PARAM_TOL, "parameters")


@pytest.mark.parametrize("world", [2, 4])
def test_batchnorm_statistics_match_jax_dp_step(setup, worlds, world, request):
    _, s, pairs = setup
    _, sd, _ = _jax_dp_step(pairs["bn"], s["bn_lr"], s["bn_hr"], world, key=4)
    ranks = request.getfixturevalue(f"world{world}")
    _same_on_every_rank(ranks, "d")
    got = ranks[0]["d"]["state_dict"]
    stats = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert stats
    _close(got, {k: sd[k] for k in stats}, TOL, "BatchNorm statistics")


def test_collectives_move_version_counters(world2):
    """A collective writes in place without moving a tensor's version;
    the step's and replicate's copies back move every one, so a
    DerivedCache keyed on them rebuilds."""
    for r in world2:
        d = r["d"]
        assert all(b > 0 for b in d["param_bumps"])
        assert all(b > f for b, f in zip(d["stat_bumps"], d["forward_bumps"], strict=True))
        assert d["builds"] == 2  # built, reused, rebuilt after the step
        assert all(b > 0 for b in r["replicate"]["bumps"])


def test_replicate_broadcasts_rank_zero(setup, world2):
    _, s, _ = setup
    for r in world2:
        for k, v in s["unet"]["sd"].items():
            assert torch.equal(r["replicate"]["state_dict"][k], v), (r["rank"], k)


def test_dp_eval_step_matches_single_and_jax(setup, worlds, request):
    from tests.util_torch_dp_worker import model_from
    from tpu_superresolution_tpu.parallel import make_dp_eval_step, make_mesh, replicate
    from tpu_superresolution_tpu.parallel import shard_batch as jax_shard
    from tpu_superresolution_torch.train.engine import make_eval_step

    _, s, pairs = setup
    single = {k: float(v) for k, v in make_eval_step("mse", "native_lr", 1)(
        model_from(s["unet"]), s["lr"], s["hr"]).items()}
    _, jmodel, variables, _ = pairs["unet"]
    mesh = make_mesh(2)
    step = make_dp_eval_step(jmodel, "mse", "native_lr", 1, mesh)
    jm = step(replicate(_jax_state(jmodel, variables), mesh),
              *jax_shard((jnp.asarray(s["lr"]), jnp.asarray(s["hr"])), mesh))
    for r in request.getfixturevalue("world2"):
        got = r["e"]
        assert got["n"] == single["n"] == float(jm["n"]) == 4.0
        for k in ("loss", "psnr_sum", "ssim_sum"):
            assert abs(got[k] - single[k]) <= 1e-5 * max(1.0, abs(single[k])), (k, "single")
            assert abs(got[k] - float(jm[k])) <= TOL * max(1.0, abs(single[k])), (k, "JAX")


@pytest.mark.parametrize("case", list(TILE_CASES))
@pytest.mark.parametrize("world", [2, 3])
def test_sharded_tiled_forward(setup, worlds, world, case, request):
    """Against tiled_forward in every case; against the JAX function in
    the case with pads and chunks (one JAX compile a world)."""
    from tpu_superresolution_torch.evaluate.tiling import tiled_forward

    _, s, pairs = setup
    scfg, svars, swinir = pairs["swinir"]
    x, mtb = s["tile_cases"][case]
    with torch.no_grad():
        want = tiled_forward(swinir, torch.from_numpy(x), 4, 8, 2, max_tile_batch=mtb).numpy()
    assert want.shape == (x.shape[0], 32, 112, 3)
    ref = None
    if case == "b2_mtb3":
        from tpu_superresolution_tpu.core.config import build_model as jax_build
        from tpu_superresolution_tpu.evaluate.tiling import make_sharded_tiled_apply
        from tpu_superresolution_tpu.parallel import make_mesh

        fn = make_sharded_tiled_apply(jax_build(scfg), svars, 4, 8, 2, make_mesh(world),
                                      max_tile_batch=mtb)
        ref = np.asarray(fn(jnp.asarray(x)))
    for r in request.getfixturevalue(f"world{world}"):
        got = r["f"][case].numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= TOL, f"rank {r['rank']} vs tiled_forward"
        if ref is not None:
            assert np.abs(got - ref).max() <= TOL, f"rank {r['rank']} vs JAX"


def test_make_mesh_sub_group_and_refusal(world4):
    for r in world4:
        m = r["mesh"]
        assert m["sub_size"] == 2
        assert m["sub_rank"] == (r["rank"] if r["rank"] < 2 else -1)
        assert "requested dp=5 > available ranks 4" in m["refused"]
