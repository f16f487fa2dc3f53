"""DAT training in the PyTorch port against the JAX package's train
steps, fp32 on the CPU (the JAX module chain through its Pallas kernels
in interpret mode, as in ``tests/test_torch_dat_train.py``):

- two engine steps against the JAX train steps, with and without EMA
  (EMA over parameters; the EMA evaluation with the live statistics);
- eval after a step against the JAX eval on the updated statistics, and
  the kernels' folded weights rebuilt after the in-place update;
- ``train --model dat`` on the CPU.

Bounds: loss and grad norm per step rtol 1e-4; statistics after the
first step 3e-5 max abs, after the second 1e-4 (its forward ran on
weights within 3 lr of each other); parameters and EMA after the steps
within 3 lr (the first Adam update is about lr * sign(g)); eval 3e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dat import perturbed_jax_dat, port_dat
from tests.test_torch_dat_train import (  # noqa: F401  (jax_dat_kernels: a fixture)
    HW,
    _assert_stats_close,
    jax_dat_kernels,
    train_config,
)
from tests.util_torchport import TOL

torch.set_num_threads(1)


def _jax_and_port_states(cfg, variables, tcfg_kw, ema_decay, steps_per_epoch=2):
    from tpu_superresolution_tpu.core.config import TrainConfig as JaxTrainConfig
    from tpu_superresolution_tpu.core.config import build_model as jax_build_model
    from tpu_superresolution_tpu.train.engine import build_optimizer as jax_build_optimizer
    from tpu_superresolution_tpu.train.engine import create_train_state as jax_create_state
    from tpu_superresolution_torch.core.config import TrainConfig
    from tpu_superresolution_torch.train.engine import build_optimizer, create_train_state

    jtcfg, tcfg = JaxTrainConfig(**tcfg_kw), TrainConfig(**tcfg_kw)
    jmodel = jax_build_model(cfg)
    jparams = jax.tree.map(jnp.asarray, variables["params"])
    jstats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    jstate = jax_create_state(jmodel, jparams, jstats,
                              jax_build_optimizer(jtcfg, steps_per_epoch, jparams),
                              ema_decay=ema_decay)
    model = port_dat(cfg, variables)
    opt, sched = build_optimizer(tcfg, steps_per_epoch, model)
    state = create_train_state(model, opt, sched, tcfg.grad_clip_norm, ema_decay)
    return jmodel, jstate, state, tcfg


@pytest.mark.parametrize("ema_decay", [None, 0.9], ids=["no-ema", "ema"])
def test_dat_train_steps_match_jax(ema_decay, jax_dat_kernels):
    """Two engine steps (L1, AdamW with weight decay, cosine schedule,
    clip) against the JAX package's make_train_step on the same batches:
    loss and grad norm per step, the parameters, the running statistics
    and the EMA after them; with EMA, the validation step on the EMA
    parameters and the live statistics against the JAX eval step on
    ``state.replace(params=ema_params)``."""
    from tpu_superresolution_tpu.train.engine import make_eval_step as jax_make_eval_step
    from tpu_superresolution_tpu.train.engine import make_train_step as jax_make_train_step
    from tpu_superresolution_torch.interop import dat_state_dict_from_jax
    from tpu_superresolution_torch.train.engine import (
        _model_copy,
        ema_state_dict,
        make_eval_step,
        make_train_step,
    )

    cfg = train_config()
    _, variables = perturbed_jax_dat(cfg, seed=34)
    base = dict(epochs=2, batch_size=2, loss="l1", lr=2e-4, weight_decay=0.05,
                scheduler="cosine", min_lr=2e-5, grad_clip_norm=0.05, finetune=True)
    jmodel, jstate, state, tcfg = _jax_and_port_states(cfg, variables, base, ema_decay)
    jstep = jax_make_train_step(jmodel, "l1", "native_lr", 2, None, False)
    step = make_train_step("l1", "native_lr", 2, None, False)
    model = state.model
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    for i in range(2):
        rng = np.random.default_rng(40 + i)
        lr = rng.random((2, *HW, 3), dtype=np.float32)
        hr = rng.random((2, 2 * HW[0], 2 * HW[1], 3), dtype=np.float32)
        jstate, jm = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr), jax.random.key(i))
        m = step(state, lr, hr, torch.Generator().manual_seed(i))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        assert bool(m["finite"]) and bool(jm["finite"])
        if i == 0:  # the first forward ran on identical weights: identical statistics
            _assert_stats_close(model, jstate.batch_stats, variables)
    assert state.step == int(jstate.step) == 2
    jvars = {"params": jax.tree.map(np.asarray, jstate.params),
             "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)}
    jsd = dat_state_dict_from_jax(jvars)
    for name, p in model.named_parameters():
        diff = float(np.abs(p.detach().numpy() - jsd[name]).max())
        assert diff <= 3 * tcfg.lr, f"{name}: {diff:.3e} > 3 lr"
        assert not torch.equal(p, start[name]), f"{name} was not updated"
    # the second forward ran on weights within 3 lr of each other
    _assert_stats_close(model, jstate.batch_stats, variables, bound=1e-4)
    if ema_decay is None:
        assert state.ema is None and jstate.ema_params is None
        return
    assert sorted(state.ema) == sorted(n for n, _ in model.named_parameters())
    jema = dat_state_dict_from_jax({"params": jax.tree.map(np.asarray, jstate.ema_params),
                                    "batch_stats": jvars["batch_stats"]})
    for name, e in state.ema.items():
        diff = float(np.abs(e.numpy() - jema[name]).max())
        assert diff <= 3 * tcfg.lr, f"EMA {name}: {diff:.3e} > 3 lr"
    # validation: EMA parameters with the live statistics, both sides
    rng = np.random.default_rng(50)
    lr = rng.random((1, *HW, 3), dtype=np.float32)
    hr = rng.random((1, 2 * HW[0], 2 * HW[1], 3), dtype=np.float32)
    jeval = jax_make_eval_step(jmodel, "l1", "native_lr", 2)(
        jstate.replace(params=jstate.ema_params), jnp.asarray(lr), jnp.asarray(hr))
    eval_model = _model_copy(model)
    eval_model.load_state_dict(ema_state_dict(state))
    for name, buf in model.named_buffers():
        assert torch.equal(dict(eval_model.named_buffers())[name], buf), name
    got = make_eval_step("l1", "native_lr")(eval_model, lr, hr)
    np.testing.assert_allclose(float(got["loss"]), float(jeval["loss"]), rtol=1e-3)
    np.testing.assert_allclose(float(got["psnr_sum"]), float(jeval["psnr_sum"]), rtol=1e-4)


def test_dat_eval_after_a_step_matches_jax(jax_dat_kernels):
    """One JAX train step, then: the port loaded with the updated
    parameters and statistics in eval() mode against the JAX eval on
    them; and a port that ran the step itself and was evaluated before
    it, evaluated again after, against a fresh port loaded with its
    state: the kernels' folded weights (K14's conv branch, K10's spatial
    map, here through their plain versions) follow the in-place update of
    the running statistics (``DerivedCache`` keys on the version
    counters)."""
    from tpu_superresolution_tpu.train.engine import make_train_step as jax_make_train_step
    from tpu_superresolution_torch.core.config import build_model, config_from_dict
    from tpu_superresolution_torch.interop import dat_state_dict_from_jax
    from tpu_superresolution_torch.train.engine import make_train_step

    cfg = train_config()
    _, variables = perturbed_jax_dat(cfg, seed=35)
    base = dict(epochs=1, batch_size=2, loss="l1", lr=1e-4, scheduler="none")
    jmodel, jstate, state, _ = _jax_and_port_states(cfg, variables, base, None, 1)
    rng = np.random.default_rng(36)
    lr = rng.random((2, *HW, 3), dtype=np.float32)
    hr = rng.random((2, 2 * HW[0], 2 * HW[1], 3), dtype=np.float32)
    x = torch.from_numpy(rng.random((1, 20, 28, 3), dtype=np.float32))
    model = state.model.eval()
    with torch.no_grad():
        before = model(x)  # builds and caches the folded weights
    jstate, _ = jax_make_train_step(jmodel, "l1", "native_lr", 2, None, False)(
        jstate, jnp.asarray(lr), jnp.asarray(hr), jax.random.key(0))
    make_train_step("l1", "native_lr", 2, None, False)(state, lr, hr,
                                                       torch.Generator().manual_seed(0))

    jvars = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x.numpy()), train=False))
    fresh = port_dat(cfg, jax.tree.map(np.asarray, jvars))
    assert fresh.routes()[0][1] == ("K14", "K10")
    with torch.no_grad():
        assert np.abs(fresh(x).numpy() - want).max() <= TOL
    model.eval()
    reloaded = build_model(config_from_dict(cfg.to_dict()))
    reloaded.load_state_dict(model.state_dict())
    with torch.no_grad():
        after, ref = model(x), reloaded(x)
    assert torch.allclose(after, ref, atol=1e-6, rtol=0)
    assert (after - before).abs().max() > 1e-4
    assert sorted(dat_state_dict_from_jax(jax.tree.map(np.asarray, jvars))) == sorted(
        model.state_dict())


def test_train_cli_dat_on_cpu(tmp_path):
    """``train --model dat --device cpu`` with EMA on a tiny synthetic
    set: steps, checkpoints and a report; the checkpoint serves through
    upscale; --window_size, a field DAT's config lacks, exits."""
    from PIL import Image

    from tests.util_fakedata import make_deeprock_dataset
    from tpu_superresolution_torch.cli.train import main
    from tpu_superresolution_torch.cli.upscale import main as upscale

    root = tmp_path / "data"
    make_deeprock_dataset(root, scale="X4", n_per_split=4, hr_size=64)
    workdir = tmp_path / "run"
    tiny = ["--embed_dim", "32", "--t_depths", "2", "--t_heads", "2", "--patch_size", "16",
            "--batch_size", "2", "--epochs", "1", "--loss", "l1"]
    trainer, state = main(["--data_root", str(root), "--scale", "X4", "--model", "dat",
                           "--device", "cpu", "--workdir", str(workdir), "--ema_decay", "0.9"]
                          + tiny)
    assert state.step == 2 and trainer.model_config.name == "dat"
    assert sorted(state.ema) == sorted(n for n, _ in state.model.named_parameters())
    assert np.isfinite(trainer.history["train"][0]) and np.isfinite(trainer.best_val_psnr)
    for name in ("best_X4.pth", "bestpsnr_X4.pth", "run_X4.json"):
        assert (workdir / name).exists(), name
    src = tmp_path / "in.png"
    Image.fromarray((np.random.default_rng(0).random((15, 17, 3)) * 255).astype(np.uint8)).save(
        src)
    out = tmp_path / "out.png"
    assert upscale(["--image", str(src), "--ckpt", str(workdir / "best_X4.pth"), "--model",
                    "dat", "--scale", "X4", "--out", str(out), "--device", "cpu"]) == [str(out)]
    with Image.open(out) as im:
        assert im.size == (68, 60)
    with pytest.raises(SystemExit, match="window_size"):
        main(["--data_root", str(root), "--scale", "X4", "--model", "dat", "--device", "cpu",
              "--workdir", str(tmp_path / "bad"), "--window_size", "8"] + tiny)
