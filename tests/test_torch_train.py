"""Training parity of the port with the JAX package, fp32 on the CPU
(every kernel wrapper runs its plain version there):

- whole-model gradients of an L1 loss against ``jax.grad`` of the JAX
  SwinIR (drop path off), every parameter included, mapped through the
  weight bridge (the gradient tree has the parameters' structure);
- one to three engine steps against the JAX package's
  ``make_train_step`` on the same pre-cropped batches;
- freezing by regex leaves the frozen parameters unchanged, as the JAX
  package's optax mask does.

Bounds: gradients max |diff| <= 1e-3 * max |grad| of the tensor + 1e-7
(fp32 sums in another order, and the composed reconstruction's sums);
loss and grad norm per step rtol 1e-4; parameters after the steps within
3 lr (the first Adam update is about lr * sign(g), so a gradient that
differs by rounding where it is near zero moves a parameter by up to 2
lr the other way)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import perturbed_jax_swinir, port_from_jax, small_swinir_config

torch.set_num_threads(1)


def _batch(seed, hw=(16, 16), b=2, scale=4):
    rng = np.random.default_rng(seed)
    lr = rng.random((b, hw[0], hw[1], 3), dtype=np.float32)
    hr = rng.random((b, hw[0] * scale, hw[1] * scale, 3), dtype=np.float32)
    return lr, hr


def _assert_grad_close(got, want, name):
    bound = 1e-3 * float(np.abs(want).max()) + 1e-7
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{name}: max |diff| {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "composed"])
def test_model_gradients_match_jax(fused):
    from tpu_superresolution_torch.interop import swinir_state_dict_from_jax

    cfg = small_swinir_config(drop_path_rate=0.0, fused_reconstruct=fused)
    jmodel, variables = perturbed_jax_swinir(cfg, seed=11)
    lr, hr = _batch(12)

    def loss_fn(params):
        out = jmodel.apply({"params": params}, jnp.asarray(lr), train=True)
        return jnp.mean(jnp.abs(out.astype(jnp.float32) - jnp.asarray(hr)))

    jloss, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    want = swinir_state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)})

    model = port_from_jax(cfg, variables).train()
    out = model(torch.from_numpy(lr))
    loss = (out - torch.from_numpy(hr)).abs().mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in model.named_parameters():
        assert p.grad is not None, f"{name} got no gradient"
        assert torch.isfinite(p.grad).all(), name
        _assert_grad_close(p.grad.numpy(), want[name], name)


def _jax_state(cfg, variables, tcfg, steps_per_epoch):
    from tpu_superresolution_tpu.core.config import build_model
    from tpu_superresolution_tpu.train.engine import build_optimizer, create_train_state

    model = build_model(cfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = build_optimizer(tcfg, steps_per_epoch, params)
    return model, create_train_state(model, params, {}, tx)


def _configs(**kw):
    from tpu_superresolution_tpu.core.config import TrainConfig as JaxTrainConfig
    from tpu_superresolution_torch.core.config import TrainConfig

    base = dict(epochs=2, batch_size=2, loss="l1", lr=1e-3, weight_decay=0.05,
                scheduler="cosine", min_lr=1e-4, grad_clip_norm=0.05, finetune=True)
    base.update(kw)
    return JaxTrainConfig(**base), TrainConfig(**base)


def _run_both(jtcfg, tcfg, n_steps, seed=21, same_grad_norm=True):
    from tpu_superresolution_tpu.train.engine import make_train_step as jax_make_train_step
    from tpu_superresolution_torch.interop import swinir_state_dict_from_jax
    from tpu_superresolution_torch.train.engine import (
        build_optimizer,
        create_train_state,
        make_train_step,
    )

    cfg = small_swinir_config(drop_path_rate=0.0)
    _, variables = perturbed_jax_swinir(cfg, seed=seed)
    steps_per_epoch = 2
    jmodel, jstate = _jax_state(cfg, variables, jtcfg, steps_per_epoch)
    jstep = jax_make_train_step(jmodel, jtcfg.loss, "native_lr", 4, None, False)

    model = port_from_jax(cfg, variables)
    opt, sched = build_optimizer(tcfg, steps_per_epoch, model)
    state = create_train_state(model, opt, sched, tcfg.grad_clip_norm)
    step = make_train_step(tcfg.loss, "native_lr", 4, None, False)

    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for i in range(n_steps):
        lr, hr = _batch(100 + i)
        jstate, jm = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr), jax.random.key(i))
        m = step(state, lr, hr, torch.Generator().manual_seed(i))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)
        if same_grad_norm:
            np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        assert bool(m["finite"]) and bool(jm["finite"])
    assert state.step == int(jstate.step) == n_steps
    jparams = swinir_state_dict_from_jax({"params": jax.tree.map(np.asarray, jstate.params)})
    return model, start, jparams


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps_match_jax(n_steps):
    jtcfg, tcfg = _configs()
    model, start, jparams = _run_both(jtcfg, tcfg, n_steps)
    moved = 0
    for name, p in model.state_dict().items():
        diff = float(np.abs(p.numpy() - jparams[name]).max())
        assert diff <= 3 * tcfg.lr, f"{name}: {diff:.3e} > 3 lr"
        moved += not torch.equal(p, start[name])
    assert moved == len(start)  # every parameter was updated


def test_frozen_parameters_do_not_update_like_jax():
    """The port's regex over torch names and the JAX package's over Flax
    paths freeze the same tensors; both leave them exactly unchanged and
    update the rest the same way.  (The reported grad norms differ: the
    JAX package's covers the frozen tensors too.)"""
    jtcfg, _ = _configs(freeze_regex=r"layers_0/|conv_first")
    _, tcfg = _configs(freeze_regex=r"^layers\.0\.|^conv_first\.")
    model, start, jparams = _run_both(jtcfg, tcfg, 2, same_grad_norm=False)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen and all(n.startswith(("layers.0.", "conv_first.")) for n in frozen)
    assert len(frozen) == sum(n.startswith(("layers.0.", "conv_first.")) for n in start)
    for name, p in model.state_dict().items():
        if name in frozen:
            assert torch.equal(p, start[name]), name
            np.testing.assert_array_equal(jparams[name], start[name].numpy(), err_msg=name)
        else:
            assert float(np.abs(p.numpy() - jparams[name]).max()) <= 3 * tcfg.lr, name
