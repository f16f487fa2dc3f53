"""DAT training in the PyTorch port against the JAX package, fp32 on the
CPU (every port kernel runs its plain version there).  The JAX side runs
its module chain through its Pallas kernels in interpret mode: the
depthwise convs through ``dwconv3x3_halo`` (K11, ``DWCONV3X3_IMPL``
"halo") and the rect-window branches through ``batched_window_attention``
(K16, ``attention_impl="pallas"``).  Embed 32, depths (2, 2), heads
(2, 2), split (4, 8), drop path 0 unless stated; group 1's j = 0 block is
shifted.

- the train-mode forward and the updated BatchNorm running statistics
  (flax's rules: biased batch variance, momentum 0.9) against
  ``apply(train=True, mutable=["batch_stats"])``, at batch 2 and 1;
- every parameter's gradient against ``jax.grad``;
- stochastic depth on both residuals of a block;
- the hand-written BatchNorm against flax's.
(Engine steps, eval after a step and the CLI are
``tests/test_torch_dat_train_steps.py``.)

Bounds: forwards and statistics 3e-5 max abs; model gradients max |diff|
<= 1e-3 * max |grad| + 1e-7 (fp32 sums in another order), and a conv
bias that feeds a train-mode BatchNorm, whose gradient is zero in exact
arithmetic, within its layer's weight bound of zero on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dat import perturbed_jax_dat, port_dat, small_dat_config
from tests.util_torchport import TOL

torch.set_num_threads(1)

HW = (16, 32)  # 16 windows a branch: the JAX K16's mask groups of 8
# the 1x1 / depthwise conv biases that feed a BatchNorm
BN_FED_BIASES = ("attn.dwconv.0.bias", "attn.channel_interaction.1.bias",
                 "attn.spatial_interaction.0.bias")


@pytest.fixture
def jax_dat_kernels():
    """The JAX DAT's depthwise convs through dwconv3x3_halo (interpret
    mode on the CPU); restored afterwards."""
    from tpu_superresolution_tpu.models import blocks

    old = blocks.DWCONV3X3_IMPL
    blocks.DWCONV3X3_IMPL = "halo"
    yield
    blocks.DWCONV3X3_IMPL = old


def train_config(**kw):
    return small_dat_config(attention_impl="pallas", **kw)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _assert_stats_close(model, jax_stats, variables, bound=TOL):
    from tpu_superresolution_torch.interop import dat_batch_stats_from_state_dict

    got = _flat(dat_batch_stats_from_state_dict(model.state_dict(), variables))
    want = _flat(jax_stats)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        err = float(np.abs(got[path] - w).max())
        assert err <= bound, f"{'/'.join(path)}: {err:.3e} > {bound:.3e}"


def _assert_grad_close(got, want, name):
    bound = 1e-3 * float(np.abs(want).max()) + 1e-7
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{name}: max |diff| {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("batch", [2, 1])
def test_dat_train_forward_and_statistics_match_jax(batch, jax_dat_kernels):
    """The port in train() mode against the JAX DAT with train=True: the
    output, and every BatchNorm's running mean and variance after the
    update (the channel gate's statistics come from the batch alone: at
    batch 1 its variance is 0, which torch's BatchNorm refuses)."""
    cfg = train_config()
    jmodel, variables = perturbed_jax_dat(cfg, seed=30)
    x = np.random.default_rng(31).random((batch, *HW, 3), dtype=np.float32)
    want, mutated = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    model = port_dat(cfg, variables).train()
    assert all(r == ("chain", "chain") for layer in model.routes() for r in layer)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - np.asarray(want)).max() <= TOL
    _assert_stats_close(model, mutated["batch_stats"], variables)


@pytest.mark.parametrize("overrides", [dict(), dict(scale=4, upsampler="pixelshuffle",
                                                    fused_reconstruct=True)],
                         ids=["x2-direct", "x4-composed"])
def test_dat_gradients_match_jax(overrides, jax_dat_kernels):
    """Every parameter's gradient of an L1 loss through the port's DAT in
    train mode against jax.grad of the JAX DAT with train=True, at batch
    3: at batch 2 the channel gate's BatchNorm normalises two values per
    channel, and the fp32 gradient of its fc1 is ill-conditioned there
    (JAX's own differs from a float64 evaluation by up to 2.5e-3 of its
    max, more than the bound; the engine-step test keeps batch 2)."""
    from tpu_superresolution_torch.interop import dat_state_dict_from_jax

    cfg = train_config(**overrides)
    jmodel, variables = perturbed_jax_dat(cfg, seed=32)
    rng = np.random.default_rng(33)
    s = cfg.scale
    lr = rng.random((3, *HW, 3), dtype=np.float32)
    hr = rng.random((3, HW[0] * s, HW[1] * s, 3), dtype=np.float32)

    def loss_fn(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(lr), train=True, mutable=["batch_stats"])
        return jnp.mean(jnp.abs(out - jnp.asarray(hr)))

    jloss, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    want = dat_state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads),
                                    "batch_stats": variables["batch_stats"]})
    model = port_dat(cfg, variables).train()
    loss = (model(torch.from_numpy(lr)) - torch.from_numpy(hr)).abs().mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(k for k in want if not k.split(".")[-1].startswith(
        ("running_", "num_batches")))
    grads = {name: p.grad for name, p in model.named_parameters()}
    for name, g in grads.items():
        assert g is not None, f"{name} got no gradient"
        assert torch.isfinite(g).all(), name
        if name.endswith(BN_FED_BIASES):
            # zero in exact arithmetic (the batch mean removes it): both
            # sides must be zero within the bound the layer's weight
            # gradient is held to
            bound = 1e-3 * float(np.abs(want[name[:-4] + "weight"]).max()) + 1e-7
            err = max(float(g.abs().max()), float(np.abs(want[name]).max()))
            assert err <= bound, f"{name}: max |g| {err:.3e} > {bound:.3e}"
        else:
            _assert_grad_close(g.numpy(), want[name], name)


def test_drop_path_reaches_both_residuals():
    """A block with branch scales (s0, s1): s0 multiplies the attention
    residual, s1 the SGFN residual (dat_arch.py:562-563, JAX
    ``models/dat.py:788-795``); the model draws [depth, B, 2] scales per
    group at rates linspace(0, drop_path_rate, sum(depths))."""
    from tpu_superresolution_torch.core.config import DATConfig, build_model

    model = build_model(DATConfig(embed_dim=32, depths=(2, 2), num_heads=(2, 2),
                                  split_size=(4, 8), num_feat=16, drop_path_rate=0.4))
    model.reset_parameters(torch.Generator().manual_seed(7))
    np.testing.assert_allclose(model.drop_path_rates(), np.linspace(0, 0.4, 4), rtol=1e-6)
    model.train()
    x = torch.randn(2, 16, 32, 32, generator=torch.Generator().manual_seed(8))
    for blk in (model.layers[0].blocks[0], model.layers[1].blocks[1]):  # spatial, channel
        run = lambda s0, s1: blk(x, branch_scales=torch.tensor([[s0, s1], [s0, s1]]))
        with torch.no_grad():
            assert torch.equal(run(0.0, 0.0), x)
            a1, a2 = run(1.0, 0.0) - x, run(2.0, 0.0) - x
            m1, m2 = run(0.0, 1.0) - x, run(0.0, 2.0) - x
        assert a1.abs().max() > 1e-3 and m1.abs().max() > 1e-3
        assert torch.allclose(a2, 2 * a1, atol=1e-5) and torch.allclose(m2, 2 * m1, atol=1e-5)
    scales = model.sample_branch_scales(3, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(s.shape) for s in scales] == [(2, 3, 2), (2, 3, 2)]
    assert torch.all(scales[0][0] == 1.0)  # rate 0: never dropped
    img = torch.rand(2, 16, 32, 3)
    with torch.no_grad():
        a = model(img, generator=torch.Generator().manual_seed(0))
        b = model(img, generator=torch.Generator().manual_seed(0))
        c = model(img, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_batchnorm_follows_flax_rules():
    """blocks.BatchNorm in train() mode: the biased batch variance over
    every axis but the last, the running statistics updated with it at
    momentum 0.9 (flax's), one sample allowed; eval() uses the running
    statistics."""
    from flax import linen as fnn

    from tpu_superresolution_torch.models.blocks import BatchNorm

    rng = np.random.default_rng(9)
    for shape in ((2, 5, 7, 6), (1, 6), (3, 6)):
        x = (rng.standard_normal(shape) * 2 + 1).astype(np.float32)
        scale = (1 + 0.3 * rng.standard_normal(6)).astype(np.float32)
        bias = (0.2 * rng.standard_normal(6)).astype(np.float32)
        mean0 = (0.3 * rng.standard_normal(6)).astype(np.float32)
        var0 = (0.5 + rng.random(6)).astype(np.float32)
        jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
        jvars = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
        want, mut = jbn.apply(jvars, jnp.asarray(x), mutable=["batch_stats"])
        bn = BatchNorm(6)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
            bn.running_mean.copy_(torch.from_numpy(mean0))
            bn.running_var.copy_(torch.from_numpy(var0))
        v0 = bn.running_var._version
        got = bn.train()(torch.from_numpy(x))
        assert bn.running_var._version > v0
        assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= TOL
        for name, w in (("running_mean", mut["batch_stats"]["mean"]),
                        ("running_var", mut["batch_stats"]["var"])):
            assert np.abs(getattr(bn, name).numpy() - np.asarray(w)).max() <= 1e-6, name
        evald = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5).apply(
            {"params": jvars["params"], "batch_stats": mut["batch_stats"]}, jnp.asarray(x))
        got = bn.eval()(torch.from_numpy(x))
        assert np.abs(got.detach().numpy() - np.asarray(evald)).max() <= TOL
