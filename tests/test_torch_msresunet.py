"""MS_ResUNet in the PyTorch port against the JAX package, fp32 on the
CPU, with the same weights through ``msresunet_state_dict_from_jax``:

- the parameter count of the published geometry, 24,918,369;
- the full-width eval forward on [1, 32, 32, 1] within 1e-4 max abs (the
  JAX package's own bound against the reference model);
- at layers (1, 1, 1, 1) on odd sides (the centre crops after each
  transposed conv take an odd row): the eval forward within 3e-5, and
  one train-mode forward / backward: the loss within 1e-5 relative and
  the BatchNorm running statistics (flax's rules: the biased batch
  variance, momentum 0.9) within 1e-5 of the JAX package's; the
  gradients against the JAX package's in float64, each within 2e-3 of
  its largest entry, and within 1e-4 of the JAX fp32 gradient where that
  one is itself within 1e-5 of float64 (the 8 parameters named in
  ``_WELL_CONDITIONED``, past the last chained max-pools; the set is
  asserted, so it cannot shrink unseen).  Many of these gradients are
  ill-conditioned in fp32 (deep cancellation against a random target):
  the JAX package's own fp32 gradients are up to 3.4e-2 of their max
  away from its float64 ones (upCT3's), the port's 1.1e-3;
- config inference from a state dict, and the reference's vestigial
  ``up_ps*`` keys dropped before a strict load.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import TOL

torch.set_num_threads(2)


def _jax_msresunet(layers, seed, hw=(32, 32)):
    """The JAX MS_ResUNet with seeded random parameters (kernels at
    torch's default scale, std 1 / sqrt(3 fan_in), so the activations stay
    O(1) through the residual stages; non-zero biases, non-unit
    BatchNorm scales) and running statistics (means ~0.1, variances in
    [0.5, 1.5])."""
    from tpu_superresolution_tpu.core.config import MSResUNetConfig, build_model

    cfg = MSResUNetConfig(layers=layers)
    model = build_model(cfg)
    x = jax.ShapeDtypeStruct((1, hw[0], hw[1], 1), jnp.float32)
    shapes = jax.eval_shape(lambda x: model.init(jax.random.key(0), x, train=False), x)
    rng = np.random.default_rng(seed)

    def param(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        n = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(3 * np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "mean":
            return 0.1 * n
        if name == "var":
            return (0.5 + rng.random(s.shape)).astype(np.float32)
        return 0.05 * n

    return cfg, model, jax.tree_util.tree_map_with_path(param, shapes)


def _port(cfg, variables):
    from tpu_superresolution_torch.core.config import build_model, config_from_dict
    from tpu_superresolution_torch.interop import msresunet_state_dict_from_jax

    model = build_model(config_from_dict(cfg.to_dict()))
    sd = msresunet_state_dict_from_jax(variables)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                          strict=True)
    return model


def test_param_count_is_the_published_one():
    from tpu_superresolution_torch.core.config import MSResUNetConfig, build_model

    model = build_model(MSResUNetConfig())
    assert sum(p.numel() for p in model.parameters()) == 24_918_369


def test_full_width_eval_forward_matches_jax():
    """As the JAX package's own parity test: torch's default
    initialisation (the port's, seeded), converted by the JAX package's
    ``convert_msresunet`` and brought back by the port's bridge, which
    gives the same state dict."""
    from tpu_superresolution_tpu.core.config import MSResUNetConfig, build_model as jax_build
    from tpu_superresolution_tpu.interop import convert_msresunet
    from tpu_superresolution_torch.core.config import build_model

    src = build_model(MSResUNetConfig())
    src.reset_parameters(torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    variables = convert_msresunet(sd)
    port = _port(MSResUNetConfig(), variables)
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert np.array_equal(v.numpy(), sd[k]), k
    x = np.random.default_rng(1).standard_normal((1, 32, 32, 1)).astype(np.float32)
    want = np.asarray(jax_build(MSResUNetConfig()).apply(variables, x, train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 32, 32, 1)
    assert np.abs(got - want).max() <= 1e-4


@pytest.fixture(scope="module")
def narrow():
    cfg, jmodel, variables = _jax_msresunet((1, 1, 1, 1), seed=2, hw=(34, 30))
    x = np.random.default_rng(3).standard_normal((2, 34, 30, 1)).astype(np.float32)
    hr = np.random.default_rng(4).standard_normal((2, 34, 30, 1)).astype(np.float32)
    return cfg, jmodel, variables, x, hr


def test_narrow_eval_forward_matches_jax(narrow):
    cfg, jmodel, variables, x, _ = narrow
    want = np.asarray(jmodel.apply(variables, x, train=False))
    with torch.no_grad():
        got = _port(cfg, variables)(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= TOL


def _jax_train_grads(jmodel, variables, x, hr):
    """(loss, updated batch_stats, gradients as a port state dict) of one
    train-mode MSE forward / backward of the JAX model."""
    from tpu_superresolution_torch.interop import msresunet_state_dict_from_jax

    def loss_fn(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                                train=True, mutable=["batch_stats"])
        return jnp.mean((out - hr) ** 2), mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    sd = msresunet_state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, grads),
                                        "batch_stats": variables["batch_stats"]})
    return float(loss), stats, sd


_WELL_CONDITIONED = {
    "mflow_conv_g4_b.0.2_conv_relu_varout_dimred.weight",
    "mflow_conv_g4_b.0.3_conv.weight",
    "mflow_conv_g4_b.0.3_conv.bias",
    "mflow_conv_g4_b.0.3_conv_relu_varout_dimred.weight",
    "clf_conv1.weight",
    "clf_conv1.bias",
    "clf_conv2.weight",
    "clf_conv2.bias",
}


def test_narrow_train_step_matches_jax(narrow):
    from tpu_superresolution_tpu.models.msresunet import build_msresunet
    from tpu_superresolution_torch.interop import batch_stats_from_state_dict

    cfg, jmodel, variables, x, hr = narrow
    jloss, jstats, want32 = _jax_train_grads(jmodel, variables, x, hr)
    with jax.enable_x64():
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        _, _, want64 = _jax_train_grads(build_msresunet(cfg, dtype=jnp.float64), v64,
                                        x.astype(np.float64), hr.astype(np.float64))

    model = _port(cfg, variables).train()
    out = model(torch.from_numpy(x))
    loss = ((out - torch.from_numpy(hr)) ** 2).mean()
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= 1e-5 * abs(jloss)

    grads = dict(model.named_parameters())
    assert set(grads) <= set(want64)
    well_conditioned = set()
    for name, p in grads.items():
        g, ref = p.grad.numpy().astype(np.float64), want64[name]
        scale = np.abs(ref).max()
        assert np.abs(g - ref).max() <= 2e-3 * scale, name
        if np.abs(want32[name] - ref).max() <= 1e-5 * scale:
            well_conditioned.add(name)
            assert np.abs(g - want32[name]).max() <= 1e-4 * scale, name
    # JAX's fp32 gradients are within 1.7e-6 of float64 (of each max) past
    # the last refine stage's chained max-pools, and at least 2.1e-4 off
    # before them (the other 139 parameters): the tight check covers these
    assert well_conditioned == _WELL_CONDITIONED

    got_stats = batch_stats_from_state_dict("ms_resunet", model.state_dict(), variables)
    flat_got = jax.tree_util.tree_leaves_with_path(got_stats)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray,
                                                                                jstats)))
    assert len(flat_got) == len(flat_want) > 0
    for path, v in flat_got:
        assert np.abs(v - flat_want[path]).max() <= 1e-5, jax.tree_util.keystr(path)


def test_config_inference_and_vestigial_keys(narrow):
    from tpu_superresolution_torch.core.config import build_model
    from tpu_superresolution_torch.interop import (
        infer_msresunet_config,
        msresunet_state_dict_from_jax,
        strip_reference_buffers,
    )

    cfg, _, variables, _, _ = narrow
    sd = msresunet_state_dict_from_jax(variables)
    got = infer_msresunet_config(sd, 4)
    assert got.layers == (1, 1, 1, 1) and got.scale == 4 and got.name == "ms_resunet"
    sd["up_ps2.weight"] = np.zeros((4, 4), np.float32)  # the commented-out PixelShuffle's
    build_model(got).load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in strip_reference_buffers(sd).items()}, strict=True)
    with pytest.raises(ValueError, match="not an MS_ResUNet checkpoint"):
        infer_msresunet_config({"conv_first.weight": np.zeros(1)}, 4)
    wide = dict(sd, **{"conv1.weight": np.zeros((64, 1, 5, 5), np.float32)})
    with pytest.raises(ValueError, match="conv1 out=64"):
        infer_msresunet_config(wide, 4)
