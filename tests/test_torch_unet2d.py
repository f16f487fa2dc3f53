"""UNet2D in the PyTorch port against the JAX package, fp32 on the CPU,
with the same weights through ``unet2d_state_dict_from_jax``: both
upsampling modes (the bilinear x2 without antialias + 1x1 conv, and
flax's 2x2 stride-2 ``ConvTranspose``, whose kernel the bridge flips
for torch's), the residual head, ``norm="none"`` (conv biases, no
BatchNorm); eval forwards within 3e-5 and one train-mode step's
gradients and BatchNorm statistics; the refusal of sides that are not
multiples of 2**depth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import TOL

torch.set_num_threads(2)


def _pair(seed, **kw):
    """(JAX config, JAX model, seeded variables, the port's model)."""
    from tpu_superresolution_tpu.core.config import UNet2DConfig, build_model as jax_build
    from tpu_superresolution_torch.core.config import build_model, config_from_dict
    from tpu_superresolution_torch.interop import unet2d_state_dict_from_jax

    cfg = UNet2DConfig(**dict(dict(base_channels=8, depth=2), **kw))
    jmodel = jax_build(cfg)
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.key(0), x, train=False),
                            jax.ShapeDtypeStruct((1, 16, 16, 1), jnp.float32))
    rng = np.random.default_rng(seed)

    def param(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        n = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(3 * np.prod(s.shape[:-1]))
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "var":
            return (0.5 + rng.random(s.shape)).astype(np.float32)
        return 0.1 * n

    variables = jax.tree_util.tree_map_with_path(param, shapes)
    port = build_model(config_from_dict(cfg.to_dict()))
    sd = unet2d_state_dict_from_jax(variables)
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                         strict=True)
    return cfg, jmodel, variables, port


@pytest.mark.parametrize("kw", [dict(), dict(bilinear=False), dict(residual=True),
                                dict(norm="none", bilinear=False, residual=True),
                                dict(depth=3, base_channels=4)],
                         ids=["bilinear", "convtranspose", "residual", "no_norm", "depth3"])
def test_eval_forward_matches_jax(kw):
    _, jmodel, variables, port = _pair(0, **kw)
    x = np.random.default_rng(1).standard_normal((2, 24, 16, 1)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, x, train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 24, 16, 1)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("bilinear", [True, False])
def test_train_step_matches_jax(bilinear):
    from tpu_superresolution_torch.interop import (
        batch_stats_from_state_dict,
        unet2d_state_dict_from_jax,
    )

    cfg, jmodel, variables, port = _pair(2, bilinear=bilinear, residual=True)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 24, 1)).astype(np.float32)
    hr = rng.standard_normal((2, 16, 24, 1)).astype(np.float32)

    def loss_fn(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                                train=True, mutable=["batch_stats"])
        return jnp.mean((out - hr) ** 2), mut["batch_stats"]

    (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    want = unet2d_state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, jgrads),
                                       "batch_stats": variables["batch_stats"]})
    port.train()
    loss = ((port(torch.from_numpy(x)) - torch.from_numpy(hr)) ** 2).mean()
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    for name, p in port.named_parameters():
        scale = np.abs(want[name]).max()
        assert np.abs(p.grad.numpy() - want[name]).max() <= 1e-4 * scale + 1e-7, name
    got = batch_stats_from_state_dict("unet2d", port.state_dict(), variables)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(jstats), strict=True):
        assert np.abs(a - np.asarray(b)).max() <= 1e-5, jax.tree_util.keystr(path)


def test_sides_not_multiple_of_the_depth_are_refused():
    from tpu_superresolution_torch.core.config import UNet2DConfig, build_model

    model = build_model(UNet2DConfig(base_channels=4, depth=4))
    assert model(torch.zeros(1, 32, 48, 1)).shape == (1, 32, 48, 1)
    with pytest.raises(ValueError, match="divisible by 16"):
        model(torch.zeros(1, 40, 48, 1))
    with pytest.raises(ValueError, match="norm"):
        build_model(UNet2DConfig(norm="group"))
