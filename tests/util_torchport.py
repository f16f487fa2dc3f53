"""Shared fixtures of the PyTorch-port parity tests: a JAX SwinIR with
seeded, perturbed parameters, and the same weights in the port through
its weight bridge."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

TOL = 3e-5  # fp32 max-abs parity bound (CLAUDE.md conventions)


def small_swinir_config(**kw):
    """A JAX SwinIRConfig at test size (embed 24, depths (2, 2), ws 8)."""
    from tpu_superresolution_tpu.core.config import SwinIRConfig

    base = dict(embed_dim=24, depths=(2, 2), num_heads=(2, 2), window_size=8,
                num_feat=16, attention_impl="jnp", gelu_approximate=False,
                fused_reconstruct=False, scale=4)
    base.update(kw)
    return SwinIRConfig(**base)


def _random_param(path, shape, rng):
    name = str(getattr(path[-1], "key", path[-1]))
    n = rng.standard_normal(shape).astype(np.float32)
    if name == "kernel":  # variance-preserving: O(1) activations
        return n / np.sqrt(np.prod(shape[:-1]))
    if name == "scale":
        return 1.0 + 0.1 * n
    if name == "relative_position_bias_table":
        return 0.5 * n
    return 0.05 * n  # biases, position embeddings


def perturbed_jax_swinir(cfg, hw=(16, 16), seed=0):
    """The JAX SwinIR for `cfg` with seeded random parameters of the
    tree `init` would build (non-zero biases, non-unit norms, a
    non-trivial position bias).  Returns (model, variables) with numpy
    leaves."""
    from tpu_superresolution_tpu.core.config import build_model

    model = build_model(cfg)
    x = jax.ShapeDtypeStruct((1, hw[0], hw[1], cfg.in_channels), jnp.float32)
    shapes = jax.eval_shape(lambda x: model.init(jax.random.key(0), x, train=False), x)
    rng = np.random.default_rng(seed)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: _random_param(p, s.shape, rng), shapes
    )
    return model, variables


def port_from_jax(cfg, variables, dtype=torch.float32):
    """The port's model for the JAX `cfg` (SwinIR or HAT), loaded
    (strict) with the JAX weights through the port's weight bridge."""
    from tpu_superresolution_torch.core.config import build_model, config_from_dict
    from tpu_superresolution_torch.interop import (
        hat_state_dict_from_jax,
        swinir_state_dict_from_jax,
    )

    model = build_model(config_from_dict(cfg.to_dict()), dtype=dtype)
    bridge = hat_state_dict_from_jax if cfg.name.startswith("hat") else swinir_state_dict_from_jax
    sd = bridge(variables)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                          strict=True)
    return model.eval()


def jax_forward(model, variables, x_np):
    return np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x_np)), np.float32)


def port_forward(model, x_np):
    with torch.no_grad():
        return model(torch.from_numpy(x_np)).numpy()
