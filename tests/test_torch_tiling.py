"""Tiled whole-image inference of the port against the JAX package:
the tile grid, the blend, max_tile_batch chunking, narrow images, and
the forward entry point (Evaluator.forward_fn) with the x8 ensemble."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import (
    TOL,
    perturbed_jax_swinir,
    port_from_jax,
    small_swinir_config,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("size,tile,overlap",
                         [(256, 64, 8), (240, 192, 16), (64, 64, 8), (50, 16, 4), (9, 16, 2)])
def test_tile_grid_matches_jax(size, tile, overlap):
    from tpu_superresolution_tpu.evaluate.tiling import tile_grid as jax_grid
    from tpu_superresolution_torch.evaluate.tiling import tile_grid

    assert tile_grid(size, tile, overlap) == jax_grid(size, tile, overlap)


def _jax_elementwise(x):  # [N, t, t, C] -> [N, 2t, 2t, C]
    y = jnp.repeat(jnp.repeat(x, 2, axis=1), 2, axis=2)
    return jnp.sin(3.0 * y) + 0.5 * y


def _torch_elementwise(x):
    y = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return torch.sin(3.0 * y) + 0.5 * y


@pytest.mark.parametrize(
    "hw,tile,overlap,mtb",
    [((40, 36), 16, 4, None), ((40, 36), 16, 4, 3), ((12, 50), 16, 4, 2), ((20, 20), 32, 4, None)],
    ids=["one-batch", "chunked", "narrow", "whole"],
)
def test_tiled_forward_elementwise_matches_jax(hw, tile, overlap, mtb):
    from tpu_superresolution_tpu.evaluate.tiling import tiled_forward as jax_tiled
    from tpu_superresolution_torch.evaluate.tiling import tiled_forward

    x = np.random.default_rng(0).random((2, hw[0], hw[1], 3), dtype=np.float32)
    want = np.asarray(jax_tiled(_jax_elementwise, jnp.asarray(x), 2, tile, overlap, mtb))
    got = tiled_forward(_torch_elementwise, torch.from_numpy(x), 2, tile, overlap, mtb).numpy()
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 3)
    assert np.abs(got - want).max() <= 1e-5


@pytest.fixture(scope="module")
def swinir_pair():
    cfg = small_swinir_config(fused_reconstruct=True, gelu_approximate=True)
    model, variables = perturbed_jax_swinir(cfg, (16, 16))
    return cfg, model, variables, port_from_jax(cfg, variables)


def _jax_forward_fn(jmodel, variables, **kw):
    from tpu_superresolution_tpu.core.config import EvalConfig as JaxEvalConfig
    from tpu_superresolution_tpu.evaluate.runner import Evaluator as JaxEvaluator

    fwd = JaxEvaluator(jmodel, variables, 4, "native_lr", JaxEvalConfig(**kw)).forward_fn()
    return lambda x: np.asarray(fwd(jnp.asarray(x)))


@pytest.mark.parametrize("mtb", [None, 2], ids=["tiles", "tiles-chunked"])
def test_forward_fn_matches_jax(swinir_pair, mtb):
    from tpu_superresolution_torch.core.config import EvalConfig
    from tpu_superresolution_torch.evaluate.runner import Evaluator

    cfg, jmodel, variables, tmodel = swinir_pair
    kw = dict(tile_size=16, tile_overlap=4, max_tile_batch=mtb)
    x = np.random.default_rng(2).random((1, 24, 20, 3), dtype=np.float32)
    want = _jax_forward_fn(jmodel, variables, **kw)(x)
    got = Evaluator(tmodel, 4, "native_lr", EvalConfig(**kw)).forward_fn()(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (1, 96, 80, 3)
    assert np.abs(got.numpy() - want).max() <= TOL


def test_self_ensemble_matches_jax_forwards(swinir_pair):
    """x8 ensemble = mean over the 8 dihedral transforms (flip, then k
    quarter turns) of the inverse-transformed forwards, each forward
    held against the JAX package's (one compile: a square image)."""
    from tpu_superresolution_torch.core.config import EvalConfig
    from tpu_superresolution_torch.evaluate.runner import Evaluator

    cfg, jmodel, variables, tmodel = swinir_pair
    kw = dict(tile_size=16, tile_overlap=4)
    x = np.random.default_rng(3).random((1, 24, 24, 3), dtype=np.float32)
    jfwd = _jax_forward_fn(jmodel, variables, **kw)
    acc = 0.0
    for k in range(4):
        for flip in (False, True):
            xi = np.rot90(x[:, :, ::-1] if flip else x, k, axes=(1, 2))
            o = np.rot90(jfwd(np.ascontiguousarray(xi)), -k, axes=(1, 2))
            acc = acc + (o[:, :, ::-1] if flip else o)
    got = Evaluator(tmodel, 4, "native_lr",
                    EvalConfig(self_ensemble=True, **kw)).forward_fn()(torch.from_numpy(x))
    assert np.abs(got.numpy() - acc / 8.0).max() <= TOL


def test_forward_fn_rejects_pre_upscale():
    """The pre_upscale convention, once refused, is now served: LR is
    bicubic-upscaled to the HR size, then tiled at scale 1 (and under the
    x8 ensemble rotated before the upscale), as the JAX package does."""
    from tpu_superresolution_tpu.core.config import EvalConfig as JaxEvalConfig
    from tpu_superresolution_tpu.evaluate.runner import Evaluator as JaxEvaluator
    from tpu_superresolution_torch.core.config import EvalConfig
    from tpu_superresolution_torch.evaluate.runner import Evaluator

    class _Jax:
        def apply(self, variables, x, train=False):
            return jnp.sin(3.0 * x) + 0.5 * x

    x = np.random.default_rng(2).random((2, 12, 10, 3), dtype=np.float32)
    for kw in (dict(), dict(tile_size=16, tile_overlap=4, max_tile_batch=3),
               dict(tile_size=16, tile_overlap=4, self_ensemble=True)):
        want = np.asarray(JaxEvaluator(_Jax(), {}, 4, "pre_upscale",
                                       JaxEvalConfig(**kw)).forward_fn()(jnp.asarray(x)))
        got = Evaluator(lambda t: torch.sin(3.0 * t) + 0.5 * t, 4,
                        eval_config=EvalConfig(**kw)).forward_fn()(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, 48, 40, 3)
        assert np.abs(got - want).max() <= TOL, kw
