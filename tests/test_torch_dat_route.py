"""DAT's per-block route in the PyTorch port (``models.dat.dat_route``)
and the module chain at the shapes DAT's serving kernels refuse, against
the JAX package, fp32 on the CPU (every port kernel runs its plain
version there; the route decides which code runs):

- the route by shape: K9 / K14 / K10 where their limits take a block
  (DATConfig()'s widths), the module chain where they do not (the
  published DAT x4's split (8, 32) and expansion 4, C > 192, hd > 32),
  and the module chain for every block in training;
- the port at eval against the JAX module chain where the kernels
  refuse: expansion 4 behind K9 / K14 fronts (a kernel front with a
  module tail), a split whose s0 * s1 is not 128 (module front, K10
  tail), and the published x4's split (8, 32) with expansion 4;
- the fully fused route kept covered: split (8, 16), N 128, where the
  port's K9, K14 and K10 plain versions run end to end, against the JAX
  module chain and its fused forward in interpret mode.

Bound: 3e-5 max abs."""

import numpy as np
import pytest
import torch

from tests.test_torch_dat import (  # noqa: F401  (jax_switches: a fixture)
    jax_switches,
    perturbed_jax_dat,
    port_dat,
    small_dat_config,
)
from tests.util_torchport import TOL, jax_forward, port_forward

torch.set_num_threads(1)


def test_dat_route_by_shape():
    from tpu_superresolution_torch.core.config import DATConfig, build_model
    from tpu_superresolution_torch.models.dat import dat_route

    # DATConfig(): C 180, 6 heads, split (8, 16), hidden 360
    assert dat_route(True, 180, 6, (8, 16), 360, False) == ("K9", "K10")
    assert dat_route(False, 180, 6, (8, 16), 360, False) == ("K14", "K10")
    # the published DAT x4: split (8, 32), expansion 4 (SGFN half 360)
    assert dat_route(True, 180, 6, (8, 32), 720, False) == ("chain", "chain")
    assert dat_route(False, 180, 6, (8, 32), 720, False) == ("K14", "chain")
    # wider than the kernels, or heads of more than 32 dims
    assert dat_route(True, 240, 6, (8, 16), 480, False) == ("chain", "chain")
    assert dat_route(False, 240, 8, (8, 16), 480, False) == ("chain", "chain")
    assert dat_route(True, 128, 2, (8, 16), 256, False) == ("chain", "K10")  # hd 64
    # training: the module chain everywhere
    assert dat_route(True, 180, 6, (8, 16), 360, True) == ("chain", "chain")
    assert dat_route(False, 180, 6, (8, 16), 360, True) == ("chain", "chain")

    x4 = build_model(DATConfig(split_size=(8, 32), expansion_factor=4.0, depths=(2,),
                               num_heads=(6,)))
    assert x4.routes() == [[("chain", "chain"), ("K14", "chain")]]
    assert x4.train().routes() == [[("chain", "chain"), ("chain", "chain")]]
    assert build_model(DATConfig(depths=(2,), num_heads=(6,))).routes() == [
        [("K9", "K10"), ("K14", "K10")]]


# embed 112 with 4 heads (hd 28): K9 and K14 take the fronts; expansion 4
# gives an SGFN half of 224 > 192, which K10 refuses
_REFUSED = [
    (dict(embed_dim=112, num_heads=(4, 4), split_size=(8, 16), expansion_factor=4.0),
     [("K9", "chain"), ("K14", "chain")], (2, 32, 32)),
    (dict(), [("chain", "K10"), ("K14", "K10")], (2, 16, 32)),
    (dict(embed_dim=112, num_heads=(4, 4), split_size=(8, 32), expansion_factor=4.0),
     [("chain", "chain"), ("K14", "chain")], (1, 20, 36)),
]


@pytest.mark.parametrize("overrides,routes,shape", _REFUSED,
                         ids=["kernel-fronts-module-tails", "split-4x8", "split-8x32-exp4"])
def test_dat_module_chain_where_the_kernels_refuse(overrides, routes, shape):
    """The port at eval, routed per block, against the JAX module chain
    (its fused switches off) on the same weights and input."""
    from tpu_superresolution_torch.kernels import read_counters, reset_counters

    cfg = small_dat_config(scale=4, upsampler="pixelshuffle", **overrides)
    model, variables = perturbed_jax_dat(cfg, seed=60)
    x = np.random.default_rng(61).random((*shape, 3), dtype=np.float32)
    want = jax_forward(model, variables, x)
    port = port_dat(cfg, variables)
    assert port.routes() == [routes, routes]
    reset_counters()
    got = port_forward(port, x)
    assert not any(read_counters().values())
    assert got.shape == want.shape == (shape[0], 4 * shape[1], 4 * shape[2], 3)
    assert np.abs(got - want).max() <= TOL


def test_dat_fused_route_matches_jax_fused_and_chain(jax_switches):
    """Split (8, 16), N 128, on a 32 x 32 image: every block takes K9 or
    K14 and K10 (their plain versions on the CPU), against the JAX module
    chain and the JAX forward with its fused kernels on (interpret
    mode; its shifted block stays on the module chain, whose strip layout
    wants eight windows a strip)."""
    cfg = small_dat_config(split_size=(8, 16))
    model, variables = perturbed_jax_dat(cfg, seed=62)
    x = np.random.default_rng(63).random((1, 32, 32, 3), dtype=np.float32)
    chain = jax_forward(model, variables, x)
    jax_switches("on")
    fused = jax_forward(model, variables, x)
    port = port_dat(cfg, variables)
    assert port.routes() == [[("K9", "K10"), ("K14", "K10")]] * 2
    got = port_forward(port, x)
    assert got.shape == chain.shape == fused.shape == (1, 64, 64, 3)
    assert np.abs(got - chain).max() <= TOL
    assert np.abs(got - fused).max() <= TOL
    assert np.abs(chain - fused).max() > 0  # the JAX fused kernels did run
