"""DAT's per-block route in the PyTorch port (``models.dat.dat_route``)
and the module chain at the shapes DAT's serving kernels refuse, against
the JAX package, fp32 on the CPU (every port kernel runs its plain
version there; the route decides which code runs):

- the route by shape: K9 / K14 / K10 where their limits take a block
  (DATConfig()'s widths; K9 and K10 also the published DAT x4's split
  (8, 32) and expansion 4, SGFN half 360), the module chain where they do
  not (K9 past N 256 or at a split whose sides do not divide each other,
  C > 192, hd > 32, an SGFN half > 384), and the module chain for every
  block in training;
- the port at eval against the JAX module chain, routed per block: an
  SGFN half past 384 behind K9 / K14 fronts (a kernel front with a module
  tail), a split whose s0 * s1 is not a multiple of 64 and one of N 512
  (module front, K10 tail), and the published x4's split (8, 32) with
  expansion 4 (K9's plain version, K10 tail);
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
    assert dat_route(True, 180, 6, (8, 32), 720, False) == ("K9", "K10")
    assert dat_route(False, 180, 6, (8, 32), 720, False) == ("K14", "K10")
    # K9 past N 256, or at sides that do not divide each other
    assert dat_route(True, 180, 6, (16, 32), 720, False) == ("chain", "K10")
    assert dat_route(True, 180, 6, (8, 12), 720, False) == ("chain", "K10")
    # K10's envelope: C <= 192, SGFN half <= 384
    assert dat_route(False, 192, 6, (8, 16), 768, False) == ("K14", "K10")
    assert dat_route(False, 180, 6, (8, 16), 770, False) == ("K14", "chain")
    assert dat_route(False, 208, 8, (8, 16), 416, False) == ("chain", "chain")
    # wider than the kernels, or heads of more than 32 dims
    assert dat_route(True, 240, 6, (8, 16), 480, False) == ("chain", "chain")
    assert dat_route(False, 240, 8, (8, 16), 480, False) == ("chain", "chain")
    assert dat_route(True, 128, 2, (8, 16), 256, False) == ("chain", "K10")  # hd 64
    # training: the module chain everywhere
    assert dat_route(True, 180, 6, (8, 16), 360, True) == ("chain", "chain")
    assert dat_route(False, 180, 6, (8, 16), 360, True) == ("chain", "chain")

    x4 = build_model(DATConfig(split_size=(8, 32), expansion_factor=4.0, depths=(2,),
                               num_heads=(6,)))
    assert x4.routes() == [[("K9", "K10"), ("K14", "K10")]]
    assert x4.train().routes() == [[("chain", "chain"), ("chain", "chain")]]
    assert build_model(DATConfig(depths=(2,), num_heads=(6,))).routes() == [
        [("K9", "K10"), ("K14", "K10")]]


# embed 112 with 4 heads (hd 28): K9 and K14 take the fronts; expansion 7
# gives an SGFN half of 392 > 384, which K10 refuses; at expansion 4 (half
# 224) K10 takes the tails behind the published split's K9 fronts, and
# behind the module fronts of a split of N 512, which K9 refuses
_REFUSED = [
    (dict(embed_dim=112, num_heads=(4, 4), split_size=(8, 16), expansion_factor=7.0),
     [("K9", "chain"), ("K14", "chain")], (2, 32, 32)),
    (dict(), [("chain", "K10"), ("K14", "K10")], (2, 16, 32)),
    (dict(embed_dim=112, num_heads=(4, 4), split_size=(8, 32), expansion_factor=4.0),
     [("K9", "K10"), ("K14", "K10")], (1, 20, 36)),
    (dict(embed_dim=112, num_heads=(4, 4), split_size=(16, 32), expansion_factor=4.0),
     [("chain", "K10"), ("K14", "K10")], (1, 20, 36)),
]


@pytest.mark.parametrize("overrides,routes,shape", _REFUSED,
                         ids=["kernel-fronts-module-tails", "split-4x8", "split-8x32-exp4",
                              "split-16x32-exp4"])
def test_dat_module_chain_where_the_kernels_refuse(overrides, routes, shape):
    """The port at eval, routed per block, against the JAX module chain
    (its fused switches off) on the same weights and input; where K9 now
    takes the published split, its plain version runs in the chain's
    place."""
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
