"""The widths ROADMAP Queue 3 item 1 repaired: Swin and HAT blocks past
the old K7 / K15 / K1t limits (C past 512, heads of more than 64 dims, a
(window, head) of 1024 tokens) route through the port's kernels and
match the JAX package, fp32 on the CPU:

- ``block_route`` and ``k15_route`` take C 576 in 6 heads (hd 96), C 264
  in 2 heads (hd 132) and ws 32 at hd 64;
- a SwinIR and a HAT at C 576 match the JAX jnp path through the weights
  bridge, their K7 calls through the wrapper's kernel path with the
  three kernels' schedules emulated (``tests/test_torch_k7_wg.py``),
  their OCAB's K15 on the emulated kernel path (the "stream" route);
- the plain attention at hd 96 and 132 (K15's, through its kernel path;
  K7's) matches the JAX references.

Bound: 3e-5 max abs (fp32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_k7_wg import k7_emulated  # noqa: F401 (a fixture)
from tests.test_torch_wide_routes import k15_emulated  # noqa: F401 (a fixture)
from tests.util_torchport import (
    TOL,
    jax_forward,
    perturbed_jax_swinir,
    port_forward,
    port_from_jax,
    small_swinir_config,
)

torch.set_num_threads(1)

_REPAIRED = [
    # (ws, C, heads): the shapes that raised before
    (8, 576, 6),    # C 576 (K1t's and the product's old C 512), hd 96
    (8, 264, 2),    # hd 132: P V in passes
    (32, 128, 2),   # ws 32 (1024 tokens) at hd 64: keys stream
]


@pytest.mark.parametrize("ws,c,heads", _REPAIRED,
                         ids=[f"ws{w}-C{c}-h{h}" for w, c, h in _REPAIRED])
def test_routes_take_the_repaired_widths(ws, c, heads):
    """The block takes the K7 route, its windows' attention (as K15 would
    see it, masked) the stream kernel, and the tail kernel a row count
    that fits C."""
    from tpu_superresolution_torch.kernels.fused_block import block_route, tail_rows
    from tpu_superresolution_torch.kernels.window_attention import k15_route, stream_plan

    assert block_route(ws, c, heads, 2 * c) == "window_attention"
    n, hd = ws * ws, c // heads
    assert k15_route(n, n, hd, True) == "stream"
    assert stream_plan(n, n, hd, ws).smem <= 232448
    assert tail_rows(c) in (64, 32)


def test_swinir_c576_matches_jax(k7_emulated):
    """SwinIR at C 576 in 6 heads (hd 96), one RSTB of two blocks (the
    second shifted) on a 16 x 16 input: both blocks on the K7 route with
    K7's kernels emulated, against the JAX jnp path."""
    from tpu_superresolution_torch.kernels import fused_attention as fa

    cfg = small_swinir_config(embed_dim=576, depths=(2,), num_heads=(6,))
    model, variables = perturbed_jax_swinir(cfg, (16, 16))
    x = np.random.default_rng(576).random((1, 16, 16, 3), dtype=np.float32)
    want = jax_forward(model, variables, x)
    got = port_forward(port_from_jax(cfg, variables), x)
    assert fa.launches.count == 2
    assert got.shape == want.shape == (1, 64, 64, 3)
    assert np.abs(got - want).max() <= TOL


def test_hat_c576_matches_jax(k7_emulated, k15_emulated):
    """HAT at embed 576 in 6 heads (hd 96; one RHAG of two HABs and the
    OCAB, ws 7): the HABs on the K7 route (emulated), their CABs (C 576)
    on K2 + K3 + K3, the OCAB's attention on K15's "stream" route;
    against the JAX jnp path."""
    from tpu_superresolution_torch.kernels import fused_attention as fa

    from tests.test_torch_hat import small_hat_config

    cfg = small_hat_config(embed_dim=576, depths=(2,), num_heads=(6,), squeeze_factor=30)
    model, variables = perturbed_jax_swinir(cfg, (14, 14))
    x = np.random.default_rng(577).random((1, 14, 14, 3), dtype=np.float32)
    want = jax_forward(model, variables, x)
    got = port_forward(port_from_jax(cfg, variables), x)
    assert fa.launches.count == 2 and k15_emulated == ["stream"]
    assert got.shape == want.shape == (1, 56, 56, 3)
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("hd", [96, 132])
def test_plain_attention_past_64_dims_matches_jax(hd, k15_emulated):
    """At hd 96 and 132: K15 through its kernel path (the "stream" route,
    each launch the plain version) against the JAX
    ``window_attention_reference``, and K7's plain version against the
    JAX ``_reference_impl``."""
    from tpu_superresolution_tpu.ops.pallas import fused_attention as jfa
    from tpu_superresolution_tpu.ops.pallas.window_attention import window_attention_reference
    from tpu_superresolution_torch.kernels import window_attention as kw
    from tpu_superresolution_torch.kernels.fused_attention import window_attention_plain

    rng = np.random.default_rng(hd)
    bw, nh, n = 4, 2, 49
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    q, k, v = f(bw, nh, n, hd), f(bw, nh, n, hd), f(bw, nh, n, hd)
    bias = f(nh, n, n, sc=0.5)
    ids = rng.integers(0, 3, size=(2, n))
    mask = np.where(ids[:, :, None] != ids[:, None, :], -100.0, 0.0).astype(np.float32)
    got = kw.fused_window_attention(*(torch.from_numpy(a) for a in (q, k, v, bias, mask)),
                                    hd ** -0.5)
    want = window_attention_reference(*(jnp.asarray(a) for a in (q, k, v, bias, mask)),
                                      hd ** -0.5)
    assert k15_emulated == ["stream"]
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL

    c = nh * hd
    xw, wqkv, bqkv = f(bw, n, c), f(3 * c, c, sc=c ** -0.5), f(3 * c, sc=0.1)
    wproj, bproj = f(c, c, sc=c ** -0.5), f(c, sc=0.1)
    got = window_attention_plain(*(torch.from_numpy(a) for a in (xw, wqkv, bqkv, wproj, bproj,
                                                                 bias, mask)), hd ** -0.5)
    want = jfa._reference_impl(*(jnp.asarray(a) for a in (xw, wqkv.T, bqkv, wproj.T, bproj,
                                                           bias, mask)), hd ** -0.5)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
