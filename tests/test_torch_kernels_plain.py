"""Each port kernel's plain PyTorch version (what its wrapper runs on a
CPU tensor) against the JAX package's Pallas kernel in interpret mode
and its jnp reference, fp32, bound 3e-5 max abs.  The CUDA kernels
themselves are checked against these plain versions on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import TOL

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _block_params(rng, c=32, nh=2, hidden=64, ws=8):
    n = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    return dict(
        g1=1 + n(c, sc=0.1), b1=n(c, sc=0.1),
        wqkv=n(c, 3 * c, sc=c ** -0.5), bqkv=n(3 * c, sc=0.1),  # [in, out] (JAX)
        wproj=n(c, c, sc=c ** -0.5), bproj=n(c, sc=0.1),
        g2=1 + n(c, sc=0.1), b2=n(c, sc=0.1),
        wfc1=n(c, hidden, sc=c ** -0.5), bfc1=n(hidden, sc=0.1),
        wfc2=n(hidden, c, sc=hidden ** -0.5), bfc2=n(c, sc=0.1),
        table=n((2 * ws - 1) ** 2, nh), nh=nh,
    )


def _port_weights(p):
    from tpu_superresolution_torch.kernels.fused_block import SwinBlockWeights

    return SwinBlockWeights(
        g1=_t(p["g1"]), b1=_t(p["b1"]), wqkv=_t(p["wqkv"].T), bqkv=_t(p["bqkv"]),
        wproj=_t(p["wproj"].T), bproj=_t(p["bproj"]), g2=_t(p["g2"]), b2=_t(p["b2"]),
        wfc1=_t(p["wfc1"].T), bfc1=_t(p["bfc1"]), wfc2=_t(p["wfc2"].T), bfc2=_t(p["bfc2"]),
        table=_t(p["table"]), num_heads=p["nh"],
    )


@pytest.mark.parametrize("oracle", ["pallas_interpret", "jnp_reference"])
@pytest.mark.parametrize("gelu_approx", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("shift", [0, 4])
def test_swin_block_plain_matches_jax(shift, gelu_approx, oracle):
    from tpu_superresolution_tpu.ops.pallas.fused_block import (
        _reference_block,
        fused_swin_block as jax_block,
    )
    from tpu_superresolution_tpu.ops.window import (
        cyclic_shift,
        cyclic_unshift,
        relative_position_index,
        shift_attn_mask,
    )
    from tpu_superresolution_torch.kernels import fused_block, read_counters, reset_counters
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    ws, b, h, w = 8, 2, 16, 24
    rng = np.random.default_rng(shift + 10 * gelu_approx)
    p = _block_params(rng)
    c = p["wqkv"].shape[0]
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    n = ws * ws
    bias = p["table"][relative_position_index(ws).reshape(-1)].reshape(n, n, -1)
    bias = jnp.asarray(bias.transpose(2, 0, 1))
    mask = shift_attn_mask(h, w, ws, shift) if shift else None
    scale = (c // p["nh"]) ** -0.5
    args = [jnp.asarray(p[k]) for k in ("g1", "b1", "wqkv", "bqkv", "wproj", "bproj",
                                        "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2")]
    xs = cyclic_shift(jnp.asarray(x), shift)
    if oracle == "pallas_interpret":
        out = jax_block(xs, *args, bias, ws, mask, scale, gelu_approx, interpret=True)
    else:
        out = _reference_block(xs, *args, bias, jnp.ones((b, 2), jnp.float32), ws, mask,
                               scale, gelu_approx)
    want = np.asarray(cyclic_unshift(out, shift))

    reset_counters()
    tmask = shift_mask_tensor(h, w, ws, shift, torch.device("cpu")) if shift else None
    got = fused_block.fused_windows_block(_t(x), _port_weights(p), ws, shift, tmask,
                                          gelu_approx).numpy()
    assert np.abs(got - want).max() <= TOL
    assert read_counters()["K1"] == 0  # CPU tensor: the plain version ran


@pytest.mark.parametrize("shape", [(2, 16, 16, 36), (333, 180)])
def test_layernorm_plain_matches_pallas(shape):
    from tpu_superresolution_tpu.ops.pallas.layernorm import pallas_layernorm
    from tpu_superresolution_torch.kernels.layernorm import layernorm

    rng = np.random.default_rng(len(shape))
    c = shape[-1]
    x = (3.0 + 2.0 * rng.standard_normal(shape)).astype(np.float32)  # offset mean
    g = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    want = np.asarray(pallas_layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                       interpret=True, block_rows=64))
    got = layernorm(_t(x), _t(g), _t(b)).numpy()
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("shape,cout", [((2, 16, 16, 24), 16), ((1, 24, 16, 8), 8)])
def test_conv3x3_plain_matches_pallas(shape, cout):
    from tpu_superresolution_tpu.ops.pallas.cab_conv import conv3x3_halo
    from tpu_superresolution_torch.kernels.cab_conv import conv3x3

    rng = np.random.default_rng(cout)
    cin = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    want = np.asarray(conv3x3_halo(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                                   interpret=True))
    got = conv3x3(_t(x), _t(k), _t(bias)).numpy()
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("kh,pad", [(5, ((2, 2), (2, 2))), (4, ((1, 2), (2, 1)))])
def test_conv_k_plain_matches_pallas(kh, pad):
    from tpu_superresolution_tpu.ops.pallas.cab_conv import conv_halo
    from tpu_superresolution_torch.kernels.cab_conv import conv_k

    rng = np.random.default_rng(kh)
    x = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
    k = (rng.standard_normal((kh, kh, 16, 12)) / np.sqrt(kh * kh * 16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(12)).astype(np.float32)
    want = np.asarray(conv_halo(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), pad,
                                interpret=True))
    got = conv_k(_t(x), _t(k), _t(bias), pad).numpy()
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("rhos", [[2], [2, 2], [3]], ids=["x2", "x4", "x3"])
def test_composed_upsample_params_match_jax(rhos):
    from tpu_superresolution_tpu.ops.fused_upsample import (
        composed_upsample_params as jax_compose,
    )
    from tpu_superresolution_torch.ops.fused_upsample import composed_upsample_params

    rng = np.random.default_rng(len(rhos) * 10 + rhos[0])
    c = 16
    stages = [((0.1 * rng.standard_normal((3, 3, c, c * r * r))).astype(np.float32),
               (0.1 * rng.standard_normal(c * r * r)).astype(np.float32), r) for r in rhos]
    last = ((0.1 * rng.standard_normal((3, 3, c, 3))).astype(np.float32),
            (0.1 * rng.standard_normal(3)).astype(np.float32))
    K, B, pad, r = composed_upsample_params(stages, last)
    jK, jB, jpad, jr = jax_compose(
        [(jnp.asarray(w), jnp.asarray(b), rr) for w, b, rr in stages],
        (jnp.asarray(last[0]), jnp.asarray(last[1])),
    )
    assert (pad, r) == (jpad, jr)
    assert K.shape == jK.shape
    assert np.abs(K - np.asarray(jK)).max() <= TOL
    assert np.abs(B - np.asarray(jB)).max() <= TOL
    if rhos == [2, 2]:
        assert K.shape == (5, 5, c, 48) and pad == ((2, 2), (2, 2))


def test_window_tables_and_pixel_shuffle_match_jax():
    from tpu_superresolution_tpu.ops import window as jw
    from tpu_superresolution_tpu.ops.pixelshuffle import pixel_shuffle as jps
    from tpu_superresolution_torch.ops import window as tw
    from tpu_superresolution_torch.ops.pixelshuffle import pixel_shuffle

    for h, w, ws, s in ((16, 24, 8, 4), (32, 32, 8, 0), (14, 21, 7, 3)):
        np.testing.assert_array_equal(tw.shift_attn_mask(h, w, ws, s),
                                      jw.shift_attn_mask(h, w, ws, s))
    np.testing.assert_array_equal(tw.relative_position_index(8), jw.relative_position_index(8))
    x = np.random.default_rng(0).standard_normal((2, 4, 6, 3 * 16)).astype(np.float32)
    np.testing.assert_array_equal(pixel_shuffle(_t(x), 4).numpy(), np.asarray(jps(x, 4)))
    xs = _t(x[..., :8])
    win = tw.window_partition(tw.cyclic_shift(xs, 1), 2)
    back = tw.cyclic_unshift(tw.window_reverse(win, 2, 4, 6), 1)
    assert torch.equal(back, xs)
    np.testing.assert_array_equal(win.numpy(), np.asarray(
        jw.window_partition(jw.cyclic_shift(jnp.asarray(x[..., :8]), 1), 2)))


@pytest.mark.parametrize("scale,rhos,ring", [(2, [2], 2), (4, [2, 2], 12), (3, [3], 3)])
def test_composed_reconstruction_matches_chain(scale, rhos, ring):
    """The composed conv + one pixel shuffle equals the reference chain
    in the interior (a border ring of 3*scale output px may differ), and
    the port's chain equals the JAX package's chain everywhere."""
    from tpu_superresolution_tpu.ops.fused_upsample import (
        chain_pixelshuffle_reconstruct as jax_chain,
    )
    from tpu_superresolution_torch.ops.fused_upsample import (
        chain_pixelshuffle_reconstruct,
        compose_upsample,
        fused_pixelshuffle_reconstruct,
    )

    rng = np.random.default_rng(scale)
    c = 16
    r = lambda *s: (0.1 * rng.standard_normal(s)).astype(np.float32)
    stages = [(r(3, 3, c, c * k * k), r(c * k * k), k) for k in rhos]
    last = (r(3, 3, c, 3), r(3))
    y = r(2, 12, 12, c)
    tstages = [(_t(w), _t(b), k) for w, b, k in stages]
    chain = chain_pixelshuffle_reconstruct(_t(y), tstages, (_t(last[0]), _t(last[1])),
                                           torch.float32).numpy()
    comp = compose_upsample(stages, last, torch.float32, torch.device("cpu"))
    fused = fused_pixelshuffle_reconstruct(_t(y), comp).numpy()
    want = np.asarray(jax_chain(jnp.asarray(y), [(jnp.asarray(w), jnp.asarray(b), k)
                                                 for w, b, k in stages],
                                (jnp.asarray(last[0]), jnp.asarray(last[1])), jnp.float32))
    assert chain.shape == fused.shape == (2, 12 * scale, 12 * scale, 3)
    assert np.abs(chain - want).max() <= TOL
    assert np.abs(fused - chain)[:, ring:-ring, ring:-ring].max() <= TOL


def test_window_attention_module_matches_jax_reference():
    from tpu_superresolution_tpu.ops.pallas.fused_attention import _reference_impl
    from tpu_superresolution_tpu.ops.window import relative_position_index, shift_attn_mask
    from tpu_superresolution_torch.models.swinir import WindowAttention

    rng = np.random.default_rng(5)
    c, nh, ws = 32, 2, 8
    attn = WindowAttention(c, ws, nh)
    with torch.no_grad():
        for p in attn.parameters():
            p.copy_(torch.from_numpy((0.2 * rng.standard_normal(p.shape)).astype(np.float32)))
    xw = rng.standard_normal((2 * 6, 64, c)).astype(np.float32)  # 2 images x 6 windows
    mask = shift_attn_mask(16, 24, ws, 4)
    n = ws * ws
    table = attn.relative_position_bias_table.detach().numpy()
    bias = table[relative_position_index(ws).reshape(-1)].reshape(n, n, nh).transpose(2, 0, 1)
    f = lambda t: jnp.asarray(t.detach().numpy())
    want = np.asarray(_reference_impl(
        jnp.asarray(xw), f(attn.qkv.weight).T, f(attn.qkv.bias), f(attn.proj.weight).T,
        f(attn.proj.bias), jnp.asarray(bias), mask, (c // nh) ** -0.5))
    with torch.no_grad():
        got = attn(_t(xw), _t(mask)).numpy()
    assert np.abs(got - want).max() <= TOL
