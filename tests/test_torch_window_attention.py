"""K7, the window-attention kernel of the PyTorch port, and the route a
Swin block takes by its shapes: K7's plain version (what the wrapper
runs on CPU tensors) against the JAX package's
``fused_window_block_attention`` in interpret mode and its
``_reference_impl``, its gradients against ``jax.vjp``, the kernel's
weight packing emulated in fp32, ``block_route`` on the shapes the
checkpoints use, and whole SwinIR models that take the K7 route against
the JAX package.  fp32 on the CPU; bound 3e-5 max abs forward, 2e-4
(activations) and 1e-3 (weights and bias) on gradients."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import (
    TOL,
    jax_forward,
    perturbed_jax_swinir,
    port_forward,
    port_from_jax,
    small_swinir_config,
)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(ws, c=32, nh=2, masked=True, with_bias=True, seed=0):
    """Seeded K7 operands for 2 images of 2 x 1 windows of ws x ws: xw
    [4, N, C], JAX-layout weights ([in, out]), the gathered bias [nH, N,
    N] and the shift mask (or None)."""
    from tpu_superresolution_tpu.ops.window import relative_position_index, shift_attn_mask

    rng = np.random.default_rng(seed)
    n = ws * ws
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    table = f((2 * ws - 1) ** 2, nh, sc=0.5)
    bias = table[relative_position_index(ws).reshape(-1)].reshape(n, n, nh).transpose(2, 0, 1)
    return dict(xw=f(4, n, c), wqkv=f(c, 3 * c, sc=c ** -0.5),
                bqkv=f(3 * c, sc=0.1) if with_bias else None,
                wproj=f(c, c, sc=c ** -0.5), bproj=f(c, sc=0.1),
                bias=np.ascontiguousarray(bias),
                mask=shift_attn_mask(2 * ws, ws, ws, ws // 2) if masked else None,
                scale=(c // nh) ** -0.5)


def _port_args(a):
    """The port's argument list (torch layout [out, in]) of a case."""
    return (_t(a["xw"]), _t(a["wqkv"].T), None if a["bqkv"] is None else _t(a["bqkv"]),
            _t(a["wproj"].T), _t(a["bproj"]), _t(a["bias"]),
            None if a["mask"] is None else _t(a["mask"]))


_CASES = [(6, True, True), (7, False, True), (8, True, False), (16, True, True),
          (16, False, False)]


@pytest.mark.parametrize("ws,masked,with_bias", _CASES,
                         ids=[f"N{w * w}-{'mask' if m else 'nomask'}-{'bias' if b else 'nobias'}"
                              for w, m, b in _CASES])
def test_plain_matches_jax_kernel_and_reference(ws, masked, with_bias):
    """window_attention_plain (the wrapper on CPU tensors, no kernel
    launched) against the JAX kernel in interpret mode (its window
    packing, token padding to a multiple of 8 with -1e9 pad keys) and
    its jnp oracle, with and without the shift mask and the qkv bias."""
    from tpu_superresolution_tpu.ops.pallas import fused_attention as jfa
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels.fused_attention import fused_window_attention

    a = _case(ws, masked=masked, with_bias=with_bias, seed=ws)
    jargs = (jnp.asarray(a["xw"]), jnp.asarray(a["wqkv"]),
             None if a["bqkv"] is None else jnp.asarray(a["bqkv"]), jnp.asarray(a["wproj"]),
             jnp.asarray(a["bproj"]), jnp.asarray(a["bias"]))
    want = np.asarray(jfa.fused_window_block_attention(*jargs, mask=a["mask"], scale=a["scale"],
                                                       interpret=True))
    oracle = np.asarray(jfa._reference_impl(*jargs, a["mask"], a["scale"]))
    reset_counters()
    got = fused_window_attention(*_port_args(a)).numpy()
    assert not any(read_counters().values())
    assert got.shape == want.shape == (4, ws * ws, 32)
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - oracle).max() <= TOL


def test_gradients_match_jax_vjp():
    """Autograd of the plain version (K7's backward on CUDA) against
    jax.vjp of the JAX kernel's custom_vjp, at N 49 with the mask."""
    from tpu_superresolution_tpu.ops.pallas import fused_attention as jfa
    from tpu_superresolution_torch.kernels.fused_attention import fused_window_attention

    a = _case(7, seed=3)
    rng = np.random.default_rng(4)
    ct = rng.standard_normal(a["xw"].shape).astype(np.float32)
    names = ("xw", "wqkv", "bqkv", "wproj", "bproj", "bias")
    fn = lambda *p: jfa.fused_window_block_attention(*p, mask=a["mask"], scale=a["scale"],
                                                     interpret=True)
    _, vjp = jax.vjp(fn, *(jnp.asarray(a[k]) for k in names))
    want = dict(zip(names, (np.asarray(g) for g in vjp(jnp.asarray(ct)))))
    args = [t.requires_grad_() if t is not None else None for t in _port_args(a)]
    fused_window_attention(*args).backward(_t(ct))
    got = dict(zip(names, (args[0].grad, args[1].grad.T, args[2].grad, args[3].grad.T,
                           args[4].grad, args[5].grad)))
    for k in names:
        bound = 2e-4 if k == "xw" else 1e-3
        assert np.abs(got[k].numpy() - want[k]).max() <= bound, k


def test_autograd_function_backward_is_autograd_of_the_plain_version():
    """WindowAttentionFunction.backward (what runs after K7 on CUDA), fed
    a context as autograd would, returns the plain version's gradients
    for the inputs that want one and None for the others."""
    from tpu_superresolution_torch.kernels.fused_attention import (
        WindowAttentionFunction,
        window_attention_plain,
    )

    a = _case(8, seed=5)
    args = _port_args(a)
    ct = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(6))
    needs = (True, True, True, False, True, True, False, False)
    ctx = types.SimpleNamespace(saved_tensors=args, scale=a["scale"], needs_input_grad=needs)
    got = WindowAttentionFunction.backward(ctx, ct)
    leaves = [t.clone().requires_grad_(n) if t is not None else None
              for t, n in zip(args, needs)]
    window_attention_plain(*leaves, a["scale"]).backward(ct)
    for i, (g, n) in enumerate(zip(got, needs)):
        if not n:
            assert g is None, i
        else:
            assert torch.allclose(g, leaves[i].grad, atol=1e-6), i


def unpack_product(packed):
    """The [C_out, C_in] fp32 weight and [C_out] bias a packed product
    operand holds: its [N, 64] tiles read back through the 128B swizzle
    (an involution), the padding dropped."""
    from tpu_superresolution_torch.kernels.cab_conv import _swizzle_rows

    nt, chunks, n, bk = packed.wp.shape
    w = _swizzle_rows(packed.wp.float()).transpose(1, 2).reshape(nt * n, chunks * bk)
    return w[:packed.c_out, :packed.c_in], packed.b[:packed.c_out]


@pytest.mark.parametrize("c,nh,with_bias", [(180, 6, True), (60, 2, False), (240, 8, True)])
def test_packed_layout_computes_the_plain_function(c, nh, with_bias):
    """K7's packed operands (head dims padded hd -> hdw with q pre-scaled,
    the product weights in swizzled [N, 64] tiles, the bias gathered),
    used as the kernels use them and computed in fp32, give the plain
    version's output: the packing that only the card runs is checked
    here."""
    from tpu_superresolution_torch.kernels.fused_attention import (
        pack_window_attention,
        window_attention_plain,
    )

    a = _case(6, c=c, nh=nh, with_bias=with_bias, seed=c)
    xw, wqkv, bqkv, wproj, bproj, rpb, mask = _port_args(a)
    p = pack_window_attention(wqkv, bqkv, wproj, bproj, rpb)
    bw, n, _ = xw.shape
    hdw = p.hdw
    wq, bq = unpack_product(p.qkv)
    wp, bp = unpack_product(p.proj)
    qkv = (xw @ wq.t() + bq).reshape(bw, n, 3, nh, hdw)
    s = torch.einsum("wqhd,wkhd->whqk", qkv[:, :, 0], qkv[:, :, 1]) + p.rpb[None]
    s = s + mask.repeat(bw // mask.shape[0], 1, 1)[:, None]
    o = torch.einsum("whqk,wkhd->wqhd", torch.softmax(s, -1), qkv[:, :, 2]).reshape(bw, n, -1)
    got = o @ wp.t() + bp
    # the packing rounds the GEMM weights to bf16 after the q pre-scale
    bf = lambda t: t.to(torch.bfloat16).float()
    qscale = torch.ones(3 * c, 1)
    qscale[:c] = a["scale"]
    want = window_attention_plain(xw, bf(wqkv * qscale) / qscale, bqkv, bf(wproj), bproj, rpb,
                                  mask, a["scale"])
    assert tuple(wq.shape) == (3 * nh * hdw, c) and tuple(wp.shape) == (c, nh * hdw)
    assert p.qkv.wp.shape[1:] == (-(-c // 64), p.qkv.plan.n_tile, 64)
    assert (got - want).abs().max() <= 1e-4


_ROUTES = [
    # (ws, C, heads, hidden, qkv_bias) -> route or the error's words
    ((8, 180, 6, 360, True), "block"),            # SwinIR-M
    ((7, 96, 6, 384, True), "block"),             # HAT ws 7
    ((8, 96, 6, 384, True), "block"),             # hat_fast
    ((16, 180, 6, 360, True), "window_attention"),  # HAT-SRx4
    ((16, 144, 6, 288, True), "window_attention"),  # HAT-S
    ((6, 180, 6, 360, True), "window_attention"),
    ((12, 96, 6, 192, True), "window_attention"),
    ((8, 240, 8, 480, True), "window_attention"),   # SwinIR-L
    ((8, 256, 8, 512, True), "window_attention"),
    ((8, 180, 6, 720, True), "window_attention"),   # hidden past 384
    ((8, 180, 6, 360, False), "window_attention"),  # no qkv bias
    ((8, 288, 8, 576, True), "window_attention"),   # past the block kernel's C 192
    ((8, 128, 2, 256, True), "window_attention"),   # hd 64
    ((8, 252, 9, 504, True), "window_attention"),   # 9 heads
    ((8, 264, 4, 528, True), "window_attention"),   # hd 66
]


@pytest.mark.parametrize("shape,route", _ROUTES, ids=[str(s) for s, _ in _ROUTES])
def test_block_route_by_shape(shape, route):
    """block_route picks the block kernel at ws 7 / 8 within its widths
    and the K7 route for every other window, width, head count and head
    dim, the same answer on every call."""
    from tpu_superresolution_torch.kernels.fused_block import block_route

    assert block_route(*shape) == route
    assert block_route(*shape) == route  # the same answer on every call


@pytest.mark.parametrize("overrides,hw,impl", [
    (dict(window_size=6), (13, 16), "fused"),
    (dict(embed_dim=208, depths=(2,), num_heads=(8,)), (10, 13), "jnp"),
    (dict(window_size=12, gelu_approximate=True, fused_reconstruct=True), (20, 26), "jnp"),
], ids=["ws6-jax-K7", "C208-8heads", "ws12-composed"])
def test_swinir_on_the_k7_route_matches_jax(overrides, hw, impl):
    """Whole SwinIR models whose blocks take the K7 route (a window of
    6 or 12; C 208 with 8 heads of hd 26) against the JAX package: its
    K7 kernel in interpret mode, or its einsum module path."""
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels.fused_block import block_route

    cfg = small_swinir_config(attention_impl=impl, **overrides)
    model, variables = perturbed_jax_swinir(cfg, (cfg.window_size * 2,) * 2)
    x = np.random.default_rng(7).random((2, hw[0], hw[1], 3), dtype=np.float32)
    want = jax_forward(model, variables, x)
    port = port_from_jax(cfg, variables)
    c, nh = cfg.embed_dim, cfg.num_heads[0]
    assert block_route(cfg.window_size, c, nh, int(c * cfg.mlp_ratio)) == "window_attention"
    reset_counters()
    got = port_forward(port, x)
    assert not any(read_counters().values())
    assert got.shape == want.shape == (2, 4 * hw[0], 4 * hw[1], 3)
    assert np.abs(got - want).max() <= TOL
