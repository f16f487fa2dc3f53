"""K1's function on the K7 route of the PyTorch port: a Swin block at a
window or width the whole-block kernel does not take runs K2 (LN1), K7
and K1's tail kernel (the attention residual read back through the
window reverse and unshift, `extra`, LN2, the MLP and its residual).
On the CPU each wrapper runs its plain version: the block through that
route against the JAX package's K1 (``fused_swin_block``) in interpret
mode, fp32, bound 3e-5 max abs; the tail kernel's packed layout and
addressing emulated in fp32; its autograd function's backward."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import TOL

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_params(rng, c, nh, hidden, ws):
    n = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    return dict(g1=1 + n(c, sc=0.1), b1=n(c, sc=0.1),
                wqkv=n(c, 3 * c, sc=c ** -0.5), bqkv=n(3 * c, sc=0.1),  # [in, out]
                wproj=n(c, c, sc=c ** -0.5), bproj=n(c, sc=0.1),
                g2=1 + n(c, sc=0.1), b2=n(c, sc=0.1),
                wfc1=n(c, hidden, sc=c ** -0.5), bfc1=n(hidden, sc=0.1),
                wfc2=n(hidden, c, sc=hidden ** -0.5), bfc2=n(c, sc=0.1),
                table=n((2 * ws - 1) ** 2, nh, sc=0.5))


def _swin_block(p, c, nh, ws, shift, gelu_approx):
    """A port SwinBlock holding the JAX-layout parameters `p`."""
    from tpu_superresolution_torch.models.swinir import SwinBlock

    blk = SwinBlock(c, nh, ws, shift, p["wfc1"].shape[1] / c, True, gelu_approx)
    with torch.no_grad():
        for mod, name, key, tr in (
                (blk.norm1, "weight", "g1", False), (blk.norm1, "bias", "b1", False),
                (blk.attn.qkv, "weight", "wqkv", True), (blk.attn.qkv, "bias", "bqkv", False),
                (blk.attn.proj, "weight", "wproj", True), (blk.attn.proj, "bias", "bproj", False),
                (blk.norm2, "weight", "g2", False), (blk.norm2, "bias", "b2", False),
                (blk.mlp.fc1, "weight", "wfc1", True), (blk.mlp.fc1, "bias", "bfc1", False),
                (blk.mlp.fc2, "weight", "wfc2", True), (blk.mlp.fc2, "bias", "bfc2", False),
                (blk.attn, "relative_position_bias_table", "table", False)):
            getattr(mod, name).copy_(_t(p[key].T if tr else p[key]))
    return blk


_BLOCKS = [
    # (ws, C, heads, hidden, shift, extra, branch scales, gelu tanh)
    (16, 32, 2, 64, 8, True, False, False),   # HAT-SRx4's window, HAB's extra
    (16, 32, 2, 64, 0, False, True, True),
    (6, 32, 2, 64, 3, True, True, False),     # an odd-sized window
    (8, 208, 8, 416, 4, False, False, True),  # C past the block kernel's 192
]


@pytest.mark.parametrize("ws,c,nh,hidden,shift,with_extra,with_scales,gelu_approx", _BLOCKS,
                         ids=[f"ws{b[0]}-C{b[1]}-shift{b[4]}" for b in _BLOCKS])
def test_k7_route_block_matches_jax_k1(ws, c, nh, hidden, shift, with_extra, with_scales,
                                       gelu_approx, monkeypatch):
    """A SwinBlock that block_route sends to the K7 route (on the CPU:
    the wrappers' plain versions, K7's and the tail's wrapper called
    once each, no kernel launched) against the JAX package's whole-block
    kernel K1 in interpret mode on the cyclically shifted map, with
    `extra` and branch scales."""
    from tpu_superresolution_tpu.ops.pallas.fused_block import fused_swin_block
    from tpu_superresolution_tpu.ops.window import (
        cyclic_shift,
        cyclic_unshift,
        relative_position_index,
        shift_attn_mask,
    )
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels.fused_block import block_route
    from tpu_superresolution_torch.models import swinir

    assert block_route(ws, c, nh, hidden) == "window_attention"
    rng = np.random.default_rng(ws + c + shift)
    p = _jax_params(rng, c, nh, hidden, ws)
    b, h, w = 2, 2 * ws, 2 * ws
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    extra = (0.3 * rng.standard_normal((b, h, w, c))).astype(np.float32) if with_extra else None
    scales = np.array([[1.25, 0.0], [0.0, 1.25]], np.float32) if with_scales else None
    n = ws * ws
    bias = p["table"][relative_position_index(ws).reshape(-1)].reshape(n, n, nh)
    mask = shift_attn_mask(h, w, ws, shift) if shift else None
    args = [jnp.asarray(p[k]) for k in ("g1", "b1", "wqkv", "bqkv", "wproj", "bproj", "g2",
                                        "b2", "wfc1", "bfc1", "wfc2", "bfc2")]
    out = fused_swin_block(
        cyclic_shift(jnp.asarray(x), shift), *args, jnp.asarray(bias.transpose(2, 0, 1)), ws,
        mask, (c // nh) ** -0.5, gelu_approx, interpret=True,
        extra=None if extra is None else cyclic_shift(jnp.asarray(extra), shift),
        branch_scales=None if scales is None else jnp.asarray(scales))
    want = np.asarray(cyclic_unshift(out, shift))

    blk = _swin_block(p, c, nh, ws, shift, gelu_approx)
    calls = []
    for name in ("fused_window_attention", "fused_block_tail"):
        real = getattr(swinir, name)
        monkeypatch.setattr(swinir, name,
                            lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    reset_counters()
    with torch.no_grad():
        got = blk(_t(x), branch_scales=None if scales is None else _t(scales),
                  extra=None if extra is None else _t(extra)).numpy()
    assert sorted(calls) == ["fused_block_tail", "fused_window_attention"]
    assert not any(read_counters().values())
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


def _tail_case(c, hidden, ws, shift, seed):
    from tpu_superresolution_torch.kernels.fused_block import SwinBlockWeights

    rng = np.random.default_rng(seed)
    p = _jax_params(rng, c, 2, hidden, ws)
    w = SwinBlockWeights(**{k: _t(p[k].T if k.startswith("w") else p[k]) for k in (
        "g1", "b1", "wqkv", "bqkv", "wproj", "bproj", "g2", "b2", "wfc1", "bfc1", "wfc2",
        "bfc2", "table")}, num_heads=2)
    b, h, wd = 2, 2 * ws, 3 * ws
    f = lambda *s, sc=1.0: _t((sc * rng.standard_normal(s)).astype(np.float32))
    x, attn, extra = f(b, h, wd, c), f(b * 6, ws * ws, c), f(b, h, wd, c, sc=0.3)
    scales = _t(np.array([[1.25, 0.5], [0.0, 1.25]], np.float32))
    return w, x, attn, extra, scales


@pytest.mark.parametrize("c,hidden,ws,shift", [(180, 360, 16, 8), (240, 720, 6, 3),
                                               (24, 40, 8, 0), (264, 528, 8, 4),
                                               (576, 1152, 8, 4), (270, 100, 6, 3)])
def test_tail_packed_layout_and_addressing_compute_the_plain_function(c, hidden, ws, shift):
    """The WMMA tail kernel's arithmetic (``csrc/swin_tail.cu``, route
    "wmma": ``tail_route``'s past C 256, packed for it at any C),
    emulated in fp32 from its packed operands: each pixel's attention
    row found by the kernel's address formula (window and token of the
    pixel in the shifted map), LN2 in the fast-variance form, the MLP
    hidden in chunks of 128 columns with each chunk's fc2 partial
    product added into the residual (fc2's bias with the first).  It
    gives the plain version's output: what only the card runs is
    checked here."""
    from tpu_superresolution_torch.kernels.fused_block import (
        LN_EPS,
        gelu,
        pack_block_tail,
        swin_block_tail_plain,
    )

    w, x, attn, extra, scales = _tail_case(c, hidden, ws, shift, c + ws)
    pk = pack_block_tail(w.g2, w.b2, w.wfc1, w.bfc1, w.wfc2, w.bfc2, route="wmma")
    b, h, wd, _ = x.shape
    ck, hk = pk.wfc1.shape[1], pk.wfc1.shape[0]
    p = torch.arange(b * h * wd)
    bidx, rem = p // (h * wd), p % (h * wd)
    si, sj = (rem // wd - shift) % h, (rem % wd - shift) % wd
    win = (bidx * (h // ws) + si // ws) * (wd // ws) + sj // ws
    tok = (si % ws) * ws + sj % ws
    rows = attn.reshape(-1, c)[win * ws * ws + tok]
    m1, m2 = scales[bidx, 0, None], scales[bidx, 1, None]
    x1 = torch.nn.functional.pad(x.reshape(-1, c) + m1 * rows + extra.reshape(-1, c),
                                 (0, ck - c))
    mu = x1[:, :c].mean(-1, keepdim=True)
    var = ((x1[:, :c] ** 2).mean(-1, keepdim=True) - mu * mu).clamp_min(0)
    y2 = torch.nn.functional.pad((x1[:, :c] - mu) * torch.rsqrt(var + LN_EPS) * pk.g2 + pk.b2,
                                 (0, ck - c))
    for h0 in range(0, hk, 128):
        hid = gelu(y2 @ pk.wfc1[h0:h0 + 128].float().t() + pk.bfc1[h0:h0 + 128], False)
        part = hid @ pk.wfc2[:, h0:h0 + 128].float().t()
        x1 = x1 + m2 * (part + (pk.bfc2 if h0 == 0 else 0))
    got = x1[:, :c].reshape(x.shape)
    # the packing rounds the MLP weights to bf16
    bf = lambda t: t.to(torch.bfloat16).float()
    wb = types.SimpleNamespace(**{**vars(w), "wfc1": bf(w.wfc1), "wfc2": bf(w.wfc2)})
    want = swin_block_tail_plain(x, attn, wb, ws, shift, False, scales, extra)
    assert tuple(pk.wfc1.shape) == (-(-hidden // 16) * 16, -(-c // 16) * 16)
    assert tuple(pk.wfc2.shape) == (-(-c // 16) * 16, -(-hidden // 16) * 16)
    assert (got - want).abs().max() <= 1e-4


def test_tail_autograd_function_backward_is_autograd_of_the_plain_version():
    """BlockTailFunction.backward (what runs after the tail kernel on
    CUDA), fed a context as autograd would, returns the plain version's
    gradients for the inputs that want one and None for the others."""
    from tpu_superresolution_torch.kernels.fused_block import BlockTailFunction, _tail_plain

    w, x, attn, extra, scales = _tail_case(32, 64, 8, 4, 3)
    tensors = (x, attn, extra, scales, w.g2, w.b2, w.wfc1, w.bfc1, w.wfc2, w.bfc2)
    meta = (8, 4, False)
    needs = (True, True, True, False, True, False, True, True, True, False, False, False, False)
    ct = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))
    ctx = types.SimpleNamespace(saved_tensors=tensors, meta=meta, needs_input_grad=needs)
    got = BlockTailFunction.backward(ctx, ct)
    leaves = [t.clone().requires_grad_(n) for t, n in zip(tensors, needs)]
    _tail_plain(*leaves, *meta).backward(ct)
    assert len(got) == len(needs)
    for i, (g, n) in enumerate(zip(got, needs)):
        if not n:
            assert g is None, i
        else:
            assert torch.allclose(g, leaves[i].grad, atol=1e-6), i


def test_tail_wrapper_refuses_devices_without_a_kernel():
    """A meta tensor gets neither the tail kernel nor its plain version."""
    from tpu_superresolution_torch.kernels.fused_block import SwinBlockWeights, fused_block_tail

    m = lambda *s: torch.empty(*s, device="meta")
    w = SwinBlockWeights(g1=m(16), b1=m(16), wqkv=m(48, 16), bqkv=m(48), wproj=m(16, 16),
                         bproj=m(16), g2=m(16), b2=m(16), wfc1=m(32, 16), bfc1=m(32),
                         wfc2=m(16, 32), bfc2=m(16), table=m(121, 2), num_heads=2)
    with pytest.raises(ValueError, match="no kernel"):
        fused_block_tail(m(1, 6, 6, 16), m(1, 36, 16), w, 6, 0, False)
