"""K5 at window 16 (the backward of the K7 route's block, upstream
HAT-SRx4's HAB): the port's plain block backward, what
``csrc/swin_block_bwd16.cu`` is held to on the card, against the JAX
package's ``fused_swin_block`` at ws 16 in interpret mode (its
custom_vjp backward is ``_mega_backward``, the Pallas K5), with and
without HAT's `extra`, shift 0 and 8, with stochastic-depth branch
scales; the CUDA kernel's order of work in its attention backward
(heads, then four 64-query tiles in order, dK / dV summed over the
tiles, D = rowsum(dO * O)) written out in plain ops against the
whole-window gradient; and the route predicate ``k5w16_ok`` by shape.
fp32 on the CPU; bounds atol 2e-4 / rtol 1e-3 on gradients (the JAX
package's own kernel-vs-vjp bound) and 3e-5 on the forward."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels_plain import _block_params, _port_weights, _t
from tests.test_torch_swin_backward import _JAX_ORDER, _as_port
from tests.util_torchport import TOL

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
SCALES = np.array([[1.25, 0.0], [1.0, 1.25]], np.float32)
B, H, W, WS = 2, 32, 32, 16


def _gathered_bias(p):
    from tpu_superresolution_tpu.ops.window import relative_position_index

    n = WS * WS
    bias = p["table"][relative_position_index(WS).reshape(-1)].reshape(n, n, -1)
    return np.ascontiguousarray(bias.transpose(2, 0, 1))


def _jax_block(p, shift):
    """(x, 12 weights, gathered bias, extra) -> the JAX fused block at
    ws 16 (shift applied around it, extra in x's frame)."""
    from tpu_superresolution_tpu.ops.pallas.fused_block import fused_swin_block
    from tpu_superresolution_tpu.ops.window import cyclic_shift, cyclic_unshift, shift_attn_mask

    c = p["wqkv"].shape[0]
    mask = shift_attn_mask(H, W, WS, shift) if shift else None
    scale = (c // p["nh"]) ** -0.5

    def f(x, *args):
        *weights, bias, extra = args
        out = fused_swin_block(cyclic_shift(x, shift), *weights, bias, WS, mask, scale, True,
                               interpret=True,
                               extra=None if extra is None else cyclic_shift(extra, shift),
                               branch_scales=jnp.asarray(SCALES))
        return cyclic_unshift(out, shift)

    return f


def _assert_close(got, want, what):
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=what)


@pytest.mark.parametrize("with_extra", [False, True], ids=["no-extra", "extra"])
@pytest.mark.parametrize("shift", [0, 8])
def test_k5_ws16_plain_matches_jax_mega_backward(shift, with_extra):
    from tpu_superresolution_torch.kernels import fused_block, read_counters, reset_counters
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    rng = np.random.default_rng(160 + shift + with_extra)
    p = _block_params(rng, ws=WS)
    c = p["wqkv"].shape[0]
    x = rng.standard_normal((B, H, W, c)).astype(np.float32)
    ct = rng.standard_normal((B, H, W, c)).astype(np.float32)
    extra = (0.3 * rng.standard_normal((B, H, W, c))).astype(np.float32) if with_extra else None
    leaves = ([jnp.asarray(x)] + [jnp.asarray(p[k]) for k in _JAX_ORDER]
              + [jnp.asarray(_gathered_bias(p))])
    f = _jax_block(p, shift)
    if with_extra:
        out, vjp = jax.vjp(f, *leaves, jnp.asarray(extra))
    else:
        out, vjp = jax.vjp(lambda *a: f(*a, None), *leaves)
    jgrads = vjp(jnp.asarray(ct))

    reset_counters()
    w = _port_weights(p)
    tmask = shift_mask_tensor(H, W, WS, shift, torch.device("cpu")) if shift else None
    tx, tex = _t(x), None if extra is None else _t(extra)
    fwd = fused_block.swin_block_plain(tx, w, WS, shift, tmask, True, _t(SCALES), tex)
    assert np.abs(fwd.numpy() - np.asarray(out)).max() <= TOL
    got = fused_block.fused_swin_block_backward(_t(ct), tx, w, WS, shift, tmask, True,
                                                branch_scales=_t(SCALES), extra=tex)
    assert not any(read_counters().values())  # CPU tensors: the plain version ran

    _assert_close(got.dx.numpy(), np.asarray(jgrads[0]), "dx")
    for name, g in zip(_JAX_ORDER, jgrads[1:13]):
        _assert_close(getattr(got, name).numpy(), _as_port(name, g), name)
    _assert_close(got.rpb.numpy(), np.asarray(jgrads[13]), "rpb")
    if with_extra:
        _assert_close(got.extra.numpy(), np.asarray(jgrads[14]), "extra")
    else:
        assert got.extra is None


def _tiled_head_backward(q, k, v, rpb, mask, do, tile=64):
    """The attention backward of csrc/swin_block_bwd16.cu for one head
    group, on [BW, nH, N, hd] fp32 tensors: per head, the query tiles in
    order, each with its exact softmax over all N keys, dV += A^T dO,
    dS = A (dO V^T - D) with D = rowsum(dO * O), dQ = dS K, dK += dS^T Q;
    the bias gradient summed over windows."""
    s = q @ k.transpose(-1, -2) + rpb + (0.0 if mask is None else mask[:, None])
    o = torch.softmax(s, dim=-1) @ v
    d_row = (do * o).sum(-1, keepdim=True)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    drpb = torch.zeros_like(rpb)
    for q0 in range(0, q.shape[2], tile):
        rows = slice(q0, q0 + tile)
        a = torch.softmax(s[:, :, rows], dim=-1)
        dv += a.transpose(-1, -2) @ do[:, :, rows]
        ds = a * (do[:, :, rows] @ v.transpose(-1, -2) - d_row[:, :, rows])
        drpb[:, rows] += ds.sum(0)
        dq[:, :, rows] = ds @ k
        dk += ds.transpose(-1, -2) @ q[:, :, rows]
    return dq, dk, dv, drpb


@pytest.mark.parametrize("masked", [False, True], ids=["unshifted", "shift-mask"])
def test_k5_ws16_tile_order_equals_the_whole_window_gradient(masked):
    """Four 64-query tiles with dK / dV summed over them in order, and
    the flash row term, give the whole-window gradient of softmax(q k^T
    + rpb + mask) v (the 256-token window the kernel cannot hold whole)."""
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    rng = np.random.default_rng(170 + masked)
    n = lambda *s, sc=1.0: torch.from_numpy((sc * rng.standard_normal(s)).astype(np.float32))
    nw, nh, tok, hd = 4, 2, WS * WS, 16
    q, k, v, do = n(nw, nh, tok, hd, sc=0.25), n(nw, nh, tok, hd), n(nw, nh, tok, hd), \
        n(nw, nh, tok, hd)
    rpb = n(nh, tok, tok, sc=0.5)
    mask = shift_mask_tensor(32, 32, WS, 8, torch.device("cpu")) if masked else None
    leaves = [t.clone().requires_grad_() for t in (q, k, v, rpb)]
    lq, lk, lv, lb = leaves
    s = lq @ lk.transpose(-1, -2) + lb + (0.0 if mask is None else mask[:, None])
    (torch.softmax(s, dim=-1) @ lv).backward(do)
    got = _tiled_head_backward(q, k, v, rpb, mask, do)
    for name, g, leaf in zip(("dq", "dk", "dv", "rpb"), got, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


_ROUTE_CASES = [
    # (ws, C, heads, hidden, qkv_bias, trains through K5w16)
    (16, 180, 6, 360, True, True),    # upstream HAT-SRx4
    (16, 32, 2, 64, True, True),
    (16, 30, 2, 120, True, True),     # hd 15
    (16, 180, 6, 720, True, False),   # hidden 720 > 384 (mlp 4)
    (16, 240, 8, 480, True, False),   # C > 192
    (16, 180, 6, 360, False, False),  # no qkv bias
    (8, 180, 6, 360, True, False),    # the block kernel's window (K5)
    (12, 180, 6, 360, True, False),   # other K7-route windows
    (24, 96, 6, 192, True, False),
]


@pytest.mark.parametrize("ws,c,nh,hidden,bias,ok", _ROUTE_CASES,
                         ids=[f"ws{w}-C{c}-h{h}-hid{d}{'' if b else '-nobias'}"
                              for w, c, h, d, b, _ in _ROUTE_CASES])
def test_k5w16_route_by_shape(ws, c, nh, hidden, bias, ok):
    """k5w16_ok takes a K7-route block at ws 16 within the block
    kernel's widths (C <= 192, <= 6 heads of hd <= 32, hidden <= 384,
    qkv bias), the same on every call; its shape check refuses the
    rest."""
    from tpu_superresolution_torch.kernels.fused_block import check_k5w16_args, k5w16_ok

    assert k5w16_ok(ws, c, nh, hidden, bias) is ok
    assert k5w16_ok(ws, c, nh, hidden, bias) is ok
    if ws == 16 and c <= 192 and not ok:
        rng = np.random.default_rng(0)
        p = _block_params(rng, c=c, nh=nh, hidden=hidden, ws=ws)
        w = _port_weights(p)
        if not bias:
            w = dataclasses.replace(w, bqkv=None)
        with pytest.raises(ValueError):
            check_k5w16_args((1, 16, 16, c), w, 0, "test")
