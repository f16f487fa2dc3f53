"""K8 and K8b at (ws, ows) = (16, 24), upstream HAT-SRx4's OCAB in
training, in the PyTorch port against the JAX package, fp32 on the CPU:
the plain forward and backward (what the wrappers run on CPU tensors,
and what ``csrc/ocab16.cu`` is held to on the card) against
``fused_ocab_core`` in interpret mode (its Pallas forward and
backward); the attention backward tiled in plain ops (query tiles of 64
rows, keys in 64-row tiles, P rebuilt from each row's statistics, D =
rowsum(dO * O)) against the whole-window gradient (the Hopper kernels'
own schedule: tests/test_torch_ocab_ws16_wg.py); and the OCAB's routes
at ws 16.  Bounds: forward 3e-5
max abs; gradients atol 2e-4 / rtol 1e-3 (the JAX package's own
kernel-vs-vjp bound, as for K5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ocab import _LINEAR, _W_ORDER, _case, _port_weights, _t
from tests.util_torchport import TOL

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
WS, OWS, BW, C, NH, HIDDEN = 16, 24, 4, 32, 2, 64


def _jax_args(acts, w, bias):
    return [jnp.asarray(acts[k]) for k in ("q", "k", "v", "sw")] + [
        jnp.asarray(w[k]) for k in _W_ORDER] + [jnp.asarray(bias)]


def _jax_core(gelu_approx):
    """(q, k, v, sw, 8 weights, bias) -> the JAX Pallas core in interpret
    mode (256 and 576 tokens need no padding)."""
    from tpu_superresolution_tpu.ops.pallas import fused_ocab

    def f(q, k, v, sw, *args):
        *weights, bias = args
        return fused_ocab.fused_ocab_core(q, k, v, sw, *weights, bias, NH, C // NH,
                                          gelu_approx=gelu_approx, interpret=True, group=BW)

    return f


@pytest.mark.parametrize("gelu_approx", [True, False], ids=["tanh", "erf"])
def test_ocab_ws16_plain_forward_matches_jax_kernel(gelu_approx):
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels.fused_ocab import fused_ocab_core

    acts, w, bias, nh = _case(40 + gelu_approx, ws=WS, c=C, nh=NH, hidden=HIDDEN, bw=BW)
    want = np.asarray(_jax_core(gelu_approx)(*_jax_args(acts, w, bias)))
    reset_counters()
    got = fused_ocab_core(*(_t(acts[k]) for k in ("q", "k", "v", "sw")), _port_weights(w, nh),
                          _t(bias), gelu_approx).numpy()
    assert not any(read_counters().values())  # CPU tensors: the plain version ran
    assert got.shape == want.shape == (BW, WS * WS, C)
    assert np.abs(got - want).max() <= TOL


def test_ocab_ws16_plain_backward_matches_jax_kernel():
    """ocab_core_bwd_plain at (16, 24): dq, dk, dv, d sw, every weight
    gradient and the bias gradient against jax.vjp of the JAX core (its
    Pallas backward in interpret mode)."""
    from tpu_superresolution_torch.kernels.fused_ocab import fused_ocab_core_backward

    acts, w, bias, nh = _case(44, ws=WS, c=C, nh=NH, hidden=HIDDEN, bw=BW)
    ct = np.random.default_rng(45).standard_normal(acts["sw"].shape).astype(np.float32)
    _, vjp = jax.vjp(_jax_core(True), *_jax_args(acts, w, bias))
    jg = vjp(jnp.asarray(ct))
    got = fused_ocab_core_backward(_t(ct), *(_t(acts[k]) for k in ("q", "k", "v", "sw")),
                                   _port_weights(w, nh), _t(bias), True)
    for name, g in zip(("dq", "dk", "dv", "dsw"), jg[:4]):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(g), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    for name, g in zip(_W_ORDER, jg[4:12]):
        g = np.asarray(g)
        np.testing.assert_allclose(getattr(got, name).numpy(), g.T if name in _LINEAR else g,
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)
    np.testing.assert_allclose(got.bias.numpy(), np.asarray(jg[12]), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL, err_msg="bias")


def _tiled_attention_backward(q, k, v, bias, do, tile=64):
    """The attention part of K8b at ws 16 tiled, on [BW, nH, N, hd] fp32
    tensors: O and each row's log-sum-exp per query
    tile; then per key tile, over the query tiles in order, P =
    exp(S + bias - lse), dV += P^T dO, dS = P (dO V^T - D) with D =
    rowsum(dO * O), dQ += dS K, dK += dS^T Q; the bias gradient summed
    over windows.  Returns (dq, dk, dv, dbias)."""
    s = q @ k.transpose(-1, -2) + bias
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    o = torch.softmax(s, dim=-1) @ v
    d_row = (do * o).sum(-1, keepdim=True)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dbias = torch.zeros_like(bias)
    for k0 in range(0, k.shape[2], tile):
        ks, vs = k[:, :, k0:k0 + tile], v[:, :, k0:k0 + tile]
        for q0 in range(0, q.shape[2], tile):
            qs, dos = q[:, :, q0:q0 + tile], do[:, :, q0:q0 + tile]
            p = torch.exp(qs @ ks.transpose(-1, -2) + bias[:, q0:q0 + tile, k0:k0 + tile]
                          - lse[:, :, q0:q0 + tile])
            dv[:, :, k0:k0 + tile] += p.transpose(-1, -2) @ dos
            ds = p * (dos @ vs.transpose(-1, -2) - d_row[:, :, q0:q0 + tile])
            dbias[:, q0:q0 + tile, k0:k0 + tile] += ds.sum(0)
            dq[:, :, q0:q0 + tile] += ds @ ks
            dk[:, :, k0:k0 + tile] += ds.transpose(-1, -2) @ qs
    return dq, dk, dv, dbias


def test_ocab_ws16_tile_order_equals_the_whole_window_gradient():
    """A tiled attention backward (4 query tiles x 9 key tiles, dK / dV
    summed over the query tiles in order, P from the row log-sum-exp,
    the flash row term) gives the whole-window gradient of
    softmax(q k^T + bias) v."""
    rng = np.random.default_rng(46)
    n = lambda *s, sc=1.0: torch.from_numpy((sc * rng.standard_normal(s)).astype(np.float32))
    q, k, v = n(BW, NH, WS * WS, 16, sc=0.25), n(BW, NH, OWS * OWS, 16), n(BW, NH, OWS * OWS, 16)
    bias, do = n(NH, WS * WS, OWS * OWS, sc=0.5), n(BW, NH, WS * WS, 16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    lq, lk, lv, lb = leaves
    (torch.softmax(lq @ lk.transpose(-1, -2) + lb, dim=-1) @ lv).backward(do)
    got = _tiled_attention_backward(q, k, v, bias, do)
    for name, g, leaf in zip(("dq", "dk", "dv", "bias"), got, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_ocab_at_window_16_trains_through_the_fused_route(monkeypatch):
    """An OCAB of window 16 within K8's widths takes the fused route in
    training (K8's plain version here, K8w16 / K8bw16 on the card) and at
    inference too (K8w16 serves it, ``OCAB.takes_fused``); the
    wrapper's check takes (16, 24)."""
    from tpu_superresolution_torch.kernels import fused_ocab
    from tpu_superresolution_torch.kernels import window_attention as kw
    from tpu_superresolution_torch.kernels.fused_ocab import check_ocab_args, ocab_ok
    from tpu_superresolution_torch.models.hat import OCAB

    assert ocab_ok(WS, OWS, 180, 6, 360) and ocab_ok(WS, OWS, C, NH, HIDDEN)
    assert ocab_ok(WS, OWS, 180, 6, 720) and not ocab_ok(WS, OWS, 264, 6, 528)
    assert not ocab_ok(12, 18, C, NH, HIDDEN)
    ocab = OCAB(C, WS, 0.5, NH, True, 2.0, True)
    calls = []
    real_k8, real_k15 = fused_ocab.ocab_core_plain, kw.fused_window_attention_plain
    monkeypatch.setattr(fused_ocab, "ocab_core_plain", lambda *a: calls.append("k8") or real_k8(*a))
    monkeypatch.setattr(kw, "fused_window_attention_plain",
                        lambda *a: calls.append("k15") or real_k15(*a))
    x = torch.rand(1, 32, 16, C, generator=torch.Generator().manual_seed(0))
    ocab.train()(x).sum().backward()
    assert calls == ["k8"]
    with torch.no_grad():
        ocab.eval()(x)
    assert calls == ["k8", "k8"]
    _, w, bias, nh = _case(0, ws=WS, c=C, nh=NH, hidden=HIDDEN, bw=1)
    check_ocab_args((4, 256, C), (4, 576, C), (4, 256, C), _port_weights(w, nh), bias.shape)
