"""K8 on Hopper (csrc/ocab_bwd.cu), HAT's OCAB core forward at (ws, ows)
= (7, 10) and (8, 12), in the PyTorch port against the JAX package, fp32
on the CPU: the three launches' schedule written out in torch ops — q,
k, v gathered head-major (``fused_ocab.to_heads``' swizzled rows), the
attention over (window, head) units with each row's max and 1 / sum (0
and 0 on ws 7's pad rows), K5a's OCAB tail over units of one window (x1
= sw + O Wproj^T + b, LN2, fc1, GELU and fc2 summed over the hidden
chunks in fp32, then fc2's bias and the residual; the pad rows dropped)
on ``pack_ocab_tiles``' operands — against ``ocab_core_plain`` and the
JAX ``fused_ocab_core`` in interpret mode, both GELU forms; K8b's
backward from the forward's kept O and row statistics against the
backward with the attention recomputed (bit for bit) and against the
plain and JAX gradients; the wrapper's buffers and C arguments (one
weight pack a call, handed to K8b; the kept head-major q, k, v, O and
row statistics at the addresses the backward reads) with the C entries
replaced by recorders; ``ocab_fwd_bytes``.  Bounds: forwards 3e-5 max
abs; gradients atol 2e-4 / rtol 1e-3 (the JAX package's own
kernel-vs-vjp bound)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ocab import _LINEAR, _W_ORDER, _jax_core, _t
from tests.test_torch_ocab_wg import BW, HIDDEN, NH, _schedule
from tests.util_torchport import TOL

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3


def _tail_forward(s, o):
    """K5a's OCAB tail (MODE_OFWD) per unit of one window, in torch ops:
    x1 = sw + O Wproj^T + b over the unit's 64 rows (ws 7's pad rows zero
    in sw and O), LN2, per 64-column hidden chunk fc1, GELU and fc2 summed
    in fp32, then fc2's bias and the residual; the real rows stored."""
    from tpu_superresolution_torch.kernels.fused_block import _ln_stats

    w = s.w
    x1 = s._pad_rows(s.sw) + o @ s.wp.T + w.bproj
    n2, _ = _ln_stats(x1)
    y2 = n2 * w.g2 + w.b2
    acc = torch.zeros_like(x1)
    for j in range(s.chunks):
        hc = slice(64 * j, min(64 * j + 64, w.hidden))
        acc = acc + s.gelu(y2 @ w.wfc1[hc].T + w.bfc1[hc]) @ w.wfc2[:, hc].T
    return ((x1 + acc) + w.bfc2)[:, :s.nq]


_CASES = [(7, True), (7, False), (8, True), (8, False)]
_IDS = [f"ws{ws}-{'tanh' if g else 'erf'}" for ws, g in _CASES]


@pytest.mark.parametrize("ws,gelu_approx", _CASES, ids=_IDS)
def test_schedule_forward_matches_plain_and_jax_kernel(ws, gelu_approx):
    """The gather, the attention (O, row statistics) and K5a's tail
    against ocab_core_plain and the JAX fused_ocab_core in interpret
    mode."""
    from tpu_superresolution_torch.kernels.fused_ocab import ocab_core_plain

    s, acts, w, bias, pw, _ = _schedule(ws, gelu_approx, 30 + 2 * ws + gelu_approx)
    o, stat = s.attention_forward()
    got = _tail_forward(s, o).numpy()
    plain = ocab_core_plain(*(_t(acts[k]) for k in ("q", "k", "v", "sw")), pw, _t(bias),
                            gelu_approx).numpy()
    args = [jnp.asarray(acts[k]) for k in ("q", "k", "v", "sw")] + [
        jnp.asarray(w[k]) for k in _W_ORDER] + [jnp.asarray(bias)]
    want = np.asarray(_jax_core(True, NH, gelu_approx)(*args))
    assert got.shape == want.shape == (BW, ws * ws, w["wproj"].shape[0])
    assert np.abs(got - plain).max() <= TOL
    assert np.abs(got - want).max() <= TOL
    assert not o[:, s.nq:].any() and not stat[..., s.nq:].any()  # ws 7's pad rows


@pytest.mark.parametrize("ws", [7, 8])
def test_backward_from_kept_forward_equals_recompute(ws):
    """K8b on the forward's kept O and row statistics gives the same bits
    as K8b recomputing them from the window-layout q, k, v (its former
    gather and attention-forward launches), and both match the plain and
    JAX gradients."""
    from tpu_superresolution_torch.kernels.fused_ocab import ocab_core_bwd_plain

    s, acts, w, bias, pw, ct = _schedule(ws, True, 50 + ws)
    kept_o, kept_stat = s.attention_forward()  # K8's launch 1, kept

    def backward(sched, o, stat):
        dsw, do, drow, ops = sched.middle(_t(ct), o)
        dq, dk, dv, dbias = sched.attention_backward(do, drow, stat)
        return dict(dq=sched.back_to_tokens(dq), dk=sched.back_to_tokens(dk),
                    dv=sched.back_to_tokens(dv), dsw=dsw, bias=dbias,
                    **sched.weight_grads(ops))

    kept = backward(s, kept_o, kept_stat)
    fresh, *_ = _schedule(ws, True, 50 + ws)  # the recompute, from the window layout
    recomputed = backward(fresh, *fresh.attention_forward())
    for name, g in kept.items():
        assert torch.equal(g, recomputed[name]), name
    plain = ocab_core_bwd_plain(_t(ct), *(_t(acts[k]) for k in ("q", "k", "v", "sw")), pw,
                                _t(bias), True)
    args = [jnp.asarray(acts[k]) for k in ("q", "k", "v", "sw")] + [
        jnp.asarray(w[k]) for k in _W_ORDER] + [jnp.asarray(bias)]
    _, vjp = jax.vjp(_jax_core(True, NH, True), *args)
    jg = vjp(jnp.asarray(ct))
    jax_grads = dict(zip(("dq", "dk", "dv", "dsw"), jg[:4]))
    jax_grads.update({k: np.asarray(g).T if k in _LINEAR else g
                      for k, g in zip(_W_ORDER, jg[4:12])})
    jax_grads["bias"] = jg[12]
    for name, g in kept.items():
        np.testing.assert_allclose(g.numpy(), getattr(plain, name).numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=f"{name} vs plain")
        np.testing.assert_allclose(g.numpy(), np.asarray(jax_grads[name]), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=f"{name} vs JAX")


@pytest.fixture
def recorded_entries(monkeypatch):
    """The K8 / K8b C entries replaced by recorders of their arguments
    (CPU tensors stand in for the card's; `_lib.call` calls the
    recorder), and ``pack_ocab_tiles`` counted."""
    from tpu_superresolution_torch.kernels import _lib
    from tpu_superresolution_torch.kernels import fused_ocab as fo

    calls, packs = [], []

    def entry(name):
        def record(*args):
            assert len(args) == len(_lib._SIGNATURES[name]), name
            calls.append((name, args))
            return 0
        return record

    lib = types.SimpleNamespace(**{n: entry(n) for n in ("sr_ocab_fwd_bf16", "sr_ocab_bwd_bf16")})
    monkeypatch.setattr(_lib, "library", lambda: lib)
    monkeypatch.setattr(_lib, "call", lambda t, fn, *args: fn(*args))
    monkeypatch.setattr(_lib, "sm_count", lambda index: 6)
    monkeypatch.setattr(_lib, "stream_of", lambda t: 0)
    pack = fo.pack_ocab_tiles
    monkeypatch.setattr(fo, "pack_ocab_tiles", lambda w: packs.append(1) or pack(w))
    fo.launches.reset()
    fo.launches_bwd.reset()
    return calls, packs


@pytest.mark.parametrize("ws", [7, 8])
def test_training_call_packs_once_and_keeps_the_forward(ws, recorded_entries):
    """``OcabCoreFunction``: one ``pack_ocab_tiles`` pack a call, K8's
    launch (18 pointers) writing the head-major q, k, v, O and the row
    statistics into one kept buffer,
    and K8b's (27 pointers) reading those five addresses, each counted
    once; the plan in both geometries."""
    from tpu_superresolution_torch.kernels import fused_ocab as fo

    calls, packs = recorded_entries
    c, nh, hidden, bw = 24, NH, HIDDEN, 5
    ows = ws + ws // 2
    nq, nk = ws * ws, ows * ows
    g = torch.Generator().manual_seed(ws)
    bf = torch.bfloat16
    q, sw = (torch.randn(bw, nq, c, generator=g).to(bf) for _ in range(2))
    k, v = (torch.randn(bw, nk, c, generator=g).to(bf) for _ in range(2))
    bias = torch.randn(nh, nq, nk, generator=g)
    w = fo.OcabWeights(num_heads=nh, wproj=torch.randn(c, c), bproj=torch.randn(c),
                       g2=torch.randn(c), b2=torch.randn(c), wfc1=torch.randn(hidden, c),
                       bfc1=torch.randn(hidden), wfc2=torch.randn(c, hidden),
                       bfc2=torch.randn(c))
    params = [getattr(w, f).requires_grad_() for f in fo.GRAD_FIELDS]
    out = fo.OcabCoreFunction.apply(q, k, v, sw, bias, (nh, True), *params)
    assert out.shape == sw.shape and len(packs) == 1 and fo.launches.count == 1
    (name, fwd), = calls
    assert name == "sr_ocab_fwd_bf16"
    p = fo.ocab_bwd_plan(ws, ows, c, nh, hidden, bw, 6)
    sizes = fo.ocab_fwd_bytes(p, nh)
    kept = fwd[12:17]  # qh, kh, vh, o, stat
    unit = bw * nh * p.block.hdp * 2
    assert [a - kept[0] for a in kept[:3]] == [0, unit * nq, unit * (nq + nk)]
    assert kept[3] - kept[0] >= sizes["head-major q, k, v"]
    assert kept[4] - kept[3] >= sizes["O"] and all((a - kept[0]) % 256 == 0 for a in kept[3:])
    assert list(fwd[18]) == [bw, ws, ows, c, nh, hidden, p.block.cp, p.block.hdp,
                             p.block.stages, 1, p.grid, p.splits, p.cph]
    out.backward(torch.ones_like(out))
    assert len(packs) == 1 and fo.launches_bwd.count == 1 and fo.launches.count == 1
    name, bwd = calls[1]
    assert name == "sr_ocab_bwd_bf16" and bwd[13:18] == kept
    assert list(bwd[27]) == list(fwd[18])


@pytest.mark.parametrize("ws,c,nh,hidden,windows", [(7, 96, 6, 384, 800), (8, 96, 6, 384, 512),
                                                    (7, 180, 6, 360, 45)])
def test_ocab_fwd_bytes(ws, c, nh, hidden, windows):
    """K8's buffers: the head-major q, k, v and the row statistics as
    K8b's recompute once wrote them, O as K5a's workspace operand, x1's
    scratch a K5a slot's [64, cp] fp32."""
    from tpu_superresolution_torch.kernels.fused_ocab import ocab_bwd_plan, ocab_fwd_bytes

    ows = ws + ws // 2
    p = ocab_bwd_plan(ws, ows, c, nh, hidden, windows, 132)
    b = p.block
    assert ocab_fwd_bytes(p, nh) == {
        "head-major q, k, v": windows * nh * (ws * ws + 2 * ows * ows) * b.hdp * 2,
        "O": windows * b.kc * 64 * 64 * 2,
        "row statistics": windows * nh * 2 * 64 * 4,
        "x1 scratch": p.grid * 2 * 64 * b.cp * 4}
