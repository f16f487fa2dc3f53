"""K8w16 and K8bw16 on Hopper (csrc/ocab16.cu), HAT's OCAB core at
(ws, ows) = (16, 24), in the PyTorch port against the JAX package, fp32
on the CPU: the kernels' schedule written out in torch ops — the
head-major operands (``fused_ocab.to_heads``' swizzled rows), the
forward's attention over (window, head) units with each row's max and
1 / sum kept, K5a's OCAB tail over 64-token units (fc2 summed over the
hidden chunks), K5a's middle, the attention backward's query-row and
key-row passes with each CTA's bias-gradient partial in its walk's order
and K5c's ordered sum, K5b's split dW sums — against the plain version
and the JAX ``fused_ocab_core`` in interpret mode, with both GELUs and a
CTA count that leaves a head's last CTA fewer windows; the launch plan
from static shapes; the serving route by shape; and a HAT of window 16
in eval mode against the JAX model.  Bounds: forward 3e-5 max abs;
gradients atol 2e-4 / rtol 1e-3 (the JAX package's own kernel-vs-vjp
bound)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_ocab import _LINEAR, _W_ORDER, _case, _port_weights, _t
from tests.util_torchport import TOL

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
WS, OWS, C, NH, HIDDEN = 16, 24, 32, 2, 96  # hidden 96: two chunks, the last half pad
BW, SMS = 5, 6  # 3 CTAs a head: windows (0, 3), (1, 4), (2)
NQ, NK = WS * WS, OWS * OWS
RED_SLICES = 8  # K5c's slices of rows


def _jax_args(acts, w, bias):
    return [jnp.asarray(acts[k]) for k in ("q", "k", "v", "sw")] + [
        jnp.asarray(w[k]) for k in _W_ORDER] + [jnp.asarray(bias)]


def _jax_core(gelu_approx):
    from tpu_superresolution_tpu.ops.pallas import fused_ocab

    def f(q, k, v, sw, *args):
        *weights, bias = args
        return fused_ocab.fused_ocab_core(q, k, v, sw, *weights, bias, NH, C // NH,
                                          gelu_approx=gelu_approx, interpret=True, group=BW)

    return f


def _ordered_sum(part):
    """K5c: rows of `part` summed in RED_SLICES slices in order, then the
    slices in order."""
    rows = part.shape[0]
    slices = [part[rows * i // RED_SLICES:rows * (i + 1) // RED_SLICES] for i in range(RED_SLICES)]
    out = torch.zeros_like(part[0])
    for s in slices:
        acc = torch.zeros_like(part[0])
        for r in s:
            acc = acc + r
        out = out + acc
    return out


def _from_stored(th):
    """The kernels' head-major tiles [BW, nH, N, hdp] -> logical rows
    (each row's swizzle undone)."""
    from tpu_superresolution_torch.kernels.fused_ocab import swizzled_positions

    bw, nh, n, hdp = th.shape
    pos = swizzled_positions(n, hdp)
    return th.reshape(bw, nh, n * hdp)[..., pos].reshape(bw, nh, n, hdp)


def _cta_walk(p, nh):
    """(head, CTA, windows in order) of the attention kernels' grid."""
    return [(hh, first, list(range(first, p.windows, p.cph)))
            for hh in range(nh) for first in range(p.cph)]


class _Schedule:
    """csrc/ocab16.cu's order of work in torch ops, fp32."""

    def __init__(self, q, k, v, sw, w, bias, gelu_approx):
        from tpu_superresolution_torch.kernels import fused_ocab as fo
        from tpu_superresolution_torch.kernels.fused_block import gelu

        self.fo, self.gelu = fo, lambda t: gelu(t, gelu_approx)
        self.gelu_approx = gelu_approx
        self.w, self.bias, self.sw = w, bias, sw
        self.nh, self.c = w.num_heads, w.dim
        self.plan = fo.ocab16_plan(self.c, self.nh, w.hidden, q.shape[0], SMS)
        hdp = self.plan.block.hdp
        self.hdp, self.hd = hdp, self.c // self.nh
        # the operands as the kernels read them, then their logical rows
        self.stored = [fo.to_heads(t, self.nh, hdp) for t in (q, k, v)]
        self.qh, self.kh, self.vh = (_from_stored(t) for t in self.stored)
        self.wp = F.pad(w.wproj.reshape(self.c, self.nh, self.hd),
                        (0, hdp - self.hd)).reshape(self.c, self.nh * hdp)
        self.chunks = -(-w.hidden // 64)

    def attention_forward(self):
        """Per (window, head) unit, per 64-query tile: the row max and sum
        online over the nine 64-key blocks, then P = exp(s - max) / sum
        and O += P V; O [BW, nH, NQ, hdp], stat [BW, nH, 2, NQ]."""
        bw = self.qh.shape[0]
        o = torch.zeros(bw, self.nh, NQ, self.hdp)
        stat = torch.zeros(bw, self.nh, 2, NQ)
        for hh, _, windows in _cta_walk(self.plan, self.nh):
            for wv in windows:
                for qt in range(NQ // 64):
                    rows = slice(64 * qt, 64 * qt + 64)
                    qs = self.qh[wv, hh, rows]
                    mx, l = torch.full((64,), -math.inf), torch.zeros(64)
                    for kb in range(NK // 64):
                        cols = slice(64 * kb, 64 * kb + 64)
                        s = qs @ self.kh[wv, hh, cols].T + self.bias[hh, rows, cols]
                        mn = torch.maximum(mx, s.max(1).values)
                        l = l * torch.exp(mx - mn) + torch.exp(s - mn[:, None]).sum(1)
                        mx = mn
                    inv = 1.0 / l
                    acc = torch.zeros(64, self.hdp)
                    for kb in range(NK // 64):
                        cols = slice(64 * kb, 64 * kb + 64)
                        s = qs @ self.kh[wv, hh, cols].T + self.bias[hh, rows, cols]
                        p = torch.exp(s - mx[:, None]) * inv[:, None]
                        acc = acc + p @ self.vh[wv, hh, cols]
                    o[wv, hh, rows] = acc
                    stat[wv, hh, 0, rows], stat[wv, hh, 1, rows] = mx, inv
        return o, stat

    def _units(self, o):
        """O as K5a's 64-token units: [units, 64, nH hdp]."""
        bw = o.shape[0]
        return o.permute(0, 2, 1, 3).reshape(bw * NQ // 64, 64, self.nh * self.hdp)

    def _x1_ln2(self, o_units):
        from tpu_superresolution_torch.kernels.fused_block import _ln_stats

        w = self.w
        x1 = self.sw.reshape(-1, 64, self.c) + o_units @ self.wp.T + w.bproj
        n2, r2 = _ln_stats(x1)
        return x1, n2, r2, n2 * w.g2 + w.b2

    def tail_forward(self, o):
        """K5a's OCAB tail over the units: x1, LN2, per hidden chunk fc1,
        GELU and fc2 summed in fp32, then the bias and the residual."""
        w = self.w
        x1, _, _, y2 = self._x1_ln2(self._units(o))
        acc = torch.zeros_like(x1)
        for j in range(self.chunks):
            hc = slice(64 * j, min(64 * j + 64, w.hidden))
            act = self.gelu(y2 @ w.wfc1[hc].T + w.bfc1[hc])
            acc = acc + act @ w.wfc2[:, hc].T
        return ((x1 + acc) + w.bfc2).reshape(self.sw.shape)

    def middle(self, ct, o):
        """K5a's middle per unit: the MLP forward and back, LN2's
        backward (dsw = dx1), dO = dattn Wproj into the head tiles and D =
        rowsum(dO O); the dW operands of the units."""
        from tpu_superresolution_torch.kernels.fused_block import gelu_grad

        w = self.w
        ou = self._units(o)
        x1, n2, r2, y2 = self._x1_ln2(ou)
        ctu = ct.reshape(-1, 64, self.c)
        dy2 = torch.zeros_like(x1)
        acts, dh1s = [], []
        for j in range(self.chunks):
            hc = slice(64 * j, min(64 * j + 64, w.hidden))
            h1 = y2 @ w.wfc1[hc].T + w.bfc1[hc]
            acts.append(self.gelu(h1))
            dh1 = (ctu @ w.wfc2[:, hc]) * gelu_grad(h1, self.gelu_approx)
            dh1s.append(dh1)
            dy2 = dy2 + dh1 @ w.wfc1[hc]
        g = w.g2
        s1 = (dy2 * g).mean(-1, keepdim=True)
        s2 = (dy2 * g * n2).mean(-1, keepdim=True)
        dx1 = ctu + r2 * (dy2 * g - s1 - n2 * s2)
        do = (dx1 @ self.wp).reshape(-1, NQ, self.nh, self.hdp).transpose(1, 2)
        drow = (do * o).sum(-1)
        ops = dict(o=ou, y2c=y2, act=torch.cat(acts, -1), dattn=dx1, dh1=torch.cat(dh1s, -1),
                   dmlp=ctu, ln=(dy2 * n2, dy2))
        return dx1.reshape(self.sw.shape), do, drow, ops

    def attention_backward(self, do, drow, stat):
        """Per CTA of a head, its windows in order: the query-row pass
        (dQ, the CTA's bias-gradient partial += dS block by block) and the
        key-row pass (dK, dV); K5c's ordered sum of a head's partials."""
        bw = do.shape[0]
        dq = torch.zeros_like(self.qh)
        dk, dv = torch.zeros_like(self.kh), torch.zeros_like(self.vh)
        part = torch.zeros(self.plan.cph, self.nh, NQ, NK)

        def probs(wv, hh, rows, cols):
            s = self.qh[wv, hh, rows] @ self.kh[wv, hh, cols].T + self.bias[hh, rows, cols]
            return torch.exp(s - stat[wv, hh, 0, rows, None]) * stat[wv, hh, 1, rows, None]

        for hh, first, windows in _cta_walk(self.plan, self.nh):
            for wv in windows:
                for qt in range(NQ // 64):
                    rows = slice(64 * qt, 64 * qt + 64)
                    acc = torch.zeros(64, self.hdp)
                    for kb in range(NK // 64):
                        cols = slice(64 * kb, 64 * kb + 64)
                        dp = do[wv, hh, rows] @ self.vh[wv, hh, cols].T
                        ds = probs(wv, hh, rows, cols) * (dp - drow[wv, hh, rows, None])
                        acc = acc + ds @ self.kh[wv, hh, cols]
                        part[first, hh, rows, cols] = part[first, hh, rows, cols] + ds
                    dq[wv, hh, rows] = acc
                for kt in range(NK // 64):
                    cols = slice(64 * kt, 64 * kt + 64)
                    ak, av = torch.zeros(64, self.hdp), torch.zeros(64, self.hdp)
                    for qb in range(NQ // 64):
                        rows = slice(64 * qb, 64 * qb + 64)
                        p = probs(wv, hh, rows, cols)
                        dpt = self.vh[wv, hh, cols] @ do[wv, hh, rows].T
                        dst = p.T * (dpt - drow[wv, hh, None, rows])
                        ak = ak + dst @ self.qh[wv, hh, rows]
                        av = av + p.T @ do[wv, hh, rows]
                    dk[wv, hh, cols], dv[wv, hh, cols] = ak, av
        dbias = _ordered_sum(part.reshape(self.plan.cph, -1)).reshape(self.nh, NQ, NK)
        return dq, dk, dv, dbias

    def weight_grads(self, ops):
        """K5b: dW = dY^T X and db = dY^T 1 per split of the units, then
        K5c's ordered sum of the splits; the LN2 sums likewise."""
        p = self.plan
        units = ops["o"].shape[0]
        bounds = [(units * s // p.splits, units * (s + 1) // p.splits) for s in range(p.splits)]

        def split_sum(fn):
            return _ordered_sum(torch.stack([fn(slice(a, b)) for a, b in bounds]))

        mm = lambda dy, x: lambda u: torch.einsum("utm,utn->mn", ops[dy][u], ops[x][u])
        cs = lambda dy: lambda u: ops[dy][u].sum((0, 1))
        wp = split_sum(mm("dattn", "o")).reshape(self.c, self.nh, self.hdp)[..., :self.hd]
        gn, gb = ops["ln"]
        return dict(wproj=wp.reshape(self.c, self.c), bproj=split_sum(cs("dattn")),
                    wfc1=split_sum(mm("dh1", "y2c")), bfc1=split_sum(cs("dh1")),
                    wfc2=split_sum(mm("dmlp", "act")), bfc2=split_sum(cs("dmlp")),
                    g2=gn.sum((0, 1)), b2=gb.sum((0, 1)))

    def back_to_tokens(self, th):
        """A head-major gradient (logical rows) -> [BW, N, C] through the
        kernels' stored layout and ``to_heads``' autograd."""
        from tpu_superresolution_torch.kernels.fused_ocab import swizzled_positions

        bw, nh, n, hdp = th.shape
        stored = torch.empty(bw, nh, n * hdp)
        stored[..., swizzled_positions(n, hdp)] = th.reshape(bw, nh, n * hdp)
        leaf = torch.zeros(bw, n, self.c, requires_grad=True)
        self.fo.to_heads(leaf, nh, hdp).backward(stored.reshape(bw, nh, n, hdp))
        return leaf.grad


def _schedule(gelu_approx, seed):
    acts, w, bias, nh = _case(seed, ws=WS, c=C, nh=NH, hidden=HIDDEN, bw=BW)
    ct = np.random.default_rng(seed + 1).standard_normal(acts["sw"].shape).astype(np.float32)
    pw = _port_weights(w, nh)
    s = _Schedule(*(_t(acts[k]) for k in ("q", "k", "v", "sw")), pw, _t(bias), gelu_approx)
    return s, acts, w, bias, pw, ct


@pytest.mark.parametrize("gelu_approx", [True, False], ids=["tanh", "erf"])
def test_schedule_forward_matches_plain_and_jax_kernel(gelu_approx):
    from tpu_superresolution_torch.kernels.fused_ocab import ocab_core_plain

    s, acts, w, bias, pw, _ = _schedule(gelu_approx, 60 + gelu_approx)
    assert s.plan.cph == 3 and [len(ws) for _, _, ws in _cta_walk(s.plan, NH)][:3] == [2, 2, 1]
    o, stat = s.attention_forward()
    got = s.tail_forward(o).numpy()
    plain = ocab_core_plain(*(_t(acts[k]) for k in ("q", "k", "v", "sw")), pw, _t(bias),
                            gelu_approx).numpy()
    want = np.asarray(_jax_core(gelu_approx)(*_jax_args(acts, w, bias)))
    assert np.abs(got - plain).max() <= TOL
    assert np.abs(got - want).max() <= TOL
    # the row statistics: the max and 1 / sum of each row's biased scores
    sc = s.qh @ s.kh.transpose(-1, -2) + s.bias
    np.testing.assert_allclose(stat[:, :, 0].numpy(), sc.max(-1).values.numpy(), atol=1e-6)
    inv = 1 / torch.exp(sc - sc.max(-1, keepdim=True).values).sum(-1)
    np.testing.assert_allclose(stat[:, :, 1].numpy(), inv.numpy(), rtol=1e-5)


@pytest.mark.parametrize("gelu_approx", [True, False], ids=["tanh", "erf"])
def test_schedule_backward_matches_plain_and_jax_kernel(gelu_approx):
    """dq, dk, dv through the stored head-major layout, dsw, every weight
    gradient and the bias gradient of the schedule against
    ocab_core_bwd_plain and jax.vjp of the JAX core (its Pallas backward
    in interpret mode)."""
    from tpu_superresolution_torch.kernels.fused_ocab import ocab_core_bwd_plain

    s, acts, w, bias, pw, ct = _schedule(gelu_approx, 70 + gelu_approx)
    o, stat = s.attention_forward()
    dsw, do, drow, ops = s.middle(_t(ct), o)
    dq, dk, dv, dbias = s.attention_backward(do, drow, stat)
    got = dict(dq=s.back_to_tokens(dq), dk=s.back_to_tokens(dk), dv=s.back_to_tokens(dv),
               dsw=dsw, bias=dbias, **s.weight_grads(ops))
    plain = ocab_core_bwd_plain(_t(ct), *(_t(acts[k]) for k in ("q", "k", "v", "sw")), pw,
                                _t(bias), gelu_approx)
    _, vjp = jax.vjp(_jax_core(gelu_approx), *_jax_args(acts, w, bias))
    jg = vjp(jnp.asarray(ct))
    jax_grads = dict(zip(("dq", "dk", "dv", "dsw"), jg[:4]))
    jax_grads.update({k: np.asarray(g).T if k in _LINEAR else g
                      for k, g in zip(_W_ORDER, jg[4:12])})
    jax_grads["bias"] = jg[12]
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), getattr(plain, name).numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=f"{name} vs plain")
        np.testing.assert_allclose(g.numpy(), np.asarray(jax_grads[name]), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=f"{name} vs JAX")


def test_head_major_layout_round_trips_and_matches_the_swizzle():
    """``to_heads``: each head's rows hd-padded with zeros, 16-byte chunk j
    of row r stored at j ^ ((r 2 hdp / 128) % (2 hdp / 16)); its autograd
    is ``from_heads``."""
    from tpu_superresolution_torch.kernels.fused_ocab import from_heads, to_heads

    x = torch.randn(3, NK, 180, generator=torch.Generator().manual_seed(0))
    th = to_heads(x, 6, 32)
    assert th.shape == (3, 6, NK, 32)
    assert torch.equal(from_heads(th, 180), x)
    logical = th.reshape(3, 6, NK, 4, 8)
    for r in (0, 1, 2, 5, 575):
        for j in range(4):
            want = x[:, r].reshape(3, 6, 30)
            want = F.pad(want, (0, 2))[:, :, 8 * j:8 * j + 8]
            assert torch.equal(logical[:, :, r, j ^ ((r * 64 // 128) % 4)], want)
    leaf = x.clone().requires_grad_()
    g = torch.randn(th.shape, generator=torch.Generator().manual_seed(1))
    to_heads(leaf, 6, 32).backward(g)
    assert torch.equal(leaf.grad, from_heads(g, 180))


@pytest.mark.parametrize("b,h,w,c,nh,hdp", [(2, 32, 48, 30, 2, 16), (1, 16, 16, 180, 6, 32),
                                             (2, 48, 32, 24, 2, 16)])
def test_map_heads_equals_partition_overlap_and_to_heads(b, h, w, c, nh, hdp):
    """``map_heads_plain`` (the plain version of K8w16's gather: one padded
    copy of the qkv map, three gathers over its overlap windows) gives the
    window partition of q and the overlap gathers of k and v (zero
    border, p_lo 4) through ``to_heads``; ``map_heads_bwd_plain`` (the
    plain version of the gather's backward: the gradients written back
    into their windows, the overlaps summed in a fixed order) equals
    autograd of that chain, the same bits twice."""
    from tpu_superresolution_torch.kernels.fused_ocab import (
        map_heads_bwd_plain,
        map_heads_plain,
        to_heads,
    )
    from tpu_superresolution_torch.ops.window import overlap_windows, window_partition

    gen = torch.Generator().manual_seed(b * h + w)
    qkv = torch.randn(b, h, w, 3 * c, generator=gen, dtype=torch.float64).requires_grad_()
    got = map_heads_plain(qkv, nh, hdp)
    q, k, v = qkv.chunk(3, -1)
    want = (to_heads(window_partition(q, WS), nh, hdp),
            to_heads(overlap_windows(k, WS, OWS), nh, hdp),
            to_heads(overlap_windows(v, WS, OWS), nh, hdp))
    for g, t in zip(got, want):
        assert torch.equal(g, t)
    cts = [torch.randn(t.shape, generator=gen, dtype=torch.float64) for t in want]
    chain = torch.autograd.grad(want, qkv, cts)[0]
    plain = map_heads_bwd_plain(*cts, qkv.shape, nh, hdp)
    np.testing.assert_allclose(plain.numpy(), chain.numpy(), atol=1e-12)
    np.testing.assert_allclose(torch.autograd.grad(got, qkv, cts)[0].numpy(), chain.numpy(),
                               atol=1e-12)
    assert torch.equal(plain, map_heads_bwd_plain(*cts, qkv.shape, nh, hdp))
    # bf16 operands: summed in fp32, rounded once
    c16 = [t.to(torch.bfloat16) for t in cts]
    want16 = map_heads_bwd_plain(*(t.float() for t in c16), qkv.shape, nh, hdp)
    got16 = map_heads_bwd_plain(*c16, qkv.shape, nh, hdp)
    assert got16.dtype == torch.bfloat16
    assert torch.equal(got16, want16.to(torch.bfloat16))


@pytest.mark.parametrize("c,nh,hidden,windows,sms", [
    (180, 6, 360, 128, 132), (180, 6, 360, 400, 132), (144, 6, 288, 128, 132),
    (32, 2, 96, 5, 6), (96, 6, 192, 1, 132), (180, 6, 720, 128, 132)])
def test_launch_plan_from_static_shapes(c, nh, hidden, windows, sms):
    """CTAs a head, rounds, the bias-gradient partials' bytes and every
    kernel's shared memory within a CTA's 232,448 bytes."""
    from tpu_superresolution_torch.kernels.fused_ocab import OCAB16_SMEM, ocab16_bytes, ocab16_plan

    p = ocab16_plan(c, nh, hidden, windows, sms)
    assert p.cph == max(1, min(windows, sms // nh)) and p.cph * nh <= max(sms, nh)
    assert p.units == 4 * windows and 1 <= p.grid <= min(sms, -(-p.units // 2))
    assert p.rounds == -(-windows // p.cph) and 0 < p.tail_ctas <= nh * p.cph
    assert max(p.block.smem, p.att_fwd_smem, p.att_bwd_smem) <= OCAB16_SMEM
    sizes = ocab16_bytes(p, nh)
    assert sizes["bias-gradient partials"] == p.cph * nh * NQ * NK * 4
    assert sizes["O"] == p.units * p.block.kc * 64 * 64 * 2
    if (c, windows) == (180, 128):
        assert (p.cph, p.att_bwd_smem) == (22, 220192)
        assert sizes["bias-gradient partials"] == 77_856_768  # not 453 MB


@pytest.mark.parametrize("ws,c,hidden,fused", [
    (16, 32, 64, True), (16, 180, 360, True), (16, 180, 720, True), (16, 264, 528, False),
    (7, 32, 64, False), (8, 32, 64, False)])
def test_serving_route_by_shape(ws, c, hidden, fused):
    """Eval-mode OCABs take the fused route at (16, 24) within ``ocab_ok``
    (the card's choice, ``OCAB.takes_fused``; any hidden) and the module
    path elsewhere (C 264 in 6 heads: hd 44); training takes it wherever
    ``ocab_ok`` holds."""
    from tpu_superresolution_torch.models.hat import OCAB

    ocab = OCAB(c, ws, 0.5, 2 if c == 32 else 6, True, hidden / c, True)
    assert (ocab.window_size, ocab.overlap_win_size) == (ws, ws + ws // 2)
    assert ocab.eval().takes_fused() == fused
    assert ocab.train().takes_fused() == ocab.takes_k8() == (c <= 192)


@pytest.mark.parametrize("gelu_approx", [True, False], ids=["tanh", "erf"])
def test_hat_window_16_eval_matches_jax_model(gelu_approx):
    """A HAT of window 16 at small width (embed 24, depths (2, 2)) in eval
    mode on the CPU, its OCABs on the serving route (K8w16's plain version
    here), against the JAX model's forward."""
    from tests.test_torch_hat import small_hat_config
    from tests.util_torchport import jax_forward, perturbed_jax_swinir, port_forward, port_from_jax
    from tpu_superresolution_torch.kernels import fused_ocab
    from tpu_superresolution_torch.models.hat import OCAB

    cfg = small_hat_config(window_size=16, gelu_approximate=gelu_approx)
    model, variables = perturbed_jax_swinir(cfg, (16, 16))
    x = np.random.default_rng(9).random((1, 18, 33, 3), dtype=np.float32)
    want = jax_forward(model, variables, x)
    port = port_from_jax(cfg, variables)
    ocabs = [m for m in port.modules() if isinstance(m, OCAB)]
    assert len(ocabs) == 2 and all(not m.training and m.takes_fused() for m in port.eval().modules()
                                   if isinstance(m, OCAB))
    calls, real = [], fused_ocab.ocab_core_plain
    fused_ocab.ocab_core_plain = lambda *a: calls.append(1) or real(*a)
    try:
        got = port_forward(port, x)
    finally:
        fused_ocab.ocab_core_plain = real
    assert len(calls) == len(ocabs)
    assert got.shape == want.shape == (1, 72, 132, 3)
    assert np.abs(got - want).max() <= TOL
