"""K8b on Hopper (csrc/ocab_bwd.cu), the backward of HAT's OCAB core at
(ws, ows) = (7, 10) and (8, 12), in the PyTorch port against the JAX
package, fp32 on the CPU: the kernels' schedule written out in torch ops
— the head-major operands (``fused_ocab.to_heads``' swizzled rows) in
tiles of 64 query rows and 128 / 192 key rows whose pad rows are zero,
the gathered bias with 0 on the pad query rows and -inf on the pad keys
(the zero border keys of the overlap gather stay real keys), the
recomputed attention forward over (window, head) units with each row's
max and 1 / sum (0 and 0 on the pad rows), K5a's middle over units of
one window, the attention backward's query-row and key-row passes (dq,
dk, dv stored in the window layout) with two windows a stage, a consumer
each, each consumer's bias-gradient partial summed over its windows, the
two added in order at the CTA's end and K5c's ordered sum over the CTAs,
K5b's split dW sums — against ``ocab_core_bwd_plain`` and the JAX
``fused_ocab_core`` vjp in interpret mode, with both GELUs and a CTA
count that leaves the last CTA fewer windows and a last stage of one
window; the gather kernel's addressing into the head-major layout; the
launch plan from static shapes. Bounds: gradients atol 2e-4
/ rtol 1e-3 (the JAX package's own kernel-vs-vjp bound); the row
statistics 1e-6 / 1e-5."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_ocab import _LINEAR, _W_ORDER, _case, _jax_core, _port_weights, _t
from tests.test_torch_ocab_ws16_wg import _from_stored, _ordered_sum

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
C, NH, HIDDEN = 24, 2, 112  # hidden 112: two 64-column chunks, the last part pad
BW, SMS = 8, 6  # 3 CTAs a head: windows (0, 3, 6), (1, 4, 7), (2, 5)
ROWS = 64  # a unit's query rows


def _cta_walk(p, nh):
    """(head, CTA, windows in order) of the attention kernels' grid."""
    return [(hh, first, list(range(first, p.windows, p.cph)))
            for hh in range(nh) for first in range(p.cph)]


class _Schedule:
    """csrc/ocab_bwd.cu's order of work in torch ops, fp32."""

    def __init__(self, q, k, v, sw, w, bias, gelu_approx):
        from tpu_superresolution_torch.kernels import fused_ocab as fo
        from tpu_superresolution_torch.kernels.fused_block import gelu

        self.fo, self.gelu = fo, lambda t: gelu(t, gelu_approx)
        self.gelu_approx = gelu_approx
        self.w, self.sw = w, sw
        self.nh, self.c = w.num_heads, w.dim
        bw, self.nq, _ = q.shape
        self.nk = k.shape[1]
        self.ws, self.ows = math.isqrt(self.nq), math.isqrt(self.nk)
        self.plan = fo.ocab_bwd_plan(self.ws, self.ows, self.c, self.nh, w.hidden, bw, SMS)
        hdp = self.plan.block.hdp
        self.hdp, self.hd = hdp, self.c // self.nh
        self.nkp = -(-self.nk // 64) * 64
        # the operands as the kernels store them, their logical rows, and the
        # shared-memory tiles: zero past the real rows
        self.stored = [fo.to_heads(t, self.nh, hdp) for t in (q, k, v)]
        qh, kh, vh = (_from_stored(t) for t in self.stored)
        self.qt = F.pad(qh, (0, 0, 0, ROWS - self.nq))
        self.kt = F.pad(kh, (0, 0, 0, self.nkp - self.nk))
        self.vt = F.pad(vh, (0, 0, 0, self.nkp - self.nk))
        # the bias as the kernels read it: 0 on the pad query rows, -inf on the pad keys
        bt = torch.full((self.nh, ROWS, self.nkp), -math.inf)
        bt[:, :, :self.nk] = 0.0
        bt[:, :self.nq, :self.nk] = bias
        self.bt = bt
        self.wp = F.pad(w.wproj.reshape(self.c, self.nh, self.hd),
                        (0, hdp - self.hd)).reshape(self.c, self.nh * hdp)
        self.chunks = -(-w.hidden // 64)

    def _pad_rows(self, t):
        return F.pad(t, (0, 0, 0, ROWS - self.nq))

    def attention_forward(self):
        """Per (window, head) unit: the row max and sum online over the
        64-key blocks, then P = exp(s - max) / sum and O += P V; the pad
        rows' O zero and statistics (0, 0).  O [BW, 64, nH hdp] (K5a's
        units), stat [BW, nH, 2, 64]."""
        bw = self.qt.shape[0]
        o = torch.zeros(bw, ROWS, self.nh * self.hdp)
        stat = torch.zeros(bw, self.nh, 2, ROWS)
        real = torch.arange(ROWS) < self.nq
        for hh, _, windows in _cta_walk(self.plan, self.nh):
            for wv in windows:
                mx, l = torch.full((ROWS,), -math.inf), torch.zeros(ROWS)
                for kb in range(self.nkp // 64):
                    cols = slice(64 * kb, 64 * kb + 64)
                    s = self.qt[wv, hh] @ self.kt[wv, hh, cols].T + self.bt[hh, :, cols]
                    mn = torch.maximum(mx, s.max(1).values)
                    l = l * torch.exp(mx - mn) + torch.exp(s - mn[:, None]).sum(1)
                    mx = mn
                inv = 1.0 / l
                acc = torch.zeros(ROWS, self.hdp)
                for kb in range(self.nkp // 64):
                    cols = slice(64 * kb, 64 * kb + 64)
                    s = self.qt[wv, hh] @ self.kt[wv, hh, cols].T + self.bt[hh, :, cols]
                    acc = acc + (torch.exp(s - mx[:, None]) * inv[:, None]) @ self.vt[wv, hh, cols]
                o[wv, :, hh * self.hdp:(hh + 1) * self.hdp] = torch.where(real[:, None], acc, 0.0)
                stat[wv, hh, 0] = torch.where(real, mx, 0.0)
                stat[wv, hh, 1] = torch.where(real, inv, 0.0)
        return o, stat

    def middle(self, ct, o):
        """K5a's middle per unit of one window (the pad rows' sw and ct
        zero): the MLP forward and back, LN2's backward (dsw = dx1), dO =
        dattn Wproj into the head tiles [BW, nH, 64, hdp] and D = rowsum(dO
        O); the dW operands of the units."""
        from tpu_superresolution_torch.kernels.fused_block import _ln_stats, gelu_grad

        w = self.w
        x1 = self._pad_rows(self.sw) + o @ self.wp.T + w.bproj
        n2, r2 = _ln_stats(x1)
        y2 = n2 * w.g2 + w.b2
        ctu = self._pad_rows(ct)
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
        assert not dx1[:, self.nq:].any()  # the pad rows' dx1, so dO and D, are 0
        oh = o.reshape(-1, ROWS, self.nh, self.hdp).transpose(1, 2)
        do = (dx1 @ self.wp).reshape(-1, ROWS, self.nh, self.hdp).transpose(1, 2)
        drow = (do * oh).sum(-1)
        ops = dict(o=o, y2c=y2, act=torch.cat(acts, -1), dattn=dx1, dh1=torch.cat(dh1s, -1),
                   dmlp=ctu, ln=(dy2 * n2, dy2))
        return dx1[:, :self.nq], do, drow, ops

    def attention_backward(self, do, drow, stat):
        """Per CTA of a head, its windows two a stage, window 2 i + cw
        consumer cw's: the query-row pass (dQ, the consumer's partial +=
        dS block by block) and the key-row pass (dK, dV); at the CTA's end
        its partial = consumer 0's + consumer 1's; K5c's ordered sum over
        a head's CTAs."""
        dq = torch.zeros_like(self.qt)
        dk, dv = torch.zeros_like(self.kt), torch.zeros_like(self.vt)
        prpb = torch.zeros(self.plan.cph, self.nh, self.nq, self.nk)

        def probs(wv, hh, cols):
            s = self.qt[wv, hh] @ self.kt[wv, hh, cols].T + self.bt[hh, :, cols]
            return torch.exp(s - stat[wv, hh, 0, :, None]) * stat[wv, hh, 1, :, None]

        for hh, first, windows in _cta_walk(self.plan, self.nh):
            part = torch.zeros(2, ROWS, self.nkp)
            for i in range(-(-len(windows) // 2)):
                for cw in range(2):
                    j = 2 * i + cw
                    if j >= len(windows):
                        continue  # the last stage's idle consumer
                    wv = windows[j]
                    acc = torch.zeros(ROWS, self.hdp)
                    for kb in range(self.nkp // 64):
                        cols = slice(64 * kb, 64 * kb + 64)
                        dp = do[wv, hh] @ self.vt[wv, hh, cols].T
                        ds = probs(wv, hh, cols) * (dp - drow[wv, hh, :, None])
                        acc = acc + ds @ self.kt[wv, hh, cols]
                        part[cw, :, cols] = part[cw, :, cols] + ds
                    dq[wv, hh] = acc
                    for kt in range(self.nkp // 64):
                        cols = slice(64 * kt, 64 * kt + 64)
                        p = probs(wv, hh, cols)
                        dpt = self.vt[wv, hh, cols] @ do[wv, hh].T
                        dst = p.T * (dpt - drow[wv, hh, None, :])
                        dk[wv, hh, cols] = dst @ self.qt[wv, hh]
                        dv[wv, hh, cols] = p.T @ do[wv, hh]
            prpb[first, hh] = (part[0] + part[1])[:self.nq, :self.nk]
        dbias = _ordered_sum(prpb.reshape(self.plan.cph, -1)).reshape(self.nh, self.nq, self.nk)
        return (dq[:, :, :self.nq], dk[:, :, :self.nk], dv[:, :, :self.nk], dbias)

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
        """A head's [n, hdp] gradient rows -> the window layout [BW, N, C]
        as the backward kernel stores them: dim d < hd of head h at column
        h hd + d."""
        bw, nh, n, _ = th.shape
        return th[..., :self.hd].transpose(1, 2).reshape(bw, n, nh * self.hd)


def _schedule(ws, gelu_approx, seed):
    acts, w, bias, nh = _case(seed, ws=ws, c=C, nh=NH, hidden=HIDDEN, bw=BW)
    ct = np.random.default_rng(seed + 1).standard_normal(acts["sw"].shape).astype(np.float32)
    pw = _port_weights(w, nh)
    s = _Schedule(*(_t(acts[k]) for k in ("q", "k", "v", "sw")), pw, _t(bias), gelu_approx)
    return s, acts, w, bias, pw, ct


_CASES = [(7, True), (7, False), (8, True), (8, False)]
_IDS = [f"ws{ws}-{'tanh' if g else 'erf'}" for ws, g in _CASES]


@pytest.mark.parametrize("ws,gelu_approx", _CASES, ids=_IDS)
def test_schedule_backward_matches_plain_and_jax_kernel(ws, gelu_approx):
    """dq, dk, dv stored in the window layout, dsw, every weight
    gradient and the bias gradient of the schedule against
    ocab_core_bwd_plain and jax.vjp of the JAX core (its Pallas backward
    in interpret mode)."""
    from tpu_superresolution_torch.kernels.fused_ocab import ocab_core_bwd_plain

    s, acts, w, bias, pw, ct = _schedule(ws, gelu_approx, 80 + 2 * ws + gelu_approx)
    assert s.plan.cph == 3 and [len(x) for _, _, x in _cta_walk(s.plan, NH)][:3] == [3, 3, 2]
    o, stat = s.attention_forward()
    dsw, do, drow, ops = s.middle(_t(ct), o)
    dq, dk, dv, dbias = s.attention_backward(do, drow, stat)
    got = dict(dq=s.back_to_tokens(dq), dk=s.back_to_tokens(dk), dv=s.back_to_tokens(dv),
               dsw=dsw, bias=dbias, **s.weight_grads(ops))
    plain = ocab_core_bwd_plain(_t(ct), *(_t(acts[k]) for k in ("q", "k", "v", "sw")), pw,
                                _t(bias), gelu_approx)
    args = [jnp.asarray(acts[k]) for k in ("q", "k", "v", "sw")] + [
        jnp.asarray(w[k]) for k in _W_ORDER] + [jnp.asarray(bias)]
    _, vjp = jax.vjp(_jax_core(True, NH, gelu_approx), *args)
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


@pytest.mark.parametrize("ws", [7, 8])
def test_schedule_attention_forward_row_statistics(ws):
    """The recomputed forward's O equals the plain attention output of
    every head (the pad rows zero) and its row statistics the max and
    1 / sum of each real row's biased scores over the real keys."""
    s, acts, *_ = _schedule(ws, True, 90 + ws)
    o, stat = s.attention_forward()
    q, k, v = (_from_stored(t) for t in s.stored)
    sc = q @ k.transpose(-1, -2) + s.bt[:, :s.nq, :s.nk]
    a = torch.softmax(sc, -1)
    want = (a @ v).transpose(1, 2).reshape(BW, s.nq, NH * s.hdp)
    np.testing.assert_allclose(o[:, :s.nq].numpy(), want.numpy(), atol=1e-6)
    assert not o[:, s.nq:].any() and not stat[..., s.nq:].any()
    np.testing.assert_allclose(stat[:, :, 0, :s.nq].numpy(), sc.max(-1).values.numpy(), atol=1e-6)
    inv = 1 / torch.exp(sc - sc.max(-1, keepdim=True).values).sum(-1)
    np.testing.assert_allclose(stat[:, :, 1, :s.nq].numpy(), inv.numpy(), rtol=1e-5)


@pytest.mark.parametrize("n,c,nh,hdp", [(49, 96, 6, 16), (144, 180, 6, 32), (100, 45, 3, 16)])
def test_gather_kernel_addressing_gives_to_heads(n, c, nh, hdp):
    """``ocab_win_heads_kernel``'s addressing written out per thread, a
    thread a 16-byte chunk of a part's output in order: chunk i is (unit,
    row r, stored chunk js), and holds dims 8 j .. 8 j + 7 of the row's
    head (j = js ^ ((2 hdp r >> 7) & (2 hdp / 16 - 1))), zero past hd (odd
    at C 45) — exactly ``to_heads``' layout."""
    from tpu_superresolution_torch.kernels.fused_ocab import to_heads

    bw = 3
    t = torch.randn(bw, n, c, generator=torch.Generator().manual_seed(n + c))
    src, hd, cpr, rb = t.numpy(), c // nh, hdp // 8, 2 * hdp
    dst = np.full((bw * nh * n * cpr, 8), np.nan, np.float32)
    for i in range(len(dst)):
        unit, rem = divmod(i, n * cpr)
        r, js = divmod(rem, cpr)
        j = js ^ (((r * rb) >> 7) & (rb // 16 - 1))
        win, hh = divmod(unit, nh)
        for e in range(8):
            d = 8 * j + e
            dst[i, e] = src[win, r, hh * hd + d] if d < hd else 0.0
    assert torch.equal(torch.from_numpy(dst).reshape(bw, nh, n, hdp), to_heads(t, nh, hdp))


@pytest.mark.parametrize("ws,c,nh,hidden,windows,sms", [
    (7, 96, 6, 384, 800, 132), (8, 96, 6, 384, 512, 132), (7, 180, 6, 360, 45, 132),
    (8, 64, 2, 200, 25, 132), (7, 24, 2, 112, 8, 6), (8, 96, 6, 384, 1, 132),
    (7, 180, 6, 720, 800, 132), (8, 180, 6, 720, 512, 132)])
def test_launch_plan_from_static_shapes(ws, c, nh, hidden, windows, sms):
    """CTAs a head, K5a's grid, K5b's splits, every kernel's shared memory
    within a CTA's 232,448 bytes and the bias-gradient partials a
    [nq, nk] fp32 buffer a CTA (not a [256, 576] read-modify-write)."""
    from tpu_superresolution_torch.kernels.fused_ocab import (
        OCAB16_SMEM,
        ocab_bwd_bytes,
        ocab_bwd_plan,
        ocab_fwd_bytes,
    )

    ows = ws + ws // 2
    p = ocab_bwd_plan(ws, ows, c, nh, hidden, windows, sms)
    assert p.cph == max(1, min(windows, sms // nh)) and p.cph * nh <= max(sms, nh)
    assert 1 <= p.grid <= min(sms, -(-windows // 2)) and 1 <= p.splits <= windows
    assert max(p.block.smem, p.att_fwd_smem, p.att_bwd_smem) <= OCAB16_SMEM
    sizes = {**ocab_fwd_bytes(p, nh), **ocab_bwd_bytes(p, nh)}  # O: K8's, kept for K8b
    assert sizes["bias-gradient partials"] == p.cph * nh * ws * ws * ows * ows * 4
    assert sizes["O"] == windows * p.block.kc * 64 * 64 * 2
    assert sizes["dO tiles"] == windows * nh * 64 * p.block.hdp * 2
    if (ws, c, windows) == (8, 96, 512):
        assert (p.cph, p.att_bwd_smem) == (22, 148512)
        assert sizes["bias-gradient partials"] == 4_866_048  # 4.9 MB, not K8bw16's 906 MB moved


@pytest.mark.parametrize("ws,ows,c,nh,hidden", [(16, 24, 96, 6, 384), (7, 10, 200, 4, 384),
                                                (8, 12, 192, 3, 400), (6, 9, 96, 6, 384)])
def test_launch_plan_raises_outside_k8b(ws, ows, c, nh, hidden):
    from tpu_superresolution_torch.kernels.fused_ocab import ocab_bwd_plan

    with pytest.raises(ValueError):
        ocab_bwd_plan(ws, ows, c, nh, hidden, 8, 132)
