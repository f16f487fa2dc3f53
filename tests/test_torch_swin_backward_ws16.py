"""K5 at window 16 (the backward of the K7 route's block, upstream
HAT-SRx4's HAB): the port's plain block backward, what
``csrc/swin_block_bwd16.cu`` is held to on the card, against the JAX
package's ``fused_swin_block`` at ws 16 in interpret mode (its
custom_vjp backward is ``_mega_backward``, the Pallas K5), with and
without HAT's `extra`, shift 0 and 8, with stochastic-depth branch
scales; an attention backward over four 64-query tiles with D =
rowsum(dO * O) written out in plain ops against the whole-window
gradient; the CUDA kernels' schedule (``block_bwd16_emulated``: K5a's
three ws-16 modes, the attention kernels' query-row and key-row passes
from the stored row statistics, the per-CTA d(rpb) partials, K5b, the
fold) on ``pack_block_tiles``' stream against the plain version and the
JAX kernel; ``bwd16_plan`` and ``pack_block_tiles`` at ws 16; and the
route predicate ``k5w16_ok`` by shape.  fp32 on the CPU; bounds atol
2e-4 / rtol 1e-3 on gradients (the JAX package's own kernel-vs-vjp
bound) and 3e-5 on the forward."""

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
    """An attention backward over 64-query tiles, on [BW, nH, N, hd]
    fp32 tensors: per head, the query tiles in order, each with its exact
    softmax over all N keys, dV += A^T dO, dS = A (dO V^T - D) with D =
    rowsum(dO * O), dQ = dS K, dK += dS^T Q; the bias gradient summed
    over windows."""
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
    the flash row term D = rowsum(dO * O) (K5w16's), give the
    whole-window gradient of softmax(q k^T + rpb + mask) v."""
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
    from tpu_superresolution_torch.kernels.fused_block import check_tiled_bwd_args, k5w16_ok

    assert k5w16_ok(ws, c, nh, hidden, bias) is ok
    assert k5w16_ok(ws, c, nh, hidden, bias) is ok
    if ws == 16 and c <= 192 and not ok:
        rng = np.random.default_rng(0)
        p = _block_params(rng, c=c, nh=nh, hidden=hidden, ws=ws)
        w = _port_weights(p)
        if not bias:
            w = dataclasses.replace(w, bqkv=None)
        with pytest.raises(ValueError):
            check_tiled_bwd_args((1, 16, 16, c), w, 16, 0, "test")


# csrc/swin_block_bwd16.cu's schedule (K5w16 on the forward's weight
# stream): K5a's three token-local modes over the windows' 64-token
# tiles, the attention kernels over (window, head) units with a fixed head
# a CTA, K5b and K5c, the fold; written out in fp32 torch ops on
# ``pack_block_tiles(w, dtype=torch.float32)``.


def _bias16(table_h, crow, shifted):
    """The attention kernels' score term for one head: table[pos_q -
    pos_k + REL0] from the tokens' codes, + -100 where the shift regions
    differ (shifted windows only)."""
    rel0 = (WS - 1) * (2 * WS - 1) + WS - 1
    pos = crow & 0xFFFF
    bias = table_h[pos[:, None] - pos[None, :] + rel0]
    if shifted:
        bias = bias + torch.where((crow[:, None] >> 16) != (crow[None, :] >> 16), -100.0, 0.0)
    return bias


def block_bwd16_emulated(ct, x, p, shift, shifted, gelu_approx, scales=None, extra=None,
                         grid=2, splits=3, cph=1):
    """K5w16 in torch ops: the front (LN1, per head q, k, v into the
    window's [256, hdp] head tiles), the attention forward (each query
    tile's row max and sum online over four 64-key blocks, then P rounded
    once and O), the middle (O read back, proj, LN2, the MLP forward and
    back, LN2's backward, do into the head tiles with D = rowsum(do o)),
    the attention backward (the query rows' pass: P from the stored
    statistics, dS, dQ, d(rpb) into the CTA's partial; the key rows' pass:
    P^T, dS^T, dK, dV), the tail (dy, LN1's backward, dx): K5a's units on
    `grid` CTAs, two a pass, every product on the feeder's tiles in
    stream order; the attention's `cph` CTAs a head, each walking its
    windows in order; every buffer NaN until written.  Then K5b over
    `splits` splits of the units, the ordered sums and the fold.  Returns
    (dx, d extra, raw gradients, stream entries written)."""
    from tests.test_torch_swin_backward import _feeder_order, wgrad_emulated
    from tests.test_torch_block_wg import _unswizzle
    from tpu_superresolution_torch.kernels.fused_block import (
        BWD_OPERANDS,
        bwd_plan,
        fold_block_grads,
        gelu,
        gelu_grad,
    )
    from tpu_superresolution_torch.ops.window import window_token_codes

    b, h, w, c = x.shape
    nh, hidden, n = p.num_heads, p.hidden, WS * WS
    plan = bwd_plan(c, nh, hidden)
    cp, hdp, kc, halves, chunks = plan.cp, plan.hdp, plan.kc, plan.halves, plan.chunks
    k_cols, q3 = kc * 64, 3 * hdp
    codes = torch.from_numpy(window_token_codes(h, w, WS, shift if shifted else 0)).long()
    nww, per = w // WS, (h // WS) * (w // WS)
    windows = b * per
    units = 4 * windows
    pairs = units // 2
    tiles = p.tiles.float()
    order = _feeder_order(plan, nh)
    nq_tiles = nh * kc
    feeds = dict(front=order[:nq_tiles], mid=order[nq_tiles:-2 * nq_tiles],
                 tail=order[-nq_tiles:])
    nan = float("nan")
    ops = {nm: torch.full((units, 64, t * 64), nan) for nm, t in zip(BWD_OPERANDS, plan.op_tiles)}
    qkvh = torch.full((windows, nh, 3, n, hdp), nan)
    doh = torch.full((windows, nh, n, hdp), nan)
    drow = torch.full((windows, nh, n), nan)
    stat = torch.full((windows, nh, 2, n), nan)
    dx1s = torch.full((units, 64, k_cols), nan)
    pvec = torch.zeros(2, grid, 2, 4 * cp)  # the middle's and the tail's LN sums
    prpb = torch.full((cph, nh, n, n), nan)
    dx = torch.full_like(x, nan)
    dex = None if extra is None else torch.full_like(x, nan)

    def ln(v, g, bb):  # fast-variance LN over the first C columns, zero past them
        mu = v[:, :c].mean(-1, keepdim=True)
        var = ((v[:, :c] ** 2).mean(-1, keepdim=True) - mu * mu).clamp_min(0)
        r = torch.rsqrt(var + 1e-5)
        nn_, y = torch.zeros(64, k_cols), torch.zeros(64, k_cols)
        nn_[:, :c] = (v[:, :c] - mu) * r
        y[:, :c] = nn_[:, :c] * g + bb
        return y, nn_, r

    def ln_back(dy, nn_, r, g):
        dyg = dy[:, :c] * g
        return r * (dyg - dyg.mean(-1, keepdim=True)
                    - nn_[:, :c] * (dyg * nn_[:, :c]).mean(-1, keepdim=True))

    def unit_rows(u):  # unit u: window u // 4, its tile u % 4 -> (image, rows, cols)
        wn, sub = divmod(u, 4)
        bi, win = divmod(wn, per)
        wy, wx = divmod(win, nww)
        tt = 64 * sub + torch.arange(64)
        return wn, sub, bi, (wy * WS + tt // WS + shift) % h, (wx * WS + tt % WS + shift) % w

    def k5a(mode, body):  # K5a's walk: unit pairs over the grid, a consumer warpgroup each
        for cta in range(grid):
            for pr in range(cta, pairs, grid):
                for cw in range(2):
                    feed = iter(feeds[mode])

                    def tile():  # the next ring tile, unswizzled: [rows, 64]
                        off, rows = next(feed)
                        return _unswizzle(tiles[off:off + rows * 64].reshape(rows, 64))

                    body(2 * pr + cw, tile, pvec[:, cta, cw])
                    assert next(feed, None) is None  # the unit took its mode's whole stream

    def load(u, t):
        _, _, bi, rr, cc = unit_rows(u)
        out = torch.zeros(64, k_cols)
        out[:, :c] = t[bi, rr, cc]
        return out

    def front(u, tile, _):
        wn, sub, _, _, _ = unit_rows(u)
        yc, _, _ = ln(load(u, x), p.g1, p.b1)
        ops["yc"][u] = yc
        for hh in range(nh):
            acc = sum(yc[:, 64 * k:64 * k + 64] @ tile().T for k in range(kc))
            acc = acc + p.bqkv[hh * q3:(hh + 1) * q3]
            qkvh[wn, hh, :, 64 * sub:64 * sub + 64] = acc.reshape(64, 3, hdp).transpose(0, 1)
        ops["o"][u, :, nh * hdp:] = 0.0

    def mid(u, tile, pv):
        wn, sub, bi, rr, cc = unit_rows(u)
        xs, cts = load(u, x), load(u, ct)
        es = torch.zeros(64, k_cols) if extra is None else load(u, extra)
        m1, m2 = (1.0, 1.0) if scales is None else (scales[bi, 0], scales[bi, 1])
        o = ops["o"][u]
        proj = torch.cat([sum(o[:, 64 * k:64 * k + 64] @ tile().T for k in range(kc))
                          for _ in range(halves)], -1)
        x1 = torch.zeros(64, k_cols)
        x1[:, :cp] = xs[:, :cp] + m1 * (proj + p.bproj) + es[:, :cp]
        y2c, n2, r2 = ln(x1, p.g2, p.b2)
        dmlp = cts * m2
        dy2 = torch.zeros(64, k_cols)
        act, dh1 = torch.zeros(64, chunks * 64), torch.zeros(64, chunks * 64)
        for j in range(chunks):
            h1 = sum(y2c[:, 64 * k:64 * k + 64] @ tile().T for k in range(kc))
            h1 = h1 + p.bfc1[64 * j:64 * j + 64]
            act[:, 64 * j:64 * j + 64] = gelu(h1, gelu_approx)
            dacc = sum(dmlp[:, 96 * hf:96 * hf + 96] @ tile() for hf in range(halves))
            dh = dacc * gelu_grad(h1, gelu_approx)
            dh1[:, 64 * j:64 * j + 64] = dh
            for k in range(kc):
                dy2[:, 64 * k:64 * k + 64] += dh @ tile()
        dx1 = torch.zeros(64, k_cols)
        dx1[:, :c] = cts[:, :c] + ln_back(dy2, n2, r2, p.g2)
        dx1s[u] = dx1
        if dex is not None:
            dex[bi, rr, cc] = dx1[:, :c]
        dattn = dx1 * m1
        do = torch.zeros(64, k_cols)
        for k in range(kc):
            for hf in range(halves):
                do[:, 64 * k:64 * k + 64] += dattn[:, 96 * hf:96 * hf + 96] @ tile()
        rows = slice(64 * sub, 64 * sub + 64)
        for hh in range(nh):
            cols = slice(hh * hdp, (hh + 1) * hdp)
            doh[wn, hh, rows] = do[:, cols]
            drow[wn, hh, rows] = (do[:, cols] * o[:, cols]).sum(-1)
        for nm, val in (("y2c", y2c), ("act", act), ("dh1", dh1), ("dattn", dattn),
                        ("dmlp", dmlp)):
            ops[nm][u] = val[:, :ops[nm].shape[2]]
        pv[0] += torch.cat([torch.zeros(2 * cp), (dy2 * n2)[:, :cp].sum(0), dy2[:, :cp].sum(0)])

    def tail(u, tile, pv):
        wn, sub, bi, rr, cc = unit_rows(u)
        _, n1, r1 = ln(load(u, x), p.g1, p.b1)
        dqkv = ops["dqkv"][u]
        dy = torch.zeros(64, k_cols)
        for hh in range(nh):
            for k in range(kc):
                dy[:, 64 * k:64 * k + 64] += dqkv[:, hh * q3:(hh + 1) * q3] @ tile()
        dx[bi, rr, cc] = dx1s[u][:, :c] + ln_back(dy, n1, r1, p.g1)
        pv[1] += torch.cat([(dy * n1)[:, :cp].sum(0), dy[:, :cp].sum(0), torch.zeros(2 * cp)])

    def attention(backward):  # cph CTAs a head, each walking its windows in order
        for cta in range(nh * cph):
            hh, first = divmod(cta, cph)
            for i, wv in enumerate(range(first, windows, cph)):
                q, k, v = qkvh[wv, hh]
                bias = _bias16(p.table[hh], codes[wv % per if shifted else 0], shifted)
                blk = [slice(64 * t, 64 * t + 64) for t in range(4)]
                if not backward:
                    for qt, rows in enumerate(blk):
                        mx, l = torch.full((64,), float("-inf")), torch.zeros(64)
                        for keys in blk:  # the row max and sum, online
                            s = q[rows] @ k[keys].T + bias[rows, keys]
                            mn = torch.maximum(mx, s.max(-1).values)
                            l = l * torch.exp(mx - mn) + torch.exp(s - mn[:, None]).sum(-1)
                            mx = mn
                        inv = 1.0 / l
                        o = sum(torch.exp(q[rows] @ k[keys].T + bias[rows, keys] - mx[:, None])
                                * inv[:, None] @ v[keys] for keys in blk)
                        ops["o"][4 * wv + qt, :, hh * hdp:(hh + 1) * hdp] = o
                        stat[wv, hh, 0, rows], stat[wv, hh, 1, rows] = mx, inv
                    continue
                do, (m, inv), d = doh[wv, hh], stat[wv, hh], drow[wv, hh]
                prob = lambda rows, keys: torch.exp(
                    q[rows] @ k[keys].T + bias[rows, keys] - m[rows, None]) * inv[rows, None]
                for qt, rows in enumerate(blk):  # the query rows
                    dq = torch.zeros(64, hdp)
                    for keys in blk:
                        ds = prob(rows, keys) * (do[rows] @ v[keys].T - d[rows, None])
                        prpb[first, hh, rows, keys] = ds if i == 0 else prpb[first, hh, rows, keys] + ds
                        dq = dq + ds @ k[keys]
                    ops["dqkv"][4 * wv + qt, :, hh * q3:hh * q3 + hdp] = dq
                for kt, keys in enumerate(blk):  # the key rows
                    dk, dv = torch.zeros(64, hdp), torch.zeros(64, hdp)
                    for rows in blk:
                        pt = prob(rows, keys).T
                        dst = pt * (v[keys] @ do[rows].T - d[None, rows])
                        dk, dv = dk + dst @ q[rows], dv + pt @ do[rows]
                    ops["dqkv"][4 * wv + kt, :, hh * q3 + hdp:(hh + 1) * q3] = torch.cat([dk, dv], -1)

    k5a("front", front)
    attention(backward=False)
    k5a("mid", mid)
    attention(backward=True)
    k5a("tail", tail)
    gv, written = wgrad_emulated(ops, plan, nh, splits)
    gv = torch.cat([gv, pvec.reshape(-1, 4 * cp).sum(0)])
    grads = fold_block_grads(gv, prpb.sum(0).reshape(-1), c, nh, hidden, WS)
    return dx, dex, grads, written


_BWD16_SCHEDULES = [
    # (b, h, w, c, heads, hidden, shift, extra, grid, splits, cph)
    ((2, 32, 16, 48, 3, 96, 8, True, 3, 3, 1), "hd16-cp96-shift8-extra"),
    ((1, 32, 32, 60, 2, 120, 0, False, 2, 2, 2), "hd30-cp96-shift0"),
    ((1, 32, 16, 180, 6, 360, 8, False, 2, 3, 1), "hat-srx4-widths-shift8"),
    ((2, 16, 32, 64, 2, 128, 0, True, 4, 5, 2), "hd32-cp96-shift0-extra"),
]


@pytest.mark.parametrize("shape", [s for s, _ in _BWD16_SCHEDULES],
                         ids=[i for _, i in _BWD16_SCHEDULES])
def test_k5w16_schedule_emulated_matches_plain(shape):
    """K5w16's schedule in torch (K5a's three modes over 64-token units,
    the attention's fixed-head CTAs and two passes from the stored row
    statistics, the per-CTA d(rpb) partials and their sum, K5b's splits,
    the fold) on the forward's packed operands reproduces
    swin_block_bwd_plain at fp32 (atol 2e-4 / rtol 1e-3), branch scales
    on; K5b writes every stream and bias entry once; nothing NaN leaks
    from unwritten entries."""
    from tests.test_torch_hat_block import _block_weights
    from tpu_superresolution_torch.kernels.fused_block import (
        GRAD_FIELDS,
        pack_block_tiles,
        swin_block_bwd_plain,
    )
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    b, h, wd, c, nh, hidden, shift, with_extra, grid, splits, cph = shape
    rng = np.random.default_rng(c + shift + 16)
    w, _, _ = _block_weights(rng, c=c, nh=nh, hidden=hidden, ws=WS)
    x = torch.from_numpy(rng.standard_normal((b, h, wd, c)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((b, h, wd, c)).astype(np.float32))
    extra = (torch.from_numpy((0.5 * rng.standard_normal((b, h, wd, c))).astype(np.float32))
             if with_extra else None)
    scales = torch.from_numpy(SCALES)[:b]
    mask = shift_mask_tensor(h, wd, WS, shift, torch.device("cpu")) if shift else None
    p = pack_block_tiles(w, dtype=torch.float32)
    dx, dex, got, written = block_bwd16_emulated(ct, x, p, shift, mask is not None, True, scales,
                                                 extra, grid=grid, splits=splits, cph=cph)
    want = swin_block_bwd_plain(ct, x, w, WS, shift, mask, True, scales, extra)
    assert torch.equal(written, torch.ones_like(written))
    _assert_close(dx.numpy(), want.dx.numpy(), "dx")
    if with_extra:
        _assert_close(dex.numpy(), want.extra.numpy(), "dextra")
    for k in GRAD_FIELDS:
        _assert_close(got[k].numpy(), getattr(want, k).numpy(), k)


@pytest.mark.parametrize("shift,with_extra", [(0, False), (8, True)],
                         ids=["shift0", "shift8-extra"])
def test_k5w16_schedule_emulated_matches_jax_mega_backward(shift, with_extra):
    """K5w16's schedule (ws 16, C 32 in 2 heads, branch scales) against
    jax.vjp of the JAX package's ``fused_swin_block`` at ws 16 in
    interpret mode (its backward is ``_mega_backward``, the Pallas K5):
    dx, d extra, every weight and bias gradient and the gathered bias's
    (atol 2e-4 / rtol 1e-3)."""
    from tpu_superresolution_torch.kernels.fused_block import pack_block_tiles

    rng = np.random.default_rng(260 + shift)
    p = _block_params(rng, ws=WS)
    c = p["wqkv"].shape[0]
    x = rng.standard_normal((B, H, W, c)).astype(np.float32)
    ct = rng.standard_normal((B, H, W, c)).astype(np.float32)
    extra = (0.3 * rng.standard_normal((B, H, W, c))).astype(np.float32) if with_extra else None
    leaves = ([jnp.asarray(x)] + [jnp.asarray(p[k]) for k in _JAX_ORDER]
              + [jnp.asarray(_gathered_bias(p))])
    f = _jax_block(p, shift)
    if with_extra:
        _, vjp = jax.vjp(f, *leaves, jnp.asarray(extra))
    else:
        _, vjp = jax.vjp(lambda *a: f(*a, None), *leaves)
    jgrads = vjp(jnp.asarray(ct))
    pk = pack_block_tiles(_port_weights(p), dtype=torch.float32)
    dx, dex, got, _ = block_bwd16_emulated(_t(ct), _t(x), pk, shift, shift > 0, True,
                                           _t(SCALES), None if extra is None else _t(extra),
                                           grid=3, splits=2, cph=3)
    _assert_close(dx.numpy(), np.asarray(jgrads[0]), "dx")
    for name, g in zip(_JAX_ORDER, jgrads[1:13]):
        _assert_close(got[name].numpy(), _as_port(name, g), name)
    _assert_close(got["rpb"].numpy(), np.asarray(jgrads[13]), "rpb")
    if with_extra:
        _assert_close(dex.numpy(), np.asarray(jgrads[14]), "dextra")


_BWD16_PLANS = [
    # (C, heads, hidden, windows, SMs) -> (cp, hdp, grid, splits, cph, rounds, tail CTAs)
    ((180, 6, 360, 128, 132), (192, 32, 132, 11, 22, 6, 108)),   # HAT-SRx4's train step
    ((32, 2, 64, 8, 132), (96, 16, 16, 32, 8, 1, 16)),
    ((96, 6, 384, 200, 132), (96, 16, 132, 16, 22, 10, 12)),
]


@pytest.mark.parametrize("shape,want", _BWD16_PLANS,
                         ids=["-".join(map(str, s)) for s, _ in _BWD16_PLANS])
def test_bwd16_plan_from_static_shapes(shape, want):
    """bwd16_plan: K5a's plan at the forward's widths over four 64-token
    units a window, K5b's splits, the attention's CTAs a head (a fixed
    head a CTA), its (window, head) units, rounds and the last round's
    CTAs; every launch within 227 KB of shared memory (the attention's
    two stages of [256, hdp] head tiles: 3 of them forward, 4 and the row
    statistics backward)."""
    from tpu_superresolution_torch.kernels import fused_block as fb

    c, heads, hidden, windows, sms = shape
    p = fb.bwd16_plan(c, heads, hidden, windows, sms)
    assert (p.block.cp, p.block.hdp, p.grid, p.splits, p.cph, p.rounds, p.tail_ctas) == want
    assert p.block == fb.bwd_plan(c, heads, hidden) and p.units == 4 * windows
    assert p.att_units == windows * heads and p.cph * heads <= sms
    for smem in (p.block.smem, p.att_fwd_smem, p.att_bwd_smem):
        assert smem <= 232448
    tile = 256 * 2 * p.block.hdp
    assert p.att_fwd_smem == 1024 + 2 * 3 * tile + 4096 + 32
    assert p.att_bwd_smem == 1024 + 2 * (4 * tile + 3 * 256 * 4) + 4096 + 32
    sizes = fb.tiled_bwd_bytes(p, heads)
    assert sizes["rpb partials"] == p.cph * heads * 256 * 256 * 4
    assert sizes["workspace"] == p.units * p.block.window_bytes


@pytest.mark.parametrize("shape", [(180, 6, 720), (240, 8, 480), (200, 4, 360)],
                         ids=["hidden720", "C240", "hd50"])
def test_bwd16_plan_raises_outside_k5w16(shape):
    from tpu_superresolution_torch.kernels.fused_block import bwd16_plan

    with pytest.raises(ValueError, match="K5w16 takes"):
        bwd16_plan(*shape, 128, 132)


@pytest.mark.parametrize("c,nh,hidden,shift", [(32, 2, 64, 0), (32, 2, 64, 8), (180, 6, 360, 8)])
def test_pack_block_tiles_at_ws16(c, nh, hidden, shift):
    """The stream K5w16 reads (``pack_block_tiles`` at ws 16): the table
    [nh, 961] (the [(2ws-1)^2, nh] parameter transposed), the weight
    stream as long as ``bwd_plan`` reckons, and the attention kernels'
    score term from the table and the tokens' codes ([1, 256] unshifted,
    [nW, 256] shifted) equal to the gathered bias plus the shift mask,
    bit for bit."""
    from tests.test_torch_hat_block import _block_weights
    from tpu_superresolution_torch.kernels.fused_block import bwd_plan, pack_block_tiles
    from tpu_superresolution_torch.ops.window import (
        relative_position_bias,
        shift_mask_tensor,
        window_token_codes,
    )

    w, _, _ = _block_weights(np.random.default_rng(c + shift), c=c, nh=nh, hidden=hidden, ws=WS)
    p = pack_block_tiles(w, dtype=torch.float32)
    assert p.window_size == WS and tuple(p.table.shape) == (nh, 31 * 31)
    assert torch.equal(p.table, w.table.t())
    assert p.tiles.numel() == bwd_plan(c, nh, hidden).stream_len
    h, wd = 32, 48
    codes = torch.from_numpy(window_token_codes(h, wd, WS, shift)).long()
    n_win = (h // WS) * (wd // WS)
    assert tuple(codes.shape) == ((n_win if shift else 1), WS * WS)
    rpb = relative_position_bias(w.table, WS)
    mask = shift_mask_tensor(h, wd, WS, shift, torch.device("cpu")) if shift else None
    for win in range(n_win):
        for hh in range(nh):
            got = _bias16(p.table[hh], codes[win if shift else 0], shift > 0)
            want = rpb[hh] + (mask[win] if shift else 0.0)
            assert torch.equal(got, want)
