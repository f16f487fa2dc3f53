"""K5r: the block backward of the K7 route's ws-8 blocks past the block
kernel's widths (SwinIR-L: C 240, 8 heads of 30, MLP hidden 480), what
``csrc/swin_block_bwd16.cu`` runs at ws 8 on the card:

- the port's plain block backward at SwinIR-L's widths against the JAX
  package's ``fused_swin_block`` in interpret mode (its custom_vjp
  backward is ``_mega_backward``, the Pallas K5), shift 0 and 4, with
  stochastic-depth branch scales;
- the CUDA kernels' schedule written out in torch ops on
  ``pack_block_tiles``' stream (``block_bwd_k5r_emulated``: K5a's three
  ws-8 modes at padded width 256 with dy2 and dy in two 128-column
  halves, the attention kernels over stages of four windows with each
  consumer warpgroup's d(rpb) partial, K5b, K5c, the fold) against the
  plain version and the JAX kernel;
- ``k5r_plan`` and ``pack_block_tiles`` at CP 256, 8 heads, hidden 480;
- the route predicate ``k5r_ok`` by shape;
- a SwinIR-L-width model (depths (2, 2)) against ``jax.value_and_grad``
  of the JAX model, and the ``finetune`` CLI on a reduced-depth SwinIR-L
  checkpoint.

fp32 on the CPU; bounds atol 2e-4 / rtol 1e-3 on gradients (the JAX
package's own kernel-vs-vjp bound), 3e-5 on the forward, and the model
gradients max |diff| <= 1e-3 max |grad| + 1e-7 (test_torch_train's)."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels_plain import _block_params, _port_weights, _t
from tests.test_torch_swin_backward import _JAX_ORDER, _as_port, _stream_tiles
from tests.util_torchport import TOL

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
SCALES = np.array([[1.25, 0.0], [1.0, 1.25]], np.float32)
WS = 8
C, NH, HIDDEN = 240, 8, 480  # SwinIR-L


def _assert_close(got, want, what):
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=what)


def _gathered_bias(p):
    from tpu_superresolution_tpu.ops.window import relative_position_index

    n = WS * WS
    bias = p["table"][relative_position_index(WS).reshape(-1)].reshape(n, n, -1)
    return np.ascontiguousarray(bias.transpose(2, 0, 1))


def _jax_grads(p, x, ct, shift, extra=None):
    """(forward, vjp cotangents) of the JAX fused block at ws 8 in
    interpret mode, the shift around it, branch scales on: gradients of
    x, the 12 weights (JAX layout), the gathered bias and extra."""
    from tpu_superresolution_tpu.ops.pallas.fused_block import fused_swin_block
    from tpu_superresolution_tpu.ops.window import cyclic_shift, cyclic_unshift, shift_attn_mask

    _, h, w, c = x.shape
    mask = shift_attn_mask(h, w, WS, shift) if shift else None
    scale = (c // p["nh"]) ** -0.5

    def f(x, *args):
        *weights, bias, ex = args
        out = fused_swin_block(cyclic_shift(x, shift), *weights, bias, WS, mask, scale, True,
                               interpret=True,
                               extra=None if ex is None else cyclic_shift(ex, shift),
                               branch_scales=jnp.asarray(SCALES))
        return cyclic_unshift(out, shift)

    leaves = ([jnp.asarray(x)] + [jnp.asarray(p[k]) for k in _JAX_ORDER]
              + [jnp.asarray(_gathered_bias(p))])
    if extra is None:
        out, vjp = jax.vjp(lambda *a: f(*a, None), *leaves)
    else:
        out, vjp = jax.vjp(f, *leaves, jnp.asarray(extra))
    return np.asarray(out), vjp(jnp.asarray(ct))


@pytest.mark.parametrize("shift", [0, 4])
def test_k5r_plain_matches_jax_mega_backward(shift):
    """The port's plain block backward (what K5r is held to on the card)
    at SwinIR-L's widths, [2, 16, 16, 240] in 8 windows, against jax.vjp
    of the JAX fused block in interpret mode: dx, every weight and bias
    gradient, the gathered bias's; the forward within 3e-5."""
    from tpu_superresolution_torch.kernels import fused_block, read_counters, reset_counters
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    rng = np.random.default_rng(190 + shift)
    p = _block_params(rng, c=C, nh=NH, hidden=HIDDEN, ws=WS)
    x = rng.standard_normal((2, 16, 16, C)).astype(np.float32)
    ct = rng.standard_normal((2, 16, 16, C)).astype(np.float32)
    out, jgrads = _jax_grads(p, x, ct, shift)

    reset_counters()
    w = _port_weights(p)
    tmask = shift_mask_tensor(16, 16, WS, shift, torch.device("cpu")) if shift else None
    fwd = fused_block.swin_block_plain(_t(x), w, WS, shift, tmask, True, _t(SCALES))
    assert np.abs(fwd.numpy() - out).max() <= TOL
    got = fused_block.fused_swin_block_backward(_t(ct), _t(x), w, WS, shift, tmask, True,
                                                branch_scales=_t(SCALES))
    assert not any(read_counters().values())  # CPU tensors: the plain version ran
    _assert_close(got.dx.numpy(), np.asarray(jgrads[0]), "dx")
    for name, g in zip(_JAX_ORDER, jgrads[1:13]):
        _assert_close(getattr(got, name).numpy(), _as_port(name, g), name)
    _assert_close(got.rpb.numpy(), np.asarray(jgrads[13]), "rpb")


# csrc/swin_block_bwd16.cu at ws 8 (K5r) on the forward's weight stream,
# written out in fp32 torch ops on ``pack_block_tiles(w, dtype=float32)``.


def _bias8(table_h, crow, shifted):
    """The attention kernels' score term for one head at ws 8."""
    rel0 = (WS - 1) * (2 * WS - 1) + WS - 1
    pos = crow & 0xFFFF
    bias = table_h[pos[:, None] - pos[None, :] + rel0]
    if shifted:
        bias = bias + torch.where((crow[:, None] >> 16) != (crow[None, :] >> 16), -100.0, 0.0)
    return bias


def _k5r_feeds(plan, heads):
    """The tiles K5a's feeder streams for a unit pair in each of K5r's
    modes: the front qkv; the middle the proj (N part, K chunk), per
    hidden chunk fc1, fc2 and fc1's first half of K chunks, then per
    hidden chunk fc1's second half, then the proj by K chunk; the tail
    qkv, each half of K chunks over every head."""
    t = _stream_tiles(plan, heads)
    kc, halves, kh = plan.kc, plan.halves, plan.kc // 2
    qkv = [t["qkv"](h, k) for h in range(heads) for k in range(kc)]
    mid = [t["proj"](hf, k) for hf in range(halves) for k in range(kc)]
    for j in range(plan.chunks):
        mid += ([t["fc1"](j, k) for k in range(kc)] + [t["fc2"](j, hf) for hf in range(halves)]
                + [t["fc1"](j, k) for k in range(kh)])
    mid += [t["fc1"](j, k) for j in range(plan.chunks) for k in range(kh, kc)]
    mid += [t["proj"](hf, k) for k in range(kc) for hf in range(halves)]
    tail = [t["qkv"](h, k) for k0 in (0, kh) for h in range(heads) for k in range(k0, k0 + kh)]
    return dict(front=qkv, mid=mid, tail=tail)


def block_bwd_k5r_emulated(ct, x, p, shift, shifted, gelu_approx, scales=None, extra=None,
                           grid=2, splits=3, cph=1):
    """K5r in torch ops: the front (LN1, per head q, k, v into the
    window's [64, hdp] head tiles), the attention forward over stages of
    four windows of a head (row max and sum, then P and O), the middle (O
    read back, the proj in 128-row N parts, LN2, the MLP forward and back
    with dy2's first half of K chunks on the forward pass and its second
    against dh1 read back, LN2's backward, do into the head tiles with D =
    rowsum(do o)), the attention backward (query rows: P from the stored
    statistics, dS, dQ, d(rpb) into the consumer warpgroup's partial; key
    rows: P^T, dS^T, dK, dV), the tail (dy in two halves of K chunks,
    each over every head, LN1's backward, dx): K5a's units (a window
    each) on `grid` CTAs, two a pass in step (an odd last unit's twin
    recomputes it, storing the same bits to the workspace and head tiles,
    its x1 / dx1 to a scratch slice of its own, no sums and no dx), every
    product on the feeder's tiles in stream order; the
    attention's `cph` CTAs a head, each consumer warpgroup taking stage
    windows cw and cw + 2; every buffer NaN until written.  Then K5b over
    `splits` splits of the units, the ordered sums and the fold.  Returns
    (dx, d extra, raw gradients, stream entries written)."""
    from tests.test_torch_block_wg import _unswizzle
    from tests.test_torch_swin_backward import wgrad_emulated
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
    plan = bwd_plan(c, nh, hidden, k5r=True)
    cp, hdp, kc, halves, chunks, pw = (plan.cp, plan.hdp, plan.kc, plan.halves, plan.chunks,
                                       plan.pw)
    assert (cp, pw) == (256, 128)
    kh, k_cols, q3 = kc // 2, kc * 64, 3 * hdp
    codes = torch.from_numpy(window_token_codes(h, w, WS, shift if shifted else 0)).long()
    nww, per = w // WS, (h // WS) * (w // WS)
    units = windows = b * per
    pairs = -(-units // 2)
    groups = -(-windows // 4)
    tiles = p.tiles.float()
    feeds = _k5r_feeds(plan, nh)
    nan = float("nan")
    ops = {nm: torch.full((units, 64, t * 64), nan) for nm, t in zip(BWD_OPERANDS, plan.op_tiles)}
    qkvh = torch.full((windows, nh, 3, n, hdp), nan)
    doh = torch.full((windows, nh, n, hdp), nan)
    drow = torch.full((windows, nh, n), nan)
    stat = torch.full((windows, nh, 2, n), nan)
    x1s = torch.full((units + units % 2, 64, k_cols), nan)  # x1, then dx1 in place
    pvec = torch.zeros(2, grid, 2, 4 * cp)  # the middle's and the tail's LN sums
    prpb = torch.full((cph, 2, nh, n, n), nan)
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

    def unit_rows(u):  # unit u = window u -> (image, rows, cols)
        bi, win = divmod(u, per)
        wy, wx = divmod(win, nww)
        tt = torch.arange(64)
        return bi, (wy * WS + tt // WS + shift) % h, (wx * WS + tt % WS + shift) % w

    def k5a(mode, body):  # K5a's walk: unit pairs over the grid, a consumer warpgroup each
        for cta in range(grid):
            for pr in range(cta, pairs, grid):
                runs = []
                for cw in range(2):
                    u = 2 * pr + cw
                    active = u < units  # else the twin of an odd last unit
                    wv = u if active else units - 1
                    slot = wv if active else units  # its x1 / dx1 scratch slice
                    feed = iter(feeds[mode])

                    def tile(feed=feed):  # the next ring tile, unswizzled: [rows, 64]
                        off, rows = next(feed)
                        return _unswizzle(tiles[off:off + rows * 64].reshape(rows, 64))

                    pv = pvec[:, cta, cw] if active else torch.zeros_like(pvec[:, cta, cw])
                    runs.append((body(wv, slot, tile, pv, active), feed))
                # the pair phase by phase, each warpgroup through a phase
                # before the other's next (the ring lets either run ahead)
                for _ in itertools.zip_longest(*(run for run, _ in runs)):
                    pass
                for _, feed in runs:
                    assert next(feed, None) is None  # the unit took its mode's whole stream

    def load(u, t):
        bi, rr, cc = unit_rows(u)
        out = torch.zeros(64, k_cols)
        out[:, :c] = t[bi, rr, cc]
        return out

    def front(u, slot, tile, pv, active):
        yc, _, _ = ln(load(u, x), p.g1, p.b1)
        ops["yc"][u] = yc
        for hh in range(nh):
            acc = sum(yc[:, 64 * k:64 * k + 64] @ tile().T for k in range(kc))
            acc = acc + p.bqkv[hh * q3:(hh + 1) * q3]
            qkvh[u, hh] = acc.reshape(64, 3, hdp).transpose(0, 1)
        ops["o"][u, :, nh * hdp:] = 0.0
        yield

    def mid(u, slot, tile, pv, active):
        bi, rr, cc = unit_rows(u)
        xs, cts = load(u, x), load(u, ct)
        es = torch.zeros(64, k_cols) if extra is None else load(u, extra)
        m1, m2 = (1.0, 1.0) if scales is None else (scales[bi, 0], scales[bi, 1])
        o = ops["o"][u]
        proj = torch.cat([sum(o[:, 64 * k:64 * k + 64] @ tile().T for k in range(kc))
                          for _ in range(halves)], -1)
        x1s[slot] = xs + m1 * (proj + p.bproj) + es  # the proj's x1 into the scratch
        yield
        x1 = x1s[slot].clone()
        y2c, n2, r2 = ln(x1, p.g2, p.b2)
        dmlp = cts * m2
        dy2 = torch.zeros(64, k_cols)
        act, dh1 = torch.zeros(64, chunks * 64), torch.zeros(64, chunks * 64)
        for j in range(chunks):  # the chunks' pass: dy2's first half of K chunks
            h1 = sum(y2c[:, 64 * k:64 * k + 64] @ tile().T for k in range(kc))
            h1 = h1 + p.bfc1[64 * j:64 * j + 64]
            act[:, 64 * j:64 * j + 64] = gelu(h1, gelu_approx)
            dacc = sum(dmlp[:, pw * hf:pw * hf + pw] @ tile() for hf in range(halves))
            dh = dacc * gelu_grad(h1, gelu_approx)
            dh1[:, 64 * j:64 * j + 64] = dh
            for k in range(kh):
                dy2[:, 64 * k:64 * k + 64] += dh @ tile()
        ops["dh1"][u] = dh1
        for j in range(chunks):  # the second half, against dh1 read back
            for k in range(kh, kc):
                dy2[:, 64 * k:64 * k + 64] += ops["dh1"][u][:, 64 * j:64 * j + 64] @ tile()
        x1s[slot] = 0.0
        x1s[slot, :, :c] = cts[:, :c] + ln_back(dy2, n2, r2, p.g2)  # dx1 over x1
        yield
        dx1 = x1s[slot].clone()
        if dex is not None and active:
            dex[bi, rr, cc] = dx1[:, :c]
        dattn = dx1 * m1
        do = torch.zeros(64, k_cols)
        for k in range(kc):
            for hf in range(halves):
                do[:, 64 * k:64 * k + 64] += dattn[:, pw * hf:pw * hf + pw] @ tile()
        for hh in range(nh):
            cols = slice(hh * hdp, (hh + 1) * hdp)
            doh[u, hh] = do[:, cols]
            drow[u, hh] = (do[:, cols] * o[:, cols]).sum(-1)
        for nm, val in (("y2c", y2c), ("act", act), ("dattn", dattn), ("dmlp", dmlp)):
            ops[nm][u] = val[:, :ops[nm].shape[2]]
        pv[0] += torch.cat([torch.zeros(2 * cp), (dy2 * n2)[:, :cp].sum(0), dy2[:, :cp].sum(0)])

    def tail(u, slot, tile, pv, active):
        bi, rr, cc = unit_rows(u)
        _, n1, r1 = ln(load(u, x), p.g1, p.b1)
        dqkv = ops["dqkv"][u]
        dy = torch.zeros(64, k_cols)
        for k0 in (0, kh):
            for hh in range(nh):
                for k in range(k0, k0 + kh):
                    dy[:, 64 * k:64 * k + 64] += dqkv[:, hh * q3:(hh + 1) * q3] @ tile()
        if active:
            dx[bi, rr, cc] = x1s[slot][:, :c] + ln_back(dy, n1, r1, p.g1)
        pv[1] += torch.cat([(dy * n1)[:, :cp].sum(0), dy[:, :cp].sum(0), torch.zeros(2 * cp)])
        yield

    def attention(backward):  # cph CTAs a head, each walking stages of four windows in order
        for cta in range(nh * cph):
            hh, first = divmod(cta, cph)
            rp = torch.zeros(2, n, n)  # each consumer warpgroup's d(rpb), in registers
            for g in range(first, groups, cph):
                for t2 in range(2):
                    for cw in range(2):
                        wv = 4 * g + cw + 2 * t2
                        if wv >= windows:  # a ragged last stage
                            continue
                        q, k, v = qkvh[wv, hh]
                        bias = _bias8(p.table[hh], codes[wv % per if shifted else 0], shifted)
                        s = q @ k.T + bias
                        if not backward:
                            mx = s.max(-1).values
                            inv = 1.0 / torch.exp(s - mx[:, None]).sum(-1)
                            o = torch.exp(s - mx[:, None]) * inv[:, None] @ v
                            ops["o"][wv, :, hh * hdp:(hh + 1) * hdp] = o
                            stat[wv, hh, 0], stat[wv, hh, 1] = mx, inv
                            continue
                        do, (m, inv), d = doh[wv, hh], stat[wv, hh], drow[wv, hh]
                        prob = torch.exp(s - m[:, None]) * inv[:, None]
                        ds = prob * (do @ v.T - d[:, None])  # the query rows
                        rp[cw] += ds
                        dst = prob.T * (v @ do.T - d[None, :])  # the key rows
                        ops["dqkv"][wv, :, hh * q3:(hh + 1) * q3] = torch.cat(
                            [ds @ k, dst @ q, prob.T @ do], -1)
            if backward:
                prpb[first, :, hh] = rp

    k5a("front", front)
    attention(backward=False)
    k5a("mid", mid)
    attention(backward=True)
    k5a("tail", tail)
    gv, written = wgrad_emulated(ops, plan, nh, splits)
    gv = torch.cat([gv, pvec.reshape(-1, 4 * cp).sum(0)])
    grads = fold_block_grads(gv, prpb.sum((0, 1)).reshape(-1), c, nh, hidden, WS)
    return dx, dex, grads, written


_K5R_SCHEDULES = [
    # (b, h, w, c, heads, hidden, shift, extra, grid, splits, cph)
    ((1, 16, 24, 240, 8, 480, 4, True, 2, 2, 1), "swinir-l-shift4-extra-ragged-stage"),
    ((2, 16, 16, 240, 8, 480, 0, False, 3, 3, 2), "swinir-l-shift0"),
    ((1, 8, 24, 192, 8, 384, 4, False, 1, 2, 1), "c192-8heads-odd-units"),
    ((2, 16, 8, 48, 8, 100, 0, True, 2, 1, 1), "hd6-hidden100-extra"),
]


@pytest.mark.parametrize("shape", [s for s, _ in _K5R_SCHEDULES],
                         ids=[i for _, i in _K5R_SCHEDULES])
def test_k5r_schedule_emulated_matches_plain(shape):
    """K5r's schedule in torch (K5a's three ws-8 modes at CP 256 with
    dy2 and dy in halves of K chunks, the attention over stages of four
    windows with each consumer warpgroup's d(rpb) partial and their sum,
    K5b's splits, the fold) on the forward's packed operands reproduces
    swin_block_bwd_plain at fp32 (atol 2e-4 / rtol 1e-3), branch scales
    on; K5b writes every stream and bias entry once; nothing NaN leaks
    from unwritten entries."""
    from tests.test_torch_hat_block import _block_weights
    from tpu_superresolution_torch.kernels.fused_block import (
        GRAD_FIELDS,
        k5r_ok,
        pack_block_tiles,
        swin_block_bwd_plain,
    )
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    b, h, wd, c, nh, hidden, shift, with_extra, grid, splits, cph = shape
    assert k5r_ok(WS, c, nh, hidden)
    rng = np.random.default_rng(c + shift + 8)
    w, _, _ = _block_weights(rng, c=c, nh=nh, hidden=hidden, ws=WS)
    x = torch.from_numpy(rng.standard_normal((b, h, wd, c)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((b, h, wd, c)).astype(np.float32))
    extra = (torch.from_numpy((0.5 * rng.standard_normal((b, h, wd, c))).astype(np.float32))
             if with_extra else None)
    scales = torch.from_numpy(SCALES)[-b:]  # at b 1 both branches on: dx1 reads x1 back
    mask = shift_mask_tensor(h, wd, WS, shift, torch.device("cpu")) if shift else None
    p = pack_block_tiles(w, dtype=torch.float32)
    dx, dex, got, written = block_bwd_k5r_emulated(ct, x, p, shift, mask is not None, True, scales,
                                                   extra, grid=grid, splits=splits, cph=cph)
    want = swin_block_bwd_plain(ct, x, w, WS, shift, mask, True, scales, extra)
    assert torch.equal(written, torch.ones_like(written))
    _assert_close(dx.numpy(), want.dx.numpy(), "dx")
    if with_extra:
        _assert_close(dex.numpy(), want.extra.numpy(), "dextra")
    for k in GRAD_FIELDS:
        _assert_close(got[k].numpy(), getattr(want, k).numpy(), k)


@pytest.mark.parametrize("shift", [0, 4])
def test_k5r_schedule_emulated_matches_jax_mega_backward(shift):
    """K5r's schedule at SwinIR-L's widths, [2, 16, 16, 240], branch
    scales, against jax.vjp of the JAX package's ``fused_swin_block`` in
    interpret mode (its backward is ``_mega_backward``): dx, every weight
    and bias gradient and the gathered bias's (atol 2e-4 / rtol 1e-3)."""
    from tpu_superresolution_torch.kernels.fused_block import pack_block_tiles

    rng = np.random.default_rng(290 + shift)
    p = _block_params(rng, c=C, nh=NH, hidden=HIDDEN, ws=WS)
    x = rng.standard_normal((2, 16, 16, C)).astype(np.float32)
    ct = rng.standard_normal((2, 16, 16, C)).astype(np.float32)
    _, jgrads = _jax_grads(p, x, ct, shift)
    pk = pack_block_tiles(_port_weights(p), dtype=torch.float32)
    dx, _, got, _ = block_bwd_k5r_emulated(_t(ct), _t(x), pk, shift, shift > 0, True, _t(SCALES),
                                           grid=3, splits=2, cph=2)
    _assert_close(dx.numpy(), np.asarray(jgrads[0]), "dx")
    for name, g in zip(_JAX_ORDER, jgrads[1:13]):
        _assert_close(got[name].numpy(), _as_port(name, g), name)
    _assert_close(got["rpb"].numpy(), np.asarray(jgrads[13]), "rpb")


_K5R_PLANS = [
    # (C, heads, hidden, windows, SMs) -> (grid, splits, cph, groups, rounds, tail CTAs)
    ((240, 8, 480, 512, 132), (132, 4, 16, 128, 8, 128)),  # SwinIR-L's train step
    ((240, 8, 480, 6, 132), (3, 4, 2, 2, 1, 16)),
    ((240, 8, 480, 25, 132), (13, 4, 7, 7, 1, 56)),  # odd: the last pair's idle twin
    ((192, 8, 384, 100, 132), (50, 5, 16, 25, 2, 72)),
    ((240, 8, 960, 512, 132), (132, 3, 16, 128, 8, 128)),  # SwinIR-L at mlp 4: 15 chunks
    ((180, 6, 720, 512, 132), (132, 4, 22, 128, 6, 108)),  # block C / heads, hidden 720
]


@pytest.mark.parametrize("shape,want", _K5R_PLANS,
                         ids=["-".join(map(str, s)) for s, _ in _K5R_PLANS])
def test_k5r_plan_from_static_shapes(shape, want):
    """k5r_plan: K5a's cp-256 / hdp-32 plan (N parts of 128 rows, 16 KB
    ring stages, four of them) over a unit a window, K5b's splits, the
    attention's CTAs a head over stages of four windows, its rounds and
    the last round's CTAs; every launch within 227 KB of shared memory;
    the d(rpb) partials a consumer warpgroup's [64, 64] a head; the
    x1 / dx1 scratch a slice more where the windows are odd."""
    from tpu_superresolution_torch.kernels import fused_block as fb

    c, heads, hidden, windows, sms = shape
    p = fb.k5r_plan(c, heads, hidden, windows, sms)
    assert (p.grid, p.splits, p.cph, p.groups, p.rounds, p.tail_ctas) == want
    blk = p.block
    assert blk == fb.bwd_plan(c, heads, hidden, k5r=True)
    assert (blk.cp, blk.hdp, blk.kc, blk.pw, blk.halves) == (256, 32, 4, 128, 2)
    assert blk.stages == 4 and blk.chunks == -(-hidden // 64)
    assert (p.ws, p.wps, p.units, p.att_units) == (8, 4, windows, windows * heads)
    assert p.cph * heads <= sms
    for smem in (blk.smem, p.att_fwd_smem, p.att_bwd_smem):
        assert smem <= 232448
    tile = 64 * 2 * 32
    assert p.att_fwd_smem == 1024 + 2 * 4 * 3 * tile + 4096 + 32
    assert p.att_bwd_smem == 1024 + 2 * 4 * (4 * tile + 3 * 64 * 4) + 4096 + 32
    sizes = fb.tiled_bwd_bytes(p, heads)
    assert sizes["rpb partials"] == 2 * p.cph * heads * 64 * 64 * 4
    assert sizes["workspace"] == p.units * blk.window_bytes
    # x1 / dx1 a unit, and a slice of its own for an odd last unit's twin
    assert sizes["dx1 scratch"] == (windows + windows % 2) * 64 * 256 * 4


@pytest.mark.parametrize("shape", [(180, 6, 360), (264, 8, 528), (240, 16, 960), (256, 4, 512)],
                         ids=["block-widths", "C264", "heads16", "hd64"])
def test_k5r_plan_raises_outside_k5r(shape):
    from tpu_superresolution_torch.kernels.fused_block import k5r_plan

    with pytest.raises(ValueError, match="K5r takes"):
        k5r_plan(*shape, 128, 132)


_LAYOUTS = [
    # (C, heads, hidden[, k5r]) -> (cp, hdp, kc, halves, chunks, pw), None where it raises
    ((180, 6, 360), (192, 32, 3, 2, 6, 96)),
    ((48, 3, 100), (96, 16, 2, 1, 2, 96)),
    ((240, 8, 480), (256, 32, 4, 2, 8, 128)),
    ((224, 7, 448), (256, 32, 4, 2, 7, 128)),
    ((96, 6, 400), (96, 16, 2, 1, 7, 96)),
    ((264, 8, 528), None),
    ((96, 6, 520), (96, 16, 2, 1, 9, 96)),
    ((256, 4, 512), None),
    ((180, 6, 720), (192, 32, 3, 2, 12, 96)),
    ((240, 8, 960), (256, 32, 4, 2, 15, 128)),
    ((96, 6, 400, True), (256, 32, 4, 2, 7, 128)),
    ((180, 6, 720, True), (256, 32, 4, 2, 12, 128)),
    ((264, 6, 528, True), None),
]


@pytest.mark.parametrize("shape,want", _LAYOUTS,
                         ids=["-".join(map(str, s)) for s, _ in _LAYOUTS])
def test_stream_layout_by_width(shape, want):
    """stream_layout: the padded width, head dim and N parts from C and
    the heads alone, the hidden chunks from the hidden (any hidden): the
    block kernel's instantiation within its C and heads (the same as
    block_plan's where the hidden fits the forward kernel), K5r's cp-256
    layout past them, or for K5r (`k5r`), within K5r's; ValueError past
    both; block_plan itself raises past the block kernel's widths (C,
    heads or a hidden past 384), so no forward plan exists there."""
    from tpu_superresolution_torch.kernels import fused_block as fb

    if want is None:
        with pytest.raises(ValueError, match="K5r's backward C <= 256"):
            fb.stream_layout(*shape)
        return
    lay = fb.stream_layout(*shape)
    assert (lay.cp, lay.hdp, lay.kc, lay.halves, lay.chunks, lay.pw) == want
    assert fb.stream_layout(*shape) is lay
    c, heads, hidden = shape[:3]
    if lay.pw == fb.K5R_PW or hidden > fb.HIDP:
        with pytest.raises(ValueError, match="hidden <= 384; got"):
            fb.block_plan(c, heads, hidden)
    else:
        fp = fb.block_plan(c, heads, hidden)
        assert (fp.cp, fp.hdp, fp.kc, fp.halves, fp.chunks) == want[:5]


@pytest.mark.parametrize("shift", [0, 4])
def test_pack_block_tiles_at_k5r_widths(shift):
    """The stream K5r reads (``pack_block_tiles`` at C 240, 8 heads,
    hidden 480): as long as ``bwd_plan`` reckons; each tile unswizzled
    equals the raw weight rows it holds (q pre-scaled, zero past C, the
    heads and the hidden), the proj's and fc2's N parts 128 rows; the
    biases in their layout; the table [8, 225]; and the attention
    kernels' score term from the table and the codes equal to the
    gathered bias plus the shift mask, bit for bit."""
    from tests.test_torch_block_wg import _unswizzle
    from tests.test_torch_hat_block import _block_weights
    from tpu_superresolution_torch.kernels.fused_block import bwd_plan, pack_block_tiles
    from tpu_superresolution_torch.ops.window import (
        relative_position_bias,
        shift_mask_tensor,
        window_token_codes,
    )

    w, _, _ = _block_weights(np.random.default_rng(shift), c=C, nh=NH, hidden=HIDDEN, ws=WS)
    p = pack_block_tiles(w, dtype=torch.float32)
    plan = bwd_plan(C, NH, HIDDEN)
    assert p.layout.cp == 256 and p.layout.pw == 128 and p.tiles.numel() == plan.stream_len
    t = _stream_tiles(plan, NH)
    tile = lambda kind, *i: _unswizzle(p.tiles[t[kind](*i)[0]:][:t[kind](*i)[1] * 64]
                                       .reshape(-1, 64))
    hd, q_scale = C // NH, (C // NH) ** -0.5
    wq = w.wqkv.reshape(3, NH, hd, C)
    for hh in (0, NH - 1):
        for k in range(4):
            got = tile("qkv", hh, k).reshape(3, 32, 64)
            cols = slice(64 * k, min(64 * k + 64, C))
            want = torch.zeros(3, 32, 64)
            want[:, :hd, :cols.stop - cols.start] = wq[:, hh, :, cols]
            want[0] *= q_scale
            assert torch.equal(got, want)
    wp = torch.zeros(256, 256)
    wp[:C] = torch.nn.functional.pad(w.wproj.reshape(C, NH, hd), (0, 32 - hd)).reshape(C, 256)
    w2 = torch.zeros(256, 512)
    w2[:C, :HIDDEN] = w.wfc2
    for hf in range(2):
        for k in range(4):
            assert torch.equal(tile("proj", hf, k), wp[128 * hf:128 * hf + 128, 64 * k:64 * k + 64])
        for j in (0, 7):
            assert torch.equal(tile("fc2", j, hf), w2[128 * hf:128 * hf + 128, 64 * j:64 * j + 64])
    w1 = torch.zeros(512, 256)
    w1[:HIDDEN, :C] = w.wfc1
    assert torch.equal(tile("fc1", 7, 3), w1[448:512, 192:256])
    assert torch.equal(p.bfc1[:HIDDEN], w.bfc1) and not p.bfc1[HIDDEN:].any()
    assert torch.equal(p.bproj[:C], w.bproj) and not p.bproj[C:].any()
    assert tuple(p.table.shape) == (NH, 225) and torch.equal(p.table, w.table.t())
    h, wd = 16, 24
    codes = torch.from_numpy(window_token_codes(h, wd, WS, shift)).long()
    n_win = (h // WS) * (wd // WS)
    rpb = relative_position_bias(w.table, WS)
    mask = shift_mask_tensor(h, wd, WS, shift, torch.device("cpu")) if shift else None
    for win in range(n_win):
        for hh in range(NH):
            got = _bias8(p.table[hh], codes[win if shift else 0], shift > 0)
            assert torch.equal(got, rpb[hh] + (mask[win] if shift else 0.0))


_ROUTE_CASES = [
    # (ws, C, heads, hidden, qkv_bias, trains through K5r)
    (8, 240, 8, 480, True, True),     # SwinIR-L
    (8, 192, 8, 384, True, True),     # 8 heads > the block kernel's 6
    (8, 256, 8, 512, True, True),     # the envelope's corner
    (8, 96, 6, 400, True, True),      # hidden past 384
    (8, 264, 8, 528, True, False),    # C > 256
    (8, 240, 8, 960, True, True),     # hidden 960 (SwinIR-L at mlp 4): any hidden
    (8, 144, 6, 576, True, True),     # the block kernel's C and heads, hidden 576 (mlp 4)
    (8, 240, 16, 960, True, False),   # 16 heads > 8
    (8, 256, 4, 512, True, False),    # hd 64
    (8, 240, 8, 480, False, False),   # no qkv bias
    (7, 240, 8, 480, True, False),    # ws 7
    (24, 240, 8, 480, True, False),   # ws 24
    (16, 240, 8, 480, True, False),   # ws 16 past 192: neither K5w16 nor K5r
    (8, 180, 6, 360, True, False),    # the block kernel's widths: K5 on the block route
]


@pytest.mark.parametrize("ws,c,nh,hidden,bias,ok", _ROUTE_CASES,
                         ids=[f"ws{w}-C{c}-h{h}-hid{d}{'' if b else '-nobias'}"
                              for w, c, h, d, b, _ in _ROUTE_CASES])
def test_k5r_route_by_shape(ws, c, nh, hidden, bias, ok):
    """k5r_ok takes a ws-8 block that block_route sends to the K7 route
    within K5r's widths (C <= 256, <= 8 heads of hd <= 32, any hidden,
    qkv bias), the same on every call; a block within the block kernel's
    widths stays on the block route (K5); the tiled backward's shape
    check refuses the rest at ws 8."""
    from tpu_superresolution_torch.kernels.fused_block import (
        block_route,
        check_tiled_bwd_args,
        k5r_ok,
        tiled_bwd_ok,
    )

    assert k5r_ok(ws, c, nh, hidden, bias) is ok
    assert k5r_ok(ws, c, nh, hidden, bias) is ok
    assert tiled_bwd_ok(ws, c, nh, hidden, bias) is ok
    if ok:
        assert block_route(ws, c, nh, hidden, bias) == "window_attention"
    if (ws, c) == (8, 180):
        assert block_route(ws, c, nh, hidden, bias) == "block"
    if ws == 8 and not ok and c % nh == 0:
        rng = np.random.default_rng(0)
        p = _block_params(rng, c=c, nh=nh, hidden=hidden, ws=ws)
        w = _port_weights(p)
        if not bias:
            w = dataclasses.replace(w, bqkv=None)
        with pytest.raises(ValueError):
            check_tiled_bwd_args((1, 16, 16, c), w, ws, 0, "test")


def _swinir_l_small(**kw):
    """SwinIR-L's architecture (embed 240, 8 heads, ws 8, mlp 2, 3conv,
    nearest+conv) at depths (2, 2), as a JAX config."""
    from tests.util_torchport import small_swinir_config

    base = dict(embed_dim=C, depths=(2, 2), num_heads=(NH, NH), mlp_ratio=2.0,
                resi_connection="3conv", upsampler="nearest+conv", num_feat=64,
                drop_path_rate=0.0)
    base.update(kw)
    return small_swinir_config(**base)


def test_swinir_l_width_model_gradients_match_jax():
    """A SwinIR-L-width model (depths (2, 2); every block on the K7 route,
    which K5r trains on the card) on the port's CPU path: the L1 loss and
    every parameter's gradient against jax.value_and_grad of the JAX
    SwinIR, weights carried over by the interop bridge."""
    from tests.util_torchport import perturbed_jax_swinir, port_from_jax
    from tpu_superresolution_torch.interop import swinir_state_dict_from_jax
    from tpu_superresolution_torch.kernels.fused_block import block_route, k5r_ok

    assert block_route(WS, C, NH, HIDDEN) == "window_attention" and k5r_ok(WS, C, NH, HIDDEN)
    cfg = _swinir_l_small()
    jmodel, variables = perturbed_jax_swinir(cfg, seed=19)
    rng = np.random.default_rng(20)
    lr = rng.random((2, 16, 16, 3), dtype=np.float32)
    hr = rng.random((2, 64, 64, 3), dtype=np.float32)

    def loss_fn(params):
        out = jmodel.apply({"params": params}, jnp.asarray(lr), train=True)
        return jnp.mean(jnp.abs(out.astype(jnp.float32) - jnp.asarray(hr)))

    jloss, jgrads = jax.value_and_grad(loss_fn)(variables["params"])
    want = swinir_state_dict_from_jax({"params": jax.tree.map(np.asarray, jgrads)})
    model = port_from_jax(cfg, variables).train()
    loss = (model(torch.from_numpy(lr)) - torch.from_numpy(hr)).abs().mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, prm in model.named_parameters():
        assert prm.grad is not None and torch.isfinite(prm.grad).all(), name
        bound = 1e-3 * float(np.abs(want[name]).max()) + 1e-7
        err = float(np.abs(prm.grad.numpy() - want[name]).max())
        assert err <= bound, f"{name}: max |diff| {err:.3e} > {bound:.3e}"


def test_finetune_cli_on_a_swinir_l_checkpoint(tmp_path):
    """``finetune --device cpu`` on a reduced-depth SwinIR-L reference
    ``.pth`` (depths (1,), embed 240, 8 heads): it infers embed 240, 8
    heads, ws 8, mlp 2, 3conv and nearest+conv from the weights and takes
    a step."""
    from tests.util_fakedata import make_deeprock_dataset
    from tpu_superresolution_torch.cli.finetune import main
    from tpu_superresolution_torch.core.config import SwinIRConfig, build_model

    cfg = SwinIRConfig(scale=4, embed_dim=C, depths=(1,), num_heads=(NH,), window_size=WS,
                       mlp_ratio=2.0, resi_connection="3conv", upsampler="nearest+conv",
                       num_feat=64)
    src = build_model(cfg)
    src.reset_parameters(torch.Generator().manual_seed(0))
    weights = tmp_path / "swinir_l_d1.pth"
    torch.save({"params": src.state_dict()}, weights)
    root = tmp_path / "data"
    make_deeprock_dataset(root, scale="X4")
    trainer, state = main(["--data_root", str(root), "--scale", "X4", "--weights", str(weights),
                           "--epochs", "1", "--batch_size", "2", "--lr_patch", "16",
                           "--workdir", str(tmp_path / "run"), "--seed", "0", "--device", "cpu"])
    mc = trainer.model_config
    assert (mc.embed_dim, mc.depths, mc.num_heads, mc.window_size, mc.mlp_ratio) == \
        (C, (1,), (NH,), WS, 2.0)
    assert (mc.resi_connection, mc.upsampler) == ("3conv", "nearest+conv")
    assert state.step >= 1 and np.isfinite(trainer.history["train"][0])
