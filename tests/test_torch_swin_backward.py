"""K1 with branch scales and K5 (the Swin block backward): the port's
plain versions against the JAX package's ``fused_swin_block`` run in
interpret mode (its custom_vjp backward is ``_mega_backward``, the
Pallas K5), and the plain K5 against autograd of the plain K1.  fp32 on
the CPU; bounds atol 2e-4 / rtol 1e-3 on gradients (the JAX package's
own kernel-vs-vjp bound, tests/test_fused_attention.py) and 3e-5 on the
forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels_plain import _block_params, _port_weights, _t
from tests.util_torchport import TOL

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
SCALES = np.array([[1.25, 0.0], [1.0, 1.25]], np.float32)
B, H, W, WS = 2, 16, 24, 8


def _jax_block(p, shift, gelu_approx, scales):
    """x -> the JAX fused block on x (shift applied around it), as a
    function of (x, 12 weights, gathered bias) for jax.vjp."""
    from tpu_superresolution_tpu.ops.pallas.fused_block import fused_swin_block
    from tpu_superresolution_tpu.ops.window import cyclic_shift, cyclic_unshift, shift_attn_mask

    c = p["wqkv"].shape[0]
    mask = shift_attn_mask(H, W, WS, shift) if shift else None
    scale = (c // p["nh"]) ** -0.5

    def f(x, *args):
        *weights, bias = args
        out = fused_swin_block(cyclic_shift(x, shift), *weights, bias, WS, mask, scale,
                               gelu_approx, interpret=True,
                               branch_scales=None if scales is None else jnp.asarray(scales))
        return cyclic_unshift(out, shift)

    return f


def _gathered_bias(p):
    from tpu_superresolution_tpu.ops.window import relative_position_index

    n = WS * WS
    bias = p["table"][relative_position_index(WS).reshape(-1)].reshape(n, n, -1)
    return np.ascontiguousarray(bias.transpose(2, 0, 1))


_JAX_ORDER = ("g1", "b1", "wqkv", "bqkv", "wproj", "bproj", "g2", "b2",
              "wfc1", "bfc1", "wfc2", "bfc2")


def _as_port(name, g):
    """A JAX gradient of weight `name` in the port's [out, in] layout."""
    g = np.asarray(g)
    return g.T if name in ("wqkv", "wproj", "wfc1", "wfc2") else g


def _assert_close(got, want, what):
    np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=what)


@pytest.mark.parametrize("scales", [None, SCALES], ids=["no-scales", "scales"])
@pytest.mark.parametrize("gelu_approx", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("shift", [0, 4])
def test_k5_plain_matches_jax_mega_backward(shift, gelu_approx, scales):
    from tpu_superresolution_torch.kernels import fused_block, read_counters, reset_counters
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    rng = np.random.default_rng(100 + shift + 10 * gelu_approx + 20 * (scales is None))
    p = _block_params(rng)
    c = p["wqkv"].shape[0]
    x = rng.standard_normal((B, H, W, c)).astype(np.float32)
    ct = rng.standard_normal((B, H, W, c)).astype(np.float32)
    bias = _gathered_bias(p)
    leaves = [jnp.asarray(x)] + [jnp.asarray(p[k]) for k in _JAX_ORDER] + [jnp.asarray(bias)]
    f = _jax_block(p, shift, gelu_approx, scales)
    out, vjp = jax.vjp(f, *leaves)
    jgrads = vjp(jnp.asarray(ct))

    reset_counters()
    w = _port_weights(p)
    tmask = shift_mask_tensor(H, W, WS, shift, torch.device("cpu")) if shift else None
    tsc = None if scales is None else _t(scales)
    fwd = fused_block.fused_windows_block(_t(x), w, WS, shift, tmask, gelu_approx,
                                          branch_scales=tsc)
    assert np.abs(fwd.numpy() - np.asarray(out)).max() <= TOL
    got = fused_block.fused_swin_block_backward(_t(ct), _t(x), w, WS, shift, tmask,
                                                gelu_approx, branch_scales=tsc)
    assert not any(read_counters().values())  # CPU tensors: the plain versions ran

    _assert_close(got.dx.numpy(), np.asarray(jgrads[0]), "dx")
    for name, g in zip(_JAX_ORDER, jgrads[1:13]):
        _assert_close(getattr(got, name).numpy(), _as_port(name, g), name)
    _assert_close(got.rpb.numpy(), np.asarray(jgrads[13]), "rpb")


@pytest.mark.parametrize("shift", [0, 4])
def test_k5_plain_matches_autograd_of_plain_k1(shift):
    """The explicit chain of swin_block_bwd_plain equals torch autograd
    through swin_block_plain (fp32), table gradient included."""
    from tpu_superresolution_torch.kernels.fused_block import (
        GRAD_FIELDS,
        SwinBlockWeights,
        swin_block_bwd_plain,
        swin_block_plain,
    )
    from tpu_superresolution_torch.ops.window import relative_position_bias, shift_mask_tensor

    rng = np.random.default_rng(7 + shift)
    p = _block_params(rng)
    c = p["wqkv"].shape[0]
    w = _port_weights(p)
    x = _t(rng.standard_normal((B, H, W, c)).astype(np.float32)).requires_grad_()
    ct = _t(rng.standard_normal((B, H, W, c)).astype(np.float32))
    mask = shift_mask_tensor(H, W, WS, shift, torch.device("cpu")) if shift else None
    leaves = {k: getattr(w, k).clone().requires_grad_() for k in GRAD_FIELDS[:-1]}
    table = w.table.clone().requires_grad_()
    wl = SwinBlockWeights(table=table, num_heads=w.num_heads, **leaves)
    out = swin_block_plain(x, wl, WS, shift, mask, False, _t(SCALES))
    out.backward(ct)

    got = swin_block_bwd_plain(ct, x.detach(), w, WS, shift, mask, False, _t(SCALES))
    _assert_close(got.dx.numpy(), x.grad.numpy(), "dx")
    for k, leaf in leaves.items():
        _assert_close(getattr(got, k).numpy(), leaf.grad.numpy(), k)
    # d table = the gather's adjoint of d rpb
    t2 = w.table.clone().requires_grad_()
    relative_position_bias(t2, WS).backward(got.rpb)
    _assert_close(t2.grad.numpy(), table.grad.numpy(), "table")


def test_k5_plain_rounds_like_the_kernel_in_bf16():
    """In bf16 the plain K5 stays near its fp32 self (the casts sit where
    the kernel's bf16 operands are); a sanity bound of a few percent of
    each gradient's scale."""
    from tpu_superresolution_torch.kernels.fused_block import GRAD_FIELDS, swin_block_bwd_plain

    rng = np.random.default_rng(3)
    p = _block_params(rng)
    c = p["wqkv"].shape[0]
    w = _port_weights(p)
    x = _t(rng.standard_normal((B, H, W, c)).astype(np.float32))
    ct = _t(rng.standard_normal((B, H, W, c)).astype(np.float32))
    g32 = swin_block_bwd_plain(ct, x, w, WS, 0, None, True, _t(SCALES))
    g16 = swin_block_bwd_plain(ct.bfloat16(), x.bfloat16(), w, WS, 0, None, True, _t(SCALES))
    assert g16.dx.dtype == torch.bfloat16
    for k in ("dx",) + GRAD_FIELDS:
        a, b = getattr(g16, k).float(), getattr(g32, k)
        rel = ((a - b).norm() / b.norm()).item()
        assert rel < 0.05, (k, rel)


# ---------------------------------------------------------------------------
# The Hopper backward's host side (csrc/swin_block_bwd.cu): its launch plan,
# the fold of tile-space gradients to raw weight space, and its schedule
# written out in torch ops on the forward's packed stream.


def _stream_tiles(plan, heads):
    """(offset, rows) of each tile of ``pack_block_tiles``' weight stream
    by kind: qkv (head, K chunk), proj (N part, K chunk), fc1 (hidden
    chunk, K chunk), fc2 (hidden chunk, N part); N parts of plan.pw rows."""
    q3, kc, halves, pw = 3 * plan.hdp, plan.kc, plan.halves, plan.pw
    p0 = heads * kc * q3 * 64
    p1 = p0 + halves * kc * pw * 64
    chunk = kc * 64 * 64 + halves * pw * 64
    return dict(qkv=lambda h, k: ((h * kc + k) * q3 * 64, q3),
                proj=lambda hf, k: (p0 + (hf * kc + k) * pw * 64, pw),
                fc1=lambda j, k: (p1 + j * chunk + k * 64 * 64, 64),
                fc2=lambda j, hf: (p1 + j * chunk + kc * 64 * 64 + hf * pw * 64, pw))


def _feeder_order(plan, heads):
    """The tiles K5a's feeder streams for a window pair, in order: qkv,
    proj (the forward's recompute); per hidden chunk fc1, fc2, fc1; proj
    by K chunk; qkv (the heads' recompute); qkv (dy)."""
    t = _stream_tiles(plan, heads)
    kc, halves = plan.kc, plan.halves
    qkv = [t["qkv"](h, k) for h in range(heads) for k in range(kc)]
    order = qkv + [t["proj"](hf, k) for hf in range(halves) for k in range(kc)]
    for j in range(plan.chunks):
        fc1 = [t["fc1"](j, k) for k in range(kc)]
        order += fc1 + [t["fc2"](j, hf) for hf in range(halves)] + fc1
    order += [t["proj"](hf, k) for k in range(kc) for hf in range(halves)]
    return order + qkv + qkv


def _stream_offsets(plan, heads, kind, rows, cols):
    """K5b's epilogue map (``stream_offset``): where dW's entry (m, n) of
    product `kind` (0 qkv, 1 proj, 2 fc1, 3 fc2) sits in the weight
    stream, -1 where the stream has no entry."""
    q3, kc, halves, pw = 3 * plan.hdp, plan.kc, plan.halves, plan.pw
    m, n = torch.arange(rows)[:, None], torch.arange(cols)[None, :]
    p0 = heads * kc * q3 * 64
    p1 = p0 + halves * kc * pw * 64
    chunk = kc * 64 * 64 + halves * pw * 64
    swz = lambda r, k: ((((k >> 3) ^ r) & 7) << 3) | (k & 7)
    if kind == 0:
        h, r = m // q3, m % q3
        return torch.where(h < heads, (h * kc + n // 64) * q3 * 64 + r * 64 + swz(r, n % 64), -1)
    if kind == 2:
        j, r = m // 64, m % 64
        return p1 + j * chunk + (n // 64) * 64 * 64 + r * 64 + swz(r, n % 64)
    hf, r = m // pw, m % pw
    if kind == 1:
        off = p0 + (hf * kc + n // 64) * pw * 64 + r * 64 + swz(r, n % 64)
    else:
        off = p1 + (n // 64) * chunk + kc * 64 * 64 + hf * pw * 64 + r * 64 + swz(r, n % 64)
    return torch.where(hf < halves, off, -1)


def wgrad_emulated(ops, plan, nh, splits):
    """K5b and K5c in torch ops on the workspace `ops` ([units, 64, cols]
    each of ``BWD_OPERANDS``): dW = dY^T X per split of the units into
    the weight stream's layout, the bias sums dY^T 1 after it
    (pack_block_tiles' bias layout), the splits summed.  Returns (that
    vector, how many times K5b writes each entry of it)."""
    q3, cp, hid = 3 * plan.hdp, plan.cp, plan.chunks * 64
    units = ops["yc"].shape[0]
    row_len = plan.stream_len + plan.bias_len
    pw = torch.full((splits, row_len), float("nan"))
    written = torch.zeros(row_len, dtype=torch.long)
    nq = nh * q3
    for kind, (dname, xname, boff, brows) in enumerate((
            ("dqkv", "yc", 0, nq), ("dattn", "o", nq, cp), ("dh1", "y2c", nq + cp, hid),
            ("dmlp", "act", nq + cp + hid, cp))):
        dys, xs_ = ops[dname], ops[xname]
        off = _stream_offsets(plan, nh, kind, dys.shape[2], xs_.shape[2])
        real = off >= 0
        written.index_add_(0, off[real], torch.ones_like(off[real]))
        written[plan.stream_len + boff:plan.stream_len + boff + brows] += 1
        for s in range(splits):
            wb, we = units * s // splits, units * (s + 1) // splits
            part = torch.einsum("wtm,wtn->mn", dys[wb:we], xs_[wb:we])
            pw[s, off[real]] = part[real]
            pw[s, plan.stream_len + boff:plan.stream_len + boff + brows] = \
                dys[wb:we, :, :brows].sum((0, 1))
    return pw.sum(0), written


def block_bwd_emulated(ct, x, p, ws, shift, shifted, gelu_approx, scales=None, extra=None,
                       grid=3, splits=3):
    """csrc/swin_block_bwd.cu's schedule in fp32 torch ops on the
    forward's packed operands `p` (``pack_block_tiles``): K5a's window
    pairs over `grid` CTAs (the second of an odd last pair recomputed and
    not stored), every product on the feeder's tiles in stream order (Y
    W^T on a tile read K-major, dY W on the same tile read MN-major), the
    bias from the table and the codes, the dW operands into a workspace
    (never-written entries NaN), per-(CTA, warp) LN sums and per-(CTA,
    warpgroup) d(rpb); K5b's products over `splits` splits of the windows
    into the weight stream's layout, each split's bias sums (dY^T 1) after
    it; the ordered sums; the fold.  Returns (dx, d extra, raw gradients, stream entries written)."""
    from tests.test_torch_block_wg import _kernel_bias, _unswizzle
    from tpu_superresolution_torch.kernels.fused_block import (
        BWD_OPERANDS,
        bwd_plan,
        fold_block_grads,
        gelu,
        gelu_grad,
    )
    from tpu_superresolution_torch.ops.window import window_token_codes

    b, h, w, c = x.shape
    nh, hidden = p.num_heads, p.hidden
    plan = bwd_plan(c, nh, hidden)
    cp, hdp, kc, halves, chunks = plan.cp, plan.hdp, plan.kc, plan.halves, plan.chunks
    k_cols, q3, nt = kc * 64, 3 * plan.hdp, ws * ws
    codes = torch.from_numpy(window_token_codes(h, w, ws, shift if shifted else 0)).long()
    nww, per = w // ws, (h // ws) * (w // ws)
    windows = b * per
    pairs = -(-windows // 2)
    tiles = p.tiles.float()
    order = _feeder_order(plan, nh)
    ops = {n: torch.full((windows, 64, t * 64), float("nan"))
           for n, t in zip(BWD_OPERANDS, plan.op_tiles)}
    pvec = torch.zeros(grid, 2, 4, 4 * cp)
    prpb = torch.zeros(grid, 2, nh, 64, 64)
    dx = torch.full_like(x, float("nan"))
    dex = None if extra is None else torch.full_like(x, float("nan"))
    t = torch.arange(64)
    row_ok = t < nt
    tt = torch.where(row_ok, t, 0)

    def ln(v, g, bb):  # fast-variance LN over the first C columns, zero past them
        mu = v[:, :c].mean(-1, keepdim=True)
        var = ((v[:, :c] ** 2).mean(-1, keepdim=True) - mu * mu).clamp_min(0)
        r = torch.rsqrt(var + 1e-5)
        n, y = torch.zeros(64, k_cols), torch.zeros(64, k_cols)
        n[:, :c] = (v[:, :c] - mu) * r
        y[:, :c] = n[:, :c] * g + bb
        return y, n, r

    def ln_back(dy, n, r, g):
        dyg = dy[:, :c] * g
        return r * (dyg - dyg.mean(-1, keepdim=True)
                    - n[:, :c] * (dyg * n[:, :c]).mean(-1, keepdim=True))

    def sums(vec_rows):  # per-warp column sums of [64, n] values
        return vec_rows.reshape(4, 16, -1).sum(1)

    for cta in range(grid):
        for pr in range(cta, pairs, grid):
            for cw in range(2):
                w0 = 2 * pr + cw
                active = w0 < windows
                wv = w0 if active else windows - 1
                bi, win = divmod(wv, per)
                wy, wx = divmod(win, nww)
                rr = (wy * ws + tt // ws + shift) % h
                cc = (wx * ws + tt % ws + shift) % w
                rows = lambda a: torch.where(row_ok[:, None], a[bi, rr, cc], 0.0)
                xs, cts = torch.zeros(64, k_cols), torch.zeros(64, k_cols)
                es = torch.zeros(64, k_cols)
                xs[:, :c], cts[:, :c] = rows(x), rows(ct)
                if extra is not None:
                    es[:, :c] = rows(extra)
                m1, m2 = (1.0, 1.0) if scales is None else (scales[bi, 0], scales[bi, 1])
                feed = iter(order)

                def tile():  # the next ring tile, unswizzled: [rows, 64]
                    off, n_rows = next(feed)
                    return _unswizzle(tiles[off:off + n_rows * 64].reshape(n_rows, 64))

                crow = codes[win if shifted else 0]
                bias = [_kernel_bias(p, ws, crow, hh, shifted) for hh in range(nh)]

                def head(yc, hh):  # a head's q, k, v and P from the A buffer
                    acc = sum(yc[:, 64 * k:64 * k + 64] @ tile().T for k in range(kc))
                    q, kk, v = (acc + p.bqkv[hh * q3:(hh + 1) * q3]).split(hdp, -1)
                    return q, kk, v, (q @ kk.T + bias[hh]).softmax(-1)

                # F1: LN1, the attention forward
                yc, n1, r1 = ln(xs, p.g1, p.b1)
                o = torch.zeros(64, k_cols)
                for hh in range(nh):
                    _, _, v, pa = head(yc, hh)
                    o[:, hh * hdp:(hh + 1) * hdp] = pa @ v
                # F2: x1, LN2; dmlp
                proj = torch.cat([sum(o[:, 64 * k:64 * k + 64] @ tile().T for k in range(kc))
                                  for _ in range(halves)], -1)
                x1 = torch.zeros(64, k_cols)
                x1[:, :cp] = xs[:, :cp] + m1 * (proj + p.bproj) + es[:, :cp]
                y2c, n2, r2 = ln(x1, p.g2, p.b2)
                dmlp = cts * m2
                # M: per hidden chunk fc1 (recompute), dmlp Wfc2, dy2 += dh1 Wfc1
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
                # L2: LN2 backward
                dx1 = torch.zeros(64, k_cols)
                dx1[:, :c] = cts[:, :c] + ln_back(dy2, n2, r2, p.g2)
                dattn = dx1 * m1
                # P: do = dattn Wproj by K chunk
                do = torch.zeros(64, k_cols)
                for k in range(kc):
                    for hf in range(halves):
                        do[:, 64 * k:64 * k + 64] += dattn[:, 96 * hf:96 * hf + 96] @ tile()
                # A2: per head, the query rows' and the key rows' passes
                dqkv = torch.zeros(64, nh * q3)
                drpb = torch.zeros(nh, 64, 64)
                for hh in range(nh):
                    q, kk, v, pa = head(yc, hh)
                    doh = do[:, hh * hdp:(hh + 1) * hdp]
                    da = doh @ v.T
                    ds = pa * (da - (da * pa).sum(-1, keepdim=True))
                    drpb[hh] = ds
                    pt = torch.where(row_ok[:, None] & row_ok[None, :], pa.T, 0.0)  # P^T
                    dqkv[:, hh * q3:(hh + 1) * q3] = torch.cat([ds @ kk, ds.T @ q, pt @ doh], -1)
                # D: dy = dqkv Wqkv over the heads, LN1 backward
                dy = torch.zeros(64, k_cols)
                for hh in range(nh):
                    for k in range(kc):
                        dy[:, 64 * k:64 * k + 64] += dqkv[:, hh * q3:(hh + 1) * q3] @ tile()
                assert next(feed, None) is None  # the window took the pair's whole stream
                if not active:
                    continue
                dxw = dx1[:, :c] + ln_back(dy, n1, r1, p.g1)
                ok = row_ok
                dx[bi, rr[ok], cc[ok]] = dxw[ok]
                if dex is not None:
                    dex[bi, rr[ok], cc[ok]] = dx1[ok, :c]
                for name, val, n_cols in (("yc", yc, cp), ("o", o, nh * hdp), ("y2c", y2c, cp),
                                          ("act", act, chunks * 64), ("dqkv", dqkv, nh * q3),
                                          ("dattn", dattn, cp), ("dh1", dh1, chunks * 64),
                                          ("dmlp", dmlp, cp)):
                    ops[name][wv, :, :n_cols] = val[:, :n_cols]
                pvec[cta, cw] += torch.cat([
                    sums((dy * n1)[:, :cp]), sums(dy[:, :cp]), sums((dy2 * n2)[:, :cp]),
                    sums(dy2[:, :cp])], -1)
                prpb[cta, cw] += drpb

    gv, written = wgrad_emulated(ops, plan, nh, splits)
    gv = torch.cat([gv, pvec.reshape(-1, 4 * cp).sum(0)])
    rpb = prpb.reshape(-1, nh * 64 * 64).sum(0)
    grads = fold_block_grads(gv, rpb, c, nh, hidden, ws)
    return dx, dex, grads, written


_BWD_PLANS = [((180, 6, 360), (192, 32, 6, 8)), ((96, 6, 384), (96, 16, 6, 8)),
              ((96, 6, 192), (96, 16, 3, 8)), ((48, 3, 100), (96, 16, 2, 8)),
              ((144, 6, 288), (192, 32, 5, 8)), ((96, 3, 192), (96, 32, 3, 8))]


@pytest.mark.parametrize("shape,want", _BWD_PLANS,
                         ids=["-".join(map(str, s)) for s, _ in _BWD_PLANS])
def test_bwd_plan_by_width(shape, want):
    """K5a / K6b's plan from static shapes at the forward's widths: the
    forward's instantiation, 8 ring stages of 12 KB within 227 KB of
    shared memory (two windows' A and R buffers, head tiles and
    statistics, the table), the workspace's tiles a window (2,304 columns
    at SwinIR-M's widths), the sums' vector and the weight stream's
    length (that of ``pack_block_tiles``)."""
    from tests.test_torch_hat_block import _block_weights
    from tpu_superresolution_torch.kernels import fused_block as fb

    c, heads, hidden = shape
    plan = fb.bwd_plan(c, heads, hidden)
    assert (plan.cp, plan.hdp, plan.chunks, plan.stages) == want
    assert plan.smem <= 232448 and 2 <= plan.stages <= fb.BWD_MAX_STAGES
    assert fb.bwd_plan(c, heads, hidden) is plan
    fp = fb.block_plan(c, heads, hidden)
    assert (plan.kc, plan.halves) == (fp.kc, fp.halves)
    w, _, _ = _block_weights(np.random.default_rng(c), c=c, nh=heads, hidden=hidden, ws=8)
    pk = fb.pack_block_tiles(w, dtype=torch.float32)
    assert plan.stream_len == pk.tiles.numel()
    assert plan.bias_len == pk.bqkv.numel() + pk.bproj.numel() + pk.bfc1.numel() + \
        pk.bfc2.numel()
    assert plan.vec_len == plan.bias_len + 4 * plan.cp
    if shape == (180, 6, 360):
        assert sum(plan.op_tiles) * 64 == 2304 and plan.window_bytes == 2304 * 64 * 2
        assert plan.units == 24 and fb.bwd_grid(plan, 512, 132) == (132, 11)
    assert fb.bwd_grid(plan, 800, 132)[0] == 132 and fb.bwd_grid(plan, 3, 132)[0] == 2


@pytest.mark.parametrize("shape", [(198, 6, 396), (264, 8, 528), (192, 4, 384), (96, 2, 520)])
def test_bwd_plan_raises_past_the_widths(shape):
    from tpu_superresolution_torch.kernels.fused_block import bwd_plan

    with pytest.raises(ValueError, match="swin_block kernel takes"):
        bwd_plan(*shape)


@pytest.mark.parametrize("c,nh,hidden,ws", [(180, 6, 360, 8), (96, 6, 384, 7), (48, 3, 100, 8)])
def test_fold_is_the_transpose_of_the_tile_gather(c, nh, hidden, ws):
    """fold_block_grads is the adjoint of pack_block_tiles' gather: for
    any tile-space gradient G, <pack(W), G> = <W, fold(G)> over the
    weights and biases (q's pre-scale carried); each raw entry's gradient
    is the sum of its tile entries (index_add over ``_tile_indices``),
    pad entries are dropped (NaN there changes nothing), the LN params
    and d(rpb) come from the sums' tail and the token-padded bias."""
    from tests.test_torch_hat_block import _block_weights
    from tpu_superresolution_torch.kernels import fused_block as fb

    w, _, _ = _block_weights(np.random.default_rng(c + ws), c=c, nh=nh, hidden=hidden, ws=ws)
    plan = fb.bwd_plan(c, nh, hidden)
    pk = fb.pack_block_tiles(w, dtype=torch.float32)
    gen = torch.Generator().manual_seed(c)
    g_tiles = torch.randn(plan.stream_len, generator=gen, dtype=torch.float64).float()
    vec = torch.randn(plan.vec_len, generator=gen, dtype=torch.float64).float()
    rpb = torch.randn(nh * 64 * 64, generator=gen, dtype=torch.float64).float()
    got = fb.fold_block_grads(torch.cat([g_tiles, vec]), rpb, c, nh, hidden, ws)
    # adjoint: <pack(W), G> = <W, fold(G)>
    lhs = (pk.tiles.double() * g_tiles.double()).sum() + sum(
        (getattr(pk, k).double() * part.double()).sum() for k, part in zip(
            ("bqkv", "bproj", "bfc1", "bfc2"),
            vec[:plan.bias_len].split([pk.bqkv.numel(), pk.bproj.numel(), pk.bfc1.numel(),
                                       pk.bfc2.numel()])))
    rhs = sum((getattr(w, k).double() * got[k].double()).sum()
              for k in ("wqkv", "wproj", "wfc1", "wfc2", "bqkv", "bproj", "bfc1", "bfc2"))
    assert abs(float(lhs - rhs)) <= 1e-9 * float(abs(lhs)) + 1e-6
    # the sum of each raw entry's tile entries, q pre-scale carried
    tile_idx, bias_idx, q_scale = fb._tile_indices(c, nh, hidden, torch.device("cpu"))
    n_w, n_b = 4 * c * c + 2 * hidden * c, 5 * c + hidden
    want = torch.zeros(n_w + 1).index_add_(0, tile_idx, g_tiles)[:n_w]
    want[:3 * c * c] = (want[:3 * c * c].reshape(3 * c, c) * q_scale).reshape(-1)
    flat = torch.cat([got[k].reshape(-1) for k in ("wqkv", "wproj", "wfc1", "wfc2")])
    assert torch.equal(flat, want)
    bwant = torch.zeros(n_b + 1).index_add_(0, bias_idx, vec[:plan.bias_len])[:n_b]
    bwant[:3 * c] *= q_scale[:, 0]
    assert torch.equal(torch.cat([got[k] for k in ("bqkv", "bproj", "bfc1", "bfc2")]), bwant)
    # NaN in the pad entries changes nothing
    pad = torch.ones(plan.stream_len, dtype=torch.bool)
    pad[torch.unique(torch.nonzero(tile_idx < n_w)[:, 0])] = False
    g_nan = g_tiles.clone()
    g_nan[pad] = float("nan")
    again = fb.fold_block_grads(torch.cat([g_nan, vec]), rpb, c, nh, hidden, ws)
    assert all(torch.equal(again[k], got[k]) for k in got)
    ln = vec[plan.bias_len:].reshape(4, plan.cp)
    for i, k in enumerate(("g1", "b1", "g2", "b2")):
        assert torch.equal(got[k], ln[i, :c])
    n = ws * ws
    assert torch.equal(got["rpb"], rpb.reshape(nh, 64, 64)[:, :n, :n])


_BWD_SCHEDULES = [
    # (b, h, w, c, heads, hidden, ws, shift, extra, scales, grid)
    ((1, 24, 8, 48, 3, 100, 8, 4, True, True, 2), "ws8-odd-windows-extra-scales"),
    ((2, 16, 16, 96, 3, 192, 8, 0, False, False, 3), "ws8-hd32-cp96"),
    ((2, 14, 21, 72, 4, 144, 7, 3, True, False, 4), "ws7-cp192-shifted"),
    ((1, 14, 14, 30, 2, 60, 7, 0, False, True, 1), "ws7-odd-c-pad-rows"),
]


@pytest.mark.parametrize("shape", [s for s, _ in _BWD_SCHEDULES],
                         ids=[i for _, i in _BWD_SCHEDULES])
def test_bwd_schedule_emulated_matches_plain(shape):
    """The backward's schedule in torch (two windows a CTA over a static
    grid, the feeder's tile order read K-major and MN-major, pad rows and
    keys, token codes, per-CTA d(rpb) and per-warp LN sums, the
    workspace's tiles, K5b's splits into the weight stream with the bias
    sums after it, the ordered sums and the fold) on the forward's packed
    operands reproduces swin_block_bwd_plain at fp32 (atol 2e-4 / rtol
    1e-3); K5b writes every stream and bias entry once; nothing NaN leaks
    from unwritten entries."""
    from tests.test_torch_hat_block import _block_weights
    from tpu_superresolution_torch.kernels.fused_block import (
        GRAD_FIELDS,
        pack_block_tiles,
        swin_block_bwd_plain,
    )
    from tpu_superresolution_torch.ops.window import shift_mask_tensor

    b, h, wd, c, nh, hidden, ws, shift, with_extra, with_scales, grid = shape
    rng = np.random.default_rng(c * ws + shift + 1)
    w, _, _ = _block_weights(rng, c=c, nh=nh, hidden=hidden, ws=ws)
    x = torch.from_numpy(rng.standard_normal((b, h, wd, c)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((b, h, wd, c)).astype(np.float32))
    extra = (torch.from_numpy((0.5 * rng.standard_normal((b, h, wd, c))).astype(np.float32))
             if with_extra else None)
    scales = (torch.tensor([[1 / 0.9, 0.0], [0.0, 1 / 0.9]])[:b] if with_scales else None)
    mask = shift_mask_tensor(h, wd, ws, shift, torch.device("cpu")) if shift else None
    p = pack_block_tiles(w, dtype=torch.float32)
    dx, dex, got, written = block_bwd_emulated(ct, x, p, ws, shift, mask is not None, True,
                                               scales, extra, grid=grid)
    want = swin_block_bwd_plain(ct, x, w, ws, shift, mask, True, scales, extra)
    assert torch.equal(written, torch.ones_like(written))
    _assert_close(dx.numpy(), want.dx.numpy(), "dx")
    if with_extra:
        _assert_close(dex.numpy(), want.extra.numpy(), "dextra")
    for k in GRAD_FIELDS:
        _assert_close(got[k].numpy(), getattr(want, k).numpy(), k)


@pytest.mark.parametrize("gelu_approx", [True, False], ids=["tanh", "erf"])
def test_bwd_schedule_emulated_matches_jax_mega_backward(gelu_approx):
    """The backward's schedule (ws 8, shift 4, C 48 in 3 heads, `extra`
    and branch scales) against jax.vjp of the JAX package's
    ``fused_swin_block`` in interpret mode (its backward is
    ``_mega_backward``, the Pallas K5): dx, d extra, every weight and
    bias gradient and the gathered bias's."""
    from tests.test_torch_hat_block import _block_weights
    from tests.test_torch_hat_train import SCALES as HSCALES
    from tests.test_torch_hat_train import _jax_block_fn
    from tpu_superresolution_tpu.ops.window import relative_position_index
    from tpu_superresolution_torch.kernels.fused_block import pack_block_tiles

    ws, shift, b, h, wd, c, nh, hidden = 8, 4, 2, 16, 24, 48, 3, 96
    rng = np.random.default_rng(500 + gelu_approx)
    w, args, table = _block_weights(rng, c=c, nh=nh, hidden=hidden, ws=ws)
    x = rng.standard_normal((b, h, wd, c)).astype(np.float32)
    extra = (0.5 * rng.standard_normal((b, h, wd, c))).astype(np.float32)
    ct = rng.standard_normal((b, h, wd, c)).astype(np.float32)
    n = ws * ws
    bias = table[relative_position_index(ws).reshape(-1)].reshape(n, n, nh).transpose(2, 0, 1)
    f = _jax_block_fn("strip", ws, shift, b, h, wd, c, nh, gelu_approx)
    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(extra), *args, jnp.asarray(bias))
    jgrads = vjp(jnp.asarray(ct))
    p = pack_block_tiles(w, dtype=torch.float32)
    dx, dex, got, _ = block_bwd_emulated(_t(ct), _t(x), p, ws, shift, True, gelu_approx,
                                         _t(HSCALES), _t(extra))
    _assert_close(dx.numpy(), np.asarray(jgrads[0]), "dx")
    _assert_close(dex.numpy(), np.asarray(jgrads[1]), "dextra")
    for name, g in zip(_JAX_ORDER, jgrads[2:14]):
        _assert_close(got[name].numpy(), _as_port(name, g), name)
    _assert_close(got["rpb"].numpy(), np.asarray(jgrads[14]), "rpb")
