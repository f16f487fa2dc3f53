"""K16 on Hopper (csrc/batched_attn_wg.cu, ``k15_route``'s "square"
route), DAT's batched window attention, in the PyTorch port against the
JAX package, fp32 on the CPU: the kernel's schedule written out in torch
ops — a grid of CTAs over (head, mask plane, 128-query row block) keys,
``sq_ctas_per_key`` CTAs a key, each CTA walking the windows of its mask
plane (w % nW = m) from its own start; the key's table of bias[h] +
mask[m] over its 128 query rows, built once a CTA; a unit's two 64-row
query tiles, one a consumer, against all N keys in groups of 128 (64 at
hd past 32) with an online softmax (scores times the scale plus the
table, exp, the row sums of the unrounded P); P V with P as three bf16
parts — against ``batched_window_attention_plain`` and the JAX
``batched_window_attention`` in interpret mode, at N 128 and 256, hd 30
and 64 (and 16, 44, 45), masked and not, with odd window counts; the
split of P on its own against the fp32 softmax; ``sq_plan`` and
``sq_ctas_per_key`` from static shapes; K16's kernel path routing DAT's
windows to the square kernel.

Bounds: 3e-5 max abs (fp32 forwards, the JAX package's parity bound);
the three-part P within 2^-20 max|v| of the fp32 output (the parts carry
fp32's 24 bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_wide_routes import k15_emulated  # noqa: F401 (a fixture)
from tests.util_torchport import TOL

torch.set_num_threads(1)

SMS = 5  # a card of 5 SMs: several CTAs a key, each walking a few windows


def _inputs(bw, nh, n, hd, n_mask, seed):
    """q (pre-scaled by hd^-0.5 in the caller's scale), k, v, the bias and
    DAT's 0 / -100 shift mask, from numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((bw, nh, n, hd)).astype(np.float32) for _ in range(3))
    bias = (0.5 * rng.standard_normal((nh, n, n))).astype(np.float32)
    mask = None
    if n_mask:
        ids = rng.integers(0, 3, size=(n_mask, n))
        mask = np.where(ids[:, :, None] != ids[:, None, :], -100.0, 0.0).astype(np.float32)
    return q, k, v, bias, mask


def _bf16_parts(p, parts):
    """p as the sum of `parts` bf16 parts, each the bf16 rounding of what
    the parts before it leave (the kernel's split of P); 0: p itself."""
    if not parts:
        return p
    out, rest = torch.zeros_like(p), p
    for _ in range(parts):
        part = rest.to(torch.bfloat16).float()
        out, rest = out + part, rest - part
    return out


def _sq_emulated(q, k, v, bias, mask, scale, sms, parts):
    """csrc/batched_attn_wg.cu's schedule in torch ops (fp32; `parts`: P V
    with P as that many bf16 parts, the kernel's three, or 0 for fp32 P)."""
    from tpu_superresolution_torch.kernels.window_attention import (
        SQ_ROWS,
        sq_ctas_per_key,
        sq_plan,
    )

    bw, nh, n, hd = q.shape
    plan = sq_plan(n, hd)
    n_mask = 1 if mask is None else mask.shape[0]
    keys = nh * n_mask * plan.row_blocks
    per_key = sq_ctas_per_key(bw, keys, n_mask, sms)
    hdp = 16 if hd <= 16 else 32 if hd <= 32 else 64
    group = 16 * (4 if hdp == 64 else 8)  # keys a group of the online softmax
    out = torch.full_like(q, float("nan"))
    visits = torch.zeros(bw, nh, plan.row_blocks, dtype=torch.long)
    for cta in range(keys * per_key):
        key, g = divmod(cta, per_key)
        hm, rb = divmod(key, plan.row_blocks)
        h, m = divmod(hm, n_mask)
        rows = slice(rb * SQ_ROWS, (rb + 1) * SQ_ROWS)
        table = bias[h, rows] + (0.0 if mask is None else mask[m, rows])  # the CTA's, once
        nj = -(-(bw - m) // n_mask) if bw > m else 0
        for j in range(g, nj, per_key):
            w = m + j * n_mask
            visits[w, h, rb] += 1
            qp, kp, vp = (torch.nn.functional.pad(t[w, h], (0, hdp - hd)) for t in (q, k, v))
            for cw in range(2):  # a consumer a 64-row query tile
                t0 = rb * SQ_ROWS + 64 * cw
                mx, l = torch.full((64,), float("-inf")), torch.zeros(64)
                o = torch.zeros(64, hdp)
                for k0 in range(0, n, group):  # the online softmax over the groups
                    cols = slice(k0, k0 + group)
                    s = qp[t0:t0 + 64] @ kp[cols].T * scale + table[64 * cw:64 * cw + 64, cols]
                    mn = torch.maximum(mx, s.max(1).values)
                    alpha = torch.exp(mx - mn)
                    p = torch.exp(s - mn[:, None])
                    l = l * alpha + p.sum(1)
                    o = o * alpha[:, None] + _bf16_parts(p, parts) @ vp[cols]
                    mx = mn
                out[w, h, t0:t0 + 64] = (o / l[:, None])[:, :hd]
    assert torch.equal(visits, torch.ones_like(visits))  # every unit exactly once
    return out


_CASES = [
    # (BW, nH, N, hd, mask planes): DAT's split (8, 16) and the published
    # x4's (8, 32); odd window counts, a last plane with fewer windows
    (5, 2, 128, 30, 2),
    (4, 2, 128, 30, 0),
    (3, 1, 256, 30, 2),
    (3, 2, 256, 16, 0),
    (3, 2, 128, 64, 2),
    (5, 1, 128, 45, 0),
    (3, 1, 128, 44, 3),
]
_IDS = [f"bw{c[0]}-n{c[2]}-hd{c[3]}-m{c[4]}" for c in _CASES]


@pytest.mark.parametrize("case", _CASES, ids=_IDS)
def test_square_schedule_matches_plain_and_jax_kernel(case):
    """The square kernel's schedule (fp32 P) against the plain version
    and the JAX batched_window_attention in interpret mode."""
    from tpu_superresolution_tpu.ops.pallas.window_attention import batched_window_attention
    from tpu_superresolution_torch.kernels.window_attention import (
        batched_window_attention_plain,
    )

    bw, nh, n, hd, n_mask = case
    q, k, v, bias, mask = _inputs(*case, seed=sum(case))
    scale = hd ** -0.5
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    tm = None if mask is None else torch.from_numpy(mask)
    got = _sq_emulated(tq, tk, tv, tb, tm, scale, SMS, parts=0)
    assert not torch.isnan(got).any()
    plain = batched_window_attention_plain(tq, tk, tv, tb, tm, scale)
    assert (got - plain).abs().max().item() <= TOL
    want = batched_window_attention(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                    None if mask is None else jnp.asarray(mask), scale=scale,
                                    interpret=True, group=1)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


@pytest.mark.parametrize("case", [_CASES[0], _CASES[2], _CASES[4]],
                         ids=[_IDS[0], _IDS[2], _IDS[4]])
def test_square_split_p_within_its_bound(case):
    """P V with P in three bf16 parts (the kernel's form: P to fp32's 24
    bits) stays within 2^-20 max|v| of the fp32 softmax's output; P in two
    parts (16 bits, the tiled and stream kernels' split P) is farther off,
    and P rounded to bf16 once farther still."""
    from tpu_superresolution_torch.kernels.window_attention import (
        batched_window_attention_plain,
    )

    q, k, v, bias, mask = (None if a is None else torch.from_numpy(a)
                           for a in _inputs(*case, seed=7 + sum(case)))
    scale = case[3] ** -0.5
    plain = batched_window_attention_plain(q, k, v, bias, mask, scale)
    err = {parts: (_sq_emulated(q, k, v, bias, mask, scale, SMS, parts) - plain).abs().max().item()
           for parts in (3, 2, 1)}
    assert err[3] <= 2.0 ** -20 * v.abs().max().item()
    assert err[3] < err[2] < err[1]


@pytest.mark.parametrize("n,hd,stages", [(128, 16, 4), (128, 30, 4), (128, 64, 2), (256, 16, 4),
                                         (256, 30, 2), (256, 32, 2)])
def test_sq_plan_from_static_shapes(n, hd, stages):
    """The square kernel's plan: N / 16 slices, N / 128 row blocks, the
    most stages (at most four) beside the [128, N + 8] fp32 table, within
    a CTA's 232,448 bytes of shared memory."""
    from tpu_superresolution_torch.kernels.window_attention import WG_SMEM_LIMIT, sq_plan

    p = sq_plan(n, hd)
    assert (p.ns, p.row_blocks, p.stages) == (n // 16, n // 128, stages)
    hdp = 16 if hd <= 16 else 32 if hd <= 32 else 64
    table = 128 * (n + 8) * 4
    assert p.smem == 1024 + 2 * 64 * hdp * 2 + 64 + table + stages * (128 + 2 * n) * hdp * 2
    assert p.smem <= WG_SMEM_LIMIT


@pytest.mark.parametrize("n,hd", [(256, 33), (256, 64), (64, 30), (192, 30), (128, 65)])
def test_sq_plan_refuses_what_it_does_not_take(n, hd):
    """Windows of other sizes, heads past 64 dims and N 256 past 32 dims
    (two stages of 80 KB do not fit beside its 135 KB table): no plan, and
    K16 takes the tiled or stream kernel there."""
    from tpu_superresolution_torch.kernels.window_attention import k15_route, sq_plan

    assert sq_plan(n, hd) is None
    assert k15_route(n, n, hd, True, True) == ("tiled" if hd <= 32 else "stream")


@pytest.mark.parametrize("bw,keys,n_mask,want", [(256, 3, 1, 44), (256, 96, 32, 1),
                                                (800, 3, 1, 44), (400, 6, 1, 22), (3, 2, 1, 3),
                                                (5, 64, 32, 1)])
def test_sq_ctas_per_key(bw, keys, n_mask, want):
    """One wave on a card of 132 SMs: at most SMs / keys CTAs a key, at
    least one, at most the windows of a mask plane."""
    from tpu_superresolution_torch.kernels.window_attention import sq_ctas_per_key

    assert sq_ctas_per_key(bw, keys, n_mask, 132) == want


def test_kernel_path_takes_dat_windows_to_the_square_kernel(k15_emulated):
    """K16's kernel path (the wrapper's CUDA-tensor code, each launch
    computed by the plain version) sends DAT's windows of 128 and 256
    tokens, masked or not, to the square kernel, counted as K16, with the
    plain version's output and gradient."""
    from tpu_superresolution_torch.kernels import window_attention as kw

    for case in ((4, 2, 128, 30, 2), (2, 1, 256, 30, 0), (2, 2, 128, 64, 0)):
        q, k, v, bias, mask = (None if a is None else torch.from_numpy(a)
                               for a in _inputs(*case, seed=1))
        q.requires_grad_()
        got = kw.batched_window_attention(q, k, v, bias, mask, 0.5)
        want = kw.batched_window_attention_plain(q, k, v, bias, mask, 0.5)
        assert torch.equal(got, want)
        got.sum().backward()
        assert q.grad is not None and torch.isfinite(q.grad).all()
    assert k15_emulated == ["square"] * 3 and kw.launches.count == 3
