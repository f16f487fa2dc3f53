"""The widths past the port's block, attention and CAB kernels, and the
host side of K15's and K11's Hopper kernels, against the JAX package,
fp32 on the CPU:

- ``fused_block.block_route`` sends every block outside the block
  kernel to the K7 route (once the "wide" route: C past 256, more than 8
  heads, hd 33-64, C past 512, hd past 64), and names the limit where it
  refuses (heads that do not divide C);
- a SwinIR and a HAT at those widths (C 264 in 6 heads, C 180 in 4 and 9
  heads; HAT at embed 264, whose CAB is past K12's C 256) against the
  JAX jnp path, with K7's and K15's kernel paths emulated: the wrappers'
  CUDA-tensor code (route, packing, autograd function) runs, each launch
  computed by the kernels' schedules in torch (K7,
  ``tests/test_torch_k7_wg.py``) or the plain version (K15) and counted;
- the CAB's route past K12 (K2 + K3 with the GELU + K3) against the JAX CAB
  reference, an OCAB at hd 44 against the JAX OCAB (module path, jnp and
  K15 in interpret mode), a DAT rect branch at hd 44 on the module chain
  against the JAX module chain;
- K15's plain version at hd 44 and 64 against the JAX
  ``window_attention_reference`` and the JAX kernel in interpret mode;
- K7's product launch (its qkv and proj) from its packed operands, and
  a wide block's training through K7's autograd function;
- ``k15_route`` by shape (each kernel where chip_smoke.py measured it
  fastest), ``wg_plan`` (the wgmma kernel's launch plan) and that
  kernel's schedule (CTAs walking (window, head) units head-major,
  64-row query tiles, 16-key slices, the padded bias table, the softmax
  in the log2 domain) written out in torch ops;
- ``dwconv_plan`` (K11's "rows" route: bands of rows, column segments,
  row buffers, a thread's fixed channels) and that route's schedule
  written out in torch ops.

Bound: 3e-5 max abs (forwards, fp32)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_k7_wg import k7_emulated, product_emulated  # noqa: F401 (a fixture)
from tests.test_torch_ocab import _jax_ocab
from tests.util_torchport import (
    TOL,
    jax_forward,
    perturbed_jax_swinir,
    port_forward,
    port_from_jax,
    small_swinir_config,
)

torch.set_num_threads(1)

LOG2E = 1.4426950408889634


@pytest.fixture
def k15_emulated(monkeypatch):
    """K15's and K16's kernel path on CPU tensors: the wrappers'
    CUDA-tensor code runs, each launch computed by the plain version,
    counted, and its route recorded."""
    from tpu_superresolution_torch.kernels import window_attention as kw

    routes = []

    def fake_launch(q, k, v, bias, mask, scale, counter, split_p, route=None):
        routes.append(route or kw.k15_route(q.shape[2], k.shape[2], q.shape[3],
                                            mask is not None, split_p))
        counter.count += 1
        return kw.fused_window_attention_plain(q, k, v, bias, mask, scale)

    monkeypatch.setattr(kw, "_launch", fake_launch)
    monkeypatch.setattr(kw, "_attention", lambda *a: kw._kernel_attention(*a))
    kw.launches.reset()
    kw.launches_rect.reset()
    return routes


# ------------------------------------------------------------ block route

_WIDE = [
    # (ws, C, heads): past K7's C 256, 8 heads or hd 32, or K1t's C 256
    (8, 264, 6),   # hd 44
    (7, 264, 6),
    (16, 264, 6),
    (8, 180, 4),   # hd 45
    (8, 180, 9),   # 9 heads of hd 20
    (8, 288, 9),   # C > 256 at hd 32
]


@pytest.mark.parametrize("ws,c,heads", _WIDE, ids=[f"ws{w}-C{c}-h{h}" for w, c, h in _WIDE])
def test_block_route_takes_wide_widths(ws, c, heads):
    """The K7 route where the block kernel refuses the block, at any
    hidden width (once the "wide" route; the others' routes are
    ``test_torch_window_attention.py``'s)."""
    from tpu_superresolution_torch.kernels.fused_block import block_route

    assert block_route(ws, c, heads, 2 * c) == "window_attention"


@pytest.mark.parametrize("c,heads,want", [(264, 4, "window_attention"), (180, 7, "do not divide"),
                                          (528, 12, "window_attention")],
                         ids=["264-4-hd <= 64", "180-7-do not divide", "528-12-C <= 512"])
def test_block_route_refuses_what_no_route_takes(c, heads, want):
    """Heads that do not divide C raise, with the limit in the message;
    heads of 66 dims and C 528 (which raised before K7 took any head dim
    and any C) route."""
    from tpu_superresolution_torch.kernels.fused_block import block_route

    if want == "window_attention":
        assert block_route(8, c, heads, 2 * c) == want
    else:
        with pytest.raises(ValueError, match=want):
            block_route(8, c, heads, 2 * c)


# ------------------------------------------------------------- the models

_SWINIR_WIDE = [(264, 6), (180, 4), (180, 9)]


@pytest.mark.parametrize("c,heads", _SWINIR_WIDE, ids=[f"C{c}-h{h}" for c, h in _SWINIR_WIDE])
def test_swinir_wide_matches_jax(c, heads, k15_emulated, k7_emulated, monkeypatch):
    """A SwinIR of one RSTB of two blocks (the second shifted) at a width
    past the old K7's, on a 16 x 16 input: every block takes the K7
    route, K7 runs once a block (its three kernels emulated from the
    packed operands, the mask dense), K15 never, and the output matches
    the JAX jnp path."""
    from tpu_superresolution_torch.kernels import window_attention as kw
    from tpu_superresolution_torch.kernels import fused_attention as fa
    from tpu_superresolution_torch.models.swinir import SwinBlock

    taken = []
    real = SwinBlock._window_attention_route
    monkeypatch.setattr(SwinBlock, "_window_attention_route",
                        lambda self, *a, **k: taken.append(self.shift_size)
                        or real(self, *a, **k))
    cfg = small_swinir_config(embed_dim=c, depths=(2,), num_heads=(heads,))
    model, variables = perturbed_jax_swinir(cfg, (16, 16))
    x = np.random.default_rng(c + heads).random((1, 16, 16, 3), dtype=np.float32)
    want = jax_forward(model, variables, x)
    got = port_forward(port_from_jax(cfg, variables), x)
    assert taken == [0, 4]
    assert kw.launches_rect.count == 0 and kw.launches.count == 0 and k15_emulated == []
    assert fa.launches.count == 2
    assert got.shape == want.shape == (1, 64, 64, 3)
    assert np.abs(got - want).max() <= TOL


def test_hat_wide_matches_jax(k15_emulated, k7_emulated, monkeypatch):
    """HAT at embed 264 in 6 heads (hd 44; one RHAG of two HABs and the
    OCAB, ws 7, conv_scale 0.3): the HABs take the K7 route (emulated),
    their CABs (C 264 > K12's 256) K2 + K3 with the GELU + K3, the OCAB
    K15 at hd 44; against the JAX jnp path."""
    from tpu_superresolution_torch.kernels import cab_conv
    from tpu_superresolution_torch.kernels import fused_attention as fa
    from tpu_superresolution_torch.kernels import window_attention as kw
    from tpu_superresolution_torch.models import hat

    from tests.test_torch_hat import small_hat_config

    calls = []
    for name in ("ln_cab_convs", "fused_ln_cab_convs"):
        real = getattr(hat, name)
        monkeypatch.setattr(hat, name, lambda *a, real=real, name=name, **k: calls.append(name)
                            or real(*a, **k))
    cfg = small_hat_config(embed_dim=264, depths=(2,), num_heads=(6,), squeeze_factor=30)
    model, variables = perturbed_jax_swinir(cfg, (14, 14))
    x = np.random.default_rng(5).random((1, 14, 14, 3), dtype=np.float32)
    want = jax_forward(model, variables, x)
    got = port_forward(port_from_jax(cfg, variables), x)
    assert cab_conv.cab_route(264, 88) == "convs"
    assert calls == ["ln_cab_convs", "ln_cab_convs"]
    assert kw.launches_rect.count == 1 and k15_emulated == ["wgmma"]  # the OCAB
    assert fa.launches.count == 2  # the HABs
    assert got.shape == want.shape == (1, 56, 56, 3)
    assert np.abs(got - want).max() <= TOL


# K12 takes C <= 256 and Cmid <= 128 (its y1 in one or two 64-channel chunks)
_CAB_ROUTES = [(96, 32, "K12"), (180, 60, "K12"), (256, 128, "K12"), (264, 88, "convs"),
               (240, 160, "convs"), (256, 64, "K12"), (144, 6, "K12")]


@pytest.mark.parametrize("c,cm,route", _CAB_ROUTES, ids=[f"C{c}-mid{m}" for c, m, _ in _CAB_ROUTES])
def test_cab_route_by_width(c, cm, route):
    from tpu_superresolution_torch.kernels.cab_conv import cab_route

    assert cab_route(c, cm) == route


@pytest.mark.parametrize("c,cm", [(264, 88), (240, 160), (256, 128)])
def test_cab_convs_route_matches_jax_reference(c, cm):
    """K2 + K3 with the GELU + K3 (``ln_cab_convs``, each wrapper's plain
    version on the CPU) against the JAX K12 reference and the port's K12
    plain version."""
    from tpu_superresolution_tpu.ops.pallas import cab_conv as jcc
    from tpu_superresolution_torch.kernels.cab_conv import fused_ln_cab_convs_plain, ln_cab_convs

    rng = np.random.default_rng(c)
    a = [rng.standard_normal((1, 7, 9, c)).astype(np.float32),
         (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
         (0.1 * rng.standard_normal(c)).astype(np.float32),
         (rng.standard_normal((3, 3, c, cm)) / np.sqrt(9 * c)).astype(np.float32),
         (0.1 * rng.standard_normal(cm)).astype(np.float32),
         (rng.standard_normal((3, 3, cm, c)) / np.sqrt(9 * cm)).astype(np.float32),
         (0.1 * rng.standard_normal(c)).astype(np.float32)]
    want = np.asarray(jcc._reference(*(jnp.asarray(t) for t in a)))
    args = [torch.from_numpy(t) for t in a]
    got = ln_cab_convs(*args).numpy()
    assert np.abs(got - want).max() <= TOL
    assert np.abs(got - fused_ln_cab_convs_plain(*args).numpy()).max() <= TOL


def test_conv_function_backward_with_gelu():
    """``ConvFunction.backward`` (what runs after K3 with the GELU in its
    epilogue on CUDA), fed a context as autograd would, returns the
    gradients of the plain conv + GELU."""
    import types

    from tpu_superresolution_torch.kernels.cab_conv import ConvFunction, conv_plain

    g = torch.Generator().manual_seed(9)
    x, k, b = torch.randn(1, 5, 6, 12, generator=g), torch.randn(3, 3, 12, 4, generator=g), \
        torch.randn(4, generator=g)
    pad = ((1, 1), (1, 1))
    ct = torch.randn(1, 5, 6, 4, generator=g)
    ctx = types.SimpleNamespace(saved_tensors=(x, k, b), pad=pad, gelu=True,
                                needs_input_grad=(True, True, False, False, False, False))
    got = ConvFunction.backward(ctx, ct)
    leaves = [t.clone().requires_grad_(n) for t, n in zip((x, k, b), (True, True, False))]
    conv_plain(*leaves, pad, gelu=True).backward(ct)
    assert got[2:] == (None,) * 4
    assert torch.allclose(got[0], leaves[0].grad) and torch.allclose(got[1], leaves[1].grad)
    y = conv_plain(x, k, b, pad, gelu=True)
    assert torch.allclose(y, F.gelu(conv_plain(x, k, b, pad)))


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_ocab_hd44_matches_jax(impl, k15_emulated):
    """An OCAB of C 88 in 2 heads (hd 44) at inference, K15's kernel path
    emulated (the wgmma route), against the JAX OCAB's module path with
    jnp attention or the JAX K15 in interpret mode."""
    from tpu_superresolution_torch.kernels import window_attention as kw

    jm, variables, tm, _ = _jax_ocab(impl, True, c=88, nh=2, ws=7, hw=(14, 21))
    x = np.random.default_rng(44).standard_normal((2, 14, 21, 88)).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert kw.launches_rect.count == 1 and k15_emulated == ["wgmma"]
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


def test_dat_branch_hd44_matches_jax(k15_emulated):
    """DAT at embed 88 in 2 heads (hd 44 a rect branch, past K9's 32):
    its spatial block on the module chain with K16's kernel path emulated
    (the stream route: P in two parts), against the JAX module chain."""
    from tpu_superresolution_torch.kernels import window_attention as kw

    from tests.test_torch_dat import perturbed_jax_dat, port_dat, small_dat_config

    cfg = small_dat_config(embed_dim=88, depths=(2,), num_heads=(2,))
    model, variables = perturbed_jax_dat(cfg, seed=44)
    x = np.random.default_rng(45).random((1, 16, 24, 3), dtype=np.float32)
    want = jax_forward(model, variables, x)
    port = port_dat(cfg, variables)
    assert port.routes()[0][0][0] == "chain"
    got = port_forward(port, x)
    assert kw.launches.count == 2 and k15_emulated == ["stream", "stream"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


# ---------------------------------------------------------- K15 plain, wide hd

_WIDE_ATTN = [(3, 2, 49, 100, 44, 0), (2, 2, 64, 144, 64, 0), (8, 2, 16, 16, 44, 4),
              (2, 1, 64, 64, 45, 2)]


def _attn_inputs(bw, nh, nq, nk, hd, n_mask, seed=0):
    rng = np.random.default_rng(seed + nq + nk + hd)
    q = rng.standard_normal((bw, nh, nq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((bw, nh, nk, hd)).astype(np.float32) for _ in range(2))
    bias = (0.5 * rng.standard_normal((nh, nq, nk))).astype(np.float32)
    mask = None
    if n_mask:
        ids = rng.integers(0, 3, size=(n_mask, max(nq, nk)))
        mask = np.where(ids[:, :nq, None] != ids[:, None, :nk], -100.0, 0.0).astype(np.float32)
    return q, k, v, bias, mask


@pytest.mark.parametrize("case", _WIDE_ATTN, ids=[f"{c[2]}x{c[3]}-hd{c[4]}-m{c[5]}"
                                                  for c in _WIDE_ATTN])
def test_plain_at_wide_heads_matches_jax(case, k15_emulated):
    """fused_window_attention_plain at hd 44, 45 and 64 against the JAX
    window_attention_reference and the JAX fused_window_attention in
    interpret mode; the wrapper's kernel path (emulated) takes the shape
    on the wgmma route unmasked, on the stream route masked."""
    from tpu_superresolution_tpu.ops.pallas.window_attention import (
        fused_window_attention,
        window_attention_reference,
    )
    from tpu_superresolution_torch.kernels import window_attention as kw
    from tpu_superresolution_torch.kernels.window_attention import fused_window_attention_plain

    bw, nh, nq, nk, hd, n_mask = case
    q, k, v, bias, mask = _attn_inputs(*case)
    scale = hd ** -0.5
    jargs = [jnp.asarray(a) for a in (q, k, v, bias)] + [
        None if mask is None else jnp.asarray(mask)]
    got = fused_window_attention_plain(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                                       None if mask is None else torch.from_numpy(mask),
                                       scale).numpy()
    assert np.abs(got - np.asarray(window_attention_reference(*jargs, scale))).max() <= TOL
    want = fused_window_attention(*jargs, scale=scale, interpret=True)
    assert np.abs(got - np.asarray(want)).max() <= TOL
    through = kw.fused_window_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                                        None if mask is None else torch.from_numpy(mask), scale)
    assert k15_emulated == ["stream" if n_mask else "wgmma"]
    assert np.abs(through.numpy() - np.asarray(want)).max() <= TOL


# --------------------------------------------------------------- K15 route

_K15_ROUTES = [
    # (Nq, Nk, hd, masked, split P, route)
    (49, 100, 16, False, False, "wgmma"),   # HAT's OCAB
    (64, 144, 16, False, False, "wgmma"),   # hat_fast's
    (256, 576, 30, False, False, "tiled"),  # HAT-SRx4's
    (64, 64, 30, True, False, "stream"),    # masked square windows
    (128, 128, 30, True, True, "square"),   # K16: DAT's windows
    (49, 100, 44, False, False, "wgmma"),   # past the tiled kernel's hd 32
    (256, 576, 44, False, False, "stream"),  # past the wgmma kernel's 256 keys
    (128, 128, 44, True, True, "square"),   # K16 past hd 32: heads padded to 64
    (64, 64, 64, True, False, "stream"),
]


@pytest.mark.parametrize("nq,nk,hd,masked,split,route", _K15_ROUTES,
                         ids=[f"{a}x{b}-hd{c}-{'m' if d else 'u'}{'-split' if e else ''}"
                              for a, b, c, d, e, _ in _K15_ROUTES])
def test_k15_route_by_shape(nq, nk, hd, masked, split, route):
    from tpu_superresolution_torch.kernels.window_attention import k15_route

    assert k15_route(nq, nk, hd, masked, split) == route


@pytest.mark.parametrize("nq,nk,hd", [(49, 100, 65), (1024, 1024, 64)],
                         ids=["49-100-65-hd <= 64", "1024-1024-64-holds at most"])
def test_k15_route_refuses_with_the_limit(nq, nk, hd, k15_emulated):
    """Heads past 64 dims, and a (window, head) whose q, k and v do not
    fit the wgmma kernel's one-stage units (the shapes that raised before
    the stream kernel), take the "stream" route, on the kernel path too,
    and match the JAX reference."""
    from tpu_superresolution_tpu.ops.pallas.window_attention import window_attention_reference
    from tpu_superresolution_torch.kernels import window_attention as kw

    assert kw.k15_route(nq, nk, hd) == "stream"
    q, k, v, bias, _ = _attn_inputs(1, 1, nq, nk, hd, 0, seed=7)
    got = kw._kernel_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)), None,
                               hd ** -0.5, kw.launches_rect, False, "fused_window_attention")
    assert k15_emulated == ["stream"] and kw.launches_rect.count == 1
    want = window_attention_reference(*(jnp.asarray(a) for a in (q, k, v, bias)), None,
                                      hd ** -0.5)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


@pytest.mark.parametrize("bw,nh,sms", [(2500, 6, 132), (10, 6, 132), (7, 9, 132), (1, 1, 132),
                                       (300, 200, 132)])
def test_wg_ctas_cover_every_unit_once(bw, nh, sms):
    """The wgmma kernel's grid (nH x G CTAs, CTA (h, g) taking windows g,
    g + G, ...): every (window, head) unit exactly once, at most one CTA
    an SM where the heads allow."""
    from tpu_superresolution_torch.kernels.window_attention import wg_ctas_per_head

    g = wg_ctas_per_head(bw, nh, sms)
    units = [(w, h) for cta in range(nh * g) for h in [cta // g]
             for w in range(cta % g, bw, g)]
    assert sorted(units) == [(w, h) for w in range(bw) for h in range(nh)]
    assert nh * g <= max(sms, nh)


def _wg_emulated(q, k, v, bias, scale, per_head):
    """csrc/window_attn_wg.cu's schedule in fp32 torch ops: CTAs walk
    (window, head) units head-major; q, k, v padded to the head's padded
    dims and to 64 query rows and the plan's 16 NS keys (slices past the
    keys read the zero tile); 64-row query tiles; the bias times log2 e
    from the padded table (-inf past Nk, 0 past Nq) and the softmax over
    the unit's keys in the log2 domain."""
    from tpu_superresolution_torch.kernels.window_attention import wg_plan

    bw, nh, nq, hd = q.shape
    nk = k.shape[2]
    kc = 16 * wg_plan(nq, nk, hd, False, False).slices
    hdp = 16 if hd <= 16 else 32 if hd <= 32 else 64
    nqp = -(-nq // 64) * 64
    out = torch.full_like(q, float("nan"))
    for cta in range(nh * per_head):
        h, g = divmod(cta, per_head)
        table = torch.full((nqp, kc), float("-inf"))
        table[:, :nk] = 0.0
        table[:nq, :nk] = bias[h] * LOG2E
        for w in range(g, bw, per_head):
            qp = F.pad(q[w, h], (0, hdp - hd, 0, nqp - nq))
            kp = F.pad(k[w, h], (0, hdp - hd, 0, kc - nk))  # pad slices: the zero tile
            vp = F.pad(v[w, h], (0, hdp - hd, 0, kc - nk))
            for q0 in range(0, nqp, 64):
                s = qp[q0:q0 + 64] @ kp.T * (scale * LOG2E) + table[q0:q0 + 64]
                p = torch.exp2(s - s.max(1).values[:, None])
                o = p @ vp / p.sum(1)[:, None]
                rows = min(64, nq - q0)
                out[w, h, q0:q0 + rows] = o[:rows, :hd]
    return out


_EMULATED = [(5, 2, 49, 100, 16, 0), (3, 2, 64, 144, 16, 0), (2, 2, 16, 36, 5, 0),
             (4, 1, 100, 60, 44, 0), (2, 1, 70, 200, 30, 0)]


@pytest.mark.parametrize("case", _EMULATED, ids=[f"{c[2]}x{c[3]}-hd{c[4]}-m{c[5]}"
                                                 for c in _EMULATED])
def test_wg_schedule_emulated_matches_plain(case):
    """The wgmma kernel's schedule written out in torch (its CTA walk on
    a card of 4 SMs, padding, the padded bias table and a log2-domain
    softmax over the unit's keys) reproduces the plain version at fp32:
    HAT's 49 x 100, hat_fast's 64 x 144, odd head dims, slices past the
    keys (the zero tile), and several query tiles."""
    from tpu_superresolution_torch.kernels.window_attention import fused_window_attention_plain

    q, k, v, bias, mask = (None if a is None else torch.from_numpy(a)
                           for a in _attn_inputs(*case, seed=3))
    from tpu_superresolution_torch.kernels.window_attention import wg_ctas_per_head

    scale = case[4] ** -0.5
    assert mask is None
    got = _wg_emulated(q, k, v, bias, scale, wg_ctas_per_head(case[0], case[1], 4))
    want = fused_window_attention_plain(q, k, v, bias, None, scale)
    assert not torch.isnan(got).any()
    assert (got - want).abs().max().item() <= TOL


def test_kernel_path_wide_heads_emulated(k15_emulated):
    """The kernel path's autograd function at hd 44 (K15, the wgmma
    route) and hd 64 with the mask (K16, the stream route): routes,
    launches, and the plain version's output and gradients."""
    from tpu_superresolution_torch.kernels import window_attention as kw

    for fn, case, counter in ((kw.fused_window_attention, (3, 2, 49, 100, 44, 0),
                               kw.launches_rect),
                              (kw.batched_window_attention, (4, 2, 32, 32, 64, 2),
                               kw.launches)):
        q, k, v, bias, mask = (None if a is None else torch.from_numpy(a)
                               for a in _attn_inputs(*case))
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        got = fn(*leaves, mask, 0.125)
        want = kw.fused_window_attention_plain(q, k, v, bias, mask, 0.125)
        assert counter.count == 1
        assert (got - want).abs().max().item() <= TOL
        got.sum().backward()
        ref = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        kw.fused_window_attention_plain(*ref, mask, 0.125).sum().backward()
        for a, b in zip(leaves, ref):
            assert torch.allclose(a.grad, b.grad, atol=1e-5)
    assert k15_emulated == ["wgmma", "stream"]


_PRODUCTS = [(264, 792), (264, 264), (180, 540), (45, 7), (512, 1536)]


@pytest.mark.parametrize("c_in,c_out", _PRODUCTS, ids=[f"{a}-{b}" for a, b in _PRODUCTS])
def test_window_product_packing_emulated(c_in, c_out):
    """K7's product launch, emulated from its packed operands (128-row x
    N tiles, 64-column chunks, the swizzled tiles read back, the bias
    padded, C_out columns stored), gives ``window_product_plain`` at fp32
    for bf16-representable weights; the packed shapes are what the C
    entry checks."""
    from tpu_superresolution_torch.kernels.fused_attention import (
        PRODUCT_BK,
        pack_window_product,
        window_product_plain,
    )

    g = torch.Generator().manual_seed(c_in + c_out)
    x = torch.randn(37, c_in, generator=g)
    w = (torch.randn(c_out, c_in, generator=g) * c_in ** -0.5).bfloat16().float()
    b = 0.1 * torch.randn(c_out, generator=g)
    packed = pack_window_product(w, b)
    plan = packed.plan
    assert tuple(packed.wp.shape) == (plan.n_tiles, -(-c_in // PRODUCT_BK), plan.n_tile,
                                      PRODUCT_BK)
    assert packed.wp.dtype == torch.bfloat16 and tuple(packed.b.shape) == (
        plan.n_tiles * plan.n_tile,)
    got = product_emulated(x, packed)
    assert (got - window_product_plain(x, w, b)).abs().max().item() <= TOL
    assert (product_emulated(x, pack_window_product(w, None))
            - window_product_plain(x, w, None)).abs().max().item() <= TOL


def test_window_product_refuses_past_its_width():
    """C 520, past the old product's 512 (its x tile held the whole K in
    shared memory), packs and computes the plain product: C streams in
    64-column chunks."""
    from tpu_superresolution_torch.kernels.fused_attention import (
        pack_window_product,
        window_product_plain,
    )

    g = torch.Generator().manual_seed(520)
    x = torch.randn(9, 520, generator=g)
    w = (torch.randn(8, 520, generator=g) * 520 ** -0.5).bfloat16().float()
    packed = pack_window_product(w, None)
    assert packed.wp.shape[1] == 9
    got = product_emulated(x, packed)
    assert (got - window_product_plain(x, w, None)).abs().max().item() <= TOL


def test_wide_route_trains_through_the_product_function(k15_emulated, k7_emulated):
    """A block at C 264 in 6 heads (once the "wide" route) in training:
    its K7 call goes through ``WindowAttentionFunction`` (forward the
    emulated kernels, backward autograd of the plain version), so that
    the gradients of every weight match the plain block's."""
    from tpu_superresolution_torch.kernels import fused_attention as fa
    from tpu_superresolution_torch.models.swinir import SwinBlock

    torch.manual_seed(3)
    blk = SwinBlock(dim=264, num_heads=6, window_size=8, shift_size=4, mlp_ratio=2.0)
    x = torch.randn(1, 16, 16, 264)
    blk(x).square().sum().backward()
    got = {n: p.grad.clone() for n, p in blk.named_parameters()}
    blk.zero_grad()
    blk(x, plain=True).square().sum().backward()
    assert fa.launches.count == 1 and k15_emulated == []
    for n, p in blk.named_parameters():
        assert torch.allclose(got[n], p.grad, atol=1e-4, rtol=1e-4), n


_PLANS_WG = [
    # (Nq, Nk, hd, masked, split P): slices, or None where the kernel does not take it
    ((49, 100, 16, False, False), 7),      # HAT's OCAB
    ((64, 144, 16, False, False), 9),      # hat_fast's
    ((49, 100, 44, False, False), 7),
    ((64, 64, 45, True, False), None),     # masked square, odd hd: the stream kernel
    ((49, 49, 44, True, False), None),     # HAT's HAB at ws 7, hd 44
    ((128, 128, 64, True, True), None),    # K16
    ((256, 576, 44, False, False), None),  # past 256 keys
]


@pytest.mark.parametrize("shape,want", _PLANS_WG,
                         ids=[f"{a}x{b}-hd{c}-{'m' if d else 'u'}{'-split' if e else ''}"
                              for (a, b, c, d, e), _ in _PLANS_WG])
def test_wg_plan_is_what_the_entry_accepts(shape, want):
    """``wg_plan`` (the one place the wgmma kernel's launch is decided):
    the fewest compiled slices that hold the keys, an even number of
    stages (two consumers, each reusing its own) and shared memory within
    the limit, as the C entry checks; None (and so another route) for a
    mask, split P or more than 256 keys."""
    from tpu_superresolution_torch.kernels import window_attention as kw

    nq, nk, hd, masked, split = shape
    plan = kw.wg_plan(*shape)
    if want is None:
        assert plan is None and kw.k15_route(*shape) != "wgmma"
        return
    assert plan.slices == want and plan.slices in kw.WG_SLICES and 16 * plan.slices >= nk
    assert 2 <= plan.stages <= kw.WG_MAX_STAGES and plan.stages % 2 == 0
    table = -(-nq // 64) * 64 * (16 * plan.slices + 8) * 4
    assert plan.smem == (kw.wg_fixed_bytes(hd) + table
                         + plan.stages * kw.wg_stage_bytes(nq, nk, hd)) <= kw.WG_SMEM_LIMIT


# ------------------------------------------------------------------- K11

_PLANS = [
    # (shape, route on 132 SMs)
    ((25, 64, 64, 360), "rows"),    # the published DAT x4's sg_conv: bands of 13
    ((25, 64, 64, 180), "rows"),    # its conv branch
    ((1, 2000, 2000, 180), "rows"),  # column segments (a row is past a quarter of the memory)
    ((8, 64, 64, 180), "tiles"),    # the DAT train step: bands of 4
    ((1, 256, 256, 180), "tiles"),
    ((2, 20, 24, 45), "tiles"),
    ((1, 13, 15, 7), "tiles"),      # W * C % 8 != 0
]


@pytest.mark.parametrize("shape,route", _PLANS, ids=["x".join(map(str, s)) for s, _ in _PLANS])
def test_dwconv_plan_invariants(shape, route):
    """K11's launch plan from the shapes: "rows" where an image row is
    whole 16-byte pieces and a band (one CTA an SM) holds at least
    ROWS_MIN_BAND rows, with a thread count whose 8-element vectors keep
    fixed channels, at least four row buffers that hold a segment and
    its one-pixel halo, segments on 16-byte boundaries and two-row steps;
    "tiles" otherwise."""
    from tpu_superresolution_torch.kernels import dwconv as kd

    b, h, w, c = shape
    plan = kd.dwconv_plan(b, h, w, c, 132)
    assert plan.route == route
    if route == "tiles":
        return
    assert plan.rows >= kd.ROWS_MIN_BAND and plan.step == 2
    assert plan.threads <= kd.ROWS_MAX_THREADS and (8 * plan.threads) % c == 0
    assert 4 <= plan.slots <= kd.ROWS_MAX_SLOTS
    assert plan.slots * plan.slot_elems * 2 <= kd.ROWS_SMEM and plan.slot_elems % 64 == 0
    assert (plan.seg + 2) * c + 14 <= plan.slot_elems and (plan.seg * c) % 8 == 0
    assert plan.grid == b * -(-h // plan.rows) * -(-w // plan.seg) <= 2 * 132


def _rows_emulated(x, taps, bias, plan):
    """csrc/dwconv.cu's "rows" schedule in fp32 torch ops: per CTA (image,
    band, segment) each input row's buffered range [ls, le) of the
    flattened W * C row, the band's output rows in steps of one or two,
    the 8-element vectors of thread t (t, t + NT, ...) with their fixed
    channels, neighbours at +-C, zero outside the row and the image."""
    bsz, h, w, c = x.shape
    wc = w * c
    flat = x.reshape(bsz, h, wc)
    out = torch.full_like(flat, float("nan"))
    k9 = taps.reshape(9, c)
    for img in range(bsz):
        for r0 in range(0, h, plan.rows):
            for x0 in range(0, w, plan.seg):
                e0, e1 = x0 * c, min(w, x0 + plan.seg) * c
                ls, le = max(0, e0 - c) // 8 * 8, min(wc, (e1 + c + 7) // 8 * 8)
                assert le - ls <= plan.slot_elems
                e = torch.arange(e0, e1)
                t = ((e - e0) // 8) % plan.threads
                ch = (8 * t + (e - e0) % 8) % c
                assert torch.equal(ch, e % c)  # a thread's taps stay in its registers
                rows = list(range(r0, min(h, r0 + plan.rows)))
                steps = [rows[i:i + plan.step] for i in range(0, len(rows), plan.step)]
                assert sum(steps, []) == rows  # each output row in one step
                for r in rows:
                    acc = bias[ch].clone()
                    for dy in range(3):
                        y = r + dy - 1
                        if not 0 <= y < h:
                            continue
                        for dx in range(3):
                            src = e + (dx - 1) * c
                            ok = (src >= 0) & (src < wc)
                            assert bool(((src >= ls) & (src < le))[ok].all())
                            val = torch.where(ok, flat[img, y, src.clamp(0, wc - 1)], 0.0)
                            acc = acc + val * k9[3 * dy + dx, ch]
                    out[img, r, e0:e1] = acc
    return out.reshape(x.shape)


@pytest.mark.parametrize("shape,smem", [((2, 9, 8, 180), None), ((1, 10, 24, 45), 4096),
                                        ((2, 9, 12, 64), 2048), ((1, 11, 9, 24), None)],
                         ids=["C180", "C45-segments", "C64-segments", "C24"])
def test_dwconv_rows_schedule_emulated_matches_plain(shape, smem, monkeypatch):
    """The "rows" route's schedule written out in torch reproduces K11's
    plain version at fp32: vectors that straddle pixels (C 180, 45), odd
    C, bands of 9-22 rows in two-row steps (one SM), and column segments
    (shared memory narrowed so that a row does not fit)."""
    from tpu_superresolution_torch.kernels import dwconv as kd

    if smem is not None:
        monkeypatch.setattr(kd, "ROWS_SMEM", smem)
    kd.dwconv_plan.cache_clear()
    b, h, w, c = shape
    plan = kd.dwconv_plan(b, h, w, c, 1)
    kd.dwconv_plan.cache_clear()
    assert plan.route == "rows" and plan.rows >= kd.ROWS_MIN_BAND
    assert (plan.seg < w) == (smem is not None)
    g = torch.Generator().manual_seed(c)
    x = torch.randn(*shape, generator=g)
    taps, bias = torch.randn(3, 3, c, generator=g) / 3, 0.1 * torch.randn(c, generator=g)
    got = _rows_emulated(x, taps, bias, plan)
    want = kd.dwconv3x3_plain(x, taps, bias)
    assert not torch.isnan(got).any()
    assert (got - want).abs().max().item() <= TOL
    assert math.isfinite(float(got.sum()))
