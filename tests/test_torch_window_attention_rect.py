"""K15 (the rectangular window attention) and HAT's OCAB on it, in the
PyTorch port against the JAX package, fp32 on the CPU, where the port's
wrappers run their plain versions:

- ``fused_window_attention`` against the JAX ``fused_window_attention``
  in interpret mode (its window packing, token and window-count padding
  included), at HAT's OCAB shapes (ws 7 / ows 10, ws 4 / ows 6, ws 16 /
  ows 24: Nq queries against Nk keys) and at a square masked case whose
  mask count divides the window count;
- its gradient through ``BatchedWindowAttentionFunction`` (the CUDA path's
  autograd function, with the launch replaced by the plain version)
  against ``jax.vjp`` of ``window_attention_reference``;
- the port's OCAB in eval mode against the JAX OCAB's module path with
  ``attn_impl="pallas"`` (K15 in interpret mode) and ``"jnp"`` at ws 7,
  8 and 16;
- the OCAB's route by shape: K8's fused route in training where
  ``fused_ocab.ocab_ok`` holds, K15's module path everywhere else.

Bounds: forwards 3e-5 max abs; gradients atol 2e-4 / rtol 1e-3 (the JAX
package's own kernel-vs-vjp bound, as for K5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_ocab import _jax_ocab
from tests.util_torchport import TOL

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3

# (id, windows, heads, Nq, Nk, hd, mask count)
_CASES = [("ws7-ows10", 2, 2, 49, 100, 16, 0), ("ws4-ows6", 2, 2, 16, 36, 5, 0),
          ("ws16-ows24", 2, 2, 256, 576, 30, 0), ("square-masked", 8, 2, 16, 16, 8, 4)]


def _inputs(bw, nh, nq, nk, hd, n_mask):
    """q, k, v, bias, mask (a 0 / -100 region mask, or None) and a
    cotangent, from a numpy generator."""
    rng = np.random.default_rng(nq + nk + n_mask)
    q = rng.standard_normal((bw, nh, nq, hd)).astype(np.float32)
    k, v = (rng.standard_normal((bw, nh, nk, hd)).astype(np.float32) for _ in range(2))
    bias = (0.5 * rng.standard_normal((nh, nq, nk))).astype(np.float32)
    mask = None
    if n_mask:
        ids = rng.integers(0, 3, size=(n_mask, nq))
        mask = np.where(ids[:, :, None] != ids[:, None, :nk], -100.0, 0.0).astype(np.float32)
    ct = rng.standard_normal((bw, nh, nq, hd)).astype(np.float32)
    return q, k, v, bias, mask, ct


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_fused_window_attention_plain_matches_jax_kernel(case):
    """fused_window_attention on CPU tensors (its plain version) against
    the JAX fused_window_attention in interpret mode; no kernel is
    launched."""
    from tpu_superresolution_tpu.ops.pallas.window_attention import fused_window_attention
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels import window_attention as kw

    _, bw, nh, nq, nk, hd, n_mask = case
    q, k, v, bias, mask, _ = _inputs(bw, nh, nq, nk, hd, n_mask)
    scale = hd ** -0.5
    want = fused_window_attention(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                  None if mask is None else jnp.asarray(mask), scale=scale,
                                  interpret=True)
    reset_counters()
    got = kw.fused_window_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                                    None if mask is None else torch.from_numpy(mask), scale)
    assert got.shape == (bw, nh, nq, hd)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
    assert not any(read_counters().values())


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_fused_window_attention_gradient_matches_jax_vjp(case, monkeypatch):
    """The gradient on q, k, v and the bias through K15's autograd
    function (its forward's launch replaced by the plain version, as the
    CPU has no kernel; its backward autograd of the plain version)
    against jax.vjp of the JAX window_attention_reference.  The launch is
    counted on K15's counter."""
    from tpu_superresolution_tpu.ops.pallas.window_attention import window_attention_reference
    from tpu_superresolution_torch.kernels import window_attention as kw

    _, bw, nh, nq, nk, hd, n_mask = case
    q, k, v, bias, mask, ct = _inputs(bw, nh, nq, nk, hd, n_mask)
    scale = hd ** -0.5
    f = lambda q, k, v, bias: window_attention_reference(
        q, k, v, bias, None if mask is None else jnp.asarray(mask), scale)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v, bias)))
    jgrads = vjp(jnp.asarray(ct))

    def fake_launch(q, k, v, bias, mask, scale, counter, split_p):
        assert split_p == kw.K15_SPLIT_P
        counter.count += 1
        return kw.fused_window_attention_plain(q, k, v, bias, mask, scale)

    monkeypatch.setattr(kw, "_launch", fake_launch)
    kw.launches_rect.reset()
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    tmask = None if mask is None else torch.from_numpy(mask)
    got = kw.BatchedWindowAttentionFunction.apply(*leaves, tmask, scale, kw.launches_rect,
                                                  kw.K15_SPLIT_P)
    assert kw.launches_rect.count == 1
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= TOL
    got.backward(torch.from_numpy(ct))
    for name, leaf, w in zip(("dq", "dk", "dv", "dbias"), leaves, jgrads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def _spy(monkeypatch):
    """Record the OCAB's route: K8's plain core ("k8") and K15's plain
    version ("k15"), each reached through its kernel's wrapper."""
    from tpu_superresolution_torch.kernels import fused_ocab
    from tpu_superresolution_torch.kernels import window_attention as kw

    calls = []
    for mod, name, tag in ((fused_ocab, "ocab_core_plain", "k8"),
                           (kw, "fused_window_attention_plain", "k15")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, tag=tag: calls.append(tag)
                            or real(*a))
    return calls


_OCAB_CASES = [(impl, ws) for ws in (7, 8, 16) for impl in ("pallas", "jnp")]


@pytest.mark.parametrize("impl,ws", _OCAB_CASES, ids=[f"{i}-ws{w}" for i, w in _OCAB_CASES])
def test_ocab_eval_matches_jax(impl, ws, monkeypatch):
    """The port's OCAB at inference (at ws 7 and 8 K2 LN1, qkv, partition
    and overlap gather, K15, proj, K2 LN2, MLP; at ws 16 the fused route,
    K8w16's plain core on the CPU) against the JAX OCAB's module path,
    whose attention is the JAX K15 in interpret mode ("pallas") or jnp
    einsums ("jnp"), on maps of 2 x 3, 2 x 3 and 2 x 1 windows with
    zero-padded overlap windows at the border."""
    jm, variables, tm, _ = _jax_ocab(impl, True, ws=ws, hw=(2 * ws, 3 * ws if ws < 16 else ws))
    x = np.random.default_rng(ws).standard_normal((2, 2 * ws, 3 * ws if ws < 16 else ws, 24))
    x = x.astype(np.float32)
    want = jm.apply(variables, jnp.asarray(x))
    calls = _spy(monkeypatch)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert calls == ["k8" if ws == 16 else "k15"]
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL


_ROUTE_CASES = [
    # (ws, C, heads, mlp_ratio, training, route)
    (7, 24, 2, 2.0, True, "k8"),     # HAT's ws 7 within K8's widths
    (8, 24, 2, 2.0, True, "k8"),     # hat_fast's ws 8
    (7, 96, 6, 4.0, True, "k8"),     # HATConfig(): hidden 384, K8's largest
    (16, 24, 2, 2.0, True, "k8"),    # upstream HAT-SRx4's window
    (7, 240, 8, 2.0, True, "k15"),   # C > 192 (8 heads)
    (7, 120, 6, 4.0, True, "k8"),    # hidden 480: any hidden
    (7, 132, 2, 2.0, True, "k15"),   # hd 66 > 32
    (7, 24, 2, 2.0, False, "k15"),   # inference: the module path at ws 7 and 8,
    (16, 24, 2, 2.0, False, "k8"),   # the fused route at ws 16 (K8w16 serves it)
]


@pytest.mark.parametrize("ws,c,nh,mlp,training,route", _ROUTE_CASES,
                         ids=[f"ws{w}-C{c}-h{h}-mlp{m:g}-{'train' if t else 'eval'}"
                              for w, c, h, m, t, _ in _ROUTE_CASES])
def test_ocab_route_by_shape(ws, c, nh, mlp, training, route, monkeypatch):
    """The OCAB takes K8's fused route in training exactly where
    fused_ocab.ocab_ok holds (ws 7 / ows 10, ws 8 / ows 12 or ws 16 / ows 24, C <= 192,
    hd <= 32, <= 6 heads, any hidden), at inference where it holds at
    ws 16 (models.hat.OCAB.takes_fused), and K15's module path
    everywhere else; the route is decided from shapes, the same on the
    CPU as on CUDA."""
    from tpu_superresolution_torch.kernels.fused_ocab import ocab_ok
    from tpu_superresolution_torch.models.hat import OCAB

    ocab = OCAB(c, ws, 0.5, nh, True, mlp, True).train(training)
    ows = ws + ws // 2
    assert ocab.takes_k8() == ocab_ok(ws, ows, c, nh, int(c * mlp))
    assert (route == "k8") == ocab.takes_fused() == (
        ocab.takes_k8() and (training or ws == 16))
    calls = _spy(monkeypatch)
    y = ocab(torch.rand(1, 2 * ws, ws, c, generator=torch.Generator().manual_seed(0)))
    assert calls == [route]
    assert y.shape == (1, 2 * ws, ws, c) and bool(torch.isfinite(y).all())


def test_fused_window_attention_refuses_other_devices():
    """A tensor on a device with neither a kernel nor a plain version is
    refused by K15's wrapper, not run some other way."""
    from tpu_superresolution_torch.kernels.window_attention import fused_window_attention

    m = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        fused_window_attention(m(2, 1, 49, 16), m(2, 1, 100, 16), m(2, 1, 100, 16),
                               m(1, 49, 100))
