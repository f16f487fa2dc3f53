"""K8, HAT's fused OCAB core, in the PyTorch port against the JAX
package, fp32 on the CPU: the plain forward and backward (what the
wrappers run on CPU tensors) against ``fused_ocab_core`` in interpret
mode (its Pallas forward and backward, driven as the JAX OCAB drives it:
tokens padded to multiples of 8, pad keys at -1e9) and against
``_reference_core`` and its vjp; the port's OCAB training route against
the JAX ``OCAB`` called non-deterministically, through its fused route
(K8 in interpret mode) and its module path; the wrapper's argument
checks.  Bounds: forwards 3e-5 max abs; gradients atol 2e-4 / rtol 1e-3
(the JAX package's own kernel-vs-vjp bound, as for K5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import TOL, _random_param

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
# JAX argument order of fused_ocab_core's weights ([in, out] dense kernels)
_W_ORDER = ("wproj", "bproj", "g2", "b2", "wfc1", "bfc1", "wfc2", "bfc2")
_LINEAR = ("wproj", "wfc1", "wfc2")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(seed, ws=7, c=24, nh=2, hidden=48, bw=8):
    """q (pre-scaled), k, v, sw, the JAX-layout weights and the gathered
    bias of `bw` windows."""
    rng = np.random.default_rng(seed)
    ows = ws + ws // 2
    nq, nk, hd = ws * ws, ows * ows, c // nh
    n = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    acts = dict(q=n(bw, nq, c, sc=hd ** -0.5), k=n(bw, nk, c), v=n(bw, nk, c), sw=n(bw, nq, c))
    w = dict(wproj=n(c, c, sc=c ** -0.5), bproj=n(c, sc=0.1), g2=1 + n(c, sc=0.1),
             b2=n(c, sc=0.1), wfc1=n(c, hidden, sc=c ** -0.5), bfc1=n(hidden, sc=0.1),
             wfc2=n(hidden, c, sc=hidden ** -0.5), bfc2=n(c, sc=0.1))
    return acts, w, n(nh, nq, nk, sc=0.5), nh


def _port_weights(w, nh):
    from tpu_superresolution_torch.kernels.fused_ocab import OcabWeights

    return OcabWeights(num_heads=nh, **{k: _t(v.T if k in _LINEAR else v) for k, v in w.items()})


def _jax_core(kernel, nh, gelu_approx):
    """(q, k, v, sw, 8 weights, bias) -> the JAX core on the real tokens,
    padded as models/hat.py OCAB._fused pads (tokens to multiples of 8,
    -1e9 on the pad bias entries)."""
    from tpu_superresolution_tpu.ops.pallas import fused_ocab

    def f(q, k, v, sw, *args):
        *weights, bias = args
        nq, nk, c = q.shape[1], k.shape[1], q.shape[2]
        nqp, nkp = nq + (-nq) % 8, nk + (-nk) % 8
        pad = lambda a, n: jnp.pad(a, ((0, 0), (0, n - a.shape[1]), (0, 0)))
        bias_p = jnp.pad(bias, ((0, 0), (0, nqp - nq), (0, nkp - nk)), constant_values=-1e9)
        ins = (pad(q, nqp), pad(k, nkp), pad(v, nkp), pad(sw, nqp), *weights, bias_p)
        if kernel:
            out = fused_ocab.fused_ocab_core(*ins, nh, c // nh, gelu_approx=gelu_approx,
                                             interpret=True, group=8)
        else:
            out = fused_ocab._reference_core(*ins, nh, c // nh, c // nh, gelu_approx)
        return out[:, :nq]

    return f


_CASES = [(True, 7, True), (True, 7, False), (False, 7, True), (True, 8, True)]
_IDS = [f"{'kernel' if k else 'reference'}-ws{ws}-{'tanh' if g else 'erf'}"
        for k, ws, g in _CASES]


@pytest.mark.parametrize("kernel,ws,gelu_approx", _CASES, ids=_IDS)
def test_ocab_core_plain_matches_jax(kernel, ws, gelu_approx):
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels.fused_ocab import fused_ocab_core

    acts, w, bias, nh = _case(10 + ws + 2 * gelu_approx, ws=ws)
    args = [jnp.asarray(acts[k]) for k in ("q", "k", "v", "sw")] + [
        jnp.asarray(w[k]) for k in _W_ORDER] + [jnp.asarray(bias)]
    want = np.asarray(_jax_core(kernel, nh, gelu_approx)(*args))
    reset_counters()
    got = fused_ocab_core(*(_t(acts[k]) for k in ("q", "k", "v", "sw")), _port_weights(w, nh),
                          _t(bias), gelu_approx).numpy()
    assert not any(read_counters().values())  # CPU tensors: the plain version ran
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("kernel,ws,gelu_approx", _CASES, ids=_IDS)
def test_ocab_core_backward_matches_jax_vjp(kernel, ws, gelu_approx):
    """ocab_core_bwd_plain: dq, dk, dv, d sw, every weight gradient and
    the bias gradient against jax.vjp of the JAX core (its Pallas
    backward in interpret mode, or its jnp reference)."""
    from tpu_superresolution_torch.kernels.fused_ocab import fused_ocab_core_backward

    acts, w, bias, nh = _case(20 + ws + 2 * gelu_approx, ws=ws)
    ct = np.random.default_rng(1).standard_normal(acts["sw"].shape).astype(np.float32)
    args = [jnp.asarray(acts[k]) for k in ("q", "k", "v", "sw")] + [
        jnp.asarray(w[k]) for k in _W_ORDER] + [jnp.asarray(bias)]
    _, vjp = jax.vjp(_jax_core(kernel, nh, gelu_approx), *args)
    jg = vjp(jnp.asarray(ct))
    got = fused_ocab_core_backward(_t(ct), *(_t(acts[k]) for k in ("q", "k", "v", "sw")),
                                   _port_weights(w, nh), _t(bias), gelu_approx)
    for name, g in zip(("dq", "dk", "dv", "dsw"), jg[:4]):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(g), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)
    for name, g in zip(_W_ORDER, jg[4:12]):
        g = np.asarray(g)
        np.testing.assert_allclose(getattr(got, name).numpy(), g.T if name in _LINEAR else g,
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)
    np.testing.assert_allclose(got.bias.numpy(), np.asarray(jg[12]), atol=GRAD_ATOL,
                               rtol=GRAD_RTOL, err_msg="bias")


def test_ocab_core_backward_matches_autograd_of_the_plain_forward():
    from tpu_superresolution_torch.kernels.fused_ocab import (
        GRAD_FIELDS,
        OcabWeights,
        ocab_core_bwd_plain,
        ocab_core_plain,
    )

    acts, w, bias, nh = _case(5)
    pw = _port_weights(w, nh)
    ins = {k: _t(v).requires_grad_() for k, v in acts.items()}
    leaves = {k: getattr(pw, k).clone().requires_grad_() for k in GRAD_FIELDS}
    b = _t(bias).requires_grad_()
    ct = torch.randn(acts["sw"].shape, generator=torch.Generator().manual_seed(2))
    ocab_core_plain(ins["q"], ins["k"], ins["v"], ins["sw"], OcabWeights(num_heads=nh, **leaves),
                    b, True).backward(ct)
    got = ocab_core_bwd_plain(ct, *(_t(acts[k]) for k in ("q", "k", "v", "sw")), pw, _t(bias),
                              True)
    for name, key in (("dq", "q"), ("dk", "k"), ("dv", "v"), ("dsw", "sw")):
        np.testing.assert_allclose(getattr(got, name).numpy(), ins[key].grad.numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)
    for k, leaf in leaves.items():
        np.testing.assert_allclose(getattr(got, k).numpy(), leaf.grad.numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=k)
    np.testing.assert_allclose(got.bias.numpy(), b.grad.numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL)


def _jax_ocab(impl, gelu_approx, c=24, nh=2, ws=7, hw=(14, 21)):
    """A JAX OCAB with seeded random parameters (the module path's tree,
    which the fused route shares) and the port's OCAB with the same
    weights."""
    from tpu_superresolution_tpu.models.hat import OCAB as JaxOCAB
    from tpu_superresolution_torch.models.hat import OCAB

    jm = JaxOCAB(c, ws, 0.5, nh, True, 2.0, attn_impl=impl, gelu_approximate=gelu_approx)
    x = jax.ShapeDtypeStruct((2, hw[0], hw[1], c), jnp.float32)
    shapes = jax.eval_shape(lambda x: JaxOCAB(c, ws, 0.5, nh, True, 2.0, attn_impl="jnp").init(
        jax.random.key(0), x), x)
    rng = np.random.default_rng(6)
    variables = jax.tree_util.tree_map_with_path(lambda p, s: _random_param(p, s.shape, rng),
                                                 shapes)
    p = variables["params"]
    sd = {"relative_position_bias_table": p["relative_position_bias_table"]}
    for name in ("norm1", "norm2"):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p[name]["scale"], p[name]["bias"]
    for name, node in (("qkv", p["qkv"]), ("proj", p["proj"]), ("mlp.fc1", p["mlp"]["fc1"]),
                       ("mlp.fc2", p["mlp"]["fc2"])):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = node["kernel"].T, node["bias"]
    tm = OCAB(c, ws, 0.5, nh, True, 2.0, gelu_approx)
    tm.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    return jm, variables, tm, sd


@pytest.mark.parametrize("impl,gelu_approx", [("fused", True), ("fused", False), ("jnp", True)])
def test_ocab_training_route_matches_jax(impl, gelu_approx):
    """The port's OCAB in train mode (K2 LN1, pre-scaled qkv, gather, K8's
    plain version on the CPU) against the JAX OCAB called with
    deterministic=False: its fused route (K8 in interpret mode) or its
    module path; output, dx and every parameter's gradient."""
    from tpu_superresolution_torch.kernels import fused_ocab

    jm, variables, tm, sd = _jax_ocab(impl, gelu_approx)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 14, 21, 24)).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def f(params, x):
        return jm.apply({"params": params}, x, False)

    out, vjp = jax.vjp(f, variables["params"], jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(ct))

    calls = []
    real = fused_ocab.ocab_core_plain
    tm.train()
    xt = _t(x).requires_grad_()
    try:  # the training route reaches K8's wrapper (its plain version here)
        fused_ocab.ocab_core_plain = lambda *a: calls.append(1) or real(*a)
        got = tm(xt)
    finally:
        fused_ocab.ocab_core_plain = real
    assert calls == [1]
    assert np.abs(got.detach().numpy() - np.asarray(out)).max() <= TOL
    got.backward(_t(ct))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    jgrad = {"relative_position_bias_table": gp["relative_position_bias_table"]}
    for name in ("norm1", "norm2"):
        jgrad[f"{name}.weight"], jgrad[f"{name}.bias"] = gp[name]["scale"], gp[name]["bias"]
    for name, node in (("qkv", gp["qkv"]), ("proj", gp["proj"]), ("mlp.fc1", gp["mlp"]["fc1"]),
                       ("mlp.fc2", gp["mlp"]["fc2"])):
        jgrad[f"{name}.weight"], jgrad[f"{name}.bias"] = np.asarray(node["kernel"]).T, node["bias"]
    for name, prm in tm.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), np.asarray(jgrad[name]), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_ocab_eval_mode_keeps_the_module_path():
    """At inference the OCAB runs the module path (the JAX package's
    INFERENCE_FUSED = False), so serving never reaches K8."""
    from tpu_superresolution_torch.kernels import fused_ocab

    _, _, tm, _ = _jax_ocab("jnp", True)
    calls = []
    real = fused_ocab.ocab_core_plain
    try:
        fused_ocab.ocab_core_plain = lambda *a: calls.append(1) or real(*a)
        with torch.no_grad():
            tm.eval()(torch.rand(1, 14, 14, 24))
    finally:
        fused_ocab.ocab_core_plain = real
    assert calls == []


def test_ocab_core_args_check():
    """The kernel wrapper's shape check (it runs on any device) takes
    HAT's ws 7 / ows 10 and hat_fast's ws 8 / ows 12 and names the shape
    of anything else."""
    from tpu_superresolution_torch.kernels.fused_ocab import check_ocab_args

    for ws in (7, 8):
        _, w, bias, nh = _case(0, ws=ws, bw=1)
        ows = ws + ws // 2
        check_ocab_args((8, ws * ws, 24), (8, ows * ows, 24), (8, ws * ws, 24),
                        _port_weights(w, nh), bias.shape)
    _, w, bias, nh = _case(0, bw=1)
    pw = _port_weights(w, nh)
    for q, k, sw, b, match in (
            ((8, 36, 24), (8, 81, 24), (8, 36, 24), (2, 36, 81), "ws, ows"),
            ((8, 49, 24), (8, 100, 24), (8, 49, 16), bias.shape, "sw"),
            ((8, 49, 24), (7, 100, 24), (8, 49, 24), bias.shape, "C=24"),
            ((8, 49, 24), (8, 100, 24), (8, 49, 24), (2, 49, 49), "bias")):
        with pytest.raises(ValueError, match=match):
            check_ocab_args(q, k, sw, pw, b)
