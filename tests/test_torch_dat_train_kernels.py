"""K11 (depthwise 3x3) and K16 (batched window attention) in the PyTorch
port against the JAX package's Pallas kernels in interpret mode, fp32 on
the CPU, where the port's wrappers run their plain versions:

- K11 ``dwconv3x3`` against ``cab_conv.dwconv3x3_halo``, at an odd width
  and at a height that is not a multiple of the kernel's row chunk;
- K16 ``batched_window_attention`` against
  ``window_attention.batched_window_attention`` at N 32 and at DAT's rect
  N 128, with and without a shift mask over B*nW windows (window w takes
  mask[w % nW]; the JAX kernel wants N % 8 == 0 and, with a mask, the
  window count and nW multiples of its group of 8);
- the gradients of both (torch autograd of the plain version) against
  ``jax.vjp`` of the JAX kernels' custom_vjp.

Bounds: forwards 3e-5 max abs; gradients atol 2e-4 / rtol 1e-3 (the JAX
package's own kernel-vs-vjp bound, as for K5).  Also the wrappers'
refusal of a device they have nothing for."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import TOL

torch.set_num_threads(1)

GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True)


@pytest.mark.parametrize("shape", [(2, 13, 11, 16), (1, 21, 24, 24), (3, 5, 7, 6)],
                         ids=["odd-width", "h-not-chunk-multiple", "tiny"])
def test_dwconv3x3_plain_matches_jax_kernel(shape):
    """dwconv3x3 on CPU tensors (its plain version) against the JAX
    dwconv3x3_halo in interpret mode, forward and vjp."""
    from tpu_superresolution_tpu.ops.pallas.cab_conv import dwconv3x3_halo
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels.dwconv import dwconv3x3

    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    k = (rng.standard_normal((3, 3, 1, c)) / 3).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    f = lambda x, k, b: dwconv3x3_halo(x, k, b, interpret=True)
    want, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    gx, gk, gb = vjp(jnp.asarray(ct))

    reset_counters()
    tx, tk, tb = _t(x), _t(k.reshape(3, 3, c)), _t(b)
    got = dwconv3x3(tx, tk, tb)
    assert got.shape == shape and got.dtype == torch.float32
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= TOL
    got.backward(torch.from_numpy(ct))
    assert not any(read_counters().values())
    gk = np.asarray(gk).reshape(3, 3, c)
    for name, a, w in (("dx", tx.grad, gx), ("dkernel", tk.grad, gk), ("dbias", tb.grad, gb)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


_ATTN_CASES = [(8, 2, 32, 16, False), (16, 2, 32, 16, True), (8, 3, 128, 30, False),
               (16, 3, 128, 30, True)]


@pytest.mark.parametrize("bw,nh,n,hd,masked", _ATTN_CASES,
                         ids=[f"bw{c[0]}-n{c[2]}-{'mask' if c[4] else 'nomask'}"
                              for c in _ATTN_CASES])
def test_batched_window_attention_plain_matches_jax_kernel(bw, nh, n, hd, masked):
    """batched_window_attention on CPU tensors (its plain version)
    against the JAX batched_window_attention in interpret mode: the
    output and the vjp on q, k, v and the bias.  The masked cases are two
    images of 8 windows each, with DAT's 0 / -100 mask."""
    from tpu_superresolution_tpu.ops.pallas.window_attention import batched_window_attention
    from tpu_superresolution_torch.kernels import read_counters, reset_counters
    from tpu_superresolution_torch.kernels.window_attention import (
        batched_window_attention as port_attention,
    )

    rng = np.random.default_rng(n + bw + int(masked))
    q, k, v = (rng.standard_normal((bw, nh, n, hd)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((nh, n, n)).astype(np.float32)
    mask = None
    if masked:
        ids = rng.integers(0, 3, size=(8, n))
        mask = np.where(ids[:, None, :] != ids[:, :, None], -100.0, 0.0).astype(np.float32)
    ct = rng.standard_normal((bw, nh, n, hd)).astype(np.float32)
    scale = hd ** -0.5
    f = lambda q, k, v, bias: batched_window_attention(q, k, v, bias, mask, scale=scale,
                                                       interpret=True)
    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v, bias)))
    jgrads = vjp(jnp.asarray(ct))

    reset_counters()
    tq, tk, tv, tb = (_t(a) for a in (q, k, v, bias))
    got = port_attention(tq, tk, tv, tb, None if mask is None else torch.from_numpy(mask), scale)
    assert got.shape == (bw, nh, n, hd)
    assert np.abs(got.detach().numpy() - np.asarray(want)).max() <= TOL
    got.backward(torch.from_numpy(ct))
    assert not any(read_counters().values())
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), (tq, tk, tv, tb), jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_kernel_wrappers_refuse_other_devices():
    """A tensor on a device with neither a kernel nor a plain version is
    refused, not run some other way."""
    from tpu_superresolution_torch.kernels.dwconv import dwconv3x3
    from tpu_superresolution_torch.kernels.window_attention import batched_window_attention

    meta = torch.device("meta")
    q = torch.empty(2, 1, 16, 8, device=meta)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        batched_window_attention(q, q, q, torch.empty(1, 16, 16, device=meta))
    x = torch.empty(1, 4, 4, 8, device=meta)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        dwconv3x3(x, torch.empty(3, 3, 8, device=meta), torch.empty(8, device=meta))
