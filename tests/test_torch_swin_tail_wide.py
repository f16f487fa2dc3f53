"""K1's tail on the K7 route at any width: past C 2272 not even 16 rows
of x1 fit the WMMA tail kernel's shared memory (``csrc/swin_tail.cu``),
so x1 and LN2's output go to a global scratch slice a CTA
(``fused_block.tail_spills``) and ``block_route`` takes every width the
JAX block takes.  On the CPU: a Swin block at C 2304 through the K7
route's wrappers (their plain versions) against ``plain=True`` and the
JAX package's SwinBlock module (jnp attention), fp32, bound 3e-5 max
abs; the rows a block and the scratch from static shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_swin_tail import _jax_params, _swin_block, _t
from tests.util_torchport import TOL

torch.set_num_threads(1)


@pytest.mark.parametrize("c,rows,spills", [(180, 64, False), (528, 64, False), (529, 32, False),
                                           (1104, 32, False), (2272, 16, False),
                                           (2288, 16, True), (2304, 16, True),
                                           (4096, 16, True)])
def test_tail_rows_and_scratch_by_width(c, rows, spills):
    """64, 32 or 16 pixels a block, the most whose shared memory fits C;
    past C 2272 16 rows with x1 and LN2's output in a scratch of [16, CK]
    fp32 and [16, CK + 8] bf16 a CTA, and the block still routes."""
    from tpu_superresolution_torch.kernels.fused_block import (
        TAIL_SMEM,
        _tail_smem,
        block_route,
        tail_route,
        tail_rows,
        tail_scratch_bytes,
        tail_spills,
    )

    assert tail_rows(c) == rows and tail_spills(c) == spills
    assert (_tail_smem(c, rows) <= TAIL_SMEM) != spills
    ck = -(-c // 16) * 16
    assert tail_scratch_bytes(c) == 16 * ck * 4 + 16 * (ck + 8) * 2
    assert tail_scratch_bytes(c) % 256 == 0  # the CTAs' slices stay 256-byte aligned
    assert block_route(8, c, 1, c) == "window_attention"
    assert tail_route(c, c) == ("wgmma" if c <= 256 else "wmma")


def _jax_block_params(p):
    return {"params": {
        "norm1": {"scale": p["g1"], "bias": p["b1"]},
        "attn": {"qkv": {"kernel": p["wqkv"], "bias": p["bqkv"]},
                 "proj": {"kernel": p["wproj"], "bias": p["bproj"]},
                 "relative_position_bias_table": p["table"]},
        "norm2": {"scale": p["g2"], "bias": p["b2"]},
        "mlp": {"fc1": {"kernel": p["wfc1"], "bias": p["bfc1"]},
                "fc2": {"kernel": p["wfc2"], "bias": p["bfc2"]}}}}


def test_block_at_c2304_matches_plain_and_jax_block():
    """SwinBlock(2304, 8, 8, 4, mlp_ratio=1.0) on a [1, 16, 16, 2304]
    input: the default route (K2, K7 and the tail's wrappers; their plain
    versions on the CPU) runs, and matches ``plain=True`` and the JAX
    package's SwinBlock at the fp32 bound."""
    from tpu_superresolution_tpu.models.swinir import SwinBlock as JaxSwinBlock
    from tpu_superresolution_torch.kernels.fused_block import block_route

    c, nh, ws, shift = 2304, 8, 8, 4
    assert block_route(ws, c, nh, c) == "window_attention"
    rng = np.random.default_rng(2304)
    p = _jax_params(rng, c, nh, c, ws)
    x = rng.standard_normal((1, 16, 16, c)).astype(np.float32)
    jmod = JaxSwinBlock(dim=c, num_heads=nh, window_size=ws, shift_size=shift, mlp_ratio=1.0,
                        attn_impl="jnp")
    want = np.asarray(jmod.apply(jax.tree_util.tree_map(jnp.asarray, _jax_block_params(p)),
                                 jnp.asarray(x)))
    blk = _swin_block(p, c, nh, ws, shift, False)
    with torch.no_grad():
        got = blk(_t(x)).numpy()
        plain = blk(_t(x), plain=True).numpy()
    assert got.shape == plain.shape == want.shape == (1, 16, 16, c)
    assert np.abs(got - plain).max() <= TOL
    assert np.abs(got - want).max() <= TOL
