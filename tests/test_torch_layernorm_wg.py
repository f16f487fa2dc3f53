"""K2 on Hopper (``csrc/layernorm.cu``), the row LayerNorm, in the
PyTorch port against the JAX package, fp32 on the CPU: the kernel's
schedule written out in torch ops (``layernorm_plan``'s lane groups and
chunks a lane, each warp's bands of rows in the grid's order, 4-channel
chunks loaded whole or, for C not a multiple of 4, element by element
with the last chunk's tail zero, a lane's sums over its chunks, the
group's butterfly sum) against ``layernorm_plain`` and the JAX
``pallas_layernorm`` in interpret mode, at C 96, 180, 240, an odd C and
C past the banded kernel (one warp a row), with row counts that leave a
partial band and idle warps; the plan from static shapes.  Bound: 3e-5
max abs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import TOL

torch.set_num_threads(1)

EPS = 1e-5


def _group_sum(v, group):
    """The butterfly over a group's lanes (xor offsets group / 2 .. 1),
    v [..., group]: every lane ends with the same sum."""
    o = group // 2
    while o:
        v = v + v[..., torch.arange(v.shape[-1]) ^ o]
        o //= 2
    return v[..., 0]


def _schedule(x, g, b, sms):
    """csrc/layernorm.cu's order of work in torch ops, fp32: warp w of the
    grid's W warps takes bands w, w + W, ...; a band is 32 / group rows, a
    row a group of lanes, lane l of a group chunks l + group j (j < npl)
    of 4 channels; returns the output and each row's (band, warp)."""
    from tpu_superresolution_torch.kernels.layernorm import WARPS, layernorm_plan

    rows, c = x.shape
    p = layernorm_plan(rows, c, sms)
    y = torch.full_like(x, float("nan"))
    owner = torch.full((rows,), -1, dtype=torch.long)
    if p.npl == 0:  # the wide kernel: a warp a row, lanes striding the channels
        warps = p.grid * WARPS
        for w in range(min(warps, rows)):
            for row in range(w, rows, warps):
                xr = x[row]
                lanes = torch.zeros(32, 2)
                for k in range(c):
                    lanes[k % 32] += torch.stack([xr[k], xr[k] * xr[k]])
                s, sq = _group_sum(lanes[:, 0], 32), _group_sum(lanes[:, 1], 32)
                mu = s / c
                rstd = torch.rsqrt(torch.clamp(sq / c - mu * mu, min=0.0) + EPS)
                y[row] = (xr - mu) * rstd * g + b
                owner[row] = w
        return y, owner, p
    per_warp = 32 // p.group
    chunks = torch.arange(p.npl)[None, :] * p.group + torch.arange(p.group)[:, None]  # [lane, j]
    cols = 4 * chunks[..., None] + torch.arange(4)  # [lane, j, 4] channels
    real = cols < c
    gv = torch.where(real, g[cols.clamp(max=c - 1)], 0.0)
    bv = torch.where(real, b[cols.clamp(max=c - 1)], 0.0)
    warps = p.grid * WARPS
    for w in range(min(warps, p.bands)):
        for band in range(w, p.bands, warps):
            for sub in range(per_warp):
                row = band * per_warp + sub
                if row >= rows:
                    continue
                # a whole chunk's four channels or, past C, zeros (the
                # scalar form loads element by element, the same values)
                v = torch.where(real, x[row][cols.clamp(max=c - 1)], 0.0)
                s = (((v[..., 0] + v[..., 1]) + (v[..., 2] + v[..., 3]))).sum(1)
                sq = (((v[..., 0] ** 2 + v[..., 1] ** 2) + (v[..., 2] ** 2 + v[..., 3] ** 2))).sum(1)
                s, sq = _group_sum(s, p.group), _group_sum(sq, p.group)
                mu = s / c
                rstd = torch.rsqrt(torch.clamp(sq / c - mu * mu, min=0.0) + EPS)
                out = (v - mu) * rstd * gv + bv
                y[row][cols[real]] = out[real]
                owner[row] = w
    return y, owner, p


_CASES = [  # rows, C, SMs: partial last bands, idle warps, every group size
    (37, 96, 1), (61, 180, 2), (29, 240, 1), (23, 45, 3), (18, 7, 1), (11, 800, 1),
    (140, 180, 1),
]


@pytest.mark.parametrize("rows,c,sms", _CASES, ids=[f"rows{r}-C{c}-sms{s}" for r, c, s in _CASES])
def test_schedule_matches_plain_and_jax_kernel(rows, c, sms):
    from tpu_superresolution_tpu.ops.pallas.layernorm import pallas_layernorm
    from tpu_superresolution_torch.kernels.layernorm import layernorm_plain

    rng = np.random.default_rng(rows * c)
    x = (rng.standard_normal((rows, c)) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    got, owner, p = _schedule(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), sms)
    assert (owner >= 0).all()  # every row written once, by the warp its band names
    plain = layernorm_plain(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b)).numpy()
    want = np.asarray(pallas_layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                       interpret=True, block_rows=16))
    assert np.abs(got.numpy() - plain).max() <= TOL
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.parametrize("c,group,npl", [(96, 8, 3), (144, 8, 5), (180, 16, 3), (240, 32, 2),
                                         (264, 16, 5), (576, 32, 5), (45, 4, 3), (7, 4, 1),
                                         (768, 32, 6), (769, 32, 0)])
def test_plan_from_static_shapes(c, group, npl):
    """Of the (group, chunks a lane) that cover C within 6 chunks a lane,
    the fewest idle chunk slots, then the fewest chunks; past 768
    channels the wide kernel (npl 0); a persistent grid of at most four
    CTAs an SM (two past 3 chunks a lane) and no more CTAs than bands
    need."""
    from tpu_superresolution_torch.kernels.layernorm import WARPS, layernorm_plan

    for rows, sms in ((102400, 132), (37, 132), (1, 1)):
        p = layernorm_plan(rows, c, sms)
        assert (p.group, p.npl) == (group, npl)
        assert npl == 0 or 4 * group * npl >= c
        per_warp = 1 if npl == 0 else 32 // group
        assert p.bands == -(-rows // per_warp)
        assert p.grid == max(1, min(-(-p.bands // WARPS), sms * (4 if 0 < npl <= 3 else 2)))


def test_wrapper_checks_and_refuses_other_devices():
    """A CPU tensor runs the plain version (the kernel only for CUDA
    tensors); a device with neither raises."""
    from tpu_superresolution_torch.kernels.layernorm import layernorm, layernorm_plain

    x = torch.randn(5, 12)
    g, b = torch.ones(12), torch.zeros(12)
    assert torch.equal(layernorm(x, g, b), layernorm_plain(x, g, b))
    with pytest.raises(ValueError):
        layernorm(x.to("meta"), g.to("meta"), b.to("meta"))
