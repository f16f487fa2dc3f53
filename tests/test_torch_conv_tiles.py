"""K3/K4's tile schedule, written out in plain ops by
``kernels/cab_conv.conv_tiled_plain`` (the packed, swizzled weight tiles
read back through the swizzle; the flat route's 128-pixel tiles over the
flattened b*h*w index and the halo route's 8 x 16- or 8 x 24-pixel
blocks with each chunk's halo gathered once; 64-channel chunks with the zero tail; fp32
sums in the kernel's order), against the JAX package's ``conv3x3_halo``
/ ``conv_halo`` in interpret mode, fp32, bound 3e-5 max abs; and the
route and weight packing by shape.  The CUDA kernel itself is checked
against its plain version on the card by chip_smoke.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.util_torchport import TOL

torch.set_num_threads(1)

SAME3 = ((1, 1), (1, 1))
# (shape, Cout, k, pad): every edge of the schedule
CASES = {
    "w70": ((1, 6, 70, 16), 16, 3, SAME3),  # a ragged 16-wide block column
    "bhw247_cin52_cout12": ((1, 13, 19, 52), 12, 3, SAME3),  # b*h*w % 128 != 0, chunk tail
    "cin180_cout180": ((2, 5, 9, 180), 180, 3, SAME3),  # 3 chunks, the last 52 wide
    "cout27": ((1, 13, 19, 24), 27, 3, SAME3),  # the x3 reconstruction's Cout
    "k4_asym_4x4": ((2, 9, 11, 16), 12, 4, ((1, 2), (2, 1))),  # K4's asymmetric pad
    "k4_5x5": ((1, 7, 9, 64), 48, 5, ((2, 2), (2, 2))),  # the x4 reconstruction
    "two_n_tiles": ((1, 5, 6, 20), 300, 3, SAME3),  # Cout > 256: two N tiles
    "cin45": ((1, 6, 17, 45), 20, 3, SAME3),  # ThreeConv's C/4: element copies
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _case(name):
    """Inputs from a seed and the JAX kernel's output (interpret mode)."""
    from tpu_superresolution_tpu.ops.pallas.cab_conv import conv3x3_halo, conv_halo

    shape, cout, k, pad = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    cin = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    if k == 3 and pad == SAME3:
        want = conv3x3_halo(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), interpret=True)
    else:
        want = conv_halo(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), pad, interpret=True)
    return x, w, b, pad, np.asarray(want)


@pytest.mark.parametrize("route", ["flat", "halo"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_tile_schedule_matches_jax(name, route):
    from tpu_superresolution_torch.kernels.cab_conv import conv_tiled_plain

    x, w, b, pad, want = _case(name)
    got = conv_tiled_plain(_t(x), _t(w), _t(b), pad, route=route).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("shape_route", [
    # (cin, cout, kh, kw) -> (route, n_tile, n_tiles, vec)
    ((180, 180, 3, 3), ("flat", 192, 1, 4)),  # the C-180 trunk convs
    ((96, 96, 3, 3), ("halo", 96, 1, 8)),  # HAT's
    ((180, 64, 3, 3), ("halo", 64, 1, 4)),  # conv_before_upsample
    ((64, 48, 5, 5), ("halo", 48, 1, 8)),  # the composed x4 reconstruction
    ((64, 27, 5, 5), ("halo", 32, 1, 8)),  # x3
    ((64, 12, 5, 5), ("halo", 16, 1, 8)),  # x2
    ((240, 240, 3, 3), ("flat", 256, 1, 8)),  # SwinIR-L
    ((180, 45, 3, 3), ("halo", 48, 1, 4)),  # ThreeConv C -> C/4
    ((45, 180, 3, 3), ("halo", 192, 1, 1)),  # ThreeConv C/4 -> C: element copies
    ((50, 300, 3, 3), ("halo", 192, 2, 2)),  # two N tiles, 4-byte copies
    ((64, 256, 10, 10), ("flat", 256, 1, 8)),  # the halo does not fit two B stages
    ((64, 48, 13, 13), ("halo", 48, 1, 8)),
    ((64, 48, 14, 14), ("flat", 48, 1, 8)),
], ids=lambda v: "x".join(map(str, v[0])) if isinstance(v[0], tuple) else None)
def test_conv_route_by_shape(shape_route):
    from tpu_superresolution_torch.kernels.cab_conv import conv_route

    (cin, cout, kh, kw), (route, n_tile, n_tiles, vec) = shape_route
    plan = conv_route(cin, cout, kh, kw)
    assert (plan.route, plan.n_tile, plan.n_tiles, plan.vec) == (route, n_tile, n_tiles, vec)


def test_halo_stages_fit_shared_memory():
    """The halo route's budget (csrc/conv.cu halo_stages): two halo
    buffers, the B ring of taps_per_stage taps a stage, the staging tile
    and the barriers in 227 KB."""
    from tpu_superresolution_torch.kernels.cab_conv import halo_stages, taps_per_stage

    assert [taps_per_stage(n) for n in (16, 48, 96, 192, 256)] == [18, 6, 3, 1, 1]
    for n, kh, kw in ((48, 5, 5), (96, 3, 3), (256, 3, 3), (16, 13, 13)):
        s = halo_stages(n, kh, kw)
        assert 2 <= s <= 8
        halo = -(-((8 + kh - 1) * (16 + kw - 1) * 128) // 1024) * 1024
        staging = 128 * n * 2 + n * 4  # the output tile and the bias
        used = 1024 + 2 * halo + s * (taps_per_stage(n) * n * 128 + 16) + 32 + staging
        assert used <= 232448
        assert used + taps_per_stage(n) * n * 128 + 16 > 232448 or s == 8


@pytest.mark.parametrize("kh,kw,cin,cout", [(3, 3, 180, 180), (5, 5, 64, 27), (4, 4, 20, 300)])
def test_packed_weight_layout(kh, kw, cin, cout):
    """wp[n tile, chunk * taps + tap, n, 8 (j ^ n % 8) + e] = kernel[tap //
    kw, tap % kw, 64 chunk + 8 j + e, n tile * N + n], zero past Cin and
    Cout."""
    from tpu_superresolution_torch.kernels.cab_conv import pack_conv_weight

    rng = np.random.default_rng(kh * 100 + cout)
    k = torch.from_numpy(rng.standard_normal((kh, kw, cin, cout)).astype(np.float32))
    packed = pack_conv_weight(k, torch.float32)
    plan, wp = packed.plan, packed.wp.numpy()
    chunks = -(-cin // 64)
    assert wp.shape == (plan.n_tiles, chunks * kh * kw, plan.n_tile, 64)
    want = np.zeros_like(wp)
    kn = k.numpy()
    for nt in range(plan.n_tiles):
        for c in range(chunks):
            for tap in range(kh * kw):
                for n in range(plan.n_tile):
                    co = nt * plan.n_tile + n
                    if co >= cout:
                        continue
                    for j in range(8):
                        ci = c * 64 + 8 * j + np.arange(8)
                        vals = np.where(ci < cin,
                                        kn[tap // kw, tap % kw, np.minimum(ci, cin - 1), co], 0)
                        jp = j ^ (n % 8)  # the swizzled chunk
                        want[nt, c * kh * kw + tap, n, 8 * jp:8 * jp + 8] = vals
    np.testing.assert_array_equal(wp, want)


def test_conv_wrappers_on_cpu_ignore_packing():
    """On CPU tensors the wrappers run the plain version; a packed weight
    (made for the kernel) changes nothing."""
    from tpu_superresolution_torch.kernels.cab_conv import (
        conv3x3,
        conv_k,
        conv_plain,
        pack_conv_weight,
    )

    x, w, b, pad, _ = _case("k4_5x5")
    tx, tw, tb = _t(x), _t(w), _t(b)
    packed = pack_conv_weight(tw)
    assert torch.equal(conv_k(tx, tw, tb, pad, packed), conv_plain(tx, tw, tb, pad))
    x, w, b, pad, _ = _case("w70")
    tx, tw, tb = _t(x), _t(w), _t(b)
    assert torch.equal(conv3x3(tx, tw, tb, pack_conv_weight(tw)), conv_plain(tx, tw, tb, pad))


def test_inference_caches_pack_only_for_the_card():
    """``Conv3x3`` and the composed reconstruction keep K3/K4's packed
    weight beside their other derived tensors only on a CUDA device; on
    the CPU they hold None and run the plain version."""
    import torch.nn as nn

    from tpu_superresolution_torch.kernels.cab_conv import conv_plain
    from tpu_superresolution_torch.models.blocks import Conv3x3, PixelShuffleUpsample, hwio
    from tpu_superresolution_torch.ops.fused_upsample import compose_upsample

    torch.manual_seed(0)
    conv = Conv3x3(16, 8)
    k, b, packed = conv.kernel_weights(torch.float32, torch.device("cpu"))
    assert packed is None and tuple(k.shape) == (3, 3, 16, 8)
    x = torch.randn(1, 5, 7, 16)
    with torch.no_grad():
        assert torch.equal(conv(x), conv_plain(x, k, b, SAME3))
    up, last = PixelShuffleUpsample(2, 16), nn.Conv2d(16, 3, 3, 1, 1)
    comp = compose_upsample(up.stages(), (hwio(last.weight), last.bias), torch.float32, "cpu")
    assert comp.packed is None and tuple(comp.kernel.shape) == (5, 5, 16, 12)


@pytest.mark.parametrize("n_tile,k,w,want", [
    (96, 3, 70, 24),  # HAT's 70-wide tiles: 72 columns, not 80
    (96, 3, 64, 16),  # 64 columns either way: the narrower block
    (48, 5, 76, 16),  # 80 < 96
    (16, 3, 19, 24),  # 24 < 32
    (192, 3, 70, 16),  # three warpgroups' registers hold N <= 128 only
])
def test_halo_block_width_by_shape(n_tile, k, w, want):
    from tpu_superresolution_torch.kernels.cab_conv import halo_block_width

    assert halo_block_width(n_tile, k, k, w) == want
