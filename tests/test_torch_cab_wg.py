"""The host side of K12's Hopper kernel (``csrc/cab_fused.cu``), fp32 on
the CPU:

- ``cab_plan`` and ``cab_route`` decide from static shapes only;
- the packed, swizzled [N, 64] weight tiles of both convs, unswizzled in
  torch, give back the kernels and biases exactly;
- the kernel's schedule written out in torch ops (14 x 14 output blocks;
  each block's 18 x 18 input halo normalised by LN with the zero ring
  outside the image and past C, in 64-channel chunks; conv1 on the 16 x
  16 pixels around the block as four 8 x 8 tiles whose tap operands are
  windows of the halo; + c1, the GELU, zero outside the image, into the
  18 x 18 y1 buffer, one 64-channel chunk a y1 item (two at Cmid 65-128);
  conv2 on 2 x 2 tiles of 8 x 8 in passes of N2 channels, each reducing
  over the y1 chunks, the block's 14 x 14 kept) reproduces
  ``fused_ln_cab_convs_plain``.

Bound: 3e-5 max abs (fp32)."""

import pytest
import torch
import torch.nn.functional as F

from tests.util_torchport import TOL

torch.set_num_threads(1)

OB, HS = 14, 18  # csrc/cab_fused.cu: output block side, halo / y1 buffer side


def unpack_taps(w: torch.Tensor) -> torch.Tensor:
    """[reps, 9, N, 64] swizzled tiles, unswizzled: rep the K chunk
    (conv1) or the (N pass, K chunk) pair (conv2)."""
    from tpu_superresolution_torch.kernels.cab_conv import _swizzle_rows

    return _swizzle_rows(w.float())  # [reps, 9, N, 64]


def cab_emulated(x, p):
    """csrc/cab_fused.cu's schedule in fp32 torch ops on packed operands
    `p` (``pack_cab``)."""
    from tpu_superresolution_torch.kernels.layernorm import layernorm_plain

    b, h, w, c = x.shape
    plan = p.plan
    w1 = unpack_taps(p.w1)  # [chunks, 9, N1, 64]
    mch = -(-plan.n1 // 64)  # y1 chunks
    w2 = unpack_taps(p.w2).reshape(plan.passes, mch, 9, plan.n2, 64)
    chunks = w1.shape[0]
    ln = F.pad(layernorm_plain(x, p.g, p.b), (0, 64 * chunks - c))
    y = torch.full_like(x, float("nan"))
    for img in range(b):
        for oy0 in range(0, h, OB):
            for ox0 in range(0, w, OB):
                # the 18 x 18 halo at (oy0 - 2, ox0 - 2): zero outside the image
                halo = torch.zeros(HS, HS, 64 * chunks)
                for hy in range(HS):
                    for hx in range(HS):
                        yy, xx = oy0 - 2 + hy, ox0 - 2 + hx
                        if 0 <= yy < h and 0 <= xx < w:
                            halo[hy, hx] = ln[img, yy, xx]
                # conv1 on the 16 x 16 region at (oy0 - 1, ox0 - 1): four 8 x 8
                # tiles, each tap's operand the halo window at the tap
                acc1 = torch.zeros(16, 16, plan.n1)
                for ty in range(2):
                    for tx in range(2):
                        for ch in range(chunks):
                            for tap in range(9):
                                dy, dx = divmod(tap, 3)
                                a = halo[8 * ty + dy:8 * ty + dy + 8, 8 * tx + dx:8 * tx + dx + 8,
                                         64 * ch:64 * ch + 64]
                                acc1[8 * ty:8 * ty + 8, 8 * tx:8 * tx + 8] += a @ w1[ch, tap].T
                # the y1 items (64 channels each); room for the unused tiles' reads
                y1 = torch.zeros(HS + 2, HS + 2, 64 * mch)
                for ry in range(16):
                    for rx in range(16):
                        yy, xx = oy0 - 1 + ry, ox0 - 1 + rx
                        if 0 <= yy < h and 0 <= xx < w:
                            y1[ry + 1, rx + 1, :plan.n1] = F.gelu(acc1[ry, rx] + p.c1)
                # conv2 on 2 x 2 tiles of 8 x 8 at the block, in passes of N2
                out = torch.zeros(16, 16, plan.n2 * plan.passes)
                for ty in range(2):
                    for tx in range(2):
                        for ps in range(plan.passes):
                            acc = torch.zeros(8, 8, plan.n2)
                            for yc in range(mch):
                                for tap in range(9):
                                    dy, dx = divmod(tap, 3)
                                    a = y1[8 * ty + dy + 1:8 * ty + dy + 9,
                                           8 * tx + dx + 1:8 * tx + dx + 9, 64 * yc:64 * yc + 64]
                                    acc += a @ w2[ps, yc, tap].T
                            out[8 * ty:8 * ty + 8, 8 * tx:8 * tx + 8,
                                ps * plan.n2:(ps + 1) * plan.n2] = acc
                out = out + p.c2
                ny, nx = min(OB, h - oy0), min(OB, w - ox0)
                y[img, oy0:oy0 + ny, ox0:ox0 + nx] = out[:ny, :nx, :c]
    return y


_PLANS = [((180, 60), (64, 96, 2)), ((96, 32), (32, 96, 1)), ((144, 6), (16, 48, 3)),
          ((256, 64), (64, 64, 4)), ((24, 5), (16, 48, 1)), ((256, 128), (128, 64, 4)),
          ((180, 90), (128, 96, 2))]


@pytest.mark.parametrize("shape,want", _PLANS, ids=[f"C{c}-mid{m}" for (c, m), _ in _PLANS])
def test_cab_plan_by_width(shape, want):
    """K12's N tiles from the widths alone: conv1's narrowest compiled N
    that holds Cmid, conv2's with the least padding over C (ties to the
    wider tile); the same on every call."""
    from tpu_superresolution_torch.kernels.cab_conv import CAB_N1, CAB_N2, cab_plan, cab_route

    plan = cab_plan(*shape)
    assert (plan.n1, plan.n2, plan.passes) == want
    assert plan.n1 in CAB_N1 and plan.n2 in CAB_N2 and plan.n2 * plan.passes >= shape[0]
    assert cab_plan(*shape) is plan and cab_route(*shape) == "K12"


def test_cab_plan_refuses_past_its_widths():
    from tpu_superresolution_torch.kernels.cab_conv import cab_plan, cab_route

    for c, cm in ((264, 88), (240, 160)):
        assert cab_route(c, cm) == "convs"
        with pytest.raises(ValueError, match="K12 takes"):
            cab_plan(c, cm)


@pytest.mark.parametrize("c,cm", [(180, 60), (96, 32), (144, 6), (30, 10), (256, 128), (96, 80)])
def test_cab_tiles_unswizzle_to_the_weights(c, cm):
    """Both convs' packed tiles, unswizzled, give back the bf16 kernels
    exactly (zero in the padding) and the biases padded with zeros."""
    from tpu_superresolution_torch.kernels.cab_conv import pack_cab

    g = torch.Generator().manual_seed(c + cm)
    k1, k2 = torch.randn(3, 3, c, cm, generator=g), torch.randn(3, 3, cm, c, generator=g)
    c1, c2 = torch.randn(cm, generator=g), torch.randn(c, generator=g)
    p = pack_cab(torch.ones(c), torch.zeros(c), k1, c1, k2, c2)
    plan = p.plan
    w1 = unpack_taps(p.w1)  # [chunks, 9, N1, 64]: [chunk, tap, mid, in]
    w1 = w1.permute(1, 0, 3, 2).reshape(9, -1, plan.n1)  # [tap, in, mid]
    assert torch.equal(w1[:, :c, :cm], k1.reshape(9, c, cm).bfloat16().float())
    assert not w1[:, c:].any() and not w1[:, :, cm:].any()
    mch = -(-plan.n1 // 64)
    w2 = unpack_taps(p.w2).reshape(plan.passes, mch, 9, plan.n2, 64)  # [pass, chunk, tap, out, mid]
    w2 = w2.permute(2, 1, 4, 0, 3).reshape(9, 64 * mch, -1)  # [tap, mid, out]
    assert torch.equal(w2[:, :cm, :c], k2.reshape(9, cm, c).bfloat16().float())
    assert not w2[:, cm:].any() and not w2[:, :, c:].any()
    assert torch.equal(p.c1[:cm], c1) and not p.c1[cm:].any()
    assert torch.equal(p.c2[:c], c2) and not p.c2[c:].any()


_SCHEDULES = [((1, 20, 17, 24, 8), "odd-sides"), ((2, 14, 28, 96, 32), "whole-blocks"),
              ((1, 9, 30, 180, 60), "C180-3-chunks"), ((1, 16, 15, 144, 6), "C144-3-passes"),
              ((1, 16, 15, 256, 128), "C256-mid128-two-y1-chunks")]


@pytest.mark.parametrize("shape", [s for s, _ in _SCHEDULES], ids=[i for _, i in _SCHEDULES])
def test_cab_schedule_emulated_matches_plain(shape):
    """The kernel's schedule in torch (14 x 14 blocks, the LN halo with
    its zero ring, conv1 on 8 x 8 tiles of the 16 x 16 region, y1 zero
    outside the image, conv2 in passes) reproduces the plain version at
    fp32: image sides that are and are not multiples of 14, C past one
    64-channel chunk, conv2 in two and three passes, and Cmid 128 (y1 in
    two chunks, conv2 reducing over both)."""
    from tpu_superresolution_torch.kernels.cab_conv import fused_ln_cab_convs_plain, pack_cab

    b, h, w, c, cm = shape
    g = torch.Generator().manual_seed(c * cm + h)
    x = torch.randn(b, h, w, c, generator=g)
    gam, bet = 1 + 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)
    k1 = torch.randn(3, 3, c, cm, generator=g) * (9 * c) ** -0.5
    k2 = torch.randn(3, 3, cm, c, generator=g) * (9 * cm) ** -0.5
    c1, c2 = 0.1 * torch.randn(cm, generator=g), 0.1 * torch.randn(c, generator=g)
    p = pack_cab(gam, bet, k1, c1, k2, c2, dtype=torch.float32)
    got = cab_emulated(x, p)
    want = fused_ln_cab_convs_plain(x, gam, bet, k1, c1, k2, c2)
    assert not torch.isnan(got).any()
    assert (got - want).abs().max().item() <= TOL
