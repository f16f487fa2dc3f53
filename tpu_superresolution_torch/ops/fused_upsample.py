"""Collapse the linear pixel-shuffle reconstruction tail into ONE conv
(port of ``tpu_superresolution_tpu/ops/fused_upsample.py``).

After ``conv_before_upsample``'s LeakyReLU the reference tail is linear:
conv3x3 -> PixelShuffle per stage, then ``conv_last``
(network_swinir.py:572-591,816-817).  A composition of convs and pixel
shuffles is one low-resolution conv to ``out_ch * r**2`` channels
followed by one pixel_shuffle(r).  The composition runs in numpy once
per loaded weights (``compose_upsample``); the forward is then one conv
(kernel K4 on CUDA) and one pixel shuffle.  For x4 the composed kernel
is [5, 5, 64, 48] with pad ((2, 2), (2, 2)).

Border semantics: the chain zero-pads every intermediate map, the
composed conv only the low-res input, so the two agree exactly in the
interior and differ on a ring of up to 3*scale output pixels (12 at x4).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from tpu_superresolution_torch.kernels.cab_conv import Pad, conv_k, conv_plain
from tpu_superresolution_torch.ops.pixelshuffle import pixel_shuffle


def _rep_onehot(r: int) -> np.ndarray:
    """M[A, B, s_in, s_out, dy, dx] = 1 iff the high-res tap (dy, dx) of
    output subpixel s_out reads input subpixel s_in at low-res offset
    (A-1, B-1) (torch PixelShuffle channel order c*r*r + I*r + J)."""
    M = np.zeros((3, 3, r * r, r * r, 3, 3), np.float32)
    for i in range(r):
        for j in range(r):
            for dy in range(3):
                for dx in range(3):
                    iy, ix = i + dy - 1, j + dx - 1
                    a, ii = iy // r, iy % r
                    b, jj = ix // r, ix % r
                    M[a + 1, b + 1, ii * r + jj, i * r + j, dy, dx] = 1.0
    return M


def _rep_kernel(w: np.ndarray, r: int) -> np.ndarray:
    """[3,3,cin,cout] conv at r-times resolution -> low-lattice conv
    [3,3,cin*r^2,cout*r^2] over rep channels."""
    if r == 1:
        return w
    cin, cout = w.shape[2], w.shape[3]
    k = np.einsum("ABstyx,yxcd->ABcsdt", _rep_onehot(r), w)
    return k.reshape(3, 3, cin * r * r, cout * r * r)


def _compose_offsets(k_old: np.ndarray, k_rep: np.ndarray) -> np.ndarray:
    """Spatially compose k_old [kh,kw,cin,cm] with a 3x3 k_rep
    [3,3,cm,cout] -> [kh+2,kw+2,cin,cout]."""
    kh, kw, cin, _ = k_old.shape
    out = np.zeros((kh + 2, kw + 2, cin, k_rep.shape[3]), np.float32)
    for dy in range(3):
        for dx in range(3):
            out[dy : dy + kh, dx : dx + kw] += np.einsum("oucd,de->ouce", k_old, k_rep[dy, dx])
    return out


def _ps_perm(c_true: int, r: int, rho: int) -> np.ndarray:
    """Source channel of each rep channel after PixelShuffle(rho) of a
    map that is itself a rep at expansion r."""
    rp = r * rho
    perm = np.empty(c_true * rp * rp, np.int64)
    for c in range(c_true):
        for In in range(rp):
            for Jn in range(rp):
                I, i = In // rho, In % rho
                J, j = Jn // rho, Jn % rho
                perm[c * rp * rp + In * rp + Jn] = (c * rho * rho + i * rho + j) * r * r + I * r + J
    return perm


def _compose(stages, last):
    """[(kernel, bias, rho)...] + (kernel, bias) -> (K, B, r), untrimmed."""
    k0, b0, rho0 = stages[0]
    c_true = k0.shape[3] // (rho0 * rho0)
    perm = _ps_perm(c_true, 1, rho0)
    K, B, r = k0[..., perm], b0[perm], rho0
    for w, b, rho in stages[1:]:
        k_rep = _rep_kernel(w, r)
        K = _compose_offsets(K, k_rep)
        B = np.repeat(b, r * r) + np.einsum("yxce,c->e", k_rep, B)
        perm = _ps_perm(w.shape[3] // (rho * rho), r, rho)
        K, B = K[..., perm], B[perm]
        r *= rho
    wl, bl = last
    k_rep = _rep_kernel(wl, r)
    K = _compose_offsets(K, k_rep)
    B = np.repeat(bl, r * r) + np.einsum("yxce,c->e", k_rep, B)
    return K, B, r


@functools.lru_cache(maxsize=32)
def _support(shape_key) -> Tuple[int, int, int, int, int]:
    """Structural nonzero support (y0, y1, x0, x1, ctr) of the composed
    kernel, found once with random weights of the same shapes."""
    stage_shapes, rhos, last_shape = shape_key
    rng = np.random.RandomState(0)
    stages = [
        (rng.rand(*s).astype(np.float32) + 0.5, rng.rand(s[3]).astype(np.float32), r)
        for s, r in zip(stage_shapes, rhos)
    ]
    last = (rng.rand(*last_shape).astype(np.float32) + 0.5,
            rng.rand(last_shape[3]).astype(np.float32))
    K, _, _ = _compose(stages, last)
    ys, xs = np.where(np.abs(K).max(axis=(2, 3)) > 0)
    return int(ys.min()), int(ys.max()), int(xs.min()), int(xs.max()), len(stages) + 1


def composed_upsample_params(stages, last):
    """Compose the chain into (K [kh,kw,cin,out*r^2], B [out*r^2], pad, r),
    numpy fp32.  stages: [(kernel [3,3,cin,cout], bias, ps_factor)...];
    last: (kernel [3,3,c,out], bias)."""
    f32 = lambda a: np.asarray(a, np.float32)
    stages = [(f32(w), f32(b), int(r)) for w, b, r in stages]
    last = (f32(last[0]), f32(last[1]))
    shape_key = (
        tuple(tuple(int(d) for d in w.shape) for w, _, _ in stages),
        tuple(r for _, _, r in stages),
        tuple(int(d) for d in last[0].shape),
    )
    y0, y1, x0, x1, ctr = _support(shape_key)
    K, B, r = _compose(stages, last)
    K = np.ascontiguousarray(K[y0 : y1 + 1, x0 : x1 + 1])
    pad = ((ctr - y0, y1 - ctr), (ctr - x0, x1 - ctr))
    return K, B.astype(np.float32), pad, r


@dataclasses.dataclass(frozen=True)
class ComposedUpsample:
    """The composed reconstruction conv, ready for K4: kernel
    [kh, kw, cin, out*r^2] in the compute dtype, fp32 bias."""

    kernel: torch.Tensor
    bias: torch.Tensor
    pad: Pad
    r: int


def compose_upsample(stages, last, dtype: torch.dtype,
                     device: torch.device) -> ComposedUpsample:
    """`composed_upsample_params` from torch or numpy weights, as tensors
    on `device` (called once per loaded weights)."""
    to_np = lambda a: a.detach().float().cpu().numpy() if torch.is_tensor(a) else a
    K, B, pad, r = composed_upsample_params(
        [(to_np(w), to_np(b), r) for w, b, r in stages], (to_np(last[0]), to_np(last[1]))
    )
    return ComposedUpsample(
        kernel=torch.from_numpy(K).to(device=device, dtype=dtype).contiguous(),
        bias=torch.from_numpy(B).to(device),
        pad=pad,
        r=r,
    )


def fused_pixelshuffle_reconstruct(y: torch.Tensor, comp: ComposedUpsample,
                                   plain: bool = False) -> torch.Tensor:
    """One conv (K4, or its plain version) + one pixel_shuffle.
    y: [B, H, W, C] after conv_before_upsample's LeakyReLU ->
    [B, H*r, W*r, out_ch]."""
    conv = conv_plain if plain else conv_k
    return pixel_shuffle(conv(y, comp.kernel, comp.bias, comp.pad), comp.r)


def chain_pixelshuffle_reconstruct(y: torch.Tensor, stages: Sequence, last,
                                   dtype: torch.dtype) -> torch.Tensor:
    """The reference's step-by-step chain (plain torch): conv3x3 zero pad
    -> PixelShuffle per stage, then conv_last.  Kernels are [3,3,cin,cout]."""
    x = y.to(dtype)
    for w, b, rho in stages:
        x = pixel_shuffle(conv_plain(x, w, b, ((1, 1), (1, 1))), rho)
    w, b = last
    return conv_plain(x, w, b, ((1, 1), (1, 1)))
