"""Collapse the linear pixel-shuffle reconstruction tail into ONE conv
(port of ``tpu_superresolution_tpu/ops/fused_upsample.py``).

After ``conv_before_upsample``'s LeakyReLU the reference tail is linear:
conv3x3 -> PixelShuffle per stage, then ``conv_last``
(network_swinir.py:572-591,816-817).  A composition of convs and pixel
shuffles is one low-resolution conv to ``out_ch * r**2`` channels
followed by one pixel_shuffle(r).  At inference the composition runs in
numpy once per loaded weights (``compose_upsample``); in training it
runs with torch ops on every step (``compose_upsample_torch``), so the
gradient reaches the chain's weights.  The forward is then one conv
(kernel K4 on CUDA) and one pixel shuffle.  For x4 the composed kernel
is [5, 5, 64, 48] with pad ((2, 2), (2, 2)).

Border semantics: the chain zero-pads every intermediate map, the
composed conv only the low-res input, so the two agree exactly in the
interior and differ on a ring of up to 3*scale output pixels (12 at x4).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_superresolution_torch.kernels.cab_conv import (
    Pad,
    PackedConv,
    conv_k,
    conv_plain,
    pack_conv_weight,
)
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


def _rep_kernel(w, r: int):
    """[3,3,cin,cout] conv at r-times resolution -> low-lattice conv
    [3,3,cin*r^2,cout*r^2] over rep channels (numpy or torch `w`)."""
    if r == 1:
        return w
    cin, cout = w.shape[2], w.shape[3]
    if torch.is_tensor(w):
        k = torch.einsum("ABstyx,yxcd->ABcsdt", _onehot_tensor(r, w.device, w.dtype), w)
    else:
        k = np.einsum("ABstyx,yxcd->ABcsdt", _rep_onehot(r), w)
    return k.reshape(3, 3, cin * r * r, cout * r * r)


def _compose_offsets(k_old, k_rep):
    """Spatially compose k_old [kh,kw,cin,cm] with a 3x3 k_rep
    [3,3,cm,cout] -> [kh+2,kw+2,cin,cout] (numpy or torch)."""
    kh, kw, cin, _ = k_old.shape
    shape = (kh + 2, kw + 2, cin, k_rep.shape[3])
    if torch.is_tensor(k_old):
        out, einsum = k_old.new_zeros(shape), torch.einsum
    else:
        out, einsum = np.zeros(shape, np.float32), np.einsum
    for dy in range(3):
        for dx in range(3):
            out[dy : dy + kh, dx : dx + kw] += einsum("oucd,de->ouce", k_old, k_rep[dy, dx])
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


# The training composition runs every step on the weights' device; its
# index constants are copied there once (a host-to-device copy per step
# would make the host wait for the device).
@functools.lru_cache(maxsize=32)
def _onehot_tensor(r: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(_rep_onehot(r)).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=32)
def _perm_tensor(c_true: int, r: int, rho: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_ps_perm(c_true, r, rho)).to(device)


def _repeat(b, n: int):
    return torch.repeat_interleave(b, n) if torch.is_tensor(b) else np.repeat(b, n)


def _einsum(eq, *ops):
    return torch.einsum(eq, *ops) if torch.is_tensor(ops[0]) else np.einsum(eq, *ops)


def _permute(K, B, c_true: int, r: int, rho: int):
    """K[..., perm], B[perm] for the permutation of PixelShuffle(rho) on
    a rep at expansion r."""
    if torch.is_tensor(K):
        perm = _perm_tensor(c_true, r, rho, K.device)
    else:
        perm = _ps_perm(c_true, r, rho)
    return K[..., perm], B[perm]


def _compose(stages, last):
    """[(kernel, bias, rho)...] + (kernel, bias) -> (K, B, r), untrimmed;
    numpy or torch arrays throughout (the torch ops are differentiable)."""
    k0, b0, rho0 = stages[0]
    c_true = k0.shape[3] // (rho0 * rho0)
    K, B = _permute(k0, b0, c_true, 1, rho0)
    r = rho0
    for w, b, rho in stages[1:]:
        k_rep = _rep_kernel(w, r)
        K = _compose_offsets(K, k_rep)
        B = _repeat(b, r * r) + _einsum("yxce,c->e", k_rep, B)
        K, B = _permute(K, B, w.shape[3] // (rho * rho), r, rho)
        r *= rho
    wl, bl = last
    k_rep = _rep_kernel(wl, r)
    K = _compose_offsets(K, k_rep)
    B = _repeat(bl, r * r) + _einsum("yxce,c->e", k_rep, B)
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


def _compose_trimmed(stages, last):
    """Compose, then trim K to its structural support: (K, B, pad, r)."""
    shape_key = (
        tuple(tuple(int(d) for d in w.shape) for w, _, _ in stages),
        tuple(int(r) for _, _, r in stages),
        tuple(int(d) for d in last[0].shape),
    )
    y0, y1, x0, x1, ctr = _support(shape_key)
    K, B, r = _compose(stages, last)
    pad = ((ctr - y0, y1 - ctr), (ctr - x0, x1 - ctr))
    return K[y0 : y1 + 1, x0 : x1 + 1], B, pad, r


def composed_upsample_params(stages, last):
    """Compose the chain into (K [kh,kw,cin,out*r^2], B [out*r^2], pad, r),
    numpy fp32.  stages: [(kernel [3,3,cin,cout], bias, ps_factor)...];
    last: (kernel [3,3,c,out], bias)."""
    f32 = lambda a: np.asarray(a, np.float32)
    K, B, pad, r = _compose_trimmed([(f32(w), f32(b), int(r)) for w, b, r in stages],
                                    (f32(last[0]), f32(last[1])))
    return np.ascontiguousarray(K), B.astype(np.float32), pad, r


@dataclasses.dataclass(frozen=True)
class ComposedUpsample:
    """The composed reconstruction conv, ready for K4: kernel
    [kh, kw, cin, out*r^2] in the compute dtype, fp32 bias, and K4's
    packed weight where it was built once for inference on a CUDA device
    (else None: the wrapper packs on every call)."""

    kernel: torch.Tensor
    bias: torch.Tensor
    pad: Pad
    r: int
    packed: Optional[PackedConv] = None


def compose_upsample(stages, last, dtype: torch.dtype,
                     device: torch.device) -> ComposedUpsample:
    """`composed_upsample_params` from torch or numpy weights, as tensors
    on `device` (called once per loaded weights)."""
    to_np = lambda a: a.detach().float().cpu().numpy() if torch.is_tensor(a) else a
    K, B, pad, r = composed_upsample_params(
        [(to_np(w), to_np(b), r) for w, b, r in stages], (to_np(last[0]), to_np(last[1]))
    )
    kernel = torch.from_numpy(K).to(device=device, dtype=dtype).contiguous()
    packed = pack_conv_weight(kernel) if torch.device(device).type == "cuda" else None
    return ComposedUpsample(kernel=kernel, bias=torch.from_numpy(B).to(device), pad=pad, r=r,
                            packed=packed)


def compose_upsample_torch(stages, last, dtype: torch.dtype) -> ComposedUpsample:
    """The same composition with torch ops in fp32 on the weights'
    device, differentiable: the training path, where the JAX package
    composes in jnp inside the step (``ops/fused_upsample.py:164-185``)."""
    K, B, pad, r = _compose_trimmed([(w.float(), b.float(), int(r)) for w, b, r in stages],
                                    (last[0].float(), last[1].float()))
    return ComposedUpsample(kernel=K.to(dtype).contiguous(), bias=B, pad=pad, r=r)


def fused_pixelshuffle_reconstruct(y: torch.Tensor, comp: ComposedUpsample,
                                   plain: bool = False) -> torch.Tensor:
    """One conv (K4, or its plain version) + one pixel_shuffle.
    y: [B, H, W, C] after conv_before_upsample's LeakyReLU ->
    [B, H*r, W*r, out_ch]."""
    if plain:
        return pixel_shuffle(conv_plain(y, comp.kernel, comp.bias, comp.pad), comp.r)
    return pixel_shuffle(conv_k(y, comp.kernel, comp.bias, comp.pad, comp.packed), comp.r)


def chain_pixelshuffle_reconstruct(y: torch.Tensor, stages: Sequence, last,
                                   dtype: torch.dtype) -> torch.Tensor:
    """The reference's step-by-step chain (plain torch): conv3x3 zero pad
    -> PixelShuffle per stage, then conv_last.  Kernels are [3,3,cin,cout]."""
    x = y.to(dtype)
    for w, b, rho in stages:
        x = pixel_shuffle(conv_plain(x, w, b, ((1, 1), (1, 1))), rho)
    w, b = last
    return conv_plain(x, w, b, ((1, 1), (1, 1)))
