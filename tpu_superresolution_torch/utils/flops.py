"""Per-model FLOP estimators and MFU reporting (port of
``tpu_superresolution_tpu/utils/flops.py``).

The reference ships analytic ``flops()`` methods on its networks
(``modules/network_swinir.py:150-161,842-851``; HAT / DAT inherit the
habit) for quick speed-of-light reasoning.  Here:

- analytic estimators for the transformer families (SwinIR / HAT / DAT)
  from their configs, the same formulas as the JAX package's;
- ``torch_flops``: FLOPs counted by ``torch.utils.flop_counter.FlopCounterMode``
  over a forward of the model's plain path in fp32 on the meta device
  (nothing is allocated or computed).  The port's kernels are ctypes
  calls that the counter cannot see, so the count runs over their plain
  versions, which do the same products.  The counter counts matrix
  products, convolutions and attention only: no elementwise work, no
  normalisation, softmax or reduction (XLA's cost analysis, the JAX
  package's ``xla_flops``, counts those too), so for the transformers it
  sits a little under XLA's count;
- ``mfu``: the fraction of the card's dense bf16 peak that a measured
  wall time achieves for a FLOP count.

Conventions: FLOPs are true floating-point ops (2 per multiply-
accumulate: twice the reference's MAC-style counts), batch size 1,
biases / norms / activations ignored by the analytic estimators (<1%
for these models).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

# NVIDIA H100 SXM5 (80 GB): dense bf16 tensor-core peak, 989.4 TFLOP/s
# (NVIDIA H100 Tensor Core GPU datasheet; the 1979 TFLOP/s figure there is
# with 2:4 sparsity, which no model here uses).
PEAK_BF16_FLOPS = 989.4e12


def _conv(h, w, cin, cout, k):
    return 2.0 * h * w * cin * cout * k * k


def _window_attn(h, w, c, n):
    """qk^T + A@v for window attention covering an [h, w, c] map with
    N-token windows: each is 2 * (h*w) * N * C FLOPs (nW*nH*N*N*hd*2
    with nW*N = h*w, nH*hd = C)."""
    return 2.0 * (2.0 * h * w * n * c)


def _pad_up(x, m):
    return x + (-x) % m


def swinir_flops(cfg, h: int, w: int) -> float:
    """One SwinIR forward on an [h, w] LR input (matches the model's
    actual compiled work: reflect-padded to window multiples, all four
    upsampler modes, fused or chained reconstruction — models/swinir.py)."""
    hp, wp = _pad_up(h, cfg.window_size), _pad_up(w, cfg.window_size)
    c = cfg.embed_dim
    n = cfg.window_size**2
    f = _conv(hp, wp, cfg.in_channels, c, 3)  # conv_first
    per_block = (
        2.0 * hp * wp * c * 3 * c  # qkv
        + _window_attn(hp, wp, c, n)
        + 2.0 * hp * wp * c * c  # proj
        + 2.0 * 2.0 * hp * wp * c * int(c * cfg.mlp_ratio)  # MLP
    )
    f += per_block * sum(cfg.depths)
    rstb_conv = (
        _conv(hp, wp, c, c, 3)
        if cfg.resi_connection == "1conv"
        else (
            _conv(hp, wp, c, c // 4, 3)
            + _conv(hp, wp, c // 4, c // 4, 1)
            + _conv(hp, wp, c // 4, c, 3)
        )
    )
    f += rstb_conv * len(cfg.depths)
    f += _conv(hp, wp, c, c, 3)  # conv_after_body
    s, nf, oc = cfg.scale, cfg.num_feat, cfg.out_channels
    if cfg.upsampler == "pixelshuffle":
        f += _conv(hp, wp, c, nf, 3)  # conv_before_upsample
        if getattr(cfg, "fused_reconstruct", False) and s > 1:
            f += _conv(hp, wp, nf, oc * s * s, 5)  # composed one-conv tail
        else:
            r, hh, ww = s, hp, wp
            while r > 1:
                rho = 3 if r == 3 else 2
                f += _conv(hh, ww, nf, rho * rho * nf, 3)
                hh, ww, r = hh * rho, ww * rho, r // rho
            f += _conv(hp * s, wp * s, nf, oc, 3)  # conv_last
    elif cfg.upsampler == "pixelshuffledirect":
        f += _conv(hp, wp, c, oc * s * s, 3)
    elif cfg.upsampler == "nearest+conv":
        f += _conv(hp, wp, c, nf, 3)
        f += _conv(hp * 2, wp * 2, nf, nf, 3)  # conv_up1 (post-nearest)
        if s == 4:
            f += _conv(hp * 4, wp * 4, nf, nf, 3)  # conv_up2
        f += _conv(hp * s, wp * s, nf, nf, 3)  # conv_hr
        f += _conv(hp * s, wp * s, nf, oc, 3)
    else:  # denoise: conv_last only
        f += _conv(hp, wp, c, oc, 3)
    return f


def hat_flops(cfg, h: int, w: int) -> float:
    """One HAT forward on [h, w] LR (``models/hat.py``; reference
    modules/hat_arch.py:710-994).  HAB = Swin block + CAB conv branch;
    one OCAB per group with owin^2-token kv windows."""
    hp, wp = _pad_up(h, cfg.window_size), _pad_up(w, cfg.window_size)
    c = cfg.embed_dim
    n = cfg.window_size**2
    owin = int(cfg.window_size * (1 + cfg.overlap_ratio))
    cab_mid = max(1, c // cfg.compress_ratio)
    hab = (
        2.0 * hp * wp * c * 3 * c
        + _window_attn(hp, wp, c, n)
        + 2.0 * hp * wp * c * c
        + 2.0 * 2.0 * hp * wp * c * int(c * cfg.mlp_ratio)
        + _conv(hp, wp, c, cab_mid, 3)  # CAB conv1
        + _conv(hp, wp, cab_mid, c, 3)  # CAB conv2
    )
    ocab = (
        2.0 * hp * wp * c * 3 * c  # qkv
        + 2.0 * 2.0 * hp * wp * (owin * owin) * c  # q@k^T + A@v vs kv wins
        + 2.0 * hp * wp * c * c  # proj
        + 2.0 * 2.0 * hp * wp * c * int(c * cfg.mlp_ratio)
    )
    f = _conv(hp, wp, cfg.in_channels, c, 3)
    f += hab * sum(cfg.depths) + ocab * len(cfg.depths)
    f += _conv(hp, wp, c, c, 3) * len(cfg.depths)  # per-RHAG conv
    f += _conv(hp, wp, c, c, 3)  # conv_after_body
    s, nf, oc = cfg.scale, cfg.num_feat, cfg.out_channels
    f += _conv(hp, wp, c, nf, 3)
    if getattr(cfg, "fused_reconstruct", False) and s > 1:
        f += _conv(hp, wp, nf, oc * s * s, 5)
    else:
        r, hh, ww = s, hp, wp
        while r > 1:
            rho = 3 if r == 3 else 2
            f += _conv(hh, ww, nf, rho * rho * nf, 3)
            hh, ww, r = hh * rho, ww * rho, r // rho
        f += _conv(hp * s, wp * s, nf, oc, 3)
    return f


def dat_flops(cfg, h: int, w: int) -> float:
    """One DAT forward on [h, w] (``models/dat.py``; reference
    modules/dat_arch.py:699-859).  Even blocks: dual rect-window spatial
    attention (half channels each) + 5x5 dwconv V branch; odd blocks:
    XCiT C-by-C channel attention; both + AIM convs + SGFN."""
    s0, s1 = cfg.split_size
    hp = _pad_up(h, max(s0, s1))
    wp = _pad_up(w, max(s0, s1))
    c = cfg.embed_dim
    l = hp * wp
    n_rect = s0 * s1
    hid = int(c * cfg.expansion_factor)
    qkv = 2.0 * l * c * 3 * c
    proj = 2.0 * l * c * c
    dw5 = 2.0 * l * c * 25  # depthwise 5x5 on V
    aim = (
        _conv(1, 1, c, c // 8, 1) + _conv(1, 1, c // 8, c, 1)  # channel map
        + _conv(hp, wp, c, c // 16, 1) + _conv(hp, wp, c // 16, 1, 1)  # spatial
    )
    spatial = qkv + _window_attn(hp, wp, c, n_rect) + proj + dw5 + aim
    # channel attention: per head [hd, hd] scores over L tokens
    hd = c // max(cfg.num_heads)
    channel = qkv + 2.0 * 2.0 * l * c * hd + proj + dw5 + aim
    # SGFN: fc1, depthwise-3x3 spatial gate on half the hidden, fc2
    sgfn = (
        2.0 * l * c * hid
        + 2.0 * l * (hid // 2) * 9
        + 2.0 * l * (hid // 2) * c
    )
    f = _conv(hp, wp, cfg.in_channels, c, 3)
    for d in cfg.depths:
        n_even = (d + 1) // 2
        n_odd = d // 2
        f += n_even * spatial + n_odd * channel + d * sgfn
        f += _conv(hp, wp, c, c, 3)  # per-group conv
    f += _conv(hp, wp, c, c, 3)
    sc, nf, oc = cfg.scale, cfg.num_feat, cfg.out_channels
    if cfg.upsampler == "pixelshuffle":
        f += _conv(hp, wp, c, nf, 3)
        if getattr(cfg, "fused_reconstruct", False) and sc > 1:
            f += _conv(hp, wp, nf, oc * sc * sc, 5)
        else:
            r, hh, ww = sc, hp, wp
            while r > 1:
                rho = 3 if r == 3 else 2
                f += _conv(hh, ww, nf, rho * rho * nf, 3)
                hh, ww, r = hh * rho, ww * rho, r // rho
            f += _conv(hp * sc, wp * sc, nf, oc, 3)
    else:
        f += _conv(hp, wp, c, oc * sc * sc, 3)
    return f


def model_flops(cfg, h: int, w: int) -> float:
    """Dispatch on config name.  Transformers use the analytic
    estimators; the conv families (MS_ResUNet / UNet2D) use
    ``torch_flops`` (their FLOPs are pure conv walks, which the counter
    sees whole)."""
    fns = {"swinir": swinir_flops, "hat": hat_flops, "dat": dat_flops}
    if cfg.name not in fns:
        raise ValueError(
            f"no analytic estimator for '{cfg.name}' — use torch_flops on the "
            "forward (exact for conv families)"
        )
    return fns[cfg.name](cfg, h, w)


class _CallMemo:
    """The model as the pipeline calls it: each distinct input shape runs
    once under its own counter; a repeated shape (the tiles' chunks, the
    x8 ensemble's turns) adds that count again and returns the first
    call's (meta) output."""

    def __init__(self, model: torch.nn.Module):
        self.model, self.seen, self.repeats = model, {}, 0.0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        from torch.utils.flop_counter import FlopCounterMode

        key = (tuple(x.shape), x.dtype)
        if key in self.seen:
            flops, out = self.seen[key]
            self.repeats += flops
            return out
        counter = FlopCounterMode(display=False)
        with counter:
            out = self.model(x)
        self.seen[key] = (float(counter.get_total_flops()), out)
        return out


def torch_flops(model: torch.nn.Module, shape: Sequence[int],
                forward: Optional[Callable] = None) -> float:
    """FLOPs of one forward at input `shape` ([B, H, W, C]): a copy of
    `model`'s config built with ``impl="plain"`` in fp32 on the meta
    device, run by ``forward(copy, x)`` (default ``copy(x)``) under
    ``FlopCounterMode``.  Each distinct shape of the model's calls inside
    `forward` runs once (``_CallMemo``), and a first, uncounted pass
    derives the weights that inference derives once per loaded weights
    (the composed reconstruction conv).  Matrix products, convolutions
    and attention only (the module docstring says what that leaves
    out)."""
    from torch.utils.flop_counter import FlopCounterMode

    from tpu_superresolution_torch.core.config import build_model

    meta = torch.device("meta")
    with meta:
        copy = build_model(model.config, impl="plain").train(model.training)
    x = torch.empty(tuple(shape), dtype=torch.float32, device=meta)
    run = forward or (lambda m, a: m(a))
    with torch.no_grad():
        run(_CallMemo(copy), x)  # the derived weights, uncounted
        memo, counter = _CallMemo(copy), FlopCounterMode(display=False)
        with counter:
            run(memo, x)
    return float(counter.get_total_flops()) + memo.repeats


def mfu(flops: float, seconds: float, peak: float = PEAK_BF16_FLOPS) -> float:
    """Model FLOPs utilization: achieved FLOP/s over the card's dense
    bf16 peak."""
    return flops / seconds / peak
