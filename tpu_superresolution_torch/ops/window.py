"""Window partition / reverse / cyclic shift on NHWC tensors, and the
numpy shift-mask and relative-position tables (port of
``tpu_superresolution_tpu/ops/window.py``; the tables are the same numpy
code, so both packages build identical constants), square windows and
DAT's rectangular ones."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nH*nW, ws*ws, C]; H, W must divide by ws."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """[B*nH*nW, ws*ws, C] -> [B, H, W, C]."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def cyclic_shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """torch.roll(x, (-s, -s), dims=(1, 2)) on NHWC."""
    if shift == 0:
        return x
    return torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))


def cyclic_unshift(x: torch.Tensor, shift: int) -> torch.Tensor:
    if shift == 0:
        return x
    return torch.roll(x, shifts=(shift, shift), dims=(1, 2))


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """Shifted-window attention mask [nW, ws*ws, ws*ws] of 0 / -100
    (SwinIR's calculate_mask, network_swinir.py:216-237), for the padded
    map size (h, w)."""
    if shift == 0:
        n_windows = (h // ws) * (w // ws)
        return np.zeros((n_windows, ws * ws, ws * ws), dtype=np.float32)
    img_mask = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wsl] = cnt
            cnt += 1
    m = img_mask.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3)
    m = m.reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def shift_mask_tensor(h: int, w: int, ws: int, shift: int,
                      device: torch.device) -> torch.Tensor:
    """`shift_attn_mask` as an fp32 tensor on `device`, built once per
    (size, window, shift, device)."""
    return torch.from_numpy(shift_attn_mask(h, w, ws, shift)).to(device)


@functools.lru_cache(maxsize=8)
def relative_position_index(ws: int, ws_w: Optional[int] = None) -> np.ndarray:
    """Swin relative-position index table [N, N] of a ws x ws window, or
    of a rectangular ws x ws_w one (N = ws * ws_w; the buffer the
    reference builds at init, network_swinir.py:89-103, dat_arch.py:
    178-190): pairwise (dh, dw) offsets as one index into the
    [(2ws-1) * (2ws_w-1)] bias table."""
    ws_h, ws_w = ws, ws if ws_w is None else ws_w
    coords = np.stack(np.meshgrid(np.arange(ws_h), np.arange(ws_w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws_h - 1
    rel[:, :, 1] += ws_w - 1
    rel[:, :, 0] *= 2 * ws_w - 1
    return rel.sum(-1).astype(np.int32)


def rect_window_partition(x: torch.Tensor, hsp: int, wsp: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, hsp*wsp, C] rectangular windows (DAT's
    img2windows, dat_arch.py:15-23); H, W must divide by hsp, wsp."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // hsp, hsp, w // wsp, wsp, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, hsp * wsp, c)


def rect_window_reverse(windows: torch.Tensor, hsp: int, wsp: int, h: int, w: int) -> torch.Tensor:
    """Inverse of rect_window_partition -> [B, H, W, C]."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // hsp) * (w // wsp))
    x = windows.reshape(b, h // hsp, w // wsp, hsp, wsp, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def rect_shift_region_ids(h: int, w: int, hsp: int, wsp: int, sh: int, sw: int) -> np.ndarray:
    """Per-token region labels [nW, hsp*wsp] of the shifted rect-window
    mask on an (h, w) map (DAT's calculate_mask img_mask, dat_arch.py:
    318-344): tokens of one window attend iff their labels match."""
    img = np.zeros((h, w), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -hsp), slice(-hsp, -sh if sh else None),
               slice(-sh, None) if sh else slice(0, 0)):
        for wsl in (slice(0, -wsp), slice(-wsp, -sw if sw else None),
                    slice(-sw, None) if sw else slice(0, 0)):
            img[hs, wsl] = cnt
            cnt += 1
    m = img.reshape(h // hsp, hsp, w // wsp, wsp).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(m.reshape(-1, hsp * wsp))


def rect_shift_attn_mask(h: int, w: int, hsp: int, wsp: int, sh: int, sw: int) -> np.ndarray:
    """The shifted rect-window mask [nW, N, N] of 0 / -100 (not -inf) for
    hsp x wsp windows rolled by (sh, sw) on the (padded) map (h, w)
    (DAT's calculate_mask, dat_arch.py:318-361)."""
    m = rect_shift_region_ids(h, w, hsp, wsp, sh, sw)
    return np.where(m[:, None, :] != m[:, :, None], -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=32)
def rect_mask_tensor(h: int, w: int, hsp: int, wsp: int, sh: int, sw: int,
                     device: torch.device) -> torch.Tensor:
    """`rect_shift_attn_mask` as an fp32 tensor on `device`, built once."""
    return torch.from_numpy(rect_shift_attn_mask(h, w, hsp, wsp, sh, sw)).to(device)


@functools.lru_cache(maxsize=8)
def rpe_biases(hsp: int, wsp: int) -> np.ndarray:
    """DAT's dynamic-position-bias input: the (dh, dw) offsets of a
    hsp x wsp window, [(2hsp-1) * (2wsp-1), 2] fp32 (dat_arch.py:
    172-176), in the row order of `relative_position_index(hsp, wsp)`."""
    bh = np.arange(1 - hsp, hsp)
    bw = np.arange(1 - wsp, wsp)
    b = np.stack(np.meshgrid(bh, bw, indexing="ij"))
    return b.reshape(2, -1).T.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _index_tensor(ws: int, device: torch.device) -> torch.Tensor:
    """`relative_position_index` flattened, on `device`, copied there
    once (a copy per call would make the host wait for the device)."""
    return torch.from_numpy(relative_position_index(ws).reshape(-1).astype(np.int64)).to(device)


def relative_position_bias(table: torch.Tensor, ws: int) -> torch.Tensor:
    """Gather the [(2ws-1)^2, nH] bias table into [nH, N, N] fp32."""
    n = ws * ws
    bias = table.float()[_index_tensor(ws, table.device)].reshape(n, n, -1)
    return bias.permute(2, 0, 1).contiguous()


@functools.lru_cache(maxsize=8)
def relative_position_index_oca(ws: int, ows: int) -> np.ndarray:
    """Relative-position index [ws*ws, ows*ows] of HAT's overlapping
    cross-attention: q from a ws x ws window, k/v from the enclosing
    ows x ows window (reference calculate_rpi_oca, hat_arch.py:896-919).
    Its "+ ws - ows + 1" shift leaves some entries negative, which the
    reference's flat indexing into the [(ws+ows-1)^2] table wraps; the
    modulo is baked in here, as in the JAX package."""
    coords_q = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    coords_k = np.stack(np.meshgrid(np.arange(ows), np.arange(ows), indexing="ij")).reshape(2, -1)
    rel = (coords_k[:, None, :] - coords_q[:, :, None]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - ows + 1
    rel[:, :, 1] += ws - ows + 1
    rel[:, :, 0] *= ws + ows - 1
    return np.mod(rel.sum(-1), (ws + ows - 1) ** 2).astype(np.int32)


@functools.lru_cache(maxsize=32)
def _oca_index_tensor(ws: int, ows: int, device: torch.device) -> torch.Tensor:
    idx = relative_position_index_oca(ws, ows).reshape(-1).astype(np.int64)
    return torch.from_numpy(idx).to(device)


def relative_position_bias_oca(table: torch.Tensor, ws: int, ows: int) -> torch.Tensor:
    """Gather OCAB's [(ws+ows-1)^2, nH] table into [nH, ws^2, ows^2] fp32."""
    bias = table.float()[_oca_index_tensor(ws, ows, table.device)]
    return bias.reshape(ws * ws, ows * ows, -1).permute(2, 0, 1).contiguous()


def overlap_windows(x: torch.Tensor, ws: int, ows: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nW, ows*ows, C]: the ows x ows windows at stride
    ws around each ws window, zero-padded outside the map (the
    reference's nn.Unfold, hat_arch.py:378).  The pad is p_lo = (ows -
    ws) // 2 before and the rest after, as in the JAX package
    (models/hat.py:_overlap_windows), so an odd ows - ws still gives
    H/ws x W/ws windows, one per q window."""
    b, h, w, c = x.shape
    diff = ows - ws
    p_lo = diff // 2
    p_hi = diff - p_lo
    xp = torch.nn.functional.pad(x, (0, 0, p_lo, p_hi, p_lo, p_hi))
    win = xp.unfold(1, ows, ws).unfold(2, ows, ws)  # [B, nWh, nWw, C, ows, ows]
    return win.permute(0, 1, 2, 4, 5, 3).reshape(-1, ows * ows, c)
