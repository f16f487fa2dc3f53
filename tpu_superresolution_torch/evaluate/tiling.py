"""Tiled whole-image inference with overlap blending (port of
``tpu_superresolution_tpu/evaluate/tiling.py``).

Tile starts are a static grid (the last tile clamps flush to the edge),
all tiles of an image stack into one batch (or fixed-size chunks of
``max_tile_batch``), and overlaps are blended with uniform weights.
Models that upsample internally tile in LR space with output scale s.
``sharded_tiled_forward`` splits the tile batch across the ranks of a
data-parallel mesh and gathers the outputs before the blend.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def tile_grid(size: int, tile: int, overlap: int) -> Tuple[int, ...]:
    """1-D tile start offsets with `overlap` shared pixels per seam; the
    last tile is clamped flush to the edge."""
    if tile >= size:
        return (0,)
    stride = tile - overlap
    if stride <= 0:
        raise ValueError(f"overlap {overlap} >= tile {tile}")
    starts = list(range(0, size - tile, stride))
    starts.append(size - tile)
    out: List[int] = []
    for s in starts:
        if not out or s > out[-1]:
            out.append(s)
    return tuple(out)


def _grid(h: int, w: int, tile: int, overlap: int):
    """(t, ys, xs): the tile clamped by the SHORT edge and the grids at
    the clamped size (else a narrow image leaves uncovered strips); the
    overlap is clamped only with the tile, so a user-supplied overlap >=
    tile still raises in tile_grid."""
    t = min(tile, h, w)
    ov = (min(overlap, t - 1) if t > 1 else 0) if t < tile else overlap
    return t, tile_grid(h, t, ov), tile_grid(w, t, ov)


def _chunked(apply_fn, batch: torch.Tensor, max_tile_batch: Optional[int]) -> torch.Tensor:
    """apply_fn over `batch` in chunks of `max_tile_batch` tiles, the last
    chunk padded by wrapping, so every model call has the same shape."""
    n = batch.shape[0]
    if max_tile_batch is None or not 0 < max_tile_batch < n:
        return apply_fn(batch)
    mtb = max_tile_batch
    pad = (-n) % mtb
    if pad:
        batch = torch.cat([batch, batch[:pad]], dim=0)
    return torch.cat([apply_fn(batch[i : i + mtb]) for i in range(0, batch.shape[0], mtb)],
                     dim=0)[:n]


def _blend(out_tiles: torch.Tensor, b: int, h: int, w: int, scale: int, t: int, ys, xs):
    """Scatter-add the tiles (image-major within each grid position) with
    uniform weights and divide by the weight map."""
    ts = t * scale
    out = torch.zeros((b, h * scale, w * scale, out_tiles.shape[-1]),
                      dtype=out_tiles.dtype, device=out_tiles.device)
    wmap = np.zeros((h * scale, w * scale, 1), np.float32)
    i = 0
    for y0 in ys:
        for x0 in xs:
            out[:, y0 * scale : y0 * scale + ts, x0 * scale : x0 * scale + ts, :] += (
                out_tiles[i * b : (i + 1) * b]
            )
            wmap[y0 * scale : y0 * scale + ts, x0 * scale : x0 * scale + ts, :] += 1.0
            i += 1
    return out / torch.from_numpy(wmap).to(device=out.device, dtype=out.dtype)[None]


def tiled_forward(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    scale: int,
    tile: int,
    overlap: int,
    max_tile_batch: Optional[int] = None,
) -> torch.Tensor:
    """apply_fn: [N, t, t, C] -> [N, t*s, t*s, C'] batched tile forward.
    x: [B, H, W, C].  Returns [B, H*s, W*s, C'] in apply_fn's dtype.

    `max_tile_batch` bounds peak device memory: the tile batch runs in
    chunks of that many tiles, the last chunk padded by wrapping, so
    every model call has the same shape.
    """
    b, h, w, _ = x.shape
    t, ys, xs = _grid(h, w, tile, overlap)
    if len(ys) == 1 and len(xs) == 1 and t >= max(h, w):
        return apply_fn(x)
    batch = torch.cat([x[:, y0 : y0 + t, x0 : x0 + t, :] for y0 in ys for x0 in xs], dim=0)
    return _blend(_chunked(apply_fn, batch, max_tile_batch), b, h, w, scale, t, ys, xs)


def sharded_tiled_forward(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    scale: int,
    tile: int,
    overlap: int,
    mesh,
    max_tile_batch: Optional[int] = None,
) -> torch.Tensor:
    """Tiled inference with the tile batch split across the ranks of
    `mesh` (``parallel.mesh.Mesh``; every rank calls it on the same `x`).

    The tile batch [nT*B, t, t, C] is padded with zero tiles to a
    multiple of the mesh size; each rank runs its contiguous shard
    (in `max_tile_batch` chunks, as ``tiled_forward``), the outputs are
    all-gathered in rank order, the dummy tiles dropped, and every rank
    blends the whole image.  Returns [B, H*s, W*s, C'] on every rank.
    """
    from tpu_superresolution_torch.parallel.mesh import all_gather_rows

    b, h, w, _ = x.shape
    t, ys, xs = _grid(h, w, tile, overlap)
    batch = torch.cat([x[:, y0 : y0 + t, x0 : x0 + t, :] for y0 in ys for x0 in xs], dim=0)
    n_tiles = batch.shape[0]
    pad = (-n_tiles) % mesh.size
    if pad:
        batch = torch.cat([batch, batch.new_zeros((pad,) + tuple(batch.shape[1:]))], dim=0)
    k = batch.shape[0] // mesh.size
    local = _chunked(apply_fn, batch[mesh.rank * k : (mesh.rank + 1) * k], max_tile_batch)
    out_tiles = all_gather_rows(local, mesh)[:n_tiles]
    return _blend(out_tiles, b, h, w, scale, t, ys, xs)
