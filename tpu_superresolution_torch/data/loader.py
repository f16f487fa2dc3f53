"""Threaded prefetching host loader (port of
``tpu_superresolution_tpu/data/loader.py`` without its native C++
decoder and decoded-image cache, which are still to port): a thread pool
decodes PNGs with PIL into float32 numpy batches while the device steps,
with a bounded prefetch queue.  Shuffling is seeded per epoch, and the
optional host crop draws its offsets from a per-batch seed, both as the
JAX package does, so the two loaders yield the same batches."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np

from tpu_superresolution_torch.data.decode import load_pair_batch
from tpu_superresolution_torch.data.index import PairedIndex


class Loader:
    def __init__(self, index: PairedIndex, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, grayscale: bool = True, channels: int = 1,
                 seed: int = 42, num_threads: int = 8, prefetch: int = 2,
                 host_crop_hr: Optional[int] = None, host_crop_scale: int = 1):
        """`host_crop_hr`: crop random scale-aligned patches on the host
        (HR patch of this size, LR patch of size / scale at offset /
        scale) before the upload, so a step moves crop-sized batches."""
        self.index = index
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.grayscale = grayscale
        self.channels = channels
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.host_crop_hr = host_crop_hr
        self.host_crop_scale = max(1, host_crop_scale)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.index)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batch_indices(self):
        n = len(self.index)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        batches = [order[i : i + self.batch_size] for i in range(0, n, self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        return batches

    def _crop(self, batch, batch_seed: int):
        lr, hr = batch
        p, s = self.host_crop_hr, self.host_crop_scale
        hh, hw = hr.shape[1], hr.shape[2]
        if p is None or (hh <= p and hw <= p):
            return batch
        ph, pw = min(p, hh - hh % s), min(p, hw - hw % s)
        rng = np.random.default_rng(batch_seed)
        tops = rng.integers(0, (hh - ph) // s + 1, size=lr.shape[0]) * s
        lefts = rng.integers(0, (hw - pw) // s + 1, size=lr.shape[0]) * s
        lr_c = np.stack([lr[i, t // s : (t + ph) // s, l // s : (l + pw) // s]
                         for i, (t, l) in enumerate(zip(tops, lefts))])
        hr_c = np.stack([hr[i, t : t + ph, l : l + pw] for i, (t, l) in enumerate(zip(tops, lefts))])
        return lr_c, hr_c

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        batches = self._batch_indices()
        epoch = self._epoch
        self._epoch += 1

        def load(bi, idxs):
            batch = load_pair_batch([self.index[i] for i in idxs], self.grayscale, self.channels)
            return self._crop(batch, (self.seed * 1_000_003 + epoch * 10_007 + bi) & 0x7FFFFFFF)

        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            it = iter(enumerate(batches))
            futures = [pool.submit(load, *nb) for nb in
                       (next(it, None) for _ in range(self.prefetch)) if nb is not None]
            while futures:
                fut = futures.pop(0)
                nb = next(it, None)
                if nb is not None:
                    futures.append(pool.submit(load, *nb))
                yield fut.result()
