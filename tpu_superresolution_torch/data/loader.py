"""Threaded prefetching host loader (port of
``tpu_superresolution_tpu/data/loader.py``): a thread pool decodes PNGs
into float32 numpy batches while the device steps, with a bounded
prefetch queue.

- The decoder: the native C++ one (``data/native_decode.py``) when
  `use_native` is "auto" and it is available and the dataset is PNG
  (sizes probed from the first pair), else PIL; "never" takes PIL,
  "always" raises where the native one cannot run.  A batch the native
  decoder refuses (a file of another size, an odd file) is decoded by
  PIL.  The loader says on stdout, once, which decoder it uses.
- The decoded-image cache (`cache_decoded`): each image decoded once,
  kept as uint16 ``x * 65535 + 0.5`` up to `cache_limit_gb`, so epochs
  after the first replay quantized pixels from RAM (and images past the
  limit are decoded each time).
- Shuffling is seeded per epoch, and the optional host crop draws its
  offsets from a per-batch seed, both as the JAX package does, so the
  two loaders yield the same batches.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np

from tpu_superresolution_torch.data import native_decode
from tpu_superresolution_torch.data.decode import load_pair_batch
from tpu_superresolution_torch.data.index import PairedIndex


class Loader:
    def __init__(self, index: PairedIndex, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, grayscale: bool = True, channels: int = 1,
                 seed: int = 42, num_threads: int = 8, prefetch: int = 2,
                 host_crop_hr: Optional[int] = None, host_crop_scale: int = 1,
                 use_native: str = "auto", cache_decoded: bool = False,
                 cache_limit_gb: float = 4.0):
        """`host_crop_hr`: crop random scale-aligned patches on the host
        (HR patch of this size, LR patch of size / scale at offset /
        scale) before the upload, so a step moves crop-sized batches."""
        if use_native not in ("auto", "never", "always"):
            raise ValueError(f"use_native must be 'auto', 'never' or 'always', got {use_native!r}")
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
        self.cache_decoded = cache_decoded
        self._cache: dict = {}
        self._cache_bytes = 0
        self._cache_limit = int(cache_limit_gb * (1 << 30))
        self._lock = threading.Lock()
        self._fallback_said = False
        self._native_sizes = None  # ((lr_h, lr_w), (hr_h, hr_w)) when native decode is on
        if use_native != "never":
            self._try_enable_native(require=use_native == "always")

    def __len__(self) -> int:
        n = len(self.index)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def decoder(self) -> str:
        return "native" if self._native_sizes is not None else "PIL"

    def _try_enable_native(self, require: bool) -> None:
        """Native decode when the library runs here and the first pair is
        PNG; its sizes are probed from that pair."""
        lr0, hr0 = self.index[0]
        why = native_decode.unavailable_reason()
        if why is None and not (str(lr0).lower().endswith(".png")
                                and str(hr0).lower().endswith(".png")):
            why = "the dataset is not PNG"
        if why is not None:
            if require:
                raise RuntimeError(f"native decoder requested but unavailable: {why}")
            print(f"[data] native decoder: unavailable ({why}); decoding with PIL", flush=True)
            return
        lh, lw, _, _ = native_decode.probe(lr0)
        hh, hw, _, _ = native_decode.probe(hr0)
        self._native_sizes = ((lh, lw), (hh, hw))
        print(f"[data] native decoder: {native_decode.loaded_path()} (LR {lh}x{lw}, HR "
              f"{hh}x{hw})", flush=True)

    def _load_pairs(self, pairs):
        """Decode [(lr_path, hr_path), ...] natively when on, else (or when
        the native decoder refuses the batch) with PIL."""
        if self._native_sizes is not None:
            (lh, lw), (hh, hw) = self._native_sizes
            try:
                lr = native_decode.decode_batch_native([p[0] for p in pairs], lh, lw,
                                                       self.grayscale, self.channels)
                hr = native_decode.decode_batch_native([p[1] for p in pairs], hh, hw,
                                                       self.grayscale, self.channels)
                return lr, hr
            except IOError as e:  # another size, an odd file
                with self._lock:
                    said, self._fallback_said = self._fallback_said, True
                if not said:
                    print(f"[data] {e}: such batches are decoded with PIL", flush=True)
        return load_pair_batch(pairs, self.grayscale, self.channels)

    def _load(self, idxs):
        """One batch, through the decoded-image cache when it is on."""
        if not self.cache_decoded:
            return self._load_pairs([self.index[i] for i in idxs])
        with self._lock:
            missing = [i for i in idxs if i not in self._cache]
        fresh = None
        if missing:
            lr_m, hr_m = fresh = self._load_pairs([self.index[i] for i in missing])
            for j, i in enumerate(missing):
                entry = ((lr_m[j] * 65535.0 + 0.5).astype(np.uint16),
                         (hr_m[j] * 65535.0 + 0.5).astype(np.uint16))
                sz = entry[0].nbytes + entry[1].nbytes
                with self._lock:
                    if i not in self._cache and self._cache_bytes + sz <= self._cache_limit:
                        self._cache[i] = entry
                        self._cache_bytes += sz
        with self._lock:
            hit = all(i in self._cache for i in idxs)
            entries = [self._cache[i] for i in idxs] if hit else None
        if not hit:  # the cache is full: the batch as decoded, not quantized
            if len(missing) == len(idxs):
                return fresh
            return self._load_pairs([self.index[i] for i in idxs])
        lr = np.stack([e[0] for e in entries]).astype(np.float32) / 65535.0
        hr = np.stack([e[1] for e in entries]).astype(np.float32) / 65535.0
        return lr, hr

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
            batch = self._load(idxs)
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
