"""Interleaved A/B timing harness (port of
``tpu_superresolution_tpu/utils/ablate.py``).

- **interleaved rounds**: candidates run A, B, C, A, B, C, ... within ONE
  process, `rounds` times, so that the host's and the card's drift
  (clocks, power, other tenants) falls on every candidate alike; never
  A/B two variants a few percent apart from separate runs or
  back-to-back blocks;
- **repetition**: each round times `inner` back-to-back calls of a
  candidate and reports the time a call: on CUDA between a pair of CUDA
  events around the calls (after one warm-up call of each candidate, and
  a ``torch.cuda.synchronize()`` between candidates), on the CPU by
  ``time.perf_counter``;
- per-candidate min / median over rounds (min is the contention-free
  estimate; median guards against a lucky outlier) and the spread.

The JAX module runs each candidate inside a ``lax.fori_loop`` whose
carry feeds the next iteration's input, so that XLA cannot hoist the
loop-invariant work out of the loop.  Eager torch hoists nothing: each
call is dispatched and runs, so the calls here are plain repeats and
the thunks take no argument.

Back-to-back calls of a small kernel measure the host's dispatch as
much as the card: a `min_s` from a round shorter than about 1 ms
(``inner`` times the call) is not a kernel's time, and a `spread` over
0.1 says to rerun with more rounds before trusting a close comparison.

Usage::

    from tpu_superresolution_torch.utils.ablate import ablate, report

    results = ablate({"plain": lambda: f_plain(x), "kernel": lambda: f_kernel(x)},
                     inner=50, rounds=5)
    print(report(results))
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping

import torch


@dataclass
class AblateResult:
    times_s: List[float] = field(default_factory=list)

    @property
    def min_s(self) -> float:
        return min(self.times_s)

    @property
    def median_s(self) -> float:
        s = sorted(self.times_s)
        return s[len(s) // 2]

    @property
    def spread(self) -> float:
        """(max - min) / min over rounds: > 0.1 means rerun with more
        rounds before trusting a close comparison."""
        return (max(self.times_s) - min(self.times_s)) / max(self.min_s, 1e-12)


def _timer(cuda: bool):
    """A function running `fn` `inner` times and returning the seconds a
    call: CUDA events on the card, ``time.perf_counter`` on the CPU."""
    if cuda:
        def run(fn, inner):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / inner
    else:
        def run(fn, inner):
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            return (time.perf_counter() - t0) / inner
    return run


def ablate(candidates: Mapping[str, Callable[[], object]], inner: int = 50, rounds: int = 5,
           warmup: int = 1, verbose: bool = False, cuda: bool = None) -> Dict[str, AblateResult]:
    """Time each argless candidate, interleaved.  Returns {name:
    AblateResult} whose ``times_s`` are seconds a call (a round's time /
    inner).  Every candidate is called `warmup` times first (builds,
    plans, caches); `cuda` (default: whether a GPU is present) picks the
    CUDA-event timer."""
    cuda = torch.cuda.is_available() if cuda is None else cuda
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    timed = _timer(cuda)
    for _ in range(warmup):
        for fn in candidates.values():
            fn()
    sync()
    results = {name: AblateResult() for name in candidates}
    for r in range(rounds):
        for name, fn in candidates.items():
            dt = timed(fn, inner)
            sync()
            results[name].times_s.append(dt)
            if verbose:
                print(f"[ablate] round {r} {name}: {dt * 1e3:.3f} ms", flush=True)
    return results


def report(results: Dict[str, AblateResult]) -> str:
    """Human-readable table, fastest first, with x-vs-best ratios."""
    rows = sorted(results.items(), key=lambda kv: kv[1].min_s)
    best = rows[0][1].min_s
    lines = [f"{'name':24s} {'min ms':>10s} {'median ms':>10s} {'vs best':>8s} {'spread':>7s}"]
    for name, r in rows:
        lines.append(f"{name:24s} {r.min_s * 1e3:10.3f} {r.median_s * 1e3:10.3f} "
                     f"{r.min_s / best:8.2f} {r.spread:7.1%}")
    return "\n".join(lines)
