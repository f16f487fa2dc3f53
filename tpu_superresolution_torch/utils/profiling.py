"""Profiling utilities (port of ``tpu_superresolution_tpu/utils/profiling.py``;
the reference's wall-clock timers, train.py:98-135 data/step split,
warmup_profile :79-86, eval throughput evaluate.py:149,229-233).

- ``trace_context``: a torch.profiler trace around a code region, written
  as a chrome trace into a directory (CUDA activity recorded on a GPU).
- ``StepTimer``: host-side data-time vs step-time accounting with the same
  split the reference reports per epoch.
- ``device_memory_stats``: live device memory per GPU.
- ``device_split``: one call of a function under torch.profiler, its
  device kernels, busy time and wall time, and ``DeviceSplit.group`` to
  sum the kernels' device time by name or by the profiler range they ran
  in (the "where the time goes" lines of ``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@contextlib.contextmanager
def trace_context(logdir: Optional[str]):
    """Profile the enclosed region with torch.profiler (CPU activity, and
    CUDA activity when a GPU is present) and write a chrome trace
    ``trace_<pid>.json`` into `logdir`; a no-op when `logdir` is None."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))


@dataclass
class StepTimer:
    """Accumulates data-load vs device-step time per epoch."""

    data_t: float = 0.0
    step_t: float = 0.0
    n: int = 0
    _mark: float = field(default_factory=time.perf_counter)

    def batch_loaded(self):
        now = time.perf_counter()
        self.data_t += now - self._mark
        self._mark = now

    def step_done(self):
        now = time.perf_counter()
        self.step_t += now - self._mark
        self._mark = now
        self.n += 1

    @property
    def mean_data_t(self) -> float:
        return self.data_t / max(1, self.n)

    @property
    def mean_step_t(self) -> float:
        return self.step_t / max(1, self.n)

    def reset(self):
        self.data_t = self.step_t = 0.0
        self.n = 0
        self._mark = time.perf_counter()


def device_memory_stats() -> List[Dict]:
    """Per-GPU memory (bytes): ``bytes_in_use`` as the caching allocator
    counts it, ``bytes_limit`` the device's total; empty without a GPU."""
    import torch

    out = []
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        _, total = torch.cuda.mem_get_info(i)
        stats = torch.cuda.memory_stats(i)
        out.append({"device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
                    "bytes_in_use": stats.get("allocated_bytes.all.current"),
                    "bytes_limit": total})
    return out


def kernel_ms(e) -> float:
    """A profiler event's device time in milliseconds."""
    return (getattr(e, "device_time", 0.0) or getattr(e, "cuda_time", 0.0)) / 1e3


def device_kernels(prof) -> list:
    """The profile's kernels on the card (not the user-annotation ranges
    that the profiler also places on the device timeline)."""
    import torch

    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


@dataclass
class DeviceSplit:
    """One profiled call: `wall_ms` (the call and a synchronise, profiler
    on), its device `kernels` in start order and every profiler
    `events` entry (host ranges too, where the call profiled the host)."""

    wall_ms: float
    kernels: list
    events: list

    @property
    def busy_ms(self) -> float:
        return sum(kernel_ms(e) for e in self.kernels)

    def by_name(self) -> Dict[str, Tuple[int, float]]:
        """{kernel name: (launches, device ms)}."""
        out: Dict[str, Tuple[int, float]] = {}
        for e in self.kernels:
            n, t = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, t + kernel_ms(e))
        return out

    def ranges(self, names: Sequence[str], on_device: bool = True) -> List[Tuple]:
        """(start, end, name) of the profiler ranges named in `names`: their
        device-side spans (user annotations), or with `on_device` False
        their host-side spans."""
        import torch

        dev = torch.autograd.DeviceType.CUDA if on_device else torch.autograd.DeviceType.CPU
        return [(e.time_range.start, e.time_range.end, e.name) for e in self.events
                if e.device_type == dev and e.name in names
                and (not on_device or getattr(e, "is_user_annotation", False))]

    def group(self, names: Sequence[Tuple[str, Sequence[str]]], other: str,
              spans: Sequence[Tuple] = (), by_span: Sequence[Tuple[str, str]] = ()
              ) -> Dict[str, float]:
        """Device ms by group, in the order given: a kernel goes to the
        first of `names` ((group, substrings)) whose substring is in its
        name, else to the group of the first `by_span` (range name,
        group) whose range of `spans` holds its start, else to `other`."""
        groups = dict.fromkeys([g for g, _ in names] + [g for _, g in by_span] + [other], 0.0)
        for e in self.kernels:
            g = next((g for g, keys in names if any(k in e.name for k in keys)), None)
            if g is None and by_span:
                t = e.time_range.start
                inside = {name for a, b, name in spans if a <= t <= b}
                g = next((g for span, g in by_span if span in inside), None)
            groups[g or other] += kernel_ms(e)
        return groups


def device_split(fn, host: bool = False) -> DeviceSplit:
    """Run `fn()` once under torch.profiler (CUDA activity; with `host`,
    CPU activity too, for host ranges and autograd nodes), synchronise,
    and return its ``DeviceSplit``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted(device_kernels(prof), key=lambda e: e.time_range.start)
    return DeviceSplit(wall_ms=wall, kernels=kernels, events=list(prof.events()))
