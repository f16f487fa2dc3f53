"""Chrome-trace (Trace Event Format) recorder: a host-side timeline of
named spans and counters, loadable in Perfetto or chrome://tracing
(port of ``tpu_superresolution_tpu/utils/trace.py``, the same events).

The train engine emits per-epoch train / val spans and loss / PSNR
counter tracks when ``Trainer(trace_path=...)`` is set (``--trace`` on
the train and finetune CLIs).  The device-side profile is
``utils.profiling.trace_context`` (torch.profiler).

Format: the Trace Event Format's "X" (complete span), "C" (counter),
"i" (instant) and "M" (track name metadata) events, which every viewer
supports; string tracks become integer tids at ``save``.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["TraceRecorder"]


def _args(args: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in args.items() if v is not None}


@dataclass
class TraceRecorder:
    """Collects host-side spans / counters; ``save()`` writes chrome-trace
    JSON.  All timestamps are microseconds relative to construction, so
    traces from different runs align at t=0."""

    events: List[Dict[str, Any]] = field(default_factory=list)
    _t0: float = field(default_factory=time.perf_counter)

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, track: str = "main", **args):
        """Context manager emitting one complete ("X") event."""
        ts = self._now_us()
        try:
            yield
        finally:
            self.events.append({"name": name, "ph": "X", "ts": ts, "dur": self._now_us() - ts,
                                "pid": 0, "tid": track, "args": _args(args)})

    def complete(self, name: str, start_s: float, dur_s: float, track: str = "main", **args):
        """Record an already-measured span (seconds relative to the
        recorder's epoch), for callers that keep their own timers."""
        self.events.append({"name": name, "ph": "X", "ts": start_s * 1e6, "dur": dur_s * 1e6,
                            "pid": 0, "tid": track, "args": _args(args)})

    def counter(self, name: str, value: float, ts_us: Optional[float] = None):
        self.events.append({"name": name, "ph": "C",
                            "ts": self._now_us() if ts_us is None else ts_us, "pid": 0,
                            "args": {name: value}})

    def instant(self, name: str, track: str = "main", **args):
        self.events.append({"name": name, "ph": "i", "ts": self._now_us(), "pid": 0,
                            "tid": track, "s": "t", "args": args})

    @property
    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0

    def save(self, path: str):
        """Write Trace Event Format JSON (object form, so metadata can
        ride along): string tracks mapped onto stable integer tids, each
        named by a "thread_name" metadata event."""
        tids: Dict[str, int] = {}
        out, meta = [], []
        for e in self.events:
            e = dict(e)
            tid = e.get("tid", "main")
            if isinstance(tid, str):
                if tid not in tids:
                    tids[tid] = len(tids)
                    meta.append({"name": "thread_name", "ph": "M", "pid": 0, "tid": tids[tid],
                                 "args": {"name": tid}})
                e["tid"] = tids[tid]
            out.append(e)
        with open(path, "w") as f:
            json.dump({"traceEvents": meta + out, "displayTimeUnit": "ms"}, f)
