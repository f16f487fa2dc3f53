"""Tagged stdout logging, following the reference's [tag] convention
([cfg] [device] [profile] [val] [ckpt] [sched] [time] [plot] [baseline]
[peek] [save] [done] — e.g. train.py:220,223,376-381).  Port of
``tpu_superresolution_tpu/utils/logging.py``."""

from __future__ import annotations

import sys
import time
from typing import Optional, TextIO


class TagLogger:
    def __init__(self, stream: Optional[TextIO] = None, with_time: bool = False):
        self.stream = stream or sys.stdout
        self.with_time = with_time
        self._t0 = time.time()

    def __call__(self, message: str, tag: Optional[str] = None):
        prefix = f"[{tag}] " if tag else ""
        ts = f"{time.time() - self._t0:8.1f}s " if self.with_time else ""
        print(f"{ts}{prefix}{message}", file=self.stream, flush=True)

    def tagged(self, tag: str):
        return lambda msg: self(msg, tag)
