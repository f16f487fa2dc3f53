"""Logging, tracing, profiling, FLOP counting and A/B timing (port of
``tpu_superresolution_tpu/utils``)."""

from .ablate import AblateResult, ablate, report
from .flops import PEAK_BF16_FLOPS, mfu, model_flops, torch_flops
from .logging import TagLogger
from .profiling import DeviceSplit, StepTimer, device_memory_stats, device_split, trace_context
from .trace import TraceRecorder

__all__ = [
    "StepTimer",
    "trace_context",
    "device_memory_stats",
    "TagLogger",
    "TraceRecorder",
    "DeviceSplit",
    "device_split",
    "PEAK_BF16_FLOPS",
    "model_flops",
    "torch_flops",
    "mfu",
    "AblateResult",
    "ablate",
    "report",
]
