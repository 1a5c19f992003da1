"""repro_torch.obs — tracing + metrics for the multi-tenant serving stack.

One recorder serves both runtimes (virtual-clock simulation and real
kernel dispatchers) because every clock in the stack is a caller-supplied
float.  See ``trace.TraceRecorder`` for the hook surface and
``histogram.LogHistogram`` for the fixed-memory aggregation primitive.
"""
from repro_torch.obs.config import (
    FEDERATED_STAGES,
    LIFECYCLE_STAGES,
    RECOVERY_STAGES,
    ObservabilityConfig,
)
from repro_torch.obs.histogram import LogHistogram
from repro_torch.obs.trace import (
    OUTCOMES,
    STAGE_METRICS,
    CircuitTrace,
    RoundEvent,
    TraceBuffer,
    TraceRecorder,
    WorkerSpan,
    WorkerTimeline,
    validate_trace,
)

__all__ = [
    "FEDERATED_STAGES",
    "LIFECYCLE_STAGES",
    "OUTCOMES",
    "RECOVERY_STAGES",
    "STAGE_METRICS",
    "CircuitTrace",
    "LogHistogram",
    "ObservabilityConfig",
    "RoundEvent",
    "TraceBuffer",
    "TraceRecorder",
    "WorkerSpan",
    "WorkerTimeline",
    "validate_trace",
]
