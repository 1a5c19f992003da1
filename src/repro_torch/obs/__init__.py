"""repro_torch.obs — tracing + metrics for the multi-tenant serving stack
and the training step.

One recorder serves both runtimes (virtual-clock simulation and real
kernel dispatchers) because every clock in the stack is a caller-supplied
float.  See ``trace.TraceRecorder`` for the hook surface and
``histogram.LogHistogram`` for the fixed-memory aggregation primitive.
``set_recorder`` installs a recorder for the program's host spans
(``span``), which the training step opens at its layer boundaries.
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
    RANGE_PREFIX,
    STAGE_METRICS,
    CircuitTrace,
    HostSpan,
    RoundEvent,
    TraceBuffer,
    TraceRecorder,
    WorkerSpan,
    WorkerTimeline,
    set_recorder,
    span,
    validate_trace,
)

__all__ = [
    "FEDERATED_STAGES",
    "LIFECYCLE_STAGES",
    "OUTCOMES",
    "RANGE_PREFIX",
    "RECOVERY_STAGES",
    "STAGE_METRICS",
    "CircuitTrace",
    "HostSpan",
    "LogHistogram",
    "ObservabilityConfig",
    "RoundEvent",
    "TraceBuffer",
    "TraceRecorder",
    "WorkerSpan",
    "WorkerTimeline",
    "set_recorder",
    "span",
    "validate_trace",
]
