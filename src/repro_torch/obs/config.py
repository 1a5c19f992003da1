"""Typed configuration for the observability layer.

``ObservabilityConfig`` travels inside ``ServingConfig`` / ``SimulationConfig``
(repro_torch.api) down to the ``Telemetry`` object every gateway owns, so one
dataclass controls tracing across the real dispatchers and the virtual-clock
simulation alike.  Validation happens at construction — a bad sampling rate
fails where it is written, not deep inside the serving hot path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

#: per-circuit lifecycle stages, in pipeline order.  ``submit`` opens the
#: trace; the terminal transition (complete / evict / fail / reject) closes
#: it and is always recorded for open traces regardless of stage filtering.
#: The recovery stages (retried / hedged / worker_offline / migrated /
#: requeue) revisit earlier pipeline stages by design — ``validate_trace``
#: relaxes its pipeline-order check for traces that contain them.
LIFECYCLE_STAGES = (
    "submit",
    "admit",
    "coalesced",
    "placed",
    "dispatched",
    "kernel_start",
    "retried",
    "hedged",
    "worker_offline",
    "migrated",
    "requeue",
)

#: stages recorded only on the failure-recovery path: their presence means
#: the circuit legitimately revisited earlier pipeline stages.
RECOVERY_STAGES = frozenset(
    {"retried", "hedged", "worker_offline", "migrated", "requeue"}
)

#: federated-round lifecycle stages (``repro_torch.federated``): these are
#: ROUND-level events recorded via ``TraceRecorder.round_event`` — one per
#: aggregation-round transition, not per circuit — so they never appear
#: inside a ``CircuitTrace`` and are exempt from the pipeline-order check.
FEDERATED_STAGES = (
    "round_start",
    "update_received",
    "update_late",
    "round_aggregated",
)


@dataclasses.dataclass(frozen=True)
class ObservabilityConfig:
    """Tracing + metrics knobs.

    ``enabled``: master switch — False makes every recorder hook a cheap
    no-op (the sampling=0 fast path the gateway benchmark pins).
    ``sample_rate``: fraction of circuits that get a full lifecycle trace
    record (deterministic hash of the admission sequence number, so virtual
    -clock traces are reproducible); histograms and worker timelines are
    O(1) memory and always on while enabled.  ``buffer_size``: ring-buffer
    capacity for finished trace records and worker spans — memory stays
    bounded at millions of circuits.  ``stages``: optional subset of
    ``LIFECYCLE_STAGES`` to record (None = all).
    """

    enabled: bool = True
    sample_rate: float = 1.0
    buffer_size: int = 65536
    stages: Optional[tuple[str, ...]] = None

    def __post_init__(self):
        if not 0.0 <= self.sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in [0, 1], got {self.sample_rate}"
            )
        if self.buffer_size < 1:
            raise ValueError(
                f"buffer_size must be >= 1, got {self.buffer_size}"
            )
        if self.stages is not None:
            if not isinstance(self.stages, tuple):
                object.__setattr__(self, "stages", tuple(self.stages))
            valid = set(LIFECYCLE_STAGES) | set(FEDERATED_STAGES)
            unknown = sorted(set(self.stages) - valid)
            if unknown:
                raise ValueError(
                    f"unknown stage(s) {unknown}; valid stages: "
                    f"{list(LIFECYCLE_STAGES) + list(FEDERATED_STAGES)}"
                )

    @classmethod
    def disabled(cls) -> "ObservabilityConfig":
        return cls(enabled=False, sample_rate=0.0)


__all__ = [
    "FEDERATED_STAGES",
    "LIFECYCLE_STAGES",
    "RECOVERY_STAGES",
    "ObservabilityConfig",
]
