"""Worker fleet health: per-worker state machine, circuit breaker, and
deterministic fault injection for the real dispatchers.

The paper's co-Manager "dynamically manages circuits according to the
runtime status of quantum workers"; this module is that runtime status.
Every worker carries a state in :data:`WORKER_STATES`:

    idle / busy      healthy; placeable
    probation        half-open breaker trial after the offline cooldown —
                     placeable, but one failure re-trips immediately
    offline          circuit breaker tripped (consecutive failures);
                     excluded from placement until the cooldown elapses
    draining         live-membership drain in progress: stop placing,
                     finish or migrate in-flight, then remove
    maintenance      operator-held out of rotation

plus an EWMA failure-rate signal and failure/retry/migration/hedge
counters surfaced through ``FleetHealth.snapshot()`` and
``Telemetry.summary()``.

:class:`FaultInjector` mirrors the simulation's typed fault schedules
(``repro_torch.comanager.faults``) onto the real dispatchers: crash windows
raise :class:`InjectedWorkerFault` from the dispatch path, flaky workers
drop attempts deterministically, slowdowns stretch wall-clock execution —
so the same scenario runs under the virtual clock and against real
kernels.
"""

from __future__ import annotations

import dataclasses
import threading

from repro_torch.comanager.faults import (
    FAULT_KINDS,
    FaultSpec,
    FaultToleranceConfig,
    normalize_failures,
)

WORKER_STATES = (
    "idle",
    "busy",
    "probation",
    "offline",
    "draining",
    "maintenance",
)

#: States a worker must be in to receive new placements.
_PLACEABLE = ("idle", "busy", "probation")


@dataclasses.dataclass
class WorkerVitals:
    """Mutable health record for one worker (guarded by FleetHealth's lock)."""

    state: str = "idle"
    failure_rate: float = 0.0
    consecutive_errors: int = 0
    busy_slots: int = 0
    offline_until: float = 0.0
    failures: int = 0
    successes: int = 0
    retries: int = 0
    migrations: int = 0
    hedges: int = 0
    trips: int = 0

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "failure_rate": round(self.failure_rate, 6),
            "consecutive_errors": self.consecutive_errors,
            "failures": self.failures,
            "successes": self.successes,
            "retries": self.retries,
            "migrations": self.migrations,
            "hedges": self.hedges,
            "offline_trips": self.trips,
        }


class FleetHealth:
    """Thread-safe worker health registry shared by both dispatchers."""

    def __init__(self, config: FaultToleranceConfig | None = None):
        self.config = config or FaultToleranceConfig()
        self._v: dict[str, WorkerVitals] = {}
        self._lock = threading.Lock()

    # ----------------------------------------------------------- membership
    def add(self, worker_id: str) -> None:
        with self._lock:
            self._v.setdefault(worker_id, WorkerVitals())

    def remove(self, worker_id: str) -> None:
        with self._lock:
            self._v.pop(worker_id, None)

    def workers(self) -> list[str]:
        with self._lock:
            return sorted(self._v)

    # ------------------------------------------------------------- queries
    def state(self, worker_id: str) -> str:
        with self._lock:
            v = self._v.get(worker_id)
            return v.state if v is not None else "offline"

    def placeable(self, worker_id: str, now: float) -> bool:
        """May new batches be placed on this worker?  Reading an expired
        offline window transitions it to the half-open probation state."""
        with self._lock:
            return self._placeable_locked(worker_id, now)

    def _placeable_locked(self, worker_id: str, now: float) -> bool:
        v = self._v.get(worker_id)
        if v is None:
            return False
        if v.state == "offline":
            if now >= v.offline_until:
                v.state = "probation"
                return True
            return False
        return v.state in _PLACEABLE

    def unplaceable(self, now: float) -> set[str]:
        """Workers to exclude from ``CoManager.assign`` this cycle."""
        with self._lock:
            return {
                w for w in self._v if not self._placeable_locked(w, now)
            }

    def retryable(self, worker_id: str, now: float) -> bool:
        """May a failed batch be retried in place on this worker?  Tripped
        or draining workers are not worth retrying — migrate instead."""
        with self._lock:
            v = self._v.get(worker_id)
            return v is not None and v.state in _PLACEABLE

    # ------------------------------------------------------------ outcomes
    def on_dispatch(self, worker_id: str) -> None:
        with self._lock:
            v = self._v.get(worker_id)
            if v is None:
                return
            v.busy_slots += 1
            if v.state == "idle":
                v.state = "busy"

    def on_release(self, worker_id: str) -> None:
        """One launch landed (success, terminal failure, or migration)."""
        with self._lock:
            v = self._v.get(worker_id)
            if v is None:
                return
            v.busy_slots = max(0, v.busy_slots - 1)
            if v.state == "busy" and v.busy_slots == 0:
                v.state = "idle"

    def on_success(self, worker_id: str) -> None:
        with self._lock:
            v = self._v.get(worker_id)
            if v is None:
                return
            alpha = self.config.failure_alpha
            v.successes += 1
            v.consecutive_errors = 0
            v.failure_rate *= 1.0 - alpha
            if v.state in ("probation", "offline"):
                # half-open trial passed: close the breaker
                v.state = "busy" if v.busy_slots else "idle"

    def on_failure(self, worker_id: str, now: float) -> bool:
        """Record one failed attempt; returns True when this failure trips
        the circuit breaker (worker just went offline)."""
        with self._lock:
            v = self._v.get(worker_id)
            if v is None:
                return False
            alpha = self.config.failure_alpha
            v.failures += 1
            v.consecutive_errors += 1
            v.failure_rate = v.failure_rate * (1.0 - alpha) + alpha
            if v.state in ("draining", "maintenance", "offline"):
                return False
            trip = (
                v.state == "probation"  # half-open trial failed: re-trip
                or v.consecutive_errors >= self.config.breaker_threshold
            )
            if trip:
                v.state = "offline"
                v.offline_until = now + self.config.breaker_cooldown_s
                v.trips += 1
            return trip

    def record_retry(self, worker_id: str) -> None:
        with self._lock:
            v = self._v.get(worker_id)
            if v is not None:
                v.retries += 1

    def record_migration(self, worker_id: str) -> None:
        with self._lock:
            v = self._v.get(worker_id)
            if v is not None:
                v.migrations += 1

    def record_hedge(self, worker_id: str) -> None:
        with self._lock:
            v = self._v.get(worker_id)
            if v is not None:
                v.hedges += 1

    # -------------------------------------------------------- state control
    def mark_draining(self, worker_id: str) -> None:
        with self._lock:
            v = self._v.get(worker_id)
            if v is not None:
                v.state = "draining"

    def mark_maintenance(self, worker_id: str) -> None:
        with self._lock:
            v = self._v.get(worker_id)
            if v is not None:
                v.state = "maintenance"

    def reactivate(self, worker_id: str) -> None:
        """Return a drained/maintenance/offline worker to rotation."""
        with self._lock:
            v = self._v.get(worker_id)
            if v is not None:
                v.state = "busy" if v.busy_slots else "idle"
                v.consecutive_errors = 0
                v.offline_until = 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {w: v.snapshot() for w, v in sorted(self._v.items())}


class InjectedWorkerFault(RuntimeError):
    """Raised by :class:`FaultInjector` in place of a real worker failure."""


class FaultInjector:
    """Deterministic fault schedule applied to the real dispatchers.

    Takes the same ``worker_failures`` map as ``SystemSimulation`` (legacy
    crash floats, dicts, or :class:`FaultSpec`).  Schedule times are
    relative to the dispatcher's start: the owning dispatcher calls
    :meth:`start` with its clock at construction, and :meth:`check` raises
    :class:`InjectedWorkerFault` whenever a dispatch lands in an open
    crash window or draws a flaky drop."""

    def __init__(self, worker_failures):
        self.schedule: dict[str, FaultSpec] = normalize_failures(worker_failures)
        self._t0: float | None = None
        self._attempts: dict[str, int] = {}
        self._lock = threading.Lock()

    def start(self, now: float) -> None:
        """Pin the schedule's t=0 to the dispatcher clock (first call wins)."""
        with self._lock:
            if self._t0 is None:
                self._t0 = now

    def _rel(self, now: float) -> float:
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            return now - self._t0

    def check(self, worker_id: str, now: float) -> None:
        """Called on the dispatch path immediately before kernel execution."""
        spec = self.schedule.get(worker_id)
        if spec is None:
            return
        t = self._rel(now)
        if spec.crashed(t):
            raise InjectedWorkerFault(
                f"injected {spec.kind} on worker {worker_id} at t={t:.3f}s"
            )
        if spec.kind == "flaky":
            with self._lock:
                attempt = self._attempts.get(worker_id, 0)
                self._attempts[worker_id] = attempt + 1
            if spec.drops(0, attempt, t):
                raise InjectedWorkerFault(
                    f"injected flaky drop on worker {worker_id} "
                    f"(attempt {attempt}, p={spec.p})"
                )

    def slowdown_factor(self, worker_id: str, now: float) -> float:
        spec = self.schedule.get(worker_id)
        if spec is None:
            return 1.0
        return spec.slowdown_factor(self._rel(now))


__all__ = [
    "FAULT_KINDS",
    "FaultInjector",
    "FaultSpec",
    "FaultToleranceConfig",
    "FleetHealth",
    "InjectedWorkerFault",
    "WORKER_STATES",
    "WorkerVitals",
]
