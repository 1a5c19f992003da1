"""Serving-gateway telemetry.

Tracks, per tenant: submission/completion counts, rejected (backpressured)
submissions, end-to-end circuit latency (submit -> fidelity delivered), and
SLO attainment (completions within the tenant's registered deadline);
and, per coalesced batch: occupancy against the lane-padded kernel shape.

``ServiceModel`` is the EWMA per-spec service-time estimator: the dispatcher
reports each executed batch's measured wall time together with its analytic
work units (gate applications x padded lanes), and the model's estimates
feed the co-Manager's CRU cost model — a worker's classical-resource usage
rises by the *predicted* seconds of the batches queued on it, so Algorithm 2
steers new mega-batches toward the worker with the least outstanding work,
not just the fewest resident circuits.

``lane_fill`` is the headline packing metric: of the kernel lanes the data
plane actually paid for (batches are padded up to a multiple of ``LANES``),
what fraction carried a real client circuit?  1.0 = every lane useful;
a gateway flushing mostly-empty deadline batches under light load trends
toward ``1 / LANES``.

All clocks are caller-supplied floats (virtual seconds in the simulation,
``time.perf_counter()`` seconds in the real data plane), so the same
telemetry object serves both runtimes.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Hashable, Optional

from repro_torch.obs.config import ObservabilityConfig
from repro_torch.obs.histogram import LogHistogram
from repro_torch.obs.trace import TraceRecorder, _key_str


@dataclasses.dataclass
class TenantStats:
    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    #: circuits preemptively evicted after their SLO budget fully elapsed
    #: while waiting for placement (each also counts as an SLO miss).
    evicted: int = 0
    first_submit: float = float("inf")
    last_complete: float = 0.0
    #: streaming end-to-end latency histogram — O(1) memory per tenant no
    #: matter how many circuits complete (percentiles within one bucket
    #: width, i.e. a 1.25x relative factor, of exact).
    latencies: LogHistogram = dataclasses.field(default_factory=LogHistogram)
    #: end-to-end latency SLO in seconds (None = best-effort tenant).
    slo_s: float | None = None
    slo_misses: int = 0
    #: federated participation counters (repro_torch.federated): updates that
    #: made a round's quorum, arrived after the deadline (folded or not),
    #: and updates dropped entirely (staleness limit / crashed tenant).
    fed_participated: int = 0
    fed_late: int = 0
    fed_dropped: int = 0

    @property
    def circuits_per_second(self) -> float:
        span = self.last_complete - self.first_submit
        return self.completed / max(span, 1e-9)

    @property
    def slo_attainment(self) -> float | None:
        """Fraction of resolved circuits delivered within the SLO (None: no
        SLO).  Evicted circuits resolved with an error still count against
        attainment — they were admitted and missed."""
        if self.slo_s is None:
            return None
        return 1.0 - self.slo_misses / max(self.completed + self.evicted, 1)

    def latency_percentile(self, q: float) -> float:
        return self.latencies.percentile(q)


class ServiceModel:
    """EWMA seconds-per-work-unit, keyed by batch family (the CircuitSpec or
    shift-group spec): ``estimate`` = ewma[key] * units, falling back to a
    global ewma (then ``default_s``) for keys never executed.  Thread-safe:
    the async dispatcher updates it from worker-pool threads."""

    def __init__(self, alpha: float = 0.25, default_s: float = 1.0):
        self.alpha = alpha
        self.default_s = default_s
        self._per_key: dict[Hashable, float] = {}
        self._updates: dict[Hashable, int] = {}
        self._global: float | None = None
        # EWMA of |predicted - measured| / measured per update, so placement
        # cost-model drift is visible in Telemetry.summary() instead of
        # silently steering Algorithm-2 decisions.
        self._rel_error: float | None = None
        self._lock = threading.Lock()

    def update(self, key: Hashable, units: float, seconds: float) -> None:
        if units <= 0 or seconds < 0:
            return
        per_unit = seconds / units
        with self._lock:
            old = self._per_key.get(key)
            if old is not None and seconds > 0:
                rel = abs(old * units - seconds) / seconds
                self._rel_error = (
                    rel
                    if self._rel_error is None
                    else self.alpha * rel + (1 - self.alpha) * self._rel_error
                )
            self._per_key[key] = (
                per_unit
                if old is None
                else self.alpha * per_unit + (1 - self.alpha) * old
            )
            self._updates[key] = self._updates.get(key, 0) + 1
            self._global = (
                per_unit
                if self._global is None
                else self.alpha * per_unit + (1 - self.alpha) * self._global
            )

    def estimate(self, key: Hashable, units: float) -> float:
        with self._lock:
            per_unit = self._per_key.get(key, self._global)
        if per_unit is None:
            return self.default_s
        return per_unit * units

    def snapshot(self) -> dict:
        """EWMA state for the metrics summary: per-spec seconds-per-unit
        (keys rendered with the trace layer's compact spec labels) and the
        running prediction error against measured wall time."""
        with self._lock:
            per_key: dict[str, dict] = {}
            for k, v in self._per_key.items():
                label = _key_str(k)
                if label in per_key:  # distinct specs, same shape label
                    n = 2
                    while f"{label}#{n}" in per_key:
                        n += 1
                    label = f"{label}#{n}"
                per_key[label] = {
                    "s_per_unit": v,
                    "updates": self._updates.get(k, 0),
                }
            out = {
                "alpha": self.alpha,
                "global_s_per_unit": self._global,
                "per_key": dict(sorted(per_key.items())),
            }
            if self._rel_error is not None:
                out["ewma_rel_error"] = round(self._rel_error, 4)
            return out


class Telemetry:
    def __init__(
        self,
        lanes: int = 128,
        observability: Optional[ObservabilityConfig] = None,
    ):
        self.lanes = lanes
        #: lifecycle tracing + worker timelines + stage histograms; the
        #: gateway/dispatchers record into it alongside these counters.
        self.trace = TraceRecorder(observability)
        self.tenants: dict[str, TenantStats] = {}
        self.batches = 0
        self.batched_circuits = 0
        self.padded_lanes = 0
        self.deadline_flushes = 0
        self.size_flushes = 0
        # fused shift-group launches: every executed ShiftGroupKey batch is
        # ONE prefix-reuse kernel launch; ``fused_banks`` counts the implicit
        # banks it covered (> batches when cross-bank fusion is happening —
        # the K x (1+2P) -> (1+2P) launch collapse the multi-bank path buys).
        self.fused_launches = 0
        self.fused_banks = 0
        self.multibank_launches = 0      # fused launches covering >= 2 banks
        # mesh spill: mega-batches too wide/deep for any single worker that
        # were routed through the sharded whole-mesh executor instead of
        # failing fast.
        self.mesh_spills = 0
        self.spilled_lanes = 0
        # failure recovery: batches sent back through the coalescer after a
        # worker failure or drain (each re-coalesces and re-places
        # bit-identically), plus per-worker fleet event counters.
        self.migrated_batches = 0
        self.migrated_circuits = 0
        self.worker_events: dict[str, dict[str, int]] = {}
        # federated aggregation rounds closed (repro_torch.federated coordinator).
        self.federated_rounds = 0
        self.service = ServiceModel()

    def _tenant(self, client_id: str) -> TenantStats:
        return self.tenants.setdefault(client_id, TenantStats())

    def set_slo(self, client_id: str, slo_s: float | None) -> None:
        self._tenant(client_id).slo_s = slo_s

    # ------------------------------------------------------------- events
    def on_submit(self, client_id: str, now: float) -> None:
        s = self._tenant(client_id)
        s.submitted += 1
        s.first_submit = min(s.first_submit, now)

    def on_reject(self, client_id: str) -> None:
        self._tenant(client_id).rejected += 1

    def on_batch(
        self, n_lanes: int, *, padded: int | None = None, by_deadline: bool
    ) -> None:
        """``n_lanes``: kernel lanes the batch's members occupy — member
        count for row circuits, sum of bank sample widths for shift-group
        subtasks (``CoalescedBatch.lane_count``).  ``padded``: lanes the
        launch pays for (``CoalescedBatch.padded``); defaults to padding
        ``n_lanes`` once, which is only right for shared-row batches."""
        self.batches += 1
        self.batched_circuits += n_lanes
        if padded is None:
            padded = math.ceil(n_lanes / self.lanes) * self.lanes
        self.padded_lanes += padded
        if by_deadline:
            self.deadline_flushes += 1
        else:
            self.size_flushes += 1

    def on_fused_launch(self, n_banks: int) -> None:
        """One executed shift-group mega-batch = one fused kernel launch
        covering ``n_banks`` implicit banks' (param, shift) subtasks."""
        self.fused_launches += 1
        self.fused_banks += n_banks
        if n_banks > 1:
            self.multibank_launches += 1

    def on_spill(self, lanes: int) -> None:
        """One mega-batch routed through the whole-mesh spill executor."""
        self.mesh_spills += 1
        self.spilled_lanes += lanes

    def on_evict(self, client_id: str) -> None:
        """One circuit preemptively evicted past its SLO budget: counts as
        an SLO miss without a completion."""
        s = self._tenant(client_id)
        s.evicted += 1
        s.slo_misses += 1

    def on_requeue(self, n_members: int) -> None:
        """One batch migrated back through the coalescer (worker failure,
        drain, or simulated eviction) for re-coalescing and re-placement."""
        self.migrated_batches += 1
        self.migrated_circuits += n_members

    def _worker_events(self, worker_id: str) -> dict[str, int]:
        return self.worker_events.setdefault(
            worker_id,
            {
                "failures": 0,
                "retries": 0,
                "migrations": 0,
                "hedges": 0,
                "offline_trips": 0,
            },
        )

    def on_worker_failure(self, worker_id: str) -> None:
        self._worker_events(worker_id)["failures"] += 1

    def on_worker_retry(self, worker_id: str) -> None:
        self._worker_events(worker_id)["retries"] += 1

    def on_worker_migration(self, worker_id: str) -> None:
        self._worker_events(worker_id)["migrations"] += 1

    def on_worker_hedge(self, worker_id: str) -> None:
        self._worker_events(worker_id)["hedges"] += 1

    def on_worker_offline(self, worker_id: str) -> None:
        self._worker_events(worker_id)["offline_trips"] += 1

    def on_federated_update(self, client_id: str, status: str) -> None:
        """One federated-round outcome for ``client_id``: ``participated``
        (made quorum), ``late`` (arrived past the deadline — folded into the
        next round or discounted away), or ``dropped`` (never arrived /
        exceeded the staleness limit)."""
        s = self._tenant(client_id)
        if status == "participated":
            s.fed_participated += 1
        elif status == "late":
            s.fed_late += 1
        elif status == "dropped":
            s.fed_dropped += 1
        else:
            raise ValueError(
                f"unknown federated update status {status!r}; valid: "
                "participated / late / dropped"
            )

    def on_round_aggregated(self) -> None:
        """One federated aggregation round closed by the coordinator."""
        self.federated_rounds += 1

    def on_complete(self, client_id: str, submit_time: float, now: float) -> None:
        s = self._tenant(client_id)
        s.completed += 1
        s.last_complete = max(s.last_complete, now)
        latency = now - submit_time
        s.latencies.record(latency)
        if s.slo_s is not None and latency > s.slo_s + 1e-12:
            s.slo_misses += 1

    # ------------------------------------------------------------ summary
    @property
    def lane_fill(self) -> float:
        return self.batched_circuits / max(self.padded_lanes, 1)

    @property
    def mean_batch_occupancy(self) -> float:
        return self.batched_circuits / max(self.batches, 1)

    def tenant_summary(self, client_id: str) -> dict:
        s = self._tenant(client_id)
        out = {
            "client": client_id,
            "submitted": s.submitted,
            "completed": s.completed,
            "rejected": s.rejected,
            "p50_latency_s": round(s.latency_percentile(50), 4),
            "p99_latency_s": round(s.latency_percentile(99), 4),
            "circuits_per_second": round(s.circuits_per_second, 2),
        }
        if s.evicted:
            out["evicted"] = s.evicted
        if s.slo_s is not None:
            out["slo_s"] = s.slo_s
            out["slo_misses"] = s.slo_misses
            out["slo_attainment"] = round(s.slo_attainment, 4)
        if s.fed_participated or s.fed_late or s.fed_dropped:
            out["federated"] = {
                "participated": s.fed_participated,
                "late": s.fed_late,
                "dropped": s.fed_dropped,
            }
        return out

    def summary(self) -> dict:
        done = sum(s.completed for s in self.tenants.values())
        t0 = min((s.first_submit for s in self.tenants.values()), default=0.0)
        t1 = max((s.last_complete for s in self.tenants.values()), default=0.0)
        slo_done = sum(
            s.completed + s.evicted
            for s in self.tenants.values()
            if s.slo_s is not None
        )
        slo_misses = sum(s.slo_misses for s in self.tenants.values())
        evicted = sum(s.evicted for s in self.tenants.values())
        out = {
            "tenants": [self.tenant_summary(c) for c in sorted(self.tenants)],
            "total_completed": done,
            "circuits_per_second": round(done / max(t1 - t0, 1e-9), 2),
            "batches": self.batches,
            "mean_batch_occupancy": round(self.mean_batch_occupancy, 1),
            "lane_fill": round(self.lane_fill, 3),
            "size_flushes": self.size_flushes,
            "deadline_flushes": self.deadline_flushes,
        }
        if self.fused_launches:
            out["fused_launches"] = self.fused_launches
            out["fused_banks"] = self.fused_banks
            out["multibank_launches"] = self.multibank_launches
            out["banks_per_launch"] = round(
                self.fused_banks / self.fused_launches, 2
            )
        if self.mesh_spills:
            out["mesh_spills"] = self.mesh_spills
            out["spilled_lanes"] = self.spilled_lanes
        if evicted:
            out["evicted"] = evicted
        if self.migrated_batches:
            out["migrated_batches"] = self.migrated_batches
            out["migrated_circuits"] = self.migrated_circuits
        if self.worker_events:
            out["fleet"] = {
                w: dict(ev) for w, ev in sorted(self.worker_events.items())
            }
        if self.federated_rounds:
            out["federated_rounds"] = self.federated_rounds
        if slo_done:
            out["slo_misses"] = slo_misses
            out["slo_attainment"] = round(1.0 - slo_misses / slo_done, 4)
        if self.service._per_key or self.service._global is not None:
            out["service_model"] = self.service.snapshot()
        if self.trace.enabled and self.trace.events:
            out["observability"] = self.trace.summary()
        return out
