"""Trace replay: drive a generated storm against a runtime.

``replay_sim`` replays a ``Trace`` against the virtual clock
(``SystemSimulation`` with the serving gateway) — the 10k+-tenant path the
CI scale gate runs, deterministic down to the last event.  ``replay_real``
replays a (small) trace against real kernels through ``GatewayRuntime``,
the sanity check that the virtual-clock knee shape is not a simulation
artifact.

Both return a ``ReplayResult`` with the aggregates the knee finder
consumes: offered vs achieved throughput, the population-wide p99 (merged
from the per-tenant streaming histograms), SLO attainment, the reject
fraction under admission control, and the obs-layer signals (queue-depth
p99, coalesce-wait share of end-to-end latency).
"""

from __future__ import annotations

import dataclasses

from repro_torch.comanager import tenancy
from repro_torch.comanager.simulation import SystemSimulation
from repro_torch.comanager.worker import PAPER_RATES_GCP, WorkerConfig
from repro_torch.obs.config import ObservabilityConfig
from repro_torch.obs.histogram import LogHistogram
from repro_torch.scale.workload import Trace

#: same co-residency slowdown as the gateway benchmarks.
CONTENTION = 0.5


def default_fleet(n_replicas: int = 2) -> list[WorkerConfig]:
    """``n_replicas`` copies of the paper's heterogeneous 5/10/15/20-qubit
    quartet — 8 workers by default, the scale-harness reference fleet."""
    return [
        WorkerConfig(f"w{r * 4 + i + 1}", q, contention=CONTENTION)
        for r in range(n_replicas)
        for i, q in enumerate((5, 10, 15, 20))
    ]


@dataclasses.dataclass
class ReplayResult:
    """Aggregates of one replayed storm (all virtual-clock deterministic
    except the ``replay_real`` wall-clock fields)."""

    n_tenants: int
    submitted: int
    completed: int
    rejected: int
    offered_cps: float
    achieved_cps: float
    makespan_s: float
    p50_latency_s: float
    p99_latency_s: float
    slo_attainment: float | None
    queue_depth_p99: float | None
    coalesce_wait_share: float | None
    summary: dict
    report: object | None = None

    @property
    def reject_fraction(self) -> float:
        return self.rejected / max(self.submitted, 1)

    def row(self) -> dict:
        """Flat JSON-ready view (drops the raw summary/report handles)."""
        return {
            "n_tenants": self.n_tenants,
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "reject_fraction": round(self.reject_fraction, 4),
            "offered_cps": round(self.offered_cps, 2),
            "achieved_cps": round(self.achieved_cps, 2),
            "makespan_s": round(self.makespan_s, 3),
            "p50_latency_s": round(self.p50_latency_s, 4),
            "p99_latency_s": round(self.p99_latency_s, 4),
            "slo_attainment": self.slo_attainment,
            "queue_depth_p99": self.queue_depth_p99,
            "coalesce_wait_share": self.coalesce_wait_share,
        }


def merged_latency(telemetry) -> LogHistogram:
    """Population-wide end-to-end latency: fold every tenant's streaming
    histogram (same bucketing, so the merge keeps the error bound)."""
    out = LogHistogram()
    for stats in telemetry.tenants.values():
        out.merge(stats.latencies)
    return out


def replay_sim(
    trace: Trace,
    *,
    workers: list[WorkerConfig] | None = None,
    max_pending: int | None = None,
    max_system_pending: int | None = None,
    gateway_deadline: float = 0.25,
    gateway_async: bool = True,
    heartbeat_period: float = 5.0,
    classical_overhead: float = 0.002,
    assign_latency: float = 0.001,
    sample_rate: float = 0.05,
    run_until: float = 1e7,
    keep_report: bool = False,
) -> ReplayResult:
    """Replay ``trace`` on the virtual clock through the serving gateway.

    ``max_system_pending`` arms the gateway's weighted-fair global
    admission cap (None = admit everything, the uncalibrated default);
    rejected circuits are shed at submit and counted, never executed.
    ``sample_rate`` keeps lifecycle tracing O(1) at storm scale while the
    always-on histograms still see every circuit.
    """
    workers = default_fleet() if workers is None else workers
    jobs, arrivals = [], {}
    weights, priorities, slos = {}, {}, {}
    for t in trace.tenants:
        offs = trace.arrivals[t.tenant_id]
        jobs.append(
            tenancy.JobSpec(
                t.tenant_id,
                t.qc,
                t.n_layers,
                len(offs),
                service_override=1.0 / PAPER_RATES_GCP[(t.qc, t.n_layers)],
            )
        )
        arrivals[t.tenant_id] = offs
        weights[t.tenant_id] = t.weight
        priorities[t.tenant_id] = t.priority
        if t.slo_ms is not None:
            slos[t.tenant_id] = t.slo_ms
    sim = SystemSimulation(
        workers,
        jobs,
        gateway=True,
        gateway_async=gateway_async,
        gateway_deadline=gateway_deadline,
        gateway_max_pending=max_pending,
        gateway_max_system_pending=max_system_pending,
        arrivals=arrivals,
        tenant_weights=weights,
        tenant_priorities=priorities,
        tenant_slos_ms=slos or None,
        heartbeat_period=heartbeat_period,
        classical_overhead=classical_overhead,
        assign_latency=assign_latency,
        run_until=run_until,
        observability=ObservabilityConfig(sample_rate=sample_rate),
    )
    report = sim.run()
    summary = report.gateway_summary
    telemetry = sim.gateway.telemetry
    lat = merged_latency(telemetry)
    rejected = report.rejected
    completed = summary["total_completed"]
    makespan = max(report.makespan, 1e-9)
    recorder = telemetry.trace
    qd = recorder.queue_depth
    queue_depth_p99 = (
        round(qd.percentile(99), 2) if qd.count else None
    )
    stages = recorder.stage_summary()
    return ReplayResult(
        n_tenants=trace.n_tenants,
        submitted=trace.n_circuits,
        completed=completed,
        rejected=rejected,
        offered_cps=trace.offered_cps,
        achieved_cps=completed / makespan,
        makespan_s=report.makespan,
        p50_latency_s=lat.percentile(50) if lat.count else 0.0,
        p99_latency_s=lat.percentile(99) if lat.count else 0.0,
        slo_attainment=summary.get("slo_attainment"),
        queue_depth_p99=queue_depth_p99,
        coalesce_wait_share=stages.get("coalesce_wait_share"),
        summary=summary,
        report=report if keep_report else None,
    )


def replay_real(
    trace: Trace,
    *,
    mode: str = "async",
    slots_per_worker: int = 2,
    deadline: float = 0.1,
    target: int | None = None,
    max_system_pending: int | None = None,
    device="cuda",
) -> ReplayResult:
    """Replay a (small) trace against real kernels via ``GatewayRuntime``.

    Submissions stream in global arrival order (open loop, as fast as the
    gateway admits them); per-tenant policies ride along.  Each circuit's
    angles are drawn on the host from the trace's seed (the reference's
    stream) and copied to ``device`` (the card by default; ``"cpu"`` runs
    the kernels' plain versions).  Wall-clock throughput is
    machine-dependent — report it, never gate it.
    """
    import time

    import numpy as np
    import torch

    from repro_torch.core import circuits
    from repro_torch.serve import Backpressure, GatewayRuntime
    from repro_torch.serve.dispatcher import submit_origin

    dev = torch.device(device)

    specs: dict[tuple[int, int], object] = {}
    for t in trace.tenants:
        key = (t.qc, t.n_layers)
        if key not in specs:
            specs[key] = circuits.build_quclassi_circuit(*key)
    events = sorted(
        (off, t)
        for t in trace.tenants
        for off in trace.arrivals[t.tenant_id]
    )
    rng = np.random.default_rng(trace.seed)
    rt = GatewayRuntime(
        target=target,
        deadline=deadline,
        mode=mode,
        slots_per_worker=slots_per_worker,
        max_system_pending=max_system_pending,
    )
    rejected = 0
    try:
        for t in trace.tenants:
            rt.gateway.register_client(
                t.tenant_id,
                weight=t.weight,
                priority=t.priority,
                slo_ms=t.slo_ms,
            )
        for key, spec in specs.items():  # stage each spec's kernel tables
            th = torch.zeros((1, spec.n_theta), dtype=torch.float32, device=dev)
            da = torch.zeros((1, spec.n_data), dtype=torch.float32, device=dev)
            rt.dispatcher.kernel(spec, th, da)
        t0 = time.perf_counter()
        futures = []
        for _, t in events:
            spec = specs[(t.qc, t.n_layers)]
            theta = torch.as_tensor(
                rng.uniform(0, np.pi, (spec.n_theta,)), dtype=torch.float32
            ).to(dev)
            data = torch.as_tensor(
                rng.uniform(0, np.pi, (spec.n_data,)), dtype=torch.float32
            ).to(dev)
            try:
                futures.append(
                    rt.gateway.submit(
                        t.tenant_id,
                        spec,
                        (theta, data),
                        now=rt.dispatcher.clock(),
                        origin=submit_origin(dev),
                    )
                )
            except Backpressure:
                rejected += 1
            rt.dispatcher.kick()
        rt.dispatcher.drain()
        wall = time.perf_counter() - t0
        summary = rt.telemetry.summary()
        lat = merged_latency(rt.telemetry)
    finally:
        rt.close()
    completed = summary["total_completed"]
    return ReplayResult(
        n_tenants=trace.n_tenants,
        submitted=len(events),
        completed=completed,
        rejected=rejected,
        offered_cps=trace.offered_cps,
        achieved_cps=completed / max(wall, 1e-9),
        makespan_s=wall,
        p50_latency_s=lat.percentile(50) if lat.count else 0.0,
        p99_latency_s=lat.percentile(99) if lat.count else 0.0,
        slo_attainment=summary.get("slo_attainment"),
        queue_depth_p99=None,
        coalesce_wait_share=None,
        summary=summary,
    )


__all__ = [
    "CONTENTION",
    "ReplayResult",
    "default_fleet",
    "merged_latency",
    "replay_real",
    "replay_sim",
]
