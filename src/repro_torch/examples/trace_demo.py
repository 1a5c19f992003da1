"""Observability demo: trace the Fig-6 multi-tenant workload end to end.

Four concurrent clients (5Q/1L, 5Q/2L, 7Q/1L, 7Q/2L) share four
heterogeneous workers (5/10/15/20 qubits) through the serving gateway on
the virtual clock.  Every circuit gets a lifecycle trace (submit -> admit
-> coalesced -> placed -> dispatched -> kernel_start -> complete), every
worker dispatch a busy-interval span, and the whole run exports as
Chrome-trace JSON: open ``trace_demo.json`` (written to the working
directory) in https://ui.perfetto.dev to see one timeline row per tenant
and per worker.

Run:  PYTHONPATH=src python -m repro_torch.examples.trace_demo [--device cpu]
"""
from __future__ import annotations

from repro_torch.api import (
    ClusterConfig,
    ObservabilityConfig,
    QuantumCluster,
    SimulationConfig,
)
from repro_torch.comanager import tenancy
from repro_torch.comanager.worker import WorkerConfig
from repro_torch.examples import arg_parser, parse
from repro_torch.obs import CircuitTrace, validate_trace

CLIENTS = [("alice-5q1l", 5, 1, 0.26), ("bob-5q2l", 5, 2, 0.33),
           ("carol-7q1l", 7, 1, 0.33), ("dave-7q2l", 7, 2, 0.42)]


def main(argv=None) -> dict:
    _, dev = parse(arg_parser(__doc__), argv)
    jobs = [tenancy.JobSpec(cid, qc, nl, 120, service_override=svc)
            for cid, qc, nl, svc in CLIENTS]
    cluster = QuantumCluster(ClusterConfig(
        workers=tuple(WorkerConfig(f"w{i+1}", q, contention=0.5)
                      for i, q in enumerate((5, 10, 15, 20))),
        simulation=SimulationConfig(
            gateway=True, gateway_deadline=0.5, classical_overhead=0.01,
            # sample_rate < 1 keeps the ring small under real load; 1.0
            # here so the demo trace covers every circuit.
            observability=ObservabilityConfig(sample_rate=1.0),
        ),
    ), device=dev)
    rep = cluster.simulate(jobs)
    tr = rep.trace

    print(f"=== Fig-6 workload: {rep.total_circuits} circuits, "
          f"makespan {rep.makespan:.1f}s ===")
    records = tr.buffer.records(CircuitTrace)
    bad = validate_trace(records)
    print(f"{len(records)} lifecycle records, {tr.open_traces} still open, "
          f"{len(bad)} well-formedness violations")

    print("\n-- where the time goes (share of end-to-end latency) --")
    stages = tr.stage_summary()
    for metric in ("queue_wait", "coalesce_wait", "place_wait",
                   "dispatch_lag", "kernel_wait", "execute"):
        share = stages.get(f"{metric}_share")
        snap = stages.get(metric)
        if share is None or snap is None:
            continue
        print(f"{metric:14s} p50={snap['p50']:8.4f}s p99={snap['p99']:8.4f}s "
              f"share={share:6.1%}")
    print(f"{'e2e':14s} p50={stages['e2e']['p50']:8.4f}s "
          f"p99={stages['e2e']['p99']:8.4f}s")

    print("\n-- worker occupancy --")
    occupancy = {}
    for w, tl in sorted(tr.timelines.items()):
        s = occupancy[w] = tl.summary(horizon=rep.makespan)
        print(f"{w}: {s['spans']} dispatches, busy {s['busy_s']:.1f}s, "
              f"utilization {s['utilization']:.0%}")

    one = records[0]
    print(f"\n-- one circuit's lifecycle (tenant {one.tenant}, "
          f"seq {one.seq}) --")
    for stage, ts in one.stages:
        print(f"  {ts:8.3f}s  {stage}")

    tr.export_chrome_trace("trace_demo.json")
    print("\nwrote trace_demo.json — open it at https://ui.perfetto.dev "
          "(one row per tenant and per worker)")
    return {"report": rep, "records": len(records), "violations": len(bad),
            "stages": stages, "occupancy": occupancy}


if __name__ == "__main__":
    main()
