"""Multi-tenant system demo: four concurrent clients with heterogeneous
circuit widths share four heterogeneous quantum workers (5/10/15/20 qubits)
under the co-Manager (Algorithm 2) — including a mid-run worker failure and
its 3-missed-heartbeats eviction + requeue recovery.  Driven through the
typed ``repro_torch.api`` facade (``ClusterConfig`` +
``QuantumCluster.simulate``).  Everything runs on the virtual clock.

Run:  PYTHONPATH=src python -m repro_torch.examples.multitenant_serving [--device cpu]
"""
from __future__ import annotations

from collections import Counter

from repro_torch.api import ClusterConfig, QuantumCluster, SimulationConfig
from repro_torch.comanager import tenancy
from repro_torch.comanager.worker import WorkerConfig
from repro_torch.examples import arg_parser, parse


def run(tenancy_mode: str, failures=None, device="cuda"):
    jobs = [
        tenancy.JobSpec("alice-5q1l", 5, 1, 240, service_override=0.26),
        tenancy.JobSpec("bob-5q2l", 5, 2, 240, service_override=0.33),
        tenancy.JobSpec("carol-7q1l", 7, 1, 240, service_override=0.33),
        tenancy.JobSpec("dave-7q2l", 7, 2, 240, service_override=0.42),
    ]
    cluster = QuantumCluster(ClusterConfig(
        workers=tuple(WorkerConfig(f"w{i+1}", q, contention=0.5)
                      for i, q in enumerate((5, 10, 15, 20))),
        simulation=SimulationConfig(tenancy=tenancy_mode, fair_queue=True,
                                    classical_overhead=0.01),
    ), device=device)
    rep = cluster.simulate(jobs, worker_failures=failures or {})
    return cluster, rep


def main(argv=None) -> dict:
    _, dev = parse(arg_parser(__doc__), argv)
    print("=== multi-tenant vs single-tenant, 4 clients x 240 circuits ===")
    results = {}
    for mode in ("multi", "single_circuit"):
        sim, rep = run(mode, device=dev)
        results[mode] = rep
        print(f"\n[{mode}] makespan {rep.makespan:.1f}s, "
              f"{rep.circuits_per_second:.1f} circuits/s")
        for cid, job in sorted(rep.jobs.items()):
            print(f"  {cid:12s} finished at {job.finish_time:7.1f}s "
                  f"({job.circuits_per_second:.2f} c/s)")
        spread = Counter(w for _, _, w in rep.assignments)
        print(f"  assignment spread: {dict(sorted(spread.items()))}")

    m, s = results["multi"], results["single_circuit"]
    speedup = (s.makespan / m.makespan, m.circuits_per_second / s.circuits_per_second)
    print(f"\nmulti-tenancy system speedup: "
          f"{speedup[0]:.2f}x on makespan, "
          f"{speedup[1]:.2f}x on throughput")

    print("\n=== worker failure: w4 (20q) goes silent at t=30s ===")
    sim, rep = run("multi", failures={"w4": 30.0}, device=dev)
    ev = rep.evictions[0] if rep.evictions else None
    print(f"evicted: {ev} (3 missed heartbeats after t=30)")
    done = sum(1 for j in rep.jobs.values())
    print(f"all {done}/4 client jobs still completed "
          f"(requeued circuits rescheduled); makespan {rep.makespan:.1f}s")
    return {"reports": results, "speedup_makespan": speedup[0],
            "speedup_throughput": speedup[1], "failure": rep, "evicted": ev,
            "completed_jobs": done}


if __name__ == "__main__":
    main()
