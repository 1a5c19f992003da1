"""Elastic fleet demo: worker crashes, migration with bit-identical replay,
hedged dispatch, and live membership — on the REAL async dispatcher, its
batches on the fidelity kernel.

Four scenes:
  1. a worker hard-crashes mid-run: its circuit breaker trips, stranded
     batches migrate through the coalescer to the survivors, and every
     future resolves to exactly the value a fault-free run produces;
  2. a flaky worker drops attempts; in-place retries absorb the noise;
  3. live membership: drain a worker out of rotation, register a fresh one,
     and keep serving without a restart;
  4. the same crash schedule on the virtual clock (``SystemSimulation``) —
     one fault spec drives both worlds.

Run:  PYTHONPATH=src python -m repro_torch.examples.failure_injection [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.comanager.simulation import SystemSimulation, homogeneous_workers
from repro_torch.comanager.tenancy import JobSpec
from repro_torch.comanager.worker import WorkerConfig
from repro_torch.core.quclassi import QuClassiConfig
from repro_torch.examples import arg_parser, parse
from repro_torch.kernels import ops as kops
from repro_torch.serve import (
    FaultInjector,
    FaultSpec,
    FaultToleranceConfig,
    GatewayRuntime,
)

CFG = QuClassiConfig(qc=5, n_layers=1)


def rows(n, seed=0, device="cuda"):
    rng = np.random.default_rng(seed)
    theta = torch.as_tensor(rng.uniform(0, np.pi, (n, CFG.n_theta)), dtype=torch.float32,
                            device=device)
    data = torch.as_tensor(rng.uniform(0, np.pi, (n, CFG.n_angles)), dtype=torch.float32,
                           device=device)
    return theta, data


def submit_all(rt, theta, data, tenant="alice"):
    now = rt.dispatcher.clock
    futures = [
        rt.gateway.submit(tenant, CFG.spec, (theta[i], data[i]), now())
        for i in range(theta.shape[0])
    ]
    rt.dispatcher.kick()
    return futures


def crash_migration_demo(device) -> dict:
    print("=== scene 1: worker crash -> breaker trip -> bit-identical "
          "migration ===")
    theta, data = rows(16, device=device)
    rt = GatewayRuntime(
        workers=[WorkerConfig("w1", 10), WorkerConfig("w2", 10)],
        target=8, lanes=8, deadline=0.05, mode="async",
        fault_tolerance=FaultToleranceConfig(retry_limit=0,
                                             breaker_threshold=1),
        fault_injector=FaultInjector({"w1": FaultSpec(kind="crash", at=0.0)}),
    )
    try:
        futures = submit_all(rt, theta, data)
        rt.dispatcher.kick()
        got = torch.stack([f.result(timeout=60.0) for f in futures])
        ref = kops.vqc_fidelity(CFG.spec, theta, data)
        assert torch.equal(got, ref), "migrated results differ from the fault-free run"
        s = rt.telemetry.summary()
        state = rt.dispatcher.fleet.state("w1")
        print(f"  w1 state={state}, "
              f"{s['migrated_batches']} batches migrated, results "
              f"bit-identical to the fault-free run")
        print(f"  fleet events: {s['fleet']}")
    finally:
        rt.close()
    return {"fidelities": got, "w1_state": state,
            "migrated_batches": s["migrated_batches"], "fleet": s["fleet"]}


def flaky_retry_demo(device) -> dict:
    print("\n=== scene 2: flaky worker absorbed by in-place retries ===")
    theta, data = rows(16, seed=1, device=device)
    rt = GatewayRuntime(
        workers=[WorkerConfig("w1", 10)],
        target=8, lanes=8, deadline=0.05, mode="async",
        fault_tolerance=FaultToleranceConfig(retry_limit=3,
                                             breaker_threshold=10),
        fault_injector=FaultInjector(
            {"w1": FaultSpec(kind="flaky", p=0.5, seed=3)}),
    )
    try:
        futures = submit_all(rt, theta, data)
        rt.dispatcher.kick()
        got = torch.stack([f.result(timeout=60.0) for f in futures])
        ev = rt.telemetry.summary()["fleet"]["w1"]
        print(f"  {ev['failures']} injected drops, {ev['retries']} retries, "
              f"all {len(futures)} circuits completed")
    finally:
        rt.close()
    return {"fidelities": got, "fleet": {"w1": ev}, "completed": len(futures)}


def live_membership_demo(device) -> dict:
    print("\n=== scene 3: drain w1 out, register w3, keep serving ===")
    theta, data = rows(16, seed=2, device=device)
    rt = GatewayRuntime(
        workers=[WorkerConfig("w1", 10), WorkerConfig("w2", 10)],
        target=8, lanes=8, deadline=0.05, mode="async",
    )
    try:
        first = torch.stack([f.result(timeout=60.0) for f in submit_all(rt, theta, data)])
        rt.dispatcher.drain_worker("w1")
        rt.dispatcher.register_worker(WorkerConfig("w3", 15))
        second = torch.stack([f.result(timeout=60.0)
                              for f in submit_all(rt, theta, data, tenant="bob")])
        fleet = rt.dispatcher.fleet.workers()
        print(f"  fleet now {fleet}, "
              f"second wave served without a restart")
    finally:
        rt.close()
    return {"waves": (first, second), "fleet": fleet}


def virtual_clock_demo() -> dict:
    print("\n=== scene 4: the same fault spec on the virtual clock ===")
    rep = SystemSimulation(
        homogeneous_workers(3, 10),
        [JobSpec("alice", qc=5, n_layers=1, n_circuits=40, submit_time=0.0),
         JobSpec("bob", qc=5, n_layers=1, n_circuits=40, submit_time=0.0)],
        gateway=True, gateway_deadline=0.2, heartbeat_period=0.5,
        worker_failures={"w1": FaultSpec(kind="crash_recover",
                                         at=0.05, recover_at=3.0)},
    ).run()
    s = rep.gateway_summary
    print(f"  {rep.total_circuits} circuits, makespan {rep.makespan:.2f}s, "
          f"{s.get('migrated_batches', 0)} batches migrated, "
          f"{len(rep.evictions)} eviction(s); all jobs finished: "
          f"{sorted(rep.jobs)}")
    return {"report": rep}


def main(argv=None) -> dict:
    _, dev = parse(arg_parser(__doc__), argv)
    return {"crash": crash_migration_demo(dev), "flaky": flaky_retry_demo(dev),
            "membership": live_membership_demo(dev), "virtual": virtual_clock_demo()}


if __name__ == "__main__":
    main()
