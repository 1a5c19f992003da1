"""The port's event loop and virtual-clock system simulation
(``repro_torch.comanager.{events,simulation}``) against the reference's.

The simulation runs on the host only, so the same jobs, fleet and knobs
must give the reference's ``SimulationReport`` field for field: jobs,
makespan, assignments, evictions, busy time, fidelity retention, rejected
circuits and the gateway summary, and, where the gateway traced the run,
the same Chrome trace.  The golden trace of ``tests/test_observability.py``
is rebuilt from the port and must equal ``tests/snapshots/gateway_trace.json``
byte for byte.
"""
import dataclasses
import importlib
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.comanager.events import EventLoop

SNAPSHOT = Path(__file__).parent / "snapshots" / "gateway_trace.json"


def _ns(root: str) -> SimpleNamespace:
    sim = importlib.import_module(f"{root}.comanager.simulation")
    ten = importlib.import_module(f"{root}.comanager.tenancy")
    wk = importlib.import_module(f"{root}.comanager.worker")
    faults = importlib.import_module(f"{root}.comanager.faults")
    return SimpleNamespace(
        SystemSimulation=sim.SystemSimulation,
        homogeneous_workers=sim.homogeneous_workers,
        JobSpec=ten.JobSpec,
        paper_job=ten.paper_job,
        WorkerConfig=wk.WorkerConfig,
        FaultSpec=faults.FaultSpec,
    )


REF, PORT = _ns("repro"), _ns("repro_torch")


def _plain(rep) -> dict:
    """Every field of a ``SimulationReport`` as plain data (the trace as its
    Chrome export)."""
    return {
        "jobs": {c: dataclasses.astuple(r) for c, r in sorted(rep.jobs.items())},
        "total_circuits": rep.total_circuits,
        "makespan": rep.makespan,
        "assignments": [tuple(a) for a in rep.assignments],
        "evictions": [tuple(e) for e in rep.evictions],
        "worker_busy_time": dict(rep.worker_busy_time),
        "fidelity_retention": rep.fidelity_retention,
        "rejected": rep.rejected,
        "gateway_summary": rep.gateway_summary,
        "trace": None if rep.trace is None
        else json.dumps(rep.trace.export_chrome_trace(), sort_keys=True),
    }


# -------------------------------------------------------------- event loop
def test_event_loop_ordering_and_stop():
    lp = EventLoop()
    seen = []
    lp.on("e", lambda t, p: seen.append((t, p)))
    lp.on("halt", lambda t, p: lp.stop())
    lp.schedule(2.0, "e", "b")
    lp.schedule(1.0, "e", "a")
    lp.schedule(2.0, "e", "c")  # same time: FIFO by sequence
    lp.schedule(3.0, "halt")
    lp.schedule(4.0, "e", "never")
    lp.run()
    assert seen == [(1.0, "a"), (2.0, "b"), (2.0, "c")]
    assert lp.now == 3.0


def test_event_loop_rejects_past():
    lp = EventLoop()
    lp.on("e", lambda t, p: lp.schedule(t - 1.0, "e") if t < 2 else None)
    lp.schedule(1.0, "e")
    with pytest.raises(ValueError, match="cannot schedule in the past"):
        lp.run()


def test_event_loop_cancel():
    lp = EventLoop()
    seen = []
    lp.on("e", lambda t, p: seen.append(p))
    lp.schedule(1.0, "e", "keep")
    drop = lp.schedule(2.0, "e", "drop")
    lp.cancel(drop)
    lp.run()
    assert seen == ["keep"]


# --------------------------------------------------------------- scenarios
FIG6 = (("5q1l", 5, 1), ("5q2l", 5, 2), ("7q1l", 7, 1), ("7q2l", 7, 2))


def _fig6_fleet(ns, contention=0.5):
    return [ns.WorkerConfig(f"w{i + 1}", q, contention=contention)
            for i, q in enumerate((5, 10, 15, 20))]


def _paper_jobs(ns, tenancy):
    """The Fig-6 clients at the paper's circuit counts (cut to 5%)."""
    jobs = [ns.paper_job(cid, qc, nl, scale=0.05) for cid, qc, nl in FIG6]
    return ns.SystemSimulation(_fig6_fleet(ns), jobs, tenancy=tenancy,
                               classical_overhead=0.01, fair_queue=True,
                               assign_latency=0.05).run()


def _heterogeneous(ns, multi_tenant):
    jobs = [ns.JobSpec(cid, qc, nl, 30, service_override=0.5 + 0.1 * i)
            for i, (cid, qc, nl) in enumerate(FIG6)]
    return ns.SystemSimulation(_fig6_fleet(ns, 0.15), jobs, multi_tenant=multi_tenant).run()


def _crash_evict(ns):
    jobs = [ns.JobSpec("c1", 5, 1, 30, service_override=2.0)]
    return ns.SystemSimulation(ns.homogeneous_workers(2, 5), jobs,
                               worker_failures={"w1": 10.0}, run_until=1e5).run()


def _crash_recover(ns):
    jobs = [ns.JobSpec("a", 5, 1, 40, service_override=1.0),
            ns.JobSpec("b", 7, 1, 20, service_override=1.5, submit_time=2.0)]
    faults = {"w1": ns.FaultSpec(kind="crash_recover", at=4.0, recover_at=30.0),
              "w2": ns.FaultSpec(kind="slowdown", at=0.0, recover_at=20.0, factor=3.0),
              "w3": ns.FaultSpec(kind="flaky", at=0.0, p=0.3, seed=5)}
    return ns.SystemSimulation(ns.homogeneous_workers(3, 10), jobs,
                               worker_failures=faults, heartbeat_period=1.0).run()


def _crash_recover_gateway(ns):
    jobs = [ns.JobSpec("a", 5, 1, 60, service_override=0.4),
            ns.JobSpec("b", 5, 1, 60, service_override=0.4, submit_time=0.5)]
    faults = {"w1": {"kind": "crash_recover", "at": 0.3, "recover_at": 3.0}}
    return ns.SystemSimulation(ns.homogeneous_workers(3, 10), jobs, gateway=True,
                               gateway_deadline=0.2, heartbeat_period=0.5,
                               worker_failures=faults).run()


def _late_joiner(ns):
    jobs = [ns.JobSpec("c1", 5, 1, 40, service_override=1.0)]
    sim = ns.SystemSimulation(ns.homogeneous_workers(2, 5), jobs)
    sim.loop.schedule(0.0, "register", "w1")
    sim.loop.schedule(15.0, "register", "w2")
    for job in sim.jobs.values():
        sim.loop.schedule(job.submit_time, "submit", job)
    sim.loop.schedule(sim.heartbeat_period, "liveness", None)
    return sim.finish(sim.loop.run())


def _poisson_gateway(ns, gateway_async):
    rng = np.random.default_rng(3)
    jobs, arrivals = [], {}
    for i, (cid, qc, nl) in enumerate(FIG6):
        jobs.append(ns.JobSpec(cid, qc, nl, 80, service_override=0.05 * (i + 1)))
        arrivals[cid] = np.cumsum(rng.exponential(0.02, 80)).tolist()
    return ns.SystemSimulation(_fig6_fleet(ns), jobs, gateway=True,
                               gateway_async=gateway_async, gateway_deadline=0.1,
                               classical_overhead=0.002, arrivals=arrivals).run()


def _tenant_policies(ns):
    jobs = [ns.JobSpec(cid, qc, nl, 64, service_override=0.3) for cid, qc, nl in FIG6]
    return ns.SystemSimulation(
        _fig6_fleet(ns), jobs, gateway=True, gateway_deadline=0.5,
        classical_overhead=0.01,
        tenant_weights={"5q1l": 2.0, "7q2l": 0.5},
        tenant_priorities={"5q1l": 0, "7q1l": 0},
        tenant_slos_ms={"5q1l": 500.0, "7q1l": 2000.0},
    ).run()


def _admission_caps(ns):
    jobs = [ns.JobSpec(cid, qc, nl, 200, service_override=0.2) for cid, qc, nl in FIG6]
    return ns.SystemSimulation(
        _fig6_fleet(ns), jobs, gateway=True, gateway_max_pending=150,
        gateway_max_system_pending=400, gateway_max_pending_per_tier={0: 120},
        tenant_priorities={"5q1l": 0}, tenant_weights={"7q2l": 3.0},
    ).run()


def _lockstep_noise_aware(ns):
    workers = [ns.WorkerConfig("w1", 10, error_rate=0.01),
               ns.WorkerConfig("w2", 10, error_rate=0.001),
               ns.WorkerConfig("w3", 15, error_rate=0.005)]
    jobs = [ns.JobSpec("a", 5, 2, 24, service_override=0.7),
            ns.JobSpec("b", 7, 1, 24, service_override=0.9, submit_time=1.0)]
    return ns.SystemSimulation(workers, jobs, lockstep=True, policy="noise_aware",
                               classical_overhead=0.05).run()


def _user_exclusive(ns):
    jobs = [ns.JobSpec(cid, qc, nl, 20, service_override=0.4) for cid, qc, nl in FIG6]
    return ns.SystemSimulation(_fig6_fleet(ns), jobs, tenancy="user_exclusive",
                               env="gcp", eager_completion=False).run()


SCENARIOS = {
    "paper_jobs_multi": lambda ns: _paper_jobs(ns, "multi"),
    "paper_jobs_single_circuit": lambda ns: _paper_jobs(ns, "single_circuit"),
    "heterogeneous_multi_tenant": lambda ns: _heterogeneous(ns, True),
    "heterogeneous_single_tenant": lambda ns: _heterogeneous(ns, False),
    "crash_evict": _crash_evict,
    "crash_recover_slowdown_flaky": _crash_recover,
    "crash_recover_gateway": _crash_recover_gateway,
    "late_joining_worker": _late_joiner,
    "poisson_gateway_sync": lambda ns: _poisson_gateway(ns, False),
    "poisson_gateway_async": lambda ns: _poisson_gateway(ns, True),
    "tenant_weights_priorities_slos": _tenant_policies,
    "admission_caps": _admission_caps,
    "lockstep_noise_aware": _lockstep_noise_aware,
    "user_exclusive": _user_exclusive,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_report_equals_reference(name):
    ref, port = _plain(SCENARIOS[name](REF)), _plain(SCENARIOS[name](PORT))
    assert ref["total_circuits"] > 0
    for field in ref:
        assert port[field] == ref[field], field


def test_scenarios_exercise_their_paths():
    """The scenarios above reach what they name (so equality is not vacuous)."""
    rep = _crash_evict(PORT)
    assert any(wid == "w1" for _, wid in rep.evictions)
    late = {wid for t, _, wid in _late_joiner(PORT).assignments if t >= 15.0}
    assert "w2" in late
    assert _admission_caps(PORT).rejected > 0
    multi, single = _paper_jobs(PORT, "multi"), _paper_jobs(PORT, "single_circuit")
    assert multi.makespan < single.makespan
    pol = _tenant_policies(PORT).gateway_summary
    slos = {t["client"]: t.get("slo_s") for t in pol["tenants"]}
    assert slos["5q1l"] == pytest.approx(0.5)


@pytest.mark.parametrize("qc,nl", [(5, 1), (5, 2), (5, 3), (7, 1), (7, 2), (7, 3)])
def test_paper_job_counts(qc, nl):
    assert PORT.paper_job("c", qc, nl).n_circuits == REF.paper_job("c", qc, nl).n_circuits


# -------------------------------------------------------------- validation
def _message(ns, **kw):
    with pytest.raises(ValueError) as exc:
        ns.SystemSimulation([ns.WorkerConfig("w1", 5)], [ns.JobSpec("a", 5, 1, 4)],
                            gateway=True, **kw)
    return str(exc.value)


@pytest.mark.parametrize("kwarg,value", [
    ("tenant_weights", {"nobody": 1}),
    ("tenant_priorities", {"nobody": 1}),
    ("tenant_slos_ms", {"nobody": 1}),
    ("arrivals", {"nobody": [0.0]}),
    ("worker_failures", {"w9": 10.0}),
    ("worker_failures", {"w1": {"kind": "crash_recover", "at": 5.0, "recover_at": 1.0}}),
])
def test_validation_messages_equal_reference(kwarg, value):
    port = _message(PORT, **{kwarg: value})
    assert port == _message(REF, **{kwarg: value})
    assert kwarg in port or "w1" in port


def test_submit_job_refuses_a_known_client():
    sim = PORT.SystemSimulation([PORT.WorkerConfig("w1", 5)], [PORT.JobSpec("a", 5, 1, 4)])
    with pytest.raises(ValueError, match="already submitted"):
        sim.submit_job(PORT.JobSpec("a", 5, 1, 4))


# ------------------------------------------------------------ golden trace
def _golden(ns) -> str:
    """``tests/test_observability.py``'s seeded 4-tenant gateway run with a
    mid-run crash and recovery, exported as a Chrome trace."""
    jobs = [
        ns.JobSpec("alice", qc=5, n_layers=1, n_circuits=30, submit_time=0.0),
        ns.JobSpec("bob", qc=5, n_layers=1, n_circuits=30, submit_time=0.0),
        ns.JobSpec("carol", qc=7, n_layers=1, n_circuits=20, submit_time=0.5),
        ns.JobSpec("dave", qc=7, n_layers=1, n_circuits=20, submit_time=0.5),
    ]
    report = ns.SystemSimulation(
        ns.homogeneous_workers(3, 10), jobs, gateway=True, gateway_deadline=0.2,
        heartbeat_period=0.5, tenant_slos_ms={"alice": 2000.0, "carol": 2000.0},
        worker_failures={"w1": {"kind": "crash_recover", "at": 0.3, "recover_at": 3.0}},
    ).run()
    assert report.trace.open_traces == 0
    return json.dumps(report.trace.export_chrome_trace(), indent=1, sort_keys=True)


def test_golden_trace_byte_equal_to_snapshot():
    assert _golden(PORT) == SNAPSHOT.read_text()
