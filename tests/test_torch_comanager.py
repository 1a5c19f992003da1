"""The port's control plane (``repro_torch.comanager`` worker, faults,
tenancy, manager) against the reference's, field for field: the same
inputs give the same accounting, the same fault schedules and the same
Algorithm-2 placements."""
import dataclasses
import random

import pytest

from repro.comanager import faults as jfaults
from repro.comanager import manager as jmanager
from repro.comanager import tenancy as jtenancy
from repro.comanager import worker as jworker
from repro_torch.comanager import faults as tfaults
from repro_torch.comanager import manager as tmanager
from repro_torch.comanager import tenancy as ttenancy
from repro_torch.comanager import worker as tworker


def _fields(obj):
    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else dict(vars(obj))


def test_paper_rates_and_defaults_match():
    assert tworker.PAPER_RATES_IBMQ == jworker.PAPER_RATES_IBMQ
    assert tworker.PAPER_RATES_GCP == jworker.PAPER_RATES_GCP
    assert _fields(tworker.WorkerConfig("w", 7)) == _fields(jworker.WorkerConfig("w", 7))
    assert ttenancy.PAPER_CIRCUIT_COUNTS == jtenancy.PAPER_CIRCUIT_COUNTS
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert _fields(tfaults.FaultToleranceConfig()) == _fields(jfaults.FaultToleranceConfig())


@pytest.mark.parametrize("contention,error_rate", [(0.0, 0.0), (0.15, 0.0), (0.5, 0.002)])
def test_quantum_worker_accounting_matches(contention, error_rate):
    """Start, finish and abandon circuits on both workers in one sequence:
    OR / AR / CRU, execution times, busy time, noise and heartbeats agree."""
    rnd = random.Random(int(contention * 100) + int(error_rate * 1e4))
    ws = [mod.QuantumWorker(mod.WorkerConfig("w1", 20, speed=1.5, contention=contention,
                                             base_load=0.25, error_rate=error_rate))
          for mod in (jworker, tworker)]
    now, live = 0.0, []
    for tid in range(40):
        now += rnd.uniform(0.0, 0.5)
        demand = rnd.choice((3, 5, 7))
        service = 0.1 + (tid % 7) * 0.3
        tasks = [mod.CircuitTask(tid, f"c{tid % 3}", demand, service, payload=tid, depth=10 + tid)
                 for mod in (jworker, tworker)]
        assert _fields(tasks[0]) == _fields(tasks[1])
        if ws[0].available_qubits >= demand:
            ends = [w.start(t, now) for w, t in zip(ws, tasks)]
            assert ends[0] == ends[1]
            live.append(tid)
        elif live:
            done = live.pop(0)
            got = [w.finish(done, now) for w in ws]
            assert _fields(got[0]) == _fields(got[1])
        for attr in ("occupied_qubits", "available_qubits", "busy_time"):
            assert getattr(ws[0], attr) == getattr(ws[1], attr)
        assert ws[0].cru(now) == ws[1].cru(now)
        assert ws[0].exec_time(tasks[0]) == ws[1].exec_time(tasks[1])
        assert ws[0].depolarization(tid) == ws[1].depolarization(tid)
        assert ws[0].observed_p0(0.8, tid) == ws[1].observed_p0(0.8, tid)
        assert ws[0].heartbeat_payload(now) == ws[1].heartbeat_payload(now)
    lost = [w.abandon(now + 1.0) for w in ws]
    assert [_fields(t) for t in lost[0]] == [_fields(t) for t in lost[1]]
    assert ws[0].completed == ws[1].completed


@pytest.mark.parametrize("value", [
    3.5,
    {"kind": "slowdown", "at": 2.0, "factor": 3.0, "recover_at": 9.0},
    {"kind": "flaky", "at": 0.0, "p": 0.3, "seed": 7},
    {"kind": "crash_recover", "at": 1.0, "recover_at": 4.0},
])
def test_fault_specs_match(value):
    j = jfaults.normalize_failures({"w1": value})["w1"]
    t = tfaults.normalize_failures({"w1": value})["w1"]
    assert _fields(j) == _fields(t)
    for x in (0.0, 0.5, 1.0, 2.5, 3.9, 4.0, 8.0, 12.0):
        assert j.active(x) == t.active(x)
        assert j.crashed(x) == t.crashed(x)
        assert j.crashed_between(x, x + 1.5) == t.crashed_between(x, x + 1.5)
        assert j.slowdown_factor(x) == t.slowdown_factor(x)
        assert [j.drops(tok, a, x) for tok in range(20) for a in range(3)] == \
               [t.drops(tok, a, x) for tok in range(20) for a in range(3)]


@pytest.mark.parametrize("bad", [{"kind": "melt"}, {"kind": "flaky", "p": 2.0}, "soon",
                                 {"nope": 1}])
def test_fault_validation_matches(bad):
    with pytest.raises(ValueError) as je:
        jfaults.normalize_failures({"w9": bad})
    with pytest.raises(ValueError) as te:
        tfaults.normalize_failures({"w9": bad})
    assert str(je.value) == str(te.value)


def test_task_ids_and_jobs_match():
    ja, ta = jtenancy.TaskIdAllocator(5), ttenancy.TaskIdAllocator(5)
    assert [next(ja) for _ in range(7)] == [next(ta) for _ in range(7)]
    for qc, nl in ((5, 1), (7, 2)):
        jj = jtenancy.paper_job(f"c{qc}{nl}", qc, nl)
        tj = ttenancy.paper_job(f"c{qc}{nl}", qc, nl)
        assert _fields(jj) == _fields(tj)
        for env in ("ibmq", "gcp"):
            assert jj.service_time(env) == tj.service_time(env)
        jc = jj.circuits("gcp", jtenancy.TaskIdAllocator(100))
        tc = tj.circuits("gcp", ttenancy.TaskIdAllocator(100))
        assert [_fields(c) for c in jc] == [_fields(c) for c in tc]


@pytest.mark.parametrize("multi_tenant,policy,tenancy", [
    (True, "cru", None),
    (False, "cru", None),
    (True, "noise_aware", None),
    (True, "cru", "single_circuit"),
    (True, "cru", "user_exclusive"),
])
def test_comanager_algorithm2_placements_match(multi_tenant, policy, tenancy):
    """The same registration, task, heartbeat, completion and liveness
    sequence gives the same placements (Algorithm 2) in both packages."""
    kw = dict(multi_tenant=multi_tenant, policy=policy, tenancy=tenancy)
    if policy == "noise_aware":
        kw["fidelity_floor"] = 0.9
    ms = [jmanager.CoManager(**kw), tmanager.CoManager(**kw)]
    for m in ms:
        for i, (q, err) in enumerate(((5, 0.0), (10, 0.001), (15, 0.004), (20, 0.0))):
            m.register_worker(f"w{i + 1}", q, cru=0.1 * i, t=0.0, error_rate=err)
    rnd = random.Random(len(tenancy or "") + len(policy) + multi_tenant)
    picks = ([], [])
    placed = []
    for tid in range(120):
        t = 0.05 * tid
        demand, depth = rnd.choice((5, 7)), rnd.choice((0, 12, 40))
        for k, (m, mod) in enumerate(zip(ms, (jworker, tworker))):
            task = mod.CircuitTask(tid, f"c{tid % 4}", demand, 1.0, depth=depth)
            wid = m.assign(task, t, exclude={"w2"} if tid % 11 == 0 else None)
            picks[k].append(wid)
            if wid is not None and k == 0:
                placed.append((wid, tid, demand, depth))
        if placed and tid % 3 == 0:
            wid, done, dem, dep = placed.pop(0)
            for m, mod in zip(ms, (jworker, tworker)):
                m.complete(wid, mod.CircuitTask(done, f"c{done % 4}", dem, 1.0, depth=dep), t)
        if tid % 10 == 9:
            for m in ms:
                for wid, v in list(m.workers.items()):
                    m.heartbeat({"worker_id": wid, "active": {}, "cru": 0.01 * tid,
                                 "completed": set()}, t)
    assert any(w is not None for w in picks[0]) and picks[0] == picks[1]
    assert ms[0].assignments == ms[1].assignments
    assert sorted(ms[0].workers) == sorted(ms[1].workers)
    for wid in ms[0].workers:
        a, b = _fields(ms[0].workers[wid]), _fields(ms[1].workers[wid])
        assert a == b
    dead = [m.liveness_check(1000.0, 5.0) for m in ms]
    assert dead[0] == dead[1] and ms[0].evictions == ms[1].evictions
