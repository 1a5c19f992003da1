"""The port's elastic fleet against the reference's, on the CPU.

Every test of ``tests/test_fleet.py`` and every property of
``tests/test_fleet_properties.py`` runs here on both packages: the same
numpy inputs (``rows_for`` draws them as the reference's tests do), the
same fleets, ``FaultSpec``s and ``FaultToleranceConfig``s.  The reference
runs as its own tests run it on the CPU; the port runs its kernels' plain
versions.

* The replay invariant: the port's futures equal the port's own fault-free
  direct call bit for bit (``torch.equal``), through crash migration,
  in-place retry, hedging and live membership, on both dispatchers.
* The port's futures are within 1e-5 of the reference's (float32
  fidelities: the reference's own kernel tolerance).
* Fleet states and counters equal the reference's wherever the reference
  pins them; sync dispatch is deterministic, so there the whole
  ``summary()["fleet"]`` equals the reference's.
* The health state machine, the fault schedules (the flaky hash's draws)
  and the virtual clock's fault kinds give the reference's values, and
  the simulations the reference's reports field for field.
* The properties draw from the reference's strategies and run both
  packages on every example, each capped at the reference's
  ``max_examples`` and under a time limit of its own (``time_limit``).
"""
import dataclasses
import functools
import importlib
import signal
import threading
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

ATOL = 1e-5


def _ns(root: str, asarray, stack) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return SimpleNamespace(
        root=root,
        faults=mod("comanager.faults"),
        fleet=mod("serve.fleet"),
        serve=mod("serve"),
        sim=mod("comanager.simulation"),
        JobSpec=mod("comanager.tenancy").JobSpec,
        WorkerConfig=mod("comanager.worker").WorkerConfig,
        QuClassiConfig=mod("core.quclassi").QuClassiConfig,
        kops=mod("kernels.ops"),
        api=mod("api"),
        mnist=mod("data.mnist"),
        asarray=asarray,
        stack=stack,
    )


REF = _ns("repro", lambda a: jnp.asarray(a, jnp.float32), jnp.stack)
PORT = _ns("repro_torch", torch.from_numpy, torch.stack)
BOTH = (REF, PORT)


def time_limit(seconds: float):
    """Fail a test that runs past ``seconds`` (SIGALRM on the main thread,
    where pytest runs tests; elsewhere the test runs unbounded), so no test
    holds the suite near its clock."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if threading.current_thread() is not threading.main_thread():
                return fn(*args, **kwargs)

            def expire(signum, frame):
                raise TimeoutError(f"{fn.__name__} ran past its {seconds} s limit")

            old = signal.signal(signal.SIGALRM, expire)
            signal.setitimer(signal.ITIMER_REAL, seconds)
            try:
                return fn(*args, **kwargs)
            finally:
                signal.setitimer(signal.ITIMER_REAL, 0)
                signal.signal(signal.SIGALRM, old)
        return run
    return deco


def rows_for(cfg, n, seed=0):
    """The reference's draws, as numpy float32."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, np.pi, (n, cfg.n_theta)).astype(np.float32)
    data = rng.uniform(0, np.pi, (n, cfg.n_angles)).astype(np.float32)
    return theta, data


def specs(mod):
    return mod.QuClassiConfig(qc=5, n_layers=1), mod.QuClassiConfig(qc=7, n_layers=1)


def submit_rows(rt, mod, client, spec, theta, data):
    t, d = mod.asarray(theta), mod.asarray(data)
    now = rt.dispatcher.clock
    return [rt.gateway.submit(client, spec, (t[i], d[i]), now()) for i in range(t.shape[0])]


def settle(rt, mode):
    if mode == "sync":
        rt.dispatcher.drain()
    else:
        rt.dispatcher.kick()


def results(mod, futs):
    return mod.stack([f.result(timeout=60.0) for f in futs])


def direct(mod, cfg, theta, data):
    return mod.kops.vqc_fidelity(cfg.spec, mod.asarray(theta), mod.asarray(data))


def assert_replay(port_got, port_direct, ref_got):
    """Port futures == the port's fault-free call bit for bit, and within
    1e-5 of the reference's futures."""
    assert torch.equal(port_got, port_direct)
    np.testing.assert_allclose(port_got.numpy(), np.asarray(ref_got), rtol=0, atol=ATOL)


def two_jobs(mod):
    return [
        mod.JobSpec("alice", n_circuits=30, qc=5, n_layers=1, submit_time=0.0),
        mod.JobSpec("bob", n_circuits=30, qc=5, n_layers=1, submit_time=0.0),
    ]


def plain(rep) -> dict:
    """Every field of a ``SimulationReport`` as plain data."""
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
    }


# ---------------------------------------------------- health state machine
def _mk(mod, **kw):
    fleet = mod.fleet.FleetHealth(mod.faults.FaultToleranceConfig(**kw))
    fleet.add("w1")
    return fleet


def _breaker_trips_after_consecutive_failures(mod):
    fleet = _mk(mod, breaker_threshold=3, breaker_cooldown_s=5.0)
    assert not fleet.on_failure("w1", 0.0)
    assert not fleet.on_failure("w1", 0.1)
    assert fleet.on_failure("w1", 0.2)  # third strike trips
    assert fleet.state("w1") == "offline"
    assert not fleet.placeable("w1", 1.0)
    assert "w1" in fleet.unplaceable(1.0)
    return fleet


def _success_resets_consecutive_count(mod):
    fleet = _mk(mod, breaker_threshold=2)
    fleet.on_failure("w1", 0.0)
    fleet.on_success("w1")
    assert not fleet.on_failure("w1", 0.1)  # count restarted
    assert fleet.state("w1") != "offline"
    return fleet


def _cooldown_half_opens_to_probation(mod):
    fleet = _mk(mod, breaker_threshold=1, breaker_cooldown_s=2.0)
    fleet.on_failure("w1", 0.0)
    assert not fleet.placeable("w1", 1.0)
    assert fleet.placeable("w1", 2.5)  # half-open trial
    assert fleet.state("w1") == "probation"
    return fleet


def _probation_failure_retrips_immediately(mod):
    fleet = _mk(mod, breaker_threshold=3, breaker_cooldown_s=2.0)
    for i in range(3):
        fleet.on_failure("w1", i * 0.1)
    assert fleet.placeable("w1", 3.0)
    assert fleet.on_failure("w1", 3.1)  # one probation strike re-trips
    assert fleet.state("w1") == "offline"
    assert fleet.snapshot()["w1"]["offline_trips"] == 2
    return fleet


def _probation_success_closes_breaker(mod):
    fleet = _mk(mod, breaker_threshold=1, breaker_cooldown_s=1.0)
    fleet.on_failure("w1", 0.0)
    assert fleet.placeable("w1", 2.0)
    fleet.on_success("w1")
    assert fleet.state("w1") in ("idle", "busy")
    assert fleet.snapshot()["w1"]["consecutive_errors"] == 0
    return fleet


def _failure_rate_is_ewma(mod):
    fleet = _mk(mod, failure_alpha=0.5, breaker_threshold=100)
    fleet.on_failure("w1", 0.0)
    assert fleet.snapshot()["w1"]["failure_rate"] == pytest.approx(0.5)
    fleet.on_success("w1")
    assert fleet.snapshot()["w1"]["failure_rate"] == pytest.approx(0.25)
    return fleet


def _draining_not_placeable_and_never_trips(mod):
    fleet = _mk(mod, breaker_threshold=1)
    fleet.mark_draining("w1")
    assert not fleet.placeable("w1", 0.0)
    assert not fleet.on_failure("w1", 0.0)  # drain beats breaker
    assert fleet.state("w1") == "draining"
    return fleet


def _maintenance_and_reactivate(mod):
    fleet = _mk(mod)
    fleet.mark_maintenance("w1")
    assert not fleet.placeable("w1", 0.0)
    fleet.reactivate("w1")
    assert fleet.placeable("w1", 0.0)
    return fleet


def _busy_slot_accounting(mod):
    fleet = _mk(mod)
    fleet.on_dispatch("w1")
    assert fleet.state("w1") == "busy"
    fleet.on_release("w1")
    assert fleet.state("w1") == "idle"
    return fleet


def _snapshot_counters(mod):
    fleet = _mk(mod, breaker_threshold=2)
    fleet.on_dispatch("w1")
    fleet.on_failure("w1", 0.0)
    fleet.record_retry("w1")
    fleet.record_migration("w1")
    fleet.record_hedge("w1")
    snap = fleet.snapshot()["w1"]
    assert snap["failures"] == 1
    assert snap["retries"] == 1
    assert snap["migrations"] == 1
    assert snap["hedges"] == 1
    assert snap["state"] == "busy"
    return fleet


HEALTH = [_breaker_trips_after_consecutive_failures, _success_resets_consecutive_count,
          _cooldown_half_opens_to_probation, _probation_failure_retrips_immediately,
          _probation_success_closes_breaker, _failure_rate_is_ewma,
          _draining_not_placeable_and_never_trips, _maintenance_and_reactivate,
          _busy_slot_accounting, _snapshot_counters]


@pytest.mark.parametrize("scenario", HEALTH, ids=[s.__name__[1:] for s in HEALTH])
def test_fleet_health_matches_reference(scenario):
    """Each of the reference's ``TestFleetHealth`` cases holds on both
    packages, and the two fleets end in the same vitals, field for field."""
    ref, port = (scenario(mod) for mod in BOTH)
    assert port.snapshot() == ref.snapshot()
    assert port.workers() == ref.workers()
    for now in (0.0, 1.0, 3.0, 10.0):  # the same (possibly half-opening) answers
        assert port.placeable("w1", now) == ref.placeable("w1", now)
        assert port.retryable("w1", now) == ref.retryable("w1", now)
    assert port.snapshot() == ref.snapshot()


# ------------------------------------------------- fault-schedule validation
@pytest.mark.parametrize(
    "bad",
    [
        {"kind": "nope"},
        {"at": -1.0},
        {"at": float("nan")},
        {"kind": "crash_recover", "at": 5.0, "recover_at": 2.0},
        {"kind": "crash_recover", "at": 5.0, "recover_at": float("inf")},
        {"kind": "slowdown", "factor": 0.0},
        {"kind": "flaky", "p": 1.5},
        "never",
    ],
)
def test_invalid_specs_name_the_worker(bad):
    msgs = []
    for mod in BOTH:
        with pytest.raises(ValueError, match="w1") as err:
            mod.faults.normalize_failures({"w1": bad})
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_legacy_float_still_means_crash():
    ref, port = (mod.faults.normalize_failures({"w1": 3.5})["w1"] for mod in BOTH)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.kind == "crash" and port.at == 3.5
    assert not port.crashed(3.0) and port.crashed(4.0)


def test_crash_recover_window():
    ref, port = (mod.faults.FaultSpec(kind="crash_recover", at=2.0, recover_at=5.0)
                 for mod in BOTH)
    assert not port.crashed(1.0)
    assert port.crashed(2.0) and port.crashed(4.9)
    assert not port.crashed(5.0)
    assert port.crashed_between(1.0, 3.0)
    assert not port.crashed_between(5.0, 9.0)
    for t in np.linspace(0.0, 8.0, 33):
        assert port.crashed(t) == ref.crashed(t)
        assert port.crashed_between(t, t + 1.5) == ref.crashed_between(t, t + 1.5)


@pytest.mark.parametrize("p,seed,at,recover_at", [(0.5, 7, 0.0, None), (0.3, 0, 0.0, None),
                                                   (0.05, 123, 1.0, 4.0), (0.97, 2**31, 0.0, None)])
def test_flaky_drops_deterministic_and_retries_progress(p, seed, at, recover_at):
    """The deterministic flaky hash gives the reference's exact draws over
    tokens, attempts, seeds and the fault window, and retries progress."""
    ref, port = (mod.faults.FaultSpec(kind="flaky", p=p, seed=seed, at=at,
                                      recover_at=recover_at) for mod in BOTH)
    draws = [port.drops(11, k, at) for k in range(64)]
    assert draws == [port.drops(11, k, at) for k in range(64)]
    assert any(draws) and not all(draws)  # retries eventually pass
    for token in (0, 1, 11, 2**20 + 3, 2**40):
        for t in (0.0, 0.5, 2.0, 3.9, 4.0, 9.0):
            assert [port.drops(token, k, t) for k in range(64)] == \
                   [ref.drops(token, k, t) for k in range(64)]


def test_simulation_rejects_bad_schedule_at_construction():
    msgs = []
    for mod in BOTH:
        with pytest.raises(ValueError, match="w1") as err:
            mod.sim.SystemSimulation(
                mod.sim.homogeneous_workers(2, 10),
                two_jobs(mod),
                worker_failures={"w1": {"kind": "flaky", "p": -0.1}},
            )
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------- real dispatchers: crash replay
def crash_runtime(mod, mode, **ft_kw):
    """Two-worker runtime with w1 hard-crashed from t=0: every batch placed
    on (or retried against) w1 fails, trips its breaker, and must migrate
    to w2 through the coalescer requeue path."""
    ft = mod.faults.FaultToleranceConfig(
        retry_limit=0, breaker_threshold=1, breaker_cooldown_s=3600.0, **ft_kw
    )
    inj = mod.fleet.FaultInjector({"w1": mod.faults.FaultSpec(kind="crash", at=0.0)})
    return mod.serve.GatewayRuntime(
        workers=[mod.WorkerConfig("w1", 10), mod.WorkerConfig("w2", 10)],
        target=8,
        lanes=8,
        deadline=0.05,
        mode=mode,
        fault_tolerance=ft,
        fault_injector=inj,
    )


def _crash_migration(mod, mode):
    cfg5, cfg7 = specs(mod)
    rows = {"alice": (cfg5, *rows_for(cfg5, 8, seed=1)),
            "bob": (cfg7, *rows_for(cfg7, 8, seed=2))}
    rt = crash_runtime(mod, mode)
    try:
        futs = {c: submit_rows(rt, mod, c, cfg.spec, th, dt) for c, (cfg, th, dt) in rows.items()}
        settle(rt, mode)
        got = {c: results(mod, fs) for c, fs in futs.items()}
        assert all(f.done for fs in futs.values() for f in fs)
        state = rt.dispatcher.fleet.state("w1")
    finally:
        rt.close()
    return got, {c: direct(mod, *r) for c, r in rows.items()}, state, rt.telemetry.summary()


@pytest.mark.parametrize("mode", ["sync", "async"])
@time_limit(120)
def test_crash_migration_is_bit_identical(mode):
    """A worker crash migrates the batch to a survivor, and every future
    resolves to exactly the value a fault-free run gives: no lost futures,
    no duplicates, on both packages."""
    ref, port = (_crash_migration(mod, mode) for mod in BOTH)
    for c in port[0]:
        assert_replay(port[0][c], port[1][c], ref[0][c])
        assert np.array_equal(np.asarray(ref[0][c]), np.asarray(ref[1][c]))
    for _, _, state, summary in (ref, port):
        assert state == "offline"
        assert summary["migrated_batches"] >= 1
        assert summary["fleet"]["w1"]["failures"] >= 1
        assert summary["fleet"]["w1"]["migrations"] >= 1
        assert summary["fleet"]["w1"]["offline_trips"] >= 1
    if mode == "sync":
        assert port[3]["fleet"] == ref[3]["fleet"]
        assert port[3]["migrated_batches"] == ref[3]["migrated_batches"]


def _terminal_failure(mod):
    cfg5, _ = specs(mod)
    ft = mod.faults.FaultToleranceConfig(retry_limit=0, breaker_threshold=1)
    inj = mod.fleet.FaultInjector({
        "w1": mod.faults.FaultSpec(kind="crash", at=0.0),
        "w2": mod.faults.FaultSpec(kind="crash", at=0.0),
    })
    rt = mod.serve.GatewayRuntime(
        workers=[mod.WorkerConfig("w1", 10), mod.WorkerConfig("w2", 10)],
        target=8, lanes=8, deadline=0.05, mode="sync",
        fault_tolerance=ft, fault_injector=inj,
    )
    try:
        futs = submit_rows(rt, mod, "alice", cfg5.spec, *rows_for(cfg5, 8))
        with pytest.raises(mod.fleet.InjectedWorkerFault):
            rt.dispatcher.drain()
        assert all(f.done for f in futs)
        for f in futs:
            with pytest.raises(mod.fleet.InjectedWorkerFault):
                f.result(timeout=1.0)
    finally:
        rt.close()
    return rt.telemetry.summary()


@time_limit(60)
def test_sync_terminal_failure_fails_futures():
    """Both workers crashed: no survivor to migrate to, so the batch's
    futures resolve with the error (not hang) and ``run_batch`` raises it."""
    ref, port = (_terminal_failure(mod) for mod in BOTH)
    assert port["fleet"] == ref["fleet"]
    assert port["fleet"]["w1"]["offline_trips"] == port["fleet"]["w2"]["offline_trips"] == 1


def _transient_retry(mod, mode):
    cfg5, _ = specs(mod)
    boom = {"n": 0}

    def flaky_kernel(spec, theta, data):
        boom["n"] += 1
        if boom["n"] == 1:
            raise RuntimeError("transient kernel fault")
        return mod.kops.vqc_fidelity(spec, theta, data)

    rt = mod.serve.GatewayRuntime(
        workers=[mod.WorkerConfig("w1", 10)],
        target=8, lanes=8, deadline=0.05, mode=mode, kernel=flaky_kernel,
        fault_tolerance=mod.faults.FaultToleranceConfig(retry_limit=2, breaker_threshold=5),
    )
    theta, data = rows_for(cfg5, 8)
    try:
        futs = submit_rows(rt, mod, "alice", cfg5.spec, theta, data)
        settle(rt, mode)
        got = results(mod, futs)
        state = rt.dispatcher.fleet.state("w1")
    finally:
        rt.close()
    return got, direct(mod, cfg5, theta, data), state, rt.telemetry.summary()


@pytest.mark.parametrize("mode", ["sync", "async"])
@time_limit(60)
def test_transient_failure_retries_in_place(mode):
    """A kernel that fails exactly once recovers through the in-place retry:
    no migration, and the retry shows in the fleet's telemetry."""
    ref, port = (_transient_retry(mod, mode) for mod in BOTH)
    assert_replay(port[0], port[1], ref[0])
    for _, _, state, summary in (ref, port):
        assert summary["fleet"]["w1"]["retries"] == 1
        assert "migrated_batches" not in summary
        assert state in ("idle", "busy")
    if mode == "sync":
        assert port[3]["fleet"] == ref[3]["fleet"]


# ----------------------------------------------------------------- hedging
def _hedge(mod):
    cfg5, _ = specs(mod)
    gate = threading.Event()
    calls = {"n": 0}

    def stall_first_kernel(spec, theta, data):
        calls["n"] += 1
        if calls["n"] == 1:
            assert gate.wait(timeout=30.0), "test gate never released"
        return mod.kops.vqc_fidelity(spec, theta, data)

    rt = mod.serve.GatewayRuntime(
        workers=[mod.WorkerConfig("w1", 10), mod.WorkerConfig("w2", 10)],
        target=8, lanes=8, deadline=0.05, mode="async", kernel=stall_first_kernel,
        fault_tolerance=mod.faults.FaultToleranceConfig(hedge_k=0.05, breaker_threshold=10),
    )
    theta, data = rows_for(cfg5, 8)
    futs = []
    try:
        futs = submit_rows(rt, mod, "alice", cfg5.spec, theta, data)
        rt.dispatcher.kick()
        got = results(mod, futs)  # the hedge resolved these
        assert not gate.is_set()
        summary = rt.telemetry.summary()
    finally:
        gate.set()
        rt.close()
        # the straggler settled without touching the already-set futures
        assert all(f.done for f in futs)
    hedges = sum(ev["hedges"] for ev in summary["fleet"].values())
    return got, direct(mod, cfg5, theta, data), hedges, calls["n"]


@time_limit(90)
def test_async_hedge_first_result_wins():
    """A stalled primary slot past hedge_k x the service estimate gets a
    duplicate on the other worker; the duplicate resolves the futures while
    the straggler is stuck, and the straggler's late result is dropped."""
    ref, port = (_hedge(mod) for mod in BOTH)
    assert_replay(port[0], port[1], ref[0])
    for _, _, hedges, calls in (ref, port):
        assert hedges >= 1
        assert calls == 2  # the straggler and its hedge, one launch each


# --------------------------------------------------------- live membership
def _register(mod, mode):
    _, cfg7 = specs(mod)
    rt = mod.serve.GatewayRuntime(workers=[mod.WorkerConfig("w1", 5)], target=8, lanes=8,
                                  deadline=0.05, mode=mode)
    theta, data = rows_for(cfg7, 8)
    try:
        rt.dispatcher.register_worker(mod.WorkerConfig("w2", 10))
        assert set(rt.dispatcher.fleet.workers()) == {"w1", "w2"}
        futs = submit_rows(rt, mod, "alice", cfg7.spec, theta, data)
        settle(rt, mode)
        got = results(mod, futs)
        with pytest.raises(ValueError) as err:
            rt.dispatcher.register_worker(mod.WorkerConfig("w2", 10))  # duplicate
        if mode == "async":
            assert rt.dispatcher._pool._max_workers == 2 * rt.dispatcher.slots_per_worker + 1
    finally:
        rt.close()
    return got, direct(mod, cfg7, theta, data), str(err.value), rt.dispatcher.batch_log


@pytest.mark.parametrize("mode", ["sync", "async"])
@time_limit(60)
def test_register_worker_adds_capacity_at_runtime(mode):
    """A fleet of one 5q worker cannot host 7q circuits; registering a 10q
    worker at runtime makes them servable without a restart."""
    ref, port = (_register(mod, mode) for mod in BOTH)
    assert_replay(port[0], port[1], ref[0])
    assert port[2] == ref[2]
    assert port[3] == ref[3] == [("w2", 8, ("alice",))]


def _drain(mod, mode):
    cfg5, _ = specs(mod)
    rt = mod.serve.GatewayRuntime(
        workers=[mod.WorkerConfig("w1", 10), mod.WorkerConfig("w2", 10)],
        target=8, lanes=8, deadline=0.05, mode=mode,
    )
    theta, data = rows_for(cfg5, 8)
    try:
        futs = submit_rows(rt, mod, "alice", cfg5.spec, theta, data)
        settle(rt, mode)
        first = results(mod, futs)
        rt.dispatcher.drain_worker("w1")
        assert "w1" not in rt.dispatcher.fleet.workers()
        assert "w1" not in rt.dispatcher.manager.workers
        n_before = len(rt.dispatcher.batch_log)
        futs2 = submit_rows(rt, mod, "alice", cfg5.spec, theta, data)
        settle(rt, mode)
        second = results(mod, futs2)
        later = {wid for wid, _, _ in rt.dispatcher.batch_log[n_before:]}
        with pytest.raises(KeyError) as err:
            rt.dispatcher.drain_worker("nope")
    finally:
        rt.close()
    return first, second, direct(mod, cfg5, theta, data), later, str(err.value)


@pytest.mark.parametrize("mode", ["sync", "async"])
@time_limit(60)
def test_drain_worker_removes_it_gracefully(mode):
    """Draining waits for in-flight work, then forgets the worker: it stops
    being placeable and later submissions run on the survivors."""
    ref, port = (_drain(mod, mode) for mod in BOTH)
    assert_replay(port[0], port[2], ref[0])
    assert_replay(port[1], port[2], ref[1])
    assert port[3] == ref[3] == {"w2"}
    assert port[4] == ref[4]


# ----------------------------------------------- bounded error ring buffer
def _error_ring(mod):
    rt = mod.serve.GatewayRuntime(workers=[mod.WorkerConfig("w1", 5)], target=8, lanes=8,
                                  deadline=0.05, mode="async")
    try:
        d = rt.dispatcher
        cap = d.ERRORS_CAPACITY
        with d._cv:
            for i in range(cap + 10):
                d._push_error_locked(RuntimeError(f"e{i}"))
        assert len(d.errors) == cap
        assert d.errors_dropped == 10
        # oldest entries were evicted, newest retained
        assert str(d.errors[-1]) == f"e{cap + 9}"
        return cap, [str(e) for e in d.errors], d.errors_dropped
    finally:
        rt.close()


@time_limit(30)
def test_async_error_ring_is_bounded():
    ref, port = (_error_ring(mod) for mod in BOTH)
    assert port == ref
    assert port[0] == 256


# ----------------------------------------- the facade's fault tolerance
def _session_train(mod, bank_mode, crash):
    """One epoch of ``Session.train`` on a sync ``QuantumCluster`` whose
    ``ServingConfig.fault_tolerance`` migrates at the first failure; with
    ``crash``, w1 (where sync placement puts 5-qubit batches) is down from
    the start."""
    x, y = mod.mnist.make_pair_dataset(3, 9, n_per_class=4, seed=0)
    serving = mod.api.ServingConfig(fault_tolerance=mod.faults.FaultToleranceConfig(
        retry_limit=0, breaker_threshold=1, breaker_cooldown_s=3600.0))
    device = {"device": "cpu"} if mod is PORT else {}
    with mod.api.QuantumCluster(mod.api.ClusterConfig(serving=serving), **device) as cluster:
        if crash:
            cluster.runtime.dispatcher.fault_injector = mod.fleet.FaultInjector(
                {"w1": mod.faults.FaultSpec(kind="crash", at=0.0)})
        rep = cluster.session("alice", bank_mode=bank_mode).train(
            mod.QuClassiConfig(qc=5, n_layers=1), (x[:4], y[:4]), (x[4:], y[4:]),
            epochs=1, batch_size=4, lr=0.05, seed=0)
        return rep, cluster.runtime.telemetry.summary()


@pytest.mark.parametrize("bank_mode", ["implicit", "materialized"])
@time_limit(120)
def test_session_train_under_a_crash_equals_fault_free(bank_mode):
    """``ServingConfig.fault_tolerance`` reaches the cluster's runtime: a
    tenant's ``Session.train`` through a crash migrates its batches and
    gives the fault-free run's loss and parameters bit for bit, on both
    packages, with the reference's fleet counters."""
    runs = {mod.root: [_session_train(mod, bank_mode, crash) for crash in (False, True)]
            for mod in BOTH}
    (ref_free, _), (ref_crash, ref_summary) = runs["repro"]
    (free, _), (crash, summary) = runs["repro_torch"]
    assert crash.epochs[0].loss == free.epochs[0].loss
    assert all(torch.equal(crash.params[k], free.params[k]) for k in free.params)
    assert ref_crash.epochs[0].loss == ref_free.epochs[0].loss
    assert summary["migrated_batches"] >= 1
    assert summary["fleet"] == ref_summary["fleet"]
    assert summary["migrated_batches"] == ref_summary["migrated_batches"]


# ------------------------------------------------- simulation fault parity
def _sim_crash_recover(mod):
    sim = mod.sim.SystemSimulation(
        mod.sim.homogeneous_workers(3, 10), two_jobs(mod), heartbeat_period=1.0,
        worker_failures={"w1": mod.faults.FaultSpec(kind="crash_recover", at=0.2,
                                                    recover_at=5.0)},
    )
    r = sim.run()
    assert r.total_circuits == 60
    assert set(r.jobs) == {"alice", "bob"}
    # the recovered worker re-registered and did real work afterwards
    assert "w1" in sim.manager.workers
    return r


def _sim_slowdown(mod):
    base = mod.sim.SystemSimulation(mod.sim.homogeneous_workers(2, 10), two_jobs(mod)).run()
    slow = mod.sim.SystemSimulation(
        mod.sim.homogeneous_workers(2, 10), two_jobs(mod),
        worker_failures={"w1": {"kind": "slowdown", "at": 0.0, "factor": 4.0}},
    ).run()
    assert slow.total_circuits == base.total_circuits == 60
    assert slow.makespan > base.makespan
    return slow


def _sim_flaky(mod):
    r = mod.sim.SystemSimulation(
        mod.sim.homogeneous_workers(2, 10), two_jobs(mod),
        worker_failures={"w1": {"kind": "flaky", "p": 0.4}},
    ).run()
    assert r.total_circuits == 60 and set(r.jobs) == {"alice", "bob"}
    return r


def _sim_gateway_crash_recover(mod):
    r = mod.sim.SystemSimulation(
        mod.sim.homogeneous_workers(3, 10), two_jobs(mod), gateway=True,
        gateway_deadline=0.2, heartbeat_period=1.0,
        worker_failures={"w1": mod.faults.FaultSpec(kind="crash_recover", at=0.1,
                                                    recover_at=6.0)},
    ).run()
    assert set(r.jobs) == {"alice", "bob"}
    assert r.gateway_summary["migrated_batches"] >= 1
    assert r.gateway_summary["migrated_circuits"] >= 1
    return r


def _sim_gateway_flaky(mod):
    r = mod.sim.SystemSimulation(
        mod.sim.homogeneous_workers(2, 10), two_jobs(mod), gateway=True,
        gateway_deadline=0.2,
        worker_failures={"w1": {"kind": "flaky", "p": 0.5}},
    ).run()
    assert set(r.jobs) == {"alice", "bob"}
    assert r.gateway_summary["migrated_batches"] >= 1
    return r


SIMS = [_sim_crash_recover, _sim_slowdown, _sim_flaky, _sim_gateway_crash_recover,
        _sim_gateway_flaky]
SIM_IDS = ["crash_recover_completes_all_jobs", "slowdown_stretches_makespan",
           "flaky_worker_completes_via_requeue", "gateway_crash_recover_migrates_batches",
           "gateway_flaky_requeues_through_coalescer"]


@pytest.mark.parametrize("scenario", SIMS, ids=SIM_IDS)
def test_sim_fault_kinds_match_reference(scenario):
    """The virtual clock's fault kinds, on both packages: the reference's
    assertions hold, and the reports agree field for field."""
    ref, port = (plain(scenario(mod)) for mod in BOTH)
    for field in ref:
        assert port[field] == ref[field], field


# ------------------------------------------------------------- properties
def lane_kernel(mod):
    """A cheap stand-in for the kernel, per lane independent (lane i's value
    depends on row i alone, so migration and re-coalescing cannot change
    it), in [0, 1] like a fidelity: the mean angle over pi."""
    def run(spec, theta, data):
        n = theta.shape[-1] + data.shape[-1]
        return (theta.sum(-1) + data.sum(-1)) / (np.float32(np.pi) * n)
    return run


def _single_worker_crash(mod, crash_worker, crash_at, recover_after, seed):
    cfg = mod.QuClassiConfig(qc=5, n_layers=1)
    spec = mod.faults.FaultSpec(
        kind="crash" if recover_after is None else "crash_recover",
        at=crash_at,
        recover_at=None if recover_after is None else crash_at + recover_after,
    )
    kernel = lane_kernel(mod)
    rt = mod.serve.GatewayRuntime(
        workers=[mod.WorkerConfig("w1", 10), mod.WorkerConfig("w2", 10)],
        target=4, lanes=4, deadline=0.02, mode="async", kernel=kernel,
        fault_tolerance=mod.faults.FaultToleranceConfig(
            retry_limit=1, breaker_threshold=1, breaker_cooldown_s=0.05),
        fault_injector=mod.fleet.FaultInjector({crash_worker: spec}),
    )
    theta, data = rows_for(cfg, 8, seed)
    try:
        futs = submit_rows(rt, mod, "t", cfg.spec, theta, data)
        rt.dispatcher.kick()
        got = results(mod, futs)
        # exactly once: CircuitFuture.set asserts on double resolution, so
        # done-ness here proves one settlement per circuit
        assert all(f.done for f in futs)
    finally:
        rt.close()
    return got, kernel(cfg.spec, mod.asarray(theta), mod.asarray(data))


@time_limit(240)
@settings(max_examples=15, deadline=None)
@given(
    crash_worker=st.sampled_from(["w1", "w2"]),
    crash_at=st.floats(0.0, 0.05, allow_nan=False),
    recover_after=st.one_of(st.none(), st.floats(0.01, 0.1, allow_nan=False)),
    seed=st.integers(0, 2**16),
)
def test_single_worker_crash_is_bit_identical(crash_worker, crash_at, recover_after, seed):
    """Any single-worker crash schedule on the real async dispatcher, on
    both packages: every future resolves exactly once, to the fault-free
    bits, with no lost or duplicated future across requeue and re-placement."""
    ref, port = (_single_worker_crash(mod, crash_worker, crash_at, recover_after, seed)
                 for mod in BOTH)
    assert np.array_equal(np.asarray(ref[0]), np.asarray(ref[1]))
    assert_replay(port[0], port[1], ref[0])


def _requeue(mod, counts, requeue_idx):
    gw = mod.serve.Gateway(target=4, deadline=10.0, lanes=4)
    seq = 0
    for ci, n in enumerate(counts):
        gw.register_client(f"c{ci}")
        for _ in range(n):
            gw.submit(f"c{ci}", ("k", 5), payload=seq, now=0.0)
            seq += 1
    batches = list(gw.pump(0.0)) + list(gw.flush(1e9))
    all_members = [m.seq for b in batches for m in b.members]
    assert sorted(all_members) == list(range(seq))  # nothing lost at emit
    victim = batches[requeue_idx % len(batches)]
    victim_seqs = [m.seq for m in victim.members]
    gw.requeue(victim, now=2.0)
    replayed = list(gw.pump(2.0)) + list(gw.flush(1e9))
    replayed_seqs = [m.seq for b in replayed for m in b.members]
    # exactly the victim's members come back, in the same relative order
    assert replayed_seqs == victim_seqs
    assert gw.idle
    shape = lambda bs: [([m.seq for m in b.members], [m.client_id for m in b.members])  # noqa
                        for b in bs]
    return shape(batches), shape(replayed), repr(gw.telemetry.summary())


@time_limit(120)
@settings(max_examples=30, deadline=None)
@given(
    counts=st.lists(st.integers(1, 9), min_size=1, max_size=4),
    requeue_idx=st.integers(0, 7),
)
def test_requeue_conserves_members_and_order(counts, requeue_idx):
    """``gateway.requeue`` of an emitted batch re-coalesces every member once,
    at the front of the queue, in the batch's lane order, on both packages,
    with the same batches and telemetry."""
    ref, port = (_requeue(mod, counts, requeue_idx) for mod in BOTH)
    assert port == ref


def _sim_crash_schedule(mod, widx, at, recover_after):
    spec = mod.faults.FaultSpec(
        kind="crash" if recover_after is None else "crash_recover",
        at=at,
        recover_at=None if recover_after is None else at + recover_after,
    )
    r = mod.sim.SystemSimulation(
        mod.sim.homogeneous_workers(3, 10),
        [mod.JobSpec("alice", n_circuits=20, qc=5, n_layers=1, submit_time=0.0),
         mod.JobSpec("bob", n_circuits=20, qc=5, n_layers=2, submit_time=0.2)],
        gateway=True, gateway_deadline=0.2, heartbeat_period=1.0,
        worker_failures={f"w{widx}": spec},
    ).run()
    assert r.total_circuits == 40
    assert set(r.jobs) == {"alice", "bob"}
    return plain(r)


@time_limit(120)
@settings(max_examples=10, deadline=None)
@given(
    widx=st.integers(1, 3),
    at=st.floats(0.05, 3.0, allow_nan=False),
    recover_after=st.one_of(st.none(), st.floats(0.5, 4.0, allow_nan=False)),
)
def test_sim_crash_schedule_conserves_circuits(widx, at, recover_after):
    """Under any single-worker crash (and recover) schedule the gateway-mode
    simulation completes every circuit of every tenant, and the port's
    report is the reference's."""
    ref, port = (_sim_crash_schedule(mod, widx, at, recover_after) for mod in BOTH)
    for field in ref:
        assert port[field] == ref[field], field
