"""The port's serving layer (``repro_torch.serve``) against the reference's
(``repro.serve``), on the CPU, where the kernels' plain versions stand in
for the CUDA kernels.

* The coalescer and the gateway are the reference's code: on a fake clock
  the same submissions give the same batches (members and order), the
  same errors and the same telemetry in both packages.
* The sync runtime on the Fig-6 client mix gives the reference's batch log
  and telemetry counters, and fidelities within 1e-5 (float32, another
  evaluation order: the reference's own kernel tolerance).
* The async runtime is pinned port against port: out-of-order futures,
  async == sync bit for bit, mixed-SLO fusion bit for bit.
* This slice's decisions: the serving lane width is the reference's 128
  while a kernel receives exactly ``batch.n`` rows; the per-block memory
  model flags 17-qubit rows, not 7-qubit ones; a shift plan beyond m = 12
  is refused at admission.
* Training through the gateway: two tenants sharing one runtime start from
  the reference's weights (torch cannot draw jax's random stream) and take
  the reference's first step: loss and gradients within 1e-5 scaled by the
  step's largest BCE chain factor (ROADMAP Queue 3, R2).
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.comanager.worker import WorkerConfig as JWorker
from repro.core import quclassi as jq
from repro.core import shift_rule as jsr
from repro.core import trainer as jtrainer
from repro.data import mnist as jmnist
from repro_torch.comanager.worker import WorkerConfig as TWorker
from repro_torch.core import circuits
from repro_torch.core import fidelity as tfid
from repro_torch.core import quclassi as tq
from repro_torch.core import shift_rule as tsr
from repro_torch.core import trainer as ttrainer
from repro_torch.kernels import ops
from repro_torch.kernels import vqc_statevector as K
from repro_torch.obs import TraceRecorder

ATOL = 1e-5
FIG6_CLIENTS = (("5q1l", 5, 1), ("5q2l", 5, 2), ("7q1l", 7, 1), ("7q2l", 7, 2))


def _item(mod, key, cid, seq, arrival=0.0):
    return mod.PendingCircuit(key=key, client_id=cid, seq=seq, arrival=arrival, payload=seq)


def _shape(batches):
    return [(b.key, [m.seq for m in b.members], [m.client_id for m in b.members],
             b.by_deadline, b.n, b.lane_count, b.padded()) for b in batches]


# --------------------------------------------- coalescer / gateway scenarios
def _size_flush(mod):
    c = mod.Coalescer(target=8, lanes=4, deadline=10.0)
    out = []
    for i in range(19):
        out += c.add(_item(mod, "k", "a", i))
    return _shape(out), c.buffered, c.buffered_lanes


def _deadline_flush(mod):
    c = mod.Coalescer(target=8, lanes=4, deadline=1.0)
    c.add(_item(mod, "k", "a", 0, arrival=0.0))
    c.add(_item(mod, "k", "a", 1, arrival=0.4))
    return (_shape(c.flush_due(now=0.5)), c.next_deadline(), _shape(c.flush_due(now=1.0)),
            c.buffered, c.oldest_wait(2.0))


def _keys_isolated(mod):
    c = mod.Coalescer(target=4, lanes=4, deadline=10.0)
    out = []
    for i in range(4):
        out += c.add(_item(mod, "k5", "a", 2 * i))
        out += c.add(_item(mod, "k7", "b", 2 * i + 1))
    return _shape(out)


def _requeue(mod):
    c = mod.Coalescer(target=4, lanes=4, deadline=1.0)
    full = []
    for i in range(4):
        full += c.add(_item(mod, "k", "a", i))
    c.add(_item(mod, "k", "a", 4, arrival=3.0))
    c.requeue(full[0])
    return _shape(c.flush_due(now=5.0)), c.next_deadline(), _shape(c.flush_all(now=6.0))


def _weighted_fair(mod):
    g = mod.Gateway(target=128, lanes=128, deadline=100.0)
    g.register_client("a", weight=2.0)
    g.register_client("b", weight=1.0)
    for i in range(30):
        g.submit("a", "k", i, now=0.0)
        g.submit("b", "k", 100 + i, now=0.0)
    out = g.pump(now=0.0)
    order = [m.client_id for m in g.coalescer._buffers["k"]]
    return _shape(out), order, _shape(g.flush(now=1.0)), g.idle


def _late_joiner(mod):
    g = mod.Gateway(target=128, lanes=128, deadline=100.0)
    for i in range(40):
        g.submit("a", "k", i, now=0.0)
    g.pump(now=0.0)
    g.register_client("b")
    for i in range(8):
        g.submit("a", "k", i, now=1.0)
        g.submit("b", "k", i, now=1.0)
    g.pump(now=1.0)
    return [m.client_id for m in g.coalescer._buffers["k"]]


def _backpressure(mod):
    g = mod.Gateway(target=128, deadline=100.0, max_pending=4)
    errors = []
    for i in range(6):
        try:
            g.submit("a", "k", i, now=0.0)
        except mod.Backpressure as exc:
            errors.append(str(exc))
    g.submit("b", "k", 0, now=0.0)
    return errors, g.telemetry.tenants["a"].rejected, g.telemetry.summary()


def _in_flight_cap(mod):
    g = mod.Gateway(target=4, lanes=4, deadline=100.0)
    g.register_client("a", max_in_flight=4)
    g.register_client("b")
    for i in range(8):
        g.submit("a", "k", i, now=0.0)
    first = g.pump(now=0.0)
    stalled = g.pump(now=0.0)
    g.complete(first[0], [0.5] * 4, now=1.0)
    g.submit("b", "k", 100, now=1.0)
    return _shape(first), _shape(stalled), _shape(g.pump(now=1.0)), g.telemetry.summary()


def _tier_caps(mod):
    g = mod.Gateway(target=4, lanes=4, deadline=100.0, max_pending_per_tier={0: 6, 1: 3})
    g.register_client("hi-a", priority=0, weight=2.0)
    g.register_client("hi-b", priority=0)
    g.register_client("lo", priority=1)
    log = []
    for i in range(8):
        for cid in ("hi-a", "hi-b", "lo"):
            try:
                g.submit(cid, "k", i, now=0.1 * i)
                log.append((cid, i, "ok"))
            except mod.Backpressure as exc:
                log.append((cid, i, str(exc)))
    out = g.pump(now=1.0)
    for b in out:
        g.complete(b, [0.0] * b.n, now=2.0)
    g.submit("lo", "k", 99, now=2.0)
    return log, _shape(out), _shape(g.flush(now=3.0)), g.telemetry.summary()


def _priority_and_slo(mod):
    g = mod.Gateway(target=128, lanes=128, deadline=10.0)
    g.register_client("batch", priority=1)
    g.register_client("live", priority=0, slo_ms=400.0)
    for i in range(5):
        g.submit("batch", "k", i, now=0.0)
        g.submit("live", "k", 100 + i, now=0.0)
    g.pump(now=0.0)
    order = [m.client_id for m in g.coalescer._buffers["k"]]
    deadline = g.next_deadline()
    due = g.pump(now=0.2)
    for b in due:
        g.complete(b, list(range(b.n)), now=0.9)
    return order, deadline, _shape(due), g.telemetry.summary()


def _fail_evict_requeue(mod):
    g = mod.Gateway(target=4, lanes=4, deadline=1.0)
    futs = [g.submit("a", "k", i, now=0.0) for i in range(12)]
    b1, b2, b3 = g.pump(now=0.0)
    g.fail(b1, RuntimeError("boom"), now=0.5)
    g.evict(b2, now=0.5)
    g.requeue(b3, now=0.5)
    again = g.flush(now=0.6)
    for b in again:
        g.complete(b, [7] * b.n, now=0.7)
    states = [(f.done, type(f._error).__name__ if f._error else f._value) for f in futs]
    return _shape(again), states, g.idle, g.telemetry.summary()


SCENARIOS = [_size_flush, _deadline_flush, _keys_isolated, _requeue, _weighted_fair,
             _late_joiner, _backpressure, _in_flight_cap, _tier_caps, _priority_and_slo,
             _fail_evict_requeue]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__[1:] for s in SCENARIOS])
def test_gateway_matches_reference_on_fake_clock(scenario):
    # repr: summaries hold NaN latencies where nothing completed
    assert repr(scenario(tserve)) == repr(scenario(jserve))


def test_futures_and_service_model_match():
    for mod in (jserve, tserve):
        g = mod.Gateway(target=4, lanes=4, deadline=100.0)
        futs = [g.submit("a", "k", i, now=0.0) for i in range(4)]
        (batch,) = g.pump(now=0.0)
        g.complete(batch, [10, 11, 12, 13], now=1.0)
        assert [f.value for f in futs] == [10, 11, 12, 13]
    ms = [mod.ServiceModel(alpha=0.5, default_s=1.0) for mod in (jserve, tserve)]
    for m in ms:
        m.update("k", 100.0, 2.0)
        m.update("k", 100.0, 4.0)
    assert [m.estimate("k", 100.0) for m in ms] == [3.0, 3.0]
    assert ms[0].estimate("other", 50.0) == ms[1].estimate("other", 50.0)


# ------------------------------------------------------------------- helpers
def _angles(spec, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, np.pi, (n, spec.n_theta)).astype(np.float32),
            rng.uniform(0, np.pi, (n, spec.n_data)).astype(np.float32))


def _fig6_banks(samples: int, seed: int = 0):
    """Each Fig-6 client's materialized shift-rule bank: (cid, spec, theta
    rows, data rows) as numpy, the base angles drawn from ``seed``."""
    out = []
    for i, (cid, qc, nl) in enumerate(FIG6_CLIENTS):
        spec = circuits.build_quclassi_circuit(qc, nl)
        th, dt = _angles(spec, samples, seed + i)
        bank = tsr.build_bank(torch.from_numpy(th[0]), torch.from_numpy(dt))
        out.append((cid, spec, bank.theta.numpy(), bank.data.numpy()))
    return out


class FakeClock:
    """A clock that advances 1 ms a reading: both packages read it at the
    same points, so they see the same times (and service estimates)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _serve_interleaved(rt, banks, to_tensor):
    """Submit the clients' rows interleaved (row i of every client, then row
    i + 1), then drain; -> per client the fidelities in submission order."""
    futs = {cid: [] for cid, _, _, _ in banks}
    for cid, _, _, _ in banks:
        rt.gateway.register_client(cid)
    for i in range(max(th.shape[0] for _, _, th, _ in banks)):
        for cid, spec, th, dt in banks:
            if i < th.shape[0]:
                futs[cid].append(rt.gateway.submit(
                    cid, spec, (to_tensor(th[i]), to_tensor(dt[i])), now=rt.dispatcher.clock()))
        rt.dispatcher.kick()
    rt.dispatcher.drain()
    return {cid: np.array([float(np.asarray(f.result(timeout=60.0))) for f in fs])
            for cid, fs in futs.items()}


def _fig6_workers(mod):
    return [mod(f"w{i + 1}", q) for i, q in enumerate((5, 10, 15, 20))]


# ---------------------------------------------------------------- sync Fig-6
def test_sync_runtime_fig6_matches_reference():
    banks = _fig6_banks(samples=3)
    jbanks = [(cid, circuits_ref(qc, nl), th, dt)
              for (cid, _, th, dt), (_, qc, nl) in zip(banks, FIG6_CLIENTS)]
    jrt = jserve.GatewayRuntime(_fig6_workers(JWorker), target=128, deadline=1.0,
                                clock=FakeClock())
    trt = tserve.GatewayRuntime(_fig6_workers(TWorker), target=128, deadline=1.0,
                                clock=FakeClock())
    want = _serve_interleaved(jrt, jbanks, jnp.asarray)
    got = _serve_interleaved(trt, banks, torch.from_numpy)
    assert trt.dispatcher.batch_log == jrt.dispatcher.batch_log
    # four circuit structures: each client's rows coalesce among themselves
    assert {clients for _, _, clients in trt.dispatcher.batch_log} == {
        (cid,) for cid, _, _ in FIG6_CLIENTS}
    assert repr(trt.telemetry.summary()) == repr(jrt.telemetry.summary())
    for cid in got:
        np.testing.assert_allclose(got[cid], want[cid], rtol=0, atol=ATOL)


def circuits_ref(qc, nl):
    from repro.core import circuits as jcircuits

    return jcircuits.build_quclassi_circuit(qc, nl)


# ------------------------------------------------------------ async runtime
def test_async_matches_sync_bit_for_bit_on_fig6_mix():
    banks = _fig6_banks(samples=4, seed=5)
    got = {}
    for mode in ("sync", "async"):
        rt = tserve.GatewayRuntime(_fig6_workers(TWorker), target=64, lanes=32,
                                   deadline=0.01, mode=mode, slots_per_worker=2)
        try:
            got[mode] = _serve_interleaved(rt, banks, torch.from_numpy)
            assert not getattr(rt.dispatcher, "errors", [])
            assert sum(n for _, n, _ in rt.dispatcher.batch_log) == sum(
                th.shape[0] for _, _, th, _ in banks)
        finally:
            rt.close()
    for cid, spec, th, dt in banks:
        assert np.array_equal(got["sync"][cid], got["async"][cid])
        direct = ops.vqc_fidelity(spec, torch.from_numpy(th), torch.from_numpy(dt)).numpy()
        assert np.array_equal(got["async"][cid], direct)


def test_async_futures_resolve_out_of_order():
    """A stalled batch on one worker does not block another tenant's batch
    on another worker slot: the later submission resolves first."""
    s5, s7 = circuits.build_quclassi_circuit(5, 1), circuits.build_quclassi_circuit(7, 1)
    gate = threading.Event()

    def kernel(spec, theta, data):
        if spec.n_qubits == 5:
            assert gate.wait(timeout=30.0)
        return ops.vqc_fidelity(spec, theta, data)

    rt = tserve.GatewayRuntime(workers=[TWorker("w1", 5), TWorker("w2", 10)], target=8,
                               lanes=8, deadline=0.05, mode="async", kernel=kernel)
    try:
        t5, d5 = (torch.from_numpy(a) for a in _angles(s5, 8, 1))
        t7, d7 = (torch.from_numpy(a) for a in _angles(s7, 8, 2))
        now = rt.dispatcher.clock
        slow = [rt.gateway.submit("a", s5, (t5[i], d5[i]), now()) for i in range(8)]
        rt.dispatcher.kick()
        fast = [rt.gateway.submit("b", s7, (t7[i], d7[i]), now()) for i in range(8)]
        rt.dispatcher.kick()
        for f in fast:
            f.result(timeout=30.0)
        assert not any(f.done for f in slow)
        gate.set()
        got = torch.stack([f.result(timeout=30.0) for f in slow])
        assert torch.equal(got, ops.vqc_fidelity(s5, t5, d5))
    finally:
        gate.set()
        rt.close()


def test_mixed_slo_banks_fuse_bit_exact():
    spec = circuits.build_quclassi_circuit(5, 1)
    rt = tserve.GatewayRuntime(deadline=0.2, mode="async")
    try:
        rt.gateway.register_client("tight", slo_ms=500.0)
        rt.gateway.register_client("loose", slo_ms=60_000.0)
        th, dt = (torch.from_numpy(a) for a in _angles(spec, 8, 3))
        bank_a = tsr.build_shift_bank(th[0], dt[:4])
        bank_b = tsr.build_shift_bank(th[1], dt[4:])
        key = tserve.ShiftGroupKey(spec, False)
        now = rt.dispatcher.clock
        futs_a = [rt.gateway.submit("tight", key, (bank_a, g), now(), lanes=4)
                  for g in range(bank_a.n_groups)]
        futs_b = [rt.gateway.submit("loose", key, (bank_b, g), now(), lanes=4)
                  for g in range(bank_b.n_groups)]
        rt.dispatcher.kick()
        got_a = torch.cat([f.result(timeout=30.0) for f in futs_a])
        got_b = torch.cat([f.result(timeout=30.0) for f in futs_b])
        assert torch.equal(got_a, ops.vqc_fidelity_shiftbank(spec, bank_a.theta, bank_a.data))
        assert torch.equal(got_b, ops.vqc_fidelity_shiftbank(spec, bank_b.theta, bank_b.data))
        assert rt.telemetry.fused_launches >= 1 and rt.telemetry.fused_banks >= 2
    finally:
        rt.close()


def test_concurrent_submitters_and_kernel_counters():
    """Several threads submit to one async runtime while the kernel
    wrappers' shared state (launch counters, device tables, the launch
    observer) is hit from the slot threads: results stay exact and every
    count balances."""
    spec = circuits.build_quclassi_circuit(5, 1)
    rec = TraceRecorder()
    prev = ops.set_launch_observer(rec.on_kernel_launch)
    rt = tserve.GatewayRuntime(workers=[TWorker("w1", 5), TWorker("w2", 10)], target=32,
                               lanes=32, deadline=0.02, mode="async", slots_per_worker=2)
    results = {}

    def client(tid):
        th, dt = (torch.from_numpy(a) for a in _angles(spec, 40, tid))
        results[tid] = (rt.executor(spec, f"c{tid}")(th, dt), th, dt)
        bank = tsr.build_shift_bank(th[0], dt[:5])
        results[tid] += (rt.shift_executor(spec, f"c{tid}")(bank), bank)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads)
        assert not rt.dispatcher.errors
    finally:
        rt.close()
        ops.set_launch_observer(prev)
    for tid, (rows, th, dt, groups, bank) in results.items():
        assert torch.equal(rows, ops.vqc_fidelity(spec, th, dt))
        assert torch.equal(groups, ops.vqc_fidelity_shiftbank(spec, bank.theta, bank.data))
        s = rt.telemetry.tenants[f"c{tid}"]
        assert s.completed == s.submitted == 40 + bank.n_groups
    # one observed launch per shift-group batch, reported to the runtime's
    # recorder from the slot threads (the runtime's observer replaced rec's
    # while it was open, and rec saw none)
    launches = sum(rt.telemetry.trace.kernel_launches.values())
    assert launches == rt.telemetry.fused_launches >= 1
    assert not rec.kernel_launches

    # the counters themselves, from many threads at once
    before = dict(K.LAUNCHES)
    tables = []

    def hammer():
        for _ in range(500):
            K._count("state")
        tables.append(K._on_device(("counter-test",), (np.arange(4, dtype=np.int32),),
                                   torch.device("cpu")))

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        assert K.LAUNCHES["state"] == before["state"] + 8 * 500
        assert all(t is tables[0] for t in tables)
    finally:
        K.LAUNCHES.update(before)
        K._DEVICE_TABLES.pop((("counter-test",), torch.device("cpu")), None)


def test_first_build_from_several_threads_gives_one_library(monkeypatch):
    """Slot threads that hit a library's first use together get one
    library, declared once (the build is faked: no nvcc here)."""
    class Fn:
        pass

    class Lib:
        def __getattr__(self, name):
            fn = Fn()
            setattr(self, name, fn)
            return fn

    loads = []

    def load(name):
        loads.append(name)
        time.sleep(0.05)  # a build in progress while the other threads ask
        return Lib()

    monkeypatch.setattr(K._build, "load", load)
    monkeypatch.setattr(K, "_LIBS", {})
    got = []
    threads = [threading.Thread(target=lambda: got.append(K._lib("vqc_fused")))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert loads == ["vqc_fused"] and len(got) == 8 and all(g is got[0] for g in got)


def test_drain_surfaces_pump_errors():
    rt = tserve.GatewayRuntime(workers=[TWorker("w1", 5)], target=4, lanes=4, mode="async")
    try:
        def boom():
            raise ValueError("pump exploded")

        rt.dispatcher._pump_once = boom
        rt.dispatcher.kick()
        t0 = time.perf_counter()
        while not rt.dispatcher.errors and time.perf_counter() - t0 < 10.0:
            time.sleep(0.005)
        with pytest.raises(ValueError, match="pump exploded"):
            rt.dispatcher.drain()
    finally:
        rt.close()


# --------------------------------------------------------------- mesh spill
@pytest.mark.parametrize("mode", ["sync", "async"])
def test_over_width_batch_spills_to_mesh(mode):
    s7 = circuits.build_quclassi_circuit(7, 1)
    rt = tserve.GatewayRuntime(workers=[TWorker("w1", 5)], target=4, lanes=4, deadline=0.01,
                               mode=mode)
    try:
        th, dt = (torch.from_numpy(a) for a in _angles(s7, 3, 4))
        bank = tsr.build_shift_bank(th[0], dt)
        got = rt.shift_executor(s7, "c")(bank)
        want = ops.vqc_fidelity_shiftbank(s7, bank.theta, bank.data)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
        rows = rt.executor(s7, "c")(th, dt)
        torch.testing.assert_close(rows, ops.vqc_fidelity(s7, th, dt), rtol=0, atol=ATOL)
        assert rt.telemetry.mesh_spills >= 2 and rt.telemetry.spilled_lanes >= 3
        assert {w for w, _, _ in rt.dispatcher.batch_log} == {"mesh"}
    finally:
        rt.close()


def test_over_width_batch_fails_fast_without_spill():
    s7 = circuits.build_quclassi_circuit(7, 1)
    rt = tserve.GatewayRuntime(workers=[TWorker("w1", 5)], target=4, lanes=4, deadline=0.01,
                               mode="async", mesh_spill=False)
    try:
        th, dt = (torch.from_numpy(a) for a in _angles(s7, 1, 5))
        fut = rt.gateway.submit("c", s7, (th[0], dt[0]), rt.dispatcher.clock())
        rt.dispatcher.kick()
        with pytest.raises(RuntimeError, match="no worker fits"):
            fut.result(timeout=10.0)
    finally:
        rt.close()


def test_17q_rows_spill_and_complete():
    """17-qubit rows fit the 20-qubit worker's register but no block of the
    card: they run on the mesh (the device-memory route on the card)."""
    s17 = circuits.build_quclassi_circuit(17, 1)
    rt = tserve.GatewayRuntime(_fig6_workers(TWorker), deadline=0.01)
    th, dt = (torch.from_numpy(a) for a in _angles(s17, 2, 6))
    got = rt.executor(s17, "wide")(th, dt)
    assert torch.equal(got, ops.vqc_fidelity(s17, th, dt))
    assert rt.dispatcher.batch_log == [("mesh", 2, ("wide",))]
    assert rt.telemetry.mesh_spills == 1


# ----------------------------------------------------- decisions of the slice
def _row_batch(mod, spec, n):
    members = [mod.PendingCircuit(key=spec, client_id="c", seq=i, arrival=0.0, payload=None)
               for i in range(n)]
    return mod.CoalescedBatch(key=spec, members=members, created=0.0)


def test_per_block_memory_model_flags_deep_rows():
    wide, narrow = (circuits.build_quclassi_circuit(q, 1) for q in (17, 7))
    assert tserve.batch_over_block(_row_batch(tserve, wide, 8))
    assert tserve.batch_launch_info(_row_batch(tserve, wide, 8))["smem_bytes"] == 0
    assert not tserve.batch_over_block(_row_batch(tserve, narrow, 8))
    assert tserve.batch_launch_info(_row_batch(tserve, narrow, 8)) == {
        "mode": "rows", "launches": 1, "smem_bytes": K.fused_geometry(7, 8)[1]}
    # the line lies between 14 qubits (one state of 128 KB fits a block)
    # and 15 (256 KB does not)
    s14 = dataclasses.replace(circuits.build_quclassi_circuit(13, 1), n_qubits=14)
    assert not tserve.batch_over_block(_row_batch(tserve, s14, 1))
    assert tserve.batch_over_block(_row_batch(tserve, circuits.build_quclassi_circuit(15, 1), 1))
    spec5 = circuits.build_quclassi_circuit(5, 1)
    th, dt = (torch.from_numpy(a) for a in _angles(spec5, 6, 9))
    bank = tsr.build_shift_bank(th[0], dt)
    key = tserve.ShiftGroupKey(spec5, False)
    members = [tserve.PendingCircuit(key=key, client_id="c", seq=g, arrival=0.0,
                                      payload=(bank, g), lanes=6) for g in range(bank.n_groups)]
    shift = tserve.CoalescedBatch(key=key, members=members, created=0.0)
    info = tserve.batch_launch_info(shift)
    assert info == {"mode": "fused", "launches": 1, "smem_bytes": K.shift_execution_info(
        spec5, 6)["smem_bytes"]} and not tserve.batch_over_block(shift)
    from repro_torch.serve.dispatcher import kernel_span_args

    assert kernel_span_args(shift) == {**info, "kind": "shift", "banks": 1, "lanes": 6,
                                       "members": bank.n_groups}
    assert kernel_span_args(_row_batch(tserve, wide, 8))["lanes"] == 8
    # the reference's VMEM model draws the same line for these two widths
    assert jserve.batch_vmem_bytes(_row_batch(jserve, circuits_ref(17, 1), 8)) > \
        jserve.WORKER_VMEM_BYTES
    assert jserve.batch_vmem_bytes(_row_batch(jserve, circuits_ref(7, 1), 8)) <= \
        jserve.WORKER_VMEM_BYTES


def test_serving_lanes_are_the_references_and_kernels_get_real_rows():
    from repro.serve import coalescer as jcoalescer

    assert tserve.LANES == jcoalescer.LANES == 128 and K.LANES == 32
    spec = circuits.build_quclassi_circuit(5, 1)
    seen = []

    def kernel(s, theta, data):
        seen.append(theta.shape[0])
        return ops.vqc_fidelity(s, theta, data)

    rt = tserve.GatewayRuntime(target=128, deadline=0.1, kernel=kernel)
    th, dt = (torch.from_numpy(a) for a in _angles(spec, 70, 7))
    got = rt.executor(spec, "c")(th, dt)
    assert seen == [70]
    assert torch.equal(got, ops.vqc_fidelity(spec, th, dt))
    assert rt.telemetry.padded_lanes == 128 and rt.telemetry.batched_circuits == 70
    batch = _row_batch(tserve, spec, 70)
    assert batch.padded() == 128 and tserve.batch_cost_units(batch) == len(spec.ops) * 128
    assert tserve.batch_cost_units(batch) == jserve.batch_cost_units(
        _row_batch(jserve, circuits_ref(5, 1), 70))


def test_shift_plan_beyond_m12_refused_at_admission():
    spec = circuits.build_quclassi_circuit(27, 1)  # m = 13
    assert K.build_shift_plan(spec).m == 13
    reason = tserve.shift_admission_error(spec)
    assert "m = 12" in reason
    assert tserve.shift_admission_error(circuits.build_quclassi_circuit(25, 1)) is None
    rt = tserve.GatewayRuntime(deadline=0.01)
    th, dt = (torch.from_numpy(a) for a in _angles(spec, 2, 8))
    bank = tsr.build_shift_bank(th[0], dt)
    with pytest.raises(NotImplementedError, match="m = 12"):
        rt.shift_executor(spec, "wide")(bank)
    assert rt.telemetry.tenants["wide"].submitted == 0 and rt.gateway.idle


# ------------------------------------------------- training through gateway
@pytest.mark.parametrize("bank_mode", ["implicit", "materialized"])
def test_two_tenants_train_through_one_runtime(bank_mode):
    """Two tenants train from two threads on one async runtime; each takes
    the reference's first step (its ``train(gateway=...)`` on its own
    runtime) within 1e-5 scaled by the chain factor."""
    seed = 0
    jcfg, tcfg = jq.QuClassiConfig(qc=5, n_layers=1), tq.QuClassiConfig(qc=5, n_layers=1)
    x, y = jmnist.make_pair_dataset(3, 9, n_per_class=4, seed=seed)
    split = ((x[:4], y[:4]), (x[4:], y[4:]))
    kw = dict(epochs=1, batch_size=4, lr=0.05, seed=seed, bank_mode=bank_mode)
    init = {k: np.asarray(v) for k, v in jq.init_params(jcfg, jax.random.PRNGKey(seed)).items()}
    jrt = jserve.GatewayRuntime(target=128, deadline=0.2)
    want = jtrainer.train(jcfg, *split, gateway=jrt, client_id="ref", **kw)

    rt = tserve.GatewayRuntime(target=128, deadline=0.05, mode="async")
    got = {}

    def tenant(cid):
        got[cid] = ttrainer.train(tcfg, *split, gateway=rt, client_id=cid,
                                  init_params=tq.params_from_numpy(init, "cpu"),
                                  device="cpu", **kw)

    try:
        threads = [threading.Thread(target=tenant, args=(c,)) for c in ("alice", "bob")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        assert not rt.dispatcher.errors
    finally:
        rt.close()
    assert set(got) == {"alice", "bob"}
    # one step: the epoch's loss is the first step's loss
    xb, yb = jnp.asarray(split[0][0]), jnp.asarray(split[0][1])
    _, _, jf = jq.grad_shift(jcfg, {k: jnp.asarray(v) for k, v in init.items()}, xb, yb)
    onehot = np.eye(tcfg.n_classes, dtype=np.float32)[split[0][1]]
    chain = tfid.bce_grad_wrt_fidelity(torch.tensor(np.asarray(jf)), torch.from_numpy(onehot))
    tol = ATOL * max(1.0, float(chain.abs().max()))
    for rep in got.values():
        (g,), (w,) = rep.epochs, want.epochs
        assert abs(g.loss - w.loss) <= tol
        assert g.circuits_executed == w.circuits_executed
        for k in want.params:  # one SGD step: params = init - lr * grad
            grad_t = (init[k] - rep.params[k].numpy()) / kw["lr"]
            grad_j = (init[k] - np.asarray(want.params[k])) / kw["lr"]
            # plus the rounding of the float32 parameters the gradient is
            # read back from
            ulp = 2 * np.finfo(np.float32).eps * max(1.0, float(np.abs(init[k]).max()))
            np.testing.assert_allclose(grad_t, grad_j, rtol=0, atol=tol + ulp / kw["lr"])
    for cid in ("alice", "bob"):
        assert rt.telemetry.tenants[cid].completed > 0
    with pytest.raises(ValueError, match="either executor or gateway"):
        ttrainer.train(tcfg, *split, gateway=rt, executor=lambda t, d: t, device="cpu")
