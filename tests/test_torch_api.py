"""The port's public facade (``repro_torch.api``) against the reference's
(``repro.api``), on the CPU, where the kernels' plain versions stand in for
the CUDA kernels.

* The surface: ``__all__`` equals the snapshot's ``"repro.api"`` list, and
  every name resolves through the lazy loader.
* The typed configs give the reference's validation messages; the one
  knob without a counterpart on the card, ``worker_vmem_bytes``, is
  refused by name rather than dropped.
* ``CostModel.bank_cost_units`` equals the reference's for materialized
  and implicit banks (the serving layer's 128 lanes, not the kernels' 32);
  ``bank_smem_bytes`` is the per-block figure of the launch.
* Sessions: registration and re-registration after ``close()``;
  ``submit``/``drain`` within 1e-5 of the reference; the session executor
  bit-identical to the runtime's executor (port against port); a session's
  ``grad_shift`` against the reference's session at the fidelity tolerance
  and the chain-scaled gradient tolerance (ROADMAP Queue 3, R2);
  ``Session.train`` equal to ``trainer.train(gateway=...)``.
* ``simulate`` forwards session policies and rejects sessions absent from
  the jobs.
* The five backends: batched, pooled and multibank against the reference's
  adapters at 1e-5; sharded and mesh-spill on a two-shard CPU mesh against
  ``bank.materialize()`` plus ``ops.vqc_fidelity`` (the reference's sharded
  paths fail under the installed jax, R1).
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.comanager import tenancy as jtenancy
from repro.comanager.worker import WorkerConfig as JWorker
from repro.core import quclassi as jq
from repro.core import shift_rule as jsr
from repro.data import mnist as jmnist
from repro_torch.comanager import tenancy as ttenancy
from repro_torch.comanager.simulation import SystemSimulation
from repro_torch.comanager.worker import WorkerConfig as TWorker
from repro_torch.core import circuits
from repro_torch.core import fidelity as tfid
from repro_torch.core import quclassi as tq
from repro_torch.core import shift_rule as tsr
from repro_torch.core import trainer as ttrainer
from repro_torch.kernels import ops
from repro_torch.kernels import vqc_statevector as K
from repro_torch.launch.mesh import make_data_mesh

ATOL = 1e-5
SNAPSHOT = Path(__file__).parent / "snapshots" / "public_api.json"


# ----------------------------------------------------------------- surface
def test_all_equals_snapshot_and_resolves():
    assert tapi.__all__ == json.loads(SNAPSHOT.read_text())["repro.api"]
    assert tapi.__all__ == japi.__all__
    for name in tapi.__all__:
        assert getattr(tapi, name) is not None
    with pytest.raises(AttributeError):
        tapi.not_a_name  # noqa: B018


# ----------------------------------------------------------- typed configs
CONFIG_ERRORS = [
    ("ServingConfig", dict(mode="bogus")),
    ("ServingConfig", dict(evict_over_slo=True)),
    ("ServingConfig", dict(slots_per_worker=0)),
    ("ServingConfig", dict(max_system_pending=0)),
    ("ServingConfig", dict(max_pending_per_tier={0: 0})),
    ("ServingConfig", dict(target=8)),
    ("ServingConfig", dict(target=32)),  # the kernels' warp, not a serving lane tile
    ("ServingConfig", dict(target=-128)),
    ("TenantPolicy", dict(weight=0.0)),
    ("TenantPolicy", dict(slo_ms=-5.0)),
    ("TenantPolicy", dict(max_pending=0)),
    ("TenantPolicy", dict(max_in_flight=-1)),
    ("SimulationConfig", dict(tenancy="shared_nothing")),
    ("SimulationConfig", dict(policy="random")),
    ("SimulationConfig", dict(gateway=True, gateway_target=8)),
    ("SimulationConfig", dict(gateway=True, gateway_target=32)),
    ("SimulationConfig", dict(gateway_max_pending=0)),
    ("SimulationConfig", dict(gateway_max_system_pending=-1)),
    ("SimulationConfig", dict(gateway_max_pending_per_tier={1: 0})),
    ("ClusterConfig", dict(workers=())),
    ("ClusterConfig", dict(workers="dup")),
]


def _config_error(api, worker, cls, kw):
    if kw.get("workers") == "dup":
        kw = dict(workers=(worker("w1", 5), worker("w1", 7)))
    with pytest.raises(ValueError) as exc:
        getattr(api, cls)(**kw)
    return str(exc.value)


@pytest.mark.parametrize("cls,kw", CONFIG_ERRORS,
                         ids=[f"{c}-{'-'.join(k)}-{i}" for i, (c, k) in enumerate(CONFIG_ERRORS)])
def test_config_validation_messages_equal_reference(cls, kw):
    assert _config_error(tapi, TWorker, cls, dict(kw)) == _config_error(japi, JWorker, cls,
                                                                         dict(kw))


def test_configs_accepted_equal_reference():
    kw = dict(target=256, deadline=0.3, mode="async", slots_per_worker=2,
              max_system_pending=40, max_pending_per_tier={0: 8})
    assert tapi.ServingConfig(**kw).runtime_kwargs() == japi.ServingConfig(**kw).runtime_kwargs()
    skw = dict(gateway=True, gateway_target=256, classical_overhead=0.01, tenancy="multi")
    assert (tapi.SimulationConfig(**skw).simulation_kwargs()
            == japi.SimulationConfig(**skw).simulation_kwargs())
    pol = dict(priority=0, slo_ms=250.0, weight=2.0, max_pending=3)
    assert tapi.TenantPolicy(**pol).register_kwargs() == japi.TenantPolicy(**pol).register_kwargs()
    tcfg, jcfg = tapi.ClusterConfig.homogeneous(3, 10), japi.ClusterConfig.homogeneous(3, 10)
    assert [(w.worker_id, w.max_qubits) for w in tcfg.workers] == [
        (w.worker_id, w.max_qubits) for w in jcfg.workers]
    assert [w.max_qubits for w in tapi.default_workers()] == [5, 10, 15, 20]
    assert [f.name for f in tapi.ServingConfig.__dataclass_fields__.values()] == [
        f.name for f in japi.ServingConfig.__dataclass_fields__.values()]


def test_worker_vmem_bytes_refused_by_name():
    japi.ServingConfig(worker_vmem_bytes=1 << 20)  # the reference takes it
    with pytest.raises(ValueError, match=r"worker_vmem_bytes.*per block.*batch_over_block"):
        tapi.ServingConfig(worker_vmem_bytes=1 << 20)
    assert "worker_vmem_bytes" not in tapi.ServingConfig().runtime_kwargs()


# ---------------------------------------------------------------- cost model
def _banks(qc, nl, samples, seed=0):
    """(port spec, port bank pair, reference bank pair): materialized and
    implicit banks of the same numpy angles."""
    spec = circuits.build_quclassi_circuit(qc, nl)
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, np.pi, spec.n_theta).astype(np.float32)
    da = rng.uniform(0, np.pi, (samples, spec.n_data)).astype(np.float32)
    tt, td = torch.from_numpy(th), torch.from_numpy(da)
    jt, jd = jnp.asarray(th), jnp.asarray(da)
    return (spec, (tsr.build_bank(tt, td), tsr.build_shift_bank(tt, td)),
            (jsr.build_bank(jt, jd), jsr.build_shift_bank(jt, jd)))


def _ref_spec(qc, nl):
    from repro.core import circuits as jcircuits

    return jcircuits.build_quclassi_circuit(qc, nl)


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("shiftbank", [True, False])
@pytest.mark.parametrize("implicit", [True, False], ids=["implicit", "materialized"])
@pytest.mark.parametrize("qc,nl", [(5, 1), (7, 3), (13, 3)])
def test_bank_cost_units_equal_reference(qc, nl, implicit, shiftbank, shards):
    spec, tbanks, jbanks = _banks(qc, nl, samples=5)
    from repro.api.backend import CostModel as JCost

    got = tapi.CostModel(shiftbank=shiftbank, n_shards=shards).bank_cost_units(
        spec, tbanks[implicit])
    want = JCost(shiftbank=shiftbank, n_shards=shards).bank_cost_units(
        _ref_spec(qc, nl), jbanks[implicit])
    assert got == want > 0


def test_bank_smem_bytes_is_the_per_block_figure():
    spec, (mat, imp), _ = _banks(7, 3, samples=64)
    shift = tapi.CostModel(shiftbank=True)
    info = K.shift_execution_info(spec, 64, four_term=False)
    assert shift.bank_smem_bytes(spec, imp) == info["smem_bytes"] > 0
    assert shift.bank_smem_bytes(spec, mat) == K.fused_geometry(7, mat.n_circuits)[1]
    rows = tapi.CostModel(shiftbank=False, n_shards=4)
    assert rows.bank_smem_bytes(spec, imp) == K.fused_geometry(7, -(-imp.n_circuits // 4))[1]
    wide, (wmat, _), _ = _banks(17, 1, samples=2)
    assert rows.bank_smem_bytes(wide, wmat) == 0  # device-memory route: no block holds it


# ----------------------------------------------------------------- sessions
@pytest.fixture(scope="module")
def qcfgs():
    return jq.QuClassiConfig(qc=5, n_layers=1), tq.QuClassiConfig(qc=5, n_layers=1)


def test_session_registration_and_reregistration_after_close(qcfgs):
    _, tcfg = qcfgs
    cluster = tapi.QuantumCluster(device="cpu")
    sess = cluster.session("alice", tapi.TenantPolicy(priority=0, slo_ms=500.0, weight=2.0))
    sess.executor(tcfg.spec)
    st = cluster.runtime.gateway.tenants["alice"]
    assert (st.priority, st.weight) == (0, 2.0) and st.slo_s == pytest.approx(0.5)
    assert cluster.session("alice", tapi.TenantPolicy(priority=0, slo_ms=500.0, weight=2.0)) is sess
    assert cluster.session("alice") is sess
    with pytest.raises(ValueError, match="already open"):
        cluster.session("alice", tapi.TenantPolicy(priority=1))
    with pytest.raises(ValueError, match="bank_mode"):
        cluster.session("carol", bank_mode="lazy")
    cluster.close()
    sess.executor(tcfg.spec)  # the old handle on a rebuilt runtime
    st = cluster.runtime.gateway.tenants["alice"]
    assert (st.priority, st.weight) == (0, 2.0) and st.slo_s == pytest.approx(0.5)
    cluster.close()
    assert cluster.session("alice", tapi.TenantPolicy(priority=5)).policy.priority == 5
    cluster.close()


def _submit_drain(api, spec, to_tensor, **kw):
    rng = np.random.default_rng(3)
    rows = [(rng.uniform(0, np.pi, spec.n_theta).astype(np.float32),
             rng.uniform(0, np.pi, spec.n_data).astype(np.float32)) for _ in range(9)]
    with api.QuantumCluster(api.ClusterConfig(serving=api.ServingConfig(target=128,
                                                                         deadline=0.25)),
                            **kw) as cluster:
        sess = cluster.session("streamer")
        futs = [sess.submit(spec, to_tensor(th), to_tensor(da)) for th, da in rows]
        sess.drain()
        assert all(f.done for f in futs)
        tel = sess.telemetry()
        return np.array([float(np.asarray(f.value)) for f in futs]), tel["completed"]


def test_submit_drain_matches_reference(qcfgs):
    jcfg, tcfg = qcfgs
    got, n_got = _submit_drain(tapi, tcfg.spec, torch.from_numpy, device="cpu")
    want, n_want = _submit_drain(japi, jcfg.spec, jnp.asarray)
    assert n_got == n_want == 9
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _images(n=2, seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n, 8, 8)).astype(np.float32), np.arange(n) % 2


def _init(jcfg, seed=0):
    return {k: np.asarray(v) for k, v in jq.init_params(jcfg, jax.random.PRNGKey(seed)).items()}


def test_session_executor_bit_identical_to_runtime_executor(qcfgs):
    jcfg, tcfg = qcfgs
    x, y = _images()
    params = tq.params_from_numpy(_init(jcfg), "cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with tapi.QuantumCluster(device="cpu") as cluster:
        sess = cluster.session("trainer", bank_mode="materialized")
        l_new, g_new, _ = tq.grad_shift(tcfg, params, xt, yt, executor=sess.executor(tcfg.spec))
        old = cluster.runtime.executor(tcfg.spec, "legacy-tenant")
        l_old, g_old, _ = tq.grad_shift(tcfg, params, xt, yt, executor=old)
        assert float(l_new) == float(l_old)
        assert torch.equal(g_new["theta"], g_old["theta"])


@pytest.mark.parametrize("bank_mode", ["materialized", "implicit"])
def test_session_grad_shift_matches_reference_session(qcfgs, bank_mode):
    jcfg, tcfg = qcfgs
    x, y = _images(2, seed=7)
    init = _init(jcfg, seed=1)
    with japi.QuantumCluster() as jc:
        jl, jg, jf = jq.grad_shift(jcfg, {k: jnp.asarray(v) for k, v in init.items()},
                                   jnp.asarray(x), jnp.asarray(y),
                                   executor=jc.session("t", bank_mode=bank_mode).executor(jcfg.spec))
    with tapi.QuantumCluster(device="cpu") as tc:
        tl, tg, tf = tq.grad_shift(tcfg, tq.params_from_numpy(init, "cpu"), torch.from_numpy(x),
                                   torch.from_numpy(y),
                                   executor=tc.session("t", bank_mode=bank_mode).executor(tcfg.spec))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=ATOL)
    onehot = np.eye(tcfg.n_classes, dtype=np.float32)[y]
    chain = tfid.bce_grad_wrt_fidelity(torch.tensor(np.asarray(jf)), torch.from_numpy(onehot))
    tol = ATOL * max(1.0, float(chain.abs().max()))
    assert abs(float(tl) - float(jl)) <= tol
    np.testing.assert_allclose(tg["theta"].numpy(), np.asarray(jg["theta"]), rtol=0, atol=tol)


@pytest.mark.parametrize("bank_mode", ["implicit", "materialized"])
def test_session_train_equals_trainer_through_the_runtime(qcfgs, bank_mode):
    jcfg, tcfg = qcfgs
    x, y = jmnist.make_pair_dataset(3, 9, n_per_class=4, seed=0)
    split = ((x[:4], y[:4]), (x[4:], y[4:]))
    init = _init(jcfg)
    kw = dict(epochs=1, batch_size=4, lr=0.05, seed=0)
    with tapi.QuantumCluster(device="cpu") as cluster:
        sess = cluster.session("alice", bank_mode=bank_mode)
        got = sess.train(tcfg, *split, init_params=tq.params_from_numpy(init, "cpu"), **kw)
        want = ttrainer.train(tcfg, *split, gateway=cluster.runtime, client_id="bob",
                              bank_mode=bank_mode, device="cpu",
                              init_params=tq.params_from_numpy(init, "cpu"), **kw)
    assert got.epochs[0].loss == want.epochs[0].loss
    assert got.epochs[0].circuits_executed == want.epochs[0].circuits_executed > 0


def test_cluster_registers_and_drains_workers(qcfgs):
    _, tcfg = qcfgs
    cluster = tapi.QuantumCluster(tapi.ClusterConfig.homogeneous(2, 10), device="cpu")
    try:
        cluster.register_worker(TWorker("w3", 20))
        assert [w.worker_id for w in cluster.config.workers] == ["w1", "w2", "w3"]
        assert "w3" in cluster.fleet.snapshot()
        cluster.drain_worker("w1")
        assert [w.worker_id for w in cluster.config.workers] == ["w2", "w3"]
        sess = cluster.session("t")
        rng = np.random.default_rng(0)
        fut = sess.submit(tcfg.spec,
                          torch.tensor(rng.uniform(0, np.pi, tcfg.n_theta), dtype=torch.float32),
                          torch.tensor(rng.uniform(0, np.pi, tcfg.n_angles), dtype=torch.float32))
        sess.drain()
        assert fut.done and sess.trace() and sess.trace()[0]["worker"] in ("w2", "w3")
    finally:
        cluster.close()


# ------------------------------------------------------ virtual-clock bridge
def _jobs(mod):
    return [mod.JobSpec("a", 5, 1, 48, service_override=0.3),
            mod.JobSpec("b", 7, 1, 48, service_override=0.3)]


def test_simulate_forwards_session_policies():
    reports = []
    for api, ten in ((tapi, ttenancy), (japi, jtenancy)):
        cluster = api.QuantumCluster(api.ClusterConfig(
            simulation=api.SimulationConfig(gateway=True, classical_overhead=0.01)))
        cluster.session("a", api.TenantPolicy(priority=0, slo_ms=2000.0, weight=2.0))
        cluster.session("b", api.TenantPolicy(weight=0.5))
        reports.append(cluster.simulate(_jobs(ten)))
    got, want = reports
    assert (got.makespan, got.assignments, got.gateway_summary) == (
        want.makespan, want.assignments, want.gateway_summary)
    slos = {t["client"]: t.get("slo_s") for t in got.gateway_summary["tenants"]}
    assert slos["a"] == pytest.approx(2.0)
    legacy = SystemSimulation(
        list(tapi.ClusterConfig().workers), _jobs(ttenancy), gateway=True,
        classical_overhead=0.01, tenant_weights={"a": 2.0, "b": 0.5},
        tenant_priorities={"a": 0, "b": 1}, tenant_slos_ms={"a": 2000.0}).run()
    assert got.makespan == legacy.makespan


def test_simulate_rejects_sessions_not_in_jobs():
    msgs = []
    for api, ten in ((tapi, ttenancy), (japi, jtenancy)):
        cluster = api.QuantumCluster(api.ClusterConfig(
            simulation=api.SimulationConfig(gateway=True)))
        cluster.session("alicee", api.TenantPolicy(priority=0))
        with pytest.raises(ValueError, match="alicee") as exc:
            cluster.simulate([ten.JobSpec("alice", 5, 1, 8)])
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


def test_simulate_without_gateway_equals_reference():
    reps = []
    for api, ten, worker in ((tapi, ttenancy, TWorker), (japi, jtenancy, JWorker)):
        cfg = api.ClusterConfig(workers=(worker("w1", 5), worker("w2", 10)),
                                simulation=api.SimulationConfig(classical_overhead=0.02,
                                                                fair_queue=True))
        reps.append(api.QuantumCluster(cfg).simulate(_jobs(ten)[:1]))
    assert (reps[0].makespan, reps[0].assignments) == (reps[1].makespan, reps[1].assignments)


# ------------------------------------------------------------------ backends
@pytest.fixture(scope="module")
def bank_case():
    spec, tbanks, jbanks = _banks(5, 1, samples=6, seed=2)
    _, tbanks2, jbanks2 = _banks(5, 1, samples=3, seed=9)
    return spec, _ref_spec(5, 1), tbanks, jbanks, tbanks2, jbanks2


@pytest.mark.parametrize("kind", ["batched", "pooled", "multibank"])
def test_worker_backends_match_reference(bank_case, kind):
    spec, jspec, (tmat, timp), (jmat, jimp), (_, timp2), (_, jimp2) = bank_case
    tbe = tapi.make_backend(kind, spec, n_workers=3)
    jbe = japi.make_backend(kind, jspec, n_workers=3)
    try:
        assert dataclasses.astuple(tbe.capabilities()) == dataclasses.astuple(jbe.capabilities())
        for tb, jb in ((timp, jimp), (tmat, jmat)):
            np.testing.assert_allclose(tbe.run_bank(tb).numpy(), np.asarray(jbe.run_bank(jb)),
                                       rtol=0, atol=ATOL)
        np.testing.assert_allclose(tbe(tmat.theta, tmat.data).numpy(),
                                   np.asarray(jbe(jmat.theta, jmat.data)), rtol=0, atol=ATOL)
        for got, want in zip(tbe.run_bank_set([timp, timp2]), jbe.run_bank_set([jimp, jimp2])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
        assert (tbe.cost_model().bank_cost_units(spec, timp)
                == jbe.cost_model().bank_cost_units(jspec, jimp))
    finally:
        tbe.close()
        jbe.close()


@pytest.mark.parametrize("kind", ["sharded", "mesh_spill"])
def test_mesh_backends_match_materialized_rows(bank_case, kind):
    spec, _, (tmat, timp), _, (_, timp2), _ = bank_case
    be = tapi.make_backend(kind, spec, mesh=make_data_mesh(2, device="cpu"))
    assert be.cost_model().n_shards == 2
    for bank in (timp, tmat, timp2):
        rows = bank.materialize() if isinstance(bank, tsr.ShiftBank) else bank
        want = ops.vqc_fidelity(spec, rows.theta, rows.data)
        np.testing.assert_allclose(be.run_bank(bank).numpy(), want.numpy(), rtol=0, atol=ATOL)
    for got, bank in zip(be.run_bank_set([timp, timp2]), (timp, timp2)):
        rows = bank.materialize()
        want = ops.vqc_fidelity(spec, rows.theta, rows.data)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", sorted(tapi.BACKEND_KINDS))
def test_cluster_backend_factory(bank_case, kind):
    spec, _, (_, timp), _, _, _ = bank_case
    cluster = tapi.QuantumCluster(tapi.ClusterConfig.homogeneous(3, 10), device="cpu")
    be = cluster.backend(kind, spec)
    try:
        if kind in ("batched", "pooled", "multibank"):
            assert be.n_workers == 3
        else:  # the mesh lives on the cluster's device kind
            assert be.cost_model().n_shards == 1
        assert isinstance(be, tapi.ExecutionBackend)
        rows = timp.materialize()
        np.testing.assert_allclose(be.run_bank(timp).numpy(),
                                   ops.vqc_fidelity(spec, rows.theta, rows.data).numpy(),
                                   rtol=0, atol=ATOL)
    finally:
        be.close()
    with pytest.raises(ValueError, match="unknown backend kind"):
        tapi.make_backend("bogus", spec)


def test_as_backend_wraps_legacy_callables(bank_case):
    spec, _, (tmat, timp), _, _, _ = bank_case
    be = tapi.as_backend(ops.kernel_executor(spec), spec)
    assert isinstance(be, tapi.CallableBackend)
    np.testing.assert_allclose(be.run_bank(tmat).numpy(),
                               ops.vqc_fidelity(spec, tmat.theta, tmat.data).numpy(), atol=0)
    with pytest.raises(TypeError, match="requires the CircuitSpec"):
        tapi.as_backend(ops.kernel_executor(spec))


# ------------------------------------------------------ serving surface map
#: the documented differences of the port's serving surface: the reference's
#: per-worker VMEM model has no counterpart on the card, whose memory model
#: is per block (``batch_over_block``, ``batch_launch_info``, the 227 KB
#: ``SMEM_BUDGET_BYTES``); the serving lane width ``LANES`` (128) is exported
#: beside it, and shift plans with no route are refused at admission
#: (``shift_admission_error``).
SERVE_REFERENCE_ONLY = {"WORKER_VMEM_BYTES", "batch_vmem_bytes"}
SERVE_PORT_ONLY = {"LANES", "SMEM_BUDGET_BYTES", "batch_launch_info", "batch_over_block",
                   "shift_admission_error"}


def test_serve_surface_differs_only_by_the_per_block_model():
    import repro_torch.serve as tserve

    snap = set(json.loads(SNAPSHOT.read_text())["repro.serve"])
    port = set(tserve.__all__)
    assert snap - port == SERVE_REFERENCE_ONLY
    assert port - snap == SERVE_PORT_ONLY
    for name in tserve.__all__:
        assert getattr(tserve, name) is not None
    assert tserve.LANES == 128
