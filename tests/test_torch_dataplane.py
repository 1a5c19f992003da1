"""The rest of the port's data plane: the pooled executor (one thread and
one CUDA stream per worker), the sharded executor over a ``DeviceMesh`` and
the serving layer's ``MeshSpillExecutor``, on the CPU (their plain paths),
against the sequential executor, the single-device kernels and the
reference.

Tolerances: bit for bit where only the scheduling differs (per-lane math
never depends on the batch or the shard); 1e-5 against the reference and
against the materialized bank (float32 fidelities, another evaluation
order), as the reference's own kernel tests."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comanager import dataplane as jdp
from repro.core import shift_rule as jshift
from repro_torch.comanager import dataplane as dp
from repro_torch.core import circuits, shift_rule
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh

ATOL = 1e-5


def _rows(spec, n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, np.pi, (n, spec.n_theta)).astype(np.float32),
            rng.uniform(0, np.pi, (n, spec.n_data)).astype(np.float32))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("qc,nl,n,workers", [(5, 1, 30, 3), (5, 2, 33, 4), (7, 1, 17, 2)])
def test_worker_pool_matches_sequential(qc, nl, n, workers):
    spec = circuits.build_quclassi_circuit(qc, nl)
    theta, data = _t(*_rows(spec, n, seed=qc + nl))
    assign = dp.round_robin_assignment(n, workers)
    pool = dp.worker_pool_executor(spec, assign, workers)
    try:
        seq = dp.worker_batched_executor(spec, assign, workers)(theta, data)
        assert torch.equal(pool(theta, data), seq)
        bank = shift_rule.build_shift_bank(theta[0], data[:6])
        groups = dp.round_robin_assignment(bank.n_groups, workers)
        g_seq = dp.worker_batched_executor(spec, groups, workers)(bank)
        g_pool = dp.worker_pool_executor(spec, groups, workers)(bank)
        assert torch.equal(g_seq, g_pool)
        # a per-row assignment of an implicit bank materializes it
        rows = dp.round_robin_assignment(bank.n_circuits, workers)
        assert torch.equal(dp.worker_pool_executor(spec, rows, workers)(bank),
                           dp.worker_batched_executor(spec, rows, workers)(bank))
        with pytest.raises(ValueError, match="assignment must cover"):
            pool(bank)
    finally:
        pool.close()


@pytest.mark.parametrize("qc,nl", [(5, 1), (7, 2)])
def test_sharded_executor_across_shard_counts(qc, nl):
    """Meshes of 1, 2 and 4 CPU entries: rows and implicit banks equal the
    single-device kernels (materialize() for the bank) within 1e-5 and each
    other bit for bit; lanes pad to a multiple of the shards."""
    spec = circuits.build_quclassi_circuit(qc, nl)
    theta, data = _t(*_rows(spec, 37, seed=qc))
    bank = shift_rule.build_shift_bank(theta[0], data[:11])
    mat = bank.materialize()
    want_rows = ops.vqc_fidelity(spec, theta, data)
    want_bank = ops.vqc_fidelity(spec, mat.theta, mat.data)
    got = []
    for n in (1, 2, 4):
        mesh = tmesh.make_data_mesh(n, device="cpu")
        assert mesh.shape == {"data": n, "model": 1} and tmesh.data_axis_size(mesh) == n
        ex = dp.sharded_executor(spec, mesh)
        got.append((ex(theta, data), ex(bank)))
        torch.testing.assert_close(got[-1][0], want_rows, rtol=0, atol=ATOL)
        torch.testing.assert_close(got[-1][1], want_bank, rtol=0, atol=ATOL)
    for rows, banks in got[1:]:
        assert torch.equal(rows, got[0][0]) and torch.equal(banks, got[0][1])


def test_sharded_run_banks_keeps_pack_banks_contract():
    """Fused multi-bank launch sharded over 1, 2 and 4 entries: per bank,
    bit-identical to ``vqc_fidelity_shiftgroups_multibank``."""
    spec = circuits.build_quclassi_circuit(5, 1)
    sizes, n_groups = (5, 40, 17), 1 + 2 * spec.n_theta
    banks = [_t(*_rows(spec, b, seed=b)) for b in sizes]
    group_sets = (tuple(range(n_groups)), (0, 3), tuple(range(1, n_groups, 2)))
    thetas, datas = tuple(t for t, _ in banks), tuple(d for _, d in banks)
    want = ops.vqc_fidelity_shiftgroups_multibank(spec, thetas, datas, False, group_sets)
    for n in (1, 2, 4):
        ex = dp.sharded_executor(spec, tmesh.make_data_mesh(n, device="cpu"))
        got = ex.run_banks(thetas, datas, False, group_sets)
        assert len(got) == len(want)
        for g, w, gs, b in zip(got, want, group_sets, sizes):
            assert g.shape == (len(gs), b) and torch.equal(g, w)


def test_mesh_spill_executor_matches_reference():
    """``MeshSpillExecutor.rows`` / ``.banks`` (default: a one-device mesh
    on the inputs' device) against the reference's worker_batched_executor
    (the reference's own sharded path fails under jax 0.9, Queue 3 R1)."""
    spec = circuits.build_quclassi_circuit(7, 1)
    th, dt = _rows(spec, 21, seed=3)
    ex = dp.MeshSpillExecutor()
    got = ex.rows(spec, *_t(th, dt))
    assert ex.mesh.devices == (torch.device("cpu"),)
    ref = jdp.worker_batched_executor(spec, jdp.round_robin_assignment(21, 3), 3)(
        jnp.asarray(th), jnp.asarray(dt))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)

    jbank = jshift.build_shift_bank(jnp.asarray(th[0]), jnp.asarray(dt[:6]))
    n_groups = jbank.n_groups
    gs = (tuple(range(0, n_groups, 2)), tuple(range(1, n_groups, 2)))
    outs = ex.banks(spec, (torch.tensor(np.asarray(jbank.theta)),) * 2,
                    (torch.tensor(np.asarray(jbank.data)),) * 2, False, gs)
    ref = np.asarray(jdp.worker_batched_executor(
        spec, jdp.round_robin_assignment(n_groups, 2), 2)(jbank)).reshape(n_groups, -1)
    for out, groups in zip(outs, gs):
        np.testing.assert_allclose(out.numpy(), ref[list(groups)], rtol=0, atol=ATOL)


def test_mesh_module():
    assert tmesh.make_host_mesh("cpu").devices == (torch.device("cpu"),)
    assert tmesh.batch_axes(tmesh.make_host_mesh("cpu")) == ("data",)
    pod = tmesh.make_production_mesh()
    assert pod.axis_names == ("data", "model") and pod.shape == {"data": 16, "model": 16}
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert tmesh.batch_axes(multi) == ("pod", "data") and tmesh.data_axis_size(multi) == 32
    assert tmesh.chips(pod) == 256 and tmesh.chips(multi) == 512
    with pytest.raises(ValueError):
        tmesh.DeviceMesh(())
    with pytest.raises(ValueError, match="'data' only"):
        dp.sharded_executor(circuits.build_quclassi_circuit(5, 1),
                            tmesh.make_host_mesh("cpu"), axis="model")
