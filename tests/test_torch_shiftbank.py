"""Port parity for the prefix-reuse shift kernel and the shift-bank paths.

Shift rows go through ``repro.kernels.ops.vqc_fidelity_shiftgroups`` (Pallas,
interpret mode) and the port's (plain PyTorch version on the CPU) from the
same seeded numpy inputs, at 1e-5 absolute (the reference's float32 kernel
tolerance; the two differ only in rounding).  Invariants the reference pins
bit-exactly are pinned bit-exactly again, port against port: the implicit
bank's ``materialize()`` equals ``build_bank``, and a fused multibank launch
equals the per-bank launches lane for lane.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import circuits as jcircuits
from repro.kernels import ops as jops
from repro_torch.core import circuits as tcircuits
from repro_torch.core import shift_rule as tsr
from repro_torch.core.sim import CircuitSpec, Op
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import vqc_statevector as K

ATOL = 1e-5


def _specs(qc, nl, tied=False):
    name = "build_tied_quclassi_circuit" if tied else "build_quclassi_circuit"
    return getattr(jcircuits, name)(qc, nl), getattr(tcircuits, name)(qc, nl)


def _angles(spec, batch, seed):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, np.pi, (batch, spec.n_theta)).astype(np.float32)
    data = rng.uniform(0.0, np.pi, (batch, spec.n_data)).astype(np.float32)
    return theta, data


@pytest.mark.parametrize(
    "qc,nl,batch,four,groups,tied",
    [
        (3, 2, 1, False, None, False),
        (5, 1, 7, False, None, False),
        (5, 3, 33, True, None, False),
        (7, 3, 7, False, (0, 3, 8, 14, 28), False),   # a partial group set
        (5, 3, 7, False, None, True),                  # tied: multi-use replay
        (5, 2, 33, True, (0, 2, 7, 19, 24), True),
        (13, 3, 3, False, tuple(range(0, 65, 2)), False),  # worker 0 of 2: a 4-sample sweep
    ],
)
def test_shift_rows_match_reference(qc, nl, batch, four, groups, tied):
    js, ts = _specs(qc, nl, tied)
    theta, data = _angles(ts, batch, seed=qc + nl + batch)
    assert K.use_shift_plan(ts, four)
    got = tops.vqc_fidelity_shiftgroups(ts, torch.from_numpy(theta), torch.from_numpy(data),
                                        four, groups)
    want = jops.vqc_fidelity_shiftgroups(js, jnp.asarray(theta), jnp.asarray(data),
                                         four, groups)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    # and against the port's dense oracle on the materialized rows
    bank = tsr.build_shift_bank(torch.from_numpy(theta), torch.from_numpy(data), four)
    mat = bank.materialize()
    dense = tref.vqc_fidelity_ref(ts, mat.theta, mat.data).reshape(bank.n_groups, batch)
    rows = list(groups) if groups is not None else list(range(bank.n_groups))
    np.testing.assert_allclose(got.numpy(), dense[rows].numpy(), rtol=0, atol=ATOL)


def test_unstructured_spec_materializes_requested_groups():
    spec = CircuitSpec(n_qubits=2, ops=(Op("ry", (0,), ("theta", 0)),
                                        Op("ry", (1,), ("data", 0))), n_theta=1, n_data=1)
    assert K.build_shift_plan(spec) is None
    t = torch.tensor([[0.3], [0.9]])
    d = torch.tensor([[0.1], [0.4]])
    got = tops.vqc_fidelity_shiftgroups(spec, t, d, False, (0, 2))
    mat = tsr.build_shift_bank(t, d).materialize()
    want = tops.vqc_fidelity(spec, mat.theta, mat.data).reshape(3, 2)[[0, 2]]
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        K.vqc_shift_fidelity(spec, t, d)


def test_groups_out_of_range_raise():
    _, ts = _specs(5, 1)
    t, d = (torch.from_numpy(a) for a in _angles(ts, 2, seed=0))
    with pytest.raises(ValueError):
        K.vqc_shift_fidelity(ts, t, d, groups=(0, 99))


def test_duplicate_groups_fill_every_row():
    _, ts = _specs(5, 2)
    t, d = (torch.from_numpy(a) for a in _angles(ts, 5, seed=1))
    got = K.vqc_shift_fidelity(ts, t, d, groups=(3, 0, 3))
    assert torch.equal(got[0], got[2])
    assert torch.equal(got[1], K.vqc_shift_fidelity(ts, t, d, groups=(0,))[0])


@pytest.mark.parametrize("four", [False, True])
def test_materialize_bit_identical_to_build_bank(four):
    _, ts = _specs(7, 3)
    theta = torch.from_numpy(_angles(ts, 1, seed=2)[0][0])
    data = torch.from_numpy(_angles(ts, 6, seed=3)[1])
    mat = tsr.build_shift_bank(theta, data, four).materialize()
    bank = tsr.build_bank(theta, data, four)
    assert torch.equal(mat.theta, bank.theta)
    assert torch.equal(mat.data, bank.data)
    assert (mat.n_samples, mat.n_params, mat.four_term) == (6, ts.n_theta, four)


def _banks(spec, sizes, seed):
    out = []
    for i, b in enumerate(sizes):
        theta, data = _angles(spec, b, seed=seed + i)
        out.append(tsr.build_shift_bank(torch.from_numpy(theta[0]), torch.from_numpy(data)))
    return out


@pytest.mark.parametrize("qc,nl,tied", [(5, 1, False), (7, 3, False), (7, 3, True)])
def test_multibank_bit_identical_to_per_bank(qc, nl, tied):
    _, ts = _specs(qc, nl, tied)
    banks = _banks(ts, (3, 40, 5), seed=qc)
    outs = tops.vqc_fidelity_shiftgroups_multibank(
        ts, tuple(b.theta for b in banks), tuple(b.data for b in banks), False,
        tuple(tuple(range(b.n_groups)) for b in banks))
    for bank, out in zip(banks, outs):
        assert torch.equal(out, tops.vqc_fidelity_shiftgroups(ts, bank.theta, bank.data))


def test_multibank_partial_group_sets_and_executor():
    _, ts = _specs(5, 2)
    banks = _banks(ts, (4, 9), seed=11)
    gs = ((0, 2, 5), (1, 2, ts.n_theta * 2))
    outs = tops.vqc_fidelity_shiftgroups_multibank(
        ts, tuple(b.theta for b in banks), tuple(b.data for b in banks), False, gs)
    for bank, got, groups in zip(banks, outs, gs):
        assert torch.equal(got, tops.vqc_fidelity_shiftgroups(ts, bank.theta, bank.data,
                                                               False, groups))
    ex = tops.multibank_executor(ts)
    assert ex.capabilities.multibank
    for bank, flat in zip(banks, tsr.run_bank_set(ex, banks)):
        assert torch.equal(flat, tops.vqc_fidelity_shiftbank(ts, bank.theta, bank.data))


def test_shiftbank_executor_both_bank_modes():
    _, ts = _specs(5, 1)
    theta, data = _angles(ts, 6, seed=12)
    bank = tsr.build_shift_bank(torch.from_numpy(theta[0]), torch.from_numpy(data))
    ex = tops.shiftbank_executor(ts)
    mat = bank.materialize()
    np.testing.assert_allclose(tsr.run_bank(ex, bank).numpy(), tsr.run_bank(ex, mat).numpy(),
                               rtol=0, atol=ATOL)


def test_launch_observer_reports_execution_mode():
    _, ts = _specs(7, 3)
    theta, data = _angles(ts, 33, seed=13)
    seen = []
    prev = tops.set_launch_observer(seen.append)
    try:
        tops.vqc_fidelity_shiftgroups(ts, torch.from_numpy(theta), torch.from_numpy(data))
    finally:
        tops.set_launch_observer(prev)
    (info,) = seen
    assert info["mode"] == "fused" and info["launches"] == 1 and info["lanes"] == 33
    # the staged tables, then 14 checkpoints + 3 live states of 64 floats
    # for each of SHIFT_WARPS samples a block
    plan = K.build_shift_plan(ts)
    assert (info["tb"], info["smem_bytes"]) == K.shift_geometry(plan, 14, 2 * ts.n_theta)
    assert info["tb"] == K.SHIFT_WARPS
    assert info["smem_bytes"] == (K.walk_table_bytes(plan, 28)
                                  + K.walk_smem_bytes(3, 14, K.SHIFT_WARPS))
