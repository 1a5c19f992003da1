"""The device-memory route's pass planner, its tables and its chunked order.

From 15 qubits a circuit's state lives in device memory and the op table
runs in passes of at most k local qubits (``dmem_plan``).  These CPU tests
pin the plan (order, width, the lowest-order padding, the pass counts at
the widths the serving path routes there), the tables the kernels read
(local op rows, zero masks) and, through ``_dmem_plain`` (the kernels'
chunked order in plain PyTorch, on the same tables), that the chunked
evolution gives ``_fused_plain``'s state.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import circuits
from repro_torch.kernels import vqc_statevector as K


def _spec(name: str):
    qc, nl = (int(x[:-1]) for x in name.split("-")[:2])
    if name.endswith("tied"):
        return circuits.build_tied_quclassi_circuit(qc, nl)
    if qc % 2 == 0:  # an idle last qubit on an odd circuit
        return dataclasses.replace(circuits.build_quclassi_circuit(qc - 1, nl), n_qubits=qc)
    return circuits.build_quclassi_circuit(qc, nl)


def _angles(spec, c, seed=0):
    rng = np.random.default_rng(seed)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, (c, spec.n_theta)), dtype=torch.float32)
    dt = torch.tensor(rng.uniform(0.0, np.pi, (c, spec.n_data)), dtype=torch.float32)
    return th, dt


PLANS = [("15q-1l", 13), ("17q-1l", 13), ("19q-1l", 13), ("17q-3l", 13), ("15q-1l", 12),
         ("17q-1l", 14), ("9q-2l", 6), ("11q-3l-tied", 7), ("13q-3l", 13), ("14q-1l", 12)]


@pytest.mark.parametrize("name,k", PLANS)
def test_passes_cover_the_op_table_in_order(name, k):
    spec = _spec(name)
    plan = K.dmem_plan(spec, k)
    assert plan[0].lo == 0 and plan[-1].hi == len(spec.ops)
    for a, b in zip(plan, plan[1:]):
        assert a.hi == b.lo and a.lo < a.hi
    width = min(k, spec.n_qubits)
    for p in plan:
        assert len(p.qubits) == width and list(p.qubits) == sorted(set(p.qubits))
        for op in spec.ops[p.lo:p.hi]:
            assert set(op.qubits) <= set(p.qubits)
    # greedy: the next pass's first op did not fit this pass's qubits
    for a, b in zip(plan, plan[1:]):
        held = {q for op in spec.ops[a.lo:a.hi] for q in op.qubits}
        sector = set(range(spec.n_qubits - K.DMEM_SECTOR_QUBITS, spec.n_qubits))
        assert len(held | sector | set(spec.ops[b.lo].qubits)) > width


@pytest.mark.parametrize("name,k", PLANS)
def test_lowest_order_qubits_fill_each_pass(name, k):
    spec = _spec(name)
    n = spec.n_qubits
    for p in K.dmem_plan(spec, k):
        gates = {q for op in spec.ops[p.lo:p.hi] for q in op.qubits}
        # the sector qubits are always local, so a chunk's runs of 2**3
        # amplitudes fill 32-byte sectors
        assert set(range(n - min(K.DMEM_SECTOR_QUBITS, len(p.qubits)), n)) <= set(p.qubits)
        pad = set(p.qubits) - gates
        outside = set(range(n)) - set(p.qubits)
        assert all(q > o for q in pad for o in outside - gates)


@pytest.mark.parametrize("qc", [15, 17])
def test_three_passes_at_the_device_memory_widths(qc):
    spec = circuits.build_quclassi_circuit(qc, 1)
    assert K.fused_geometry(qc, 1) == (0, 0)  # no block holds one state
    assert len(K.dmem_plan(spec, 13)) == 3
    assert K.dmem_traffic_bytes(spec, False, 13)[0] == 3
    assert len(K.dmem_plan(spec)) == 3  # the kernels' k


def test_narrow_circuits_take_one_pass_of_every_qubit():
    for name in ("5q-1l", "13q-3l", "7q-3l-tied"):
        spec = _spec(name)
        (only,) = K.dmem_plan(spec)
        assert only == K.DmemPass(0, len(spec.ops), tuple(range(spec.n_qubits)))


@pytest.mark.parametrize("name,k", PLANS)
def test_tables_hold_local_ranks_and_zero_masks(name, k):
    spec = _spec(name)
    n = spec.n_qubits
    rows, local_ops, consts = K._dmem_tables(spec, k)
    ints, consts0 = K._spec_table(spec)
    plan = K.dmem_plan(spec, k)
    assert rows.dtype == np.int32 and rows.shape == (len(plan), 6)
    np.testing.assert_array_equal(consts, consts0)
    np.testing.assert_array_equal(local_ops[:, [0, 4, 5]], ints[:, [0, 4, 5]])
    reached = 0
    for p, row in zip(plan, rows):
        assert (row[0], row[1]) == (p.lo, p.hi)
        local = K._mask(row, 2)
        assert local == sum(1 << (n - 1 - q) for q in p.qubits)
        assert K._mask(row, 4) == ((1 << n) - 1) & ~reached  # every bit in the first pass
        reached |= local
        for r in range(p.lo, p.hi):
            a = len(spec.ops[r].qubits)
            want = [p.qubits.index(q) for q in ints[r, 1:1 + a]]
            assert list(local_ops[r, 1:1 + a]) == want
            assert want == sorted(want)  # a rank keeps the kernels' ascending order


def test_masks_above_32_bits_round_trip():
    spec = dataclasses.replace(circuits.build_quclassi_circuit(5, 1), n_qubits=35)
    rows, _, _ = K._dmem_tables(spec)
    (only,) = K.dmem_plan(spec)
    assert K._mask(rows[0], 4) == (1 << 35) - 1
    assert K._mask(rows[0], 2) == sum(1 << (34 - q) for q in only.qubits)
    assert K._mask(rows[0], 2) >> 32 == 0b111  # qubits 0, 1, 2: bits 34, 33, 32


@pytest.mark.parametrize("name,k", PLANS + [("17q-1l", 8), ("15q-3l", 10)])
def test_chunked_order_gives_the_plain_state(name, k):
    """The passes run chunk by chunk on the kernels' tables give
    ``_fused_plain``'s state value for value (each amplitude meets the same
    gates in the same order with the same arithmetic), and P0 within 1e-6
    of that state's ancilla-0 half summed in float64."""
    spec = _spec(name)
    th, dt = _angles(spec, 3, seed=len(name) + k)
    re, im = K._dmem_plain(spec, th, dt, True, k)
    pre, pim = K._fused_plain(spec, th, dt, True)
    assert torch.equal(re, pre) and torch.equal(im, pim)
    half = 2 ** (spec.n_qubits - 1)
    want = (pre[:, :half].double() ** 2 + pim[:, :half].double() ** 2).sum(1).float()
    p0 = K._dmem_plain(spec, th, dt, False, k)
    torch.testing.assert_close(p0, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,k", [("15q-1l", 13), ("9q-2l", 6), ("14q-1l", 12)])
def test_chunked_order_reads_only_what_it_wrote(name, k):
    """Every amplitude a pass reads was stored by an earlier pass or is
    under the zero mask: ``_dmem_plain`` starts from NaN, so a read of
    memory no pass wrote would show in the state."""
    spec = _spec(name)
    th, dt = _angles(spec, 2, seed=5)
    re, im = K._dmem_plain(spec, th, dt, True, k)
    assert torch.isfinite(re).all() and torch.isfinite(im).all()


def test_zero_chunks_are_skipped():
    """The first pass computes only the chunk that holds |0...0>, and the
    fidelity's last pass only chunks whose ancilla half is 0 where the
    ancilla is not local."""
    spec = circuits.build_quclassi_circuit(17, 1)
    first = next(K._dmem_chunks(spec, 13, False))
    assert first[3].sum() == 1 and first[1][first[3]][0] == 0
    *_, (_, bases, _, live, last) = K._dmem_chunks(spec, 13, False)
    assert last and 0 in K.dmem_plan(spec, 13)[-1].qubits and live.all()
    # an ancilla outside the last pass: half its chunks are skipped
    late = dataclasses.replace(spec, ops=spec.ops[:16])  # the data encoding alone
    *_, (_, bases, _, live, last) = K._dmem_chunks(late, 13, False)
    assert 0 not in K.dmem_plan(late, 13)[-1].qubits
    assert live.sum() == 1  # chunk 0: the only one |0...0> reached


@pytest.mark.parametrize("qc,k", [(15, 13), (17, 13), (17, 12), (19, 13)])
def test_traffic_is_a_few_state_passes(qc, k):
    """P0 moves fewer bytes than the state, and both a few passes of the
    state where the per-gate scheme moved one read and write a gate."""
    spec = circuits.build_quclassi_circuit(qc, 1)
    n_pass, p0_bytes = K.dmem_traffic_bytes(spec, False, k)
    _, state_bytes = K.dmem_traffic_bytes(spec, True, k)
    one_state = K._state_bytes(qc, 1)
    assert n_pass == len(K.dmem_plan(spec, k))
    assert p0_bytes < state_bytes <= 2 * n_pass * one_state
    # the state is written whole at least once
    assert state_bytes >= one_state


def test_traffic_of_one_pass_is_its_writes():
    """One pass: no loads (|0...0> is made in shared memory), the state's
    one store, or the fidelity's one partial sum read and written."""
    spec = circuits.build_quclassi_circuit(7, 2)
    assert K.dmem_traffic_bytes(spec, True) == (1, K._state_bytes(7, 1))
    assert K.dmem_traffic_bytes(spec, False) == (1, 8)


@pytest.mark.parametrize("c,sm,want", [(256, 132, 1), (64, 132, 4), (8, 132, 8), (1, 132, 8),
                                       (130, 132, 2), (1000, 132, 1), (8, 2, 1)])
def test_cluster_size_fills_the_card(c, sm, want):
    spec = circuits.build_quclassi_circuit(17, 1)
    cs, smem = K.dmem_geometry(spec, c, sm)
    assert cs == want
    assert smem == K._dmem_smem(spec) <= K.SMEM_BUDGET_BYTES
    assert smem >= K._state_bytes(K.DMEM_LOCAL_QUBITS, 1)


def test_cluster_size_is_capped_by_the_chunks():
    spec = circuits.build_quclassi_circuit(15, 1)  # 4 chunks a pass
    assert K.dmem_geometry(spec, 1, 132)[0] == 4
    narrow = circuits.build_quclassi_circuit(13, 3)  # one chunk
    assert K.dmem_geometry(narrow, 1, 132)[0] == 1
