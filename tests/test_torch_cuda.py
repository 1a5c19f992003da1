"""The port's CUDA kernels on a GPU: each against its plain PyTorch version.

Marked ``requires_cuda``: each test skips (inside its fixture, never at
import) on a host without a CUDA device.  This file imports no JAX, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m requires_cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import base as cfg_base
from repro_torch.core import circuits, quclassi, trainer
from repro_torch.data import mnist
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import ops
from repro_torch.kernels import vqc_statevector as K
from repro_torch.models import multimodal, transformer

pytestmark = pytest.mark.requires_cuda
ATOL = 1e-5  # float32: other cos/sin and summation order than the plain version
#: the shift walk's device-memory rows also within ROW_RTOL of their own
#: size (ROW_ATOL where ~0)
ROW_RTOL, ROW_ATOL = 1e-4, 1e-10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _angles(spec, c, device, seed=0):
    rng = np.random.default_rng(seed)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, (c, spec.n_theta)), dtype=torch.float32)
    dt = torch.tensor(rng.uniform(0, np.pi, (c, spec.n_data)), dtype=torch.float32)
    return th.to(device), dt.to(device)


@pytest.mark.parametrize("qc,nl,tied", [(3, 1, False), (5, 2, False), (7, 3, True)])
@pytest.mark.parametrize("c", [1, 33, 300])
def test_fused_kernels_match_plain(cuda, qc, nl, tied, c):
    build = circuits.build_tied_quclassi_circuit if tied else circuits.build_quclassi_circuit
    spec = build(qc, nl)
    th, dt = _angles(spec, c, cuda, seed=c)
    before = dict(K.LAUNCHES)
    p0 = K.vqc_p0(spec, th, dt)
    re, im = K.vqc_state(spec, th, dt)
    assert K.LAUNCHES["fidelity"] == before["fidelity"] + 1
    assert K.LAUNCHES["state"] == before["state"] + 1
    torch.testing.assert_close(p0, K._fused_plain(spec, th, dt, False), rtol=0, atol=ATOL)
    pre, pim = K._fused_plain(spec, th, dt, True)
    torch.testing.assert_close(re, pre, rtol=0, atol=ATOL)
    torch.testing.assert_close(im, pim, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [10, 12, 14])
def test_state_kernel_wide(cuda, n):
    """The state kernel on the fidelity kernel's warp geometry, at widths
    its one-thread predecessor refused (from 10 qubits): a QuClassi
    circuit on n - 1 qubits with one idle least significant qubit."""
    base = circuits.build_quclassi_circuit(n - 1, 1)
    spec = dataclasses.replace(base, n_qubits=n)
    assert K.fused_geometry(n, 33)[0] > 0
    th, dt = _angles(spec, 33, cuda, seed=n)
    before = K.LAUNCHES["state"]
    re, im = K.vqc_state(spec, th, dt)
    assert K.LAUNCHES["state"] == before + 1
    pre, pim = K._fused_plain(spec, th, dt, True)
    torch.testing.assert_close(re, pre, rtol=0, atol=ATOL)
    torch.testing.assert_close(im, pim, rtol=0, atol=ATOL)


@pytest.mark.parametrize("qc,nl", [(3, 1), (5, 2), (7, 3), (11, 1)])
@pytest.mark.parametrize("c", [1, 33, 300, 1061])  # 1061: the last block ragged
def test_fidelity_warp_kernel_matches_plain(cuda, qc, nl, c):
    """The warp-per-circuit fidelity kernel, narrow circuits (idle lanes)
    and 11 qubits (2**10 pairs a gate, beyond the one-thread kernel's
    limit) included."""
    spec = circuits.build_quclassi_circuit(qc, nl)
    warps, smem = K.fused_geometry(qc, c)
    assert warps > 0 and smem <= K.SMEM_BUDGET_BYTES
    if c == 1061:
        assert c % warps
    th, dt = _angles(spec, c, cuda, seed=c + qc)
    before = K.LAUNCHES["fidelity"]
    got = K.vqc_p0(spec, th, dt)
    assert K.LAUNCHES["fidelity"] == before + 1
    want = K._fused_plain(spec, th, dt, False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("qc,nl,tied", [(5, 1, False), (7, 3, False), (7, 3, True)])
@pytest.mark.parametrize("four", [False, True])
def test_shiftbank_kernel_matches_plain(cuda, qc, nl, tied, four):
    build = circuits.build_tied_quclassi_circuit if tied else circuits.build_quclassi_circuit
    spec = build(qc, nl)
    plan = K.build_shift_plan(spec)
    shifts = K.shift_values(four)
    n_groups = 1 + len(shifts) * spec.n_theta
    th, dt = _angles(spec, 77, cuda, seed=qc)
    for groups in (tuple(range(n_groups)), tuple(range(n_groups - 1, 0, -3)), (0,)):
        before = K.LAUNCHES["shiftbank"]
        got = K.vqc_shift_fidelity(spec, th, dt, four_term=four, groups=groups)
        assert K.LAUNCHES["shiftbank"] == before + 1
        want = K._shiftbank_plain(plan, shifts, groups, spec.n_theta, th, dt)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_multibank_lane_identity_on_card(cuda):
    spec = circuits.build_quclassi_circuit(7, 3)
    banks = [_angles(spec, b, cuda, seed=b) for b in (5, 64, 130)]
    outs = ops.vqc_fidelity_shiftgroups_multibank(
        spec, tuple(t for t, _ in banks), tuple(d for _, d in banks), False,
        ((0, 1), tuple(range(29)), (28,)))
    for (t, d), gs, out in zip(banks, ((0, 1), tuple(range(29)), (28,)), outs):
        assert torch.equal(out, ops.vqc_fidelity_shiftgroups(spec, t, d, False, gs))


def _spill_budget(spec, four, groups, n_ckpt):
    """A budget under which the single sweep cannot hold one sample and the
    spill pair must tile: the staged tables and, for one sample, n_ckpt
    checkpoints and 4 live states."""
    plan = K.build_shift_plan(spec)
    n_variants = K._walk_table(spec, four, groups, K.SMEM_BUDGET_BYTES, False).n_variants
    return K.walk_table_bytes(plan, n_variants) + (n_ckpt + 4) * K._state_bytes(plan.m, 1)


@pytest.mark.parametrize("qc,nl,tied,budget_ckpts", [
    (13, 3, False, None),   # m = 6: one tile of 4 samples at 227 KB
    (17, 1, False, None),   # m = 8
    (17, 3, False, None),   # 2 tiles
    (19, 1, False, None),   # m = 9: refused by the one-thread forward kernel
    (7, 3, True, 3),        # forced budget: multi-use replay spans tile
    (5, 3, True, 2),
])
@pytest.mark.parametrize("four", [False, True])
def test_spill_kernels_match_plain(cuda, qc, nl, tied, budget_ckpts, four):
    """The spill pair launched directly (whichever route the request would
    take), against the plain pair over the same tiles."""
    build = circuits.build_tied_quclassi_circuit if tied else circuits.build_quclassi_circuit
    spec = build(qc, nl)
    plan = K.build_shift_plan(spec)
    shifts = K.shift_values(four)
    n_groups = 1 + len(shifts) * spec.n_theta
    th, dt = _angles(spec, 100, cuda, seed=qc + nl)
    for groups in (tuple(range(n_groups)), tuple(range(1, n_groups, 2))):
        budget = (K.SMEM_BUDGET_BYTES if budget_ckpts is None
                  else _spill_budget(spec, four, groups, budget_ckpts))
        tab = K._walk_table(spec, four, groups, budget, True)
        assert tab.tb > 0 and tab.smem_bytes <= K.SMEM_BUDGET_BYTES
        if budget_ckpts is not None:
            info = K.shift_execution_info(spec, 100, four_term=four, groups=groups,
                                          smem_budget=budget)
            assert info["mode"] == "spill" and info["n_tiles"] >= 2
        before = dict(K.LAUNCHES)
        got = K._shift_spilled_cuda(tab, th, dt)
        assert K.LAUNCHES["shift_forward"] == before["shift_forward"] + 1
        assert K.LAUNCHES["shift_tile"] == before["shift_tile"] + 1
        want = K._shift_spilled_plain(plan, shifts, groups, spec.n_theta, tab.tiles, th, dt)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("four", [False, True])
def test_shift_routes_match_plain_at_13q(cuda, four):
    """13q-3l, both workers' groups of 2 and all groups: the single sweep
    (the route the plan takes) and the spill pair, each against its plain
    version; the two routes apply the same gates with the same arithmetic,
    so they agree bit for bit."""
    spec = circuits.build_quclassi_circuit(13, 3)
    plan = K.build_shift_plan(spec)
    shifts = K.shift_values(four)
    n_groups = 1 + len(shifts) * spec.n_theta
    th, dt = _angles(spec, 576, cuda, seed=13)
    for groups in (tuple(range(0, n_groups, 2)), tuple(range(1, n_groups, 2)),
                   tuple(range(n_groups))):
        sweep = K._walk_table(spec, four, groups, K.SMEM_BUDGET_BYTES, False)
        spill = K._walk_table(spec, four, groups, K.SMEM_BUDGET_BYTES, True)
        assert K._shift_route(spec, four, groups, K.SMEM_BUDGET_BYTES) is sweep
        before = dict(K.LAUNCHES)
        got_sweep = K._shiftbank_cuda(sweep, th, dt)
        got_spill = K._shift_spilled_cuda(spill, th, dt)
        assert K.LAUNCHES["shiftbank"] == before["shiftbank"] + 1
        assert K.LAUNCHES["shift_tile"] == before["shift_tile"] + 1
        want = K._shiftbank_plain(plan, shifts, groups, spec.n_theta, th, dt)
        torch.testing.assert_close(got_sweep, want, rtol=0, atol=ATOL)
        torch.testing.assert_close(got_spill, want, rtol=0, atol=ATOL)
        assert torch.equal(got_sweep, got_spill)


@pytest.mark.parametrize("route", ["fused", "spill"])
def test_spilled_multibank_bit_identical_on_card(cuda, route):
    """13q-3l on each route: banks packed into one launch equal per-bank
    launches bit for bit (a sample's result never depends on its warp's
    place in the launch).  The banks ask for different groups, so the
    union launch holds other checkpoints (and, spilled under a forced
    budget, cuts other depth tiles) than some per-bank launches: a
    checkpoint reached through another tile start has the same bits."""
    spec = circuits.build_quclassi_circuit(13, 3)
    n_groups = 1 + 2 * spec.n_theta
    group_sets = (tuple(range(0, n_groups, 2)), tuple(range(1, n_groups, 2)),
                  tuple(range(0, n_groups, 3)))
    sizes = (5, 100, 333)
    union = tuple(sorted(set().union(*group_sets)))
    budget = (K.SMEM_BUDGET_BYTES if route == "fused"
              else _spill_budget(spec, False, union, 8))
    infos = [K.shift_execution_info(spec, b, groups=gs, smem_budget=budget)
             for b, gs in zip(sizes, (*group_sets, union))]
    assert all(i["mode"] == route for i in infos)
    if route == "spill":
        assert any(i["tiles"] != infos[-1]["tiles"] for i in infos[:-1])
    banks = [_angles(spec, b, cuda, seed=b) for b in sizes]
    theta, data, segments = ops._pack_banks(tuple(t for t, _ in banks),
                                            tuple(d for _, d in banks))
    out = K.vqc_shift_fidelity(spec, theta, data, groups=union, smem_budget=budget)
    row = {g: i for i, g in enumerate(union)}
    for (t, d), gs, (off, b) in zip(banks, group_sets, segments):
        per_bank = K.vqc_shift_fidelity(spec, t, d, groups=gs, smem_budget=budget)
        assert torch.equal(out[[row[g] for g in gs], off : off + b], per_bank)


def test_unfit_shapes_raise_instead_of_running(cuda):
    # a shift plan no block of the shared-memory routes holds runs on the
    # shift walk's device-memory route; only a register too narrow for its
    # chunks (m < 3) still raises, before any launch
    wide = circuits.build_quclassi_circuit(13, 3)  # m = 6
    th, dt = _angles(wide, 8, cuda)
    got = K.vqc_shift_fidelity(wide, th, dt, smem_budget=2 * K._state_bytes(6, 1))
    torch.testing.assert_close(got, K.vqc_shift_fidelity(wide, th, dt), rtol=0, atol=1e-6)
    narrow = circuits.build_quclassi_circuit(5, 1)  # m = 2
    th, dt = _angles(narrow, 8, cuda)
    before = dict(K.LAUNCHES)
    with pytest.raises(NotImplementedError, match="3 qubits or more"):
        K.vqc_shift_fidelity(narrow, th, dt, smem_budget=64)
    # rows of 15 or more qubits run on the device-memory route, up to the
    # widest state the card holds; one qubit more raises, naming that width
    limit = K.dmem_max_qubits(cuda)
    widest = dataclasses.replace(circuits.build_quclassi_circuit(5, 1), n_qubits=limit + 1)
    th, dt = _angles(widest, 2, cuda)
    with pytest.raises(NotImplementedError, match=f"up to {limit} qubits"):
        K.vqc_p0(widest, th, dt)
    with pytest.raises(NotImplementedError, match=f"up to {limit} qubits"):
        K.vqc_state(widest, th, dt)
    assert K.LAUNCHES == before


@pytest.mark.parametrize("qc,c", [(15, 256), (17, 64)])
def test_device_memory_route_matches_plain(cuda, qc, c):
    """Rows of 15 and 17 qubits (no block holds one state) on the
    device-memory kernels, one launch each, against the plain version."""
    spec = circuits.build_quclassi_circuit(qc, 1)
    assert K.fused_geometry(qc, c) == (0, 0)
    th, dt = _angles(spec, c, cuda, seed=qc)
    before = dict(K.LAUNCHES)
    p0 = K.vqc_p0(spec, th, dt)
    re, im = K.vqc_state(spec, th, dt)
    assert K.LAUNCHES["fidelity_dmem"] == before["fidelity_dmem"] + 1
    assert K.LAUNCHES["state_dmem"] == before["state_dmem"] + 1
    assert K.LAUNCHES["fidelity"] == before["fidelity"]
    torch.testing.assert_close(p0, K._fused_plain(spec, th, dt, False), rtol=0, atol=ATOL)
    pre, pim = K._fused_plain(spec, th, dt, True)
    torch.testing.assert_close(re, pre, rtol=0, atol=ATOL)
    torch.testing.assert_close(im, pim, rtol=0, atol=ATOL)


def test_device_memory_route_chunks_its_workspace(cuda, monkeypatch):
    """A workspace of three 15-qubit states: 8 circuits run in 3 launches
    and give the bits of one launch."""
    spec = circuits.build_quclassi_circuit(15, 1)
    th, dt = _angles(spec, 8, cuda, seed=3)
    whole = K.vqc_p0(spec, th, dt)
    monkeypatch.setattr(K, "DMEM_WORKSPACE_BYTES", 3 * K._state_bytes(15, 1))
    before = K.LAUNCHES["fidelity_dmem"]
    chunked = K.vqc_p0(spec, th, dt)
    assert K.LAUNCHES["fidelity_dmem"] == before + 3
    assert torch.equal(chunked, whole)


@pytest.mark.parametrize("name", ["13q-3l", "14q-1l"])
def test_device_memory_route_equals_warp_route(cuda, name):
    """At widths both routes run, the device-memory kernels (one pass of a
    single chunk at 13q-3l, two chunks a pass at 14q) give the warp
    kernels' state bit for bit, and P(0) within 1e-6 (another summation
    order)."""
    if name == "13q-3l":
        spec = circuits.build_quclassi_circuit(13, 3)
    else:  # 13q-1l with one idle lowest-order qubit
        spec = dataclasses.replace(circuits.build_quclassi_circuit(13, 1), n_qubits=14)
    th, dt = _angles(spec, 40, cuda, seed=spec.n_qubits)
    before = dict(K.LAUNCHES)
    re, im = K._state_dmem_cuda(spec, th, dt)
    p0 = K._fidelity_dmem_cuda(spec, th, dt)
    assert K.LAUNCHES["state_dmem"] == before["state_dmem"] + 1
    assert K.LAUNCHES["fidelity_dmem"] == before["fidelity_dmem"] + 1
    wre, wim = K.vqc_state(spec, th, dt)
    wp0 = K.vqc_p0(spec, th, dt)
    assert K.LAUNCHES["state"] == before["state"] + 1
    assert K.LAUNCHES["fidelity"] == before["fidelity"] + 1
    assert torch.equal(re, wre) and torch.equal(im, wim)
    torch.testing.assert_close(p0, wp0, rtol=0, atol=1e-6)


def test_device_memory_route_19q(cuda):
    """19q-1l (3 passes of 64 chunks, a cluster of 8 blocks a circuit at
    C = 8) against the plain version."""
    spec = circuits.build_quclassi_circuit(19, 1)
    th, dt = _angles(spec, 8, cuda, seed=19)
    assert K.dmem_geometry(spec, 8, torch.cuda.get_device_properties(cuda)
                           .multi_processor_count)[0] == K.DMEM_MAX_CLUSTER
    before = dict(K.LAUNCHES)
    p0 = K.vqc_p0(spec, th, dt)
    re, im = K.vqc_state(spec, th, dt)
    assert K.LAUNCHES["fidelity_dmem"] == before["fidelity_dmem"] + 1
    assert K.LAUNCHES["state_dmem"] == before["state_dmem"] + 1
    torch.testing.assert_close(p0, K._fused_plain(spec, th, dt, False), rtol=0, atol=ATOL)
    pre, pim = K._fused_plain(spec, th, dt, True)
    torch.testing.assert_close(re, pre, rtol=0, atol=ATOL)
    torch.testing.assert_close(im, pim, rtol=0, atol=ATOL)


def _shared_angle_spec(qc, n_shared):
    """QuClassi qc-1l with its parameters folded onto ``n_shared``: each
    parameter's replay span reaches across the register."""
    base = circuits.build_quclassi_circuit(qc, 1)
    ops_ = tuple(dataclasses.replace(op, param=("theta", op.param[1] % n_shared))
                 if op.param is not None and op.param[0] == "theta" else op for op in base.ops)
    return dataclasses.replace(base, ops=ops_, n_theta=n_shared)


@pytest.mark.parametrize("name,m", [("27q-1l", 13), ("tied-27q-1l", 13), ("29q-1l", 14),
                                    ("shared-29q-1l", 14), ("33q-1l", 16)])
@pytest.mark.parametrize("subset", [False, True])
def test_shift_dmem_kernel_matches_plain(cuda, name, m, subset):
    """The shift walk's device-memory kernel (registers of 13-16 qubits,
    one launch) against its plain version: whole banks and a group subset
    of the 2-worker round robin."""
    qc = int(name.split("-")[-2][:-1])
    if name.startswith("tied"):
        spec = circuits.build_tied_quclassi_circuit(qc, 1)
    elif name.startswith("shared"):
        spec = _shared_angle_spec(qc, 3)
    else:
        spec = circuits.build_quclassi_circuit(qc, 1)
    groups = tuple(range(1 + 2 * spec.n_theta))
    if subset:
        groups = groups[1::2]
    walk = K._shift_route(spec, False, groups, K.SMEM_BUDGET_BYTES)
    assert walk.route == "dmem" and walk.m == m
    th, dt = _angles(spec, 33, cuda, seed=qc)
    before = dict(K.LAUNCHES)
    got = K.vqc_shift_fidelity(spec, th, dt, groups=groups)
    assert K.LAUNCHES["shift_dmem"] == before["shift_dmem"] + 1
    assert sum(K.LAUNCHES.values()) == sum(before.values()) + 1
    want = K._shift_dmem_plain(walk, th, dt)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    # each row also within 1e-4 of its own size: these rows are products of
    # 13-16 factors in [0, 1], most far below ATOL
    torch.testing.assert_close(got, want, rtol=ROW_RTOL, atol=ROW_ATOL)


@pytest.mark.parametrize("qc,nl", [(21, 3), (25, 1), (13, 3)])
def test_shift_dmem_forced_matches_shared_memory_routes(cuda, qc, nl):
    """m <= 12 plans forced onto the device-memory walk by a budget that
    holds no block of the shared-memory routes, against the route they take
    at 227 KB (the spill pair at 21q-3l and 25q-1l, the single sweep at
    13q-3l): the same gates on the same bits, the inner products summed in
    another order, so within 1e-6."""
    spec = circuits.build_quclassi_circuit(qc, nl)
    th, dt = _angles(spec, 100, cuda, seed=qc + nl)
    assert K._shift_route(spec, False, tuple(range(1 + 2 * spec.n_theta)), 64).route == "dmem"
    before = K.LAUNCHES["shift_dmem"]
    got = K.vqc_shift_fidelity(spec, th, dt, smem_budget=64)
    assert K.LAUNCHES["shift_dmem"] == before + 1
    want = K.vqc_shift_fidelity(spec, th, dt)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    torch.testing.assert_close(got, want, rtol=ROW_RTOL, atol=ROW_ATOL)


@pytest.mark.parametrize("qc", [27, 29, 31])
@pytest.mark.parametrize("groups", [(0,), (5,), (0, 2, 3, 30)],
                         ids=["f0", "one-variant", "shifts-without-pair"])
def test_shift_dmem_kernel_small_group_sets(cuda, qc, groups):
    """The kernel against its plain version on group subsets that leave its
    staging plan (m = 13), resident chi (m = 14) and streamed passes (m =
    15) little to pair: f0 alone, one variant alone, and f0 with three
    lone shifts of three parameters."""
    spec = circuits.build_quclassi_circuit(qc, 1)
    walk = K._shift_route(spec, False, groups, 64)  # f0 alone fits the single sweep at 227 KB
    assert walk.route == "dmem" and walk.m == qc // 2
    th, dt = _angles(spec, 33, cuda, seed=qc + len(groups))
    before = K.LAUNCHES["shift_dmem"]
    got = K.vqc_shift_fidelity(spec, th, dt, groups=groups, smem_budget=64)
    assert K.LAUNCHES["shift_dmem"] == before + 1
    want = K._shift_dmem_plain(walk, th, dt)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)
    torch.testing.assert_close(got, want, rtol=ROW_RTOL, atol=ROW_ATOL)


@pytest.mark.parametrize("qc", [27, 31])
def test_shift_dmem_tables_in_device_memory_same_bits(cuda, qc, monkeypatch):
    """Where the program's tables leave no room in shared memory the kernel
    reads them from device memory, with the bits it gives with them copied
    in: m = 13 (passes, staging plan, ops) and m = 15 (no staging plan)."""
    spec = circuits.build_quclassi_circuit(qc, 1)
    walk = K._shift_route(spec, False, tuple(range(1 + 2 * spec.n_theta)), K.SMEM_BUDGET_BYTES)
    th, dt = _angles(spec, 33, cuda, seed=qc)
    staged = K.vqc_shift_fidelity(spec, th, dt)
    smem, in_smem = K._shift_dmem_smem(walk)
    assert in_smem
    monkeypatch.setattr(K, "SMEM_BUDGET_BYTES", smem - 1)
    assert not K._shift_dmem_smem(walk)[1]
    assert torch.equal(K.vqc_shift_fidelity(spec, th, dt), staged)


def test_shift_dmem_launches_split_by_samples(cuda, monkeypatch):
    """A workspace of three samples' scratch: 8 samples of 27q-1l run in 3
    launches and give the bits of one launch."""
    spec = circuits.build_quclassi_circuit(27, 1)
    th, dt = _angles(spec, 8, cuda, seed=8)
    whole = K.vqc_shift_fidelity(spec, th, dt)
    walk = K._shift_route(spec, False, tuple(range(1 + 2 * spec.n_theta)), K.SMEM_BUDGET_BYTES)
    monkeypatch.setattr(K, "SHIFT_DMEM_WORKSPACE_BYTES", 3 * K.shift_dmem_geometry(walk, 1)[2])
    before = K.LAUNCHES["shift_dmem"]
    split = K.vqc_shift_fidelity(spec, th, dt)
    assert K.LAUNCHES["shift_dmem"] == before + 3
    assert torch.equal(split, whole)


@pytest.mark.parametrize("qc,c", [(15, 8), (17, 3)])
def test_device_memory_bits_do_not_depend_on_the_cluster(cuda, qc, c, monkeypatch):
    """P(0) and the state are the same bits with one block a circuit as
    with a cluster of several (the chunks' partial sums are added in chunk
    order by the circuit's first block)."""
    spec = circuits.build_quclassi_circuit(qc, 1)
    th, dt = _angles(spec, c, cuda, seed=qc + c)
    p0, (re, im) = K.vqc_p0(spec, th, dt), K.vqc_state(spec, th, dt)
    monkeypatch.setattr(K, "DMEM_MAX_CLUSTER", 1)
    assert K.dmem_geometry(spec, c, 132)[0] == 1
    assert torch.equal(K.vqc_p0(spec, th, dt), p0)
    re1, im1 = K.vqc_state(spec, th, dt)
    assert torch.equal(re1, re) and torch.equal(im1, im)


def test_async_runtime_matches_sync_on_card(cuda):
    """The Fig-6 client mix through the sync and the async runtime (one
    CUDA stream per slot): bit-identical, and equal to direct launches."""
    from repro_torch.serve import GatewayRuntime

    banks = []
    for qc, nl in ((5, 1), (5, 2), (7, 1), (7, 2)):
        spec = circuits.build_quclassi_circuit(qc, nl)
        banks.append((spec, *_angles(spec, 300, cuda, seed=qc * nl)))
    got = {}
    for mode in ("sync", "async"):
        rt = GatewayRuntime(target=128, deadline=0.05, mode=mode, slots_per_worker=2)
        try:
            got[mode] = [rt.executor(spec, f"c{i}")(th, dt)
                         for i, (spec, th, dt) in enumerate(banks)]
            assert not getattr(rt.dispatcher, "errors", [])
        finally:
            rt.close()
    for (spec, th, dt), fs, fa in zip(banks, got["sync"], got["async"]):
        assert fa.is_cuda and torch.equal(fs, fa)
        assert torch.equal(fs, ops.vqc_fidelity(spec, th, dt))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_crash_migration_replays_bit_for_bit_on_card(cuda, mode):
    """w1 crashed from the start, no retry, one failure trips it: every
    batch placed on it migrates to w2 through the coalescer (re-coalesced,
    and in async on another slot's stream), and rows and an implicit bank's
    groups come back as a fault-free launch gives them, bit for bit."""
    from repro_torch.comanager.faults import FaultSpec, FaultToleranceConfig
    from repro_torch.comanager.worker import WorkerConfig
    from repro_torch.core import shift_rule
    from repro_torch.serve import GatewayRuntime
    from repro_torch.serve.fleet import FaultInjector

    rt = GatewayRuntime(
        workers=[WorkerConfig("w1", 10), WorkerConfig("w2", 10)], target=8, lanes=8,
        deadline=0.05, mode=mode,
        fault_tolerance=FaultToleranceConfig(retry_limit=0, breaker_threshold=1,
                                             breaker_cooldown_s=3600.0),
        fault_injector=FaultInjector({"w1": FaultSpec(kind="crash", at=0.0)}))
    s5, s7 = circuits.build_quclassi_circuit(5, 1), circuits.build_quclassi_circuit(7, 1)
    t5, d5 = _angles(s5, 40, cuda, seed=1)
    t7, d7 = _angles(s7, 40, cuda, seed=2)
    bank = shift_rule.build_shift_bank(t7[0], d7[:16])
    try:
        rows5 = rt.executor(s5, "alice")(t5, d5)
        rows7 = rt.executor(s7, "bob")(t7, d7)
        groups = rt.shift_executor(s7, "carol")(bank)
        summary = rt.telemetry.summary()
        state = rt.dispatcher.fleet.state("w1")
    finally:
        rt.close()
    assert state == "offline" and summary["migrated_batches"] >= 1
    assert rows5.is_cuda and torch.equal(rows5, ops.vqc_fidelity(s5, t5, d5))
    assert torch.equal(rows7, ops.vqc_fidelity(s7, t7, d7))
    assert torch.equal(groups, ops.vqc_fidelity_shiftbank(s7, bank.theta, bank.data))


@pytest.mark.parametrize("n_banks", [1, 3])
def test_shift_group_bits_do_not_depend_on_batch_composition_on_card(cuda, n_banks):
    """``test_torch_serve``'s pinned composition on the card: a sync
    runtime whose target is ``n_banks`` members, fed one group of every
    bank at a time, so each batch is group g of each bank alone and runs
    ``shiftbank_kernel`` with that subset's own walk table (single-bank
    launches for one bank, multibank for three).  Each group comes back as
    the whole bank's launch gives it, bit for bit."""
    import itertools

    from repro_torch.comanager.worker import WorkerConfig
    from repro_torch.core import shift_rule
    from repro_torch.serve import GatewayRuntime, ShiftGroupKey

    spec = circuits.build_quclassi_circuit(5, 1)
    ticks = itertools.count(1)
    rt = GatewayRuntime(workers=[WorkerConfig("w1", 10)], target=n_banks, lanes=1,
                        deadline=1e9, mode="sync", clock=lambda: next(ticks) * 1e-3)
    key = ShiftGroupKey(spec, False)
    banks = []
    for k in range(n_banks):
        th, dt = _angles(spec, 5, cuda, seed=40 + k)
        banks.append(shift_rule.build_shift_bank(th[0], dt))
    n_groups = banks[0].n_groups
    futs = [[] for _ in banks]
    before = K.LAUNCHES["shiftbank"]
    try:
        for g in range(n_groups):
            for k, bank in enumerate(banks):
                futs[k].append(rt.gateway.submit(f"c{k}", key, (bank, g),
                                                 rt.dispatcher.clock(), lanes=bank.n_samples))
            rt.dispatcher.pump()
        rt.dispatcher.drain()
        log = rt.dispatcher.batch_log
    finally:
        rt.close()
    assert [n for _, n, _ in log] == [n_banks] * n_groups
    assert K.LAUNCHES["shiftbank"] == before + n_groups
    for bank, fs in zip(banks, futs):
        got = torch.stack([f.result(timeout=1.0) for f in fs])
        whole = ops.vqc_fidelity_shiftbank(spec, bank.theta, bank.data).reshape(n_groups, -1)
        assert got.is_cuda and torch.equal(got, whole)


def test_hedge_first_result_wins_on_card(cuda):
    """A stalled slot past hedge_k x its estimate gets a duplicate on the
    other worker's slot stream; the duplicate's launch resolves the futures
    while the straggler is held, and the straggler's launch, run once it is
    let go, is dropped without touching them."""
    import threading

    from repro_torch.comanager.faults import FaultToleranceConfig
    from repro_torch.comanager.worker import WorkerConfig
    from repro_torch.serve import GatewayRuntime

    gate, calls = threading.Event(), {"n": 0}

    def stall_first_kernel(spec, theta, data):
        calls["n"] += 1
        if calls["n"] == 1:
            assert gate.wait(timeout=30.0)
        return ops.vqc_fidelity(spec, theta, data)

    spec = circuits.build_quclassi_circuit(5, 1)
    th, dt = _angles(spec, 8, cuda, seed=3)
    rt = GatewayRuntime(
        workers=[WorkerConfig("w1", 10), WorkerConfig("w2", 10)], target=8, lanes=8,
        deadline=0.05, mode="async", kernel=stall_first_kernel,
        fault_tolerance=FaultToleranceConfig(hedge_k=0.05, breaker_threshold=10))
    futs = []
    try:
        futs = [rt.gateway.submit("alice", spec, (th[i], dt[i]), rt.dispatcher.clock())
                for i in range(8)]
        rt.dispatcher.kick()
        got = torch.stack([f.result(timeout=60.0) for f in futs])
        assert not gate.is_set()
        hedges = sum(ev["hedges"] for ev in rt.telemetry.summary()["fleet"].values())
    finally:
        gate.set()
        rt.close()
    assert all(f.done for f in futs) and calls["n"] == 2
    assert hedges >= 1
    assert got.is_cuda and torch.equal(got, ops.vqc_fidelity(spec, th, dt))


def test_worker_pool_streams_on_card(cuda):
    """One thread and one CUDA stream per worker: the same bits as the
    sequential per-worker executor, for rows and an implicit bank."""
    from repro_torch.comanager import dataplane
    from repro_torch.core import shift_rule

    spec = circuits.build_quclassi_circuit(7, 2)
    th, dt = _angles(spec, 999, cuda, seed=4)
    rows = dataplane.round_robin_assignment(999, 4)
    pool = dataplane.worker_pool_executor(spec, rows, 4)
    try:
        assert torch.equal(pool(th, dt), dataplane.worker_batched_executor(spec, rows, 4)(th, dt))
    finally:
        pool.close()
    bank = shift_rule.build_shift_bank(th[0], dt[:300])
    groups = dataplane.round_robin_assignment(bank.n_groups, 4)
    pool = dataplane.worker_pool_executor(spec, groups, 4)
    try:
        assert torch.equal(pool(bank), dataplane.worker_batched_executor(spec, groups, 4)(bank))
    finally:
        pool.close()


def test_one_device_mesh_on_card(cuda):
    from repro_torch.comanager import dataplane
    from repro_torch.core import shift_rule
    from repro_torch.launch.mesh import make_data_mesh, make_host_mesh

    mesh = make_data_mesh(1)
    assert mesh.devices == (torch.device("cuda", 0),) and make_host_mesh() == mesh
    spec = circuits.build_quclassi_circuit(5, 1)
    th, dt = _angles(spec, 70, cuda)
    ex = dataplane.sharded_executor(spec, mesh)
    assert torch.equal(ex(th, dt), ops.vqc_fidelity(spec, th, dt))
    bank = shift_rule.build_shift_bank(th[0], dt[:9])
    mat = bank.materialize()
    torch.testing.assert_close(ex(bank), ops.vqc_fidelity(spec, mat.theta, mat.data),
                               rtol=0, atol=ATOL)


def test_training_step_on_card(cuda):
    cfg = quclassi.QuClassiConfig(qc=5, n_layers=1)
    x, y = mnist.make_pair_dataset(1, 5, n_per_class=8, seed=0)
    tr, te = mnist.train_test_split(x, y)
    before = K.LAUNCHES["shiftbank"]
    rep = trainer.train(cfg, tr, te, epochs=1, batch_size=4,
                        executor=ops.shiftbank_executor(cfg.spec), device=cuda)
    assert np.isfinite(rep.epochs[0].loss)
    assert K.LAUNCHES["shiftbank"] > before
    assert all(v.is_cuda for v in rep.params.values())


def test_spans_on_card_tie_kernels_to_the_dense_backward(cuda, tmp_path):
    """A 7q-3l gradient through the data plane on the card: the same bits
    with and without a recorder, and under the profiler the program's
    ``rt:`` ranges share the trace with the kernels, some launched (on
    autograd's device thread) inside ``grad_shift.dense.backward``."""
    import json

    from repro_torch import obs
    from repro_torch.comanager import dataplane

    cfg = quclassi.QuClassiConfig(qc=7, n_layers=3)
    params = quclassi.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    x, y = mnist.make_pair_dataset(1, 5, n_per_class=8, seed=0)
    x, y = torch.as_tensor(x, device=cuda), torch.as_tensor(y, device=cuda)
    run = dataplane.worker_batched_executor(
        cfg.spec, dataplane.round_robin_assignment(1 + 2 * cfg.n_theta, 4), 4)

    def grad():
        return quclassi.grad_shift(cfg, params, x, y, executor=run, implicit=True)

    want = grad()
    rec = obs.TraceRecorder()
    prev = obs.set_recorder(rec)
    try:
        got = grad()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            grad()
            torch.cuda.synchronize()
    finally:
        obs.set_recorder(prev)
    assert torch.equal(got[0], want[0])
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    ranges = {e["name"] for e in ev if e.get("name", "").startswith(obs.RANGE_PREFIX)}
    assert {"rt:grad_shift", "rt:dataplane.worker", "rt:grad_shift.dense.backward"} <= ranges
    (back,) = [e for e in ev if e.get("cat") == "user_annotation"
               and e.get("name") == "rt:grad_shift.dense.backward"]
    kernels = {e["args"]["correlation"] for e in ev if e.get("cat") == "kernel"}
    inside = [e for e in ev if e.get("cat") == "cuda_runtime"
              and e.get("args", {}).get("correlation") in kernels
              and back["ts"] <= e["ts"] < back["ts"] + back["dur"]]
    assert inside
    assert rec.summary()["spans"]["dataplane.worker"]["count"] == 2 * 2 * 4


def _dense_inputs(qc, nl, b, device, seed=0):
    """A QuClassi config's dense-gradient plan and random kernel inputs
    for ``b`` images: angles in [0, pi], pixels in [0, 1], weights N(0, 1)."""
    from repro_torch.kernels import dense_grad

    cfg = quclassi.QuClassiConfig(qc=qc, n_layers=nl)
    plan = dense_grad.route_plan(cfg.qc, cfg.n_layers, cfg.n_classes, cfg.patch_dim)
    g = torch.Generator().manual_seed(seed)
    n = b * cfg.n_patches
    theta = torch.rand((cfg.n_classes, cfg.n_theta), generator=g) * np.pi
    angles = torch.rand((n, cfg.n_angles), generator=g) * np.pi
    patches = torch.rand((n, cfg.patch_dim), generator=g)
    weights = torch.randn((b, cfg.n_classes), generator=g)
    return cfg, plan, [t.to(device) for t in (theta, angles, patches, weights)]


@pytest.mark.parametrize("qc,nl,b", [  # b = 1000: 9,000 patches, the last tile ragged
    (5, 1, 1), (5, 1, 64), (5, 1, 1000), (7, 3, 1), (7, 3, 64), (7, 3, 1000),
    (13, 2, 64), (13, 2, 1000), (25, 1, 1), (25, 1, 64)])
def test_dense_register_kernel_matches_plain(cuda, qc, nl, b):
    """``dense_grad_kernel`` and its reduction against the plain version,
    one launch of each kernel a call, and two calls bit-equal.  Tolerance: float32
    with other cos/sin and another summation order (block partials summed
    in block order against one matmul over every patch), so each element
    within 1e-4 of the largest element's size."""
    from repro_torch.kernels import dense_grad

    cfg, plan, (theta, angles, patches, weights) = _dense_inputs(qc, nl, b, cuda, seed=b)
    before = dict(K.LAUNCHES)
    parts = dense_grad.register_partials(plan, theta, angles, patches, weights, cfg.n_patches)
    gw, gb = dense_grad.reduce_partials(parts, cfg.patch_dim, cfg.n_angles)
    assert K.LAUNCHES["dense_grad"] == before["dense_grad"] + 1
    assert K.LAUNCHES["dense_reduce"] == before["dense_reduce"] + 1
    assert sum(K.LAUNCHES.values()) == sum(before.values()) + 2
    want = dense_grad.reduce_partials(
        dense_grad.register_partials(plan, *(t.cpu() for t in (theta, angles, patches, weights)),
                                     cfg.n_patches), cfg.patch_dim, cfg.n_angles)
    for got, ref in zip((gw, gb), want):
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
    again = dense_grad.reduce_partials(
        dense_grad.register_partials(plan, theta, angles, patches, weights, cfg.n_patches),
        cfg.patch_dim, cfg.n_angles)
    assert torch.equal(again[0], gw) and torch.equal(again[1], gb)


def test_dense_gradient_on_card_is_deterministic_and_routed(cuda, monkeypatch):
    """A 7q-3l ``grad_shift`` on the card: the dense layer on the register
    route (one ``dense_grad`` launch a call, bit-equal across calls) and,
    with the route refused, on the dense simulator (no ``dense_grad``
    launch), the two within the chain-scaled tolerance; m = 13 takes the
    wide route and m >= 17 the simulator."""
    from repro_torch.comanager import dataplane
    from repro_torch.core import fidelity
    from repro_torch.kernels import dense_grad

    cfg = quclassi.QuClassiConfig(qc=7, n_layers=3)
    params = quclassi.init_params(cfg, torch.Generator().manual_seed(0), cuda)
    x, y = mnist.make_pair_dataset(1, 5, n_per_class=8, seed=0)
    x, y = torch.as_tensor(x, device=cuda), torch.as_tensor(y, device=cuda)
    run = dataplane.worker_batched_executor(
        cfg.spec, dataplane.round_robin_assignment(1 + 2 * cfg.n_theta, 4), 4)

    def grad():
        return quclassi.grad_shift(cfg, params, x, y, executor=run, implicit=True)

    before = K.LAUNCHES["dense_grad"]
    first, second = grad(), grad()
    assert K.LAUNCHES["dense_grad"] == before + 2
    for k in first[1]:
        assert torch.equal(first[1][k], second[1][k]), k
    monkeypatch.setattr(dense_grad, "route_plan", lambda *a: None)
    sim = grad()
    assert K.LAUNCHES["dense_grad"] == before + 2
    f = torch.clamp(first[2], fidelity._EPS, 1 - fidelity._EPS)
    onehot = torch.nn.functional.one_hot(y.long(), 2).to(f.dtype)
    c = float(((f - onehot) / (f * (1 - f))).abs().max())
    for k in ("w", "b"):
        torch.testing.assert_close(first[1][k], sim[1][k], rtol=0, atol=ATOL * (c + c**2))
    monkeypatch.undo()
    wide = quclassi.QuClassiConfig(qc=27, n_layers=3)
    assert dense_grad.route_plan(wide.qc, wide.n_layers, 2, wide.patch_dim).wide
    wider = quclassi.QuClassiConfig(qc=35, n_layers=1)
    assert dense_grad.route_plan(wider.qc, wider.n_layers, 2, wider.patch_dim) is None


def _wide_pair(plan, cfg, args):
    from repro_torch.kernels import dense_grad

    parts = dense_grad.register_partials(plan, *args, cfg.n_patches)
    return dense_grad.reduce_partials(parts, cfg.patch_dim, cfg.n_angles)


@pytest.mark.parametrize("qc,nl", [(27, 3), (29, 2), (33, 1)])
def test_dense_wide_kernel_matches_plain(cuda, qc, nl):
    """The wide route at m = 13, 14 and 16 on the cell's 576 patches (64
    images): ``dense_wide_psi_kernel``, ``dense_wide_kernel`` and the
    reduction against the plain version (run on the card: phi of 2**16
    amplitudes a patch is 0.3 GB at 576 patches), one launch of each a
    call, two calls bit-equal.  Tolerance as the register kernel's: each
    element within 1e-4 of the largest element's size."""
    from repro_torch.kernels import dense_grad

    cfg, plan, args = _dense_inputs(qc, nl, 64, cuda, seed=qc)
    assert plan.wide and plan.m == (qc - 1) // 2
    before = dict(K.LAUNCHES)
    gw, gb = _wide_pair(plan, cfg, args)
    assert K.LAUNCHES["dense_wide_psi"] == before["dense_wide_psi"] + 1
    assert K.LAUNCHES["dense_wide"] == before["dense_wide"] + 1
    assert K.LAUNCHES["dense_reduce"] == before["dense_reduce"] + 1
    assert sum(K.LAUNCHES.values()) == sum(before.values()) + 3
    want = dense_grad.reduce_partials(dense_grad._partials_plain(plan, *args, cfg.n_patches),
                                      cfg.patch_dim, cfg.n_angles)
    for got, ref in zip((gw, gb), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
    again = _wide_pair(plan, cfg, args)
    assert torch.equal(again[0], gw) and torch.equal(again[1], gb)


@pytest.mark.parametrize("qc,nl,b", [(5, 1, 64), (7, 3, 64), (7, 3, 1000), (25, 1, 8)])
def test_dense_wide_kernel_forced_matches_the_register_kernel(cuda, qc, nl, b):
    """The wide route forced onto registers the register route takes (m =
    2, 3 and 12: every thread of a block its own amplitude, or a sweep of
    16): the same w and b as ``dense_grad_kernel``, within 1e-4 of the
    largest element (another summation order)."""
    cfg, plan, args = _dense_inputs(qc, nl, b, cuda, seed=b)
    assert not plan.wide
    got = _wide_pair(dataclasses.replace(plan, wide=True), cfg, args)
    want = _wide_pair(plan, cfg, args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4 * float(w.abs().max()))


#: flash attention: float32 (summation order) and bfloat16 (one rounding of
#: the output), the reference's own tolerances
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(bh, s, hd, dtype, device, groups=1, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((n, s, hd), generator=g) * 0.5 for n in (bh, bh // groups, bh // groups))
    return tuple(t.to(device=device, dtype=dtype) for t in (q, k, v))


@pytest.mark.parametrize("hd", F.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0), (False, 48)])
@pytest.mark.parametrize("s", [128, 100])  # 100: the last tile is part full
def test_flash_kernel_matches_plain(cuda, hd, dtype, causal, window, s):
    q, k, v = _qkv(6, s, hd, dtype, cuda, groups=3, seed=hd + s)
    before = dict(F.LAUNCHES)
    got = F.flash_attention(q, k, v, causal=causal, window=window, groups=3)
    _assert_one_launch(before, dtype)
    assert got.dtype == dtype
    want = F._flash_plain(q, k, v, causal=causal, window=window, groups=3)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=FLASH_ATOL[dtype])


def _assert_one_launch(before, dtype):
    """One launch, on the dtype's route (bf16: wgmma, float32: SIMT)."""
    route = F.ROUTES[dtype]
    assert F.LAUNCHES["flash"] == before["flash"] + 1
    assert F.LAUNCHES[route] == before[route] + 1
    assert all(F.LAUNCHES[r] == before[r] for r in F.ROUTES.values() if r != route)


@pytest.mark.parametrize("bh,s,hd,groups,causal,window", [
    (6, 2048, 64, 3, True, 0),      # the ring of K/V stages wraps many times
    (4, 2048, 128, 4, True, 0),
    (3, 2048, 32, 1, False, 0),
    (6, 2048, 64, 3, True, 65),     # windows that cross tile edges
    (4, 2048, 128, 4, True, 48),
    (6, 1, 64, 3, True, 0),         # one row: a box of 128 rows, 127 zero-filled
    (4, 1, 128, 4, False, 0),
    (6, 192, 64, 3, True, 0),       # 1.5 query tiles, 1.5 kv tiles of 128
    (8, 192, 128, 4, True, 48),
    (3, 192, 16, 1, True, 65),
    (6, 100, 64, 3, True, 65),      # ragged tile inside each of 6 heads
    (4, 100, 128, 4, False, 48),
    (2, 100, 32, 1, True, 48),
    (24, 2048, 192, 12, True, 0),   # nemotron's hd 192, g 12: two consumer warpgroups
    (4, 300, 192, 2, True, 65),
    (4, 1, 192, 1, False, 0),
    (32, 2048, 96, 1, True, 0),     # phi-3-vision's hd 96 (three 32-column boxes), MHA
    (8, 2048, 96, 4, True, 65),
    (6, 100, 96, 3, False, 48),
    (6, 192, 96, 3, True, 0),
    (4, 1, 96, 1, True, 0),
])
def test_flash_wgmma_pipeline_edges(cuda, bh, s, hd, groups, causal, window):
    q, k, v = _qkv(bh, s, hd, torch.bfloat16, cuda, groups=groups, seed=s + hd + window)
    before = dict(F.LAUNCHES)
    got = F.flash_attention(q, k, v, causal=causal, window=window, groups=groups)
    _assert_one_launch(before, torch.bfloat16)
    want = F._flash_plain(q, k, v, causal=causal, window=window, groups=groups)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=FLASH_ATOL[torch.bfloat16])


@pytest.mark.parametrize("bh,s,hd,groups,causal,window", [
    (6, 100, 192, 3, True, 48),      # hd 192: windows, ragged S
    (6, 1000, 192, 3, True, 130),
    (4, 333, 192, 1, False, 65),
    (3, 577, 192, 1, True, 0),
    (96, 257, 64, 48, True, 0),      # MQA: 48 query heads a kv head
    (48, 200, 128, 48, True, 64),
    (96, 130, 16, 48, False, 0),
    (9, 130, 96, 3, False, 0),       # groups 3
    (9, 1025, 32, 3, True, 1),       # a window of one key: the diagonal alone
    (6, 1, 32, 3, True, 0),
    (12, 2047, 64, 3, True, 0),
    (4, 65, 128, 1, True, 63),
    (4, 190, 96, 1, False, 100),
])
def test_flash_simt_tile_edges(cuda, bh, s, hd, groups, causal, window):
    """The float32 route at S that no 64-row tile divides, at hd 192 with
    windows, and with groups 1, 3 and 48, one launch each."""
    q, k, v = _qkv(bh, s, hd, torch.float32, cuda, groups=groups, seed=s + hd + window)
    before = dict(F.LAUNCHES)
    got = F.flash_attention(q, k, v, causal=causal, window=window, groups=groups)
    _assert_one_launch(before, torch.float32)
    want = F._flash_plain(q, k, v, causal=causal, window=window, groups=groups)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=FLASH_ATOL[torch.float32])


def test_flash_simt_copies_unaligned_views(cuda):
    """cp.async copies 16 bytes: a view one element into its storage is
    copied to an aligned tensor first and gives the aligned inputs' result."""
    q, k, v = _qkv(3, 70, 64, torch.float32, cuda, groups=3)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16
    before = dict(F.LAUNCHES)
    got = F.flash_attention(shifted, k, v, groups=3)
    _assert_one_launch(before, torch.float32)
    assert torch.equal(got, F.flash_attention(q, k, v, groups=3))


def test_flash_wgmma_rejects_unaligned_tensors(cuda):
    """TMA needs 16-byte aligned bases: a view one element into its
    storage raises before any launch."""
    q, k, v = _qkv(2, 64, 64, torch.bfloat16, cuda)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    shifted.copy_(q)
    before = dict(F.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        F.flash_attention(shifted, k, v)
    assert F.LAUNCHES == before


def test_flash_prefill_on_card_matches_naive(cuda):
    cfg = cfg_base.get("smollm-360m").reduced().with_(attention_impl="flash")
    model = transformer.Model(cfg, device=cuda)
    toks = multimodal.text_batch(cfg, 2, 96)
    before = dict(F.LAUNCHES)
    with torch.no_grad():
        flash, _ = model.prefill(toks)
        model.cfg = cfg.with_(attention_impl="naive")
        naive, _ = model.prefill(toks)
    assert F.LAUNCHES["flash"] == before["flash"] + cfg.n_layers
    assert F.LAUNCHES["flash_simt"] == before["flash_simt"] + cfg.n_layers
    torch.testing.assert_close(flash, naive, rtol=0, atol=1e-4)


def test_flash_prefill_on_card_matches_naive_bf16(cuda):
    """The reduced smollm-360m prefill in bf16, the dtype of the full model,
    through the wgmma kernel against the naive path.  The naive path rounds
    scores to bf16 and the flash path does not; on the CPU (plain version)
    the two differ by up to two bf16 steps of the logits after 2 layers.
    atol: four bf16 steps (8 significant bits) at the logits' largest
    magnitude."""
    cfg = cfg_base.get("smollm-360m").reduced().with_(attention_impl="flash", dtype="bfloat16")
    model = transformer.Model(cfg, device=cuda)
    toks = multimodal.text_batch(cfg, 2, 96)
    before = dict(F.LAUNCHES)
    with torch.no_grad():
        flash, _ = model.prefill(toks)
        model.cfg = cfg.with_(attention_impl="naive")
        naive, _ = model.prefill(toks)
    assert F.LAUNCHES["flash_wgmma"] == before["flash_wgmma"] + cfg.n_layers
    assert F.LAUNCHES["flash_simt"] == before["flash_simt"]
    assert flash.dtype == torch.bfloat16 and torch.isfinite(flash.float()).all()
    step = 2.0 ** (torch.floor(torch.log2(naive.float().abs().max())).item() - 7)
    torch.testing.assert_close(flash.float(), naive.float(), rtol=0, atol=4 * step)


# ------------------------------------------------ the public facade on card
def _facade():
    from repro_torch import api

    return api


def test_cluster_submit_drain_on_card(cuda):
    """Two tenants' sessions on one async cluster: every future resolves to
    a direct ``ops.vqc_fidelity`` of the same rows (chip_smoke phase 7a)."""
    api = _facade()
    spec = circuits.build_quclassi_circuit(7, 3)
    th, dt = _angles(spec, 24, cuda, seed=7)
    cfg = api.ClusterConfig(serving=api.ServingConfig(mode="async", slots_per_worker=2))
    with api.QuantumCluster(cfg, device="cuda") as cluster:
        alice = cluster.session("alice", api.TenantPolicy(priority=0, slo_ms=500.0, weight=2.0))
        bob = cluster.session("bob", api.TenantPolicy(priority=1))
        before = K.LAUNCHES["fidelity"]
        futs = []
        for i in range(0, 24, 2):
            futs.append(alice.submit(spec, th[i], dt[i]))
            futs.append(bob.submit(spec, th[i + 1], dt[i + 1]))
        alice.drain()
        got = torch.stack([f.result(timeout=60.0) for f in futs])
        assert K.LAUNCHES["fidelity"] > before
        assert alice.telemetry()["completed"] == bob.telemetry()["completed"] == 12
    torch.testing.assert_close(got, ops.vqc_fidelity(spec, th, dt), rtol=0, atol=ATOL)


def test_cluster_executors_on_card(cuda):
    """A materialized session's executor is the runtime's executor: equal
    bit for bit; the implicit session runs the shiftbank kernel and agrees
    within 1e-5 on fidelities (chip_smoke phase 7b)."""
    api = _facade()
    qcfg = quclassi.QuClassiConfig(qc=5, n_layers=1)
    params = quclassi.init_params(qcfg, torch.Generator().manual_seed(0), device=cuda)
    x, y = mnist.make_pair_dataset(3, 9, n_per_class=2, seed=0)
    x, y = torch.from_numpy(x).to(cuda), torch.from_numpy(y).to(cuda)
    with api.QuantumCluster(device="cuda") as cluster:
        mat = cluster.session("m", bank_mode="materialized")
        l_s, g_s, f_s = quclassi.grad_shift(qcfg, params, x, y, executor=mat.executor(qcfg.spec))
        l_r, g_r, _ = quclassi.grad_shift(qcfg, params, x, y,
                                          executor=cluster.runtime.executor(qcfg.spec, "legacy"))
        assert float(l_s) == float(l_r) and torch.equal(g_s["theta"], g_r["theta"])
        before = K.LAUNCHES["shiftbank"]
        imp = cluster.session("i", bank_mode="implicit")
        _, _, f_i = quclassi.grad_shift(qcfg, params, x, y, executor=imp.executor(qcfg.spec))
        assert K.LAUNCHES["shiftbank"] > before
    torch.testing.assert_close(f_i, f_s, rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["batched", "pooled", "multibank", "sharded", "mesh_spill"])
def test_cluster_backends_on_card(cuda, kind):
    """``cluster.backend(kind)``: the worker backends equal the direct
    implicit route bit for bit; the one-device CUDA mesh backends agree
    with the materialized rows within 1e-5 (chip_smoke phase 7d)."""
    from repro_torch.core import shift_rule

    api = _facade()
    spec = circuits.build_quclassi_circuit(7, 3)
    th, dt = _angles(spec, 16, cuda, seed=11)
    bank = shift_rule.build_shift_bank(th[0], dt)
    cluster = api.QuantumCluster(device="cuda")
    be = cluster.backend(kind, spec)
    try:
        got = be.run_bank(bank)
    finally:
        be.close()
    assert got.device.type == "cuda"
    if kind in ("batched", "pooled", "multibank"):
        direct = ops.vqc_fidelity_shiftgroups(spec, bank.theta, bank.data, False).reshape(-1)
        assert torch.equal(got, direct)
    else:
        rows = bank.materialize()
        torch.testing.assert_close(got, ops.vqc_fidelity(spec, rows.theta, rows.data),
                                   rtol=0, atol=ATOL)


# ------------------------------------------ MQA, MLA, MoE and checkpoints
def _cpu_and_card(cfg, cuda):
    """The same seeded parameters on the CPU and on the card."""
    cpu = transformer.Model(cfg, device="cpu", seed=3)
    card = transformer.Model(cfg, device=cuda, seed=3)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "deepseek-v3-671b", "granite-34b",
                                  "nemotron-4-340b"])
def test_new_archs_on_card_match_cpu(cuda, name):
    """Reduced prefill (MoE dispatch, MLA, MQA, squared ReLU) and cached
    decode on the card against the port on the CPU, float32; the MoE
    routing is the same on both."""
    from repro_torch.models import moe

    cfg = cfg_base.get(name).reduced()
    cpu, card = _cpu_and_card(cfg, cuda)
    toks = multimodal.text_batch(cfg, 4, 32, seed=1)   # T*K = 256: the Switch capacity
    with torch.no_grad():
        want, want_aux = cpu.prefill(toks)
        got, got_aux = card.prefill(toks)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    torch.testing.assert_close(got_aux.cpu(), want_aux, rtol=1e-5, atol=0)
    if cfg.moe:
        x = torch.randn((4, 32, cfg.d_model), generator=torch.Generator().manual_seed(0))
        s_cpu, s_card = {}, {}
        with torch.no_grad():
            moe.moe_ffn(cpu.blocks[0].ffn, x, cfg, stats=s_cpu)
            moe.moe_ffn(card.blocks[0].ffn, x.to(cuda), cfg, stats=s_card)
        assert torch.equal(s_card["expert_idx"].cpu(), s_cpu["expert_idx"])
        assert torch.equal(s_card["keep"].cpu(), s_cpu["keep"])
    caches_c, caches_g = cpu.init_caches(2, 8), card.init_caches(2, 8)
    with torch.no_grad():
        for t in range(8):
            tok = {"tokens": toks["tokens"][:2, t:t + 1]}
            lc, caches_c = cpu.decode_step(tok, caches_c, t)
            lg, caches_g = card.decode_step(tok, caches_g, t)
            torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_mixers_on_card_match_cpu(cuda, kind, dtype):
    """Each SSM / xLSTM mixer's prefill (two chunks and a ragged tail) and
    one decode step on the card against the same plain code on the CPU.
    float32: 1e-4 (another summation order in the card's products); bf16:
    the outputs within 2e-2 relative to max(1, |cpu|), the flash bf16
    tolerance."""
    from repro_torch.models import blocks

    name = "jamba-v0.1-52b" if kind == "mamba" else "xlstm-125m"
    cfg = cfg_base.get(name).reduced().with_(dtype=str(dtype)[6:])
    init, mixer, init_state = blocks._SSM[kind]
    gen = torch.Generator().manual_seed(5)
    params = init(gen, cfg, dtype)
    card = {k: v.to(cuda) for k, v in params.items()}
    x = (torch.randn((2, 71, cfg.d_model), generator=gen) * 0.5).to(dtype)
    st = {k: v for k, v in init_state(cfg, 2, dtype, "cpu").items()}
    with torch.no_grad():
        want, _ = mixer(params, x, cfg)
        got, _ = mixer(card, x.to(cuda), cfg)
        want1, want_st = mixer(params, x[:, :1], cfg, state=st)
        got1, got_st = mixer(card, x[:, :1].to(cuda), cfg,
                             state={k: v.to(cuda) for k, v in st.items()})
    for g, w in ((got, want), (got1, want1)):
        assert g.dtype == dtype and torch.isfinite(g.float()).all()
        if dtype == torch.float32:
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4)
        else:
            rel = (g.cpu().float() - w.float()).abs() / w.float().abs().clamp(min=1.0)
            assert float(rel.max()) <= 2e-2
    for key in want_st:
        assert got_st[key].dtype == want_st[key].dtype
        torch.testing.assert_close(got_st[key].cpu().float(), want_st[key].float(), rtol=0,
                                   atol=1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "xlstm-125m", "phi-3-vision-4.2b",
                                  "musicgen-large"])
def test_ssm_and_multimodal_archs_on_card_match_cpu(cuda, name):
    """Reduced prefill (through the flash kernel's float32 route where the
    model has attention) and cached decode on the card against the port on
    the CPU, float32, MoE dropless."""
    cfg = cfg_base.get(name).reduced().with_(attention_impl="flash")
    if cfg.moe:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, dropless=True))
    cpu, card = _cpu_and_card(cfg, cuda)
    batch = multimodal.batch_for(cfg, 2, 40, seed=1)
    before = dict(F.LAUNCHES)
    with torch.no_grad():
        want, _ = cpu.prefill(batch)
        got, _ = card.prefill(batch)
    n_attn = cfg.layer_kinds.count("attn")
    assert F.LAUNCHES["flash_simt"] == before["flash_simt"] + n_attn
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    key = "codes" if cfg.n_codebooks else "tokens"
    toks = multimodal.decode_batch_for(cfg, 2, seed=2)[key]
    caches_c, caches_g = cpu.init_caches(2, 4), card.init_caches(2, 4)
    with torch.no_grad():
        for t in range(4):
            lc, caches_c = cpu.decode_step({key: toks}, caches_c, t)
            lg, caches_g = card.decode_step({key: toks}, caches_g, t)
            torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_mqa_prefill_on_card_matches_naive(cuda, impl):
    """granite-34b's MQA (one kv head) through the chunked online softmax
    and the float32 flash route against the naive path on the card."""
    cfg = cfg_base.get("granite-34b").reduced().with_(attention_chunk=16)
    model = transformer.Model(cfg, device=cuda)
    toks = multimodal.text_batch(cfg, 2, 64)
    with torch.no_grad():
        naive, _ = model.prefill(toks)
        model.cfg = cfg.with_(attention_impl=impl)
        got, _ = model.prefill(toks)
    torch.testing.assert_close(got, naive, rtol=0, atol=1e-4)


def test_checkpoint_round_trip_of_card_tensors(cuda, tmp_path):
    """Tensors on the card, saved and restored into a template on the
    card, bit for bit; a model restored from its checkpoint prefills the
    same logits."""
    from repro_torch import checkpoint

    tree = {"a": torch.randn((5, 7), device=cuda), "b": [torch.arange(4, device=cuda)],
            "c": (torch.randn(3, device=cuda, dtype=torch.float64),)}
    checkpoint.save(str(tmp_path / "t.npz"), tree, {"n": 1})
    like = {"a": torch.zeros((5, 7), device=cuda), "b": [torch.zeros(4, dtype=torch.int64,
                                                                      device=cuda)],
            "c": (torch.zeros(3, device=cuda, dtype=torch.float64),)}
    got, meta = checkpoint.load(str(tmp_path / "t.npz"), like=like)
    assert meta == {"n": 1}
    assert got["a"].is_cuda and torch.equal(got["a"], tree["a"])
    assert torch.equal(got["b"][0], tree["b"][0]) and torch.equal(got["c"][0], tree["c"][0])

    cfg = cfg_base.get("deepseek-v3-671b").reduced()
    model = transformer.Model(cfg, device=cuda, seed=4)
    checkpoint.save(str(tmp_path / "m.npz"), transformer.params_to_numpy(cfg, model))
    fresh = transformer.Model(cfg, device=cuda, seed=5)
    restored, _ = checkpoint.load(str(tmp_path / "m.npz"),
                                  like=transformer.params_to_numpy(cfg, fresh))
    fresh.load_state_dict(transformer.params_from_numpy(cfg, restored, cuda))
    toks = multimodal.text_batch(cfg, 2, 16)
    with torch.no_grad():
        assert torch.equal(fresh.prefill(toks)[0], model.prefill(toks)[0])


# ------------------------------------------------------------- LM training
TRAIN_ARCHS = ["nemotron-4-340b", "phi-3-vision-4.2b", "granite-34b", "smollm-360m",
               "qwen3-4b", "granite-moe-3b-a800m", "musicgen-large", "xlstm-125m",
               "jamba-v0.1-52b", "deepseek-v3-671b"]


def _train_once(cfg, model, batch):
    from repro_torch.launch import steps

    train_step, optimizer, _ = steps.make_train_step(cfg, global_batch=4, model=model)
    stats = {}
    _, loss = train_step(optimizer.init(dict(model.named_parameters())), batch, stats)
    return loss, stats["grads"]


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_train_step_on_card_matches_cpu(cuda, name):
    """One float32 train step (global batch 4: two interleaved microbatches)
    on the card against the same step of the port on the CPU: the loss
    within 1e-5 relative, the new parameters within 1e-5 (AdamW: where the
    CPU's gradient exceeds 1e-3 of its leaf's largest, ROADMAP Queue 3
    R7).  The MoE sort and scatter, the SSM scans, MLA and MTP run their
    backward on CUDA."""
    cfg = cfg_base.get(name).reduced()
    cpu, card = _cpu_and_card(cfg, cuda)
    batch = multimodal.batch_for(cfg, 4, 16, seed=1)
    want, grads = _train_once(cfg, cpu, batch)
    got, _ = _train_once(cfg, card, batch)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)
    adam = cfg.optimizer in ("adam", "adamw")
    card_params = dict(card.named_parameters())
    for n, p in cpu.named_parameters():
        g = grads[n].abs()
        mask = g > 1e-3 * g.max() if adam else torch.ones_like(g, dtype=torch.bool)
        err = (card_params[n].detach().cpu() - p.detach()).abs()[mask]
        assert err.numel() == 0 or float(err.max()) <= 1e-5, (name, n)


def test_train_launcher_on_card(cuda, capsys):
    from repro_torch.launch import train

    loss = train.run_reduced("smollm-360m", 3, 2, 16, device="cuda")
    assert np.isfinite(loss)
    assert "on cuda" in capsys.readouterr().out


def test_flash_loss_raises_on_card(cuda):
    """The flash kernel has no backward: a loss through it with grad enabled
    raises before any launch; without grad the prefill launches it."""
    cfg = cfg_base.get("smollm-360m").reduced().with_(attention_impl="flash")
    model = transformer.Model(cfg, device=cuda)
    batch = multimodal.text_batch(cfg, 2, 16)
    before = dict(F.LAUNCHES)
    with pytest.raises(RuntimeError, match="has no backward"):
        model.loss(batch)
    assert F.LAUNCHES == before
    model.prefill(batch)
    assert F.LAUNCHES["flash_simt"] == before["flash_simt"] + cfg.n_layers


def test_quantum_dryrun_executes_on_card(cuda, tmp_path):
    """The bank dry-run's execution on the card: ``fidelity_kernel`` within
    1e-5 of the per-gate plain path, one launch at least, nothing else."""
    from repro_torch.launch import quantum_dryrun
    before = dict(K.LAUNCHES)
    rec = quantum_dryrun.run(7, 3, 4096, verbose=False, device=cuda, out_dir=str(tmp_path))
    assert rec["executed"]["max_abs_diff"] <= quantum_dryrun.TOL
    assert K.LAUNCHES["fidelity"] > before["fidelity"]
    assert rec["_results"]["fused"].device.type == "cuda"


@pytest.mark.parametrize("n_shards", [1, 3])
def test_bank_shardings_on_card_bit_equal(cuda, n_shards):
    from repro_torch.comanager import dataplane
    from repro_torch.launch.mesh import DeviceMesh
    spec = circuits.build_quclassi_circuit(7, 3)
    th, dt = _angles(spec, 1000, cuda, seed=n_shards)
    mesh = DeviceMesh((cuda,) * n_shards)
    t_sh, d_sh = dataplane.bank_shardings(mesh)
    got = dataplane.sharded_executor(spec, mesh)(t_sh.place(th), d_sh.place(dt))
    want = dataplane.worker_batched_executor(
        spec, dataplane.round_robin_assignment(1000, 4), 4)(th, dt)
    assert torch.equal(got, want)


def test_meta_model_allocates_nothing_on_card(cuda):
    """The dry-run's shape-only model draws and allocates nothing."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model = transformer.Model(cfg_base.get("smollm-360m"), device="meta")
    assert transformer.param_count(model) == 409_007_040
    assert torch.cuda.memory_allocated() == before


def test_quickstart_example_on_card_matches_cpu(cuda, capsys):
    """``python -m repro_torch.examples.quickstart`` on the card: the same
    seeded angles through the fidelity kernel as through its plain version
    on the CPU."""
    from repro_torch.examples import quickstart
    before = K.LAUNCHES["fidelity"]
    card = quickstart.main(["--device", "cuda"])
    assert K.LAUNCHES["fidelity"] > before
    cpu = quickstart.main(["--device", "cpu"])
    assert card["fidelities"].device.type == "cuda"
    torch.testing.assert_close(card["fidelities"].cpu(), cpu["fidelities"], rtol=0, atol=ATOL)
    assert abs(card["loss_shift"] - cpu["loss_shift"]) <= ATOL
    assert card["grad_gap"] <= 1e-4
    assert capsys.readouterr().out.count("quickstart OK") == 2
