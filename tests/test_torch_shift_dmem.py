"""The shift walk's device-memory route (registers of 13 qubits and more,
27-33-qubit QuClassi) on the CPU: its plain version against the reference,
its route and geometry, and the port's own bit identities.

Inputs are seeded numpy arrays handed to both packages.  The reference runs
these plans through its spill pair (Pallas in interpret mode, 26 and 28
depth tiles at B = 2); the port's plain version runs the route's program of
passes, chunk by chunk.  Rows agree to 1e-5, the reference's float32 kernel
tolerance, and to 1e-4 of their own size: at these widths a row is a
product of 13-16 factors in [0, 1] (27q-1l's rows here reach 7e-7, their
median 3e-8), so the absolute limit alone passes a walk that is wrong on
every row (``test_planted_fault_fails_the_row_check``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import circuits as jcircuits
from repro.kernels import vqc_statevector as JK
from repro_torch import api as tapi
from repro_torch.comanager.faults import FaultSpec, FaultToleranceConfig
from repro_torch.comanager.worker import WorkerConfig
from repro_torch.core import circuits as tcircuits
from repro_torch.core import shift_rule as tsr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import vqc_statevector as K
from repro_torch.serve import GatewayRuntime
from repro_torch.serve import dispatcher as tdisp
from repro_torch.serve.fleet import FaultInjector

ATOL = 1e-5
#: each row also within ROW_RTOL of its own size, ROW_ATOL where it is ~0
ROW_RTOL, ROW_ATOL = 1e-4, 1e-10


def _angles(spec, batch, seed):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, np.pi, (batch, spec.n_theta)).astype(np.float32)
    data = rng.uniform(0.0, np.pi, (batch, spec.n_data)).astype(np.float32)
    return theta, data


def _all(spec, four=False):
    return tuple(range(1 + (4 if four else 2) * spec.n_theta))


def _assert_rows(got, want, atol=ATOL):
    """Rows within ``atol`` and within ROW_RTOL of their own size."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, equal_nan=False)
    np.testing.assert_allclose(got, want, rtol=ROW_RTOL, atol=ROW_ATOL, equal_nan=False)


@pytest.mark.parametrize("qc", [27, 29])
def test_rows_match_reference(qc):
    """27q-1l (m = 13, one chunk a pass) and 29q-1l (m = 14, two chunks)."""
    js, ts = jcircuits.build_quclassi_circuit(qc, 1), tcircuits.build_quclassi_circuit(qc, 1)
    theta, data = _angles(ts, 2, seed=qc)
    info = K.shift_execution_info(ts, 2)
    assert (info["mode"], info["route"]) == ("spill", "dmem")
    jinfo = JK.shift_execution_info(js, 2)
    assert jinfo["mode"] == "spill" and jinfo["n_tiles"] == qc - 1  # P tiles of one op
    got = K.vqc_shift_fidelity(ts, torch.from_numpy(theta), torch.from_numpy(data))
    want = JK.vqc_shift_fidelity(js, jnp.asarray(theta), jnp.asarray(data))
    assert got.shape == (len(_all(ts)), 2)
    _assert_rows(got.numpy(), want)


def _planted(walk, fault, theta, data, rows):
    """27q-1l rows with one fault planted: a variant's shift dropped, the
    data run's last gate left out of its pass, every row 3% low, or every
    row past the first three written as 0."""
    if fault == "dropped_shift":
        shifts = walk.var_shift.copy()
        shifts[0] = 0.0
        return K._shift_dmem_plain(dataclasses.replace(walk, var_shift=shifts), theta, data)
    if fault == "dropped_gate":
        passes = walk.passes.copy()
        passes[0, 4] -= 1
        return K._shift_dmem_plain(dataclasses.replace(walk, passes=passes), theta, data)
    if fault == "scaled":
        return rows * 0.97
    out = rows.clone()
    out[3:] = 0.0
    return out


@pytest.mark.parametrize("fault", ["dropped_shift", "dropped_gate", "scaled", "zeroed"])
def test_planted_fault_fails_the_row_check(fault):
    """Each planted fault stays within the absolute 1e-5 of every row, and
    the check relative to each row's size fails it."""
    spec = tcircuits.build_quclassi_circuit(27, 1)
    theta, data = (torch.from_numpy(a) for a in _angles(spec, 2, seed=27))
    walk = K._shift_route(spec, False, _all(spec), K.SMEM_BUDGET_BYTES)
    rows = K._shift_dmem_plain(walk, theta, data)
    bad = _planted(walk, fault, theta, data, rows)
    assert 0.0 < float((bad - rows).abs().max()) < ATOL
    with pytest.raises(AssertionError):
        _assert_rows(bad.numpy(), rows.numpy())


# (qc, layers, register qubits, chunks a pass)
WIDE = [(27, 1, 13, 1), (27, 3, 13, 1), (29, 1, 14, 2), (31, 1, 15, 4), (33, 1, 16, 8),
        (33, 3, 16, 8)]


@pytest.mark.parametrize("qc,nl,m,chunks", WIDE)
def test_route_and_geometry(qc, nl, m, chunks):
    """m = 13-16 take the device-memory walk at 227 KB: one block a sample,
    its shared memory three 64 KB chunks, two mbarriers and the tables
    (at m = 13 each pass op's cos / sin, and the program's tables with the
    staging plan; from m = 14 the deposit tables, the angle table, a pass's
    cos / sin and the program's tables with the angle references),
    every pass of k = 13 local qubits holding the three lowest-order ones;
    its scratch the checkpoints alone at m = 13 (chi and the variant slot
    never leave shared memory), the variant slot too at m = 14 (chi
    resident), every slot from m = 15; samples a launch as the workspace
    holds them; the serving layer admits and sizes it."""
    spec = tcircuits.build_quclassi_circuit(qc, nl)
    gs = _all(spec)
    walk = K._shift_route(spec, False, gs, K.SMEM_BUDGET_BYTES)
    assert (walk.route, walk.m, walk.k) == ("dmem", m, K.DMEM_LOCAL_QUBITS)
    blocks, smem, sample, per = K.shift_dmem_geometry(walk, 1152)
    assert blocks == 1 and 3 * 64 * 1024 < smem <= K.SMEM_BUDGET_BYTES
    assert (walk.stage is None) == (m > 13)
    n_ops = len(walk.pass_refs)
    if m == 13:
        base = 4 * (6 * 2**13 + 64 + 2 * n_ops) + 8 * 2
        tables = 4 * ((7 + 9) * len(walk.passes) + 6 * n_ops)
    else:
        base = 4 * (6 * 2**13 + 64 + 2 * walk.n_angles + 2 * walk.max_pass_ops) + 8 * (2 + 320)
        tables = 4 * (7 * len(walk.passes) + 7 * n_ops)
    assert K._shift_dmem_smem(walk) == (smem, True)
    assert smem == base + tables
    n_ckpt = len({p[0] for p in K.build_shift_plan(spec).theta_positions})
    kept = {13: 0, 14: 1}.get(m, 2)  # chi and the variant slot, from m = 15
    assert sample == (n_ckpt + kept) * K._state_bytes(m, 1)
    assert per == min(1152, K.SHIFT_DMEM_WORKSPACE_BYTES // sample)
    info = K.shift_execution_info(spec, 1152)
    assert info["launches"] == -(-1152 // per) and info["scratch_bytes"] == per * sample
    assert (info["tb"], info["smem_bytes"], info["n_tiles"]) == (1, smem, 0)
    low = sum(1 << b for b in range(K.DMEM_SECTOR_QUBITS))
    for row in walk.passes:
        local = K._mask(row, 5)
        assert bin(local).count("1") == K.DMEM_LOCAL_QUBITS and local & low == low
        assert 2 ** (m - bin(local).count("1")) == chunks
        for op in walk.local_ops[row[3]:row[4]]:
            assert all(0 <= q < K.DMEM_LOCAL_QUBITS for q in op.qubits)
    assert K.shift_plan_fits(spec) and tdisp.shift_admission_error(spec) is None
    bank = tsr.build_shift_bank(torch.zeros(spec.n_theta), torch.zeros((3, spec.n_data)))
    assert tapi.CostModel(shiftbank=True).bank_smem_bytes(spec, bank) == smem


def test_launch_split_by_samples(monkeypatch):
    """Past the workspace the wrapper's launches take fewer samples, never
    fewer ops: 33q-3l's 94 states of 512 KB a sample, 174 samples a launch
    of 8 GiB, so B = 1,152 runs in 7 launches."""
    spec = tcircuits.build_quclassi_circuit(33, 3)
    walk = K._shift_route(spec, False, _all(spec), K.SMEM_BUDGET_BYTES)
    assert walk.n_slots == 94
    _, _, sample, per = K.shift_dmem_geometry(walk, 1152)
    assert (sample, per) == (94 * 2**19, 174)
    assert K.shift_execution_info(spec, 1152)["launches"] == 7
    assert K.shift_dmem_geometry(walk, 3)[3] == 3
    monkeypatch.setattr(K, "SHIFT_DMEM_WORKSPACE_BYTES", sample - 1)
    assert K.shift_dmem_geometry(walk, 1152)[3] == 1


# (qc, layers, tied, four_term, groups): register plans the shared-memory
# routes also run, forced onto the walk by a budget that holds neither
FORCED = [
    (7, 3, False, False, None),
    (7, 3, True, True, None),
    (13, 3, False, False, (0, 1, 4, 9, 16, 40)),
    (13, 3, True, False, None),
    (9, 2, True, True, (0, 2, 7, 19, 24, 24)),   # a repeated group
    (7, 3, False, False, (5, 3)),                # no base-fidelity row
]


@pytest.mark.parametrize("qc,nl,tied,four,groups", FORCED)
def test_walk_program_matches_single_sweep(qc, nl, tied, four, groups):
    """The program of passes (its plain version) against the single sweep's
    plain version: the same gates in the same order on the same bits, the
    inner products summed in another order, so within 1e-6."""
    build = tcircuits.build_tied_quclassi_circuit if tied else tcircuits.build_quclassi_circuit
    spec = build(qc, nl)
    gs = groups or _all(spec, four)
    tiny = 64  # not even the staged tables
    assert K._shift_route(spec, four, gs, tiny).route == "dmem"
    theta, data = (torch.from_numpy(a) for a in _angles(spec, 4, seed=qc + nl))
    got = K.vqc_shift_fidelity(spec, theta, data, four_term=four, groups=groups,
                               smem_budget=tiny)
    want = K._shiftbank_plain(K.build_shift_plan(spec), K.shift_values(four), gs,
                              spec.n_theta, theta, data)
    assert not torch.isnan(got).any()
    _assert_rows(got, want, atol=1e-6)


def _shared_angle_spec(qc, n_shared):
    """QuClassi qc-1l with its trainable parameters folded onto ``n_shared``
    (parameter j drives every gate of j, j + n_shared, ...): each
    parameter's replay span then reaches across the whole register."""
    base = tcircuits.build_quclassi_circuit(qc, 1)
    ops = tuple(dataclasses.replace(op, param=("theta", op.param[1] % n_shared))
                if op.param is not None and op.param[0] == "theta" else op for op in base.ops)
    return dataclasses.replace(base, ops=ops, n_theta=n_shared)


@pytest.mark.parametrize("qc,nl,tied", [(29, 1, True), (29, 1, False)])
def test_m14_spans_cross_passes_match_single_sweep(qc, nl, tied):
    """m = 14, two chunks a pass: tied QuClassi's two-gate spans, and a
    circuit whose parameters each drive gates across the whole register, so
    that its replays, its forward runs and its chi runs take several passes
    (a replay's middle passes in the variant slot), against the single
    sweep's plain version on the same register."""
    spec = (tcircuits.build_tied_quclassi_circuit(qc, nl) if tied
            else _shared_angle_spec(qc, 3))
    gs = _all(spec) if not tied else (0, 1, 2, 17, 28, 55)
    walk = K._shift_route(spec, False, gs, K.SMEM_BUDGET_BYTES)
    assert walk.route == "dmem" and walk.m == 14
    if not tied:
        assert any(r[0] == 1 for r in walk.passes)  # a replay pass from the variant slot
    theta, data = (torch.from_numpy(a) for a in _angles(spec, 2, seed=5))
    got = K.vqc_shift_fidelity(spec, theta, data, groups=gs)
    want = K._shiftbank_plain(K.build_shift_plan(spec), K.shift_values(False), gs,
                              spec.n_theta, theta, data)
    _assert_rows(got, want, atol=1e-6)


def test_traffic_counts_the_program():
    """27q-3l (m = 13): chi never leaves shared memory; the forward runs
    store the 74 checkpoints; each parameter's checkpoint is loaded once
    for its two shifts, but the two deepest, still staged after the
    forward runs (f0 and the deepest parameter's variants read the deepest
    where it stands, and leave the one before it staged): 146 chunks a
    sample, where a walk with every slot in device memory moved 518
    (chi's load/store round trips and its reads for the inner products,
    every variant's own load).  29q-1l (m = 14): chi resident, each pass
    moves its other slots' chunks."""
    spec = tcircuits.build_quclassi_circuit(27, 3)
    walk = K._shift_route(spec, False, _all(spec), K.SMEM_BUDGET_BYTES)
    n_ckpt, stage = walk.n_slots - 2, walk.stage
    loads = np.concatenate([stage[:, 2][stage[:, 1] >= 0], stage[:, 6][stage[:, 5] >= 0]])
    assert (n_ckpt, len(loads), len(set(loads.tolist()))) == (74, 72, 72)
    assert loads.min() >= 2 and set(walk.passes[:, 1][walk.passes[:, 1] >= 2]) == \
        set(range(2, 2 + n_ckpt))
    assert K.shift_dmem_traffic_bytes(walk) == 146 * K._state_bytes(13, 1)
    spec = tcircuits.build_quclassi_circuit(29, 1)
    walk = K._shift_route(spec, False, _all(spec), K.SMEM_BUDGET_BYTES)
    per = sum((r[0] >= 1) + (r[1] >= 1) for r in walk.passes.tolist())
    assert K.shift_dmem_traffic_bytes(walk) == per * 2 * K._state_bytes(13, 1)


@pytest.mark.parametrize("worker", [0, 1])
def test_traffic_of_a_worker_half_bank_m13(worker):
    """A worker's groups of the 2-worker round robin (27q-3l, both shifts
    of every other parameter): 37 checkpoints stored, 35 loaded (the two
    deepest staged), 72 chunks a sample where a walk with every slot in
    device memory moved 259-260, and none of chi's or the variant slot's."""
    from repro_torch.comanager import dataplane

    spec = tcircuits.build_quclassi_circuit(27, 3)
    assign = dataplane.round_robin_assignment(len(_all(spec)), 2)
    gs = tuple(g for g in _all(spec) if assign[g] == worker)
    walk = K._shift_route(spec, False, gs, K.SMEM_BUDGET_BYTES)
    assert walk.m == walk.k == 13 and walk.n_slots - 2 == 37
    assert K.shift_dmem_traffic_bytes(walk) == 72 * K._state_bytes(13, 1)
    stage = walk.stage
    assert min(stage[:, 2][stage[:, 1] >= 0].tolist() + stage[:, 6][stage[:, 5] >= 0].tolist()) >= 2


@pytest.mark.parametrize("groups,sweeps,one", [(None, 310, 296), (0, 162, 148), (1, 162, 148)],
                         ids=["whole", "worker0", "worker1"])
def test_sweeps_a_sample_m13(groups, sweeps, one):
    """27q-3l's whole bank and each worker's half of the 2-worker round
    robin: every pass but the data run sweeps the state in shared memory
    once (its 26 gates take 13 sweeps and |0...0> one), so a half takes
    162 sweeps a sample where one sweep a gate took 372 (worker 0, with
    f0) and 368; ``shift_execution_info`` reports the plan's counts."""
    from repro_torch.comanager import dataplane

    spec = tcircuits.build_quclassi_circuit(27, 3)
    gs = _all(spec)
    if groups is not None:
        assign = dataplane.round_robin_assignment(len(gs), 2)
        gs = tuple(g for g in gs if assign[g] == groups)
    walk = K._shift_route(spec, False, gs, K.SMEM_BUDGET_BYTES)
    assert K.shift_dmem_sweeps(walk) == (sweeps, one) and len(walk.passes) == one + 1
    info = K.shift_execution_info(spec, 576, groups=gs)
    assert (info["sweeps"], info["one_sweep_passes"], info["passes"]) == (sweeps, one, one + 1)
    forms = walk.stage[:, 7].tolist()
    assert forms[0] == K._PER_GATE and K._PER_GATE not in forms[1:]
    variants = [st[7] for r, st in zip(walk.passes.tolist(), walk.stage.tolist()) if r[2] != -1]
    assert set(variants) == {K._ELEMENT}


@pytest.mark.parametrize("qc,nl,sweeps", [(29, 1, 353), (31, 1, 378), (33, 1, 403),
                                          (33, 3, 1123)])
def test_sweeps_a_sample_chunked(qc, nl, sweeps):
    """m = 14-16 walk chunk by chunk, each pass a fill, its gates one sweep
    each (chunk_gates: a run of one qubit's rotations in one), a drain where
    it stores and an inner product where it ends in one: the count their
    passes run, none of them one sweep."""
    spec = tcircuits.build_quclassi_circuit(qc, nl)
    walk = K._shift_route(spec, False, _all(spec), K.SMEM_BUDGET_BYTES)
    assert walk.stage is None
    want = 0
    for src, dst, row, lo, hi, *_ in walk.passes.tolist():
        ops, j = walk.local_ops[lo:hi], 0
        while j < len(ops):  # chunk_gates' sweeps
            j1, low = j + 1, ops[j].qubits[-1] > walk.k - 3
            joins = ("rx", "ry", "rz", "h") if low else ("rx", "ry", "rz")
            while ops[j].gate in joins and j1 < len(ops) and ops[j1].gate in joins \
                    and ops[j1].qubits[0] == ops[j].qubits[0]:
                j1 += 1
            want, j = want + 1, j1
        want += 1 + (dst >= 0) + (row != -1)
    assert K.shift_dmem_sweeps(walk) == (want, 0) and want == sweeps
    info = K.shift_execution_info(spec, 100)
    assert (info["sweeps"], info["one_sweep_passes"]) == (sweeps, 0)


def _run_stage(walk):
    """Run the staging plan symbolically, region by region, and return its
    (loads, stores): each pass must find its source in its read region (a
    checkpoint's stored value, or chi in region 0; |0...0> reads none), a
    load must read a slot already stored into a region no pass touches
    until it is waited for, and every load is waited for.  An element pass
    (one gate ending in an inner product) reads its staged checkpoint and
    writes nothing, so the checkpoint stays staged; any other pass writes
    its work region (in place where it is the read region), and a forward
    run's region is the checkpoint it stores.  Each pass's orbit holds
    every bit across which its gates mix amplitudes."""
    value, region, loading = {}, {0: None, 1: None, 2: None}, {1: None, 2: None}
    loads = stores = 0
    for i, (row, st) in enumerate(zip(walk.passes.tolist(), walk.stage.tolist())):
        src, dst, out, lo, hi = row[:5]
        work, fetch, fetch_slot, wait, read, load, load_slot, form, orbit = st

        def issue(r, slot):
            assert r in (1, 2) and loading[r] is None and slot in value, (i, r, slot)
            loading[r], region[r] = ("slot", slot, value[slot]), "in flight"
            return 1

        loads += issue(fetch, fetch_slot) if fetch >= 0 else 0
        if wait >= 0:
            assert loading[wait] is not None, (i, wait)
            region[wait], loading[wait] = loading[wait], None
        assert all(loading[r] is None for r in (work, read) if r > 0), (i, work, read)
        if src < 0:
            assert read == -1, i
        else:
            assert region[read] == ("slot", src, value[src]), (i, read, region[read])
        assert load < 0 or load not in (work, read), (i, load)
        loads += issue(load, load_slot) if load >= 0 else 0
        bits = {walk.k - 1 - q for op in walk.local_ops[lo:hi] for q in K._coupled_qubits(op)}
        if form == K._ELEMENT:
            assert (work, dst, hi - lo) == (-1, -1, 1) and out != -1 and read > 0, i
        else:
            assert form == K._PER_GATE or (orbit & 3 == 3 and bin(orbit).count("1") == 4
                                           and bits == {b for b in bits if orbit >> b & 1}), i
            region[work] = ("pass", i)
            if dst >= 0:
                assert (work == 0) == (dst == 0), (i, work, dst)
                stores += dst > 0
                value[dst] = ("pass", i)
                region[work] = ("slot", dst, value[dst])
        if out != -1:
            assert work != 0 and region[0] == ("slot", 0, value[0]), i
    assert all(v is None for v in loading.values())
    return loads, stores


STAGED = [(27, 1, False, False), (27, 3, False, False)] + [f[:4] for f in FORCED]


@pytest.mark.parametrize("qc,nl,tied,four", STAGED)
def test_staging_plan_feeds_every_pass(qc, nl, tied, four):
    """The one-chunk walk's staging plan, run symbolically on its whole bank,
    each worker's round-robin groups and 12 random group sets (repeats and
    lone shifts among them): every pass finds its state, no region is
    touched while a load into it is in flight, the traffic count is the
    plan's loads and stores, and every variant of one gate on a checkpoint
    reads it where it stands."""
    build = tcircuits.build_tied_quclassi_circuit if tied else tcircuits.build_quclassi_circuit
    spec = build(qc, nl)
    gs = _all(spec, four)
    rng = np.random.default_rng(qc * 10 + nl)
    sets = [gs, gs[0::2], gs[1::2]] + [
        tuple(rng.choice(len(gs), size=rng.integers(1, 9)).tolist()) for _ in range(12)]
    for groups in sets:
        walk = K._shift_dmem_walk(spec, four, groups)
        assert walk.m == walk.k
        loads, stores = _run_stage(walk)
        assert stores == walk.n_slots - 2
        assert K.shift_dmem_traffic_bytes(walk) == (loads + stores) * K._state_bytes(walk.k, 1)
        for (src, dst, row, lo, hi, *_), st in zip(walk.passes.tolist(), walk.stage.tolist()):
            if walk.k >= 4 and src >= 0 and row != -1 and hi - lo == 1:
                assert st[7] == K._ELEMENT


@pytest.mark.parametrize("qc,nl,m,chunks", WIDE)
@pytest.mark.parametrize("worker", [None, 0, 1])
def test_shared_memory_within_budget(qc, nl, m, chunks, worker):
    """Every wide plan's block, whole bank or a worker's groups, fits the
    232,448 bytes a block may use, and the serving layer's per-block
    memory model (which sizes the whole bank) reads the whole bank's."""
    from repro_torch.comanager import dataplane

    spec = tcircuits.build_quclassi_circuit(qc, nl)
    gs = _all(spec)
    if worker is not None:
        assign = dataplane.round_robin_assignment(len(gs), 2)
        gs = tuple(g for g in gs if assign[g] == worker)
    walk = K._shift_route(spec, False, gs, K.SMEM_BUDGET_BYTES)
    smem = K.shift_dmem_geometry(walk, 1)[1]
    assert walk.route == "dmem" and smem <= K.SMEM_BUDGET_BYTES == 232_448
    if worker is None:
        bank = tsr.build_shift_bank(torch.zeros(spec.n_theta), torch.zeros((2, spec.n_data)))
        assert tapi.CostModel(shiftbank=True).bank_smem_bytes(spec, bank) == smem


def test_multibank_bit_identical_per_lane_m13():
    """Banks packed into one launch give each lane the bits of its own
    per-bank call, whatever the segment (27q-1l, a group subset each)."""
    spec = tcircuits.build_quclassi_circuit(27, 1)
    banks, group_sets = [], ((0, 3, 8, 40), _all(spec), (1, 2))
    for i, b in enumerate((3, 2, 1)):
        theta, data = _angles(spec, b, seed=30 + i)
        banks.append(tsr.build_shift_bank(torch.from_numpy(theta[0]), torch.from_numpy(data)))
    outs = tops.vqc_fidelity_shiftgroups_multibank(
        spec, tuple(b.theta for b in banks), tuple(b.data for b in banks), False, group_sets)
    for bank, gs, out in zip(banks, group_sets, outs):
        assert torch.equal(out, tops.vqc_fidelity_shiftgroups(spec, bank.theta, bank.data,
                                                               False, gs))
        whole = tops.vqc_fidelity_shiftgroups(spec, bank.theta, bank.data)
        assert torch.equal(out, whole[list(gs)])


def test_launch_observer_reports_the_route():
    spec = tcircuits.build_quclassi_circuit(27, 1)
    theta, data = (torch.from_numpy(a) for a in _angles(spec, 2, seed=4))
    seen = []
    prev = tops.set_launch_observer(seen.append)
    try:
        tops.vqc_fidelity_shiftgroups(spec, theta, data, False, (0, 1, 2))
    finally:
        tops.set_launch_observer(prev)
    assert len(seen) == 1  # no depth tiles: no tile events
    assert (seen[0]["mode"], seen[0]["route"], seen[0]["launches"]) == ("spill", "dmem", 1)
    walk = K._shift_route(spec, False, (0, 1, 2), K.SMEM_BUDGET_BYTES)
    assert (seen[0]["sweeps"], seen[0]["one_sweep_passes"]) == K.shift_dmem_sweeps(walk)


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_crash_migration_replays_m13_bit_for_bit(mode):
    """A 27q-1l bank's batch placed on a crashed worker migrates to the
    survivor and replays on the same route: the served rows equal the
    direct call bit for bit, and no batch goes to the mesh."""
    spec = tcircuits.build_quclassi_circuit(27, 1)
    theta, data = (torch.from_numpy(a) for a in _angles(spec, 3, seed=9))
    bank = tsr.build_shift_bank(theta[0], data)
    want = tops.vqc_fidelity_shiftgroups(spec, bank.theta, bank.data).reshape(-1)
    rt = GatewayRuntime(
        [WorkerConfig("w1", 33), WorkerConfig("w2", 33)], deadline=0.01, mode=mode,
        fault_tolerance=FaultToleranceConfig(retry_limit=0, breaker_threshold=1,
                                             breaker_cooldown_s=3600.0),
        fault_injector=FaultInjector({"w1": FaultSpec(kind="crash", at=0.0)}))
    try:
        got = rt.shift_executor(spec, "wide")(bank)
    finally:
        rt.close()
    summary = rt.telemetry.summary()
    assert torch.equal(got, want)
    assert summary["migrated_batches"] >= 1 and rt.telemetry.mesh_spills == 0

