"""Launch geometry of the warp-per-circuit kernels, on the CPU.

``fused_geometry`` is the only source of the fidelity and state kernels'
warps per block and shared memory, ``shift_geometry`` of the single-sweep
shift kernel's, ``forward_geometry`` of the spill forward kernel's and
``spill_tiling`` of the tile kernel's; the launch and
``shift_execution_info`` must read the same numbers, or a launch asks for
other shared memory than the model reports.  ``_shift_route`` decides
single sweep or spill pair from those launches' blocks.
"""
import dataclasses

import pytest

from repro_torch.core import circuits
from repro_torch.core.sim import CircuitSpec
from repro_torch.kernels import vqc_statevector as K


@pytest.mark.parametrize("n,c,want", [
    (7, 4176, (8, 8 * 1024)),     # one worker's row batch: 522 blocks of 8 warps
    (7, 100, (8, 8 * 1024)),      # the last block ragged (100 = 12 * 8 + 4)
    (7, 3, (4, 4 * 1024)),        # a batch smaller than a block: its envelope
    (7, 1, (1, 1024)),
    (3, 4176, (8, 8 * 64)),       # 8 amplitudes: most lanes idle
    (10, 4176, (8, 8 * 8192)),    # the state kernel's one-thread limit was 9
    (11, 4176, (8, 8 * 16384)),   # 16 KB a state: 128 KB a block
    (12, 4176, (4, 4 * 32768)),   # the budget halves the block
    (13, 4176, (2, 2 * 65536)),
    (14, 4176, (1, 131072)),      # the widest: one 128 KB state a block
    (15, 4176, (0, 0)),           # 256 KB: not one state fits 227 KB
])
def test_fused_geometry(n, c, want):
    assert K.fused_geometry(n, c) == want
    warps, smem = want
    assert smem == K._state_bytes(n, warps) <= K.SMEM_BUDGET_BYTES
    assert warps <= K.FUSED_WARPS


def test_fused_geometry_follows_the_budget():
    assert K.fused_geometry(7, 4176, smem_budget=4 * 1024) == (4, 4 * 1024)
    assert K.fused_geometry(7, 4176, smem_budget=1023) == (0, 0)


def _unstructured(qc, nl):
    """A QuClassi circuit without its last H: no SWAP-test plan, so every
    shift bank materializes."""
    spec = circuits.build_quclassi_circuit(qc, nl)
    return dataclasses.replace(spec, ops=spec.ops[:-1])


@pytest.mark.parametrize("qc,nl,n_samples,groups", [
    (7, 3, 576, None),          # 576 x 29 rows
    (7, 3, 1, (0, 3)),          # 2 rows
    (5, 1, 33, (0, 1, 2)),
    (11, 1, 64, (0,)),
])
def test_materialize_info_reads_fused_geometry(qc, nl, n_samples, groups):
    """The materialize branch reports the fidelity launch over the
    n_samples x G materialized rows."""
    spec = _unstructured(qc, nl)
    assert isinstance(spec, CircuitSpec) and K.build_shift_plan(spec) is None
    info = K.shift_execution_info(spec, n_samples, groups=groups)
    n_groups = 1 + 2 * spec.n_theta if groups is None else len(groups)
    assert info["mode"] == "materialize" and info["launches"] == 1
    assert (info["tb"], info["smem_bytes"]) == K.fused_geometry(qc, n_samples * n_groups)


def _groups(spec, n_workers, worker=0):
    n_groups = 1 + 2 * spec.n_theta
    return tuple(g for g in range(n_groups) if g % n_workers == worker)


# (qc, layers, workers, checkpoints, variant rows, shift_geometry): worker
# 0's request at 227 KB
SWEEPS = [
    (7, 3, 1, 14, 28, (4, 5760)),      # the paper's: 4 x 17 x 64 B + 1,408 B of tables
    (13, 3, 2, 16, 32, (4, 41216)),
    (13, 3, 1, 32, 64, (4, 74752)),
    (15, 3, 1, 38, 76, (4, 171520)),
    (17, 1, 1, 16, 32, (4, 157440)),
    (17, 3, 1, 44, 88, (2, 196736)),   # 47 states of 2 KB: two samples a block
    (19, 3, 1, 50, 100, (1, 221824)),  # 53 states of 4 KB: one
    (21, 3, 1, 56, 112, (0, 0)),       # 59 states of 8 KB: not one
]


@pytest.mark.parametrize("qc,nl,n_workers,n_ckpt,n_variants,want", SWEEPS)
def test_shift_geometry(qc, nl, n_workers, n_ckpt, n_variants, want):
    """One warp per sample, SHIFT_WARPS a block halved until the staged
    tables and the samples' (n_ckpt + 3) states fit; the single-sweep table
    carries exactly that launch."""
    spec = circuits.build_quclassi_circuit(qc, nl)
    plan = K.build_shift_plan(spec)
    assert K.shift_geometry(plan, n_ckpt, n_variants) == want
    warps, smem = want
    if warps:
        assert warps <= K.SHIFT_WARPS and smem <= K.SMEM_BUDGET_BYTES
        assert smem == K.walk_table_bytes(plan, n_variants) + K.walk_smem_bytes(
            plan.m, n_ckpt, warps)
    tab = K._walk_table(spec, False, _groups(spec, n_workers), K.SMEM_BUDGET_BYTES, False)
    assert (tab.n_ckpt, tab.n_variants, tab.tiles) == ((n_ckpt,), n_variants, ())
    assert (tab.tb, tab.smem_bytes) == want


def test_shift_geometry_follows_the_budget():
    spec = circuits.build_quclassi_circuit(7, 3)
    plan = K.build_shift_plan(spec)
    table = K.walk_table_bytes(plan, 28)
    assert table == 4 * (-(-((6 + 14) * 6 + 2 * 14 + 5 * 28 + 6 + 14 + 28) // 32) * 32)
    one = table + K.walk_smem_bytes(3, 14, 1)
    assert K.shift_geometry(plan, 14, 28, smem_budget=one) == (1, one)
    assert K.shift_geometry(plan, 14, 28, smem_budget=one - 1) == (0, 0)
    three = table + K.walk_smem_bytes(3, 14, 3)  # halves 4 to 2, not 3
    assert K.shift_geometry(plan, 14, 28, smem_budget=three) == (2, 2 * one - table)


@pytest.mark.parametrize("qc,nl,n_variants,want", [
    (13, 3, 32, (4, 2304 + 4 * 2 * 512)),  # m = 6: the data and running states
    (19, 1, 36, (4, 2048 + 4 * 2 * 4096)),
    (25, 1, 2, (2, 132736)),               # m = 12: two samples a block
    (27, 1, 2, (1, 132864)),               # m = 13: one
    (29, 1, 2, (0, 0)),                    # m = 14: two 128 KB states do not fit
])
def test_forward_geometry(qc, nl, n_variants, want):
    """The spill forward kernel: SPILL_LAUNCH_WARPS samples a block, halved
    until the tables and two states a sample fit (the one-thread kernel it
    replaced needed 32 samples and refused m >= 9)."""
    spec = circuits.build_quclassi_circuit(qc, nl)
    plan = K.build_shift_plan(spec)
    assert K.forward_geometry(plan, n_variants) == want


# (qc, layers, route of worker 0's request at 1, 2 and 4 workers, as
# (mode, samples a block))
ROUTES = [
    (7, 3, (("fused", 4), ("fused", 4), ("fused", 4))),
    (13, 3, (("fused", 4), ("fused", 4), ("fused", 4))),
    (15, 3, (("fused", 4), ("fused", 4), ("fused", 4))),
    (17, 1, (("fused", 4), ("fused", 4), ("fused", 4))),
    (17, 3, (("spill", 4), ("fused", 4), ("fused", 4))),  # 1 worker: a sweep block of 2
    (19, 3, (("spill", 4), ("spill", 4), ("spill", 4))),  # sweep blocks of 1, 1, 2
]


@pytest.mark.parametrize("qc,nl,want", ROUTES)
@pytest.mark.parametrize("worker_index", range(3))
def test_route_from_the_launch_block(qc, nl, want, worker_index):
    """``_shift_route`` takes the single sweep where a block of at least
    SWEEP_MIN_WARPS samples holds its checkpoints, else the spill pair where
    its tile launch fits; the execution report shows the launch taken."""
    n_workers = (1, 2, 4)[worker_index]
    spec = circuits.build_quclassi_circuit(qc, nl)
    groups = _groups(spec, n_workers)
    info = K.shift_execution_info(spec, 576, groups=groups)
    assert (info["mode"], info["tb"]) == want[worker_index]
    sweep = K._walk_table(spec, False, groups, K.SMEM_BUDGET_BYTES, False)
    spill = K._walk_table(spec, False, groups, K.SMEM_BUDGET_BYTES, True)
    fits = sweep.tb >= K.SWEEP_MIN_WARPS or (sweep.tb and not spill.tb)
    assert info["mode"] == ("fused" if fits else "spill")
    assert K._shift_route(spec, False, groups, K.SMEM_BUDGET_BYTES) is (sweep if fits else spill)


# (qc, layers, workers, worker, tiles, checkpoints a tile, samples a block,
# shared memory of the tile launch) of the spill pair's table at 227 KB,
# whichever route the request takes
SPILLED = [
    (13, 3, 2, 0, ((1, 32),), (16,), 4, 41216),
    (13, 3, 2, 1, ((0, 32),), (16,), 4, 41216),
    (17, 1, 1, 0, ((0, 16),), (16,), 4, 157440),
    (17, 3, 1, 0, ((0, 24), (24, 44)), (24, 20), 4, 225408),
    (19, 1, 1, 0, ((0, 11), (11, 18)), (11, 7), 4, 231424),  # m = 9
]


@pytest.mark.parametrize("qc,nl,n_workers,worker,tiles,n_ckpt,tb,smem", SPILLED)
def test_spill_launch_geometry(qc, nl, n_workers, worker, tiles, n_ckpt, tb, smem):
    """The tile launch's tiles are planned for its own block of
    SPILL_LAUNCH_WARPS samples and it asks for exactly the reported bytes:
    the staged tables (the kernel's count of them) and the states of tb
    samples for the fullest tile."""
    spec = circuits.build_quclassi_circuit(qc, nl)
    groups = _groups(spec, n_workers, worker)
    tab = K._walk_table(spec, False, groups, K.SMEM_BUDGET_BYTES, True)
    plan = K.build_shift_plan(spec)
    assert (tab.tiles, tab.n_ckpt, tab.tb, tab.smem_bytes) == (tiles, n_ckpt, tb, smem)
    assert tab.tb <= K.SPILL_LAUNCH_WARPS and tab.smem_bytes <= K.SMEM_BUDGET_BYTES
    # the kernel stages the int table up to the variants' end and every float
    words = len(tab.ints) - tab.n_f0_rows - 4 * tab.n_tiles + len(tab.floats)
    table = K.walk_table_bytes(plan, tab.n_variants)
    assert table == 4 * (-(-words // 32) * 32)
    assert smem == table + K.walk_smem_bytes(plan.m, max(n_ckpt), tb)
    assert (tab.forward_tb, tab.forward_smem_bytes) == K.forward_geometry(plan, tab.n_variants)
