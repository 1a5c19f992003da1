"""Launch geometry of the warp-per-circuit kernels (fidelity and spill
tile), on the CPU.

``fused_geometry`` is the only source of the fidelity kernel's warps per
block and shared memory, and ``spill_tiling`` of the tile kernel's; the
launch and ``shift_execution_info`` must read the same numbers, or a launch
asks for other shared memory than the model reports.
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


# (qc, layers, workers, worker, the parent footprint model's tiles,
# checkpoints a tile and samples a block: unchanged by the launch geometry)
SPILLED = [
    (13, 3, 2, 0, ((1, 23), (23, 32)), (11, 5), 32),
    (13, 3, 2, 1, ((0, 22), (22, 32)), (11, 5), 32),
    (17, 1, 1, 0, ((0, 4), (4, 8), (8, 12), (12, 16)), (4,) * 4, 16),
    (17, 3, 1, 0, tuple((lo, lo + 4) for lo in range(0, 44, 4)), (4,) * 11, 16),
]


@pytest.mark.parametrize("qc,nl,n_workers,worker,tiles,n_ckpt,tb", SPILLED)
def test_spill_launch_geometry(qc, nl, n_workers, worker, tiles, n_ckpt, tb):
    """The tile launch takes blocks of SPILL_LAUNCH_WARPS samples with the
    footprint model's tiles, and asks for exactly the reported launch
    bytes: the staged tables (the kernel's count of them) and the
    states of launch_tb samples."""
    spec = circuits.build_quclassi_circuit(qc, nl)
    n_groups = 1 + 2 * spec.n_theta
    groups = tuple(g for g in range(n_groups) if g % n_workers == worker)
    info = K.shift_execution_info(spec, 576, groups=groups)
    tab = K._spill_table(spec, False, groups, K.SMEM_BUDGET_BYTES)
    plan = K.build_shift_plan(spec)
    assert info["mode"] == "spill" and tab.tiling.tiles == info["tiles"] == tiles
    assert tab.tiling.n_ckpt == n_ckpt and info["tb"] == tb
    assert info["smem_bytes"] == K.spill_tile_smem_bytes(plan.m, max(n_ckpt), tb)
    assert info["launch_tb"] == tab.tiling.launch_tb == K.SPILL_LAUNCH_WARPS
    assert info["launch_smem_bytes"] == tab.tiling.launch_smem_bytes <= K.SMEM_BUDGET_BYTES
    # the kernel stages the int table up to the variants' end and every float
    words = len(tab.ints) - tab.n_f0_rows + len(tab.floats)
    table = K.spill_table_bytes(plan, tab.n_tiles, tab.n_variants)
    assert table == 4 * (-(-words // 32) * 32)
    assert info["launch_smem_bytes"] == table + K.spill_tile_smem_bytes(
        plan.m, max(n_ckpt), K.SPILL_LAUNCH_WARPS)

