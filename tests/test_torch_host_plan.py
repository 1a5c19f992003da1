"""The host half of the shift kernel: the port's plans and analytic counters
equal the reference's exactly when both get the same ``tb`` and budget.

Only the on-chip memory model differs between the packages (the TPU's
128-lane tiles and 14 MB VMEM against Hopper's warps and 227 KB of shared
memory), so the comparisons pass the same explicit arguments, and bank sizes
that are multiples of both lane quanta where lanes are padded.
"""
import pytest

from repro.core import circuits as jcircuits
from repro.core import shift_rule as jsr
from repro.kernels import vqc_statevector as JK
from repro_torch.core import circuits as tcircuits
from repro_torch.core import shift_rule as tsr
from repro_torch.kernels import vqc_statevector as TK

CASES = [(3, 1, False), (5, 1, False), (5, 3, False), (7, 2, False), (7, 3, False),
         (5, 2, True), (7, 3, True), (9, 3, True)]


def _specs(qc, nl, tied):
    name = "build_tied_quclassi_circuit" if tied else "build_quclassi_circuit"
    return getattr(jcircuits, name)(qc, nl), getattr(tcircuits, name)(qc, nl)


def _fields(plan):
    return (plan.m, [(o.gate, o.qubits, o.param) for o in plan.data_ops],
            [(o.gate, o.qubits, o.param) for o in plan.train_ops], plan.theta_positions)


@pytest.mark.parametrize("qc,nl,tied", CASES)
def test_plan_and_costs_equal_reference(qc, nl, tied):
    js, ts = _specs(qc, nl, tied)
    jp, tp = JK.build_shift_plan(js), TK.build_shift_plan(ts)
    assert _fields(tp) == _fields(jp)
    assert [tp.replay_depth(j) for j in range(ts.n_theta)] == [
        jp.replay_depth(j) for j in range(js.n_theta)]
    for four in (False, True):
        n_groups = 1 + (4 if four else 2) * ts.n_theta
        shifts = tsr.shift_values(four)
        assert shifts == jsr.shift_values(four)
        for groups in (None, tuple(range(0, n_groups, 3)), (0,), (n_groups - 1,)):
            want = JK.shift_cost_info(js, four, groups)
            assert TK.shift_cost_info(ts, four, groups) == {
                k: v for k, v in want.items() if k != "use_implicit"}
            gs = groups or tuple(range(n_groups))
            assert TK.plan_gate_apps(tp, shifts, gs, ts.n_theta) == JK.plan_gate_apps(
                jp, shifts, gs, js.n_theta)
            assert TK._collect_variants(tp, shifts, gs, ts.n_theta) == JK._collect_variants(
                jp, shifts, gs, js.n_theta)
        # the port decides the route per bank (use_shift_plan): the
        # reference's decision for the whole bank
        assert TK.use_shift_plan(ts, four) == JK.shift_cost_info(js, four)["use_implicit"]
        for n in (1, 7, 576):
            assert TK.shift_bank_stats(ts, n, four) == JK.shift_bank_stats(js, n, four)


@pytest.mark.parametrize("qc,nl,tied", CASES)
@pytest.mark.parametrize("tb,budget", [(128, 14 * 1024 * 1024), (128, 64 * 1024),
                                       (512, 200 * 1024), (32, 227 * 1024)])
def test_depth_tiles_equal_reference(qc, nl, tied, tb, budget):
    js, ts = _specs(qc, nl, tied)
    jp, tp = JK.build_shift_plan(js), TK.build_shift_plan(ts)
    anchors = sorted({ps[-1] for ps in tp.theta_positions if ps})
    for positions in (anchors, anchors[::2], anchors[-1:], []):
        assert TK._merge_spans(tp, positions) == JK._merge_spans(jp, positions)
        assert TK.plan_depth_tiles(tp, positions, tb, budget) == JK.plan_depth_tiles(
            jp, positions, tb, budget)


@pytest.mark.parametrize("sizes", [(128,), (128, 256, 384), (512, 128)])
@pytest.mark.parametrize("four", [False, True])
def test_multibank_stats_equal_reference(sizes, four):
    js, ts = _specs(7, 3, False)
    budget = 14 * 1024 * 1024
    assert TK.multibank_stats(ts, sizes, four, smem_budget=budget) == JK.multibank_stats(
        js, sizes, four, vmem_budget=budget)


def test_hopper_spill_threshold():
    """The single sweep is planned from its launch's block (one warp per
    sample, SHIFT_WARPS a block, beside the staged tables): every register
    the paper uses (m <= 3) and 13q-3l with all 65 groups (m = 6, 32
    checkpoints, 4 x 35 x 512 B) stay in one sweep; 21q-3l (m = 10) fits no
    single-sweep sample and spills.  ``plan_depth_tiles`` itself is the
    reference's: a warp of 32 samples holds 10 of 13q-3l's checkpoints,
    not 11."""
    _, ts = _specs(7, 3, False)
    plan = TK.build_shift_plan(ts)
    info = TK.shift_execution_info(ts, 576)
    assert info["mode"] == "fused" and info["tb"] == TK.SHIFT_WARPS
    n_variants = 2 * ts.n_theta
    assert info["smem_bytes"] == (TK.walk_table_bytes(plan, n_variants)
                                  + (14 + 3) * 2 * 4 * 8 * TK.SHIFT_WARPS)
    wide = tcircuits.build_quclassi_circuit(13, 3)  # m = 6, 32 parameters
    info = TK.shift_execution_info(wide, 576)
    assert info["mode"] == "fused" and info["tb"] == TK.SHIFT_WARPS
    assert info["smem_bytes"] <= TK.SMEM_BUDGET_BYTES
    assert TK.shift_execution_info(tcircuits.build_quclassi_circuit(21, 3), 576)["mode"] == "spill"
    plan = TK.build_shift_plan(wide)
    anchors = sorted({ps[-1] for ps in plan.theta_positions if ps})
    assert TK.plan_depth_tiles(plan, anchors[:10]) is None
    assert TK.plan_depth_tiles(plan, anchors[:11]) is not None
