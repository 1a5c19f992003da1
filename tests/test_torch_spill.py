"""The spilled shift path: the port's plain spill pair (the plain versions of
``vqc_spill.cu``), the shared-memory model and route of both shift paths,
and the 13-qubit training step, on the CPU.

Inputs are seeded numpy arrays handed to both packages.  The spilled pair
applies each lane's gates in the single sweep's order, so it equals the
port's single-sweep plain version bit for bit; against the reference
(Pallas in interpret mode, its own spill tiling under ``vmem_budget``) and
the dense oracle it agrees to 1e-5, the reference's float32 kernel
tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.capabilities import declare as jdeclare
from repro.comanager import dataplane as jdp
from repro.core import circuits as jcircuits
from repro.core import quclassi as jq
from repro.core import segmentation as jseg
from repro.data import mnist as jmnist
from repro.kernels import vqc_statevector as JK
from repro_torch.api.capabilities import declare as tdeclare
from repro_torch.comanager import dataplane as tdp
from repro_torch.core import circuits as tcircuits
from repro_torch.core import fidelity as tfid
from repro_torch.core import quclassi as tq
from repro_torch.core import segmentation as tseg
from repro_torch.core import shift_rule as tsr
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


# (qc, layers, tied, four_term, groups, checkpoints the forced budget holds)
CASES = [
    (5, 3, False, False, None, 3),
    (5, 3, False, True, None, 3),
    (7, 3, False, False, None, 3),
    (7, 3, False, True, None, 2),
    (5, 3, True, False, None, 3),
    (5, 3, True, True, None, 2),
    (5, 3, False, False, (0, 1, 4, 9, 16), 1),        # a group subset
    (7, 3, False, False, (0, 3, 8, 14, 28), 1),
    (5, 2, True, True, (0, 2, 7, 19, 24), 1),         # tied subset, four-term
]


def _forced(ts, four, groups, n_ckpt):
    """A budget that holds the staged tables and, for one sample, ``n_ckpt``
    checkpoints and the reference's 4 live states (so a single sweep of
    ``n_ckpt + 1`` checkpoints), and the execution report under it (which
    must spill into >= 2 tiles)."""
    plan = K.build_shift_plan(ts)
    gs = groups or tuple(range(1 + len(K.shift_values(four)) * ts.n_theta))
    n_variants = K._walk_table(ts, four, gs, K.SMEM_BUDGET_BYTES, False).n_variants
    budget = K.walk_table_bytes(plan, n_variants) + (n_ckpt + 4) * K._state_bytes(plan.m, 1)
    info = K.shift_execution_info(ts, 5, four_term=four, groups=groups, smem_budget=budget)
    assert info["mode"] == "spill" and info["n_tiles"] >= 2
    return budget


@pytest.mark.parametrize("qc,nl,tied,four,groups,n_ckpt", CASES)
def test_spilled_plain_bit_identical_to_single_sweep(qc, nl, tied, four, groups, n_ckpt):
    _, ts = _specs(qc, nl, tied)
    budget = _forced(ts, four, groups, n_ckpt)
    theta, data = (torch.from_numpy(a) for a in _angles(ts, 5, seed=qc + nl))
    got = K.vqc_shift_fidelity(ts, theta, data, four_term=four, groups=groups,
                               smem_budget=budget)
    gs = groups or tuple(range(1 + len(K.shift_values(four)) * ts.n_theta))
    want = K._shiftbank_plain(K.build_shift_plan(ts), K.shift_values(four), gs,
                              ts.n_theta, theta, data)
    assert torch.equal(got, want)


@pytest.mark.parametrize("qc,nl,tied,four,groups,n_ckpt", CASES)
def test_spilled_plain_matches_reference_and_dense_oracle(qc, nl, tied, four, groups, n_ckpt):
    js, ts = _specs(qc, nl, tied)
    budget = _forced(ts, four, groups, n_ckpt)
    theta, data = _angles(ts, 3, seed=qc * nl + 1)
    got = K.vqc_shift_fidelity(ts, torch.from_numpy(theta), torch.from_numpy(data),
                               four_term=four, groups=groups, smem_budget=budget)
    # the reference spills too, under its own tiling of the same budget idea
    jbudget = JK.checkpoint_vmem_bytes(JK.build_shift_plan(js), n_ckpt, 128)
    want = JK.vqc_shift_fidelity(js, jnp.asarray(theta), jnp.asarray(data), four_term=four,
                                 groups=groups, vmem_budget=jbudget)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    bank = tsr.build_shift_bank(torch.from_numpy(theta[0]), torch.from_numpy(data), four)
    mat = bank.materialize()
    dense = tref.vqc_fidelity_ref(ts, mat.theta, mat.data).reshape(bank.n_groups, 3)
    rows = list(groups) if groups is not None else list(range(bank.n_groups))
    got0 = K.vqc_shift_fidelity(ts, bank.theta, bank.data, four_term=four, groups=groups,
                                smem_budget=budget)
    np.testing.assert_allclose(torch.clamp(got0, 0, 1).numpy(), dense[rows].numpy(),
                               rtol=0, atol=ATOL)


def test_forward_plain_writes_boundaries_in_kernel_layout():
    """f0, the data state and each tile's boundary are the single sweep's
    states, stacked [tile][re/im][amp][sample]."""
    _, ts = _specs(7, 3)
    plan = K.build_shift_plan(ts)
    theta, data = (torch.from_numpy(a) for a in _angles(ts, 4, seed=3))
    tiles = ((0, 4), (4, 9), (9, 14))
    f0, d_state, bnd = K._shift_forward_plain(plan, [lo for lo, _ in tiles], theta, data)
    dim = 2**plan.m
    assert d_state.shape == (2 * dim, 4) and bnd.shape == (2 * len(tiles) * dim, 4)
    th, dt = theta.T, data.T
    re, im = K.zero_tile(dim, 4, "cpu")
    for k, op in enumerate(plan.train_ops):
        for t, (lo, _) in enumerate(tiles):
            if k == lo:
                assert torch.equal(bnd[2 * t * dim : (2 * t + 1) * dim], re)
                assert torch.equal(bnd[(2 * t + 1) * dim : (2 * t + 2) * dim], im)
        re, im = K.apply_one(op, re, im, plan.m, th, dt)
    assert torch.equal(f0, K._shiftbank_plain(plan, K.shift_values(False), (0,), ts.n_theta,
                                              theta, data)[0])


WORKERS = (1, 2, 4)


@pytest.mark.parametrize("qc", [5, 7, 9, 11, 13, 15, 17, 19, 21])
@pytest.mark.parametrize("nl", [1, 3])
@pytest.mark.parametrize("n_workers", WORKERS)
def test_footprint_fits_shared_memory(qc, nl, n_workers):
    """Every worker subset's launch fits 227 KB, and reports exactly what
    its table asks for: the single sweep's ``shift_geometry``, or the spill
    tile launch's ``spill_tiling`` and the forward launch's
    ``forward_geometry``."""
    _, ts = _specs(qc, nl)
    plan = K.build_shift_plan(ts)
    n_groups = 1 + 2 * ts.n_theta
    assignment = tdp.round_robin_assignment(n_groups, n_workers)
    for w in range(n_workers):
        groups = tuple(g for g in range(n_groups) if assignment[g] == w)
        info = K.shift_execution_info(ts, 576, groups=groups)
        tab = K._shift_route(ts, False, groups, K.SMEM_BUDGET_BYTES)
        assert 0 < info["smem_bytes"] <= K.SMEM_BUDGET_BYTES
        assert (info["tb"], info["smem_bytes"]) == (tab.tb, tab.smem_bytes)
        if info["mode"] == "fused":
            assert (tab.tb, tab.smem_bytes) == K.shift_geometry(
                plan, tab.n_ckpt[0], tab.n_variants)
            continue
        variants = K._collect_variants(plan, K.shift_values(False), groups, ts.n_theta)
        tiling = K.spill_tiling(plan, [k for k in variants if k >= 0], tab.n_variants)
        assert (tiling.tiles, tiling.tb, tiling.smem_bytes) == (tab.tiles, tab.tb, tab.smem_bytes)
        assert info["smem_bytes"] == K.walk_table_bytes(plan, tab.n_variants) + K.walk_smem_bytes(
            plan.m, max(tab.n_ckpt), info["tb"])
        assert (info["forward_tb"], info["forward_smem_bytes"]) == K.forward_geometry(
            plan, tab.n_variants)
        assert tab.tiles == info["tiles"] and tab.n_tiles == info["n_tiles"]
        assert info["tiles"][-1][1] == len(plan.train_ops)
        assert all(a[1] == b[0] for a, b in zip(info["tiles"], info["tiles"][1:]))


def test_route_follows_the_launch_block():
    """The route is decided from the launch's own block: 13q-3l fits a
    single-sweep block of SHIFT_WARPS samples on any number of workers
    (before the warp kernel it spilled on 1 and 2); 17q-3l on one worker
    fits 2; 21q-3l on 1 or 2 workers fits no single-sweep sample and spills;
    the spill pair runs up to m = 12 (25q-1l); from m = 13, where not one
    sample's tile states fit, the plan spills onto the device-memory walk
    (mode "spill" as the reference reports, route "dmem", no depth
    tiles)."""
    _, ts = _specs(13, 3)
    n_groups = 1 + 2 * ts.n_theta
    for n_workers in WORKERS:
        assignment = tdp.round_robin_assignment(n_groups, n_workers)
        groups = tuple(g for g in range(n_groups) if assignment[g] == 0)
        info = K.shift_execution_info(ts, 576, groups=groups)
        assert info["mode"] == "fused" and info["tb"] == K.SHIFT_WARPS
    _, wide = _specs(17, 3)
    info = K.shift_execution_info(wide, 100)
    want = "fused" if K.SWEEP_MIN_WARPS <= 2 else "spill"
    assert info["mode"] == want and info["tb"] == (2 if want == "fused" else K.SPILL_LAUNCH_WARPS)
    _, widest = _specs(21, 3)
    for groups in (None, tuple(range(0, 1 + 2 * widest.n_theta, 2))):
        info = K.shift_execution_info(widest, 100, groups=groups)
        assert info["mode"] == "spill" and info["n_tiles"] >= 5
    _, m12 = _specs(25, 1)
    info = K.shift_execution_info(m12, 8)
    assert (info["mode"], info["route"]) == ("spill", "pair")
    _, m13 = _specs(27, 1)
    info = K.shift_execution_info(m13, 8)
    assert (info["mode"], info["route"], info["n_tiles"]) == ("spill", "dmem", 0)
    assert info["launches"] == 1 and 0 < info["smem_bytes"] <= K.SMEM_BUDGET_BYTES


def test_no_block_holds_the_plan_raises():
    """A budget that holds no sample of either shared-memory route sends the
    plan to the device-memory walk (once refused), whose rows equal the
    single sweep's within 1e-6; a register under 3 qubits, which that route
    cannot chunk, still raises."""
    _, ts = _specs(7, 3)
    theta, data = (torch.from_numpy(a) for a in _angles(ts, 2, seed=0))
    tiny = 2 * K._state_bytes(3, 1)  # not one sample's tile kernel states
    gs = tuple(range(1 + 2 * ts.n_theta))
    assert K._shift_route(ts, False, gs, tiny).route == "dmem"
    got = K.vqc_shift_fidelity(ts, theta, data, smem_budget=tiny)
    want = K.vqc_shift_fidelity(ts, theta, data)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    _, narrow = _specs(5, 1)  # m = 2
    with pytest.raises(NotImplementedError, match="3 qubits or more"):
        K.vqc_shift_fidelity(narrow, *(torch.from_numpy(a) for a in _angles(narrow, 2, 0)),
                             smem_budget=64)


def test_launch_observer_reports_spill_tiles():
    _, ts = _specs(21, 3)  # m = 10: no single-sweep sample fits
    groups = tuple(range(0, 1 + 2 * ts.n_theta, 2))  # worker 0 of 2
    theta, data = (torch.from_numpy(a) for a in _angles(ts, 3, seed=4))
    seen = []
    prev = tops.set_launch_observer(seen.append)
    try:
        tops.vqc_fidelity_shiftgroups(ts, theta, data, False, groups)
    finally:
        tops.set_launch_observer(prev)
    summary, *tiles = seen
    assert summary["mode"] == "spill" and summary["launches"] == 2
    assert len(tiles) == summary["n_tiles"] >= 2
    assert [e["tile"] for e in tiles] == list(range(summary["n_tiles"] - 1, -1, -1))
    assert [e["ops"] for e in tiles] == list(reversed(summary["tiles"]))
    assert all(e["boundary_bytes"] == summary["spill_buffer_bytes"] for e in tiles)


def test_multibank_spilled_bit_identical_to_per_bank():
    _, ts = _specs(21, 3)
    groups = tuple(range(1, 1 + 2 * ts.n_theta, 2))  # worker 1 of 2: spills
    banks = []
    for i, b in enumerate((3, 5)):
        theta, data = _angles(ts, b, seed=20 + i)
        banks.append(tsr.build_shift_bank(torch.from_numpy(theta[0]), torch.from_numpy(data)))
    outs = tops.vqc_fidelity_shiftgroups_multibank(
        ts, tuple(b.theta for b in banks), tuple(b.data for b in banks), False, (groups, groups))
    for bank, out in zip(banks, outs):
        assert torch.equal(out, tops.vqc_fidelity_shiftgroups(ts, bank.theta, bank.data,
                                                               False, groups))


def _recording(run, declare, seen):
    def rec(*args):
        out = run(*args)
        seen.append(np.asarray(out))
        return out
    return declare(rec, shiftbank=True)


def test_13q_grad_shift_step_matches_reference():
    """One gradient step of 13-qubit, 3-layer QuClassi through the 2-worker
    implicit executor, port (the single sweep's plain version: each
    worker's checkpoints fit a block of SHIFT_WARPS samples) against
    reference.

    Fidelity rows agree to 1e-5.  Gradients carry the BCE chain factor
    1/(f(1-f)) (ROADMAP Queue 3, R2), so their tolerance is 1e-5 scaled by
    the largest chain factor of the step."""
    seg = dict(filter_width=4, stride=2, n_filters=4)
    jcfg = jq.QuClassiConfig(qc=13, n_layers=3, seg=jseg.SegmentationConfig(**seg))
    tcfg = tq.QuClassiConfig(qc=13, n_layers=3, seg=tseg.SegmentationConfig(**seg))
    x, y = jmnist.make_pair_dataset(1, 5, n_per_class=1, seed=0)
    n_groups = 1 + 2 * tcfg.n_theta
    assignment = tdp.round_robin_assignment(n_groups, 2)
    init = {k: np.asarray(v) for k, v in jq.init_params(jcfg, jax.random.PRNGKey(0)).items()}

    jrows, trows, modes = [], [], []
    jrun = _recording(jdp.worker_batched_executor(jcfg.spec, assignment, 2), jdeclare, jrows)
    trun = _recording(tdp.worker_batched_executor(tcfg.spec, assignment, 2), tdeclare, trows)
    jloss, jgrads, jf = jq.grad_shift(jcfg, {k: jnp.asarray(v) for k, v in init.items()},
                                      jnp.asarray(x), jnp.asarray(y), executor=jrun,
                                      implicit=True)
    prev = tops.set_launch_observer(lambda info: modes.append(info["mode"]))
    try:
        tloss, tgrads, tf = tq.grad_shift(tcfg, tq.params_from_numpy(init, "cpu"),
                                          torch.as_tensor(x), torch.as_tensor(y),
                                          executor=trun, implicit=True)
    finally:
        tops.set_launch_observer(prev)
    assert modes.count("fused") == 2 * tcfg.n_classes  # both workers, every class
    assert len(trows) == len(jrows) == tcfg.n_classes
    for t, j in zip(trows, jrows):
        assert t.shape == j.shape == (n_groups * 2 * tcfg.n_patches,)
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=ATOL)
    onehot = np.eye(tcfg.n_classes, dtype=np.float32)[y]
    chain = tfid.bce_grad_wrt_fidelity(torch.from_numpy(np.asarray(jf)), torch.from_numpy(onehot))
    tol = ATOL * max(1.0, float(chain.abs().max()))
    assert abs(float(tloss) - float(jloss)) <= tol
    for k in ("theta", "w", "b"):
        np.testing.assert_allclose(tgrads[k].numpy(), np.asarray(jgrads[k]), rtol=0, atol=tol)
