"""The port's CUDA kernels on a GPU: each against its plain PyTorch version.

Marked ``requires_cuda``: each test skips (inside its fixture, never at
import) on a host without a CUDA device.  This file imports no JAX, so it
runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m requires_cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import circuits, quclassi, trainer
from repro_torch.data import mnist
from repro_torch.kernels import ops
from repro_torch.kernels import vqc_statevector as K

pytestmark = pytest.mark.requires_cuda
ATOL = 1e-5  # float32: other cos/sin and summation order than the plain version


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


@pytest.mark.parametrize("qc,nl,tied,budget_ckpts", [
    (13, 3, False, None),   # m = 6: the checkpoints need tiles at 227 KB
    (17, 1, False, None),   # m = 8: blocks of 16 samples
    (17, 3, False, None),
    (7, 3, True, 3),        # forced budget: multi-use replay spans tile
    (5, 3, True, 3),
])
@pytest.mark.parametrize("four", [False, True])
def test_spill_kernels_match_plain(cuda, qc, nl, tied, budget_ckpts, four):
    build = circuits.build_tied_quclassi_circuit if tied else circuits.build_quclassi_circuit
    spec = build(qc, nl)
    plan = K.build_shift_plan(spec)
    budget = (K.SMEM_BUDGET_BYTES if budget_ckpts is None
              else K.checkpoint_smem_bytes(plan, budget_ckpts, K.LANES))
    shifts = K.shift_values(four)
    n_groups = 1 + len(shifts) * spec.n_theta
    th, dt = _angles(spec, 100, cuda, seed=qc + nl)
    for groups in (tuple(range(n_groups)), tuple(range(1, n_groups, 2))):
        info = K.shift_execution_info(spec, 100, four_term=four, groups=groups,
                                      smem_budget=budget)
        assert info["mode"] == "spill" and info["smem_bytes"] <= K.SMEM_BUDGET_BYTES
        before = dict(K.LAUNCHES)
        got = K.vqc_shift_fidelity(spec, th, dt, four_term=four, groups=groups,
                                   smem_budget=budget)
        assert K.LAUNCHES["shift_forward"] == before["shift_forward"] + 1
        assert K.LAUNCHES["shift_tile"] == before["shift_tile"] + 1
        want = K._shift_spilled_plain(plan, shifts, groups, spec.n_theta, info["tiles"], th, dt)
        torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_unfit_shapes_raise_instead_of_running(cuda):
    wide = circuits.build_quclassi_circuit(13, 3)  # m = 6: runs as depth tiles
    th, dt = _angles(wide, 8, cuda)
    with pytest.raises(NotImplementedError, match="shared-memory budget"):
        K.vqc_shift_fidelity(wide, th, dt, smem_budget=2 * K._state_bytes(6, 1))
    big = circuits.build_quclassi_circuit(11, 1)  # 2**11 amplitudes: 16 KB a circuit
    th, dt = _angles(big, 8, cuda)
    with pytest.raises(NotImplementedError, match="shared-memory budget"):
        K.vqc_p0(big, th, dt)


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
