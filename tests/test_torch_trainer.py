"""The slice as a whole: the data plane's per-worker executors and
Algorithm-1 training, port against reference, on the CPU.

Both trainers start from the same weights: the reference's
``quclassi.init_params(cfg, PRNGKey(seed))`` (what its ``train(seed=seed)``
draws) handed to the port through ``params_from_numpy``, since torch cannot
reproduce jax's random stream.  Batches come from the same numpy pipeline.
Per-epoch losses agree to 1e-4: each batch loss is a BCE of float32
fidelities that agree to about 1e-6, and the weights they are taken at drift
apart only by lr times float32 gradient noise; accuracies (argmax of two
class fidelities) are equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.comanager import dataplane as jdp
from repro.core import quclassi as jq
from repro.core import trainer as jtrainer
from repro.core import circuits as jcircuits
from repro.core import shift_rule as jsr
from repro.data import mnist as jmnist
from repro_torch.comanager import dataplane as tdp
from repro_torch.core import circuits as tcircuits
from repro_torch.core import quclassi as tq
from repro_torch.core import shift_rule as tsr
from repro_torch.core import trainer as ttrainer
from repro_torch.kernels import ops as tops

ATOL = 1e-5


def _bank(spec, b, seed, four=False):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, np.pi, spec.n_theta).astype(np.float32)
    data = rng.uniform(0, np.pi, (b, spec.n_data)).astype(np.float32)
    return theta, data


@pytest.mark.parametrize("implicit", [False, True])
def test_worker_batched_executor_matches_reference(implicit):
    js = jcircuits.build_quclassi_circuit(5, 2)
    ts = tcircuits.build_quclassi_circuit(5, 2)
    theta, data = _bank(ts, 6, seed=1)
    jbuild = jsr.build_shift_bank if implicit else jsr.build_bank
    tbuild = tsr.build_shift_bank if implicit else tsr.build_bank
    jbank = jbuild(jax.numpy.asarray(theta), jax.numpy.asarray(data))
    tbank = tbuild(torch.from_numpy(theta), torch.from_numpy(data))
    n = tbank.n_groups if implicit else tbank.n_circuits
    assignment = list(np.random.default_rng(2).integers(0, 3, n))
    got = tsr.run_bank(tdp.worker_batched_executor(ts, assignment, 3), tbank)
    want = jsr.run_bank(jdp.worker_batched_executor(js, assignment, 3), jbank)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    # scheduling never changes the math: same rows as one fused launch
    one = tsr.run_bank(tdp.worker_batched_executor(ts, [0] * n, 1), tbank)
    assert torch.equal(got, one)


def test_worker_batched_executor_row_assignment_on_implicit_bank():
    ts = tcircuits.build_quclassi_circuit(5, 1)
    theta, data = _bank(ts, 4, seed=3)
    bank = tsr.build_shift_bank(torch.from_numpy(theta), torch.from_numpy(data))
    rows = tdp.round_robin_assignment(bank.n_circuits, 2)
    got = tdp.worker_batched_executor(ts, rows, 2)(bank)
    mat = bank.materialize()
    assert torch.equal(got, tops.vqc_fidelity(ts, mat.theta, mat.data))
    with pytest.raises(ValueError):
        tdp.worker_batched_executor(ts, [0, 1, 0], 2)(bank)
    assert tdp.round_robin_assignment(5, 2) == jdp.round_robin_assignment(5, 2)


def test_worker_multibank_executor_matches_per_bank():
    ts = tcircuits.build_quclassi_circuit(5, 2)
    banks = []
    for i, b in enumerate((3, 5)):
        theta, data = _bank(ts, b, seed=10 + i)
        banks.append(tsr.build_shift_bank(torch.from_numpy(theta), torch.from_numpy(data)))
    n = sum(b.n_groups for b in banks)
    run = tdp.worker_multibank_executor(ts, tdp.round_robin_assignment(n, 2), 2)
    for bank, flat in zip(banks, tsr.run_bank_set(run, banks)):
        assert torch.equal(flat, tops.vqc_fidelity_shiftbank(ts, bank.theta, bank.data))
    with pytest.raises(ValueError):
        run(banks[:1])


@pytest.mark.parametrize("bank_mode", ["implicit", "materialized"])
def test_training_epoch_matches_reference(bank_mode):
    jcfg, tcfg = jq.QuClassiConfig(qc=5, n_layers=1), tq.QuClassiConfig(qc=5, n_layers=1)
    seed, batch, workers = 1, 4, 2
    x, y = jmnist.make_pair_dataset(1, 5, n_per_class=8, seed=seed)
    train_set, test_set = jmnist.train_test_split(x, y)
    n_groups = 1 + 2 * tcfg.n_theta
    n = n_groups if bank_mode == "implicit" else batch * tcfg.n_patches * n_groups
    assignment = jdp.round_robin_assignment(n, workers)
    kw = dict(epochs=1, batch_size=batch, lr=0.05, bank_mode=bank_mode, seed=seed)
    want = jtrainer.train(jcfg, train_set, test_set,
                          executor=jdp.worker_batched_executor(jcfg.spec, assignment, workers),
                          **kw)
    init = jq.init_params(jcfg, jax.random.PRNGKey(seed))
    got = ttrainer.train(tcfg, train_set, test_set,
                         executor=tdp.worker_batched_executor(tcfg.spec, assignment, workers),
                         init_params=tq.params_from_numpy(
                             {k: np.asarray(v) for k, v in init.items()}, "cpu"),
                         device="cpu", **kw)
    (w,), (g,) = want.epochs, got.epochs
    assert abs(g.loss - w.loss) <= 1e-4
    assert g.train_accuracy == w.train_accuracy
    assert g.test_accuracy == w.test_accuracy
    assert g.circuits_executed == w.circuits_executed > 0
    for k in want.params:
        np.testing.assert_allclose(got.params[k].numpy(), np.asarray(want.params[k]),
                                   rtol=0, atol=1e-4)


def test_default_init_and_autodiff_mode_run_on_cpu():
    cfg = tq.QuClassiConfig(qc=5, n_layers=1)
    x, y = jmnist.make_pair_dataset(1, 5, n_per_class=4, seed=0)
    tr, te = jmnist.train_test_split(x, y)
    rep = ttrainer.train(cfg, tr, te, epochs=1, batch_size=2, grad_mode="autodiff",
                         device="cpu")
    assert np.isfinite(rep.epochs[0].loss) and rep.epochs[0].circuits_executed == 0
    with pytest.raises(ValueError):
        ttrainer.train(cfg, tr, te, bank_mode="lazy", device="cpu")


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tq.QuClassiConfig(qc=5, n_layers=1)
    x, y = jmnist.make_pair_dataset(1, 5, n_per_class=4, seed=0)
    tr, te = jmnist.train_test_split(x, y)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrainer.train(cfg, tr, te, epochs=1)  # the default device is the GPU
