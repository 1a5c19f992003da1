"""The port's training example programs (``distributed_training``,
``federated_dql``'s scene 1, ``transformer_train``) against the
reference's scripts in ``examples/``, on the CPU, on the same inputs.

The reference's ``jax.random`` draws (ROADMAP Queue 3 R3) are made here
and handed to the port through the program's keyword (``params=`` /
``params0=``).  Tolerances:
  * one epoch of QuClassi training (Adam, lr 0.05): loss within 1e-4 (each
    batch loss is a BCE of float32 fidelities that agree to about 1e-6),
    accuracies and circuit counts equal, and the parameters within 1e-4
    where the reference's first-step gradient exceeds 1e-3 of its leaf's
    largest: a first Adam step is +-lr by the gradient's sign, so a
    gradient that rounding moves across 0 flips a parameter by 2 lr (R7);
  * federated rounds: update norms within 1e-4, accuracies equal;
  * the LM loop (float32, 2 layers): losses within 1e-4; the checkpoint
    round trip bit for bit.

For the duration of this file the reference's ``quclassi.class_fidelities``
runs under ``jax.jit`` (the same function, compiled once a shape): eagerly
it costs about 15 s a call on the CPU.
"""
import dataclasses
import importlib
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import api as rapi
from repro.checkpoint import checkpoint as rcheckpoint
from repro.configs import base as rbase
from repro.core import quclassi as rq
from repro.core import trainer as rtrainer
from repro.data import mnist as rmnist
from repro.data import pipeline as rpipeline
from repro.launch import steps as rsteps
from repro.models import transformer as rtransformer
from repro_torch import api as tapi
from repro_torch.configs import base
from repro_torch.core import quclassi as tq
from repro_torch.models import transformer

ROOT = Path(__file__).resolve().parents[1]
CFG = rq.QuClassiConfig(qc=5, n_layers=1)
LOSS_TOL = 1e-4
PARAM_TOL = 1e-4
ADAM_MASK = 1e-3  # R7
NORM_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def jitted_reference():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rq, "class_fidelities", jax.jit(rq.class_fidelities, static_argnums=0))
        yield


def _ref(name: str):
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name: str):
    return importlib.import_module(f"repro_torch.examples.{name}")


def _lines(capsys) -> list[str]:
    return capsys.readouterr().out.splitlines()


def _numpy(params: dict) -> dict:
    return {k: np.asarray(v) for k, v in params.items()}


def test_distributed_training_epoch_matches_reference(capsys):
    """One epoch of the reference's ``main`` (its co-Managed executor and
    ``train`` call) against the port's ``main --epochs 1``."""
    ref = _ref("distributed_training")
    x, y = rmnist.make_pair_dataset(1, 5, n_per_class=24, seed=0)
    (xtr, ytr), (xte, yte) = rmnist.train_test_split(x, y)
    n_bank = rq.total_bank_circuits(CFG, 8) // CFG.n_classes
    executor = ref.comanaged_executor(CFG, n_bank)
    want = rtrainer.train(CFG, (xtr, ytr), (xte, yte), epochs=1, batch_size=8, lr=0.05,
                          optimizer="adam", grad_mode="shift", executor=executor)
    spread = _lines(capsys)
    params = rq.init_params(CFG, jax.random.PRNGKey(0))  # what train(seed=0) draws
    out = _port("distributed_training").main(
        ["--device", "cpu", "--epochs", "1"],
        params=tq.params_from_numpy(_numpy(params), "cpu"))
    got = _lines(capsys)
    assert got[:2] == [f"task 1/5: {len(ytr)} train, {len(yte)} test images", *spread]
    assert spread == [f"  co-Manager spread {n_bank} circuits over workers: {out['spread']}"]
    (w,), (g,) = want.epochs, out["report"].epochs
    assert abs(g.loss - w.loss) <= LOSS_TOL
    for acc, n in (("train_accuracy", len(ytr)), ("test_accuracy", len(yte))):
        # equal counts of right answers (the float32 means round apart)
        assert round(getattr(g, acc) * n) == round(getattr(w, acc) * n)
    assert g.circuits_executed == w.circuits_executed == out["circuits"] > 0
    xb, yb = next(rpipeline.batches(xtr, ytr, 8, seed=0))  # the first step's batch
    _, g0, _ = rq.grad_shift(CFG, params, jnp.asarray(xb), jnp.asarray(yb))
    for k, ref_p in want.params.items():
        g_ref = np.abs(np.asarray(g0[k]))
        mask = g_ref > ADAM_MASK * g_ref.max()
        diff = np.abs(out["report"].params[k].numpy() - np.asarray(ref_p))
        assert mask.any() and diff[mask].max() <= PARAM_TOL, k


def test_federated_happy_path_matches_reference(capsys):
    want_rep = _ref("federated_dql").scene_1_happy_path(
        rapi.QuantumCluster(simulation=rapi.SimulationConfig(gateway=True)))
    want = _lines(capsys)
    params0 = _numpy(rq.init_params(CFG, jax.random.PRNGKey(0)))  # FederatedConfig(seed=0)
    got_rep = _port("federated_dql").scene_1_happy_path(
        tapi.QuantumCluster(simulation=tapi.SimulationConfig(gateway=True), device="cpu"),
        params0=params0)
    got = _lines(capsys)
    assert len(got) == len(want)
    for g, w in zip(got, want):  # the norms are compared below
        assert g.split("update norm")[0] == w.split("update norm")[0]
    assert got_rep.accuracy_by_round == want_rep.accuracy_by_round
    assert len(got_rep.rounds) == len(want_rep.rounds) == 2
    for g, w in zip(got_rep.rounds, want_rep.rounds):
        assert (g.on_time, g.participants, g.duration_s) == (w.on_time, w.participants,
                                                           w.duration_s)
        assert abs(g.update_norm - w.update_norm) <= NORM_TOL


@pytest.mark.parametrize("arch,batch", [("smollm-360m", 8), ("qwen3-4b", 3)])
def test_transformer_model_config_matches_reference(arch, batch):
    want = rbase.get(arch).with_(n_layers=8, vocab=8192, microbatch=max(1, batch // 2),
                                 dtype="float32", remat=False)
    cfg = _port("transformer_train").model_config(arch, batch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    shapes = jax.eval_shape(rtransformer.Model(want).init_params, jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    assert transformer.param_count(transformer.Model(cfg, device="meta")) == n_ref


def _overrides(batch: int) -> dict:
    """``model_config``'s overrides, for the reduced config (2 layers)."""
    return dict(microbatch=max(1, batch // 2), dtype="float32", remat=False)


def test_transformer_train_loop_matches_reference(capsys, tmp_path):
    arch, batch, seq, n_steps = "smollm-360m", 4, 16, 2
    rcfg = rbase.get(arch).reduced().with_(**_overrides(batch))
    cfg = base.get(arch).reduced().with_(**_overrides(batch))
    params = rtransformer.Model(rcfg).init_params(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    train_step, optimizer, _ = rsteps.make_train_step(rcfg, global_batch=batch)
    opt_state, step = optimizer.init(params), jax.jit(train_step)
    want = []
    for i in range(n_steps):
        tokens = rpipeline.synthetic_tokens(i, batch, seq, rcfg.vocab)
        params, opt_state, loss = step(params, opt_state, {"tokens": tokens})
        want.append(float(loss))

    tt = _port("transformer_train")
    model = transformer.Model(cfg, device="cpu")
    model.load_state_dict(transformer.params_from_numpy(cfg, tree))
    losses, tps = tt.train_loop(cfg, model, n_steps, batch, seq)
    np.testing.assert_allclose(losses, want, rtol=0, atol=LOSS_TOL)
    assert tps > 0 and len(_lines(capsys)) == n_steps  # step 0 and the last
    path = str(tmp_path / "ck.npz")
    same, meta = tt.checkpoint_round_trip(cfg, model, path, {"step": n_steps, "arch": arch})
    assert same and meta == {"step": n_steps, "arch": arch}
    # the reference restores the port's file into its own tree, bit for bit
    restored, _ = rcheckpoint.load(path, like=params)
    mine = transformer.params_to_numpy(cfg, model)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(mine)):
        assert np.array_equal(np.asarray(a), b)


def test_transformer_train_main_at_reduced_size(capsys, monkeypatch, tmp_path):
    """``main`` end to end on the reduced config: 40 steps, as the loss on
    uniform random tokens falls slowly towards ln(vocab) under step-to-step
    noise of about 0.1."""
    tt = _port("transformer_train")
    monkeypatch.setattr(tt, "model_config",
                        lambda arch, batch: base.get(arch).reduced().with_(**_overrides(batch)))
    path = tmp_path / "ck.npz"
    out = tt.main(["--device", "cpu", "--steps", "40", "--batch", "4", "--seq", "16",
                   "--ckpt", str(path)])
    lines = _lines(capsys)
    assert out["checkpoint_ok"] and not os.path.exists(path)
    assert out["losses"][-1] < out["losses"][0] and len(out["losses"]) == 40
    assert lines[-1] == "checkpoint round-trip at step 40: OK"
    assert lines[-2] == f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} over 40 steps"
    assert lines[0] == f"smollm-360m variant: 2L d=256 vocab=512 -> {out['params']/1e6:.1f}M params"
