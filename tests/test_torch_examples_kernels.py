"""The port's example programs that run circuits on the device
(``quickstart``, ``gateway_serving``, ``cluster_api``,
``failure_injection``) against the reference's scripts in ``examples/``,
on the CPU (the kernels' plain versions), on the same inputs.

``jax.random`` streams cannot be reproduced in torch (ROADMAP Queue 3 R3),
so the reference's draws are made here and handed to the port's scene
through its keyword (``theta=`` / ``params=``).  Reference scripts are
loaded by path; their scenes print, and the port's scene must print the
same lines, apart from wall-clock latencies and the last digits of a
float32 rounding gap.  Tolerances:
  * fidelities, losses and gradients: 1e-5 (float32, the reference's own
    kernel tolerance; the gradients' chain factor at these fidelities stays
    below 10, so R2's conditioning does not bite);
  * cost-model units and capability flags: equal.

For the duration of this file the reference's ``quclassi.class_fidelities``
runs under ``jax.jit`` (the same function, compiled once a shape): eagerly
it costs about 15 s a call on the CPU.
"""
import importlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ClusterConfig, QuantumCluster, ServingConfig
from repro.core import quclassi as rq
from repro.core import segmentation as rseg
from repro.core import shift_rule as rsr
from repro.data import mnist as rmnist
from repro.kernels import ops as rops
from repro_torch.core import quclassi as tq

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
CFG = rq.QuClassiConfig(qc=5, n_layers=1)
PROGRAMS = ["cluster_api", "distributed_training", "failure_injection", "federated_dql",
            "gateway_serving", "multitenant_serving", "quickstart", "scale_storm",
            "trace_demo", "transformer_train"]
KINDS = ["batched", "pooled", "multibank", "sharded", "mesh_spill"]


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


def _ref_params():
    """The reference's ``init_params(PRNGKey(0))`` -> (jax tree, port tensors)."""
    params = rq.init_params(CFG, jax.random.PRNGKey(0))
    return params, tq.params_from_numpy({k: np.asarray(v) for k, v in params.items()}, "cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)


def _grads_close(got: dict, want: dict):
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("name", PROGRAMS)
def test_cuda_request_without_cuda_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _port(name).main([])  # the default device is the GPU


def test_quickstart_matches_reference(capsys):
    _ref("quickstart").main()
    want = _lines(capsys)
    key = jax.random.PRNGKey(0)
    spec = CFG.spec
    theta = jax.random.uniform(key, (72, spec.n_theta)) * jnp.pi
    params, tparams = _ref_params()
    out = _port("quickstart").main(["--device", "cpu"], theta=torch.from_numpy(np.array(theta)),
                                   params=tparams)
    got = _lines(capsys)
    assert len(got) == len(want)
    for g, w in zip(got, want):  # the gap is a float32 rounding residue
        assert g.split("max grad gap")[0] == w.split("max grad gap")[0]
    x, y = rmnist.make_pair_dataset(1, 5, n_per_class=4, seed=0)
    patches = rseg.segment(jnp.asarray(x), CFG.seg)
    angles = patches.reshape(-1, 16)[:, :spec.n_data] * jnp.pi
    _close(out["fidelities"], rops.vqc_fidelity(spec, theta, angles))
    loss, grads, _ = rq.grad_shift(CFG, params, jnp.asarray(x), jnp.asarray(y))
    assert abs(out["loss_shift"] - float(loss)) <= TOL
    assert abs(out["loss_autodiff"] - float(loss)) <= TOL
    _grads_close(out["grads_shift"], grads)
    assert out["grad_gap"] <= 1e-4


def test_gateway_streaming_matches_reference(capsys):
    _ref("gateway_serving").streaming_demo()
    want = [line for line in _lines(capsys) if "p50=" not in line]  # wall-clock latencies
    out = _port("gateway_serving").streaming_demo("cpu")
    assert [line for line in _lines(capsys) if "p50=" not in line] == want
    assert [n for _, n, _ in out["batch_log"]] == [128, 64]
    rng = np.random.default_rng(0)
    rows = [(rng.uniform(0, np.pi, CFG.n_theta), rng.uniform(0, np.pi, CFG.n_angles))
            for _ in range(192)]
    theta, data = (jnp.asarray(np.stack(a), jnp.float32) for a in zip(*rows))
    _close(out["fidelities"], rops.vqc_fidelity(CFG.spec, theta, data))


def test_gateway_training_matches_reference(capsys):
    _ref("gateway_serving").training_demo()
    want = _lines(capsys)
    params, tparams = _ref_params()
    out = _port("gateway_serving").training_demo("cpu", params=tparams)
    got = _lines(capsys)
    assert got[0] == want[0] and got[-1] == want[-1]  # the title; launches and lane fill
    x, y = rmnist.make_pair_dataset(3, 9, n_per_class=8, seed=0)
    loss, grads, _ = rq.grad_shift(CFG, params, jnp.asarray(x[:4]), jnp.asarray(y[:4]))
    for key in ("loss_gateway", "loss_local"):
        assert abs(out[key] - float(loss)) <= TOL
    _grads_close(out["grads_gateway"], grads)
    _grads_close(out["grads_local"], grads)
    assert out["grad_diff"] <= TOL


@pytest.fixture(scope="module")
def cluster_run():
    """The port's ``cluster_api`` run once, from the reference's weights."""
    params, tparams = _ref_params()
    return _port("cluster_api").main(["--device", "cpu"], params=tparams), params


@pytest.mark.parametrize("kind", KINDS)
def test_cluster_api_backend_matches_reference(kind, cluster_run):
    """The reference's own ``sharded`` and ``mesh_spill`` runs fail under
    jax 0.9 (ROADMAP Queue 3 R1), so every family is held against the
    materialized bank through the reference's single-device kernel."""
    got = cluster_run[0]["backends"][kind]
    rng = np.random.default_rng(2)
    theta = jnp.asarray(rng.uniform(0, np.pi, CFG.n_theta), jnp.float32)
    data = jnp.asarray(rng.uniform(0, np.pi, (96, CFG.n_angles)), jnp.float32)
    bank = rsr.build_shift_bank(theta, data)
    mat = bank.materialize()
    _close(got["fidelities"], rops.vqc_fidelity(CFG.spec, mat.theta, mat.data))
    assert got["diff_vs_batched"] <= TOL
    config = ClusterConfig(serving=ServingConfig(target=128, deadline=0.25))
    with QuantumCluster(config) as cluster, cluster.backend(kind, CFG.spec) as be:
        caps, cm = be.capabilities(), be.cost_model()
        flags = "".join(c for c, on in zip("smxvp", (caps.shiftbank, caps.multibank,
                                                     caps.sharded, caps.vmem_model,
                                                     caps.mesh_spill)) if on)
        assert got["flags"] == flags
        assert got["implicit_units"] == cm.bank_cost_units(CFG.spec, bank) == 2560
        assert got["materialized_units"] == cm.bank_cost_units(CFG.spec, mat) == 10752


def test_cluster_api_session_gradient_matches_reference(cluster_run):
    out, params = cluster_run[0]["training"], cluster_run[1]
    assert out["diff"] == 0.0 and out["loss_session"] == out["loss_legacy"]
    assert torch.equal(out["grads_session"]["theta"], out["grads_legacy"]["theta"])
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.uniform(0, 1, (4, 8, 8)), jnp.float32)
    loss, grads, _ = rq.grad_shift(CFG, params, x, jnp.asarray([0, 1, 0, 1]))
    assert abs(out["loss_session"] - float(loss)) <= TOL
    _grads_close(out["grads_session"], grads)
    _close(out["grads_implicit"]["theta"], grads["theta"])


@pytest.mark.parametrize("scene,seed", [("crash_migration_demo", 0), ("flaky_retry_demo", 1),
                                        ("live_membership_demo", 2)])
def test_failure_scene_matches_reference(scene, seed, capsys):
    """The fleet's counters (failures, retries, migrations, ...) are printed,
    so equal lines mean equal counters."""
    ref = _ref("failure_injection")
    getattr(ref, scene)()
    want = _lines(capsys)
    out = getattr(_port("failure_injection"), scene)("cpu")
    assert _lines(capsys) == want
    theta, data = ref.rows(16, seed=seed)
    fids = rops.vqc_fidelity(ref.CFG.spec, theta, data)
    for got in out.get("waves", (out.get("fidelities"),)):
        _close(got, fids)
