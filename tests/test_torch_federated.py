"""The port's federated DQL (``repro_torch.federated``) against the
reference's (``repro.federated``).

Everything but the QuClassi helpers is numpy on the virtual clock, so a
numpy ``update_fn`` must give the reference's ``FederatedReport.summary()``
and final parameters bit for bit, under every round policy: quorum 1 and
quorum < n, a crashed tenant, late fold-in, secure aggregation, DP noise, a
NaN update and the staleness policy.  The QuClassi ``update_fn`` and
``eval_fn`` run the port's autodiff on the CPU from the reference's
parameters (torch cannot draw jax's random stream, ROADMAP Queue 3 R3):
deltas within 1e-5, accuracy equal.
"""
import importlib
import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.core import quclassi as jq
from repro.data import mnist as jmnist
from repro_torch.core import quclassi as tq

ATOL = 1e-5


def _ns(root: str) -> SimpleNamespace:
    fed = importlib.import_module(f"{root}.federated")
    return SimpleNamespace(
        fed=fed,
        WorkerConfig=importlib.import_module(f"{root}.comanager.worker").WorkerConfig,
        FaultSpec=importlib.import_module(f"{root}.comanager.faults").FaultSpec,
    )


REF, PORT = _ns("repro"), _ns("repro_torch")
PARAMS0 = {"theta": np.linspace(-1.0, 1.0, 12).reshape(3, 4), "phi": np.ones(5)}


def toy_update_fn(seed):
    def update_fn(tenant, round_idx, params):
        ent = [seed, round_idx] + [ord(c) for c in tenant]
        g = np.random.default_rng(np.random.SeedSequence(ent))
        return {k: 0.01 * g.standard_normal(np.shape(v)) for k, v in params.items()}

    return update_fn


def nan_update_fn(seed):
    """The toy update, but tenant ``t5b`` diverges in round 1."""
    base = toy_update_fn(seed)

    def update_fn(tenant, round_idx, params):
        upd = base(tenant, round_idx, params)
        if tenant == "t5b" and round_idx == 1:
            upd = {k: np.full(np.shape(v), np.nan) for k, v in upd.items()}
        return upd

    return update_fn


def fleet(ns):
    return [ns.WorkerConfig(f"w{i + 1}", q) for i, q in enumerate((5, 10, 15, 20))]


def fig6_tenants(ns, n_circuits=8):
    T = ns.fed.TenantSpec
    return [T("t5a", qc=5, n_layers=1, n_circuits=n_circuits),
            T("t5b", qc=5, n_layers=2, n_circuits=n_circuits),
            T("t7a", qc=7, n_layers=1, n_circuits=n_circuits),
            T("t7b", qc=7, n_layers=2, n_circuits=n_circuits)]


def fingerprint(report):
    return (
        json.dumps(report.summary(), sort_keys=True, default=float),
        tuple((k, report.params[k].tobytes()) for k in sorted(report.params)),
    )


# ---------------------------------------------------------- round scenarios
def _barrier(ns):
    cfg = ns.fed.FederatedConfig(n_rounds=3, seed=11, barrier=True)
    return ns.fed.run_federated(cfg, fig6_tenants(ns), toy_update_fn(11), PARAMS0,
                                fleet(ns), gateway=True)


def _quorum_one(ns):
    cfg = ns.fed.FederatedConfig(n_rounds=3, seed=11, barrier=False, quorum=1.0,
                                 round_deadline_s=1e5)
    return ns.fed.run_federated(cfg, fig6_tenants(ns), toy_update_fn(11), PARAMS0,
                                fleet(ns), gateway=True)


def _quorum_half(ns):
    cfg = ns.fed.FederatedConfig(n_rounds=3, quorum=0.5, seed=2)
    return ns.fed.run_federated(cfg, fig6_tenants(ns, 12), toy_update_fn(2), PARAMS0,
                                fleet(ns), gateway=True)


def _crashed_tenant(ns):
    T = ns.fed.TenantSpec
    tenants = [T("a", qc=5, n_circuits=8), T("b", qc=5, n_circuits=8),
               T("big", qc=7, n_circuits=8)]
    cfg = ns.fed.FederatedConfig(n_rounds=3, quorum=0.5, seed=3)
    return ns.fed.run_federated(
        cfg, tenants, toy_update_fn(3), PARAMS0,
        [ns.WorkerConfig("w1", 5), ns.WorkerConfig("w2", 10)], gateway=True,
        worker_failures={"w2": ns.FaultSpec(kind="crash", at=0.0)})


def _late_fold_in(ns):
    faults = {w: ns.FaultSpec(kind="slowdown", at=0.0, factor=10.0) for w in ("w2", "w3", "w4")}
    cfg = ns.fed.FederatedConfig(n_rounds=4, quorum=0.5, seed=7)
    return ns.fed.run_federated(cfg, fig6_tenants(ns, 16), toy_update_fn(7), PARAMS0,
                                fleet(ns), gateway=True, worker_failures=faults)


def _secure(ns):
    cfg = ns.fed.FederatedConfig(n_rounds=2, quorum=0.75, seed=5, secure_aggregation=True)
    return ns.fed.run_federated(cfg, fig6_tenants(ns), toy_update_fn(5), PARAMS0,
                                fleet(ns), gateway=True)


def _dp_noise(ns):
    cfg = ns.fed.FederatedConfig(n_rounds=3, quorum=0.75, seed=9,
                                 dp_noise_multiplier=1.5, dp_clip=0.05)
    return ns.fed.run_federated(cfg, fig6_tenants(ns), toy_update_fn(9), PARAMS0,
                                fleet(ns), gateway=True)


def _nan_update(ns):
    cfg = ns.fed.FederatedConfig(n_rounds=3, quorum=0.75, seed=4)
    return ns.fed.run_federated(cfg, fig6_tenants(ns), nan_update_fn(4), PARAMS0,
                                fleet(ns), gateway=True)


def _staleness(ns):
    faults = {w: ns.FaultSpec(kind="slowdown", at=0.0, factor=20.0) for w in ("w3", "w4")}
    cfg = ns.fed.FederatedConfig(n_rounds=5, quorum=0.5, seed=8, staleness_alpha=0.3,
                                 max_staleness=1)
    return ns.fed.run_federated(cfg, fig6_tenants(ns, 16), toy_update_fn(8), PARAMS0,
                                fleet(ns), gateway=True, worker_failures=faults)


def _no_gateway_drop_late(ns):
    cfg = ns.fed.FederatedConfig(n_rounds=3, quorum=0.5, seed=6, late_policy="drop")
    return ns.fed.run_federated(cfg, fig6_tenants(ns), toy_update_fn(6), PARAMS0,
                                fleet(ns), worker_failures={
                                    "w4": ns.FaultSpec(kind="slowdown", at=0.0, factor=8.0)})


SCENARIOS = {
    "barrier": _barrier,
    "quorum_one": _quorum_one,
    "quorum_half": _quorum_half,
    "crashed_tenant": _crashed_tenant,
    "late_fold_in": _late_fold_in,
    "secure_aggregation": _secure,
    "dp_noise": _dp_noise,
    "nan_update": _nan_update,
    "staleness_policy": _staleness,
    "no_gateway_drop_late": _no_gateway_drop_late,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_report_equals_reference(name):
    port, ref = SCENARIOS[name](PORT), SCENARIOS[name](REF)
    assert len(ref.rounds) > 0
    assert fingerprint(port) == fingerprint(ref)


def test_scenarios_exercise_their_paths():
    assert any(rec.folded for rec in _late_fold_in(PORT).rounds)
    crashed = _crashed_tenant(PORT)
    assert crashed.participation["big"]["participated"] == 0
    assert any(rec.nan_rejected for rec in _nan_update(PORT).rounds)
    assert _dp_noise(PORT).summary()["privacy"]["epsilon"] > 0


def test_late_fold_in_deterministic_double_run():
    assert fingerprint(_late_fold_in(PORT)) == fingerprint(_late_fold_in(PORT))


# ------------------------------------------------- coordinator, step by step
def _coordinator_steps(ns):
    """Secure aggregation, DP noise, a NaN update and late fold-in / drop
    through the clock-agnostic coordinator directly."""
    rng = np.random.default_rng(0)
    cfg = ns.fed.FederatedConfig(n_rounds=3, secure_aggregation=True, staleness_alpha=0.5,
                                 max_staleness=1, dp_noise_multiplier=0.5, dp_clip=1.0,
                                 seed=5)
    co = ns.fed.FederatedCoordinator(cfg, PARAMS0)
    log = []
    co.begin_round(0, 0.0, ["a", "b", "c", "bad"])
    for t in ("a", "b"):
        upd = {k: 0.1 * rng.standard_normal(np.shape(v)) for k, v in PARAMS0.items()}
        log.append(co.offer(t, upd, 0.5))
    log.append(co.offer("bad", {k: np.full(np.shape(v), np.nan) for k, v in PARAMS0.items()},
                        0.6))
    log.append(co.close_round(1.0).to_dict())
    ones = {k: np.ones(np.shape(v)) for k, v in PARAMS0.items()}
    log.append(co.offer_late("c", ones, 1.5, trained_round=0))
    co.begin_round(1, 2.0, ["a", "b", "c"])
    log.append(co.offer("a", {k: np.zeros(np.shape(v)) for k, v in PARAMS0.items()}, 2.1))
    log.append(co.close_round(3.0).to_dict())
    log.append(co.offer_late("c", ones, 3.5, trained_round=0))
    log.append(co.accountant.summary(1e-5))
    return json.dumps(log, sort_keys=True, default=float), co.params


def test_coordinator_steps_equal_reference():
    (plog, pparams), (rlog, rparams) = _coordinator_steps(PORT), _coordinator_steps(REF)
    assert plog == rlog
    for k in PARAMS0:
        assert pparams[k].tobytes() == rparams[k].tobytes()


@pytest.mark.parametrize("kw", [dict(quorum=0.0), dict(n_rounds=0), dict(late_policy="x"),
                                dict(staleness_alpha=1.5), dict(dp_noise_multiplier=-1.0),
                                dict(round_deadline_s=-1.0)])
def test_config_validation_messages_equal_reference(kw):
    msgs = []
    for ns in (PORT, REF):
        with pytest.raises(ValueError) as exc:
            ns.fed.FederatedConfig(**kw)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("n", [1, 3, 4])
def test_shard_dataset_equals_reference(n):
    x = np.arange(40 * 4, dtype=np.float32).reshape(40, 2, 2)
    y = np.arange(40) % 2
    names = [f"t{i}" for i in range(n)]
    p, r = PORT.fed.shard_dataset(x, y, names, seed=3), REF.fed.shard_dataset(x, y, names, seed=3)
    assert list(p) == list(r)
    for t in p:
        np.testing.assert_array_equal(p[t][0], r[t][0])
        np.testing.assert_array_equal(p[t][1], r[t][1])


# ------------------------------------------------------ QuClassi local steps
@pytest.fixture(scope="module")
def quclassi_case():
    jcfg, tcfg = jq.QuClassiConfig(qc=5, n_layers=1), tq.QuClassiConfig(qc=5, n_layers=1)
    x, y = jmnist.make_pair_dataset(3, 9, n_per_class=6, seed=1)
    params = {k: np.asarray(v, dtype=np.float64)
              for k, v in jq.init_params(jcfg, jax.random.PRNGKey(4)).items()}
    shards = REF.fed.shard_dataset(x[:8], y[:8], ["a", "b"], seed=2)
    return jcfg, tcfg, shards, params, (x[8:], y[8:])


@pytest.mark.parametrize("local_steps", [1, 2])
def test_quclassi_update_fn_matches_reference(quclassi_case, local_steps):
    jcfg, tcfg, shards, params, _ = quclassi_case
    ref = REF.fed.make_quclassi_update_fn(jcfg, shards, lr=0.1, local_steps=local_steps)
    port = PORT.fed.make_quclassi_update_fn(tcfg, shards, lr=0.1, local_steps=local_steps,
                                            device="cpu")
    for tenant in ("a", "b"):
        want, got = ref(tenant, 0, params), port(tenant, 0, params)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == np.float64 and got[k].shape == want[k].shape
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL)
        assert any(np.abs(got[k]).max() > 0 for k in got)


def test_quclassi_eval_fn_matches_reference(quclassi_case):
    jcfg, tcfg, _, params, eval_set = quclassi_case
    ref = REF.fed.make_quclassi_eval_fn(jcfg, eval_set)
    port = PORT.fed.make_quclassi_eval_fn(tcfg, eval_set, device="cpu")
    assert port(params) == ref(params)
