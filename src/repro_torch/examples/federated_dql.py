"""Federated DQL demo: 4 tenants train one QuClassi model without sharing
data, through the serving gateway on the virtual clock.

Three scenes:
  1. the happy path — 4 tenants, private MNIST shards, quorum-0.75 rounds
     via ``QuantumCluster.federated_session`` (2 rounds, 4 tenants, quorum
     0.75, virtual clock), each tenant's local training on the device;
  2. stragglers — a 10x slowdown fault on the wide workers makes the 7q
     tenants late; quorum + deadline rounds keep the cadence while the
     sync barrier pays the full straggler tax, and late updates fold in
     with the staleness discount;
  3. privacy knobs — pairwise-mask secure aggregation (the server only
     ever sums masked updates) and Gaussian DP noise with the epsilon
     ledger.

Run:  PYTHONPATH=src python -m repro_torch.examples.federated_dql [--device cpu]
"""
from __future__ import annotations

import numpy as np

from repro_torch.api import (
    FederatedConfig,
    QuantumCluster,
    SimulationConfig,
    TenantSpec,
)
from repro_torch.comanager.faults import FaultSpec
from repro_torch.core.quclassi import QuClassiConfig
from repro_torch.data import mnist
from repro_torch.examples import arg_parser, parse


def scene_1_happy_path(cluster, *, params0=None):
    """``params0`` (numpy arrays) replaces the session's seeded draw (the
    reference's is ``jax.random.PRNGKey(config.seed)``)."""
    print("\n-- scene 1: 4 tenants, private shards, quorum-0.75 rounds")
    qcfg = QuClassiConfig(qc=5, n_layers=1)
    x, y = mnist.make_pair_dataset(3, 6, n_per_class=12, seed=0)
    (xtr, ytr), (xte, yte) = mnist.train_test_split(x, y)
    session = cluster.federated_session(
        ["alice", "bob", "carol", "dave"],
        FederatedConfig(n_rounds=2, quorum=0.75, seed=0),
        qcfg=qcfg,
        dataset=(xtr, ytr),
        eval_set=(xte, yte),
        params0=params0,
    )
    report = session.run()
    for rec in report.rounds:
        print(
            f"  round {rec.round_idx}: {len(rec.on_time)}/"
            f"{len(rec.participants)} on time in {rec.duration_s:.2f}s, "
            f"update norm {rec.update_norm:.4f}"
        )
    print(f"  accuracy by round: {[round(a, 3) for a in report.accuracy_by_round]}")
    tel = session.telemetry()
    rows = {r["client"]: r.get("federated") for r in tel["tenants"]}
    print(f"  gateway telemetry: rounds={tel['federated_rounds']}, "
          f"alice={rows['alice']}")
    return report


def scene_2_stragglers(device="cuda"):
    print("\n-- scene 2: slow wide workers -> quorum rounds vs sync barrier")
    from repro_torch.federated import run_federated

    params0 = {"theta": np.zeros((2, 8))}

    def update_fn(tenant, round_idx, params):
        g = np.random.default_rng(
            np.random.SeedSequence([round_idx] + [ord(c) for c in tenant])
        )
        return {k: 0.01 * g.standard_normal(np.shape(v))
                for k, v in params.items()}

    tenants = [
        TenantSpec("t5a", qc=5, n_layers=1, n_circuits=16),
        TenantSpec("t5b", qc=5, n_layers=2, n_circuits=16),
        TenantSpec("t7a", qc=7, n_layers=1, n_circuits=16),
        TenantSpec("t7b", qc=7, n_layers=2, n_circuits=16),
    ]
    faults = {
        w: FaultSpec(kind="slowdown", at=0.0, factor=10.0)
        for w in ("w2", "w3", "w4")
    }
    reports = {}
    for label, kw in (
        ("sync barrier", dict(barrier=True)),
        ("quorum 0.5  ", dict(quorum=0.5)),
    ):
        cfg = FederatedConfig(n_rounds=4, seed=7, **kw)
        rep = reports[label.strip()] = run_federated(
            cfg, tenants, update_fn, params0,
            list(QuantumCluster(device=device).config.workers),
            gateway=True, worker_failures=dict(faults),
        )
        late = sum(c["late"] for c in rep.participation.values())
        print(
            f"  {label}: {rep.rounds_per_second:.3f} rounds/s, "
            f"straggler wait share {rep.quorum_wait_share:.0%}, "
            f"{late} late fold-ins"
        )
    return reports


def scene_3_privacy():
    print("\n-- scene 3: secure aggregation + DP noise")
    from repro_torch.federated import FederatedCoordinator

    params0 = {"theta": np.zeros(16)}
    rng = np.random.default_rng(1)
    updates = {t: {"theta": 0.1 * rng.standard_normal(16)}
               for t in ("a", "b", "c", "d")}
    finals = {}
    for secure in (False, True):
        co = FederatedCoordinator(
            FederatedConfig(n_rounds=1, secure_aggregation=secure, seed=5),
            params0,
        )
        co.begin_round(0, 0.0, list(updates))
        for t, u in updates.items():
            co.offer(t, u, 0.5)
        co.close_round(1.0)
        finals[secure] = co.params["theta"]
    gap = float(np.abs(finals[True] - finals[False]).max())
    print(f"  masked vs plain FedAvg max |diff| = {gap:.1e} (masks cancel)")

    co = FederatedCoordinator(
        FederatedConfig(n_rounds=3, dp_noise_multiplier=1.0, dp_clip=1.0,
                        dp_delta=1e-5, seed=5),
        params0,
    )
    for r in range(3):
        co.begin_round(r, float(r), list(updates))
        for t, u in updates.items():
            co.offer(t, u, r + 0.5)
        co.close_round(r + 1.0)
    ledger = co.accountant.summary(1e-5)
    print(f"  DP ledger after 3 noisy rounds: {ledger}")
    return {"secure_gap": gap, "finals": finals, "dp_params": co.params, "ledger": ledger}


def main(argv=None, *, params0=None) -> dict:
    _, dev = parse(arg_parser(__doc__), argv)
    # gateway-mode simulation: rounds flow through the serving gateway, so
    # its telemetry carries the federated participation counters.
    cluster = QuantumCluster(simulation=SimulationConfig(gateway=True), device=dev)
    print(f"fleet: {[(w.worker_id, w.max_qubits) for w in cluster.config.workers]}")
    out = {"happy": scene_1_happy_path(cluster, params0=params0),
           "stragglers": scene_2_stragglers(dev), "privacy": scene_3_privacy()}
    print("\nfederated demo OK")
    return out


if __name__ == "__main__":
    main()
