"""The unified public API: one ``QuantumCluster``, per-tenant ``Session``
handles, and the ``ExecutionBackend`` protocol over every executor family.

Three scenes:
  1. two tenants with different ``TenantPolicy``s stream circuits through
     session handles and share coalesced kernel launches;
  2. a training session's gradients are BIT-IDENTICAL to the pre-redesign
     ``GatewayRuntime.executor`` path (the facade is a front, not a fork);
  3. the same ``ShiftBank`` runs through backend adapters and the cost
     model explains what each family charges.

Run:  PYTHONPATH=src python -m repro_torch.examples.cluster_api [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import ClusterConfig, QuantumCluster, ServingConfig, TenantPolicy
from repro_torch.core import quclassi, shift_rule
from repro_torch.core.quclassi import QuClassiConfig
from repro_torch.examples import arg_parser, parse


def _f32(a, device):
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def serving_demo(cluster, cfg) -> dict:
    print("=== tenant sessions: alice (tier 0, 500ms SLO) + bob (bulk) ===")
    dev = cluster.device
    alice = cluster.session("alice", TenantPolicy(priority=0, slo_ms=500.0, weight=2.0))
    bob = cluster.session("bob", TenantPolicy(priority=1))
    rng = np.random.default_rng(0)
    futures = []
    for _ in range(48):
        for sess in (alice, bob):
            theta = _f32(rng.uniform(0, np.pi, cfg.n_theta), dev)
            data = _f32(rng.uniform(0, np.pi, cfg.n_angles), dev)
            futures.append(sess.submit(cfg.spec, theta, data))
    alice.drain()
    assert all(f.done for f in futures)
    for sess in (alice, bob):
        t = sess.telemetry()
        print(f"  {sess.tenant:6s} completed={t['completed']} "
              f"p50={t['p50_latency_s']*1e3:.1f}ms")
    s = cluster.telemetry.summary()
    print(f"  {s['total_completed']} circuits in {s['batches']} launches, "
          f"lane fill {s['lane_fill']:.0%}")
    return {"summary": s, "fidelities": torch.stack([f.value for f in futures])}


def training_demo(cluster, cfg, *, params=None) -> dict:
    """``params`` replaces the seeded draw (the reference's is
    ``jax.random.PRNGKey(0)``)."""
    print("\n=== session.train path == pre-redesign gateway path, bit for bit ===")
    dev = cluster.device
    rng = np.random.default_rng(1)
    x = _f32(rng.uniform(0, 1, (4, 8, 8)), dev)
    y = torch.tensor([0, 1, 0, 1], device=dev)
    if params is None:
        params = quclassi.init_params(cfg, torch.Generator().manual_seed(0), dev)
    params = {k: v.to(dev, torch.float32) for k, v in params.items()}

    sess = cluster.session("trainer", bank_mode="materialized")
    loss_new, g_new, _ = quclassi.grad_shift(cfg, params, x, y,
                                             executor=sess.executor(cfg.spec))
    old = cluster.runtime.executor(cfg.spec, "trainer-legacy")
    loss_old, g_old, _ = quclassi.grad_shift(cfg, params, x, y, executor=old)
    diff = float((g_new["theta"] - g_old["theta"]).abs().max())
    assert diff == 0.0 and float(loss_new) == float(loss_old)
    print(f"  session grad == legacy gateway grad (max |diff| = {diff:.1f})")

    imp = cluster.session("trainer-imp")  # bank_mode auto -> implicit banks
    _, g_imp, _ = quclassi.grad_shift(cfg, params, x, y,
                                      executor=imp.executor(cfg.spec))
    err = float((g_imp["theta"] - g_old["theta"]).abs().max())
    print(f"  implicit shift-bank session matches to kernel tolerance "
          f"({err:.1e})")
    return {"loss_session": float(loss_new), "loss_legacy": float(loss_old),
            "grads_session": g_new, "grads_legacy": g_old, "grads_implicit": g_imp,
            "diff": diff, "implicit_err": err}


def backend_demo(cluster, cfg) -> dict:
    print("\n=== ExecutionBackend protocol over the executor families ===")
    dev = cluster.device
    rng = np.random.default_rng(2)
    theta = _f32(rng.uniform(0, np.pi, cfg.n_theta), dev)
    data = _f32(rng.uniform(0, np.pi, (96, cfg.n_angles)), dev)
    bank = shift_rule.build_shift_bank(theta, data)
    mat = bank.materialize()
    ref, out = None, {}
    for kind in ("batched", "pooled", "multibank", "sharded", "mesh_spill"):
        with cluster.backend(kind, cfg.spec) as be:
            fids = be.run_bank(bank).to(dev)
            if ref is None:
                ref = fids
            caps = be.capabilities()
            cm = be.cost_model()
            flags = "".join(
                c for c, on in zip("smxvp", (caps.shiftbank, caps.multibank,
                                             caps.sharded, caps.vmem_model,
                                             caps.mesh_spill)) if on)
            units = (cm.bank_cost_units(cfg.spec, bank), cm.bank_cost_units(cfg.spec, mat))
            gap = float((fids - ref).abs().max())
            print(f"  {kind:10s} caps[{flags:5s}] "
                  f"implicit {units[0]:8.0f} units "
                  f"vs materialized {units[1]:8.0f} "
                  f"(max |diff vs batched| = {gap:.1e})")
            out[kind] = {"fidelities": fids, "flags": flags, "implicit_units": units[0],
                         "materialized_units": units[1], "diff_vs_batched": gap}
    return out


def main(argv=None, *, params=None) -> dict:
    _, dev = parse(arg_parser(__doc__), argv)
    cfg = QuClassiConfig(qc=5, n_layers=1)
    config = ClusterConfig(serving=ServingConfig(target=128, deadline=0.25))
    with QuantumCluster(config, device=dev) as cluster:
        return {"serving": serving_demo(cluster, cfg),
                "training": training_demo(cluster, cfg, params=params),
                "backends": backend_demo(cluster, cfg)}


if __name__ == "__main__":
    main()
