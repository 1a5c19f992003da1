"""Online serving gateway demo: streaming circuits from concurrent tenants
are coalesced across clients into lane-aligned mega-batches, placed by the
co-Manager, and executed on the fidelity kernel — then the same gateway
drives a real QuClassi training step, and the async runtime overlaps kernel
execution across per-worker slots with priority tiers and latency SLOs.

Run:  PYTHONPATH=src python -m repro_torch.examples.gateway_serving [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import quclassi
from repro_torch.core.quclassi import QuClassiConfig
from repro_torch.data import mnist
from repro_torch.examples import arg_parser, parse
from repro_torch.serve import GatewayRuntime


def _row(rng, cfg, device):
    theta = torch.as_tensor(rng.uniform(0, np.pi, cfg.n_theta), dtype=torch.float32,
                            device=device)
    data = torch.as_tensor(rng.uniform(0, np.pi, cfg.n_angles), dtype=torch.float32,
                           device=device)
    return theta, data


def streaming_demo(device) -> dict:
    """Two tenants submit interleaved; their circuits share kernel batches."""
    print("=== cross-tenant coalescing: alice + bob share mega-batches ===")
    cfg = QuClassiConfig(qc=5, n_layers=1)
    rt = GatewayRuntime(target=128, deadline=0.25)
    rt.gateway.register_client("alice", weight=2.0)   # alice paid for 2x share
    rt.gateway.register_client("bob", weight=1.0)

    rng = np.random.default_rng(0)
    futures = []
    now = rt.dispatcher.clock
    for i in range(96):                      # interleaved open-loop streams
        for cid in ("alice", "bob"):
            futures.append(rt.gateway.submit(cid, cfg.spec, _row(rng, cfg, device), now()))
    rt.dispatcher.drain()

    for wid, n, clients in rt.dispatcher.batch_log:
        print(f"  batch of {n:3d} circuits -> {wid}  tenants={clients}")
    s = rt.telemetry.summary()
    print(f"  lane fill {s['lane_fill']:.0%}, "
          f"{s['total_completed']} circuits in {s['batches']} kernel launches")
    for t in s["tenants"]:
        print(f"  {t['client']:6s} p50={t['p50_latency_s']*1e3:.1f}ms "
              f"p99={t['p99_latency_s']*1e3:.1f}ms")
    assert all(f.done for f in futures)
    return {"batch_log": list(rt.dispatcher.batch_log), "summary": s,
            "fidelities": torch.stack([f.value for f in futures])}


def training_demo(device, *, params=None) -> dict:
    """QuClassi training drives the real kernel through the gateway.
    ``params`` replaces the seeded draw (the reference's is
    ``jax.random.PRNGKey(0)``)."""
    print("\n=== gateway-backed training (grad_shift via serve/) ===")
    cfg = QuClassiConfig(qc=5, n_layers=1)
    x, y = mnist.make_pair_dataset(3, 9, n_per_class=8, seed=0)
    x, y = torch.as_tensor(x[:4], device=device), torch.as_tensor(y[:4], device=device)
    if params is None:
        params = quclassi.init_params(cfg, torch.Generator().manual_seed(0), device)
    params = {k: v.to(device, torch.float32) for k, v in params.items()}

    rt = GatewayRuntime(target=128, deadline=0.5)
    ex = rt.executor(cfg.spec, "trainer")
    loss_gw, g_gw, _ = quclassi.grad_shift(cfg, params, x, y, executor=ex)
    loss_local, g_local, _ = quclassi.grad_shift(cfg, params, x, y)
    err = float((g_gw["theta"] - g_local["theta"]).abs().max())
    print(f"  loss via gateway {float(loss_gw):.6f} == local {float(loss_local):.6f}")
    print(f"  max |grad diff| = {err:.2e} (scheduling never changes the math)")
    print(f"  kernel launches: {len(rt.dispatcher.batch_log)}, "
          f"lane fill {rt.telemetry.lane_fill:.0%}")
    return {"loss_gateway": float(loss_gw), "loss_local": float(loss_local),
            "grads_gateway": g_gw, "grads_local": g_local, "grad_diff": err,
            "launches": len(rt.dispatcher.batch_log)}


def async_demo(device) -> dict:
    """The async runtime: a tier-0 interactive tenant with a tight SLO rides
    the same worker pool as a tier-1 bulk tenant; batches execute on worker
    slots while admission continues, and futures resolve out of order."""
    print("\n=== async dispatcher: priority tiers + SLOs on a worker pool ===")
    cfg = QuClassiConfig(qc=5, n_layers=1)
    rng = np.random.default_rng(1)
    with GatewayRuntime(target=128, deadline=0.1, mode="async",
                        slots_per_worker=2) as rt:
        rt.gateway.register_client("bulk", priority=1)
        rt.gateway.register_client("interactive", priority=0, slo_ms=500.0)
        now = rt.dispatcher.clock
        futures = []
        for i in range(192):
            cid = "interactive" if i % 3 == 0 else "bulk"
            futures.append(rt.gateway.submit(cid, cfg.spec, _row(rng, cfg, device), now()))
            rt.dispatcher.kick()
        rt.dispatcher.drain()
        assert all(f.done for f in futures)
        s = rt.telemetry.summary()
        for t in s["tenants"]:
            slo = (f" slo_attainment={t['slo_attainment']:.0%}"
                   if "slo_attainment" in t else "")
            print(f"  {t['client']:12s} p50={t['p50_latency_s']*1e3:.1f}ms "
                  f"p99={t['p99_latency_s']*1e3:.1f}ms{slo}")
        print(f"  {s['total_completed']} circuits in {s['batches']} launches, "
              f"lane fill {s['lane_fill']:.0%}")
    return {"summary": s, "fidelities": torch.stack([f.value for f in futures])}


def main(argv=None, *, params=None) -> dict:
    _, dev = parse(arg_parser(__doc__), argv)
    return {"streaming": streaming_demo(dev), "training": training_demo(dev, params=params),
            "async": async_demo(dev)}


if __name__ == "__main__":
    main()
