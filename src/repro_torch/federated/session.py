"""User-facing federated DQL session: QuClassi local training + the round
loop, wired to a ``QuantumCluster``.

``FederatedSession`` is what ``QuantumCluster.federated_session(...)``
returns: it carries the cluster's fleet + ``SimulationConfig`` into the
virtual-clock driver and keeps the resulting ``FederatedReport`` for
telemetry queries.  The QuClassi helpers build the deterministic local
``update_fn`` (a few steps of exact-gradient SGD on the tenant's shard) and
the per-round eval hook the accuracy-vs-rounds benchmark plots.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from repro_torch.federated.config import FederatedConfig
from repro_torch.federated.driver import TenantSpec, run_federated
from repro_torch.federated.rounds import FederatedReport, UpdateFn


def shard_dataset(
    images, labels, tenants: list[str], seed: int = 0
) -> dict[str, tuple]:
    """Deterministic near-even split of a dataset across tenants (each
    tenant's shard is its private local-training data)."""
    if not tenants:
        raise ValueError("need at least one tenant")
    rng = np.random.default_rng(np.random.SeedSequence([seed, len(tenants)]))
    perm = rng.permutation(len(images))
    parts = np.array_split(perm, len(tenants))
    return {
        t: (np.asarray(images)[idx], np.asarray(labels)[idx])
        for t, idx in zip(sorted(tenants), parts)
    }


def _on_device(x, y, device) -> tuple:
    """(images, labels) as float32 / int64 tensors on ``device``."""
    import torch

    return (
        torch.as_tensor(np.asarray(x, dtype=np.float32), device=device),
        torch.as_tensor(np.asarray(y, dtype=np.int64), device=device),
    )


def make_quclassi_update_fn(
    qcfg,
    shards: dict[str, tuple],
    *,
    lr: float = 0.1,
    local_steps: int = 1,
    device="cuda",
) -> UpdateFn:
    """Local-training closure for the round loop: ``local_steps`` of exact
    autodiff-gradient SGD on the tenant's shard, starting from the round's
    global parameters (cast to float32, as the reference's arrays are), on
    ``device``; returns the parameter DELTA tree in float64.  Deterministic
    in (tenant shard, round params) — exactly what the bit-determinism gate
    needs."""
    from repro_torch.core import quclassi

    on_device: dict[str, tuple] = {}

    def update_fn(tenant: str, round_idx: int, params: dict) -> dict:
        if tenant not in on_device:
            on_device[tenant] = _on_device(*shards[tenant], device)
        x, y = on_device[tenant]
        p = quclassi.params_from_numpy(params, device)
        for _ in range(local_steps):
            _, g, _ = quclassi.grad_autodiff(qcfg, p, x, y)
            p = {k: p[k] - lr * g[k] for k in p}
        return {
            k: p[k].detach().cpu().numpy().astype(np.float64)
            - np.asarray(params[k], dtype=np.float64)
            for k in params
        }

    return update_fn


def make_quclassi_eval_fn(qcfg, eval_set, *, device="cuda") -> Callable[[dict], float]:
    """Held-out accuracy of the global parameters after each round."""
    from repro_torch.core import quclassi

    x, y = _on_device(*eval_set, device)

    def eval_fn(params: dict) -> float:
        p = quclassi.params_from_numpy(params, device)
        return float(quclassi.accuracy(qcfg, p, x, y))

    return eval_fn


class FederatedSession:
    """One federated experiment bound to a cluster's fleet and simulation
    config.  ``run()`` executes the whole round loop on the virtual clock
    and returns (and retains) the ``FederatedReport``."""

    def __init__(
        self,
        cluster,
        config: FederatedConfig,
        tenants: list[TenantSpec],
        update_fn: UpdateFn,
        params0: dict,
        *,
        eval_fn: Optional[Callable[[dict], float]] = None,
        worker_failures: Optional[dict] = None,
        simulation=None,
    ):
        self.cluster = cluster
        self.config = config
        self.tenants = list(tenants)
        self.update_fn = update_fn
        self.params0 = params0
        self.eval_fn = eval_fn
        self.worker_failures = worker_failures
        self.simulation = simulation or cluster.config.simulation
        self.report: Optional[FederatedReport] = None

    def run(self) -> FederatedReport:
        kw = self.simulation.simulation_kwargs()
        self.report = run_federated(
            self.config,
            self.tenants,
            self.update_fn,
            self.params0,
            list(self.cluster.config.workers),
            eval_fn=self.eval_fn,
            worker_failures=self.worker_failures,
            **kw,
        )
        return self.report

    def telemetry(self) -> Optional[dict]:
        """The gateway telemetry summary of the finished run (federated
        participation counters under each tenant row, ``federated_rounds``
        at the top level), or None before ``run()`` / without a gateway."""
        if self.report is None or self.report.simulation is None:
            return None
        return self.report.simulation.gateway_summary

    def summary(self) -> Optional[dict]:
        """The finished run's ``FederatedReport.summary()``."""
        return None if self.report is None else self.report.summary()


__all__ = [
    "FederatedSession",
    "make_quclassi_eval_fn",
    "make_quclassi_update_fn",
    "shard_dataset",
]
