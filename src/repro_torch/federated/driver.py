"""Virtual-clock federated round driver over ``SystemSimulation``.

This is where the round loop meets the multi-tenant runtime: each round,
every *free* tenant gets a local-training job (its round's circuit bank)
submitted into ONE shared simulation — through the serving gateway when the
simulation runs in gateway mode — and the coordinator observes per-tenant
update arrival times via ``SystemSimulation.job_callbacks``.  Rounds close
on quorum + deadline (or the sync barrier), late completions fold in with
the staleness discount, and the whole schedule composes with
``worker_failures`` fault schedules and arrival storms because it IS the
same event loop.

Determinism: local updates are computed eagerly (seeded numerics) at round
launch against the round's starting global parameters; the virtual clock
only decides WHEN each update is observed and whether it made quorum.
Timing and numerics are therefore independently deterministic, and the
whole run is bit-reproducible for a fixed seed.

Deadlines ride the ``ServiceModel`` EWMA: each tenant's observed
launch-to-arrival time updates an estimator keyed by its circuit family,
and a round's deadline is ``deadline_factor x`` the slowest participant's
estimate.  Round 0 bootstraps from the analytic per-circuit calibration
divided across the currently *healthy* workers (a fault schedule that has
already crashed a worker shrinks the denominator — the fleet-health
tie-in).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.comanager.simulation import SystemSimulation
from repro_torch.comanager.tenancy import JobSpec
from repro_torch.federated.config import FederatedConfig
from repro_torch.federated.rounds import FederatedCoordinator, FederatedReport, UpdateFn


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One federated tenant: its per-round local-training job shape and its
    scheduling contract in the shared gateway."""

    name: str
    qc: int = 5
    n_layers: int = 1
    n_circuits: int = 32  # circuits per round (the local-training bank)
    weight: float = 1.0
    priority: int = 1
    slo_ms: Optional[float] = None
    service_override: Optional[float] = None

    def __post_init__(self):
        if "@r" in self.name:
            raise ValueError(
                f"tenant name {self.name!r} may not contain '@r' (reserved "
                "for per-round job ids)"
            )
        if self.n_circuits < 1:
            raise ValueError(f"n_circuits must be >= 1, got {self.n_circuits}")

    def job(self, round_idx: int, submit_time: float) -> JobSpec:
        return JobSpec(
            client_id=f"{self.name}@r{round_idx}",
            qc=self.qc,
            n_layers=self.n_layers,
            n_circuits=self.n_circuits,
            submit_time=submit_time,
            service_override=self.service_override,
        )


def _split_job_id(cid: str) -> tuple[str, int]:
    name, r = cid.rsplit("@r", 1)
    return name, int(r)


class FederatedDriver:
    """Owns one ``SystemSimulation`` and one ``FederatedCoordinator`` and
    runs the round loop to completion on the virtual clock.  Use
    ``run_federated`` unless you need to poke at the pieces."""

    def __init__(
        self,
        config: FederatedConfig,
        tenants: list[TenantSpec],
        update_fn: UpdateFn,
        params0: dict,
        sim: SystemSimulation,
        *,
        eval_fn: Optional[Callable[[dict], float]] = None,
        telemetry=None,
    ):
        if not tenants:
            raise ValueError("need at least one tenant")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        self.config = config
        self.tenants = {t.name: t for t in tenants}
        self.update_fn = update_fn
        self.eval_fn = eval_fn
        self.sim = sim
        if telemetry is None and sim.gateway is not None:
            telemetry = sim.gateway.telemetry
        self.telemetry = telemetry
        self.coordinator = FederatedCoordinator(
            config,
            params0,
            weights={t.name: t.weight for t in tenants},
            telemetry=telemetry,
        )
        from repro_torch.serve.metrics import ServiceModel

        # driver-owned EWMA (same estimator class the gateway placement
        # rides), keyed by circuit family — kept separate from the
        # gateway's instance so round-level observations never perturb
        # batch-placement estimates.
        self.service = ServiceModel()
        self._seed_service_priors()
        # ---- round bookkeeping
        self._outstanding: dict[str, int] = {}  # tenant -> round in flight
        self._launched_at: dict[tuple[str, int], float] = {}
        self._updates: dict[tuple[str, int], dict] = {}  # eager local updates
        self._deferred_round: Optional[int] = None
        self._deadline_entry = None
        self.accuracy_by_round: list[float] = []
        self.finished = False
        sim.job_callbacks.append(self._on_job_done)
        sim.loop.on("fed_deadline", self._on_deadline)

    # ----------------------------------------------------------- estimates
    def _seed_service_priors(self) -> None:
        """Bootstrap the EWMA with the analytic calibration so round 0 has a
        deadline: bank seconds = n_circuits x per-circuit service time,
        spread across the workers healthy at t=0 (fault schedules that
        crash a worker before the start shrink the effective fleet)."""
        healthy = 0
        for wid in self.sim.workers:
            f = self.sim.failures.get(wid)
            if f is None or not f.crashed(0.0):
                healthy += 1
        healthy = max(healthy, 1)
        for t in self.tenants.values():
            key = ("fed", t.qc, t.n_layers)
            per_circuit = t.job(0, 0.0).service_time(self.sim.env)
            self.service.update(
                key, t.n_circuits, t.n_circuits * per_circuit / healthy
            )

    def _round_deadline(self, now: float, participants: list[str]) -> float | None:
        if self.config.barrier:
            return None
        if self.config.round_deadline_s is not None:
            return now + self.config.round_deadline_s
        slowest = max(
            self.service.estimate(
                ("fed", self.tenants[n].qc, self.tenants[n].n_layers),
                self.tenants[n].n_circuits,
            )
            for n in participants
        )
        # in gateway mode a bank can sit a full coalescer flush deadline
        # before anything executes — a pure service-time estimate would close
        # round 0 before the first batch even dispatched.
        floor = 0.0
        if self.sim.gateway is not None:
            floor = self.sim.gateway.coalescer.deadline
        return now + self.config.deadline_factor * (slowest + floor)

    # -------------------------------------------------------------- rounds
    def _launch_round(self, round_idx: int, now: float) -> bool:
        """Open round ``round_idx`` over the currently free tenants; False
        when every tenant is still busy straggling (the round is deferred
        until the next completion frees one)."""
        free = [n for n in self.tenants if n not in self._outstanding]
        if not free:
            return False
        # eager local updates against the round's starting global params:
        # numerics are fixed here; the clock only decides observation order.
        params = {k: np.array(v) for k, v in self.coordinator.params.items()}
        for name in free:
            self._updates[(name, round_idx)] = self.update_fn(
                name, round_idx, params
            )
        deadline = self._round_deadline(now, free)
        self.coordinator.begin_round(round_idx, now, free, deadline=deadline)
        for name in free:
            t = self.tenants[name]
            self._outstanding[name] = round_idx
            self._launched_at[(name, round_idx)] = now
            self.sim.submit_job(
                t.job(round_idx, now),
                weight=t.weight,
                priority=t.priority,
                slo_ms=t.slo_ms,
            )
        if deadline is not None:
            self._deadline_entry = self.sim.loop.schedule(
                deadline, "fed_deadline", round_idx
            )
        return True

    def _on_job_done(self, cid: str, t: float) -> None:
        if "@r" not in cid:
            return  # not a federated round job (shared simulation)
        name, r = _split_job_id(cid)
        if name not in self.tenants or self._outstanding.get(name) != r:
            return
        del self._outstanding[name]
        launched = self._launched_at.pop((name, r))
        spec = self.tenants[name]
        self.service.update(
            ("fed", spec.qc, spec.n_layers), spec.n_circuits, t - launched
        )
        update = self._updates.pop((name, r))
        co = self.coordinator
        if co.open and co.round_idx == r:
            co.offer(name, update, t)
            close = co.all_arrived() if self.config.barrier else co.quorum_reached()
            if close:
                self._close_round(t)
        else:
            # straggler: its round already closed — fold with the staleness
            # discount or drop, per config.
            co.offer_late(name, update, t, r)
        if self._deferred_round is not None and not co.open:
            if self._launch_round(self._deferred_round, t):
                self._deferred_round = None

    def _on_deadline(self, t: float, round_idx: int) -> None:
        co = self.coordinator
        if co.open and co.round_idx == round_idx:
            self._close_round(t)

    def _close_round(self, t: float) -> None:
        if self._deadline_entry is not None:
            self.sim.loop.cancel(self._deadline_entry)
            self._deadline_entry = None
        rec = self.coordinator.close_round(t)
        if self.eval_fn is not None:
            self.accuracy_by_round.append(
                float(self.eval_fn(self.coordinator.params))
            )
        nxt = rec.round_idx + 1
        if nxt >= self.config.n_rounds:
            self.finished = True
            # the experiment is over: stop the loop even though straggler
            # jobs (e.g. a tenant wedged on a crashed worker) would keep
            # heartbeat chains alive forever.
            self.sim.loop.stop()
            return
        if not self._launch_round(nxt, t):
            self._deferred_round = nxt

    # ----------------------------------------------------------------- run
    def run(self) -> FederatedReport:
        self.sim.start()
        self._launch_round(0, 0.0)
        self.sim.loop.run(until=self.config.max_sim_seconds)
        # stragglers that never reported by the end of the run
        for name in sorted(self._outstanding):
            self.coordinator.resolve_missing(name)
        sim_report = self.sim.finish()
        return self.coordinator.report(
            accuracy_by_round=self.accuracy_by_round,
            simulation=sim_report,
        )


def run_federated(
    config: FederatedConfig,
    tenants: list[TenantSpec],
    update_fn: UpdateFn,
    params0: dict,
    worker_cfgs,
    *,
    eval_fn: Optional[Callable[[dict], float]] = None,
    **sim_kwargs,
) -> FederatedReport:
    """One-call federated experiment on the virtual clock.

    ``update_fn(tenant, round_idx, global_params) -> delta tree`` computes a
    tenant's local update (must be deterministic — seed it on its inputs);
    ``sim_kwargs`` forward to ``SystemSimulation`` (gateway mode, fault
    schedules, observability, ...).  Per-tenant scheduling policy comes from
    each ``TenantSpec``, not the simulation's tenant maps (round job ids are
    created as the clock advances, so the closed-world maps cannot name
    them)."""
    for banned in ("jobs", "tenant_weights", "tenant_priorities", "tenant_slos_ms"):
        if banned in sim_kwargs:
            raise ValueError(
                f"{banned} is managed by the federated driver; configure "
                "tenants via TenantSpec"
            )
    sim_kwargs.setdefault("run_until", config.max_sim_seconds)
    sim = SystemSimulation(worker_cfgs, [], **sim_kwargs)
    driver = FederatedDriver(
        config, tenants, update_fn, params0, sim, eval_fn=eval_fn
    )
    return driver.run()


__all__ = ["FederatedDriver", "TenantSpec", "run_federated"]
