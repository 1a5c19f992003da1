"""``QuantumCluster`` / ``Session``: the one tenant-facing entry point.

The paper's co-management story is ONE control plane placing any client's
circuits on any worker; this facade is its API counterpart — one object
(``QuantumCluster``) that owns the worker fleet, the serving gateway, the
execution backends, and the virtual-clock simulation, and one per-tenant
handle (``Session``) through which a client submits circuits, trains, and
reads its telemetry.  The same session object rides the synchronous
dispatcher, the async worker-pool runtime, and the virtual-clock
simulation, because all three consume the ``ExecutionBackend`` protocol
and the gateway's tenant registry underneath.

    cluster = QuantumCluster(ClusterConfig(serving=ServingConfig(mode="async")),
                             device="cuda")
    sess = cluster.session("alice", TenantPolicy(priority=0, slo_ms=500.0))
    fut = sess.submit(spec, theta, data)          # one circuit
    report = sess.train(qcfg, train_set, test_set)  # Algorithm 1, served
    print(sess.telemetry())

The device is a keyword of the cluster, not a ``ClusterConfig`` field, so
the config dataclasses stay the reference's: the card by default, the CPU
(the kernels' plain versions) when the caller asks for it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.api.backend import ExecutionBackend, make_backend
from repro_torch.api.config import ClusterConfig, TenantPolicy
from repro_torch.comanager.worker import WorkerConfig
from repro_torch.core.sim import CircuitSpec


class QuantumCluster:
    """Facade over the co-managed multi-tenant system.

    Lazily materializes a ``serve.GatewayRuntime`` (per its
    ``ServingConfig``) the first time real execution is needed, so
    simulation-only and backend-only uses never spin up serving threads.
    Context-manage it (or call ``close()``) to stop async runtimes.

    ``device``: where sessions train, where federated local updates run and
    where meshes of the sharded and mesh-spill backends live (``"cuda"`` by
    default; ``"cpu"`` runs the kernels' plain versions).  Submitted tensors
    run on their own device.
    """

    def __init__(self, config: ClusterConfig | None = None, *, device="cuda", **overrides):
        if config is None:
            config = ClusterConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.device = torch.device(device)
        self._runtime = None
        self._sessions: dict[str, "Session"] = {}

    # ------------------------------------------------------------ runtime
    @property
    def runtime(self):
        """The real-execution serving runtime (built on first use)."""
        if self._runtime is None:
            from repro_torch.serve.dispatcher import GatewayRuntime

            self._runtime = GatewayRuntime(
                list(self.config.workers),
                **self.config.serving.runtime_kwargs(),
            )
        return self._runtime

    @property
    def telemetry(self):
        return self.runtime.telemetry

    @property
    def fleet(self):
        """Per-worker health vitals (``serve.fleet.FleetHealth``) of the
        active dispatcher — state machine, failure rates, breaker trips."""
        return self.runtime.dispatcher.fleet

    def register_worker(self, worker: WorkerConfig) -> None:
        """Add a worker to the live runtime (new capacity is placeable on
        the next dispatch; the fleet's max width is re-derived)."""
        self.runtime.dispatcher.register_worker(worker)
        self.config = dataclasses.replace(
            self.config, workers=(*self.config.workers, worker)
        )

    def drain_worker(self, worker_id: str, timeout: float = 30.0) -> None:
        """Gracefully remove a worker: stop placing on it, wait for its
        in-flight batches, then forget it.  In-flight work elsewhere is
        untouched."""
        self.runtime.dispatcher.drain_worker(worker_id, timeout=timeout)
        self.config = dataclasses.replace(
            self.config,
            workers=tuple(
                w for w in self.config.workers if w.worker_id != worker_id
            ),
        )

    def close(self) -> None:
        if self._runtime is not None:
            self._runtime.close()
            self._runtime = None
        # a rebuilt runtime starts with an empty tenant registry: existing
        # handles must re-register (with their full policy) on next use, and
        # the session table resets so tenants can be reconfigured.
        for sess in self._sessions.values():
            sess._registered = False
        self._sessions.clear()

    def __enter__(self) -> "QuantumCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------- sessions
    def session(
        self,
        tenant: str,
        policy: TenantPolicy | None = None,
        *,
        bank_mode: str | None = None,
    ) -> "Session":
        """Open (or retrieve) the tenant's session handle.

        Omitted arguments mean "whatever the session already has" (new
        sessions default to ``TenantPolicy()`` and ``bank_mode='auto'``);
        re-opening an existing session with a DIFFERENT explicit policy or
        bank mode is an error — the gateway's scheduler state is
        per-tenant, not per-handle.  ``close()`` resets the table so
        tenants can be reconfigured."""
        if bank_mode not in (None, "auto", "implicit", "materialized"):
            raise ValueError(f"unknown bank_mode {bank_mode!r}")
        existing = self._sessions.get(tenant)
        if existing is not None:
            if (policy is not None and existing.policy != policy) or (
                bank_mode is not None and existing.bank_mode != bank_mode
            ):
                raise ValueError(
                    f"session {tenant!r} already open with a different "
                    f"policy/bank_mode; close the cluster to reconfigure"
                )
            return existing
        sess = Session(self, tenant, policy or TenantPolicy(), bank_mode or "auto")
        self._sessions[tenant] = sess
        return sess

    @property
    def policies(self) -> dict[str, TenantPolicy]:
        return {t: s.policy for t, s in self._sessions.items()}

    # ----------------------------------------------------------- backends
    def backend(self, kind: str, spec: CircuitSpec, **kw) -> ExecutionBackend:
        """Build one of the five executor-family adapters against this
        cluster's fleet (worker count defaults to the configured fleet; the
        sharded and mesh-spill meshes default to the cluster's device kind)."""
        if kind in ("batched", "pooled", "multibank"):
            kw.setdefault("n_workers", len(self.config.workers))
        elif kind in ("sharded", "mesh_spill"):
            kw.setdefault("device", self.device.type)
        return make_backend(kind, spec, **kw)

    # --------------------------------------------------------- simulation
    def simulate(
        self,
        jobs,
        *,
        worker_failures: dict | None = None,
        arrivals: dict | None = None,
        simulation=None,
    ):
        """Run the virtual-clock system simulation for ``jobs`` under this
        cluster's fleet and ``SimulationConfig``, with every open session's
        ``TenantPolicy`` forwarded to the gateway (weights, priorities,
        SLOs).  Returns the ``SimulationReport``."""
        from repro_torch.comanager.simulation import SystemSimulation

        sim_cfg = simulation or self.config.simulation
        policies = self.policies
        kw = sim_cfg.simulation_kwargs()
        if policies and kw.get("gateway"):
            # forward UNFILTERED: a session tenant absent from the submitted
            # jobs hits SystemSimulation's unknown-id validation instead of
            # silently losing its policy (the typo class this PR eliminates).
            kw["tenant_weights"] = {t: p.weight for t, p in policies.items()}
            kw["tenant_priorities"] = {t: p.priority for t, p in policies.items()}
            kw["tenant_slos_ms"] = {
                t: p.slo_ms for t, p in policies.items() if p.slo_ms is not None
            }
        sim = SystemSimulation(
            list(self.config.workers),
            list(jobs),
            worker_failures=worker_failures,
            arrivals=arrivals,
            **kw,
        )
        return sim.run()

    # ----------------------------------------------------------- federated
    def federated_session(
        self,
        tenants,
        config=None,
        *,
        update_fn=None,
        params0=None,
        qcfg=None,
        dataset=None,
        eval_set=None,
        lr: float = 0.1,
        local_steps: int = 1,
        worker_failures: dict | None = None,
        simulation=None,
    ):
        """Open a federated DQL session over this cluster's fleet
        (``repro_torch.federated``): per-tenant local training on private shards,
        gateway-side FedAvg rounds closing on quorum + deadline, on the
        virtual clock.

        ``tenants``: ``TenantSpec`` list, or plain names (default spec).
        Either pass ``update_fn`` + ``params0`` directly, or ``qcfg`` + a
        ``dataset`` ``(images, labels)`` — the dataset is then sharded
        deterministically across tenants and the local update is
        ``local_steps`` of exact-gradient SGD at ``lr`` (``eval_set`` adds
        per-round held-out accuracy).  Local updates and evaluation run on
        the cluster's device; ``params0`` is drawn from a ``torch.Generator``
        seeded with ``config.seed`` unless given.  Returns a
        ``FederatedSession``; call ``.run()`` for the ``FederatedReport``."""
        from repro_torch.federated import (
            FederatedConfig,
            FederatedSession,
            TenantSpec,
            make_quclassi_eval_fn,
            make_quclassi_update_fn,
            shard_dataset,
        )

        config = config or FederatedConfig()
        specs = [
            t if isinstance(t, TenantSpec) else TenantSpec(name=t)
            for t in tenants
        ]
        eval_fn = None
        if update_fn is None:
            if qcfg is None or dataset is None:
                raise ValueError(
                    "pass update_fn + params0, or qcfg + dataset to build "
                    "the QuClassi local-training update"
                )
            from repro_torch.core import quclassi

            shards = shard_dataset(
                dataset[0], dataset[1], [t.name for t in specs], seed=config.seed
            )
            update_fn = make_quclassi_update_fn(
                qcfg, shards, lr=lr, local_steps=local_steps, device=self.device
            )
            if params0 is None:
                gen = torch.Generator().manual_seed(config.seed)
                params0 = {
                    k: v.numpy() for k, v in quclassi.init_params(qcfg, gen).items()
                }
            if eval_set is not None:
                eval_fn = make_quclassi_eval_fn(qcfg, eval_set, device=self.device)
        elif params0 is None:
            raise ValueError("params0 is required with an explicit update_fn")
        return FederatedSession(
            self,
            config,
            specs,
            update_fn,
            params0,
            eval_fn=eval_fn,
            worker_failures=worker_failures,
            simulation=simulation,
        )


class Session:
    """One tenant's handle on the cluster: submit, train, observe.

    Created via ``QuantumCluster.session`` — constructing it registers the
    tenant (with its full ``TenantPolicy``) in the serving gateway the
    first time real execution is touched."""

    def __init__(
        self,
        cluster: QuantumCluster,
        tenant: str,
        policy: TenantPolicy,
        bank_mode: str,
    ):
        self.cluster = cluster
        self.tenant = tenant
        self.policy = policy
        self.bank_mode = bank_mode
        self._registered = False

    # ---------------------------------------------------------- plumbing
    def _gateway(self):
        gw = self.cluster.runtime.gateway
        if not self._registered:
            if self.tenant not in gw.tenants:
                gw.register_client(self.tenant, **self.policy.register_kwargs())
            self._registered = True
        return gw

    def executor(self, spec: CircuitSpec):
        """The gateway-backed ``shift_rule.Executor`` for this tenant.

        ``bank_mode='implicit'`` (or 'auto') returns the shift-aware
        executor: implicit banks enter as (param, shift) group subtasks
        and coalesce across tenants into fused multi-bank launches;
        'materialized' returns the per-row executor."""
        self._gateway()
        rt = self.cluster.runtime
        kw = dict(
            weight=self.policy.weight,
            priority=self.policy.priority,
            slo_ms=self.policy.slo_ms,
        )
        if self.bank_mode == "materialized":
            return rt.executor(spec, self.tenant, **kw)
        return rt.shift_executor(spec, self.tenant, **kw)

    # ----------------------------------------------------------- serving
    def submit(self, spec: CircuitSpec, theta, data):
        """Admit one circuit (``theta`` (P,), ``data`` (D,) tensors on the
        device it runs on); returns its ``CircuitFuture``.  Call ``drain()``
        (or keep submitting) to force partial batches out."""
        from repro_torch.serve.dispatcher import submit_origin

        gw = self._gateway()
        rt = self.cluster.runtime
        fut = gw.submit(
            self.tenant, spec, (theta, data), now=rt.dispatcher.clock(),
            origin=submit_origin(theta.device),
        )
        rt.dispatcher.kick()
        return fut

    def drain(self) -> int:
        """Flush partial coalescer buffers and run everything pending."""
        return self.cluster.runtime.dispatcher.drain()

    # ---------------------------------------------------------- training
    def train(self, qcfg, train_set, test_set, **train_kwargs):
        """Run Algorithm-1 training for this tenant through the cluster's
        serving runtime (``core.trainer.train`` with this session's policy
        and bank mode pre-wired, on the cluster's device unless
        ``device=`` is given)."""
        from repro_torch.core import trainer

        self._gateway()
        train_kwargs.setdefault("device", self.cluster.device)
        return trainer.train(
            qcfg,
            train_set,
            test_set,
            gateway=self.cluster.runtime,
            client_id=self.tenant,
            bank_mode=self.bank_mode,
            policy=self.policy,
            **train_kwargs,
        )

    # --------------------------------------------------------- telemetry
    def telemetry(self) -> Optional[dict]:
        """This tenant's slice of the gateway telemetry summary (latency
        percentiles, throughput, SLO attainment), or None before any
        completed work."""
        summary = self.cluster.runtime.telemetry.summary()
        for row in summary.get("tenants", []):
            if row.get("client") == self.tenant:
                return row
        return None

    def trace(self) -> list[dict]:
        """This tenant's finished circuit lifecycle records (oldest first):
        timestamped stage transitions submit -> ... -> complete/evict, the
        executing worker, and the outcome.  Empty when tracing is disabled
        (``ServingConfig.observability``) or nothing has finished yet; use
        ``cluster.telemetry.trace.export_chrome_trace(path)`` for the
        Perfetto view across all tenants."""
        return self.cluster.runtime.telemetry.trace.tenant_records(self.tenant)


__all__ = ["QuantumCluster", "Session"]
