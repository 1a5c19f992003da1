"""Typed configuration for the tenant-session facade.

These dataclasses replace the kwarg piles that accreted on the old entry
points: ``TenantPolicy`` carries what ``Gateway.register_client`` /
``train(priority=, slo_ms=)`` took loose, ``ServingConfig`` what
``GatewayRuntime.__init__`` took loose, and ``SimulationConfig`` the
virtual-clock knobs of ``SystemSimulation``'s 19-kwarg ``__init__``.
``ClusterConfig`` bundles them with the worker fleet — one object that the
``QuantumCluster`` facade consumes for serving, training, and simulation
alike.  Validation happens at construction, so a typo fails where it is
written instead of deep inside a runtime.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.comanager.faults import FaultToleranceConfig
from repro_torch.comanager.worker import WorkerConfig
from repro_torch.obs.config import ObservabilityConfig

#: default heterogeneous fleet (matches the paper's 5/10/15/20-qubit
#: workers and GatewayRuntime's historical default).
DEFAULT_WORKER_QUBITS = (5, 10, 15, 20)


def default_workers() -> tuple[WorkerConfig, ...]:
    return tuple(
        WorkerConfig(f"w{i + 1}", q) for i, q in enumerate(DEFAULT_WORKER_QUBITS)
    )


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant scheduling contract.

    ``priority``: strict tier (lower = served strictly first).
    ``slo_ms``: end-to-end latency SLO; shortens coalescer flush deadlines
    and arms deadline-miss accounting.  ``weight``: weighted-fair share
    within the tier.  ``max_pending`` / ``max_in_flight``: backpressure
    bounds (None = gateway defaults).
    """

    priority: int = 1
    slo_ms: Optional[float] = None
    weight: float = 1.0
    max_pending: Optional[int] = None
    max_in_flight: Optional[int] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be positive, got {self.weight}")
        if self.slo_ms is not None and self.slo_ms <= 0:
            raise ValueError(f"slo_ms must be positive, got {self.slo_ms}")
        # the gateway treats 0 as "use the default", so bounds must be >= 1
        # (None = gateway default) — reject both 0 and negatives here.
        if self.max_pending is not None and self.max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {self.max_pending}")
        if self.max_in_flight is not None and self.max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1, got {self.max_in_flight}"
            )

    def register_kwargs(self) -> dict:
        """The ``Gateway.register_client`` keyword view of this policy."""
        kw = dict(weight=self.weight, priority=self.priority, slo_ms=self.slo_ms)
        if self.max_pending is not None:
            kw["max_pending"] = self.max_pending
        if self.max_in_flight is not None:
            kw["max_in_flight"] = self.max_in_flight
        return kw


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Real-execution serving runtime shape (was ``GatewayRuntime`` kwargs).

    ``mode``: "sync" (inline execution) or "async" (pump thread +
    per-worker execution slots).  ``target`` / ``deadline``: coalescer
    size trigger and flush deadline.  ``mesh_spill`` routes oversized
    batches to the whole-mesh executor; ``evict_over_slo`` (async only)
    sheds fully-expired batches with ``DeadlineExceeded``.
    """

    target: Optional[int] = None
    deadline: float = 1.0
    mode: str = "sync"
    slots_per_worker: int = 1
    mesh_spill: bool = True
    #: the reference's per-worker VMEM budget.  Kept as a field so a config
    #: carries across field for field, but only None is accepted: the card's
    #: memory model is per block (``serve.batch_over_block``).
    worker_vmem_bytes: Optional[int] = None
    evict_over_slo: bool = False
    #: global weighted-fair admission cap: total outstanding circuits
    #: (queued + in flight) across all tenants; above it, a tenant at or
    #: over its weighted share gets ``Backpressure`` at submit.  Calibrate
    #: at the throughput knee with ``repro_torch.scale.knee`` (None = never shed).
    max_system_pending: Optional[int] = None
    #: per-priority-tier outstanding caps (tier -> cap): bounds each tier's
    #: queued + in-flight circuits independently of the global cap, so a
    #: low-tier burst cannot consume a high tier's admission headroom;
    #: shedding is weighted-fair within the tier.  None = no tier caps.
    max_pending_per_tier: Optional[dict[int, int]] = None
    #: tracing + metrics knobs (None = trace everything at the defaults;
    #: ``ObservabilityConfig.disabled()`` turns the recorder off).
    observability: Optional[ObservabilityConfig] = None
    #: retry / migration / hedging / circuit-breaker knobs (None = the
    #: ``FaultToleranceConfig`` defaults: 1 in-place retry, no hedging,
    #: breaker trips after 3 consecutive failures).
    fault_tolerance: Optional[FaultToleranceConfig] = None

    def __post_init__(self):
        if self.mode not in ("sync", "async"):
            raise ValueError(
                f"mode must be 'sync' or 'async', got {self.mode!r}"
            )
        if self.evict_over_slo and self.mode != "async":
            raise ValueError(
                "evict_over_slo requires mode='async' (the sync dispatcher "
                "has no ready queue)"
            )
        if self.slots_per_worker < 1:
            raise ValueError(
                f"slots_per_worker must be >= 1, got {self.slots_per_worker}"
            )
        if self.max_system_pending is not None and self.max_system_pending < 1:
            raise ValueError(
                f"max_system_pending must be >= 1, got {self.max_system_pending}"
            )
        if self.max_pending_per_tier is not None:
            for tier, cap in self.max_pending_per_tier.items():
                if cap < 1:
                    raise ValueError(
                        f"max_pending_per_tier[{tier}] must be >= 1, got {cap}"
                    )
        if self.worker_vmem_bytes is not None:
            raise ValueError(
                f"worker_vmem_bytes={self.worker_vmem_bytes} has no counterpart "
                "on the card: its memory model is per block (a batch is over "
                "it when no block of its launch fits the 227 KB of shared "
                "memory, serve.batch_over_block), not a per-worker VMEM "
                "budget; leave worker_vmem_bytes as None"
            )
        if self.target is not None:
            # fail where the typo is written, not at first (lazy) runtime
            # construction deep inside the coalescer.  The lane width is the
            # serving layer's 128 (the reference's kernel tile), not the
            # kernels' warp of 32.
            from repro_torch.serve.coalescer import LANES

            if self.target <= 0 or self.target % LANES:
                raise ValueError(
                    f"target {self.target} must be a positive multiple of "
                    f"the kernel lane width {LANES}"
                )

    def runtime_kwargs(self) -> dict:
        """The ``GatewayRuntime`` keyword view of this config."""
        kw = dict(
            target=self.target,
            deadline=self.deadline,
            mode=self.mode,
            slots_per_worker=self.slots_per_worker,
            mesh_spill=self.mesh_spill,
            evict_over_slo=self.evict_over_slo,
            observability=self.observability,
            fault_tolerance=self.fault_tolerance,
        )
        if self.max_system_pending is not None:
            kw["max_system_pending"] = self.max_system_pending
        if self.max_pending_per_tier is not None:
            kw["max_pending_per_tier"] = dict(self.max_pending_per_tier)
        return kw


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """Virtual-clock runtime knobs (was ``SystemSimulation``'s kwarg pile).

    Field semantics are unchanged from ``SystemSimulation.__init__`` — see
    its docstring for the calibration notes; this object just makes the
    pile typed, defaulted, and reusable across runs.
    """

    env: str = "ibmq"
    tenancy: Optional[str] = None
    multi_tenant: bool = True
    policy: str = "cru"
    fidelity_floor: float = 0.0
    eager_completion: bool = True
    heartbeat_period: float = 5.0
    assign_latency: float = 0.01
    classical_overhead: float = 0.0
    lockstep: bool = False
    fair_queue: bool = False
    run_until: float = 1e7
    gateway: bool = False
    gateway_target: Optional[int] = None
    gateway_deadline: float = 1.0
    gateway_async: bool = False
    #: per-tenant admission queue bound (None = gateway default).
    gateway_max_pending: Optional[int] = None
    #: global weighted-fair outstanding cap — the knee-calibrated admission
    #: control (``repro_torch.scale.knee``); None = admit everything.
    gateway_max_system_pending: Optional[int] = None
    #: per-priority-tier outstanding caps (tier -> cap); None = no tier caps.
    gateway_max_pending_per_tier: Optional[dict[int, int]] = None
    #: gateway-mode tracing + metrics knobs (None = trace everything).
    observability: Optional[ObservabilityConfig] = None

    def __post_init__(self):
        if self.tenancy is not None and self.tenancy not in (
            "multi",
            "single_circuit",
            "user_exclusive",
        ):
            raise ValueError(f"unknown tenancy {self.tenancy!r}")
        if self.policy not in ("cru", "noise_aware"):
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.gateway_target is not None:
            from repro_torch.serve.coalescer import LANES  # serving lanes: 128

            if self.gateway_target <= 0 or self.gateway_target % LANES:
                raise ValueError(
                    f"gateway_target {self.gateway_target} must be a "
                    f"positive multiple of the kernel lane width {LANES}"
                )
        for name in ("gateway_max_pending", "gateway_max_system_pending"):
            value = getattr(self, name)
            if value is not None and value < 1:
                raise ValueError(f"{name} must be >= 1, got {value}")
        if self.gateway_max_pending_per_tier is not None:
            for tier, cap in self.gateway_max_pending_per_tier.items():
                if cap < 1:
                    raise ValueError(
                        f"gateway_max_pending_per_tier[{tier}] must be >= 1, "
                        f"got {cap}"
                    )

    def simulation_kwargs(self) -> dict:
        """The ``SystemSimulation`` keyword view of this config.

        Shallow on purpose: ``dataclasses.asdict`` would deep-convert the
        nested ``ObservabilityConfig`` into a plain dict, and the simulation
        passes it through to the trace recorder as the typed object."""
        return {
            f.name: getattr(self, f.name) for f in dataclasses.fields(self)
        }


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """One typed object describing the whole co-managed system: the worker
    fleet plus the serving and simulation runtime shapes."""

    workers: tuple[WorkerConfig, ...] = dataclasses.field(
        default_factory=default_workers
    )
    serving: ServingConfig = ServingConfig()
    simulation: SimulationConfig = SimulationConfig()

    def __post_init__(self):
        if not self.workers:
            raise ValueError("a cluster needs at least one worker")
        ids = [w.worker_id for w in self.workers]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate worker ids in {ids}")
        # tolerate lists at the call site; store the canonical tuple
        if not isinstance(self.workers, tuple):
            object.__setattr__(self, "workers", tuple(self.workers))

    @classmethod
    def homogeneous(
        cls, n_workers: int, max_qubits: int, *, serving=None, simulation=None, **kw
    ) -> "ClusterConfig":
        workers = tuple(
            WorkerConfig(f"w{i + 1}", max_qubits, **kw) for i in range(n_workers)
        )
        return cls(
            workers=workers,
            serving=serving or ServingConfig(),
            simulation=simulation or SimulationConfig(),
        )


__all__ = [
    "ClusterConfig",
    "DEFAULT_WORKER_QUBITS",
    "ServingConfig",
    "SimulationConfig",
    "TenantPolicy",
    "default_workers",
]
