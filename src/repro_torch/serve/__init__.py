"""Online serving layer: streaming circuit submissions from many tenants
-> priority-tiered weighted-fair admission -> cross-tenant lane-aligned
coalescing (SLO-aware flush deadlines) -> co-Manager placement -> fused
CUDA kernel execution, synchronously inline or async on a worker pool
(one CUDA stream per slot).

See ``gateway`` (admission / priority tiers / SLOs / backpressure),
``coalescer`` (structure-keyed mega-batch packing), ``dispatcher``
(placement + inline execution + EWMA cost model), ``async_dispatcher``
(pump loop + per-worker execution slots, out-of-order futures), ``metrics``
(per-tenant latency / throughput / lane-fill / SLO-attainment telemetry),
``fleet`` (worker health states, circuit breaker, fault injection).
"""
from repro_torch.comanager.faults import FaultSpec, FaultToleranceConfig
from repro_torch.kernels.vqc_statevector import SMEM_BUDGET_BYTES
from repro_torch.serve.async_dispatcher import AsyncDispatcher
from repro_torch.serve.coalescer import LANES, CoalescedBatch, Coalescer, PendingCircuit
from repro_torch.serve.dispatcher import (
    Dispatcher,
    GatewayRuntime,
    ShiftGroupKey,
    bank_partition,
    batch_cost_units,
    batch_launch_info,
    batch_over_block,
    execute_batch,
    shift_admission_error,
)
from repro_torch.serve.fleet import (
    WORKER_STATES,
    FaultInjector,
    FleetHealth,
    InjectedWorkerFault,
    WorkerVitals,
)
from repro_torch.serve.gateway import (
    SLO_FLUSH_FRACTION,
    Backpressure,
    CircuitFuture,
    DeadlineExceeded,
    Gateway,
)
from repro_torch.serve.metrics import ServiceModel, Telemetry

__all__ = [
    "AsyncDispatcher",
    "Backpressure",
    "CircuitFuture",
    "CoalescedBatch",
    "Coalescer",
    "DeadlineExceeded",
    "Dispatcher",
    "FaultInjector",
    "FaultSpec",
    "FaultToleranceConfig",
    "FleetHealth",
    "Gateway",
    "GatewayRuntime",
    "InjectedWorkerFault",
    "LANES",
    "PendingCircuit",
    "ServiceModel",
    "ShiftGroupKey",
    "SLO_FLUSH_FRACTION",
    "SMEM_BUDGET_BYTES",
    "Telemetry",
    "WORKER_STATES",
    "WorkerVitals",
    "bank_partition",
    "batch_cost_units",
    "batch_launch_info",
    "batch_over_block",
    "execute_batch",
    "shift_admission_error",
]
