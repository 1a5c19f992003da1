"""``repro_torch.api`` — the public surface of the co-managed quantum system.

Two layers:

* ``ExecutionBackend`` protocol (``backend``): one capability-declaring
  contract over all five executor families (per-worker batched, pooled,
  multi-bank, mesh-sharded, whole-mesh spill), with adapters that remain
  drop-in legacy ``shift_rule.Executor`` callables.
* ``QuantumCluster`` / ``Session`` facade (``cluster``): typed configs
  (``ClusterConfig``, ``TenantPolicy``, ``ServingConfig``,
  ``SimulationConfig``) and per-tenant session handles that front the
  trainer, the sync/async serving gateways, and the virtual-clock
  simulation through one object.

Heavy submodules load lazily (PEP 562): ``repro_torch.core.shift_rule``
imports ``repro_torch.api.capabilities`` at module scope, while
``repro_torch.api.backend`` imports ``repro_torch.core.shift_rule`` — eager
package imports here would turn that into a partially-initialized-module
crash for anyone importing ``repro_torch.core.shift_rule`` first.
"""

from repro_torch.api.capabilities import (
    MATERIALIZED_ONLY,
    Capabilities,
    capabilities_of,
    declare,
)

_LAZY = {
    "BACKEND_KINDS": "repro_torch.api.backend",
    "BatchedWorkerBackend": "repro_torch.api.backend",
    "CallableBackend": "repro_torch.api.backend",
    "CostModel": "repro_torch.api.backend",
    "ExecutionBackend": "repro_torch.api.backend",
    "MeshSpillBackend": "repro_torch.api.backend",
    "MultibankWorkerBackend": "repro_torch.api.backend",
    "PooledWorkerBackend": "repro_torch.api.backend",
    "ShardedBackend": "repro_torch.api.backend",
    "as_backend": "repro_torch.api.backend",
    "make_backend": "repro_torch.api.backend",
    "ClusterConfig": "repro_torch.api.config",
    "FaultSpec": "repro_torch.comanager.faults",
    "FaultToleranceConfig": "repro_torch.comanager.faults",
    "FederatedConfig": "repro_torch.federated",
    "FederatedReport": "repro_torch.federated",
    "FederatedSession": "repro_torch.federated",
    "TenantSpec": "repro_torch.federated",
    "ObservabilityConfig": "repro_torch.obs.config",
    "ServingConfig": "repro_torch.api.config",
    "SimulationConfig": "repro_torch.api.config",
    "TenantPolicy": "repro_torch.api.config",
    "default_workers": "repro_torch.api.config",
    "QuantumCluster": "repro_torch.api.cluster",
    "Session": "repro_torch.api.cluster",
}

__all__ = sorted(
    [
        "Capabilities",
        "MATERIALIZED_ONLY",
        "capabilities_of",
        "declare",
        *_LAZY,
    ]
)


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)


def __dir__():
    return __all__
