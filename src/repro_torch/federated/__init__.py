"""repro_torch.federated — round-based federated DQL over the multi-tenant stack.

The paper's loop (distributed quantum workers execute subtasks, results
loop back to the classical side for the next iteration) generalized to
federated learning: per-tenant local training on private shards, gateway-
side FedAvg aggregation, rounds closing on quorum + deadline instead of a
sync barrier, FedAsync-style staleness fold-in for stragglers, optional
pairwise-mask secure aggregation and Gaussian DP noise.

Layering:
  * ``config``  — ``FederatedConfig``: the typed knob surface.
  * ``secure``  — canceling pairwise masks, DP noise, epsilon stub.
  * ``rounds``  — ``FederatedCoordinator``: the clock-agnostic round state
    machine, ``RoundRecord`` / ``FederatedReport``.
  * ``driver``  — the virtual-clock driver over ``SystemSimulation``
    (composes with fault schedules and arrival storms).
  * ``session`` — ``FederatedSession`` + QuClassi local-training helpers;
    the ``QuantumCluster.federated_session`` surface.
"""
from repro_torch.federated.config import FederatedConfig
from repro_torch.federated.driver import FederatedDriver, TenantSpec, run_federated
from repro_torch.federated.rounds import (
    FederatedCoordinator,
    FederatedReport,
    RoundRecord,
    fedavg,
)
from repro_torch.federated.secure import (
    PrivacyAccountant,
    gaussian_noise,
    pairwise_masks,
)
from repro_torch.federated.session import (
    FederatedSession,
    make_quclassi_eval_fn,
    make_quclassi_update_fn,
    shard_dataset,
)

__all__ = [
    "FederatedConfig",
    "FederatedCoordinator",
    "FederatedDriver",
    "FederatedReport",
    "FederatedSession",
    "PrivacyAccountant",
    "RoundRecord",
    "TenantSpec",
    "fedavg",
    "gaussian_noise",
    "make_quclassi_eval_fn",
    "make_quclassi_update_fn",
    "pairwise_masks",
    "run_federated",
    "shard_dataset",
]
