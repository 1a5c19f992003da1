"""Typed configuration for the federated DQL subsystem.

``FederatedConfig`` is the one knob surface for the round loop: how many
rounds, when a round closes (quorum fraction + deadline, or a full sync
barrier), what happens to stragglers (FedAsync-style staleness fold-in vs
drop), and the privacy options (pairwise-mask secure aggregation, Gaussian
DP noise).  Validation happens at construction, mirroring the other
``repro_torch.api`` config dataclasses.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FederatedConfig:
    """Round-loop knobs for ``FederatedCoordinator`` / the virtual-clock
    driver.

    ``n_rounds``: aggregation rounds to run.
    ``quorum``: fraction of a round's launched participants whose updates
    must arrive before the round may close early (the round still closes at
    its deadline with whoever arrived).  ``quorum=1.0`` waits for everyone
    until the deadline.
    ``barrier``: sync-barrier mode — the round closes only when EVERY
    launched participant has reported, ignoring quorum and deadline (the
    baseline the quorum path is benchmarked against).
    ``round_deadline_s``: explicit per-round deadline; ``None`` derives one
    as ``deadline_factor x`` the slowest participant's EWMA service-time
    estimate (``ServiceModel``, bootstrapped from the analytic per-circuit
    calibration over the currently-healthy worker count).
    ``late_policy``: ``"fold"`` folds a late update into the next round's
    aggregate with weight ``staleness_alpha ** rounds_late`` (FedAsync-style
    discount), dropping it once ``rounds_late > max_staleness``; ``"drop"``
    discards every late update.
    ``weighted``: weighted FedAvg — each tenant's update is weighted by its
    configured tenant weight (shard size by default in the session layer)
    instead of uniformly.
    ``secure_aggregation``: pairwise seeded masks that cancel in the sum, so
    the aggregator only ever observes the masked total (``repro_torch.federated
    .secure``).  ``dp_noise_multiplier``: Gaussian noise scale (in units of
    ``dp_clip``) added to the aggregate; > 0 requires ``dp_clip``, the
    per-update L2 clipping bound.  ``dp_delta``: the delta the
    epsilon-accounting stub reports epsilon at.
    ``seed``: master seed for masks/noise (local-update seeds belong to the
    session layer).
    ``max_sim_seconds``: virtual-clock budget for the whole experiment —
    the driver stops a run whose rounds cannot make progress (e.g. every
    tenant wedged on crashed workers) instead of spinning heartbeats
    forever.
    """

    n_rounds: int = 5
    quorum: float = 0.75
    barrier: bool = False
    round_deadline_s: float | None = None
    deadline_factor: float = 3.0
    late_policy: str = "fold"
    staleness_alpha: float = 0.5
    max_staleness: int = 2
    weighted: bool = False
    secure_aggregation: bool = False
    dp_noise_multiplier: float = 0.0
    dp_clip: float | None = None
    dp_delta: float = 1e-5
    seed: int = 0
    max_sim_seconds: float = 1e6

    def __post_init__(self):
        if self.n_rounds < 1:
            raise ValueError(f"n_rounds must be >= 1, got {self.n_rounds}")
        if not 0.0 < self.quorum <= 1.0:
            raise ValueError(f"quorum must be in (0, 1], got {self.quorum}")
        if self.round_deadline_s is not None and self.round_deadline_s <= 0:
            raise ValueError(
                f"round_deadline_s must be > 0, got {self.round_deadline_s}"
            )
        if self.deadline_factor <= 0:
            raise ValueError(
                f"deadline_factor must be > 0, got {self.deadline_factor}"
            )
        if self.late_policy not in ("fold", "drop"):
            raise ValueError(
                f"late_policy must be 'fold' or 'drop', got {self.late_policy!r}"
            )
        if not 0.0 < self.staleness_alpha <= 1.0:
            raise ValueError(
                f"staleness_alpha must be in (0, 1], got {self.staleness_alpha}"
            )
        if self.max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {self.max_staleness}"
            )
        if self.dp_noise_multiplier < 0:
            raise ValueError(
                f"dp_noise_multiplier must be >= 0, got {self.dp_noise_multiplier}"
            )
        if self.dp_noise_multiplier > 0 and self.dp_clip is None:
            raise ValueError("dp_noise_multiplier > 0 requires dp_clip")
        if self.dp_clip is not None and self.dp_clip <= 0:
            raise ValueError(f"dp_clip must be > 0, got {self.dp_clip}")
        if not 0.0 < self.dp_delta < 1.0:
            raise ValueError(f"dp_delta must be in (0, 1), got {self.dp_delta}")
        if self.max_sim_seconds <= 0:
            raise ValueError(
                f"max_sim_seconds must be > 0, got {self.max_sim_seconds}"
            )


__all__ = ["FederatedConfig"]
