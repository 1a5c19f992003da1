"""Typed worker-fault schedules shared by the virtual clock and the real
serving path.

``SystemSimulation.worker_failures`` historically mapped ``worker_id ->
crash time`` (the worker silently stops heartbeating at ``t``).  This
module generalizes that toggle into typed :class:`FaultSpec` schedules —
crash, crash-recover, slowdown, flaky — consumed identically by the
virtual-clock simulation and by the real dispatchers' ``FaultInjector``
(``repro_torch.serve.fleet``), so every failure scenario is a cheap
deterministic regression test in both worlds.

Kept deliberately light (stdlib only): ``repro_torch.api.config`` imports the
:class:`FaultToleranceConfig` knobs from here without pulling torch through
``repro_torch.serve``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Union

FAULT_KINDS = ("crash", "crash_recover", "slowdown", "flaky")

#: Deterministic flaky-drop hash: Knuth-style multipliers combine the
#: (token, attempt, seed) triple, then a MurmurHash3 finalizer gives the
#: avalanche (attempt k and k+1 must draw independent values).  ``hash()``
#: is salted for strings, so it is never used here — flaky schedules stay
#: bit-reproducible across runs and platforms.
_MIX_A = 2654435761
_MIX_B = 40503
_MIX_C = 69069
_MASK64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    x &= _MASK64
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & _MASK64
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & _MASK64
    x ^= x >> 33
    return x


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One worker's fault schedule.

    kind          one of :data:`FAULT_KINDS`
    at            fault onset time (simulation / dispatcher-relative s)
    recover_at    optional end of the fault window (crash_recover,
                  slowdown, flaky); ``None`` = faulty forever
    factor        slowdown multiplier on service time (kind="slowdown")
    p             per-attempt failure probability (kind="flaky")
    seed          salt for the deterministic flaky hash
    """

    kind: str = "crash"
    at: float = 0.0
    recover_at: Optional[float] = None
    factor: float = 1.0
    p: float = 0.0
    seed: int = 0

    # ------------------------------------------------------------ queries
    def active(self, t: float) -> bool:
        """Is the fault window open at time ``t``?"""
        if t < self.at:
            return False
        return self.recover_at is None or t < self.recover_at

    def crashed(self, t: float) -> bool:
        return self.kind in ("crash", "crash_recover") and self.active(t)

    def crashed_between(self, t0: float, t1: float) -> bool:
        """Did the crash window overlap ``[t0, t1]``?  Used by the virtual
        clock to drop results whose execution straddled a crash."""
        if self.kind not in ("crash", "crash_recover"):
            return False
        end = math.inf if self.recover_at is None else self.recover_at
        return self.at <= t1 and t0 < end

    def slowdown_factor(self, t: float) -> float:
        if self.kind != "slowdown" or not self.active(t):
            return 1.0
        return self.factor

    def drops(self, token: int, attempt: int, t: float) -> bool:
        """Deterministic flaky decision for ``(token, attempt)`` — e.g.
        (task_id, retry count).  Retries draw fresh hashes, so a flaky
        worker eventually succeeds."""
        if self.kind != "flaky" or self.p <= 0.0 or not self.active(t):
            return False
        x = _mix64(token * _MIX_A + attempt * _MIX_B + self.seed * _MIX_C + 12345)
        return x / (_MASK64 + 1) < self.p

    # --------------------------------------------------------- validation
    def validate(self, owner: str) -> None:
        """Raise ``ValueError`` naming ``owner`` (the worker id) on any
        malformed field."""
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"worker_failures[{owner!r}]: unknown fault kind "
                f"{self.kind!r} (expected one of {FAULT_KINDS})"
            )
        if not math.isfinite(self.at) or self.at < 0.0:
            raise ValueError(
                f"worker_failures[{owner!r}]: fault time {self.at!r} must "
                f"be finite and >= 0"
            )
        if self.recover_at is not None:
            if not math.isfinite(self.recover_at):
                raise ValueError(
                    f"worker_failures[{owner!r}]: recover_at "
                    f"{self.recover_at!r} must be finite"
                )
            if self.recover_at <= self.at:
                raise ValueError(
                    f"worker_failures[{owner!r}]: recover_at "
                    f"{self.recover_at!r} must be > fault time {self.at!r}"
                )
        if self.kind == "slowdown" and (
            not math.isfinite(self.factor) or self.factor <= 0.0
        ):
            raise ValueError(
                f"worker_failures[{owner!r}]: slowdown factor "
                f"{self.factor!r} must be finite and > 0"
            )
        if self.kind == "flaky" and not (0.0 <= self.p <= 1.0):
            raise ValueError(
                f"worker_failures[{owner!r}]: flaky probability "
                f"{self.p!r} must be in [0, 1]"
            )


FaultLike = Union[float, int, FaultSpec, Mapping]


def normalize_failures(
    worker_failures: Optional[Mapping[str, FaultLike]],
) -> dict[str, FaultSpec]:
    """Coerce a ``worker_failures`` map to ``{worker_id: FaultSpec}`` and
    validate it.  Accepts the legacy ``{wid: crash_time}`` float form, dict
    kwargs (``{"kind": "slowdown", "at": 2.0, "factor": 3.0}``), or
    ready-made :class:`FaultSpec` values.  Raises ``ValueError`` naming the
    offending worker id."""
    out: dict[str, FaultSpec] = {}
    for wid, value in (worker_failures or {}).items():
        if isinstance(value, FaultSpec):
            spec = value
        elif isinstance(value, Mapping):
            try:
                spec = FaultSpec(**value)
            except TypeError as exc:
                raise ValueError(
                    f"worker_failures[{wid!r}]: bad fault fields: {exc}"
                ) from None
        elif isinstance(value, (int, float)) and not isinstance(value, bool):
            spec = FaultSpec(kind="crash", at=float(value))
        else:
            raise ValueError(
                f"worker_failures[{wid!r}]: expected a crash time, a "
                f"FaultSpec, or a dict of FaultSpec fields, got "
                f"{type(value).__name__}"
            )
        spec.validate(str(wid))
        out[str(wid)] = spec
    return out


@dataclasses.dataclass(frozen=True)
class FaultToleranceConfig:
    """Dispatcher fault-tolerance knobs (``ServingConfig.fault_tolerance``).

    retry_limit         in-place retries of a failed batch on the same
                        worker before migrating (0 = migrate immediately)
    retry_backoff_s     base backoff between retries (doubles per attempt)
    hedge_k             hedged duplicate dispatch fires when a slot exceeds
                        ``hedge_k ×`` the ServiceModel EWMA estimate;
                        ``None`` disables hedging
    breaker_threshold   consecutive failures that trip a worker offline
    breaker_cooldown_s  offline hold before the half-open probation trial
    failure_alpha       EWMA smoothing for the per-worker failure rate
    """

    retry_limit: int = 1
    retry_backoff_s: float = 0.0
    hedge_k: Optional[float] = None
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 5.0
    failure_alpha: float = 0.25

    def __post_init__(self):
        if self.retry_limit < 0:
            raise ValueError("retry_limit must be >= 0")
        if self.retry_backoff_s < 0.0:
            raise ValueError("retry_backoff_s must be >= 0")
        if self.hedge_k is not None and self.hedge_k <= 0.0:
            raise ValueError("hedge_k must be > 0 (or None to disable)")
        if self.breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        if self.breaker_cooldown_s < 0.0:
            raise ValueError("breaker_cooldown_s must be >= 0")
        if not (0.0 < self.failure_alpha <= 1.0):
            raise ValueError("failure_alpha must be in (0, 1]")


__all__ = [
    "FAULT_KINDS",
    "FaultSpec",
    "FaultToleranceConfig",
    "normalize_failures",
]
