"""Secure aggregation + differential-privacy noise for federated rounds.

Two independent mechanisms, both optional via ``FederatedConfig``:

*Pairwise-mask secure aggregation* (Bonawitz et al. style, simulation-grade):
every ordered pair (i, j) of a round's participants derives a shared mask
vector from a seed both can compute; participant i ADDS the mask for every
j > i and SUBTRACTS it for every j < i, so the masks cancel exactly in the
sum and the aggregator recovers ``sum(updates)`` without ever observing an
individual update.  All arithmetic is float64, so cancellation error is at
the 1e-12 level — far inside the 1e-6 equivalence bound the tests pin.

Caveat (documented, intentionally out of scope): real secure aggregation
must survive participants dropping out AFTER masking (secret-shared seed
recovery).  Here masks are generated over the round's *realized* on-time
participant set at aggregation time, so dropout recovery never arises; the
protocol hole is the gap between this simulation and a deployment.

*Gaussian DP noise*: updates are L2-clipped to ``dp_clip`` and the average
gets ``N(0, (noise_multiplier * clip / n)^2)`` noise per coordinate.
``PrivacyAccountant`` is an epsilon-accounting STUB — basic composition of
the Gaussian mechanism, not a tight moments/RDP accountant — good for
surfacing "how much noise did this run spend" in reports, not for
production privacy claims.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def _pair_rng(seed: int, round_idx: int, a: str, b: str) -> np.random.Generator:
    """Shared generator for the (a, b) pair: both sides derive the same
    stream from (seed, round, sorted pair names), hashed through numpy's
    SeedSequence so it is stable across platforms and runs."""
    lo, hi = sorted((a, b))
    entropy = [seed, round_idx] + [ord(c) for c in lo] + [7] + [ord(c) for c in hi]
    return np.random.default_rng(np.random.SeedSequence(entropy))


def pairwise_masks(
    seed: int, round_idx: int, participants: list[str], dim: int
) -> dict[str, np.ndarray]:
    """Per-participant mask vectors that cancel exactly in the sum.

    ``mask[i] = sum_{j: i < j} m_ij - sum_{j: j < i} m_ji`` where ``m_ij``
    is the pair (i, j)'s shared stream — each pair's term appears once with
    each sign, so ``sum(mask.values())`` is identically zero (float64
    rounding aside).  Deterministic in (seed, round, participant set)."""
    order = sorted(participants)
    masks = {p: np.zeros(dim, dtype=np.float64) for p in order}
    for i, a in enumerate(order):
        for b in order[i + 1:]:
            m = _pair_rng(seed, round_idx, a, b).standard_normal(dim)
            masks[a] += m
            masks[b] -= m
    return masks


def clip_update(vec: np.ndarray, clip: float | None) -> np.ndarray:
    """L2-clip an update to norm <= ``clip`` (no-op when clip is None)."""
    if clip is None:
        return vec
    norm = float(np.linalg.norm(vec))
    if norm <= clip or norm == 0.0:
        return vec
    return vec * (clip / norm)


def gaussian_noise(
    seed: int, round_idx: int, dim: int, scale: float
) -> np.ndarray:
    """Deterministic per-round DP noise vector, N(0, scale^2) iid."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x0D9, round_idx]))
    return rng.standard_normal(dim) * scale


@dataclasses.dataclass
class PrivacyAccountant:
    """Epsilon-accounting STUB for the Gaussian mechanism.

    Tracks how many noised rounds ran at which ``noise_multiplier`` (noise
    stddev in units of the clipping bound).  ``epsilon`` applies the basic
    advanced-composition bound for the Gaussian mechanism,
    ``eps ~= sqrt(2 k ln(1/delta)) / sigma``, which is loose but monotone
    and dependency-free — a placeholder to be swapped for an RDP accountant.
    """

    noise_multiplier: float = 0.0
    rounds: int = 0

    def spend(self, noise_multiplier: float) -> None:
        if self.rounds and abs(noise_multiplier - self.noise_multiplier) > 1e-12:
            raise ValueError(
                "accountant stub assumes a constant noise multiplier; got "
                f"{noise_multiplier} after {self.noise_multiplier}"
            )
        self.noise_multiplier = noise_multiplier
        self.rounds += 1

    def epsilon(self, delta: float = 1e-5) -> float | None:
        """Loose composed epsilon at ``delta``; None when no noise ran."""
        if self.rounds == 0 or self.noise_multiplier == 0.0:
            return None
        return math.sqrt(2.0 * self.rounds * math.log(1.0 / delta)) / (
            self.noise_multiplier
        )

    def summary(self, delta: float = 1e-5) -> dict:
        out = {
            "rounds": self.rounds,
            "noise_multiplier": self.noise_multiplier,
        }
        eps = self.epsilon(delta)
        if eps is not None:
            out["epsilon"] = round(eps, 4)
            out["delta"] = delta
        return out


__all__ = [
    "PrivacyAccountant",
    "clip_update",
    "gaussian_noise",
    "pairwise_masks",
]
