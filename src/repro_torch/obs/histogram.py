"""Streaming log-bucketed histograms (HDR-style, fixed memory).

The serving telemetry used to keep raw per-completion latency lists — O(n)
memory per tenant forever, exactly what a gateway serving millions of
circuits cannot afford.  ``LogHistogram`` replaces them: a fixed array of
geometrically spaced buckets (``v_min * growth**i``), so memory is O(1)
regardless of sample count and any percentile is reconstructable to within
one bucket width (relative error <= ``growth`` — the tolerance the metrics
tests assert).

Values at or below ``v_min`` (including exact zeros — empty-queue depth
samples, sub-resolution latencies) land in a dedicated zero bucket; values
beyond the top bucket clamp into it (and are remembered exactly via
``max_seen``).  ``merge`` folds two same-shape histograms, so per-stage and
per-tenant histograms can be aggregated without losing the error bound.

Everything is pure Python over a fixed-size list: the recorder hot path is
one ``log`` + one list increment, no numpy import on the serving thread.
"""
from __future__ import annotations

import math


class LogHistogram:
    """Fixed-memory streaming histogram over log-spaced buckets.

    ``v_min``: lower edge of the first bucket (values <= v_min are "zero");
    ``growth``: geometric bucket width (1.25 -> <= 25% percentile error);
    ``n_buckets``: bucket count.  The defaults cover 1 us .. ~2e6 s, wide
    enough for stage latencies, end-to-end latencies, and queue depths.
    """

    __slots__ = (
        "v_min",
        "growth",
        "n_buckets",
        "_log_growth",
        "_log_vmin",
        "counts",
        "zeros",
        "count",
        "total",
        "min_seen",
        "max_seen",
    )

    def __init__(
        self, v_min: float = 1e-6, growth: float = 1.25, n_buckets: int = 128
    ):
        if v_min <= 0:
            raise ValueError(f"v_min must be positive, got {v_min}")
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1, got {growth}")
        if n_buckets < 1:
            raise ValueError(f"n_buckets must be >= 1, got {n_buckets}")
        self.v_min = v_min
        self.growth = growth
        self.n_buckets = n_buckets
        self._log_growth = math.log(growth)
        self._log_vmin = math.log(v_min)
        self.counts = [0] * n_buckets
        self.zeros = 0  # samples <= v_min (incl. exact zeros)
        self.count = 0
        self.total = 0.0
        self.min_seen = math.inf
        self.max_seen = -math.inf

    # ------------------------------------------------------------- record
    def _bucket(self, v: float) -> int:
        i = int((math.log(v) - self._log_vmin) / self._log_growth)
        return min(max(i, 0), self.n_buckets - 1)

    def record(self, v: float, n: int = 1) -> None:
        """Add ``n`` observations of value ``v`` (O(1), no allocation)."""
        v = float(v)
        self.count += n
        self.total += v * n
        if v < self.min_seen:
            self.min_seen = v
        if v > self.max_seen:
            self.max_seen = v
        if v <= self.v_min:
            self.zeros += n
        else:
            self.counts[self._bucket(v)] += n

    # ------------------------------------------------------------ queries
    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def bucket_bounds(self, i: int) -> tuple[float, float]:
        return (self.v_min * self.growth**i, self.v_min * self.growth ** (i + 1))

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile, reconstructed from bucket midpoints.

        Returns the geometric midpoint of the selected bucket, clamped to
        the exactly-tracked [min_seen, max_seen] envelope — always within
        one bucket width (x ``growth``) of the exact order statistic."""
        if not self.count:
            return float("nan")
        rank = max(1, min(self.count, math.ceil(q / 100.0 * self.count)))
        seen = self.zeros
        if rank <= seen:
            # all-zero bucket: the envelope is exact for min-side values
            return min(max(0.0, self.min_seen), self.v_min)
        for i, c in enumerate(self.counts):
            seen += c
            if rank <= seen:
                lo, hi = self.bucket_bounds(i)
                mid = math.sqrt(lo * hi)
                return min(max(mid, self.min_seen), self.max_seen)
        return self.max_seen  # unreachable when counts are consistent

    # ---------------------------------------------------------- aggregate
    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other`` into self (shapes must match); returns self."""
        if (self.v_min, self.growth, self.n_buckets) != (
            other.v_min,
            other.growth,
            other.n_buckets,
        ):
            raise ValueError("cannot merge histograms with different bucketing")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.zeros += other.zeros
        self.count += other.count
        self.total += other.total
        self.min_seen = min(self.min_seen, other.min_seen)
        self.max_seen = max(self.max_seen, other.max_seen)
        return self

    def snapshot(self) -> dict:
        """Compact JSON-ready view: only non-empty buckets are listed."""
        out = {
            "count": self.count,
            "mean": round(self.mean, 6) if self.count else None,
            "min": self.min_seen if self.count else None,
            "max": self.max_seen if self.count else None,
            "p50": round(self.percentile(50), 6) if self.count else None,
            "p99": round(self.percentile(99), 6) if self.count else None,
        }
        buckets = {str(i): c for i, c in enumerate(self.counts) if c}
        if self.zeros:
            buckets["zero"] = self.zeros
        out["buckets"] = buckets
        return out

    def __repr__(self) -> str:
        return (
            f"LogHistogram(count={self.count}, mean={self.mean:.4g}, "
            f"buckets={sum(1 for c in self.counts if c)}/{self.n_buckets})"
        )


__all__ = ["LogHistogram"]
