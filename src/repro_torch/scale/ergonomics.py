"""Experiment ergonomics for long-running harness sweeps.

Three small utilities (the mlfab-style experiment conveniences the ROADMAP
calls out) used by the scale harness's own telemetry — none of them touch
the virtual clock, so harness progress reporting never perturbs the
deterministic results it reports on:

* ``CumulativeTimer`` — named wall-clock accumulators (``with timer.time(
  "replay"): ...``); ``stats()`` reports count / total / mean per name, so
  a sweep's cost breakdown (generate vs replay vs aggregate) is one dict.
* ``IntervalTicker`` — rate-limits progress output: ``tick()`` returns
  True at most once per interval, so a 10k-tenant sweep logs a heartbeat
  line every few seconds instead of per event or not at all.
* ``config_diff`` — flat "key: old -> new" report between two config
  mappings, so every emitted artifact can say exactly how its run deviated
  from the defaults (the config-diff report idiom).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator, Mapping


class CumulativeTimer:
    """Named cumulative wall-clock timers.

    ``time(name)`` is a context manager accumulating into ``name``;
    ``add(name, seconds)`` records an externally measured duration.
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._total: dict[str, float] = {}
        self._count: dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            self.add(name, self._clock() - t0)

    def add(self, name: str, seconds: float) -> None:
        self._total[name] = self._total.get(name, 0.0) + seconds
        self._count[name] = self._count.get(name, 0) + 1

    def total(self, name: str) -> float:
        return self._total.get(name, 0.0)

    def stats(self) -> dict[str, dict[str, float]]:
        """``{name: {count, total_s, mean_s}}``, insertion-ordered."""
        return {
            name: {
                "count": self._count[name],
                "total_s": round(total, 6),
                "mean_s": round(total / self._count[name], 6),
            }
            for name, total in self._total.items()
        }


class IntervalTicker:
    """Fires at most once per ``interval_s`` of wall time.

    The first ``tick()`` always fires (so progress output starts
    immediately); subsequent calls fire only after the interval elapsed.
    """

    def __init__(self, interval_s: float, clock=time.monotonic):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be positive, got {interval_s}")
        self.interval_s = interval_s
        self._clock = clock
        self._last: float | None = None
        self.ticks = 0

    def tick(self, now: float | None = None) -> bool:
        now = self._clock() if now is None else now
        if self._last is not None and now - self._last < self.interval_s:
            return False
        self._last = now
        self.ticks += 1
        return True


def config_diff(
    base: Mapping[str, Any], current: Mapping[str, Any]
) -> list[str]:
    """Flat ``key: old -> new`` lines for every key that differs.

    Nested mappings recurse with dotted paths; keys present on one side
    only render as ``added``/``removed``.  Deterministic (sorted) so the
    report can live inside a trend-gated artifact.
    """
    lines: list[str] = []
    for key in sorted(set(base) | set(current)):
        if key not in current:
            lines.append(f"{key}: {base[key]!r} -> removed")
        elif key not in base:
            lines.append(f"{key}: added -> {current[key]!r}")
        elif isinstance(base[key], Mapping) and isinstance(
            current[key], Mapping
        ):
            lines.extend(
                f"{key}.{sub}"
                for sub in config_diff(base[key], current[key])
            )
        elif base[key] != current[key]:
            lines.append(f"{key}: {base[key]!r} -> {current[key]!r}")
    return lines


__all__ = ["CumulativeTimer", "IntervalTicker", "config_diff"]
