"""Deterministic event-driven runtime for the co-Manager simulation.

The paper runs its control plane on wall-clock time (RPyC heartbeats every
5 s).  We reproduce the *semantics* on a virtual clock so every experiment is
exactly reproducible: events are ordered by (time, sequence number) and all
randomness is seeded.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any, Callable


@dataclasses.dataclass(order=True)
class _Entry:
    time: float
    seq: int
    kind: str = dataclasses.field(compare=False)
    payload: Any = dataclasses.field(compare=False)
    cancelled: bool = dataclasses.field(compare=False, default=False)


class EventLoop:
    """Min-heap virtual-time event loop."""

    def __init__(self):
        self._heap: list[_Entry] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.handlers: dict[str, Callable[[float, Any], None]] = {}
        self._stopped = False

    def schedule(self, time: float, kind: str, payload: Any = None) -> _Entry:
        if time < self.now - 1e-12:
            raise ValueError(f"cannot schedule in the past: {time} < {self.now}")
        e = _Entry(time, next(self._seq), kind, payload)
        heapq.heappush(self._heap, e)
        return e

    def cancel(self, entry: _Entry) -> None:
        entry.cancelled = True

    def on(self, kind: str, fn: Callable[[float, Any], None]) -> None:
        self.handlers[kind] = fn

    def stop(self) -> None:
        """Terminally stop the loop: ``run`` returns after the handler that
        called this (and any later ``run`` returns immediately).  Used by
        controllers layered on the simulation — e.g. the federated round
        driver, whose experiment ends at the final round close even when
        straggler jobs (a crashed worker's stalled tenant) would keep
        heartbeat events circulating forever."""
        self._stopped = True

    def run(self, until: float = float("inf"), max_events: int = 10_000_000) -> float:
        """Dispatch events in order until the heap drains, ``until`` is
        passed, or a handler calls ``stop()``."""
        n = 0
        while self._heap and n < max_events and not self._stopped:
            e = self._heap[0]
            if e.time > until:
                break
            heapq.heappop(self._heap)
            if e.cancelled:
                continue
            self.now = max(self.now, e.time)
            self.handlers[e.kind](self.now, e.payload)
            n += 1
        if n >= max_events:
            raise RuntimeError("event budget exhausted — likely a scheduling loop")
        return self.now

    @property
    def pending(self) -> int:
        return sum(1 for e in self._heap if not e.cancelled)
