"""The models' Python loops over steps or chunks, and how a counter may
shorten them.

A mixer that loops writes ``for i in trip_loop(n)`` and gathers its
per-trip outputs with ``expand_trips(outs, n)``.  Nothing bound, that is
``range(n)`` and the outputs as they are.  A counter bound by
``trip_counter`` (the dry-run's op counter, ``roofline/op_counter.py``)
supplies the trips itself: it may run the first, one middle and the last
trip (indices 0, 1 and n - 1) and count the middle one n - 2 times, as a
compiler's cost analysis counts a ``while`` body once times its trip count.
The loop body's ops must then not depend on the index's value, apart from
the last trip's (a ragged tail chunk).

The binding is a ``contextvars`` variable, as ``sharding.axis_binding``:
it holds in the context that bound it and in no other thread, so a model
that runs beside an open counter loops over every trip.
"""
from __future__ import annotations

import contextlib
import contextvars

_COUNTER: contextvars.ContextVar = contextvars.ContextVar("trip_counter", default=None)


@contextlib.contextmanager
def trip_counter(counter):
    """Bind ``counter``, whose ``trips(n)`` yields the trip indices to run."""
    tok = _COUNTER.set(counter)
    try:
        yield
    finally:
        _COUNTER.reset(tok)


def trip_loop(n: int):
    """``range(n)``, or the bound counter's trips."""
    counter = _COUNTER.get()
    return range(n) if counter is None else counter.trips(n)


def expand_trips(outs: list, n: int) -> list:
    """A ``trip_loop``'s per-trip outputs as ``n`` entries: the middle
    trip's stands for the n - 2 it counted as."""
    return outs if len(outs) == n else outs[:1] + outs[1:2] * (n - 2) + outs[2:]
