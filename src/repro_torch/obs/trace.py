"""Per-circuit lifecycle tracing + worker occupancy timelines.

The co-Manager "dynamically manages circuits according to the runtime
status of quantum workers" — this module is where that runtime status
becomes *visible*.  Three cooperating pieces:

* ``TraceRecorder`` — the hook surface the serving stack calls.  Every
  submitted circuit (deterministically sampled by admission sequence
  number) gets a ``CircuitTrace`` with timestamped stage transitions
  (``submit -> admit -> coalesced -> placed -> dispatched -> kernel_start
  -> complete/evict/fail``); every worker execution (real dispatcher slot
  or virtual-clock dispatch ledger) records a ``WorkerSpan``.  Stage
  transition latencies feed fixed-memory ``LogHistogram``s as they happen,
  so aggregate stage accounting survives ring-buffer eviction.
* ``TraceBuffer`` — bounded ring (O(1) append) holding finished records;
  ``export_chrome_trace()`` emits Chrome-trace/Perfetto JSON with one row
  per tenant and one per worker (async b/e span pairs, so overlapping
  circuits and co-resident worker tasks render correctly in
  ``ui.perfetto.dev``).
* ``WorkerTimeline`` — per-worker busy/spill interval accounting (O(1)
  memory: integrals + counters, not interval lists).
* ``HostSpan`` — the program's own nested intervals on host threads (the
  layers of a training step: ``grad_shift`` and its parts, the data plane,
  the trainer loop), opened through ``span()`` against the recorder that
  ``set_recorder`` installed.  Per-name totals (count, duration, self time)
  are O(1) memory; under an active ``torch.profiler`` each span is also an
  ``rt:<name>`` range of the profiler's trace, so device work lines up
  with the span its launch was made in.

All clocks are caller-supplied floats — virtual seconds under the
simulation's event loop, ``time.perf_counter()`` seconds in the real data
plane — so the same recorder serves both runtimes, and a seeded simulation
exports a bit-identical trace (the golden-file test pins this).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Iterable, Optional

import torch

from repro_torch.obs.config import (
    FEDERATED_STAGES,
    LIFECYCLE_STAGES,
    RECOVERY_STAGES,
    ObservabilityConfig,
)
from repro_torch.obs.histogram import LogHistogram

#: human-facing metric name for the latency *into* each stage (duration
#: since the previous recorded transition).
STAGE_METRICS = {
    "admit": "queue_wait",
    "coalesced": "coalesce_wait",
    "placed": "place_wait",
    "dispatched": "dispatch_lag",
    "kernel_start": "kernel_wait",
    "complete": "execute",
}

#: terminal transitions closing a circuit trace.
OUTCOMES = ("complete", "evict", "fail", "reject")

_HASH_MULT = 2654435761  # Knuth multiplicative hash (fits 32 bits)


@dataclasses.dataclass
class CircuitTrace:
    """Lifecycle record of one sampled circuit."""

    seq: int
    tenant: str
    key: str
    stages: list = dataclasses.field(default_factory=list)  # [(stage, ts)]
    worker: Optional[str] = None
    outcome: Optional[str] = None
    queue_depth: Optional[int] = None

    @property
    def start(self) -> float:
        return self.stages[0][1]

    @property
    def end(self) -> float:
        return self.stages[-1][1]

    def to_dict(self) -> dict:
        return {
            "seq": self.seq,
            "tenant": self.tenant,
            "key": self.key,
            "stages": [[s, t] for s, t in self.stages],
            "worker": self.worker,
            "outcome": self.outcome,
            "queue_depth": self.queue_depth,
        }


@dataclasses.dataclass
class RoundEvent:
    """One federated aggregation-round transition (``FEDERATED_STAGES``).

    Round-level, not circuit-level: a round's local-training circuits carry
    ordinary ``CircuitTrace`` records; these mark the coordinator's control
    decisions (round opened, update arrived on time / late, aggregate
    applied) so straggler waits are visible next to the data plane."""

    round_idx: int
    stage: str
    ts: float
    tenant: Optional[str] = None
    args: Optional[dict] = None

    def to_dict(self) -> dict:
        out = {"round": self.round_idx, "stage": self.stage, "ts": self.ts}
        if self.tenant is not None:
            out["tenant"] = self.tenant
        if self.args:
            out["args"] = dict(self.args)
        return out


@dataclasses.dataclass
class WorkerSpan:
    """One contiguous busy interval on a worker (or the mesh spill slot)."""

    span_id: int
    worker: str
    start: float
    end: float
    kind: str = "batch"  # batch | spill | circuit
    name: Optional[str] = None
    args: Optional[dict] = None


@dataclasses.dataclass
class HostSpan:
    """One finished interval of the program's own work on a host thread
    (``time.perf_counter()`` seconds), nested under the span open on the
    same thread when it began; ``step`` is the id of the outermost span
    open on that thread then (its own id for an outermost span)."""

    span_id: int
    parent_id: Optional[int]
    step: int
    name: str
    thread: str
    start: float
    end: float
    args: Optional[dict] = None


class WorkerTimeline:
    """Busy/spill occupancy accounting for one worker — O(1) memory.

    ``busy_s`` integrates span durations (co-resident spans double-count,
    matching ``QuantumWorker.busy_time``'s integral semantics); idle time
    is derived against the observed horizon at summary time."""

    __slots__ = (
        "worker_id",
        "busy_s",
        "spill_s",
        "n_spans",
        "first_start",
        "last_end",
        "by_kind",
    )

    def __init__(self, worker_id: str):
        self.worker_id = worker_id
        self.busy_s = 0.0
        self.spill_s = 0.0
        self.n_spans = 0
        self.first_start = float("inf")
        self.last_end = 0.0
        self.by_kind: dict[str, int] = {}

    def record(self, start: float, end: float, kind: str) -> None:
        dur = max(0.0, end - start)
        self.busy_s += dur
        if kind == "spill":
            self.spill_s += dur
        self.n_spans += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        self.first_start = min(self.first_start, start)
        self.last_end = max(self.last_end, end)

    def summary(self, horizon: Optional[float] = None) -> dict:
        span = (
            (horizon if horizon is not None else self.last_end) - self.first_start
            if self.n_spans
            else 0.0
        )
        return {
            "worker": self.worker_id,
            "spans": self.n_spans,
            "busy_s": round(self.busy_s, 6),
            "spill_s": round(self.spill_s, 6),
            "idle_s": round(max(0.0, span - self.busy_s), 6),
            "utilization": round(self.busy_s / span, 4) if span > 0 else None,
            "by_kind": dict(sorted(self.by_kind.items())),
        }


class TraceBuffer:
    """Bounded ring of finished trace records; O(1) append, fixed memory."""

    def __init__(self, capacity: int = 65536):
        self._buf: deque = deque(maxlen=capacity)
        self.capacity = capacity
        self.appended = 0

    def append(self, rec) -> None:
        self.appended += 1
        self._buf.append(rec)

    @property
    def dropped(self) -> int:
        return self.appended - len(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    def __iter__(self):
        return iter(self._buf)

    def records(self, kind=None) -> list:
        if kind is None:
            return list(self._buf)
        return [r for r in self._buf if isinstance(r, kind)]

    # -------------------------------------------------------------- export
    def export_chrome_trace(self, path: Optional[str] = None) -> dict:
        """Chrome-trace/Perfetto JSON: one process row per tenant and per
        worker; circuits and worker executions are async ``b``/``e`` span
        pairs (overlap-safe), queue depths are counter tracks.  Open the
        written file directly in https://ui.perfetto.dev."""
        circuits = self.records(CircuitTrace)
        spans = self.records(WorkerSpan)
        rounds = self.records(RoundEvent)
        tenants = sorted({c.tenant for c in circuits})
        workers = sorted({s.worker for s in spans})
        pid_of = {t: 1 + i for i, t in enumerate(tenants)}
        pid_of.update({("w", w): 1001 + i for i, w in enumerate(workers)})
        us = 1e6

        events: list[dict] = []
        for i, t in enumerate(tenants):
            events.append(_meta(pid_of[t], "process_name", name=f"tenant {t}"))
            events.append(_meta(pid_of[t], "process_sort_index", sort_index=i))
        for i, w in enumerate(workers):
            pid = pid_of[("w", w)]
            events.append(_meta(pid, "process_name", name=f"worker {w}"))
            events.append(_meta(pid, "process_sort_index", sort_index=100 + i))

        for c in circuits:
            pid = pid_of[c.tenant]
            # rejected submissions never consumed their sequence number, so
            # suffix their span id to avoid colliding with the admitted
            # circuit that did.
            cid = f"{c.seq}r" if c.outcome == "reject" else str(c.seq)
            name = f"{c.key} #{c.seq}"
            b_args: dict[str, Any] = {
                "stages": {s: round(ts, 9) for s, ts in c.stages}
            }
            if c.queue_depth is not None:
                b_args["queue_depth"] = c.queue_depth
            events.append(
                {
                    "ph": "b",
                    "cat": "circuit",
                    "id": cid,
                    "name": name,
                    "pid": pid,
                    "tid": 1,
                    "ts": c.start * us,
                    "args": b_args,
                }
            )
            events.append(
                {
                    "ph": "e",
                    "cat": "circuit",
                    "id": cid,
                    "name": name,
                    "pid": pid,
                    "tid": 1,
                    "ts": c.end * us,
                    "args": {"outcome": c.outcome, "worker": c.worker},
                }
            )
            if c.queue_depth is not None:
                events.append(
                    {
                        "ph": "C",
                        "name": "queue_depth",
                        "pid": pid,
                        "tid": 1,
                        "ts": c.start * us,
                        "args": {"depth": c.queue_depth},
                    }
                )

        for s in spans:
            pid = pid_of[("w", s.worker)]
            name = s.name or s.kind
            sid = f"s{s.span_id}"
            b = {
                "ph": "b",
                "cat": "exec",
                "id": sid,
                "name": name,
                "pid": pid,
                "tid": 1,
                "ts": s.start * us,
            }
            if s.args:
                b["args"] = s.args
            events.append(b)
            events.append(
                {
                    "ph": "e",
                    "cat": "exec",
                    "id": sid,
                    "name": name,
                    "pid": pid,
                    "tid": 1,
                    "ts": s.end * us,
                }
            )

        if rounds:
            # dedicated control-plane row, present only for federated runs
            # so non-federated golden traces stay byte-identical.
            fed_pid = 2001
            events.append(_meta(fed_pid, "process_name", name="federated rounds"))
            events.append(_meta(fed_pid, "process_sort_index", sort_index=200))
            for r in rounds:
                args: dict[str, Any] = {"round": r.round_idx}
                if r.tenant is not None:
                    args["tenant"] = r.tenant
                if r.args:
                    args.update(r.args)
                events.append(
                    {
                        "ph": "i",
                        "s": "p",
                        "cat": "round",
                        "name": f"{r.stage} r{r.round_idx}",
                        "pid": fed_pid,
                        "tid": 1,
                        "ts": r.ts * us,
                        "args": args,
                    }
                )

        hosts = self.records(HostSpan)
        if hosts:
            # one row per host thread, present only when the program's
            # spans were recorded, so other traces stay byte-identical.
            host_pid = 3001
            threads = sorted({h.thread for h in hosts})
            tid_of = {t: 1 + i for i, t in enumerate(threads)}
            events.append(_meta(host_pid, "process_name", name="host spans"))
            events.append(_meta(host_pid, "process_sort_index", sort_index=300))
            for t in threads:
                events.append(
                    {
                        "ph": "M",
                        "name": "thread_name",
                        "pid": host_pid,
                        "tid": tid_of[t],
                        "ts": 0,
                        "args": {"name": t},
                    }
                )
            for h in hosts:
                args = {"span_id": h.span_id, "parent_id": h.parent_id, "step": h.step}
                if h.args:
                    args.update(h.args)
                events.append(
                    {
                        "ph": "X",
                        "cat": "span",
                        "name": h.name,
                        "pid": host_pid,
                        "tid": tid_of[h.thread],
                        "ts": h.start * us,
                        "dur": (h.end - h.start) * us,
                        "args": args,
                    }
                )

        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f, indent=1, sort_keys=True)
        return trace


def _meta(pid: int, kind: str, **args) -> dict:
    return {"ph": "M", "name": kind, "pid": pid, "tid": 1, "ts": 0, "args": args}


class TraceRecorder:
    """The hook surface the serving stack (gateway, dispatchers, simulation,
    kernel wrappers) records into.  Hooks are cheap no-ops when disabled;
    when enabled, per-circuit records are sampled deterministically by
    sequence number while histograms and worker timelines stay always-on
    (they are O(1) memory).  Thread-safe: async dispatcher worker slots
    record concurrently with the pump thread."""

    def __init__(self, config: Optional[ObservabilityConfig] = None):
        self.config = config or ObservabilityConfig()
        self.enabled = self.config.enabled and self.config.sample_rate > 0.0
        self._threshold = int(self.config.sample_rate * (1 << 32))
        self._stage_ok = (
            None if self.config.stages is None else set(self.config.stages)
        )
        self.buffer = TraceBuffer(self.config.buffer_size)
        self._active: dict[int, CircuitTrace] = {}
        self._lock = threading.Lock()
        self.stage_hists: dict[str, LogHistogram] = {}
        self.e2e = LogHistogram()
        self.queue_depth = LogHistogram(v_min=0.5, growth=1.3, n_buckets=48)
        self.coalescer_depth = LogHistogram(v_min=0.5, growth=1.3, n_buckets=48)
        self.coalescer_lanes = LogHistogram(v_min=0.5, growth=1.3, n_buckets=64)
        self.timelines: dict[str, WorkerTimeline] = {}
        self.kernel_launches: dict[str, int] = {}
        self.round_counts: dict[str, int] = {}
        self.events = 0
        self._next_span = 0
        self._host_ids = itertools.count()
        self._threads = threading.local()
        self._span_totals: dict[str, list] = {}  # name -> [count, total_s, self_s]

    # ------------------------------------------------------------ sampling
    def sampled(self, seq: int) -> bool:
        """Deterministic per-circuit sampling decision (hash of the
        admission sequence number — identical across reruns and clocks)."""
        return (seq * _HASH_MULT) % (1 << 32) < self._threshold

    def _hist(self, name: str) -> LogHistogram:
        h = self.stage_hists.get(name)
        if h is None:
            h = self.stage_hists[name] = LogHistogram()
        return h

    # ----------------------------------------------------- circuit lifecycle
    def circuit_submit(
        self,
        seq: int,
        tenant: str,
        key,
        now: float,
        *,
        queue_depth: Optional[int] = None,
    ) -> None:
        if not self.enabled or not self.sampled(seq):
            return
        with self._lock:
            self.events += 1
            self._active[seq] = CircuitTrace(
                seq=seq,
                tenant=tenant,
                key=_key_str(key),
                stages=[("submit", now)],
                queue_depth=queue_depth,
            )
            if queue_depth is not None:
                self.queue_depth.record(queue_depth)

    def circuit_reject(self, seq: int, tenant: str, key, now: float) -> None:
        """Backpressure rejection: a zero-length trace closed on arrival."""
        if not self.enabled or not self.sampled(seq):
            return
        with self._lock:
            self.events += 1
            self.buffer.append(
                CircuitTrace(
                    seq=seq,
                    tenant=tenant,
                    key=_key_str(key),
                    stages=[("submit", now), ("reject", now)],
                    outcome="reject",
                )
            )

    def circuit_stage(
        self, seq: int, stage: str, now: float, worker: Optional[str] = None
    ) -> None:
        if not self.enabled:
            return
        with self._lock:
            rec = self._active.get(seq)
            if rec is None:
                return
            if self._stage_ok is not None and stage not in self._stage_ok:
                return
            self.events += 1
            metric = STAGE_METRICS.get(stage)
            if metric is not None:
                self._hist(metric).record(now - rec.stages[-1][1])
            rec.stages.append((stage, now))
            if worker is not None:
                rec.worker = worker

    def batch_stage(
        self,
        seqs: Iterable[int],
        stage: str,
        now: float,
        worker: Optional[str] = None,
    ) -> None:
        """Record one stage transition for every member of a batch."""
        if not self.enabled:
            return
        for seq in seqs:
            self.circuit_stage(seq, stage, now, worker)

    def circuit_end(self, seq: int, outcome: str, now: float) -> None:
        if not self.enabled:
            return
        with self._lock:
            rec = self._active.pop(seq, None)
            if rec is None:
                return
            self.events += 1
            if outcome == "complete":
                self._hist("execute").record(now - rec.stages[-1][1])
            rec.stages.append((outcome, now))
            rec.outcome = outcome
            self.e2e.record(now - rec.start)
            self.buffer.append(rec)

    # ------------------------------------------------------- worker spans
    def worker_span(
        self,
        worker: str,
        start: float,
        end: float,
        *,
        kind: str = "batch",
        name: Optional[str] = None,
        args: Optional[dict] = None,
    ) -> None:
        """One busy interval on ``worker`` (kernel launch, simulated task,
        or mesh spill).  Feeds the occupancy timeline and the trace ring."""
        if not self.enabled:
            return
        with self._lock:
            self.events += 1
            tl = self.timelines.get(worker)
            if tl is None:
                tl = self.timelines[worker] = WorkerTimeline(worker)
            tl.record(start, end, kind)
            self.buffer.append(
                WorkerSpan(
                    span_id=self._next_span,
                    worker=worker,
                    start=start,
                    end=end,
                    kind=kind,
                    name=name,
                    args=args,
                )
            )
            self._next_span += 1

    # --------------------------------------------------------- host spans
    def span(self, name: str, **args):
        """Context manager: one ``HostSpan`` named ``name`` around the
        block, a child of the span open on this thread.  Feeds the per-name
        totals and the trace ring; while a ``torch.profiler`` is active it
        also opens the range ``rt:<name>``."""
        if not self.enabled:
            return _NOOP
        return _OpenSpan(self, name, args or None)

    def _stack(self) -> list:
        stack = getattr(self._threads, "stack", None)
        if stack is None:
            stack = self._threads.stack = []
        return stack

    def _close_span(self, rec: HostSpan, self_s: float) -> None:
        with self._lock:
            self.events += 1
            tot = self._span_totals.get(rec.name)
            if tot is None:
                tot = self._span_totals[rec.name] = [0, 0.0, 0.0]
            tot[0] += 1
            tot[1] += rec.end - rec.start
            tot[2] += self_s
            self.buffer.append(rec)

    # -------------------------------------------------- federated rounds
    def round_event(
        self,
        round_idx: int,
        stage: str,
        now: float,
        *,
        tenant: Optional[str] = None,
        args: Optional[dict] = None,
    ) -> None:
        """One federated-round transition (``FEDERATED_STAGES``): round-level
        control events from ``repro_torch.federated`` — not tied to any circuit
        sequence number, so they bypass sampling (a handful per round) but
        respect the ``stages`` filter and the ring buffer like everything
        else."""
        if not self.enabled:
            return
        if stage not in FEDERATED_STAGES:
            raise ValueError(
                f"unknown federated stage {stage!r}; valid: "
                f"{list(FEDERATED_STAGES)}"
            )
        if self._stage_ok is not None and stage not in self._stage_ok:
            return
        with self._lock:
            self.events += 1
            self.round_counts[stage] = self.round_counts.get(stage, 0) + 1
            self.buffer.append(
                RoundEvent(
                    round_idx=round_idx,
                    stage=stage,
                    ts=now,
                    tenant=tenant,
                    args=args,
                )
            )

    def round_records(self) -> list[dict]:
        """Finished federated round events (oldest first)."""
        with self._lock:
            return [r.to_dict() for r in self.buffer.records(RoundEvent)]

    def coalescer_sample(self, members: int, lanes: int) -> None:
        """Coalescer buffer depth after one pump (member count and
        lane-weighted) — the queue the size-or-deadline policy drains."""
        if not self.enabled:
            return
        with self._lock:
            self.coalescer_depth.record(members)
            self.coalescer_lanes.record(lanes)

    def on_kernel_launch(self, info: dict) -> None:
        """Kernel-wrapper hook (``repro_torch.kernels.ops.set_launch_observer``):
        counts shift-plan launches by execution mode (fused / spill /
        materialize), independent of any dispatcher."""
        if not self.enabled:
            return
        with self._lock:
            kind = info.get("mode", "unknown")
            self.kernel_launches[kind] = self.kernel_launches.get(kind, 0) + 1

    # ----------------------------------------------------------- summaries
    @property
    def open_traces(self) -> int:
        with self._lock:
            return len(self._active)

    def tenant_records(self, tenant: str) -> list[dict]:
        """Finished lifecycle records of one tenant (oldest first)."""
        with self._lock:
            return [
                r.to_dict()
                for r in self.buffer.records(CircuitTrace)
                if r.tenant == tenant
            ]

    def stage_summary(self) -> dict:
        """Aggregate stage-latency accounting: per-metric histogram stats
        plus each stage's share of total end-to-end latency."""
        with self._lock:
            out: dict[str, Any] = {}
            for metric in sorted(self.stage_hists):
                out[metric] = self.stage_hists[metric].snapshot()
            e2e_total = self.e2e.total
            if self.e2e.count:
                out["e2e"] = self.e2e.snapshot()
                for metric in sorted(self.stage_hists):
                    share = (
                        self.stage_hists[metric].total / e2e_total
                        if e2e_total > 0
                        else 0.0
                    )
                    out[f"{metric}_share"] = round(share, 4)
            return out

    def summary(self) -> dict:
        with self._lock:
            out = {
                "enabled": self.enabled,
                "sample_rate": self.config.sample_rate,
                "events": self.events,
                "records": len(self.buffer),
                "records_dropped": self.buffer.dropped,
                "open_traces": len(self._active),
            }
            if self.kernel_launches:
                out["kernel_launches"] = dict(sorted(self.kernel_launches.items()))
            if self.round_counts:
                out["rounds"] = dict(sorted(self.round_counts.items()))
            if self.queue_depth.count:
                out["queue_depth"] = self.queue_depth.snapshot()
            if self.coalescer_depth.count:
                out["coalescer_depth"] = self.coalescer_depth.snapshot()
                out["coalescer_lanes"] = self.coalescer_lanes.snapshot()
            if self.timelines:
                out["workers"] = {
                    w: tl.summary() for w, tl in sorted(self.timelines.items())
                }
            if self._span_totals:
                # per host span name: count, summed duration and summed self
                # time (duration less what its children cover), in seconds
                out["spans"] = {
                    name: {"count": n, "total_s": total, "self_s": own}
                    for name, (n, total, own) in sorted(self._span_totals.items())
                }
        stages = self.stage_summary()
        if stages:
            out["stages"] = stages
        return out

    def export_chrome_trace(self, path: Optional[str] = None) -> dict:
        return self.buffer.export_chrome_trace(path)


#: the one context manager ``span()`` hands out while no recorder is
#: installed (it holds no state, so every caller may share it).
_NOOP = contextlib.nullcontext()
#: prefix of the profiler ranges the program's spans open.
RANGE_PREFIX = "rt:"


class _OpenSpan:
    """The context manager behind ``TraceRecorder.span``."""

    __slots__ = ("rec", "name", "args", "span_id", "parent", "step", "start",
                 "child_s", "range")

    def __init__(self, rec: TraceRecorder, name: str, args: Optional[dict]):
        self.rec, self.name, self.args = rec, name, args

    def __enter__(self):
        stack = self.rec._stack()
        parent = stack[-1] if stack else None
        self.span_id = next(self.rec._host_ids)
        self.parent = parent
        self.step = parent.step if parent is not None else self.span_id
        self.child_s = 0.0
        stack.append(self)
        self.range = None
        self.start = time.perf_counter()
        if torch.autograd.profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.range is not None:
            self.range.__exit__(None, None, None)
        end = time.perf_counter()
        stack = self.rec._stack()
        stack.pop()
        dur = end - self.start
        if self.parent is not None:
            self.parent.child_s += dur
        rec = HostSpan(
            span_id=self.span_id,
            parent_id=None if self.parent is None else self.parent.span_id,
            step=self.step,
            name=self.name,
            thread=threading.current_thread().name,
            start=self.start,
            end=end,
            args=self.args,
        )
        self.rec._close_span(rec, dur - self.child_s)


# ------------------------------------------------- the installed recorder
#: the recorder the program's span sites record into; None (the default)
#: makes every site cost one global read and a call.
_recorder: Optional[TraceRecorder] = None
_recorder_lock = threading.Lock()


def set_recorder(rec: Optional[TraceRecorder]) -> Optional[TraceRecorder]:
    """Install ``rec`` as the recorder of the program's host spans (None
    uninstalls) and return the previous one, so callers can restore it.
    The swap is atomic under a lock; a span site reads the recorder once,
    so a span opened on another thread records into the old recorder or
    the new one, never half into each."""
    global _recorder
    with _recorder_lock:
        prev, _recorder = _recorder, rec
    return prev


def span(name: str, **args):
    """A span named ``name`` in the installed recorder (``with
    obs.span("grad_shift.dense"): ...``), or, with none installed, a shared
    context manager that does nothing."""
    rec = _recorder
    if rec is None:
        return _NOOP
    return rec.span(name, **args)


def _key_str(key) -> str:
    """Compact, deterministic label for a coalescing key (CircuitSpec,
    ShiftGroupKey, simulation tuple, ...)."""
    spec = getattr(key, "spec", key)
    n_q = getattr(spec, "n_qubits", None)
    if n_q is not None:
        label = f"{n_q}q/{len(getattr(spec, 'ops', ()))}ops"
        if spec is not key:  # shift-group key
            label = f"shift:{label}"
        return label
    s = str(key)
    return s if len(s) <= 48 else s[:45] + "..."


def validate_trace(records: Iterable[CircuitTrace]) -> list[str]:
    """Well-formedness check used by tests and the demo: monotone stage
    timestamps, a terminal outcome on every record, eviction/fail spans
    closed.  Returns a list of violations (empty = well-formed)."""
    bad = []
    for r in records:
        ts = [t for _, t in r.stages]
        if any(b < a - 1e-9 for a, b in zip(ts, ts[1:])):
            bad.append(f"#{r.seq}: non-monotone stage timestamps {r.stages}")
        if r.outcome not in OUTCOMES:
            bad.append(f"#{r.seq}: no terminal outcome (stages {r.stages})")
        elif r.stages[-1][0] != r.outcome:
            bad.append(f"#{r.seq}: outcome {r.outcome} != last stage")
        names = [s for s, _ in r.stages]
        if names[0] != "submit":
            bad.append(f"#{r.seq}: trace does not open with submit")
        # recovery stages (retry / hedge / migrate / requeue) legitimately
        # send a circuit back through earlier pipeline stages, so the
        # order check only applies to untouched traces.
        order = {s: i for i, s in enumerate(LIFECYCLE_STAGES)}
        core = [s for s in names if s in order and s not in RECOVERY_STAGES]
        if not RECOVERY_STAGES.intersection(names) and any(
            order[b] < order[a] for a, b in zip(core, core[1:])
        ):
            bad.append(f"#{r.seq}: stages out of pipeline order {names}")
    return bad


__all__ = [
    "OUTCOMES",
    "RANGE_PREFIX",
    "STAGE_METRICS",
    "CircuitTrace",
    "HostSpan",
    "TraceBuffer",
    "TraceRecorder",
    "WorkerSpan",
    "WorkerTimeline",
    "set_recorder",
    "span",
    "validate_trace",
]
