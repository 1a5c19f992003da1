"""The program's own spans in a traced run.

The program (``repro_torch``) opens a span at each layer boundary of its
training step (``grad_shift`` and its parts, ``dataplane.run`` and its
workers) into the recorder that ``repro_torch.obs.set_recorder`` installed;
under an active ``torch.profiler`` each span is also a range ``rt:<name>``
of the profiler's trace.  ``measure`` builds the cell's step afresh once
the run's own reading is done and drives it, with a recorder installed,
through two stretches:

* a spanned one of ``SPANNED_STEPS`` steps without the profiler, whose
  per-name totals give host times that the profiler has not stretched.  It
  goes first: steps after a second profiler session in one process ran
  slower on the card;
* a profiled one of the cell's ``trace_steps`` steps, read by ``read``:
  every device operation (kernel, copy, set) is tied, through the
  correlation of its runtime launch, to the innermost program span in
  force when the launch was made, and every idle gap of the device to the
  innermost program span the host was in.  A launch made on a thread that
  holds no program span (autograd's device thread, while the step's thread
  waits in ``torch.autograd.grad``) is tied by time to the step's thread's
  spans.  Outside every program span, the harness's own span names the
  time (``dq:update``, ``dq:readback``, ``dq:step`` for the batch's copy).

Against a program without host spans ``measure`` returns None and runs
nothing, so the metrics that read it are left out of the result line.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

import feed as feed_mod
import tracing

PREFIX = "rt:"
#: steps that warm the freshly built step
WARM_STEPS = 5
#: steps of the spanned stretch
SPANNED_STEPS = 40


@dataclasses.dataclass
class ProgramTrace:
    steps: int      # the traced steps read: those whose every device operation was kept
    traced: int     # the traced steps
    device: dict    # program span -> [device seconds, operations] of the launches made in it
    gaps: list      # (span the host was in, seconds), longest first

    def under(self, name: str) -> tuple[float, int]:
        """Device seconds and operations of the launches made in ``name``
        or in a span below it (``name.<part>``)."""
        s, n = 0.0, 0
        for span, (secs, ops) in self.device.items():
            if span == name or span.startswith(name + "."):
                s, n = s + secs, n + ops
        return s, n


@dataclasses.dataclass
class Reading:
    steps: int
    host: dict               # span name -> {"count", "total_s", "self_s"}, spanned stretch
    trace: ProgramTrace      # the profiled stretch


def _timeline(ranges):
    """Segment starts and, for each segment, the innermost of ``ranges``
    ((name, start, end), nested as one thread's ranges are) over it."""
    points, names, stack = [], [], []
    for name, a, b in sorted(ranges, key=lambda r: (r[1], -r[2])):
        while stack and stack[-1][2] <= a:
            end = stack.pop()[2]
            points.append(end)
            names.append(stack[-1][0] if stack else None)
        if stack:
            b = min(b, stack[-1][2])   # rounding of the trace's microseconds
        stack.append((name, a, b))
        points.append(a)
        names.append(name)
    while stack:
        end = stack.pop()[2]
        points.append(end)
        names.append(stack[-1][0] if stack else None)
    return points, names


def _at(timeline, t: float):
    points, names = timeline
    i = bisect.bisect_right(points, t) - 1
    return names[i] if i >= 0 else None


#: runtime calls that put an operation on the device
LAUNCHES = ("LaunchKernel", "Memcpy", "Memset")


def read(trace: dict) -> ProgramTrace:
    """Device operations of the ``dq:window`` range by the program span
    their launch was made in, and the device's idle gaps there by the
    program span the host was in, over the traced steps (``dq:step``)
    whose every record the trace kept.

    A profiler session may lose records, more often in a process that has
    profiled before, and then mostly late in its stretch.  A step is read
    where each launch made while it was open (a kernel launch, a copy or a
    set, on any thread) has its device operation and each operation
    launched in it has its launch; an operation whose launch was lost
    counts against the step it ran in."""
    ranges, dq, launches, device = {}, [], {}, []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = e["ts"] * 1e-6, e.get("dur", 0) * 1e-6
        if cat == "user_annotation" and name.startswith(PREFIX):
            ranges.setdefault(e.get("tid"), []).append((name[len(PREFIX):], ts, ts + dur))
        elif cat == "user_annotation" and name.startswith(tracing.PREFIX):
            dq.append((name[len(tracing.PREFIX):], ts, ts + dur))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ts, e.get("tid"), any(k in name for k in LAUNCHES))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((ts, dur, e.get("args", {}).get("correlation")))
    windows = [(a, b) for n, a, b in dq if n == "window"]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = windows[0]
    steps = sorted((a, b) for n, a, b in dq if n == "step" and w0 <= a < w1)
    if not steps:
        raise RuntimeError("the trace's window holds no step span")
    dq.sort(key=lambda r: r[1])
    timelines = {tid: _timeline(r) for tid, r in ranges.items()}
    # the step's thread: the one that holds the longest program span
    main = max(ranges, key=lambda tid: max(b - a for _, a, b in ranges[tid]), default=None)
    starts = [a for a, _ in steps]

    def step_at(t):
        i = bisect.bisect_right(starts, t) - 1
        return i if i >= 0 and t < steps[i][1] else None

    def name_at(t, tid=None):
        name = _at(timelines[tid], t) if tid in timelines else None
        if name is None and main is not None:
            name = _at(timelines[main], t)
        return name or "dq:" + tracing.host_span_at(t, dq)

    ops = [[] for _ in steps]          # (start, dur, span) of the operations launched in each step
    lost = [False] * len(steps)
    done = set()
    for ts, dur, corr in device:
        at = launches.get(corr)
        if at is None:
            i = step_at(ts)
            if i is not None:
                lost[i] = True
            continue
        done.add(corr)
        i = step_at(at[0])
        if i is not None:
            ops[i].append((ts, dur, name_at(at[0], at[1])))
    for corr, (ts, _, puts) in launches.items():
        i = step_at(ts) if puts and corr not in done else None
        if i is not None:
            lost[i] = True
    by, gaps, kept = {}, [], 0
    for (a0, b0), step_ops, bad in zip(steps, ops, lost):
        if bad:
            continue
        kept += 1
        for _, dur, span in step_ops:
            got = by.setdefault(span, [0.0, 0])
            got[0] += dur
            got[1] += 1
        busy = tracing._union((max(ts, a0), min(ts + dur, b0)) for ts, dur, _ in step_ops
                              if ts < b0 and ts + dur > a0)
        t = a0
        for a, b in busy + [[b0, b0]]:
            if a > t:
                gaps.append((name_at((t + a) / 2), a - t))
            t = max(t, b)
    gaps.sort(key=lambda g: -g[1])
    return ProgramTrace(kept, len(steps), by, gaps)


def _seed(default: int = 0) -> int:
    """The run's ``--seed``, as ``run.py`` was given it."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--seed", type=int, default=default)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def measure(ctx):
    """The two stretches on a freshly built step of ``ctx``'s cell, on the
    card wherever there is one (as ``run.py`` runs every cell) -> a
    ``Reading``, or None where the program has no host spans."""
    from repro_torch import obs
    if not hasattr(obs, "set_recorder"):
        return None
    import harness

    cell, n = ctx.cell, ctx.cell.params["trace_steps"]
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    seed = _seed()
    feed = feed_mod.Feed(cell.traffic, cell.config, seed)
    spans = tracing.Spans()
    trainer = harness.Trainer(cell, harness.initial_params(ctx.model, seed, device), spans, device)
    for k in range(WARM_STEPS):
        trainer.step(*feed(k))

    rec = obs.TraceRecorder()
    prev = obs.set_recorder(rec)
    try:
        harness.sync(device)
        spans.executor_s = 0.0
        t0 = time.perf_counter()
        for i in range(SPANNED_STEPS):
            trainer.step(*feed(WARM_STEPS + i))
        spanned_s = (time.perf_counter() - t0) / SPANNED_STEPS
        executor_s = spans.executor_s / SPANNED_STEPS
    finally:
        obs.set_recorder(prev)

    first = WARM_STEPS + SPANNED_STEPS

    def stretch():
        trainer.step(*feed(first))   # the profiler's own first step
        spans.tracing = True
        try:
            with spans.span("window"):
                for i in range(n):
                    with spans.span("step"):
                        trainer.step(*feed(first + 1 + i))
        finally:
            spans.tracing = False

    prev = obs.set_recorder(obs.TraceRecorder())
    try:
        with tempfile.TemporaryDirectory() as tmp:
            raw = tracing.profile(stretch, Path(tmp) / "trace.json", device)
    finally:
        obs.set_recorder(prev)
    traced = read(raw)
    del raw, trainer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    host = rec.summary().get("spans", {})
    print(f"program traced steps read: {traced.steps} of {traced.traced}; device ms and "
          "operations a step, by span: " + json.dumps(
              {k: [secs / max(traced.steps, 1) * 1e3, ops / max(traced.steps, 1)]
               for k, (secs, ops) in sorted(traced.device.items())}), file=sys.stderr)
    print("program idle gaps: " + json.dumps([[s, g] for s, g in traced.gaps[:10]]),
          file=sys.stderr)
    print("program spans, ms a step (total, self): " + json.dumps(
        {k: [v["total_s"] / SPANNED_STEPS * 1e3, v["self_s"] / SPANNED_STEPS * 1e3]
         for k, v in host.items()}),
        file=sys.stderr)
    print(f"program spanned step ms: {spanned_s * 1e3!r} against the window's "
          f"{ctx.window_s / max(ctx.steps, 1) * 1e3!r}; the harness's executor wrapper "
          f"{executor_s * 1e3!r} ms a step there", file=sys.stderr)
    return Reading(SPANNED_STEPS, host, traced)


def of(ctx):
    """``measure(ctx)``, made once for all the metrics that read it."""
    got = getattr(ctx, "program", None)
    if got is None:
        got = ctx.program = measure(ctx)
    return got


def host_ms(ctx, name: str):
    """Host ms a step inside the program span ``name``, from the spanned
    stretch."""
    r = of(ctx)
    if r is None or name not in r.host:
        return None
    return r.host[name]["total_s"] / r.steps * 1e3
