"""The harness's spans and the reading of a ``torch.profiler`` trace.

Spans are the harness's own, around its calls into the program's layers:
``step`` around a whole training step, ``grad_shift`` around the gradient
call, ``executor`` around each call the program makes into the executor
the harness handed it, ``update`` around the optimizer, ``readback``
around reading the loss.  In the measured window they cost a branch (and
the executor's host clock); in a traced stretch each also opens a
``record_function`` range, so that the trace ties every device operation
to the span its launch was made in, and every idle gap of the device to
the span the host was in.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from pathlib import Path

import torch

PREFIX = "dq:"
#: nesting depth of the harness's spans: an inner span names the host's work
DEPTH = {"window": 0, "step": 1, "executor": 3}


class Spans:
    def __init__(self):
        self.tracing = False
        self.executor_s = 0.0

    @contextlib.contextmanager
    def span(self, name: str):
        if self.tracing:
            with torch.profiler.record_function(PREFIX + name):
                yield
        else:
            yield

    def timed_executor(self, run):
        """``run`` with its host time added to ``executor_s`` and, when
        tracing, inside an ``executor`` span; the same capabilities."""
        from repro_torch.api.capabilities import capabilities_of, declare

        def call(*args):
            t0 = time.perf_counter()
            try:
                with self.span("executor"):
                    return run(*args)
            finally:
                self.executor_s += time.perf_counter() - t0

        caps = capabilities_of(run)
        return declare(call, shiftbank=caps.shiftbank, multibank=caps.multibank)


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float   # s, on the trace's clock
    dur: float     # s
    span: str      # the harness span its launch was made in ("" if none)


@dataclasses.dataclass
class Trace:
    ops: list                # DeviceOp, kernels, copies and sets
    window: tuple            # (start, end) s of the traced steps
    steps: int
    busy_s: float            # union of device ops inside the window
    gaps: list               # (span the host was in, seconds), longest first

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def ops_named(self, part: str) -> list:
        return [o for o in self.ops if part in o.name]

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for o in self.ops:
            by[o.name] = by.get(o.name, 0.0) + o.dur
        return [[k[:160], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def profile(fn, path: Path, device):
    """Run ``fn`` under ``torch.profiler`` (host and, on a card, device),
    write the chrome trace to ``path`` and return it parsed."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = device.type == "cuda"
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize(device)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def host_span_at(t: float, ranges) -> str:
    """The innermost harness span of the main thread at time ``t``; inside
    ``grad_shift`` but outside its executor calls, the part of the gradient
    call: ``bank_build`` before its first executor call, ``assemble``
    between two, ``assemble_dense`` (the last class's assembly and the
    dense layer's gradient) after the last."""
    around = [(DEPTH.get(n, 2), a - b, n, a, b) for n, a, b in ranges if a <= t < b]
    if not around:
        return "outside"
    *_, name, a, b = max(around)
    if name != "grad_shift":
        return name
    calls = [(x, y) for n, x, y in ranges if n == "executor" and a <= x and y <= b]
    if not calls:
        return "grad_shift"
    if t < calls[0][0]:
        return "bank_build"
    if t >= calls[-1][1]:
        return "assemble_dense"
    return "assemble"


def read(trace: dict, steps: int) -> Trace:
    """Device ops of the ``window`` span, each tied through its launch to
    the harness span the launch was made in; the device's busy time there
    and its idle gaps by the span the host was in.  The harness's spans are
    all on the thread that drives the step, and a launch made on another
    thread (a worker's) is made while that thread waits in one of them."""
    ranges, launches, device = [], {}, []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), e["ts"] * 1e-6, e.get("dur", 0) * 1e-6
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            ranges.append((e["name"][len(PREFIX):], ts, ts + dur))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((e.get("name", "?"), ts, dur, e.get("args", {}).get("correlation")))
    windows = [(a, b) for n, a, b in ranges if n == "window"]
    if not windows:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = windows[0]
    ranges.sort(key=lambda r: r[1])
    ops = []
    for name, ts, dur, corr in device:
        if ts + dur <= w0 or ts >= w1:
            continue
        at = launches.get(corr)
        ops.append(DeviceOp(name, ts, dur, "" if at is None else host_span_at(at, ranges)))
    busy = _union((max(o.start, w0), min(o.start + o.dur, w1)) for o in ops)
    busy_s = sum(b - a for a, b in busy)
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((host_span_at((t + a) / 2, ranges), a - t))
        t = max(t, b)
    gaps.sort(key=lambda g: -g[1])
    return Trace(ops, (w0, w1), steps, busy_s, gaps)
