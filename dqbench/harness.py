"""One run of one cell: set-up, the measured window, the traced stretch, the
comparison with the plain reference, and the result line.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file found by its name: ``cells/<workload>.json`` (the harness's
parameters of the cell: workers, learning rate, steps to trace, the
limits of the comparison), ``configs/<config>.json`` (the model as run),
``traffic/<traffic>.json`` (read by ``feed.Feed``) and
``metrics/<metric>.py`` (a ``read(ctx)`` that returns the metric's value,
or None where the run has nothing to read).  ``BENCHMARK.json`` names the
cell's configuration, traffic and chips, and which metrics it reports.

The window drives the training step as the body of the batch loop of the
program's ``core/trainer.train`` runs it (a copy of that body: the loop
runs whole epochs and offers no hook between its steps): the batch copied
from the host to the device, ``quclassi.grad_shift`` through the cell's
executor, the optimizer's ``update`` and ``apply_updates``, the loss read
back.  Set-up builds that
step once and drives it through its first ``CHECK_STEPS`` steps (which
also build the kernels and warm every shape), then hands the same objects
to the window.  Once the window has closed, the reference follows those
first steps from the same start and batches, and the run compares each
step's loss, the first gradient by its worst leaf, and the parameters'
change by its worst leaf.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

import counters
import feed as feed_mod
import ref_quclassi
import tracing

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FOREIGN = ("jax", "jaxlib", "flax", "repro")
#: the steps set-up drives and the reference follows
CHECK_STEPS = 3


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    entry: dict      # the workload's entry in BENCHMARK.json
    params: dict     # cells/<name>.json
    config: dict     # configs/<config>.json
    traffic: dict    # traffic/<traffic>.json
    end_to_end: list
    per_layer: list

    @property
    def model(self) -> ref_quclassi.Model:
        return ref_quclassi.model_from_config(self.config)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether the cell reports ``metric``: those its ``workloads`` list, or
    without the list every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    spec = _json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, names)]
    config = dict(_json(bench / "configs" / f"{entry['config']}.json"), name=entry["config"])
    traffic = dict(_json(bench / "traffic" / f"{entry['traffic']}.json"), name=entry["traffic"])
    return Cell(name, entry["chips"], entry, _json(bench / "cells" / f"{name}.json"),
                config, traffic, e2e, per_layer)


def load_reader(metric: str, bench: Path = BENCH):
    path = bench / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"dqbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ------------------------------------------------------------ the program
def initial_params(model, seed: int, device) -> dict:
    """The start of training from the seed, made on the device in the
    program's type: theta ~ U[0, pi], the dense layer's w ~ N(0, 1 /
    patch size) and b = 0 (Algorithm 1 l.2)."""
    g = torch.Generator(device=device).manual_seed(seed)
    params = {"theta": torch.rand((model.n_classes, model.n_theta), generator=g,
                                  device=device) * math.pi}
    if model.use_dense:
        fw2 = model.filter_width**2
        params["w"] = torch.randn((fw2, model.n_angles), generator=g, device=device) / math.sqrt(fw2)
        params["b"] = torch.zeros(model.n_angles, device=device)
    return params


class Trainer:
    """The system under test: QuClassi's Algorithm-1 step through the
    program's data plane (implicit banks, each class's bank split over the
    cell's ``workers`` by the round robin over its groups), SGD at the
    cell's ``lr``, and the trainer's arithmetic."""

    def __init__(self, cell: Cell, params: dict, spans: tracing.Spans, device):
        from repro_torch.comanager import dataplane
        from repro_torch.core import quclassi, segmentation
        from repro_torch.optim import optimizers

        c, p = cell.config, cell.params
        self.cfg = quclassi.QuClassiConfig(
            qc=c["qc"], n_layers=c["n_layers"], n_classes=c["n_classes"],
            seg=segmentation.SegmentationConfig(
                filter_width=c["filter_width"], stride=c["stride"], n_filters=c["n_filters"]),
            image_size=(c["image_height"], c["image_width"]), use_dense=c["use_dense"])
        n_groups = 1 + 2 * self.cfg.n_theta
        assign = dataplane.round_robin_assignment(n_groups, p["workers"])
        self.spans, self.device = spans, device
        self.executor = spans.timed_executor(
            dataplane.worker_batched_executor(self.cfg.spec, assign, p["workers"]))
        self.opt = optimizers.make("sgd", p["lr"])
        self.params = dict(params)
        self.opt_state = self.opt.init(self.params)

    def to_device(self, images, labels):
        """A batch from the host, copied as the trainer's loop copies it."""
        return (torch.as_tensor(images, device=self.device),
                torch.as_tensor(labels, device=self.device))

    def step(self, images, labels):
        """One step on a batch from the host -> (loss as read back, the
        gradients the optimizer got)."""
        from repro_torch.core import quclassi
        from repro_torch.optim import optimizers

        images, labels = self.to_device(images, labels)
        with self.spans.span("grad_shift"):
            loss, grads, _ = quclassi.grad_shift(
                self.cfg, self.params, images, labels, executor=self.executor, implicit=True)
        with self.spans.span("update"):
            updates, self.opt_state = self.opt.update(grads, self.opt_state, self.params)
            self.params = optimizers.apply_updates(self.params, updates)
        with self.spans.span("readback"):
            return float(loss), grads


# ------------------------------------------------------------ comparison
def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def leaf_gaps(got: dict, want: dict, among=None) -> dict:
    """Per leaf | |got| - |want| | / max(|want|, median leaf's |want|): the
    gap between the two norms, leaf by leaf."""
    g, w = _norms(got), _norms(want)
    med = statistics.median(w.values())
    return {k: abs(g[k] - w[k]) / max(w[k], med, 1e-300)
            for k in w if among is None or k in among}


def compare(prog: dict, ref_losses, ref_grads, ref_params, params0, leaves=None) -> dict:
    """The numbers compared: each step's loss, the first gradient and the
    parameters' change after the checked steps, each by its worst leaf.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of the change (they move by round-off alone).
    ``leaves``, a dict, gets the gaps leaf by leaf."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref_losses))
    grad = leaf_gaps(prog["grads"], ref_grads)
    gn = _norms(ref_grads)
    med = statistics.median(gn.values())
    moving = [k for k in gn if gn[k] >= 1e-3 * med]
    d_prog = {k: prog["params"][k].double() - params0[k].double() for k in params0}
    d_ref = {k: ref_params[k].double() - params0[k].double() for k in params0}
    change = leaf_gaps(d_prog, d_ref, among=moving)
    if leaves is not None:
        leaves.update({f"grad.{k}": v for k, v in grad.items()})
        leaves.update({f"change.{k}": v for k, v in change.items()})
    return {"loss_gap": loss_gap, "grad_gap": max(grad.values()),
            "change_gap": max(change.values())}


def reference(cell: Cell, params0: dict, batches, prec=None):
    """The plain reference's first steps, on the device of ``params0``."""
    prec = prec or ref_quclassi.Precision(torch.float64)
    return ref_quclassi.follow(cell.model, params0, batches, cell.params["lr"], prec)


def foreign_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


# ------------------------------------------------------------------- run
@dataclasses.dataclass
class Context:
    """What a metric reader reads."""
    cell: Cell
    model: object
    setup_s: float
    steps: int
    window_s: float
    step_s: list
    executor_s: float
    trace: object = None
    counters: object = counters


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(name: str, seed: int, seconds: float, trace: bool, device, t_start: float,
        step_impl=None, bench: Path = BENCH, root: Path = ROOT) -> tuple[dict, dict]:
    """One run of cell ``name``; returns the result line's object and, for
    the log, the compared gaps leaf by leaf and the set-up's stages (s from
    ``t_start``).  ``step_impl(trainer, images, labels)`` replaces the
    trainer's step, for the control (the reference in the precision below
    the program's)."""
    marks = {"imported": time.perf_counter() - t_start}
    cell = load_cell(name, root, bench)
    torch.backends.cuda.matmul.allow_tf32 = False   # the program's float32, as stated
    torch.backends.cudnn.allow_tf32 = False
    model = cell.model
    check_steps = CHECK_STEPS
    feed = feed_mod.Feed(cell.traffic, cell.config, seed)
    spans = tracing.Spans()
    params0 = initial_params(model, seed, device)
    trainer = Trainer(cell, params0, spans, device)
    step = (lambda x, y: step_impl(trainer, x, y)) if step_impl else trainer.step
    sync(device)
    marks["built"] = time.perf_counter() - t_start

    # set-up: the first steps, which build and warm everything the window runs
    losses, first, failed = [], None, 0
    for k in range(check_steps):
        loss, grads = step(*feed(k))
        losses.append(loss)
        first = first if first is not None else {g: v.detach().clone() for g, v in grads.items()}
        marks[f"step{k + 1}"] = time.perf_counter() - t_start
    checked = {"losses": losses, "grads": first,
               "params": {k: v.detach().clone() for k, v in trainer.params.items()}}
    failed += sum(not math.isfinite(x) for x in losses)
    sync(device)
    setup_s = time.perf_counter() - t_start

    # the measured window: closed loop, one step after the other
    spans.executor_s = 0.0
    step_s, k = [], check_steps
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        loss, _ = step(*feed(k))
        b = time.perf_counter()
        step_s.append(b - a)
        failed += not math.isfinite(loss)
        k += 1
        if b - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    executor_s = spans.executor_s
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    attempted = check_steps + len(step_s)

    traced = None
    if trace:
        n = cell.params["trace_steps"]
        start = k

        losses = []

        def stretch():
            losses.append(step(*feed(start))[0])   # the profiler's own first step
            spans.tracing = True
            try:
                with spans.span("window"):
                    for i in range(n):
                        with spans.span("step"):
                            losses.append(step(*feed(start + 1 + i))[0])
            finally:
                spans.tracing = False

        raw = tracing.profile(stretch, root / "build" / "dqbench" / f"trace-{name}.json", device)
        traced = tracing.read(raw, n)
        del raw
        attempted += len(losses)
        failed += sum(not math.isfinite(x) for x in losses)

    # the program's state goes before the reference runs
    del trainer, step
    if device.type == "cuda":
        torch.cuda.empty_cache()
    batches = [tuple(torch.as_tensor(a, device=device) for a in feed(i))
               for i in range(check_steps)]
    ref_losses, ref_grads, ref_params = reference(cell, params0, batches)
    leaves = {}
    checks = compare(checked, ref_losses, ref_grads, ref_params, params0, leaves)
    limits = cell.params["limits"]
    correct = failed == 0 and all(
        math.isfinite(v) and v <= limits[k] for k, v in checks.items())

    ctx = Context(cell, model, setup_s, len(step_s), window_s, step_s, executor_s, traced)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_reader(m["name"], bench)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak,
           "power_limit_w": power_limit_w() if device.type == "cuda" else None}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
        out["breakdown"] = {"device_ops": traced.top_ops(10),
                            "idle_gaps": [[s, g] for s, g in traced.gaps[:10]]}
    out["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    qs = statistics.quantiles(step_s, n=100, method="inclusive") if len(step_s) > 1 else step_s * 99
    steps_ms = {"n": len(step_s), "p50": qs[49] * 1e3, "p90": qs[89] * 1e3,
                "p95": qs[94] * 1e3, "p99": qs[98] * 1e3, "max": max(step_s) * 1e3,
                "quarters": [statistics.fmean(step_s[i * len(step_s) // 4:(i + 1) * len(step_s) // 4]
                                              or step_s) * 1e3 for i in range(4)]}
    return out, {"leaves": leaves, "setup": marks, "steps_ms": steps_ms}
