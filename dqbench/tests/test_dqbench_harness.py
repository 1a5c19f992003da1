"""The harness on the CPU: cells, metrics and traffic found by name, the
result line, the comparison against the planted faults and the control,
the trace reader, the counters, and the import rules."""
import ast
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import counters
import faults
import harness
import ref_quclassi
import run as run_mod
import tracing

BENCH = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_tiny(root, name, trace=False, **kw):
    out, _ = harness.run(name, 2**31 + 77, 0.2, trace, CPU, time.perf_counter(),
                         bench=root / "dqbench", root=root, **kw)
    return out


def test_added_cell_config_traffic_and_metric_are_found_by_name(tiny_root):
    bench = tiny_root / "dqbench"
    cfg = json.loads((bench / "configs" / "quclassi-7q-3l.json").read_text())
    (bench / "configs" / "quclassi-5q-1l.json").write_text(json.dumps(dict(cfg, qc=5, n_layers=1)))
    (bench / "traffic" / "closed.b6.json").write_text(json.dumps(
        {"loop": "closed", "tenants": 1, "batch": 6, "pool_batches": 3, "noise": 0.1}))
    (bench / "cells" / "train.5q1l.b6.json").write_text(
        (bench / "cells" / "train.7q3l.b4096.json").read_text())
    (bench / "metrics" / "steps_done.py").write_text("def read(ctx):\n    return ctx.steps\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "train.5q1l.b6", "config": "quclassi-5q-1l",
                              "traffic": "closed.b6", "chips": 1, "why": "added"})
    spec["end_to_end"].append({"name": "steps_done", "unit": "steps", "better": "higher",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["train.5q1l.b6"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("train.5q1l.b6", tiny_root, bench)
    assert (cell.model.qc, cell.traffic["batch"]) == (5, 6)
    out = run_tiny(tiny_root, "train.5q1l.b6")
    assert out["correct"]
    assert out["metrics"]["steps_done"]["value"] >= 1
    assert set(out["metrics"]) == {"train_circuits_per_s", "train_step_p95_ms", "setup_s",
                                   "steps_done"}
    assert "steps_done" not in run_tiny(tiny_root, "tiny.7q")["metrics"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(tiny_root, trace):
    out = run_tiny(tiny_root, "tiny.7q", trace=trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == want
    assert json.loads(json.dumps(out)) == out
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(out["metrics"]) <= {m["name"] for m in harness.load_cell(
            "tiny.7q", tiny_root, tiny_root / "dqbench").per_layer}
        assert "mfu.train" in out["metrics"] and "executor_host_ms.train" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"train_circuits_per_s", "train_step_p95_ms", "setup_s"}
    for v in out["checks"].values():
        assert set(v) == {"value", "limit"}


@pytest.mark.parametrize("name", ["tiny.7q", "tiny.5q1l.nodense"])
def test_sound_run_is_correct(tiny_root, name):
    out = run_tiny(tiny_root, name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 4


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_planted_fault_is_caught(tiny_root, fault):
    with faults.FAULTS[fault]():
        out = run_tiny(tiny_root, "tiny.7q")
    assert not out["correct"], out["checks"]


def test_control_in_tf32_is_caught(tiny_root):
    cell = harness.load_cell("tiny.7q", tiny_root, tiny_root / "dqbench")
    out = run_tiny(tiny_root, "tiny.7q", step_impl=faults.control(cell))
    assert not out["correct"], out["checks"]


def test_run_without_cuda_prints_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run_mod.main(["--workload", "train.7q3l.b4096", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_trace_reader_ties_ops_to_spans():
    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    ev = [x("user_annotation", "dq:window", 0, 100), x("user_annotation", "dq:step", 0, 100),
          x("user_annotation", "dq:grad_shift", 0, 60),
          x("user_annotation", "dq:executor", 10, 20), x("user_annotation", "dq:update", 60, 20),
          x("cuda_runtime", "cudaLaunchKernel", 5, 1, 1),
          x("cuda_runtime", "cudaLaunchKernel", 15, 1, 2),
          x("cuda_runtime", "cudaLaunchKernel", 65, 1, 3),
          x("kernel", "seg", 6, 4, 1), x("kernel", "shiftbank_kernel", 16, 30, 2),
          x("kernel", "sgd", 66, 10, 3), x("kernel", "before", -50, 10, 9)]
    t = tracing.read({"traceEvents": ev}, 1)
    assert [(o.name, o.span) for o in t.ops] == [
        ("seg", "bank_build"), ("shiftbank_kernel", "executor"), ("sgd", "update")]
    assert t.busy_s == pytest.approx(44e-6) and t.window_s == pytest.approx(100e-6)
    assert t.gaps[0] == ("step", pytest.approx(24e-6))
    assert ("assemble_dense", pytest.approx(20e-6)) in t.gaps
    assert t.top_ops(1) == [["shiftbank_kernel", pytest.approx(30e-6)]]


def test_counters_reproduce_the_recorded_bounds():
    m27 = ref_quclassi.Model(27, 3, 2, 4, 2, (8, 8), False)
    m7 = ref_quclassi.Model(7, 3, 2, 4, 2, (8, 8), True)
    whole = tuple(range(1 + 2 * m27.n_theta))
    ms, by = counters.bound_s(1152 * counters.share_flops(m27, whole),
                              1152 * counters.share_bytes(m27, whole))
    assert (round(ms * 1e3, 6), by) == (0.399461, "operations")
    worker0 = counters.round_robin(1 + 2 * m7.n_theta, 4)[0]
    assert len(worker0) == 8
    ms, by = counters.bound_s(576 * counters.share_flops(m7, worker0),
                              576 * counters.share_bytes(m7, worker0))
    assert (f"{ms * 1e3:.7f}", by) == ("0.0000193", "bytes")
    assert counters.circuits_per_step(m7, 4096) == 2_138_112
    assert counters.circuits_per_step(m27, 64) == 171_648


FOREIGN = {"jax", "jaxlib", "flax", "repro"}
#: modules of the yardstick that must not read the program either
REFERENCE = ("ref_quclassi.py", "digits.py", "counters.py")


def imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not imported(path) & FOREIGN, path
    for name in REFERENCE:
        assert "repro_torch" not in imported(BENCH / name), name


def test_nothing_reads_the_old_harness():
    old = "bench" + "marks"
    for path in BENCH.rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json"):
            assert f"{old}/" not in path.read_text() and f"{old}." not in path.read_text(), path


def run_cli(cwd, *args):
    return subprocess.run([sys.executable, "dqbench/run.py", "--workload", "train.7q3l.b4096",
                           "--seed", str(2**31 + 9), "--seconds", "1", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_run_on_card_prints_one_result_line(cuda, trace):
    proc = run_cli(BENCH.parent, "--trace", trace)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert proc.stderr.strip().splitlines()[-1].startswith("check change_gap")


@pytest.mark.requires_cuda
def test_stripped_checkout_gives_no_result(cuda, tmp_path):
    shutil.copytree(BENCH, tmp_path / "dqbench")
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    proc = run_cli(tmp_path, "--trace", "0")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_dense_gradient_counted_on_registers():
    m7 = ref_quclassi.Model(7, 3, 2, 4, 2, (8, 8), True)
    samples = 4096 * m7.n_patches
    base = counters.share_flops(m7, (0,))
    assert counters.dense_flops(m7, samples) == 3 * samples * (2 * base + 2 * 16 * 6)
    banks = counters.step_flops(m7, 4096, 4) - counters.dense_flops(m7, samples)
    assert banks == 2 * samples * sum(counters.share_flops(m7, g)
                                      for g in counters.round_robin(29, 4))
    assert counters.step_flops(m7, 4096, 4) == 880_017_408


def test_idle_share_reads_the_untraced_step():
    read = harness.load_reader("device_idle_share.train")
    trace = tracing.Trace([], (0.0, 2.0), 10, 0.5, [])
    ctx = harness.Context(None, None, 1.0, 100, 7.0, [0.07] * 100, 0.0, trace)
    assert read(ctx) == pytest.approx(100 * (1 - 0.05 / 0.07))
    assert read(harness.Context(None, None, 1.0, 100, 7.0, [], 0.0, None)) is None
