"""The reading of the program's own spans: device operations tied to the
program span of their launch (a launch from a second thread by the step's
thread's spans), idle gaps by the program span the host was in, the
metrics a traced run reports from them on the CPU, and a program without
host spans, whose metrics are left out."""
import time

import pytest
import torch

import harness
import program_trace

CPU = torch.device("cpu")
NEW = ("dense_grad_host_ms.train", "dense_grad_device_ms.train",
       "dense_grad_launches.train", "dataplane_host_ms.train")


def x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reader_ties_ops_to_program_spans():
    ua = "user_annotation"
    ev = [x(ua, "dq:window", 0, 200), x(ua, "dq:step", 0, 200),
          x(ua, "dq:grad_shift", 0, 150), x(ua, "rt:grad_shift", 1, 148),
          x(ua, "rt:grad_shift.bank_build", 2, 8),
          x(ua, "rt:grad_shift.execute", 10, 30), x(ua, "rt:dataplane.run", 11, 28),
          x(ua, "rt:dataplane.worker", 12, 10),
          x(ua, "rt:grad_shift.dense", 60, 89), x(ua, "rt:grad_shift.dense.forward", 61, 20),
          x(ua, "rt:grad_shift.dense.backward", 81, 67),
          x(ua, "dq:update", 150, 20),
          x("cuda_runtime", "cudaLaunchKernel", 3, 1, 1),
          x("cuda_runtime", "cudaLaunchKernel", 13, 1, 2),
          x("cuda_runtime", "cudaLaunchKernel", 62, 1, 3),
          # autograd's device thread, while the step's thread is in the backward
          x("cuda_runtime", "cudaLaunchKernel", 90, 1, 4, tid=7),
          x("cuda_runtime", "cudaMemcpyAsync", 95, 1, 5, tid=7),
          x("cuda_runtime", "cudaLaunchKernel", 155, 1, 6),
          x("kernel", "seg", 4, 4, 1), x("kernel", "shiftbank_kernel", 14, 30, 2),
          x("kernel", "gemv", 63, 10, 3), x("kernel", "sgemm", 91, 20, 4),
          x("gpu_memcpy", "copy", 112, 5, 5), x("kernel", "sgd", 156, 10, 6),
          x("kernel", "before", -50, 10, 9)]
    t = program_trace.read({"traceEvents": ev})
    assert (t.steps, t.traced) == (1, 1)
    assert t.device == {"grad_shift.bank_build": [pytest.approx(4e-6), 1],
                        "dataplane.worker": [pytest.approx(30e-6), 1],
                        "grad_shift.dense.forward": [pytest.approx(10e-6), 1],
                        "grad_shift.dense.backward": [pytest.approx(25e-6), 2],
                        "dq:update": [pytest.approx(10e-6), 1]}
    secs, ops = t.under("grad_shift.dense")
    assert (secs, ops) == (pytest.approx(35e-6), 3)
    # by name: the data plane's spans are not parts of grad_shift's name
    assert t.under("grad_shift") == (pytest.approx(39e-6), 4)
    assert t.gaps == [("grad_shift.dense.backward", pytest.approx(39e-6)),
                      ("dq:step", pytest.approx(34e-6)),
                      ("grad_shift", pytest.approx(19e-6)),
                      ("grad_shift.dense.backward", pytest.approx(18e-6)),
                      ("dataplane.run", pytest.approx(6e-6)),
                      ("grad_shift.bank_build", pytest.approx(4e-6)),
                      ("grad_shift.dense.backward", pytest.approx(1e-6))]


def test_reader_leaves_out_steps_that_lost_records():
    ua = "user_annotation"
    ev = [x(ua, "dq:window", 0, 300)]
    for k in range(3):
        t0 = 100 * k
        ev += [x(ua, "dq:step", t0, 100), x(ua, "rt:grad_shift", t0 + 1, 90),
               x(ua, "rt:grad_shift.dense", t0 + 10, 80)]
        for j in range(2):
            corr = 10 * k + j
            if (k, j) != (2, 0):          # step 2 lost a launch's record
                ev.append(x("cuda_runtime", "cudaLaunchKernel", t0 + 20 + j, 1, corr))
            if (k, j) != (1, 1):          # step 1 lost a kernel's record
                ev.append(x("kernel", "k", t0 + 30 + 10 * j, 5, corr))
    t = program_trace.read({"traceEvents": ev})
    assert (t.steps, t.traced) == (1, 3)
    assert t.device == {"grad_shift.dense": [pytest.approx(10e-6), 2]}
    # idle from the step's start to its first kernel, between and after its kernels
    assert t.gaps == [("grad_shift.dense", pytest.approx(55e-6)),
                      ("grad_shift.dense", pytest.approx(30e-6)),
                      ("grad_shift.dense", pytest.approx(5e-6))]


def test_reader_needs_the_window_and_its_steps():
    with pytest.raises(RuntimeError):
        program_trace.read({"traceEvents": [x("user_annotation", "rt:grad_shift", 0, 1)]})
    with pytest.raises(RuntimeError):
        program_trace.read({"traceEvents": [x("user_annotation", "dq:window", 0, 1)]})


def run_tiny(root, trace):
    out, _ = harness.run("tiny.7q", 2**31 + 91, 0.2, trace, CPU, time.perf_counter(),
                         bench=root / "dqbench", root=root)
    return out


def test_traced_tiny_run_reports_the_program_span_metrics(tiny_root, capsys, monkeypatch):
    # the program's stretches take the card wherever there is one, as run.py does
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = run_tiny(tiny_root, True)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert out["correct"], out["checks"]
    for name in ("dense_grad_host_ms.train", "dataplane_host_ms.train"):
        assert out["metrics"][name]["value"] > 0 and out["metrics"][name]["unit"] == "ms"
    # no device on the CPU: the device's metrics are left out
    assert "dense_grad_device_ms.train" not in out["metrics"]
    assert "dense_grad_launches.train" not in out["metrics"]
    assert "executor_host_ms.train" in out["metrics"]
    err = capsys.readouterr().err
    assert "program idle gaps: " in err and "program spanned step ms: " in err
    assert not run_tiny(tiny_root, False)["metrics"].keys() & set(NEW)


def test_program_without_host_spans_leaves_the_metrics_out(tiny_root, monkeypatch):
    from repro_torch import obs
    monkeypatch.delattr(obs, "set_recorder")
    out = run_tiny(tiny_root, True)
    assert out["correct"]
    assert not out["metrics"].keys() & set(NEW)
    assert "mfu.train" in out["metrics"]
