"""The program's host spans (``repro_torch.obs.span``) in the training step,
on the CPU: the span tree of ``grad_shift`` through the data plane, results
bit-identical with and without a recorder, the ``rt:`` twin of every span
under ``torch.profiler``, one ``train.step`` per batch of ``train()``, and
the recorder's swap, totals, threads and export."""
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.comanager import dataplane as dp
from repro_torch.core import quclassi as q
from repro_torch.core import trainer
from repro_torch.data import mnist

WORKERS = 4
GRAD_NAMES = {"grad_shift", "grad_shift.bank_build", "grad_shift.execute",
              "grad_shift.assemble", "grad_shift.dense", "grad_shift.dense.forward",
              "grad_shift.dense.backward", "dataplane.run", "dataplane.worker",
              "dataplane.gather"}
PARENT = {"grad_shift": None, "grad_shift.bank_build": "grad_shift",
          "grad_shift.execute": "grad_shift", "grad_shift.assemble": "grad_shift",
          "grad_shift.dense": "grad_shift", "grad_shift.dense.forward": "grad_shift.dense",
          "grad_shift.dense.backward": "grad_shift.dense",
          "dataplane.run": "grad_shift.execute", "dataplane.worker": "dataplane.run",
          "dataplane.gather": "dataplane.run"}


@pytest.fixture
def recorder():
    rec = obs.TraceRecorder()
    prev = obs.set_recorder(rec)
    try:
        yield rec
    finally:
        obs.set_recorder(prev)


def _grad(implicit=True, batch=2, seed=0):
    """QuClassi 5q-1l's gradient on ``batch`` images through the data plane
    on ``WORKERS`` workers: the bank's groups round robin (implicit banks)
    or its rows (materialized ones)."""
    cfg = q.QuClassiConfig(qc=5, n_layers=1)
    params = q.init_params(cfg, torch.Generator().manual_seed(seed), torch.device("cpu"))
    x, y = mnist.make_pair_dataset(1, 5, n_per_class=batch, seed=seed)
    images = torch.as_tensor(x[:batch], dtype=torch.float32)
    labels = torch.as_tensor(y[:batch])
    n = 1 + 2 * cfg.n_theta
    if not implicit:
        n *= batch * cfg.n_patches
    run = dp.worker_batched_executor(cfg.spec, dp.round_robin_assignment(n, WORKERS), WORKERS)
    return q.grad_shift(cfg, params, images, labels, executor=run, implicit=implicit)


def _spans(rec):
    return rec.buffer.records(obs.HostSpan)


def test_grad_shift_records_its_span_tree(recorder):
    _grad()
    spans = _spans(recorder)
    by_id = {s.span_id: s for s in spans}
    assert {s.name for s in spans} == GRAD_NAMES
    (root,) = [s for s in spans if s.parent_id is None]
    assert root.name == "grad_shift"
    assert root.args == {"batch": 2, "classes": 2,
                         "circuits": q.total_bank_circuits(q.QuClassiConfig(), 2)}
    assert {s.step for s in spans} == {root.span_id}
    assert len({s.thread for s in spans}) == 1
    for s in spans:
        assert s.start <= s.end
        parent = by_id.get(s.parent_id)
        assert (parent.name if parent else None) == PARENT[s.name], s.name
        if parent is not None:
            assert parent.start <= s.start and s.end <= parent.end
    names = [s.name for s in spans]
    assert names.count("grad_shift.execute") == names.count("grad_shift.assemble") == 2
    assert [s.args for s in spans if s.name == "grad_shift.execute"] == [{"class": 0},
                                                                       {"class": 1}]
    runs = [s for s in spans if s.name == "dataplane.run"]
    assert len(runs) == 2 and all(r.args["workers"] == WORKERS for r in runs)
    for r in runs:
        workers = [s for s in spans if s.parent_id == r.span_id and s.name == "dataplane.worker"]
        assert sorted(w.args["worker"] for w in workers) == list(range(WORKERS))
        assert sum(w.args["groups"] for w in workers) == r.args["groups"]
        assert all(w.args["lanes"] == 2 * q.QuClassiConfig().n_patches for w in workers)
    totals = recorder.summary()["spans"]
    assert totals["dataplane.worker"]["count"] == 2 * WORKERS
    for name, t in totals.items():
        assert t["self_s"] >= 0 and t["self_s"] <= t["total_s"] + 1e-12, name
    summed_self = sum(t["self_s"] for t in totals.values())
    assert summed_self == pytest.approx(totals["grad_shift"]["total_s"], rel=1e-6, abs=1e-9)
    assert totals["grad_shift"]["count"] == 1


def test_27q_dense_gradient_records_the_wide_route(recorder):
    """At 27 qubits (m = 13) the dense layer's gradient takes the wide route:
    ``grad_shift.dense`` records ``route="wide"`` with ``.forward`` and
    ``.backward`` inside it, one of each."""
    from repro_torch.core import segmentation

    cfg = q.QuClassiConfig(qc=27, n_layers=1, seg=segmentation.SegmentationConfig(
        filter_width=8, stride=8, n_filters=4))
    params = q.init_params(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    x, y = mnist.make_pair_dataset(1, 5, n_per_class=1, seed=0)
    run = dp.worker_batched_executor(cfg.spec, dp.round_robin_assignment(1 + 2 * cfg.n_theta, 2),
                                     2)
    q.grad_shift(cfg, params, torch.as_tensor(x), torch.as_tensor(y), executor=run,
                 implicit=True)
    spans = _spans(recorder)
    (dense,) = [s for s in spans if s.name == "grad_shift.dense"]
    assert dense.args == {"route": "wide"}
    inner = [s for s in spans if s.parent_id == dense.span_id]
    assert sorted(s.name for s in inner) == ["grad_shift.dense.backward",
                                             "grad_shift.dense.forward"]
    assert all(dense.start <= s.start and s.end <= dense.end for s in inner)


@pytest.mark.parametrize("implicit", [True, False])
def test_spans_leave_loss_and_gradients_bit_identical(implicit):
    want = _grad(implicit)
    rec = obs.TraceRecorder()
    prev = obs.set_recorder(rec)
    try:
        got = _grad(implicit)
    finally:
        obs.set_recorder(prev)
    assert len(_spans(rec)) > 0
    assert torch.equal(got[0], want[0])
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k]), k
    assert torch.equal(got[2], want[2])


def _rt_ranges(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"][len(obs.RANGE_PREFIX):], e["ts"], e["ts"] + e["dur"])
                   for e in events if e.get("ph") == "X"
                   and e.get("name", "").startswith(obs.RANGE_PREFIX)), key=lambda r: r[1])


def _innermost_parent(ranges, i):
    name, a, b = ranges[i]
    around = [r for j, r in enumerate(ranges) if j != i and r[1] <= a and b <= r[2]]
    return max(around, key=lambda r: r[1])[0] if around else None


def test_spans_open_profiler_ranges_with_the_same_nesting(recorder, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _grad()
    ranges = _rt_ranges(prof, tmp_path)
    spans = sorted(_spans(recorder), key=lambda s: s.start)
    by_id = {s.span_id: s for s in spans}
    assert [r[0] for r in ranges] == [s.name for s in spans]
    for i, s in enumerate(spans):
        parent = by_id.get(s.parent_id)
        assert _innermost_parent(ranges, i) == (parent.name if parent else None), s.name


def test_no_recorder_means_no_span_and_no_profiler_range(tmp_path):
    assert obs.set_recorder(None) is None
    assert obs.span("a") is obs.span("b", x=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _grad()
    assert _rt_ranges(prof, tmp_path) == []


def test_spans_record_nothing_when_the_recorder_is_disabled():
    rec = obs.TraceRecorder(obs.ObservabilityConfig.disabled())
    prev = obs.set_recorder(rec)
    try:
        _grad()
    finally:
        obs.set_recorder(prev)
    assert len(rec.buffer) == 0 and "spans" not in rec.summary()


def test_set_recorder_returns_the_previous_one():
    a, b = obs.TraceRecorder(), obs.TraceRecorder()
    assert obs.set_recorder(a) is None
    try:
        assert obs.set_recorder(b) is a
        assert obs.set_recorder(a) is b
    finally:
        assert obs.set_recorder(None) is a


def test_train_records_one_step_per_batch(recorder):
    cfg = q.QuClassiConfig(qc=5, n_layers=1)
    x, y = mnist.make_pair_dataset(1, 5, n_per_class=4, seed=0)
    tr, te = mnist.train_test_split(x, y)
    n_batches = -(-len(tr[0]) // 2)
    run = dp.worker_batched_executor(cfg.spec, dp.round_robin_assignment(1 + 2 * cfg.n_theta, 2),
                                     2)
    rep = trainer.train(cfg, tr, te, epochs=2, batch_size=2, executor=run, device="cpu")
    spans = _spans(recorder)
    by_id = {s.span_id: s for s in spans}
    steps = [s for s in spans if s.name == "train.step"]
    assert len(steps) == 2 * n_batches
    assert [(s.args["epoch"], s.args["batch"]) for s in steps] == [
        (e, i) for e in range(2) for i in range(n_batches)]
    for st in steps:
        kids = [s.name for s in spans if s.parent_id == st.span_id]
        assert kids == ["train.h2d", "grad_shift", "train.update", "train.readback"]
        assert {s.step for s in spans if s.start >= st.start and s.end <= st.end} == {st.span_id}
    evals = [s for s in spans if s.name == "train.eval"]
    assert len(evals) == 2 and all(s.parent_id is None for s in evals)
    assert all(by_id[s.parent_id].name == "train.step" for s in spans if s.name == "grad_shift")
    assert len(rep.epochs) == 2


def test_train_gives_the_same_report_with_and_without_a_recorder():
    cfg = q.QuClassiConfig(qc=5, n_layers=1)
    x, y = mnist.make_pair_dataset(1, 5, n_per_class=4, seed=3)
    tr, te = mnist.train_test_split(x, y)
    kw = dict(epochs=1, batch_size=2, device="cpu", seed=3)
    want = trainer.train(cfg, tr, te, **kw)
    rec = obs.TraceRecorder()
    prev = obs.set_recorder(rec)
    try:
        got = trainer.train(cfg, tr, te, **kw)
    finally:
        obs.set_recorder(prev)
    assert rec.summary()["spans"]["train.step"]["count"] == len(tr[0]) // 2
    assert got.epochs[0].loss == want.epochs[0].loss
    for k in want.params:
        assert torch.equal(got.params[k], want.params[k]), k


def test_threads_keep_their_own_span_stacks(recorder):
    ready = threading.Barrier(2, timeout=30)

    def work(tag):
        with obs.span("outer", tag=tag):
            ready.wait()
            with obs.span("inner", tag=tag):
                ready.wait()

    threads = [threading.Thread(target=work, args=(t,), name=f"t{t}") for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    spans = _spans(recorder)
    by_id = {s.span_id: s for s in spans}
    inner = [s for s in spans if s.name == "inner"]
    assert len(inner) == 2
    for s in inner:
        parent = by_id[s.parent_id]
        assert (parent.name, parent.args, parent.thread) == ("outer", s.args, s.thread)
        assert s.step == parent.span_id
    rows = [e for e in recorder.export_chrome_trace()["traceEvents"] if e.get("ph") == "X"]
    assert sorted({e["tid"] for e in rows}) == [1, 2]


def test_host_spans_add_only_their_own_rows_to_the_export():
    plain = obs.TraceRecorder()
    plain.worker_span("w0", 0.0, 0.5, args={"lanes": 4})
    before = json.dumps(plain.export_chrome_trace(), sort_keys=True)
    summary = plain.summary()
    with plain.span("train.step", epoch=0):
        with plain.span("train.h2d"):
            pass
    trace = plain.export_chrome_trace()
    hosts = [e for e in trace["traceEvents"] if e["pid"] == 3001]
    rest = dict(trace, traceEvents=[e for e in trace["traceEvents"] if e["pid"] != 3001])
    assert json.dumps(rest, sort_keys=True) == before
    x = [e for e in hosts if e["ph"] == "X"]
    assert [e["name"] for e in x] == ["train.h2d", "train.step"]
    assert x[0]["args"]["parent_id"] == x[1]["args"]["span_id"] == x[1]["args"]["step"]
    assert x[1]["args"]["epoch"] == 0 and np.isfinite(x[1]["dur"])
    got = plain.summary()
    assert set(got) - set(summary) == {"spans"}
    assert got["spans"]["train.step"]["count"] == 1
