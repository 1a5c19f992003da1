"""The port's observability layer (``repro_torch.obs``) against the
reference's: the same samples give the same histogram percentiles, and a
``TraceRecorder`` fed the same events exports the same Chrome trace."""
import json
import random

import pytest

from repro import obs as jobs
from repro_torch import obs as tobs


@pytest.mark.parametrize("v_min,growth,n_buckets", [(1e-6, 1.25, 128), (1e-3, 1.1, 64),
                                                    (1.0, 2.0, 8)])
def test_log_histogram_matches(v_min, growth, n_buckets):
    rnd = random.Random(n_buckets)
    hs = [mod.LogHistogram(v_min, growth, n_buckets) for mod in (jobs, tobs)]
    other = [mod.LogHistogram(v_min, growth, n_buckets) for mod in (jobs, tobs)]
    for _ in range(2000):
        v = rnd.choice((0.0, rnd.expovariate(3.0), rnd.lognormvariate(-4, 2), 1e9))
        for h in hs:
            h.record(v)
        w = rnd.expovariate(0.5)
        for h in other:
            h.record(w, n=2)
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert hs[0].percentile(q) == hs[1].percentile(q)
    assert hs[0].snapshot() == hs[1].snapshot()
    assert hs[0].merge(other[0]).snapshot() == hs[1].merge(other[1]).snapshot()
    with pytest.raises(ValueError):
        tobs.LogHistogram(v_min=0.0)


def _feed(mod, sample_rate: float):
    """One event sequence: submissions, stage transitions, batch stages,
    worker spans, rejects, ends of every outcome and kernel launches."""
    rec = mod.TraceRecorder(mod.ObservabilityConfig(sample_rate=sample_rate, buffer_size=64))
    rnd = random.Random(7)
    now = 0.0
    for seq in range(40):
        now += rnd.uniform(0.001, 0.01)
        rec.circuit_submit(seq, f"t{seq % 3}", ("spec", seq % 2), now, queue_depth=seq % 5)
        if seq % 9 == 8:
            rec.circuit_reject(1000 + seq, "t9", "k", now)
    for lo in range(0, 40, 8):
        seqs = range(lo, lo + 8)
        now += 0.002
        rec.batch_stage(seqs, "coalesced", now)
        rec.batch_stage(seqs, "placed", now + 0.001, worker=f"w{lo // 8 % 4}")
        rec.batch_stage(seqs, "dispatched", now + 0.002)
        rec.batch_stage(seqs, "kernel_start", now + 0.003)
        rec.worker_span(f"w{lo // 8 % 4}", now + 0.003, now + 0.009,
                        args={"kind": "rows", "lanes": 8})
        now += 0.01
        for seq in seqs:
            rec.circuit_end(seq, ("complete", "fail", "evict")[seq % 3] if seq % 7 == 0
                            else "complete", now)
        rec.coalescer_sample(lo, 4 * lo)
        rec.on_kernel_launch({"mode": ("fused", "spill", "materialize")[lo % 3]})
    return rec


@pytest.mark.parametrize("sample_rate", [1.0, 0.5, 0.0])
def test_trace_recorder_exports_same_chrome_trace(sample_rate):
    recs = [_feed(mod, sample_rate) for mod in (jobs, tobs)]
    exports = [json.dumps(r.export_chrome_trace(), sort_keys=True) for r in recs]
    assert exports[0] == exports[1]
    assert recs[0].summary() == recs[1].summary()
    assert recs[0].stage_summary() == recs[1].stage_summary()
    for tenant in ("t0", "t1", "t2"):
        assert recs[0].tenant_records(tenant) == recs[1].tenant_records(tenant)
    assert jobs.validate_trace(recs[0].buffer.records(jobs.CircuitTrace)) == \
        tobs.validate_trace(recs[1].buffer.records(tobs.CircuitTrace))


def test_observability_config_matches():
    assert tobs.LIFECYCLE_STAGES == jobs.LIFECYCLE_STAGES
    assert tobs.ObservabilityConfig.disabled() == tobs.ObservabilityConfig(False, 0.0)
    for bad in ({"sample_rate": 1.5}, {"buffer_size": 0}, {"stages": ("nope",)}):
        with pytest.raises(ValueError) as je:
            jobs.ObservabilityConfig(**bad)
        with pytest.raises(ValueError) as te:
            tobs.ObservabilityConfig(**bad)
        assert str(je.value) == str(te.value)
