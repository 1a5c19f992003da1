"""The port's scale harness (``repro_torch.scale``) against the reference's
(``repro.scale``).

Storm generation, the virtual-clock replay, the load sweep, the knee and
the admission calibration are numpy and host code: the same seeds give the
reference's arrays bit for bit and its results field for field.
``replay_real`` drives a 20-tenant storm through real kernels (the plain
versions on the CPU): every circuit completes, each with the reference's
angles and within 1e-5 of a direct kernel call.
"""
import dataclasses
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.kernels import ops

ATOL = 1e-5


def _ns(root: str) -> SimpleNamespace:
    return SimpleNamespace(root=root, scale=importlib.import_module(f"{root}.scale"))


REF, PORT = _ns("repro"), _ns("repro_torch")


def _spec(ns, n=60, rate=1.0, seed=11, duration=8.0, **kw):
    s = ns.scale
    return s.WorkloadSpec(populations=s.standard_populations(n, rate_per_tenant=rate,
                                                             slo_scale=2.0),
                          duration_s=duration, seed=seed, **kw)


def _trace_data(trace):
    return (trace.duration_s, trace.seed, trace.load,
            [dataclasses.astuple(t) for t in trace.tenants],
            {k: np.asarray(v).tobytes() for k, v in trace.arrivals.items()},
            trace.summary())


# ------------------------------------------------------------- generation
@pytest.mark.parametrize("n,rate,seed,load", [(60, 1.0, 11, 1.0), (200, 0.4, 7, 2.5),
                                              (30, 3.0, 0, 0.5)])
def test_generate_equals_reference(n, rate, seed, load):
    port = _spec(PORT, n, rate, seed).at_load(load).generate()
    ref = _spec(REF, n, rate, seed).at_load(load).generate()
    assert port.n_circuits > 0
    assert _trace_data(port) == _trace_data(ref)


@pytest.mark.parametrize("kind", ["poisson", "bursty", "heavy_tail", "diurnal"])
def test_arrival_process_equals_reference(kind):
    offs = [ns.scale.ArrivalProcess(kind=kind, rate=5.0).sample(np.random.default_rng(4), 30.0)
            for ns in (PORT, REF)]
    assert np.asarray(offs[0]).tobytes() == np.asarray(offs[1]).tobytes()
    assert len(offs[0]) > 0


@pytest.mark.parametrize("kw", [dict(kind="weibull"), dict(rate=0.0),
                                dict(kind="heavy_tail", alpha=1.0),
                                dict(kind="diurnal", depth=1.0)])
def test_arrival_validation_messages_equal_reference(kw):
    msgs = []
    for ns in (PORT, REF):
        with pytest.raises(ValueError) as exc:
            ns.scale.ArrivalProcess(**kw)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


# ----------------------------------------------------------------- replay
def _replay(ns, cap):
    trace = _spec(ns, 120, 4.0 if cap else 1.0).generate()
    res = ns.scale.replay_sim(trace, workers=ns.scale.default_fleet(1),
                              max_system_pending=cap, keep_report=True)
    rep = res.report
    return (res.row(), json.dumps(res.summary, sort_keys=True, default=repr),
            rep.makespan, [tuple(a) for a in rep.assignments], rep.rejected,
            dict(rep.worker_busy_time))


@pytest.mark.parametrize("cap", [None, 64])
def test_replay_sim_equals_reference(cap):
    port, ref = _replay(PORT, cap), _replay(REF, cap)
    assert port == ref
    row = port[0]
    assert row["completed"] + row["rejected"] == row["submitted"]
    assert (row["rejected"] > 0) == (cap is not None)


def _sweep_knee(ns):
    s = ns.scale
    spec = _spec(ns, 100, 0.4, seed=5, duration=10.0)
    pts = s.sweep(spec, (1.0, 4.0, 8.0), workers=s.default_fleet(1))
    rep = s.find_knee(pts, efficiency_floor=0.80, attainment_floor=0.99)
    cap = s.calibrate_admission(rep.knee, slack=0.5)
    verified = s.verify_admission(spec, rep, workers=s.default_fleet(1))
    return ([p.row() for p in pts], rep.knee.row(), None if rep.cliff is None else rep.cliff.row(),
            rep.saturated, cap, verified)


def test_sweep_knee_admission_equal_reference():
    port, ref = _sweep_knee(PORT), _sweep_knee(REF)
    assert port == ref
    assert len(port[0]) == 3 and port[4] >= 1


@pytest.mark.parametrize("slack,floor", [(0.5, 1), (2.0, 1), (0.5, 1000)])
def test_calibrate_admission_equals_reference(slack, floor):
    caps = []
    for ns in (PORT, REF):
        p = ns.scale.SweepPoint(load=3, n_tenants=10, offered_cps=300, achieved_cps=280,
                                p99_latency_s=2.0, slo_attainment=1.0, reject_fraction=0.0,
                                queue_depth_p99=None, coalesce_wait_share=None, makespan_s=10.0)
        caps.append(ns.scale.calibrate_admission(p, slack=slack, floor=floor))
    assert caps[0] == caps[1]


def test_ergonomics_equal_reference():
    out = []
    for ns in (PORT, REF):
        t = iter([0.0, 1.0, 5.0, 7.5])
        timer = ns.scale.CumulativeTimer(clock=lambda: next(t))
        for _ in range(2):
            with timer.time("step"):
                pass
        ticker = ns.scale.IntervalTicker(10.0, clock=lambda: 0.0)
        ticks = [ticker.tick(now=x) for x in (0.0, 5.0, 10.0)]
        diff = ns.scale.config_diff({"a": 1, "b": {"c": 2}, "gone": 9},
                                    {"a": 1, "b": {"c": 5}, "new": 7})
        out.append((timer.stats(), ticks, diff))
    assert out[0] == out[1]


# ------------------------------------------------------------ replay_real
def _recording(monkeypatch, serve_mod):
    """Patch ``serve_mod.GatewayRuntime`` so each runtime records every
    admitted (spec, payload, future)."""
    seen = []
    base = serve_mod.GatewayRuntime

    class Recording(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            submit = self.gateway.submit

            def recorded(client_id, key, payload, *args, **kwargs):
                fut = submit(client_id, key, payload, *args, **kwargs)
                seen.append((key, payload, fut))
                return fut

            self.gateway.submit = recorded

    monkeypatch.setattr(serve_mod, "GatewayRuntime", Recording)
    return seen


def test_replay_real_completes_and_matches_reference(monkeypatch):
    import repro.serve as jserve
    import repro_torch.serve as tserve

    trace_p = _spec(PORT, 20, 1.0, seed=3, duration=4.0).generate()
    trace_r = _spec(REF, 20, 1.0, seed=3, duration=4.0).generate()
    got_seen = _recording(monkeypatch, tserve)
    want_seen = _recording(monkeypatch, jserve)
    got = PORT.scale.replay_real(trace_p, mode="sync", deadline=0.05, device="cpu")
    want = REF.scale.replay_real(trace_r, mode="sync", deadline=0.05)
    assert got.submitted == want.submitted == trace_p.n_circuits > 0
    assert got.completed == got.submitted and got.rejected == 0
    assert len(got_seen) == len(want_seen) == got.submitted
    for (gspec, (gth, gda), gfut), (_, (wth, wda), wfut) in zip(got_seen, want_seen):
        # the reference's angles: the same numpy stream, cast to float32
        assert gth.numpy().tobytes() == np.asarray(wth).tobytes()
        assert gda.numpy().tobytes() == np.asarray(wda).tobytes()
        direct = ops.vqc_fidelity(gspec, gth[None], gda[None])[0]
        assert abs(float(gfut.value) - float(direct)) <= ATOL
        assert abs(float(gfut.value) - float(np.asarray(wfut.value))) <= ATOL


def test_replay_real_async_completes_everything():
    trace = _spec(PORT, 20, 1.0, seed=4, duration=4.0).generate()
    res = PORT.scale.replay_real(trace, mode="async", deadline=0.05, device="cpu")
    assert res.completed == res.submitted == trace.n_circuits > 0
    assert res.rejected == 0 and res.p99_latency_s > 0
