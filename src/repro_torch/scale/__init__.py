"""Trace-driven scale harness: storm generation, replay, knee discovery.

The pipeline the CI scale gate runs end to end:

1. ``workload`` — deterministic multi-population storm generator: thousands
   of tenants with diurnal / bursty / heavy-tailed arrival processes, mixed
   circuit specs, priority tiers, SLO classes and fair-share weights, all
   from one seed.
2. ``replay`` — drive a generated ``Trace`` against the virtual clock
   (``SystemSimulation``; 10k+-tenant runs) or against real kernels
   (``GatewayRuntime``; small mixes).
3. ``knee`` — sweep offered load, locate the throughput knee and the
   p99/attainment cliff from the obs-layer signals, and calibrate the
   gateway's weighted-fair admission cap at the knee.
4. ``ergonomics`` — the harness's own telemetry (cumulative timers,
   interval tickers, config-diff reports); wall-clock only, never touches
   the virtual clock.

``benchmarks/scale_harness.py`` wires the reference's pipeline
(``repro.scale``, the same code) into ``BENCH_scale.json`` with baselines
gated by ``benchmarks/check_trend.py``; ``chip_smoke.py`` replays a storm
through the port's real kernels on the card.
"""

from repro_torch.scale.ergonomics import CumulativeTimer, IntervalTicker, config_diff
from repro_torch.scale.knee import (
    KneeReport,
    SweepPoint,
    calibrate_admission,
    find_knee,
    sweep,
    verify_admission,
)
from repro_torch.scale.replay import (
    ReplayResult,
    default_fleet,
    replay_real,
    replay_sim,
)
from repro_torch.scale.workload import (
    ArrivalProcess,
    TenantPopulation,
    TenantProfile,
    Trace,
    WorkloadSpec,
    standard_populations,
)

__all__ = [
    "ArrivalProcess",
    "CumulativeTimer",
    "IntervalTicker",
    "KneeReport",
    "ReplayResult",
    "SweepPoint",
    "TenantPopulation",
    "TenantProfile",
    "Trace",
    "WorkloadSpec",
    "calibrate_admission",
    "config_diff",
    "default_fleet",
    "find_knee",
    "replay_real",
    "replay_sim",
    "standard_populations",
    "sweep",
    "verify_admission",
]
