"""Knee-point discovery + admission-control calibration.

``sweep`` replays one seeded storm recipe at increasing offered loads and
collects a ``SweepPoint`` per load: offered vs achieved throughput, the
population p99, SLO attainment, and the obs-layer congestion signals
(queue-depth p99, coalesce-wait share).  ``find_knee`` walks the curve and
locates the *throughput knee* — the last operating point where the system
still converts offered load into completions efficiently AND holds its
SLOs — plus the attainment cliff right past it.

``calibrate_admission`` then turns the knee into a policy: a Little's-law
global pending cap (knee throughput x knee p99 x slack) for the gateway's
weighted-fair admission control, so past-knee storms shed load at submit
instead of queueing into certain SLO misses.  ``verify_admission`` replays
a past-knee storm with the cap armed and reports the improvement.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

from repro_torch.scale.ergonomics import CumulativeTimer, IntervalTicker
from repro_torch.scale.replay import ReplayResult, replay_sim
from repro_torch.scale.workload import WorkloadSpec


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One operating point of the offered-load sweep."""

    load: float
    n_tenants: int
    offered_cps: float
    achieved_cps: float
    p99_latency_s: float
    slo_attainment: float | None
    reject_fraction: float
    queue_depth_p99: float | None
    coalesce_wait_share: float | None
    makespan_s: float

    @property
    def efficiency(self) -> float:
        """Achieved / offered throughput (1.0 = keeping up)."""
        return self.achieved_cps / max(self.offered_cps, 1e-9)

    def row(self) -> dict:
        return {
            "load": self.load,
            "offered_cps": round(self.offered_cps, 2),
            "achieved_cps": round(self.achieved_cps, 2),
            "efficiency": round(self.efficiency, 4),
            "p99_latency_s": round(self.p99_latency_s, 4),
            "slo_attainment": self.slo_attainment,
            "reject_fraction": round(self.reject_fraction, 4),
            "queue_depth_p99": self.queue_depth_p99,
            "coalesce_wait_share": self.coalesce_wait_share,
            "makespan_s": round(self.makespan_s, 3),
        }


def _point(load: float, res: ReplayResult) -> SweepPoint:
    return SweepPoint(
        load=load,
        n_tenants=res.n_tenants,
        offered_cps=res.offered_cps,
        achieved_cps=res.achieved_cps,
        p99_latency_s=res.p99_latency_s,
        slo_attainment=res.slo_attainment,
        reject_fraction=res.reject_fraction,
        queue_depth_p99=res.queue_depth_p99,
        coalesce_wait_share=res.coalesce_wait_share,
        makespan_s=res.makespan_s,
    )


def sweep(
    spec: WorkloadSpec,
    loads: Sequence[float],
    *,
    timer: CumulativeTimer | None = None,
    progress: Callable[[str], None] | None = None,
    tick_s: float = 5.0,
    **replay_kwargs,
) -> list[SweepPoint]:
    """Replay ``spec`` at each load multiplier (ascending), one seeded
    regeneration + virtual-clock replay per point."""
    timer = timer or CumulativeTimer()
    ticker = IntervalTicker(tick_s)
    points: list[SweepPoint] = []
    for load in sorted(loads):
        with timer.time("generate"):
            trace = spec.at_load(load).generate()
        with timer.time("replay"):
            res = replay_sim(trace, **replay_kwargs)
        points.append(_point(load, res))
        if progress is not None and ticker.tick():
            p = points[-1]
            progress(
                f"load {load:g}: offered {p.offered_cps:.0f} c/s -> "
                f"achieved {p.achieved_cps:.0f} c/s "
                f"(eff {p.efficiency:.2f}, p99 {p.p99_latency_s:.2f}s, "
                f"attainment {p.slo_attainment})"
            )
    return points


@dataclasses.dataclass(frozen=True)
class KneeReport:
    """The located knee + the cliff past it + the full curve."""

    knee: SweepPoint
    cliff: SweepPoint | None
    points: tuple[SweepPoint, ...]
    efficiency_floor: float
    attainment_floor: float

    @property
    def saturated(self) -> bool:
        """True when the sweep actually pushed past the knee (some point
        violated a floor) — a sweep that never saturates found no knee,
        only a lower bound."""
        return any(not self._healthy(p) for p in self.points)

    def _healthy(self, p: SweepPoint) -> bool:
        att_ok = (
            p.slo_attainment is None
            or p.slo_attainment >= self.attainment_floor
        )
        return p.efficiency >= self.efficiency_floor and att_ok

    def point_near_offered(self, offered_cps: float) -> SweepPoint:
        """The sweep point whose offered load is closest to the target."""
        return min(
            self.points, key=lambda p: abs(p.offered_cps - offered_cps)
        )

    def to_dict(self) -> dict:
        return {
            "knee": self.knee.row(),
            "cliff": self.cliff.row() if self.cliff is not None else None,
            "saturated": self.saturated,
            "efficiency_floor": self.efficiency_floor,
            "attainment_floor": self.attainment_floor,
            "sweep": [p.row() for p in self.points],
        }


def find_knee(
    points: Sequence[SweepPoint],
    *,
    efficiency_floor: float = 0.85,
    attainment_floor: float = 0.999,
) -> KneeReport:
    """Locate the knee on an ascending-load sweep.

    The knee is the HIGHEST offered-load point that still (a) converts at
    least ``efficiency_floor`` of its offered load into completions and
    (b) holds SLO attainment at or above ``attainment_floor``.  The cliff
    is the first point past the knee violating either floor (None when
    the sweep never saturates).
    """
    if not points:
        raise ValueError("cannot find a knee on an empty sweep")
    pts = sorted(points, key=lambda p: p.offered_cps)
    report = KneeReport(
        knee=pts[0],
        cliff=None,
        points=tuple(pts),
        efficiency_floor=efficiency_floor,
        attainment_floor=attainment_floor,
    )
    knee = None
    cliff = None
    for p in pts:
        if report._healthy(p):
            if cliff is None:
                knee = p
        elif cliff is None:
            cliff = p
    # a sweep already saturated at its first point: the knee is unknown
    # below the sweep range; report the first point as the (degenerate)
    # knee so downstream metrics stay defined.
    return dataclasses.replace(report, knee=knee or pts[0], cliff=cliff)


def calibrate_admission(
    knee: SweepPoint, *, slack: float = 0.5, floor: int = 64
) -> int:
    """Little's-law global outstanding cap from the knee operating point.

    Little's law says the healthy system holds ``achieved x mean-sojourn``
    circuits; we size from the knee's ``achieved x p99`` — a deliberate
    overstatement (p99 >> mean on a heavy-tailed mix) discounted by
    ``slack < 1``.  A standing backlog deeper than that can only add
    latency, never throughput: cap admission there, and the gateway sheds
    the excess at submit instead of queueing it into certain SLO misses.
    The default ``slack=0.5`` empirically pins the admitted circuits' p99
    back to the knee p99 under a 1.6x-knee storm (see the harness's
    ``admission`` section).
    """
    if slack <= 0:
        raise ValueError(f"slack must be positive, got {slack}")
    cap = int(math.ceil(knee.achieved_cps * knee.p99_latency_s * slack))
    return max(cap, floor)


def verify_admission(
    spec: WorkloadSpec,
    knee_report: KneeReport,
    *,
    overload: float = 1.6,
    slack: float = 0.5,
    **replay_kwargs,
) -> dict:
    """Replay a past-knee storm with and without the calibrated cap.

    Returns the calibrated cap plus both operating points; with the cap
    armed the gateway must actually shed load (``reject_fraction > 0``)
    and the admitted circuits' attainment must not degrade.
    """
    cap = calibrate_admission(knee_report.knee, slack=slack)
    load = knee_report.knee.load * overload
    trace = spec.at_load(load).generate()
    uncapped = replay_sim(trace, **replay_kwargs)
    capped = replay_sim(trace, max_system_pending=cap, **replay_kwargs)
    return {
        "max_system_pending": cap,
        "overload": overload,
        "load": round(load, 4),
        "offered_cps": round(trace.offered_cps, 2),
        "reject_fraction": round(capped.reject_fraction, 4),
        "rejected": capped.rejected,
        "attainment_admitted": capped.slo_attainment,
        "attainment_uncapped": uncapped.slo_attainment,
        "p99_admitted_s": round(capped.p99_latency_s, 4),
        "p99_uncapped_s": round(uncapped.p99_latency_s, 4),
        "achieved_cps": round(capped.achieved_cps, 2),
        "achieved_cps_uncapped": round(uncapped.achieved_cps, 2),
    }


__all__ = [
    "KneeReport",
    "SweepPoint",
    "calibrate_admission",
    "find_knee",
    "sweep",
    "verify_admission",
]
