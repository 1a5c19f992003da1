"""Scale-storm demo: arrival storm -> knee -> calibrated admission control.

A scaled-down version of the reference's ``benchmarks/scale_harness.py``:

1. generate a seeded 300-tenant storm (15% interactive / 55% batch / 30%
   bursty best-effort, with priority tiers, SLO classes and fair-share
   weights) from ``repro_torch.scale.standard_populations``;
2. sweep offered load on the virtual clock to find the fleet's throughput
   knee — the highest operating point that still keeps up (efficiency
   >= 0.80) and holds the SLOs (attainment >= 0.99);
3. size the gateway's global weighted-fair admission cap at the knee via
   Little's law and replay a past-knee storm with and without it: the cap
   converts deep queueing past the knee into load shedding at submit,
   pinning the admitted circuits' p99 back to the knee's.

Everything runs on the virtual clock and is a pure function of the seed —
re-running this program reproduces every number bit-for-bit.

Run:  PYTHONPATH=src python -m repro_torch.examples.scale_storm [--device cpu]
"""
from __future__ import annotations

from repro_torch.examples import arg_parser, parse
from repro_torch.scale import (
    WorkloadSpec,
    default_fleet,
    find_knee,
    standard_populations,
    sweep,
    verify_admission,
)

SPEC = WorkloadSpec(
    populations=standard_populations(300, rate_per_tenant=0.4, slo_scale=2.0),
    duration_s=10.0,
    seed=11,
)
LOADS = (0.5, 1.0, 2.0, 4.0, 6.0, 8.0)
FLEET = default_fleet(n_replicas=1)  # the paper's 5/10/15/20-qubit quartet


def main(argv=None) -> dict:
    parse(arg_parser(__doc__), argv)  # nothing here runs on the device
    trace = SPEC.generate()
    print(f"storm: {trace.summary()}")

    print(f"\nsweeping {len(LOADS)} offered-load points on the virtual clock...")
    points = sweep(SPEC, LOADS, workers=FLEET)
    for p in points:
        print(
            f"  load {p.load:g}: offered {p.offered_cps:7.1f} c/s -> "
            f"achieved {p.achieved_cps:7.1f} c/s  "
            f"eff {p.efficiency:.2f}  p99 {p.p99_latency_s:5.2f}s  "
            f"attainment {p.slo_attainment}"
        )

    report = find_knee(points)
    knee = report.knee
    print(
        f"\nknee: load {knee.load:g} -> {knee.achieved_cps:.0f} c/s at "
        f"p99 {knee.p99_latency_s:.2f}s (saturated={report.saturated})"
    )

    adm = verify_admission(SPEC, report, overload=1.6, workers=FLEET)
    print(
        f"\nadmission control at {adm['overload']:g}x the knee "
        f"(cap = {adm['max_system_pending']} outstanding circuits):"
    )
    print(
        f"  uncapped: attainment {adm['attainment_uncapped']}, "
        f"p99 {adm['p99_uncapped_s']:.2f}s"
    )
    print(
        f"  capped:   attainment {adm['attainment_admitted']}, "
        f"p99 {adm['p99_admitted_s']:.2f}s, "
        f"sheds {adm['reject_fraction']:.1%} at submit"
    )
    return {"storm": trace.summary(), "points": points, "knee": report,
            "admission": adm}


if __name__ == "__main__":
    main()
