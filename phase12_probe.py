"""Phase 12 of ``chip_smoke.py`` (the serving fleet's faults) on one card,
repeated, to see how often its timing-bound parts pass.

The kernels are built from the checkout, phase 6 gives the fault-free
baseline, then phase 12 runs ``--repeat`` times.  With ``--hedge-trials N``
it also runs phase 12c's hedging N times at each ``--hedge-k``: a control
run with no fault and a run with ``chip_smoke.SLOWED`` slowed
``SLOW_FACTOR`` times from its batch ``FAULT_AFTER + 1``; it prints, for
each run, the hedges, the slowed worker's hedges and the batches whose
result it gave.  Run from the root of a checkout on a host with one card:

    python3 phase12_probe.py --repeat 3 --hedge-trials 12 --hedge-k 0.5 0.25
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def hedge_trial(clients, hedge_k: float, slowed: bool) -> dict:
    import chip_smoke as cs
    from repro_torch.comanager.faults import FaultSpec, FaultToleranceConfig

    inj = None
    if slowed:
        inj = cs.counting_injector(
            {cs.SLOWED: FaultSpec(kind="slowdown", factor=cs.SLOW_FACTOR)}, after=cs.FAULT_AFTER)
    _, seconds, rt = cs.serve_fig6(clients, "async", fault_injector=inj,
                                   fault_tolerance=FaultToleranceConfig(hedge_k=hedge_k))
    fleet = rt.dispatcher.fleet.snapshot()
    return {"seconds": seconds, "hedges": sum(v["hedges"] for v in fleet.values()),
            "slowed_hedges": fleet[cs.SLOWED]["hedges"],
            "slowed_won": [w for w, _, _ in rt.dispatcher.batch_log].count(cs.SLOWED)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeat", type=int, default=3, help="runs of phase 12")
    ap.add_argument("--hedge-trials", type=int, default=0, help="hedging trials a hedge_k")
    ap.add_argument("--hedge-k", type=float, nargs="+", default=[0.25])
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("phase12_probe: no CUDA device", file=sys.stderr)
        return 1
    _build.build()
    dev = torch.device("cuda", 0)
    card = cs.smi_line()
    print(card, flush=True)
    _, base = cs.serve_gateway(dev, card)
    for i in range(args.repeat):
        t0 = time.perf_counter()
        cs.fault_phase(dev, card, base)
        print(f"phase 12 run {i}: passed in {time.perf_counter() - t0} s [{card}]", flush=True)
    clients = cs.fig6_clients(dev, np.random.default_rng(6))
    for trial in range(args.hedge_trials):
        row = {}
        for k in args.hedge_k:
            row[f"control {k}"] = hedge_trial(clients, k, slowed=False)
            row[f"slowed {k}"] = hedge_trial(clients, k, slowed=True)
        print(f"hedge trial {trial}: {json.dumps(row)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
