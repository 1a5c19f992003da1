"""Readings that the limits of a cell's comparison are set from.

    python3 dqbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...] [--out FILE]

On the card, at the cell's own size, in one process: the program's
numbers on each seed (the lower readings), the control's (the plain
reference put in the program's place, in TF32) and each planted fault's
(the upper readings).  Training needs no measured window: each run makes
one window step.  Prints one line a run and writes every reading as JSON.
The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    import torch

    import faults
    import harness

    if not torch.cuda.is_available():
        print("calibrate: CUDA is not available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload)
    runs = [("program", s, None, None) for s in args.seeds]
    runs += [("control", s, faults.control(cell), None) for s in args.control_seeds]
    runs += [(name, s, None, make) for name, make in faults.FAULTS.items()
             for s in args.fault_seeds]
    readings = []
    for kind, seed, step_impl, fault in runs:
        t0 = time.perf_counter()
        if fault is None:
            out, log = harness.run(args.workload, seed, 0.0, False, device, t0,
                                   step_impl=step_impl)
        else:
            with fault():
                out, log = harness.run(args.workload, seed, 0.0, False, device, t0)
        checks = {k: v["value"] for k, v in out["checks"].items()}
        readings.append({"kind": kind, "seed": seed, "correct": out["correct"], **checks,
                         "leaves": log["leaves"]})
        print(f"{args.workload} {kind:14s} seed {seed}: " + " ".join(
            f"{k} {v:.6e}" for k, v in checks.items())
            + f" correct {out['correct']} ({time.perf_counter() - t0:.1f} s); by leaf "
            + " ".join(f"{k} {v:.3e}" for k, v in log["leaves"].items()), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"workload": args.workload, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
