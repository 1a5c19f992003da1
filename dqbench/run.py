"""Run one cell of the benchmark once and print its result line.

    python3 dqbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout of the repository, on a host with as many
CUDA cards as the cell asks for (the program, ``src/repro_torch``, is
imported from the checkout).  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; then ``checks``, each number
compared with its limit, which are also the last lines of standard
error.  Exits 2 without a result where CUDA or the cards are missing, 3
where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]
# kernel caches of the CUDA driver stay inside the checkout
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "dqbench" / "cuda_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import harness

    if not torch.cuda.is_available():
        print("dqbench: CUDA is not available; no result", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"dqbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present; no result", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out, log = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"dqbench: loaded in this process: {', '.join(foreign)}; no result",
              file=sys.stderr)
        return 3
    print("set-up (s from start): " + json.dumps(log["setup"]), file=sys.stderr)
    print("step ms: " + json.dumps(log["steps_ms"]), file=sys.stderr)
    print("gaps by leaf: " + json.dumps(log["leaves"]), file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
