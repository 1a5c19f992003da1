"""Re-run the HLO static analysis over saved dry-run artifacts (*.hlo.gz)
and refresh the corrected fields of the matching *.json records — lets the
analyzer iterate without re-compiling 80 modules.  A copy of the
reference's ``roofline/reanalyze.py``: the port's own dry-run writes no HLO,
so a record is refreshed only where a ``.hlo.gz`` lies beside it (the
reference's artifacts; point ``--dir`` at its ``experiments/dryrun``).

Usage:  PYTHONPATH=src python -m repro_torch.roofline.reanalyze [--mesh 16x16] [--dir DIR]
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os

from repro_torch.roofline import hlo_analyzer

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "experiments", "dryrun_torch")


def reanalyze(mesh: str | None = None, directory: str | None = None) -> int:
    pat = f"*__{mesh}.hlo.gz" if mesh else "*.hlo.gz"
    n = 0
    for hlo_path in sorted(glob.glob(os.path.join(directory or DRYRUN_DIR, pat))):
        json_path = hlo_path[: -len(".hlo.gz")] + ".json"
        if not os.path.exists(json_path):
            continue
        with gzip.open(hlo_path, "rt") as f:
            cost = hlo_analyzer.analyze(f.read())
        with open(json_path) as f:
            rec = json.load(f)
        rec["flops_per_device"] = cost.flops
        rec["bytes_accessed_per_device"] = cost.bytes
        rec["collective_bytes_per_device"] = cost.coll_bytes
        rec["collectives"] = {k: int(v) for k, v in cost.coll_by_kind.items()}
        with open(json_path, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
        print(f"[reanalyze] {os.path.basename(json_path)}: "
              f"flops {cost.flops:.2e}  bytes {cost.bytes:.2e}  "
              f"coll {cost.coll_bytes:.2e}")
    return n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    n = reanalyze(args.mesh, args.dir)
    print(f"re-analyzed {n} records")


if __name__ == "__main__":
    main()
