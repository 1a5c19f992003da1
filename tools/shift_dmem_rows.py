#!/usr/bin/env python3
"""The shift walk's device-memory rows of one source tree, for a bit-for-bit
comparison with another tree's, on one GPU.

    python3 tools/shift_dmem_rows.py --root TREE --out FILE [--against FILE]
        [--qc 27] [--layers 3] [--batch 576] [--iters 20]

Imports ``repro_torch`` from ``TREE/src`` (this checkout's by default, or an
unpacked ``git archive`` of another commit), and runs ``vqc_shift_fidelity``
on QuClassi qc-layers at B samples: the whole bank and each worker's groups
of the 2-worker round robin, on seeded angles (the same in every tree).  It
saves the rows and each set's time (CUDA events around back-to-back calls,
after a warm-up) to FILE (``torch.save``); with ``--against`` it loads
another tree's FILE and reports, per set, whether the rows are equal
(``torch.equal``) and the largest difference, and exits 1 where any set
differs.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", required=True)
    ap.add_argument("--against")
    ap.add_argument("--qc", type=int, default=27)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--batch", type=int, default=576)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("shift_dmem_rows: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root) / "src"))
    from repro_torch.comanager import dataplane
    from repro_torch.core import circuits
    from repro_torch.kernels import vqc_statevector as K

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    spec = circuits.build_quclassi_circuit(args.qc, args.layers)
    n_groups = 1 + 2 * spec.n_theta
    assign = dataplane.round_robin_assignment(n_groups, 2)
    sets = {"whole": tuple(range(n_groups))}
    for w in range(2):
        sets[f"worker {w}"] = tuple(g for g in range(n_groups) if assign[g] == w)
    rng = np.random.default_rng(args.qc * 100 + args.layers)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, (args.batch, spec.n_theta)),
                      dtype=torch.float32, device=dev)
    dt = torch.tensor(rng.uniform(0.0, np.pi, (args.batch, spec.n_data)), dtype=torch.float32,
                      device=dev)
    result = {"root": args.root, "card": card, "rows": {}, "ms": {}}
    for label, gs in sets.items():
        rows = K.vqc_shift_fidelity(spec, th, dt, groups=gs)
        for _ in range(2):
            K.vqc_shift_fidelity(spec, th, dt, groups=gs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.iters):
            K.vqc_shift_fidelity(spec, th, dt, groups=gs)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.iters
        result["rows"][label] = rows.cpu()
        result["ms"][label] = ms
        print(f"{args.qc}q-{args.layers}l B={args.batch} {label} (G={len(gs)}): {ms:.4f} ms a call "
              f"[{card}; {args.root}]", flush=True)
    torch.save(result, args.out)
    if not args.against:
        return 0
    other = torch.load(args.against)
    same = True
    for label, rows in result["rows"].items():
        theirs = other["rows"][label]
        equal = torch.equal(rows, theirs)
        same &= equal
        print(f"{label}: torch.equal {equal}, max |diff| "
              f"{float((rows - theirs).abs().max()):.3g}, ms {result['ms'][label]:.4f} here, "
              f"{other['ms'][label]:.4f} in {other['root']}", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
