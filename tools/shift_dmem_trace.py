#!/usr/bin/env python3
"""Where a sample's time goes inside ``shift_dmem_kernel`` at m = 13, on one GPU.

    python3 tools/shift_dmem_trace.py [--qc 27] [--layers 3] [--batch 576]

Builds a copy of ``vqc_shift_dmem.cu`` with a ``clock64()`` stamp at seven
points of the one-chunk pass loop (thread 0 of each block of the first
wave), into ``build/shift_dmem_trace/``, and runs it through
``vqc_shift_fidelity`` in place of the built library on the whole bank and
on each worker's groups of the 2-worker round robin.  Per kind of pass
(the data run, forward runs, f0, variants, chi's inverse runs, each with
the form the staging plan gives it: per_gate, orbit or element) it reports
the mean SM cycles of each segment:

  top     the last pass's end to the pass's first barrier (the wait for a
          bulk store's read of a region the pass writes),
  prep    the checkpoint fetch, the wait on its load, the load issued ahead,
  body    the pass's gates: its one sweep (orbit), its gate and inner
          product with the reduction and the row's write (element), or
          |0...0> or the copy and ``chunk_gates`` (per_gate),
  store   the bulk store's barrier and issue,
  inner   the inner product of the other forms, its reduction and the row's
          write,
  tail    to the next pass's start.

Prints a log and writes ``chiprun_out/shift_dmem_trace.json``.  The copy
differs from the kernel by the stamps alone (a global store by thread 0 at
each point); its events time is logged beside the built kernel's.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
from chip_smoke import log, smi_line, time_ms  # noqa: E402

SEGMENTS = ("top", "prep", "body", "store", "inner", "tail")
#: (text of the kernel, stamps placed before it or after it): stamp 0 at a
#: pass's start, 6 at its end; an element pass takes stamps 3-6 at once
ANCHORS = (
    ("      if (recent >= 0 || older) {  // no buffer is written while a store reads it\n",
     "before", (0,)),
    ("      __syncthreads();  // the last pass is done with the regions and the partial sums\n",
     "after", (1,)),
    ("      const float* r = rd >= 0 ? region(rd) : nullptr;\n", "before", (2,)),
    ("        continue;\n      }\n      float* w = region(work);\n", "before", (3, 4, 5, 6)),
    ("      if (dst > 0) {\n        asm volatile(\"fence.proxy.async.shared::cta;", "before", (3,)),
    ("        stores_open = true;\n      }\n", "after", (4,)),
    ("    }\n    if (tid == 0) bulk_wait_written();  // no store outlives the block\n", "before",
     (5, 6)),
)
STAMP = ("if (g_trace && threadIdx.x == 0 && blockIdx.x < g_blocks) "
         "g_trace[((long long)blockIdx.x * n_passes + p) * 8 + {i}] = clock64();\n")


def build(out: Path) -> tuple:
    """The traced copy, loaded and declared as the runtime loads a library:
    (library, its error string)."""
    from repro_torch.kernels import _build

    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    out.mkdir(parents=True, exist_ok=True)
    for name in ("dmem.cuh", "statevector.cuh"):
        (out / name).write_text((csrc / name).read_text())
    src = (csrc / "vqc_shift_dmem.cu").read_text()
    src = src.replace("namespace vqc {\n", "namespace vqc {\n__device__ long long* g_trace;\n"
                      "__device__ int g_blocks;\n", 1)
    for text, where, marks in ANCHORS:
        if src.count(text) != 1:
            raise RuntimeError(f"anchor not found once in vqc_shift_dmem.cu: {text!r}")
        stamp = "".join(STAMP.replace("{i}", str(i)) for i in marks)
        src = src.replace(text, stamp + text if where == "before" else text + stamp)
    src += ('\nextern "C" int set_trace(long long* p, int blocks) {\n'
            '  cudaMemcpyToSymbol(vqc::g_blocks, &blocks, sizeof(blocks));\n'
            '  return (int)cudaMemcpyToSymbol(vqc::g_trace, &p, sizeof(p));\n}\n')
    (out / "vqc_shift_dmem.cu").write_text(src)
    lib_path = out / "libvqc_shift_dmem_trace.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                           str(out / "vqc_shift_dmem.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the traced copy:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    return lib, _build.declare(lib, out / "vqc_shift_dmem.cu")


def kinds(walk) -> list[str]:
    out = []
    for (src, dst, row, *_), st in zip(walk.passes.tolist(), walk.stage.tolist()):
        kind = ("data" if src < 0 and dst == 0 else "chi" if src == 0 else
                "forward" if dst > 0 else "f0" if row == -2 else "variant")
        out.append(f"{kind}:{('per_gate', 'orbit', 'element')[st[7]]}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("shift_dmem_trace: CUDA is not available", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--qc", type=int, default=27)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--batch", type=int, default=576)
    args = ap.parse_args()
    from repro_torch.comanager import dataplane
    from repro_torch.core import circuits
    from repro_torch.kernels import _build
    from repro_torch.kernels import vqc_statevector as K

    dev, card = torch.device("cuda", 0), smi_line()
    log(card)
    spec = circuits.build_quclassi_circuit(args.qc, args.layers)
    n_groups = 1 + 2 * spec.n_theta
    assign = dataplane.round_robin_assignment(n_groups, 2)
    sets = {"whole": tuple(range(n_groups))}
    for w in range(2):
        sets[f"worker {w}"] = tuple(g for g in range(n_groups) if assign[g] == w)
    rng = np.random.default_rng(args.qc)
    th = torch.tensor(rng.uniform(-np.pi, np.pi, (args.batch, spec.n_theta)),
                      dtype=torch.float32, device=dev)
    dt = torch.tensor(rng.uniform(0.0, np.pi, (args.batch, spec.n_data)), dtype=torch.float32,
                      device=dev)
    built = _build.load("vqc_shift_dmem")
    traced = build(ROOT / "build" / "shift_dmem_trace")
    blocks = min(args.batch, torch.cuda.get_device_properties(dev).multi_processor_count)
    result = {"card": card, "shape": f"{args.qc}q-{args.layers}l B={args.batch}", "sets": {}}
    try:
        for label, gs in sets.items():
            walk = K._shift_route(spec, False, gs, K.SMEM_BUDGET_BYTES)
            if walk.route != "dmem" or walk.m != walk.k:
                raise AssertionError(f"{label}: not a one-chunk device-memory walk")

            def run(gs=gs):
                return K.vqc_shift_fidelity(spec, th, dt, groups=gs)

            _build._loaded["vqc_shift_dmem"] = built
            want = run().clone()
            built_ms = time_ms(run, iters=3, warmup=1)
            _build._loaded["vqc_shift_dmem"] = traced
            n = len(walk.passes)
            buf = torch.zeros((blocks, n, 8), dtype=torch.int64, device=dev)
            traced[0].set_trace(ctypes.c_void_p(buf.data_ptr()), blocks)
            got = run()
            torch.cuda.synchronize()
            traced[0].set_trace(ctypes.c_void_p(0), 0)
            traced_ms = time_ms(run, iters=3, warmup=1)
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: the traced copy's rows differ from the kernel's")
            t = buf.cpu().numpy().astype(np.float64)
            nxt = np.concatenate([t[:, 1:, 0], t[:, -1:, 6]], axis=1)
            seg = np.stack([t[:, :, 1] - t[:, :, 0], t[:, :, 2] - t[:, :, 1],
                            t[:, :, 3] - t[:, :, 2], t[:, :, 4] - t[:, :, 3],
                            t[:, :, 5] - t[:, :, 4], nxt - t[:, :, 5]], axis=2).mean(axis=0)
            by_kind = {}
            for i, kind in enumerate(kinds(walk)):
                rec = by_kind.setdefault(kind, {"passes": 0, **{s: 0.0 for s in SEGMENTS}})
                rec["passes"] += 1
                for j, s in enumerate(SEGMENTS):
                    rec[s] += float(seg[i, j])
            for rec in by_kind.values():
                for s in SEGMENTS:
                    rec[s] = round(rec[s] / rec["passes"], 1)
            sample = float((t[:, -1, 6] - t[:, 0, 0]).mean())
            result["sets"][label] = {"groups": len(gs), "passes": n, "cycles_a_sample": sample,
                                     "kernel_ms": built_ms, "traced_ms": traced_ms,
                                     "by_kind": by_kind}
            log(f"{label}: G={len(gs)}, {n} passes, {sample:.0f} cycles a sample (first wave); "
                f"kernel {built_ms:.4f} ms, traced copy {traced_ms:.4f} ms [{card}]")
            for kind, rec in by_kind.items():
                log(f"  {kind:17s} x{rec['passes']:<4d} " + ", ".join(
                    f"{s} {rec[s]:.0f}" for s in SEGMENTS))
    finally:
        _build._loaded["vqc_shift_dmem"] = built
    out = ROOT / "chiprun_out" / "shift_dmem_trace.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    log(f"wrote {out.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
