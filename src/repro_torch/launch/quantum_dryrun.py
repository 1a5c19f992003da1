"""Dry-run + roofline of the PAPER'S OWN workload on the production mesh:
a multi-tenant circuit bank (the parameter-shift subtasks of all concurrent
clients) executed across the 16x16 pod.

Baseline = the mechanical port: per-gate statevector simulation
(``core.fidelity.fidelity_batch``: one op chain per gate, the statevector
round-trips memory between gates), the bank sharded over every chip.
Optimized = the fused kernel (``vqc_fused.cu`` ``fidelity_kernel``: the
statevector lives in shared memory for the whole circuit; device-memory
traffic is angles in, fidelity out), whose traffic is analytic.

The per-gate path's cost is ``roofline.op_counter``'s count of
``fidelity_batch`` over one device's rows on ``meta`` (the reference
analyses its compiled HLO).  With ``device``, the bank is also drawn (from
seed 0) and run through both paths there, and their largest difference
recorded.

Usage: PYTHONPATH=src python -m repro_torch.launch.quantum_dryrun [--circuits N]
       [--execute --device cuda]
Records land in experiments/dryrun_torch/quantum_bank__<q>q<l>L[__<mesh>].json.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import circuits as qc, fidelity as fid
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import chips, make_production_mesh
from repro_torch.roofline import analysis
from repro_torch.roofline.op_counter import count

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")
#: fused path against the per-gate path: the reference's kernel tolerance
TOL = 1e-5


def kernel_traffic(spec, n_circuits: int, chips: int) -> dict:
    """Analytic HBM traffic of the fused kernel (per device): read the
    angle block, write the fidelity; the statevector never leaves VMEM."""
    c_local = n_circuits // chips
    read = (spec.n_theta + spec.n_data) * 4 * c_local
    write = 4 * c_local
    return {"bytes_per_device": read + write}


def pergate_state_traffic(spec, n_circuits: int, chips: int) -> dict:
    """What the baseline moves: state read+write per gate."""
    c_local = n_circuits // chips
    dim = 2 ** spec.n_qubits
    per_gate = 2 * 4 * dim * c_local * 2          # (re,im) f32, r+w
    return {"bytes_per_device": per_gate * len(spec.ops)}


def count_pergate(spec, c_local: int):
    """``op_counter``'s cost of the per-gate path over ``c_local`` rows."""
    theta = torch.empty((c_local, spec.n_theta), dtype=torch.float32, device="meta")
    data = torch.empty((c_local, spec.n_data), dtype=torch.float32, device="meta")
    cost, _ = count(fid.fidelity_batch, spec, theta, data)
    return cost


#: the seed the executed bank is drawn from
SEED = 0


def bank(spec, n_circuits: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(theta (C, n_theta), data (C, n_data)) float32 angles in [-pi, pi),
    drawn from ``SEED``."""
    rng = np.random.default_rng(SEED)
    theta = rng.uniform(-np.pi, np.pi, (n_circuits, spec.n_theta)).astype(np.float32)
    data = rng.uniform(-np.pi, np.pi, (n_circuits, spec.n_data)).astype(np.float32)
    return torch.from_numpy(theta).to(device), torch.from_numpy(data).to(device)


def execute(spec, theta: torch.Tensor, data: torch.Tensor) -> dict:
    """The bank through the fused path (the kernel on the card, its plain
    version on the CPU) and the per-gate path: both fidelities and their
    largest difference."""
    fused = kops.vqc_fidelity(spec, theta, data)
    pergate = fid.fidelity_batch(spec, theta, data)
    return {"fused": fused, "pergate": pergate,
            "max_abs_diff": float(torch.max(torch.abs(fused - pergate)))}


def run(qc_width: int, n_layers: int, n_circuits: int, verbose=True, *, mesh=None,
        device=None, out_dir: str | None = None) -> dict:
    """The bank's record on ``mesh`` (default: the 16 x 16 production
    mesh, whose record is named as the reference's; another mesh's name
    carries its shape); with ``device``, also run there
    (``rec["executed"]``; the fidelities under ``rec["_results"]``, not
    written).  Times are against the H100's peaks."""
    spec = qc.build_quclassi_circuit(qc_width, n_layers)
    mesh_name = None if mesh is None else "x".join(str(n) for n in mesh.shape.values())
    mesh = mesh or make_production_mesh(multi_pod=False)
    n_chips = chips(mesh)
    hw = analysis.H100

    t0 = time.time()
    cost = count_pergate(spec, n_circuits // n_chips)
    t_count = time.time() - t0

    peak = hw.peak_f32_flops or hw.peak_flops      # the statevector is float32
    analytic = pergate_state_traffic(spec, n_circuits, n_chips)
    kern = kernel_traffic(spec, n_circuits, n_chips)
    rec = {
        "workload": f"vqc_bank_{qc_width}q{n_layers}L", "circuits": n_circuits,
        "chips": n_chips, "n_gates": len(spec.ops), "hardware": hw.name,
        "pergate": {
            "flops_per_device": cost.flops,
            "bytes_per_device": cost.bytes,
            "collective_bytes_per_device": 0.0,
            "compute_ms": cost.flops / peak * 1e3,
            "memory_ms": cost.bytes / hw.hbm_bw * 1e3,
            "analytic_state_bytes_per_device": analytic["bytes_per_device"],
            "analytic_state_ms": analytic["bytes_per_device"] / hw.hbm_bw * 1e3,
        },
        "fused_kernel": {
            "bytes_per_device": kern["bytes_per_device"],
            "memory_ms": kern["bytes_per_device"] / hw.hbm_bw * 1e3,
            "traffic_reduction_vs_pergate": cost.bytes / kern["bytes_per_device"],
        },
        "compile_s": None, "count_s": round(t_count, 2),
        "counted_on": "meta (torch eager, unfused: bytes are an upper bound)",
        "not_computed": ["compile_s"],
    }
    if device is not None:
        theta, data = bank(spec, n_circuits, device)
        res = execute(spec, theta, data)
        rec["executed"] = {"device": str(theta.device), "seed": SEED,
                           "max_abs_diff": res["max_abs_diff"], "tol": TOL}
    tag = f"quantum_bank__{qc_width}q{n_layers}L" + (f"__{mesh_name}" if mesh_name else "")
    out_dir = out_dir or RESULTS_DIR
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{tag}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    if device is not None:
        rec["_results"] = {"theta": theta, "data": data, **res}
    if verbose:
        print(f"[quantum-dryrun] {rec['workload']}: {n_circuits} circuits on "
              f"{n_chips} chips ({hw.name} peaks)")
        print(f"  per-gate : compute {rec['pergate']['compute_ms']:.3f}ms  "
              f"memory {rec['pergate']['memory_ms']:.3f}ms  "
              f"(counted bytes {cost.bytes:.2e}, "
              f"analytic state traffic {analytic['bytes_per_device']:.2e})")
        print(f"  fused    : memory {rec['fused_kernel']['memory_ms']:.4f}ms  "
              f"({rec['fused_kernel']['traffic_reduction_vs_pergate']:.0f}x "
              f"less HBM traffic)")
        if device is not None:
            print(f"  executed on {rec['executed']['device']}: fused vs per-gate max |diff| "
                  f"{rec['executed']['max_abs_diff']:.3e} (tol {TOL})")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--circuits", type=int, default=1_048_576)
    ap.add_argument("--qc", type=int, default=7)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--execute", action="store_true",
                    help="also run the bank through both paths on --device")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.qc, args.layers, args.circuits,
              device=args.device if args.execute else None)
    if args.execute and not rec["executed"]["max_abs_diff"] <= TOL:
        raise SystemExit(f"fused and per-gate paths differ by {rec['executed']['max_abs_diff']}")


if __name__ == "__main__":
    main()
