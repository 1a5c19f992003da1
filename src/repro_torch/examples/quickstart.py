"""Quickstart: the DQuLearn pipeline on one machine in ~a minute.

  1. build the paper's 5-qubit / 1-layer QuClassi circuit,
  2. segment an image into filter patches (Task Segmentation),
  3. run the SWAP-test fidelity through the fused fidelity kernel,
  4. take one parameter-shift gradient step and verify it against autodiff.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import circuits, quclassi, segmentation
from repro_torch.core.quclassi import QuClassiConfig
from repro_torch.data import mnist
from repro_torch.examples import arg_parser, parse
from repro_torch.kernels import ops


def main(argv=None, *, theta=None, params=None) -> dict:
    """``theta`` ((72, 4) circuit angles) and ``params`` (QuClassi weights,
    tensors) replace the seeded draws: the reference draws both from
    ``jax.random.PRNGKey(0)``."""
    _, dev = parse(arg_parser(__doc__), argv)
    # --- the subtask circuit -------------------------------------------------
    spec = circuits.build_quclassi_circuit(qc=5, n_layers=1)
    print(f"QuClassi circuit: {spec.n_qubits} qubits, {len(spec.ops)} gates, "
          f"{spec.n_theta} trainable params, {spec.n_data} data angles")

    # --- task segmentation (paper Fig 2): 8x8 image -> 3x3 patches of 4x4 ----
    cfg = QuClassiConfig(qc=5, n_layers=1)
    x, y = mnist.make_pair_dataset(1, 5, n_per_class=4, seed=0)
    patches = segmentation.segment(torch.as_tensor(x, device=dev), cfg.seg)
    print(f"segmentation: {x.shape} images -> {tuple(patches.shape)} patches "
          f"(stride {cfg.seg.stride}, width {cfg.seg.filter_width})")

    # --- fused-kernel fidelity on a batch of circuits ------------------------
    if theta is None:
        gen = torch.Generator().manual_seed(0)
        theta = torch.rand((patches.shape[0] * patches.shape[1], spec.n_theta),
                           generator=gen) * math.pi
    theta = theta.to(dev, torch.float32)
    angles = (patches.reshape(-1, 16)[:, :spec.n_data]) * math.pi
    fids = ops.vqc_fidelity(spec, theta, angles)
    print(f"kernel fidelities: shape {tuple(fids.shape)}, "
          f"range [{float(fids.min()):.3f}, {float(fids.max()):.3f}]")

    # --- one parameter-shift training step ------------------------------------
    if params is None:
        params = quclassi.init_params(cfg, torch.Generator().manual_seed(0), dev)
    params = {k: v.to(dev, torch.float32) for k, v in params.items()}
    xb, yb = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    loss_s, grads_s, _ = quclassi.grad_shift(cfg, params, xb, yb)
    loss_a, grads_a, _ = quclassi.grad_autodiff(cfg, params, xb, yb)
    gap = float((grads_s["theta"] - grads_a["theta"]).abs().max())
    print(f"parameter-shift loss {float(loss_s):.4f} "
          f"(autodiff {float(loss_a):.4f}), max grad gap {gap:.2e}")
    print("quickstart OK")
    return {"theta": theta, "fidelities": fids, "loss_shift": float(loss_s),
            "loss_autodiff": float(loss_a), "grads_shift": grads_s,
            "grads_autodiff": grads_a, "grad_gap": gap}


if __name__ == "__main__":
    main()
