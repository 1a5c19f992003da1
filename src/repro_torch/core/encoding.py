"""Classical-data -> qubit encodings (paper §III-A, Logical Circuit Generator).

* ``rotation_angles`` — the paper's default ("we utilize X and Y rotations to
  encode our data"): a flattened patch is mapped to 2 angles per data qubit
  (RX, RY), either directly (pixel -> angle in [0, pi]) or through the
  model's classical dense layer (Algorithm 1 line 10).
* ``amplitude_encoding`` — the log_n encoding referenced in Algorithm 1
  line 8: 2**m values are L2-normalized onto the amplitudes of m qubits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rotation_angles(patch: torch.Tensor, n_angles: int) -> torch.Tensor:
    """Map a flattened patch (..., P) to (..., n_angles) rotation angles.

    Pixels are assumed in [0, 1]; angle = pixel * pi.  If P != n_angles the
    patch is average-pooled (P > n) or tiled (P < n).
    """
    p = patch.shape[-1]
    if p == n_angles:
        v = patch
    elif p > n_angles:
        # average-pool groups of ceil(P/n) pixels
        v = F.pad(patch, (0, (-p) % n_angles))
        v = v.reshape(*patch.shape[:-1], n_angles, -1).mean(-1)
    else:
        reps = -(-n_angles // p)
        v = patch.repeat(*([1] * (patch.dim() - 1)), reps)[..., :n_angles]
    return (v * math.pi).to(torch.float32)


def amplitude_encoding(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """log_n encoding: (..., 2**m) values -> normalized m-qubit state (re, im)."""
    dim = values.shape[-1]
    if dim & (dim - 1):
        raise ValueError(f"amplitude encoding needs a power-of-two length, got {dim}")
    norm = torch.linalg.vector_norm(values, dim=-1, keepdim=True)
    # Guard the all-zero patch: fall back to |0...0>.
    basis0 = torch.zeros_like(values)
    basis0[..., 0] = 1.0
    safe = torch.where(norm > 1e-8, values / torch.clamp(norm, min=1e-8), basis0)
    safe = safe.to(torch.float32)
    return safe, torch.zeros_like(safe)


def angles_to_unit_interval(angles: torch.Tensor) -> torch.Tensor:
    """Inverse of the pixel->angle map (for round-trip tests)."""
    return angles / math.pi
