"""SWAP-test fidelity readout + fidelity-based loss (Quantum Measurement +
Quantum State Analyst modules of the paper's architecture, Fig 1).

After the SWAP test, P(ancilla = 0) = (1 + F) / 2 where
F = |<data|trainable>|^2, so F = 2 P0 - 1.
"""
from __future__ import annotations

import torch

from repro_torch.core import sim
from repro_torch.core.sim import CircuitSpec

_EPS = 1e-7


def ancilla_p0(spec: CircuitSpec, theta, data) -> torch.Tensor:
    state = sim.run_circuit(spec, theta, data)
    return sim.marginal_p0(state, qubit=0, n_qubits=spec.n_qubits)


def fidelity(spec: CircuitSpec, theta, data) -> torch.Tensor:
    """F = |<phi(data)|psi(theta)>|^2 in [0, 1] via the SWAP test."""
    return torch.clamp(2.0 * ancilla_p0(spec, theta, data) - 1.0, 0.0, 1.0)


def fidelity_batch(spec: CircuitSpec, theta, data) -> torch.Tensor:
    """(B,P),(B,D)->(B,): the simulator is batched over leading axes, so this
    is ``fidelity`` itself (the reference needs a vmap here)."""
    return fidelity(spec, theta, data)


def bce_loss(fid: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with fidelity as p(class=1) (QuClassi's loss)."""
    f = torch.clamp(fid, _EPS, 1.0 - _EPS)
    return -(label * torch.log(f) + (1.0 - label) * torch.log(1.0 - f))


def bce_grad_wrt_fidelity(fid: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """dL/dF, evaluated classically by the Quantum State Analyst."""
    f = torch.clamp(fid, _EPS, 1.0 - _EPS)
    return (f - label) / (f * (1.0 - f))
