"""Dense-simulator oracles for the statevector kernels.

Written independently of the kernel code paths: the oracle runs the dense
(2**k, 2**k) gate contractions of ``repro_torch.core.sim``, while the CUDA
kernels and their plain versions use structured row-combination micro-ops,
so an agreement test covers both formulations.
"""
from __future__ import annotations

import torch

from repro_torch.core import sim
from repro_torch.core.sim import CircuitSpec


def vqc_state_ref(spec: CircuitSpec, theta: torch.Tensor, data: torch.Tensor):
    """(C,P),(C,D) -> final state (re, im), each (C, 2**n)."""
    return sim.run_circuit(spec, theta, data)


def vqc_p0_ref(spec: CircuitSpec, theta: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(C,P),(C,D) -> ancilla P(|0>) per circuit, (C,)."""
    state = vqc_state_ref(spec, theta, data)
    return sim.marginal_p0(state, qubit=0, n_qubits=spec.n_qubits)


def vqc_fidelity_ref(spec: CircuitSpec, theta, data) -> torch.Tensor:
    return torch.clamp(2.0 * vqc_p0_ref(spec, theta, data) - 1.0, 0.0, 1.0)
