"""Dense statevector simulator over (re, im) float32 tensor pairs.

The independent oracle of the port, as ``repro.core.sim`` is of the
reference: every gate is a dense (2**k, 2**k) matrix contracted against the
state viewed as a rank-n tensor, with no knowledge of the structured
micro-ops the kernels use.  Autograd flows through it, which is how the
dense layer of QuClassi is trained.

Layout convention: a state over ``n`` qubits is a pair of float32 tensors of
shape ``(..., 2**n)`` (leading axes = batch).  Qubit 0 is the MOST
significant bit of the basis index: basis index = q0 q1 ... q_{n-1} in
binary.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import gates as G

State = tuple[torch.Tensor, torch.Tensor]


def zero_state(n_qubits: int, batch: tuple[int, ...] = (), device=None) -> State:
    dim = 2**n_qubits
    re = torch.zeros(batch + (dim,), dtype=torch.float32, device=device)
    re[..., 0] = 1.0
    im = torch.zeros(batch + (dim,), dtype=torch.float32, device=device)
    return re, im


def apply_gate(state: State, u: G.Mat, qubits: Sequence[int], n_qubits: int) -> State:
    """Apply a k-qubit gate ``u`` to ``qubits`` of an n-qubit state.

    Views the state as a rank-n tensor of shape (2,)*n, moves the target
    axes to the front, contracts with the (..., 2**k, 2**k) matrix (its
    leading axes broadcast against the state's batch), and moves axes back.
    """
    re, im = state
    k = len(qubits)
    batch = tuple(re.shape[:-1])
    nb = len(batch)
    axes = [nb + q for q in qubits]
    rest = [nb + i for i in range(n_qubits) if i not in set(qubits)]
    perm = list(range(nb)) + axes + rest

    def to_front(t):
        return t.reshape(batch + (2,) * n_qubits).permute(perm).reshape(
            batch + (2**k, -1)
        )

    t_re, t_im = to_front(re), to_front(im)
    u_re, u_im = u
    # complex matmul: (U_re + i U_im) @ (t_re + i t_im)
    o_re = torch.einsum("...ij,...jk->...ik", u_re, t_re) - torch.einsum(
        "...ij,...jk->...ik", u_im, t_im
    )
    o_im = torch.einsum("...ij,...jk->...ik", u_re, t_im) + torch.einsum(
        "...ij,...jk->...ik", u_im, t_re
    )
    out_batch = tuple(o_re.shape[:-2])
    inv = [0] * (len(out_batch) + n_qubits)
    for i, p in enumerate(perm):
        inv[p] = i

    def back(t):
        return t.reshape(out_batch + (2,) * n_qubits).permute(inv).reshape(
            out_batch + (2**n_qubits,)
        )

    return back(o_re), back(o_im)


# ------------------------------------------------------------- circuit spec
@dataclasses.dataclass(frozen=True)
class Op:
    """One gate in a circuit.

    ``param`` selects the angle source:
      ("theta", j)  -> trainable parameter j
      ("data", j)   -> data-encoding angle j
      ("const", v)  -> fixed float angle v
      None          -> non-parameterized gate
    """

    gate: str
    qubits: tuple[int, ...]
    param: tuple | None = None

    def __post_init__(self):
        _, k, takes_angle = G.GATES[self.gate]
        if len(self.qubits) != k:
            raise ValueError(f"{self.gate} acts on {k} qubits, got {self.qubits}")
        if takes_angle != (self.param is not None):
            raise ValueError(f"{self.gate}: param {self.param!r} does not fit")


@dataclasses.dataclass(frozen=True)
class CircuitSpec:
    """Static circuit structure: gates are Python data, angles are tensors."""

    n_qubits: int
    ops: tuple[Op, ...]
    n_theta: int
    n_data: int

    def angle_of(self, op: Op, theta, data):
        kind, j = op.param
        if kind == "theta":
            return theta[..., j]
        if kind == "data":
            return data[..., j]
        if kind == "const":
            return torch.tensor(j, dtype=torch.float32, device=theta.device)
        raise ValueError(op.param)


def run_circuit(spec: CircuitSpec, theta, data, state: State | None = None) -> State:
    """Execute ``spec`` from |0...0> (or ``state``).

    theta: (..., n_theta), data: (..., n_data); their leading axes broadcast
    into the batch of circuits.
    """
    if state is None:
        batch = torch.broadcast_shapes(theta.shape[:-1], data.shape[:-1])
        state = zero_state(spec.n_qubits, tuple(batch), device=theta.device)
    for op in spec.ops:
        ctor, _, takes_angle = G.GATES[op.gate]
        if takes_angle:
            u = ctor(spec.angle_of(op, theta, data))
        else:
            u = ctor(device=theta.device)
        state = apply_gate(state, u, op.qubits, spec.n_qubits)
    return state


def probabilities(state: State) -> torch.Tensor:
    re, im = state
    return re * re + im * im


def marginal_p0(state: State, qubit: int, n_qubits: int) -> torch.Tensor:
    """P(measuring |0> on ``qubit``)."""
    p = probabilities(state)
    batch = tuple(p.shape[:-1])
    t = p.reshape(batch + (2,) * n_qubits)
    t = torch.movedim(t, len(batch) + qubit, len(batch))
    return t.reshape(batch + (2, -1))[..., 0, :].sum(-1)


def state_norm(state: State) -> torch.Tensor:
    return torch.sqrt(probabilities(state).sum(-1))
