"""QuClassi-style variational circuit construction (paper §IV-A).

A DQuLearn circuit over ``qc`` qubits has three registers:

  qubit 0                    : ancilla (SWAP-test readout)
  qubits 1 .. m              : DATA register   (m = (qc-1)//2 qubits)
  qubits m+1 .. 2m           : TRAINABLE register

The trainable register is prepared by a stack of variational layers:

  "single"   : RY + RZ on every trainable qubit          (2m params)
  "dual"     : RYY + RZZ on adjacent qubit pairs          (2(m-1) params)
  "entangle" : CRY + CRZ on adjacent qubit pairs          (2(m-1) params)

matching the paper's three configurations — 1 layer = [single],
2 layers = [single, dual], 3 layers = [single, dual, entangle].

The DATA register is prepared by rotation encoding (RX+RY per qubit, angles
supplied at run time — "we utilize X and Y rotations to encode our data",
paper §III-A).  Fidelity between the registers is read out with the standard
SWAP test: H(anc) -> CSWAP(anc, d_i, t_i) -> H(anc); then
P(anc=0) = (1 + |<psi|phi>|^2) / 2.
"""
from __future__ import annotations

from repro_torch.core.sim import CircuitSpec, Op

LAYER_SEQUENCE = ("single", "dual", "entangle")


def layers_for_count(n_layers: int) -> tuple[str, ...]:
    """Paper's layer configurations: 1 -> [single], 2 -> +dual, 3 -> +entangle."""
    if not 1 <= n_layers <= 3:
        raise ValueError(f"paper evaluates 1..3 layers, got {n_layers}")
    return LAYER_SEQUENCE[:n_layers]


def registers(qc: int) -> tuple[int, list[int], list[int]]:
    """-> (ancilla, data qubits, trainable qubits) for a qc-qubit circuit."""
    if qc % 2 == 0 or qc < 3:
        raise ValueError(
            f"need odd qubit count >=3 (ancilla + 2 equal registers), got {qc}"
        )
    m = (qc - 1) // 2
    anc = 0
    data_q = list(range(1, 1 + m))
    train_q = list(range(1 + m, 1 + 2 * m))
    return anc, data_q, train_q


def n_theta_for(qc: int, n_layers: int) -> int:
    m = (qc - 1) // 2
    total = 0
    for name in layers_for_count(n_layers):
        total += 2 * m if name == "single" else 2 * (m - 1)
    return total


def n_data_angles_for(qc: int) -> int:
    m = (qc - 1) // 2
    return 2 * m  # RX + RY per data qubit


def variational_ops(
    train_q: list[int], layer_names: tuple[str, ...], theta_offset: int = 0
):
    """Ops for the trainable register; returns (ops, n_theta)."""
    ops: list[Op] = []
    j = theta_offset
    m = len(train_q)
    for name in layer_names:
        if name == "single":
            for q in train_q:
                ops.append(Op("ry", (q,), ("theta", j))); j += 1
                ops.append(Op("rz", (q,), ("theta", j))); j += 1
        elif name == "dual":
            for a, b in zip(train_q[:-1], train_q[1:]):
                ops.append(Op("ryy", (a, b), ("theta", j))); j += 1
                ops.append(Op("rzz", (a, b), ("theta", j))); j += 1
        elif name == "entangle":
            for a, b in zip(train_q[:-1], train_q[1:]):
                ops.append(Op("cry", (a, b), ("theta", j))); j += 1
                ops.append(Op("crz", (a, b), ("theta", j))); j += 1
        else:
            raise ValueError(name)
    return ops, j - theta_offset


def encoding_ops(data_q: list[int], data_offset: int = 0):
    """RX+RY rotation encoding on the data register; returns (ops, n_data)."""
    ops: list[Op] = []
    j = data_offset
    for q in data_q:
        ops.append(Op("rx", (q,), ("data", j))); j += 1
        ops.append(Op("ry", (q,), ("data", j))); j += 1
    return ops, j - data_offset


def swap_test_ops(anc: int, data_q: list[int], train_q: list[int]) -> list[Op]:
    ops = [Op("h", (anc,))]
    for d, t in zip(data_q, train_q):
        ops.append(Op("cswap", (anc, d, t)))
    ops.append(Op("h", (anc,)))
    return ops


def build_quclassi_circuit(qc: int, n_layers: int) -> CircuitSpec:
    """The full DQuLearn subtask circuit: encode -> variational -> SWAP test.

    ``qc`` is the paper's qubit-count knob (5 or 7 in the evaluation).
    """
    anc, data_q, train_q = registers(qc)
    enc_ops, n_data = encoding_ops(data_q)
    var_ops, n_theta = variational_ops(train_q, layers_for_count(n_layers))
    ops = tuple(enc_ops + var_ops + swap_test_ops(anc, data_q, train_q))
    return CircuitSpec(n_qubits=qc, ops=ops, n_theta=n_theta, n_data=n_data)


def _mirror_twin(op: Op, train_q: list[int]) -> Op:
    """The register-mirrored twin of a variational op: each qubit at local
    index i maps to local index m-1-i.  Two-qubit pairs stay ascending
    (pair (i, i+1) mirrors to (m-2-i, m-1-i)), so cry/crz twins keep the
    (control, target) order the kernel requires."""
    m = len(train_q)
    base = train_q[0]
    mirrored = tuple(sorted(train_q[m - 1 - (q - base)] for q in op.qubits))
    return Op(op.gate, mirrored, op.param)


def build_tied_quclassi_circuit(qc: int, n_layers: int) -> CircuitSpec:
    """A weight-tied (2-reuse) hardware-efficient variant of the QuClassi
    circuit: every variational parameter drives TWO gates — the original
    gate and its register-mirrored twin at the same angle (the parameter
    sharing common in the hardware-efficient architectures surveyed in
    Sünkel et al.).  Same parameter count as ``build_quclassi_circuit``,
    twice the variational depth.  Exercises the multi-use suffix-replay
    shift plans: the twin sits adjacent to its original, so each variant
    replays a two-gate span from one checkpoint instead of falling back to
    the (1+2P)x materialized bank."""
    anc, data_q, train_q = registers(qc)
    enc_ops, n_data = encoding_ops(data_q)
    var_ops, n_theta = variational_ops(train_q, layers_for_count(n_layers))
    tied: list[Op] = []
    for op in var_ops:
        tied.append(op)
        tied.append(_mirror_twin(op, train_q))
    ops = tuple(enc_ops + tied + swap_test_ops(anc, data_q, train_q))
    return CircuitSpec(n_qubits=qc, ops=ops, n_theta=n_theta, n_data=n_data)


def circuit_depth(spec: CircuitSpec) -> int:
    return len(spec.ops)


def qubit_demand(spec: CircuitSpec) -> int:
    """Resource demand D_c of a circuit (Algorithm 2) = its qubit width."""
    return spec.n_qubits
