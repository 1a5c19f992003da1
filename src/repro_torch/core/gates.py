"""Quantum gate matrices as (real, imag) float32 tensor pairs.

The port keeps the reference's representation: a complex matrix is a pair
``(U_re, U_im)``.  A k-qubit gate is ``(..., 2**k, 2**k)``: parameterized
constructors take an angle tensor of any shape and return one matrix per
angle (leading axes = the angle's shape), so a batch of circuits with
per-circuit angles applies its gates in one contraction.  Constant gates
take the ``device`` to build on.

Gate set = what DQuLearn's QuClassi workload needs (paper §IV-A):
  Single Qubit Unitary layer : RY, RZ          (+ RX for data encoding)
  Dual Qubit Unitary layer   : RYY, RZZ
  Entanglement Unitary layer : CRY, CRZ
  SWAP-test measurement      : H, CSWAP
"""
from __future__ import annotations

import torch

Mat = tuple[torch.Tensor, torch.Tensor]  # (re, im)

_SQRT2_INV = 0.7071067811865476
_F32 = torch.float32


def _real(m: torch.Tensor) -> Mat:
    return m, torch.zeros_like(m)


# ---------------------------------------------------------------- constants
def h(device=None) -> Mat:
    m = torch.tensor([[1.0, 1.0], [1.0, -1.0]], dtype=_F32, device=device)
    return _real(m * _SQRT2_INV)


def x(device=None) -> Mat:
    return _real(torch.tensor([[0.0, 1.0], [1.0, 0.0]], dtype=_F32, device=device))


def swap(device=None) -> Mat:
    m = torch.zeros((4, 4), dtype=_F32, device=device)
    m[0, 0] = m[1, 2] = m[2, 1] = m[3, 3] = 1.0
    return _real(m)


def cswap(device=None) -> Mat:
    """Controlled-SWAP (Fredkin), control = first qubit of the 3."""
    m = torch.eye(8, dtype=_F32, device=device)
    # |1ab> -> |1ba>: swap basis indices 0b101 (5) and 0b110 (6).
    m[5, 5] = m[6, 6] = 0.0
    m[5, 6] = m[6, 5] = 1.0
    return _real(m)


# ------------------------------------------------------------ rotations
def _cs(theta):
    theta = torch.as_tensor(theta, dtype=_F32)
    return torch.cos(theta / 2), torch.sin(theta / 2)


def _mat(rows) -> torch.Tensor:
    """Nested lists of same-shape tensors -> (..., R, C)."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rx(theta) -> Mat:
    c, s = _cs(theta)
    z = torch.zeros_like(c)
    return _mat([[c, z], [z, c]]), _mat([[z, -s], [-s, z]])


def ry(theta) -> Mat:
    c, s = _cs(theta)
    return _real(_mat([[c, -s], [s, c]]))


def rz(theta) -> Mat:
    c, s = _cs(theta)
    z = torch.zeros_like(c)
    return _mat([[c, z], [z, c]]), _mat([[-s, z], [z, s]])


def _diag4(a, b, c_, d):
    z = torch.zeros_like(a)
    return _mat([[a, z, z, z], [z, b, z, z], [z, z, c_, z], [z, z, z, d]])


def ryy(theta) -> Mat:
    """exp(-i theta/2 Y⊗Y): +i s on (00,11),(11,00), -i s on (01,10),(10,01)."""
    c, s = _cs(theta)
    z = torch.zeros_like(c)
    im = _mat([[z, z, z, s], [z, z, -s, z], [z, -s, z, z], [s, z, z, z]])
    return _diag4(c, c, c, c), im


def rzz(theta) -> Mat:
    """exp(-i theta/2 Z⊗Z) = diag(e^-it/2, e^it/2, e^it/2, e^-it/2)."""
    c, s = _cs(theta)
    return _diag4(c, c, c, c), _diag4(-s, s, s, -s)


def _controlled(u: Mat) -> Mat:
    """diag(I2, U) for a 1q gate U -> 4x4, control = first qubit."""
    u_re, u_im = u
    batch = u_re.shape[:-2]
    re = torch.eye(4, dtype=_F32, device=u_re.device).expand(batch + (4, 4)).clone()
    im = torch.zeros(batch + (4, 4), dtype=_F32, device=u_re.device)
    re[..., 2:, 2:] = u_re
    im[..., 2:, 2:] = u_im
    return re, im


def cry(theta) -> Mat:
    return _controlled(ry(theta))


def crz(theta) -> Mat:
    return _controlled(rz(theta))


#: name -> (constructor, n_qubits, takes_angle)
GATES = {
    "h": (h, 1, False),
    "x": (x, 1, False),
    "swap": (swap, 2, False),
    "cswap": (cswap, 3, False),
    "rx": (rx, 1, True),
    "ry": (ry, 1, True),
    "rz": (rz, 1, True),
    "ryy": (ryy, 2, True),
    "rzz": (rzz, 2, True),
    "cry": (cry, 2, True),
    "crz": (crz, 2, True),
}
