"""Parameter-shift training: circuit-bank generation + gradient assembly
(Algorithm 1, lines 12–22).

For every trainable parameter theta_j the paper appends one forward-shifted
(+pi/2) and one backward-shifted (-pi/2) circuit to the *circuit bank* cB;
the bank is what gets distributed to quantum workers, and the returned
fidelities are assembled into gradients on the classical side.

The two-term rule
    dF/dtheta_j = (F(theta + pi/2 e_j) - F(theta - pi/2 e_j)) / 2
is exact for RX/RY/RZ/RYY/RZZ but not for the controlled rotations CRY/CRZ
(generator eigenvalues {0, +-1/2}).  The exact four-term rule
    dF/dtheta = c+ [F(+pi/2) - F(-pi/2)] - c- [F(+3pi/2) - F(-3pi/2)],
    c+- = (sqrt(2) +- 1) / (4 sqrt(2))
is available as ``exact_controlled=True``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.api.capabilities import capabilities_of
from repro_torch.core import fidelity as fid
from repro_torch.core.sim import CircuitSpec

SHIFT = math.pi / 2
_SQ2 = 2.0**0.5
C_PLUS = (_SQ2 + 1.0) / (4.0 * _SQ2)
C_MINUS = (_SQ2 - 1.0) / (4.0 * _SQ2)

#: executor signature: (theta_bank (C,P), data_bank (C,D)) -> fidelities (C,)
Executor = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def controlled_param_indices(spec: CircuitSpec) -> tuple[int, ...]:
    """Theta indices driven by controlled-rotation gates (4-term params)."""
    idx = []
    for op in spec.ops:
        if op.gate in ("cry", "crz") and op.param and op.param[0] == "theta":
            idx.append(op.param[1])
    return tuple(sorted(set(idx)))


def shift_values(four_term: bool) -> tuple[float, ...]:
    """Shift magnitudes in bank-group order: +-pi/2 [, +-3pi/2]."""
    base = (SHIFT, -SHIFT)
    return base + (3 * SHIFT, -3 * SHIFT) if four_term else base


def group_descriptors(n_params: int, four_term: bool):
    """Per-(param, shift) group descriptors in bank order.

    Group g covers bank rows [g*B, (g+1)*B): g=0 is the unshifted base
    (descriptor ``(-1, 0.0)``), g = 1 + s*P + j is shift s of param j.
    """
    out = [(-1, 0.0)]
    for s in shift_values(four_term):
        for j in range(n_params):
            out.append((j, float(s)))
    return tuple(out)


def _split_results(f: torch.Tensor, b: int, p: int, four_term: bool):
    """fidelities (C,) -> (f0 (B,), f_plus (P,B), f_minus (P,B)[, f3p, f3m])."""
    f0 = f[:b]
    body = f[b : b + 2 * p * b].reshape(2, p, b)
    out = [f0, body[0], body[1]]
    if four_term:
        tail = f[b + 2 * p * b :].reshape(2, p, b)
        out += [tail[0], tail[1]]
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class CircuitBank:
    """A flat batch of (theta, data) circuit instances + index bookkeeping.

    Layout (C = n_base + 2 * P * B [+ 2 * P * B more when four_term]):
      [0, B)                 : unshifted circuits (forward pass, loss value)
      [B + (s*P + j)*B + b]  : s=0 plus-shift, s=1 minus-shift of param j, sample b
      four-term tail         : same layout with +-3pi/2 shifts
    """

    theta: torch.Tensor  # (C, P)
    data: torch.Tensor   # (C, D)
    n_samples: int
    n_params: int
    four_term: bool

    @property
    def n_circuits(self) -> int:
        return self.theta.shape[0]

    def split_results(self, f: torch.Tensor):
        return _split_results(f, self.n_samples, self.n_params, self.four_term)


@dataclasses.dataclass(frozen=True)
class ShiftBank:
    """An IMPLICIT circuit bank: base angles + shift descriptors only.

    Semantically identical to the ``CircuitBank`` that ``materialize()``
    returns, but it never stores the (C, P) theta matrix — just the
    per-sample base ``theta (B, P)``, ``data (B, D)`` and the static group
    structure.  Shift-aware executors consume it directly; everything else
    goes through ``materialize()``.
    """

    theta: torch.Tensor  # (B, P) base thetas, one row per sample
    data: torch.Tensor   # (B, D)
    n_samples: int
    n_params: int
    four_term: bool

    @property
    def n_shifts(self) -> int:
        return 4 if self.four_term else 2

    @property
    def n_groups(self) -> int:
        return 1 + self.n_shifts * self.n_params

    @property
    def n_circuits(self) -> int:
        return self.n_groups * self.n_samples

    def group_descriptors(self):
        return group_descriptors(self.n_params, self.four_term)

    def split_results(self, f: torch.Tensor):
        return _split_results(f, self.n_samples, self.n_params, self.four_term)

    def materialize(self) -> CircuitBank:
        """The escape hatch: expand to the explicit (C, P) bank.

        Bit-identical to ``build_bank`` on the same base angles (same
        broadcast + concatenation arithmetic), pinned by tests.
        """
        b, p = self.n_samples, self.n_params
        eye = torch.eye(p, dtype=self.theta.dtype, device=self.theta.device)

        def shifted(s):
            t = self.theta[None, :, :] + s * eye[:, None, :]   # (P, B, P)
            return t.reshape(p * b, p)

        blocks = [self.theta]
        blocks += [shifted(s) for s in shift_values(self.four_term)]
        theta_bank = torch.cat(blocks, 0)
        data_bank = self.data.repeat(self.n_groups, 1)
        return CircuitBank(
            theta_bank, data_bank, n_samples=b, n_params=p, four_term=self.four_term
        )


def build_bank(
    theta: torch.Tensor, data: torch.Tensor, four_term: bool = False
) -> CircuitBank:
    """Build the circuit bank for a sample batch. theta: (P,), data: (B, D)."""
    (p,) = theta.shape
    b = data.shape[0]
    eye = torch.eye(p, dtype=theta.dtype, device=theta.device)

    def shifted(s):
        # (P, P) thetas, tiled over B -> (P, B, P)
        t = theta[None, :] + s * eye
        return t[:, None, :].expand(p, b, p).reshape(p * b, p)

    blocks = [theta[None, :].expand(b, p)]
    blocks += [shifted(s) for s in shift_values(four_term)]
    theta_bank = torch.cat(blocks, 0)
    reps = theta_bank.shape[0] // b
    data_bank = data.repeat(reps, 1)
    return CircuitBank(
        theta_bank, data_bank, n_samples=b, n_params=p, four_term=four_term
    )


def build_shift_bank(
    theta: torch.Tensor, data: torch.Tensor, four_term: bool = False
) -> ShiftBank:
    """Build the implicit bank. theta: (P,) or per-sample (B, P); data: (B, D)."""
    b = data.shape[0]
    if theta.dim() == 1:
        theta = theta[None, :].expand(b, theta.shape[0]).contiguous()
    return ShiftBank(
        theta, data, n_samples=b, n_params=theta.shape[1], four_term=four_term
    )


def group_bank_sets(items):
    """Group (spec, ShiftBank) pairs into FUSABLE bank-sets: same
    ``CircuitSpec`` and same ``four_term``.  Returns
    ``{(spec, four_term): [bank, ...]}`` in submission order."""
    sets: dict = {}
    for spec, bank in items:
        sets.setdefault((spec, bank.four_term), []).append(bank)
    return sets


def run_bank_set(executor, banks) -> list:
    """Execute several same-spec implicit banks through ``executor``:
    ``multibank`` executors receive the list (one fused launch), everything
    else falls back to per-bank ``run_bank`` calls."""
    banks = list(banks)
    if capabilities_of(executor).multibank:
        return list(executor(banks))
    return [run_bank(executor, bank) for bank in banks]


def default_executor(spec: CircuitSpec) -> Executor:
    """The dense simulator as an executor (no kernels)."""
    return lambda t, d: fid.fidelity_batch(spec, t, d)


def run_bank(executor: Executor, bank) -> torch.Tensor:
    """Execute a bank (implicit or materialized) through ``executor``.

    ``shiftbank`` executors are called with the ``ShiftBank`` itself; every
    other executor receives the materialized bank as ``(theta, data)``.
    """
    if isinstance(bank, ShiftBank):
        if capabilities_of(executor).shiftbank:
            return executor(bank)
        mat = bank.materialize()
        return executor(mat.theta, mat.data)
    return executor(bank.theta, bank.data)


def assemble_gradient(
    spec: CircuitSpec, bank: CircuitBank, fids: torch.Tensor, labels: torch.Tensor
):
    """-> (loss (scalar), grad_theta (P,), per-sample fidelities (B,)).

    The classical Quantum State Analyst step: chain dL/dF through the
    shift-rule estimate of dF/dtheta.
    """
    parts = bank.split_results(fids)
    f0, f_plus, f_minus = parts[0], parts[1], parts[2]
    dfdt = (f_plus - f_minus) / 2.0  # (P, B) two-term estimate
    if bank.four_term:
        f3p, f3m = parts[3], parts[4]
        four = C_PLUS * (f_plus - f_minus) - C_MINUS * (f3p - f3m)
        ctrl = controlled_param_indices(spec)
        if ctrl:
            mask = torch.zeros((bank.n_params, 1), dtype=fids.dtype, device=fids.device)
            mask[list(ctrl), 0] = 1.0
            dfdt = mask * four + (1.0 - mask) * dfdt
    chain = fid.bce_grad_wrt_fidelity(f0, labels)  # (B,)
    grad = (dfdt * chain[None, :]).mean(-1)  # (P,)
    loss = fid.bce_loss(f0, labels).mean()
    return loss, grad, f0


def parameter_shift_grad(
    spec: CircuitSpec,
    theta: torch.Tensor,
    data: torch.Tensor,
    labels: torch.Tensor,
    executor: Executor | None = None,
    exact_controlled: bool = False,
    implicit: bool | None = None,
):
    """One full Algorithm-1 gradient step's worth of circuit-bank work.

    ``implicit``: build a ``ShiftBank`` instead of the explicit bank;
    ``None`` = auto: implicit exactly when the executor declares the
    ``shiftbank`` capability.
    """
    four = exact_controlled and bool(controlled_param_indices(spec))
    run = executor or default_executor(spec)
    if implicit is None:
        implicit = capabilities_of(run).shiftbank
    build = build_shift_bank if implicit else build_bank
    bank = build(theta, data, four_term=four)
    fids = run_bank(run, bank)
    return assemble_gradient(spec, bank, fids, labels)


def autodiff_grad(
    spec: CircuitSpec, theta: torch.Tensor, data: torch.Tensor, labels: torch.Tensor
):
    """Exact gradient through the simulator (validation oracle for the rule)."""
    t = theta.detach().requires_grad_(True)
    f = fid.fidelity_batch(spec, t[None, :].expand(data.shape[0], -1), data)
    loss = fid.bce_loss(f, labels).mean()
    (g,) = torch.autograd.grad(loss, t)
    return loss.detach(), g, f.detach()
