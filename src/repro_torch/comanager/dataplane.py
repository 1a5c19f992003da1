"""Data plane: really execute circuit banks, per co-Manager assignment.

``worker_batched_executor`` groups the bank rows assigned to each worker and
runs each group through the fused statevector kernel — the faithful "each
worker executes its circuits" path.  Implicit ``shift_rule.ShiftBank``s make
the (param, shift) group the schedulable unit, executed by the prefix-reuse
kernel.  ``worker_multibank_executor`` schedules (bank, group) subtasks of a
same-spec bank set.  Results come back in bank order, so
``shift_rule.assemble_gradient`` consumes them identically — scheduling
never changes the math.

Every factory returns a ``declare``-d executor.  The sharded and mesh-spill
executors of the reference are not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.api.capabilities import declare
from repro_torch.core import shift_rule
from repro_torch.core.sim import CircuitSpec
from repro_torch.kernels import ops as kops


def worker_batched_executor(spec: CircuitSpec, assignment: Sequence[int], n_workers: int):
    """Executor that mimics per-worker execution.

    Materialized banks: ``assignment[i] = worker index for bank row i``.
    Rows are grouped per worker and executed as one fused-kernel batch each;
    results come back in bank order via ONE inverse-permutation gather.

    Implicit ``ShiftBank``s (``run(bank)``): ``assignment[g] = worker index
    for bank group g`` (length ``bank.n_groups``), and each worker executes
    its groups as one prefix-reuse kernel call over the whole sample batch.
    """
    assignment = np.asarray(assignment)
    # stable grouping permutation: rows sorted by worker, ties in bank order.
    order = np.argsort(assignment, kind="stable")
    inverse = np.argsort(order, kind="stable")
    bounds = np.searchsorted(assignment[order], np.arange(n_workers + 1))
    per_worker = [order[bounds[w] : bounds[w + 1]] for w in range(n_workers)]
    per_worker = [rows for rows in per_worker if rows.size]
    indices: dict = {}

    def _indices(device):
        """Per-worker row indices and the inverse gather, on ``device`` once."""
        got = indices.get(device)
        if got is None:
            got = indices[device] = (
                [torch.as_tensor(rows, device=device) for rows in per_worker],
                torch.as_tensor(inverse, device=device),
            )
        return got

    def _run_rows(theta_bank: torch.Tensor, data_bank: torch.Tensor) -> torch.Tensor:
        rows, inv = _indices(theta_bank.device)
        groups = [kops.vqc_fidelity(spec, theta_bank[r], data_bank[r]) for r in rows]
        return torch.cat(groups)[inv]

    def _run_shiftbank(bank: shift_rule.ShiftBank) -> torch.Tensor:
        if len(assignment) != bank.n_groups:
            if len(assignment) == bank.n_circuits:
                # per-ROW assignment: honor it exactly by materializing.
                mat = bank.materialize()
                return _run_rows(mat.theta, mat.data)
            raise ValueError(
                f"assignment must cover the bank's {bank.n_groups} groups or "
                f"{bank.n_circuits} rows, got {len(assignment)} entries"
            )
        outs = [
            kops.vqc_fidelity_shiftgroups(
                spec, bank.theta, bank.data, bank.four_term, tuple(int(g) for g in grp)
            )
            for grp in per_worker
        ]
        _, inv = _indices(bank.theta.device)
        return torch.cat(outs, 0)[inv].reshape(-1)  # (n_groups, B) flattened

    def run(theta_bank, data_bank=None):
        if isinstance(theta_bank, shift_rule.ShiftBank):
            return _run_shiftbank(theta_bank)
        return _run_rows(theta_bank, data_bank)

    return declare(run, shiftbank=True)


def round_robin_assignment(n_circuits: int, n_workers: int):
    """The degenerate scheduler baseline (no co-management); also the
    group-assignment baseline for implicit banks (``n_circuits =
    bank.n_groups``)."""
    return [i % n_workers for i in range(n_circuits)]


def worker_multibank_executor(spec: CircuitSpec, assignment: Sequence[int], n_workers: int):
    """Multi-bank scheduling: the schedulable unit is the (bank, group)
    subtask of a same-spec BANK SET.

    ``assignment[i]`` is the worker for flat subtask i, where subtasks
    enumerate every bank's groups in bank-major order.  Each worker executes
    ALL its subtasks — possibly spanning several banks — as ONE fused
    multi-bank prefix-reuse launch.  Returns per-bank flat fidelity vectors
    in bank order (``run(banks) -> [f_0, f_1, ...]``).
    """
    assignment = np.asarray(assignment)

    def run(banks: Sequence[shift_rule.ShiftBank]) -> list:
        if len({b.four_term for b in banks}) > 1:
            raise ValueError("banks in one fused set must share four_term")
        flat = [(bi, g) for bi, b in enumerate(banks) for g in range(b.n_groups)]
        if len(assignment) != len(flat):
            raise ValueError(
                f"assignment must cover the bank set's {len(flat)} "
                f"(bank, group) subtasks, got {len(assignment)} entries"
            )
        grids = [[None] * b.n_groups for b in banks]
        for w in range(n_workers):
            subtasks = [flat[i] for i in np.flatnonzero(assignment == w)]
            if not subtasks:
                continue
            w_banks, group_sets, slots = [], [], []
            index: dict[int, int] = {}
            for bi, g in subtasks:
                k = index.get(bi)
                if k is None:
                    k = index[bi] = len(w_banks)
                    w_banks.append(bi)
                    group_sets.append([])
                slots.append((k, len(group_sets[k])))
                group_sets[k].append(g)
            outs = kops.vqc_fidelity_shiftgroups_multibank(
                spec,
                tuple(banks[bi].theta for bi in w_banks),
                tuple(banks[bi].data for bi in w_banks),
                banks[0].four_term,
                tuple(tuple(gs) for gs in group_sets),
            )
            for (bi, g), (k, i) in zip(subtasks, slots):
                grids[bi][g] = outs[k][i]
        return [torch.stack(rows, 0).reshape(-1) for rows in grids]

    return declare(run, multibank=True)
