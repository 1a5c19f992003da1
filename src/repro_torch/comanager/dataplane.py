"""Data plane: really execute circuit banks, per co-Manager assignment.

``worker_batched_executor`` groups the bank rows assigned to each worker and
runs each group through the fused statevector kernel — the faithful "each
worker executes its circuits" path; ``worker_pool_executor`` runs the same
groups concurrently, one thread and one CUDA stream per worker.  Implicit
``shift_rule.ShiftBank``s make the (param, shift) group the schedulable
unit, executed by the prefix-reuse kernel.  ``worker_multibank_executor``
schedules (bank, group) subtasks of a same-spec bank set.
``sharded_executor`` shards a whole bank's lanes over the devices of a
``DeviceMesh`` (``repro_torch.launch.mesh``), and ``MeshSpillExecutor`` is
the serving layer's escape hatch onto it for batches no single worker fits.
Results come back in bank order, so ``shift_rule.assemble_gradient``
consumes them identically — scheduling never changes the math.

Every factory returns a ``declare``-d executor.  The reference's
``bank_shardings`` (a ``pjit`` sharding read only by the dry-run) waits for
the dry-run's port (ROADMAP Queue 1 item 15).
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.api.capabilities import declare
from repro_torch.core import shift_rule
from repro_torch.core.sim import CircuitSpec
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import DeviceMesh, make_host_mesh


class SlotStreams:
    """One CUDA stream per execution slot and device, made at first use, so
    that slots running on several host threads overlap on the card.

    ``run(slot, device, waits, fn)`` (on the slot's thread) orders the
    slot's stream after ``waits`` — the streams and events the inputs were
    made behind — runs ``fn`` with the slot's stream current, and returns
    its result with a CUDA event recorded after it; ``wait(done, readers,
    outs)`` orders each reader stream after that event before it reads the
    result.  On the CPU both just run (``done`` is None)."""

    def __init__(self):
        self._streams: dict = {}
        self._lock = threading.Lock()

    def stream(self, slot, device: torch.device):
        with self._lock:
            s = self._streams.get((slot, device))
            if s is None:
                s = self._streams[(slot, device)] = torch.cuda.Stream(device)
            return s

    def run(self, slot, device: torch.device, waits, fn: Callable):
        if device.type != "cuda":
            return fn(), None
        s = self.stream(slot, device)
        with torch.cuda.device(device), torch.cuda.stream(s):
            for w in waits:
                if isinstance(w, torch.cuda.Event):
                    s.wait_event(w)
                else:
                    s.wait_stream(w)
            out = fn()
            done = torch.cuda.Event()
            done.record(s)
        return out, done

    @staticmethod
    def wait(done, readers, outs=()) -> None:
        """Order every stream of ``readers`` after ``done``; ``outs``
        (tensors made on the slot's stream) are marked as used by each
        reader, so their memory is not reused before it has read them."""
        if done is None:
            return
        for reader in readers:
            reader.wait_event(done)
        bases = {t.untyped_storage().data_ptr(): t for t in outs}
        for t in bases.values():
            for reader in readers:
                t.record_stream(reader)


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


def worker_pool_executor(
    spec: CircuitSpec,
    assignment: Sequence[int],
    n_workers: int,
    max_threads: int | None = None,
):
    """``worker_batched_executor`` with OVERLAPPING per-worker execution.

    Each worker's group is submitted to a thread pool, and each thread
    launches its kernel on its worker's own CUDA stream (``SlotStreams``),
    ordered after the caller's stream, so the groups of distinct workers
    overlap on the card.  Results gather in bank order on the caller's
    stream after each worker's stream is done, bit-identical to the
    sequential path (per-lane math never depends on the batch).

    Call ``run.close()`` to shut the pool down when the executor is retired
    (threads are created on demand, so an unused executor costs nothing).
    """
    assignment = np.asarray(assignment)
    order = np.argsort(assignment, kind="stable")
    inverse = np.argsort(order, kind="stable")
    bounds = np.searchsorted(assignment[order], np.arange(n_workers + 1))
    groups = [(w, order[bounds[w] : bounds[w + 1]]) for w in range(n_workers)]
    groups = [(w, rows) for w, rows in groups if rows.size]
    pool = ThreadPoolExecutor(
        max_workers=max_threads or n_workers, thread_name_prefix="dataplane-worker"
    )
    streams = SlotStreams()

    def _gather(device, jobs):
        caller = torch.cuda.current_stream(device) if device.type == "cuda" else None
        futs = [pool.submit(streams.run, w, device, (caller,), fn) for w, fn in jobs]
        outs = []
        for f in futs:
            out, done = f.result()
            streams.wait(done, (caller,), (out,))
            outs.append(out)
        return torch.cat(outs, 0)[torch.as_tensor(inverse, device=device)]

    def run(theta_bank, data_bank=None) -> torch.Tensor:
        if isinstance(theta_bank, shift_rule.ShiftBank):
            bank = theta_bank
            if len(assignment) != bank.n_groups:
                if len(assignment) == bank.n_circuits:
                    # per-ROW assignment: honor it by materializing, same as
                    # worker_batched_executor.
                    mat = bank.materialize()
                    return run(mat.theta, mat.data)
                raise ValueError(
                    f"assignment must cover the bank's {bank.n_groups} "
                    f"groups or {bank.n_circuits} rows, got "
                    f"{len(assignment)} entries"
                )
            jobs = [
                (w, lambda rows=rows: kops.vqc_fidelity_shiftgroups(
                    spec, bank.theta, bank.data, bank.four_term, tuple(int(g) for g in rows)))
                for w, rows in groups
            ]
            return _gather(bank.theta.device, jobs).reshape(-1)
        dev = theta_bank.device
        jobs = [
            (w, lambda rows=rows: kops.vqc_fidelity(
                spec, theta_bank[torch.as_tensor(rows, device=dev)],
                data_bank[torch.as_tensor(rows, device=dev)]))
            for w, rows in groups
        ]
        return _gather(dev, jobs)

    run.close = lambda: pool.shutdown(wait=True)
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


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x


def sharded_executor(spec: CircuitSpec, mesh: DeviceMesh, axis: str = "data"):
    """Whole-bank executor over the devices of ``mesh``'s ``data`` axis.

    Materialized banks: pads the rows to a multiple of the shard count,
    copies shard i to device i and launches the fused kernel there, every
    shard before waiting on any (kernel launches are asynchronous), then
    gathers the results onto the mesh's first device in bank order.

    Implicit ``ShiftBank``s (``run(bank)``): SAMPLES are sharded instead of
    materialized rows — every device runs the prefix-reuse kernel over its
    sample shard for all (param, shift) groups; the gathered (n_groups, B)
    grid flattens back to bank order.  Per-lane math never depends on the
    shard, so every shard count gives the same bits.
    """
    if axis != "data":
        raise ValueError(f"the port's meshes shard over 'data' only, got {axis!r}")
    devices = mesh.devices
    n_shards = len(devices)
    home = devices[0]

    def _shards(*arrays):
        """Each array padded to a multiple of the shard count and cut into
        one contiguous float32 piece per device, copied there."""
        c = arrays[0].shape[0]
        pad = (-c) % n_shards
        per = (c + pad) // n_shards
        padded = [_pad_rows(a.to(torch.float32), pad) for a in arrays]
        return [
            tuple(a[i * per : (i + 1) * per].to(dev, non_blocking=True).contiguous()
                  for a in padded)
            for i, dev in enumerate(devices)
        ]

    def _local(fn, *arrays, dim: int = 0):
        outs = [fn(*shard) for shard in _shards(*arrays)]  # all launched first
        return torch.cat([o.to(home) for o in outs], dim)

    def run(theta_bank, data_bank=None) -> torch.Tensor:
        if isinstance(theta_bank, shift_rule.ShiftBank):
            bank = theta_bank
            out = _local(
                lambda t, d: kops.vqc_fidelity_shiftgroups(spec, t, d, bank.four_term),
                bank.theta, bank.data, dim=1,
            )
            return out[:, : bank.n_samples].reshape(-1)
        c = theta_bank.shape[0]
        return _local(lambda t, d: kops.vqc_fidelity(spec, t, d), theta_bank, data_bank)[:c]

    def run_banks(thetas, datas, four_term: bool, group_sets: tuple):
        """Fused multi-bank launch SHARDED over the mesh: per-bank
        lane segments concatenate (``kops._pack_banks``), the union group
        set runs on every device's lane shard, and per-bank blocks slice
        back out — the contract of ``kops.vqc_fidelity_shiftgroups_multibank``
        with the device mesh as the executor (the dispatcher's spill path)."""
        union = tuple(sorted({g for gs in group_sets for g in gs}))
        theta_cat, data_cat, segments = kops._pack_banks(thetas, datas)
        out = torch.clamp(
            _local(
                lambda t, d: kops.vqc_fidelity_shiftgroups(spec, t, d, four_term, union),
                theta_cat, data_cat, dim=1,
            ),
            0.0,
            1.0,
        )
        row = {g: i for i, g in enumerate(union)}
        return tuple(
            torch.stack([out[row[g], off : off + b] for g in gs], dim=0)
            for (off, b), gs in zip(segments, group_sets)
        )

    run.run_banks = run_banks
    return declare(run, shiftbank=True, sharded=True)


class MeshSpillExecutor:
    """Whole-mesh escape hatch for mega-batches that fit no single worker.

    A coalesced batch too wide (qubit count above every worker's register
    capacity) or too deep (no block of the kernel it would get fits the
    card's per-block memory: rows of 15 or more qubits) is routed HERE
    instead of failing fast: row batches shard their lanes across the
    mesh's ``data`` axis, and their rows then run on the kernels' own route
    for their width (the device-memory route from 15 qubits); shift-group
    bank sets run the fused multi-bank kernel with lane segments sharded
    the same way.  Without a ``mesh`` it uses a one-device mesh on the
    device of the first batch's inputs.  Per-spec sharded executors are
    built lazily and cached."""

    def __init__(self, mesh: DeviceMesh | None = None, axis: str = "data"):
        self.mesh = mesh
        self.axis = axis
        self._per_spec: dict[CircuitSpec, Callable] = {}
        self._lock = threading.Lock()

    def _executor(self, spec: CircuitSpec, device: torch.device):
        with self._lock:
            if self.mesh is None:
                self.mesh = make_host_mesh(device)
            if spec not in self._per_spec:
                self._per_spec[spec] = sharded_executor(spec, self.mesh, self.axis)
            return self._per_spec[spec]

    def rows(self, spec: CircuitSpec, theta_bank, data_bank):
        """(C, P), (C, D) -> (C,) fidelities, lanes sharded over the mesh."""
        return self._executor(spec, theta_bank.device)(theta_bank, data_bank)

    def banks(self, spec: CircuitSpec, thetas, datas, four_term: bool, group_sets: tuple):
        """Fused multi-bank bank-set execution sharded over the mesh."""
        return self._executor(spec, thetas[0].device).run_banks(
            thetas, datas, four_term, group_sets
        )
