"""The unified ``ExecutionBackend`` protocol + adapters for every executor
family.

DQuLearn grew five duck-typed executor factories (``worker_batched_executor``,
``worker_pool_executor``, ``worker_multibank_executor``, ``sharded_executor``,
``MeshSpillExecutor``), each advertising what it can consume through ad-hoc
attributes.  The protocol here replaces that with one contract:

    capabilities() -> Capabilities     what the backend consumes natively
    run_rows(theta, data) -> fids      materialized (C, P)/(C, D) row batches
    run_bank(bank) -> fids             one bank (implicit or materialized)
    run_bank_set(banks) -> [fids, ...] same-spec bank sets (fused when able)
    cost_model() -> CostModel          analytic work / shared-memory estimates

Every adapter is ALSO a legacy ``shift_rule.Executor`` callable (``__call__``
dispatches on the argument shape), so the protocol objects drop into every
existing dispatch site — ``shift_rule.run_bank``, ``grad_shift(executor=)``,
``train(executor=)`` — unchanged, and ``capabilities_of`` reads their
declaration without the deprecated attribute probes.
"""

from __future__ import annotations

import math
from typing import Protocol, Sequence, runtime_checkable

from repro_torch.api.capabilities import Capabilities, capabilities_of
from repro_torch.core import shift_rule
from repro_torch.core.sim import CircuitSpec
from repro_torch.kernels.vqc_statevector import (
    fused_geometry,
    shift_cost_info,
    shift_execution_info,
    shift_plan_fits,
)
from repro_torch.serve.coalescer import LANES


@runtime_checkable
class ExecutionBackend(Protocol):
    """The one contract every executor family implements (via the adapters
    below) and every dispatch layer consumes."""

    def capabilities(self) -> Capabilities: ...

    def run_rows(self, theta_bank, data_bank): ...

    def run_bank(self, bank): ...

    def run_bank_set(self, banks) -> list: ...

    def cost_model(self) -> "CostModel": ...


# ------------------------------------------------------- analytic cost model
class CostModel:
    """Analytic per-bank cost estimates, comparable across backends.

    ``bank_cost_units``: gate applications x padded lanes — the same unit
    ``serve.dispatcher.batch_cost_units`` charges to worker CRU, so a
    backend's estimate slots straight into the serving EWMA.  Shift-capable
    backends pay the analytic prefix-reuse cost from
    ``kernels.shift_cost_info`` (data pass + forward pass + deepest suffix
    + each variant's replay span — one gate for single-use parameters, the
    [first, last] dependent span for multi-use ones); everything else pays
    the full gate sequence per materialized row.  Multi-use-param banks are
    therefore no longer mis-charged the full materialized cost.

    Lanes are the serving layer's 128 (the reference's kernel tile), not
    the kernels' warp of 32, so the units are the reference's for every
    bank.

    ``bank_smem_bytes``: the shared memory one block of the bank's launch
    asks for on the card, for the samples (rows) of one shard — the
    counterpart of the reference's per-device VMEM working set, under the
    card's per-block memory model (``serve.batch_over_block``).
    """

    def __init__(self, *, shiftbank: bool, n_shards: int = 1):
        self.shiftbank = shiftbank
        self.n_shards = max(1, n_shards)

    @staticmethod
    def _lanes(n: int) -> int:
        return math.ceil(n / LANES) * LANES

    def _materialized_units(self, spec: CircuitSpec, n_circuits: int) -> float:
        return float(len(spec.ops) * self._lanes(n_circuits))

    def bank_cost_units(self, spec: CircuitSpec, bank) -> float:
        if not isinstance(bank, shift_rule.ShiftBank) or not self.shiftbank:
            n = bank.n_circuits
            return self._materialized_units(spec, n) / self.n_shards
        cost = shift_cost_info(spec, bank.four_term)
        if not cost["use_implicit"]:  # no structure / replay dearer: materialize
            return self._materialized_units(spec, bank.n_circuits) / self.n_shards
        gate_apps = cost["gate_apps_implicit"]
        return float(gate_apps * self._lanes(bank.n_samples)) / self.n_shards

    def bank_smem_bytes(self, spec: CircuitSpec, bank) -> int:
        """Shared memory of one block of the launch that runs one shard of
        ``bank``: ``shift_execution_info(...)["smem_bytes"]`` for a shift
        bank (the tile launch's where the plan spills), the block of
        ``fused_geometry`` for rows.  0 where no block holds the work: rows
        of 15 or more qubits, which take the kernels' device-memory route
        (the state lives in device memory, the block stages nothing), and
        shift plans beyond m = 12, which the serving layer refuses at
        admission."""
        if isinstance(bank, shift_rule.ShiftBank) and self.shiftbank:
            if not shift_plan_fits(spec, bank.four_term):
                return 0
            n = math.ceil(bank.n_samples / self.n_shards)
            info = shift_execution_info(spec, n, four_term=bank.four_term)
            return info["smem_bytes"]
        n = math.ceil(bank.n_circuits / self.n_shards)
        return fused_geometry(spec.n_qubits, n)[1]


# ------------------------------------------------------------- adapter base
class _BackendBase:
    """Shared ``ExecutionBackend`` plumbing.

    Subclasses provide ``_rows_executor(n_rows)`` and (when shift-capable)
    ``_bank_executor(bank)`` returning legacy callables; the base supplies
    the protocol surface, the bank-set fallback loop, and the legacy
    ``__call__`` compatibility so adapters remain drop-in
    ``shift_rule.Executor``s.
    """

    _caps = Capabilities()
    _n_shards = 1

    def __init__(self, spec: CircuitSpec):
        self.spec = spec

    # -- protocol surface
    def capabilities(self) -> Capabilities:
        return self._caps

    def cost_model(self) -> CostModel:
        return CostModel(shiftbank=self._caps.shiftbank, n_shards=self._n_shards)

    def run_rows(self, theta_bank, data_bank):
        return self._rows_executor(theta_bank.shape[0])(theta_bank, data_bank)

    def run_bank(self, bank):
        if isinstance(bank, shift_rule.ShiftBank) and self._caps.shiftbank:
            return self._bank_executor(bank)(bank)
        if isinstance(bank, shift_rule.ShiftBank):
            bank = bank.materialize()
        return self.run_rows(bank.theta, bank.data)

    def run_bank_set(self, banks) -> list:
        return [self.run_bank(b) for b in banks]

    def close(self) -> None:
        pass

    # -- legacy Executor compatibility: adapters drop into every existing
    #    dispatch site (run_bank / run_bank_set / grad_shift / train).
    def __call__(self, x, data_bank=None):
        if data_bank is not None:
            return self.run_rows(x, data_bank)
        if isinstance(x, shift_rule.ShiftBank):
            return self.run_bank(x)
        if isinstance(x, shift_rule.CircuitBank):
            return self.run_rows(x.theta, x.data)
        if isinstance(x, (list, tuple)):
            return self.run_bank_set(x)
        raise TypeError(
            f"cannot execute {type(x).__name__}: expected a bank, a bank "
            f"sequence, or (theta_bank, data_bank)"
        )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _WorkerBackendBase(_BackendBase):
    """Per-worker scheduling backends (batched / pooled).

    ``assignment`` pins a fixed unit->worker map (rows of a materialized
    bank, (param, shift) groups of an implicit one); when omitted, each
    call derives a round-robin assignment for its own unit count, so one
    backend serves banks of any size.  Underlying executors are cached per
    (unit count, assignment) — they bind the grouping permutation at
    construction.
    """

    def __init__(
        self,
        spec: CircuitSpec,
        n_workers: int = 4,
        assignment: Sequence[int] | None = None,
    ):
        super().__init__(spec)
        self.n_workers = n_workers
        self.assignment = None if assignment is None else tuple(assignment)
        self._executors: dict[tuple, object] = {}

    def _make(self, assignment):
        raise NotImplementedError

    def _executor_for(self, n_units: int):
        from repro_torch.comanager.dataplane import round_robin_assignment

        a = self.assignment or tuple(round_robin_assignment(n_units, self.n_workers))
        key = (n_units, a)
        if key not in self._executors:
            self._executors[key] = self._make(a)
        return self._executors[key]

    def _rows_executor(self, n_rows: int):
        if self.assignment is not None and len(self.assignment) != n_rows:
            # the underlying executor validates bank-shaped inputs itself,
            # but the row path would silently run only the assigned rows.
            raise ValueError(
                f"pinned assignment covers {len(self.assignment)} rows, "
                f"got a {n_rows}-row bank"
            )
        return self._executor_for(n_rows)

    def _bank_executor(self, bank):
        return self._executor_for(bank.n_groups)


class BatchedWorkerBackend(_WorkerBackendBase):
    """Adapter over ``dataplane.worker_batched_executor``: sequential
    per-worker fused-kernel groups, shift-aware via per-group scheduling."""

    _caps = Capabilities(shiftbank=True, vmem_model=True)

    def _make(self, assignment):
        from repro_torch.comanager.dataplane import worker_batched_executor

        return worker_batched_executor(self.spec, assignment, self.n_workers)


class PooledWorkerBackend(_WorkerBackendBase):
    """Adapter over ``dataplane.worker_pool_executor``: per-worker groups
    overlap on a thread pool; results stay bit-identical to the sequential
    path.  ``close()`` shuts every cached executor's pool down."""

    _caps = Capabilities(shiftbank=True, vmem_model=True)

    def __init__(
        self,
        spec: CircuitSpec,
        n_workers: int = 4,
        assignment: Sequence[int] | None = None,
        max_threads: int | None = None,
    ):
        super().__init__(spec, n_workers, assignment)
        self.max_threads = max_threads

    def _make(self, assignment):
        from repro_torch.comanager.dataplane import worker_pool_executor

        return worker_pool_executor(
            self.spec, assignment, self.n_workers, max_threads=self.max_threads
        )

    def close(self) -> None:
        for run in self._executors.values():
            run.close()
        self._executors.clear()


class MultibankWorkerBackend(_WorkerBackendBase):
    """Adapter over ``dataplane.worker_multibank_executor``: the schedulable
    unit is the (bank, group) subtask of a same-spec bank SET, and each
    worker executes all its subtasks as one fused multi-bank launch."""

    _caps = Capabilities(shiftbank=True, multibank=True, vmem_model=True)

    def _make(self, assignment):
        from repro_torch.comanager.dataplane import worker_multibank_executor

        return worker_multibank_executor(self.spec, assignment, self.n_workers)

    def run_bank_set(self, banks) -> list:
        banks = list(banks)
        if not all(isinstance(b, shift_rule.ShiftBank) for b in banks):
            # materialized banks have no (bank, group) structure to fuse
            return [self.run_bank(b) for b in banks]
        n_subtasks = sum(b.n_groups for b in banks)
        return list(self._executor_for(n_subtasks)(banks))

    def run_bank(self, bank):
        if isinstance(bank, shift_rule.ShiftBank):
            return self.run_bank_set([bank])[0]
        return super().run_bank(bank)

    def _rows_executor(self, n_rows: int):
        # row batches have no (bank, group) structure: route them through
        # the per-worker batched path with the same worker count.
        from repro_torch.comanager.dataplane import (
            round_robin_assignment,
            worker_batched_executor,
        )

        if self.assignment is not None and len(self.assignment) != n_rows:
            raise ValueError(
                f"pinned assignment covers {len(self.assignment)} rows, "
                f"got a {n_rows}-row bank"
            )
        key = ("rows", n_rows)
        if key not in self._executors:
            self._executors[key] = worker_batched_executor(
                self.spec,
                self.assignment
                or round_robin_assignment(n_rows, self.n_workers),
                self.n_workers,
            )
        return self._executors[key]


class ShardedBackend(_BackendBase):
    """Adapter over ``dataplane.sharded_executor``: whole banks shard over
    the devices of one mesh axis; bank sets fuse through ``run_banks`` with
    lane segments sharded the same way.  Without a ``mesh`` it shards over
    every local device of ``device``'s kind (``make_data_mesh``)."""

    _caps = Capabilities(shiftbank=True, multibank=True, sharded=True, vmem_model=True)

    def __init__(self, spec: CircuitSpec, mesh=None, axis: str = "data", device: str = "cuda"):
        super().__init__(spec)
        if mesh is None:
            from repro_torch.launch.mesh import make_data_mesh

            mesh = make_data_mesh(device=device)
        self.mesh = mesh
        self.axis = axis
        self._n_shards = mesh.shape[axis]
        from repro_torch.comanager.dataplane import sharded_executor

        self._run = sharded_executor(spec, mesh, axis)

    def _rows_executor(self, n_rows: int):
        return self._run

    def _bank_executor(self, bank):
        return self._run

    def run_bank_set(self, banks) -> list:
        banks = list(banks)
        if not all(isinstance(b, shift_rule.ShiftBank) for b in banks):
            return [self.run_bank(b) for b in banks]
        if len({b.four_term for b in banks}) > 1:
            raise ValueError("banks in one fused set must share four_term")
        group_sets = tuple(tuple(range(b.n_groups)) for b in banks)
        outs = self._run.run_banks(
            tuple(b.theta for b in banks),
            tuple(b.data for b in banks),
            banks[0].four_term,
            group_sets,
        )
        return [o.reshape(-1) for o in outs]


class MeshSpillBackend(_BackendBase):
    """Adapter over ``dataplane.MeshSpillExecutor``: the whole-mesh escape
    hatch for mega-batches that fit no single worker.  Per-spec sharded
    executors build lazily inside the spill executor, so one backend serves
    every circuit spec."""

    _caps = Capabilities(
        shiftbank=True,
        multibank=True,
        sharded=True,
        vmem_model=True,
        mesh_spill=True,
    )

    def __init__(self, spec: CircuitSpec, mesh=None, axis: str = "data", device: str = "cuda"):
        super().__init__(spec)
        from repro_torch.comanager.dataplane import MeshSpillExecutor

        if mesh is None:
            # match ShardedBackend: spill onto ALL local devices by default
            # (MeshSpillExecutor's own fallback is a one-device mesh).
            from repro_torch.launch.mesh import make_data_mesh

            mesh = make_data_mesh(device=device)
        self.executor = MeshSpillExecutor(mesh, axis)
        self._n_shards = self.executor.mesh.shape[axis]

    def run_rows(self, theta_bank, data_bank):
        return self.executor.rows(self.spec, theta_bank, data_bank)

    def run_bank(self, bank):
        if not isinstance(bank, shift_rule.ShiftBank):
            return self.run_rows(bank.theta, bank.data)
        groups = tuple(range(bank.n_groups))
        out = self.executor.banks(
            self.spec, (bank.theta,), (bank.data,), bank.four_term, (groups,)
        )
        return out[0].reshape(-1)

    def run_bank_set(self, banks) -> list:
        banks = list(banks)
        if not all(isinstance(b, shift_rule.ShiftBank) for b in banks):
            return [self.run_bank(b) for b in banks]
        if len({b.four_term for b in banks}) > 1:
            raise ValueError("banks in one fused set must share four_term")
        outs = self.executor.banks(
            self.spec,
            tuple(b.theta for b in banks),
            tuple(b.data for b in banks),
            banks[0].four_term,
            tuple(tuple(range(b.n_groups)) for b in banks),
        )
        return [o.reshape(-1) for o in outs]


# ----------------------------------------------------------- legacy bridge
class CallableBackend(_BackendBase):
    """Wrap a legacy ``shift_rule.Executor`` callable as an
    ``ExecutionBackend``.  Capabilities come from ``capabilities_of`` — i.e.
    a declaration when the callable has one, else the deprecation shim's
    reading of the old duck-typed attributes."""

    def __init__(self, spec: CircuitSpec, run):
        super().__init__(spec)
        self._run = run
        self._caps = capabilities_of(run)

    def run_rows(self, theta_bank, data_bank):
        return self._run(theta_bank, data_bank)

    def run_bank(self, bank):
        return shift_rule.run_bank(self._run, bank)

    def run_bank_set(self, banks) -> list:
        return shift_rule.run_bank_set(self._run, banks)

    def close(self) -> None:
        close = getattr(self._run, "close", None)
        if close is not None:
            close()


def as_backend(executor, spec: CircuitSpec | None = None) -> ExecutionBackend:
    """Coerce anything executor-shaped to an ``ExecutionBackend``.

    Protocol objects pass through; legacy callables (declared or
    duck-typed) wrap in ``CallableBackend`` — ``spec`` is required for
    those, since the cost model and row padding are per-structure."""
    if isinstance(executor, ExecutionBackend):
        return executor
    if spec is None:
        raise TypeError(
            "wrapping a legacy executor callable requires the CircuitSpec "
            "it executes (as_backend(run, spec))"
        )
    return CallableBackend(spec, executor)


#: the five executor families, by name — the facade's backend factory.
BACKEND_KINDS = {
    "batched": BatchedWorkerBackend,
    "pooled": PooledWorkerBackend,
    "multibank": MultibankWorkerBackend,
    "sharded": ShardedBackend,
    "mesh_spill": MeshSpillBackend,
}


def make_backend(kind: str, spec: CircuitSpec, **kw) -> ExecutionBackend:
    """Build one of the five adapter families by name."""
    try:
        cls = BACKEND_KINDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown backend kind {kind!r}; choose from "
            f"{sorted(BACKEND_KINDS)}"
        ) from None
    return cls(spec, **kw)


__all__ = [
    "BACKEND_KINDS",
    "BatchedWorkerBackend",
    "CallableBackend",
    "CostModel",
    "ExecutionBackend",
    "MeshSpillBackend",
    "MultibankWorkerBackend",
    "PooledWorkerBackend",
    "ShardedBackend",
    "as_backend",
    "make_backend",
]
