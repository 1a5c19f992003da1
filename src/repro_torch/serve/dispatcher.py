"""Dispatcher: coalesced mega-batches -> co-Manager placement -> CUDA kernels.

One ``CoalescedBatch`` becomes ONE logical circuit-bank task for Algorithm 2:
its resource demand is the spec's qubit width (the co-resident lanes of a
fused kernel batch occupy one ``n_qubits``-wide register file slot on the
worker, not ``n * width`` qubits), so the existing capacity/CRU assignment
logic routes whole batches exactly as it routed single circuits.

Cost model: every batch carries an analytic work estimate
(``batch_cost_units`` — gate applications x padded kernel lanes; for
shift-group subtasks the TRUE prefix-reuse cost, including the suffix depth
the backward pass must cover) which the ``Telemetry.service`` EWMA converts
into predicted seconds.  The prediction becomes the task's ``service_time``
AND is charged to the assigned worker's CRU while the batch is outstanding,
so Algorithm 2's lowest-CRU-first choice routes new batches toward the
worker with the least predicted backlog.

This module is the *synchronous real-execution* runtime: execution happens
inline on the chosen worker's mesh slice (here: the local device) and
capacity is released immediately after.  The non-blocking counterpart with
a pump loop and per-worker execution slots is
``repro_torch.serve.async_dispatcher.AsyncDispatcher``; the virtual-clock
counterpart lives in ``repro_torch.comanager.simulation``
(``gateway=True``).

What differs from the reference on the card:

* Lanes.  The serving layer counts in the reference's 128-lane tiles
  (``repro_torch.serve.coalescer.LANES``): coalescing targets, ``padded()``,
  cost units and lane fill match the reference's.  ``execute_batch``
  launches only a batch's real rows: nothing compiles per shape here, and
  each pad row would cost the kernel a warp.
* Memory model.  The reference models 16 MiB of VMEM a worker (one TPU
  core) and spills batches whose working set exceeds it.  The port's model
  is the card's per block: a batch is over it when the launch it would get
  has no block that fits 227 KB (``batch_over_block``) — row batches of 15
  or more qubits (``fused_geometry`` gives (0, 0)), shift batches whose
  plan has no route (``shift_plan_fits``).  Over-block row batches go to
  ``MeshSpillExecutor``, where the rows run on the kernels' device-memory
  route; shift plans with no route (registers of 13 or more qubits) are
  refused at admission (``shift_admission_error``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Sequence

import torch

from repro_torch.api.capabilities import declare
from repro_torch.comanager.faults import FaultToleranceConfig
from repro_torch.comanager.manager import CoManager
from repro_torch.comanager.tenancy import TaskIdAllocator
from repro_torch.comanager.worker import CircuitTask, WorkerConfig
from repro_torch.core.sim import CircuitSpec
from repro_torch.kernels import ops as kops
from repro_torch.kernels.vqc_statevector import (
    SMEM_BUDGET_BYTES,
    build_shift_plan,
    fused_geometry,
    shift_cost_info,
    shift_execution_info,
    shift_plan_fits,
)
from repro_torch.serve.coalescer import LANES, CoalescedBatch
from repro_torch.serve.fleet import FaultInjector, FleetHealth
from repro_torch.serve.gateway import Backpressure, Gateway
from repro_torch.serve.metrics import Telemetry

#: kernel runner signature: (spec, theta (C,P), data (C,D)) -> fidelities (C,)
KernelFn = Callable[[CircuitSpec, torch.Tensor, torch.Tensor], torch.Tensor]

#: shift-group runner: (spec, theta (B,P), data (B,D), four_term, groups)
#: -> per-group fidelities (len(groups), B)
ShiftKernelFn = Callable[
    [CircuitSpec, torch.Tensor, torch.Tensor, bool, tuple], torch.Tensor
]

#: fused multi-bank runner: (spec, thetas, datas, four_term, group_sets)
#: -> per-bank (len(group_sets[k]), B_k) fidelity blocks
MultiBankKernelFn = Callable[[CircuitSpec, tuple, tuple, bool, tuple], tuple]


@dataclasses.dataclass(frozen=True)
class ShiftGroupKey:
    """Coalescing key for implicit-bank (param, shift) group subtasks.

    Keyed by circuit STRUCTURE only: group subtasks of *different* banks —
    different tenants, different base angles, different sample counts — of
    the same ``CircuitSpec`` and shift rule share a key and coalesce into
    joint multi-bank prefix-reuse launches (base angles are per-lane data
    of the fused kernel, so they never had to keep banks apart)."""

    spec: CircuitSpec
    four_term: bool = False


# --------------------------------------------------------- shared execution
def batch_spec(batch: CoalescedBatch) -> CircuitSpec:
    key = batch.key
    if isinstance(key, CircuitSpec):
        return key
    if isinstance(key, ShiftGroupKey):
        return key.spec
    raise TypeError(
        f"dispatcher batches must be keyed by CircuitSpec or "
        f"ShiftGroupKey, got {type(key).__name__}"
    )


def batch_device(batch: CoalescedBatch) -> torch.device:
    """The device of a batch's payloads (its first member's)."""
    payload = batch.members[0].payload
    if isinstance(batch.key, ShiftGroupKey):
        return payload[0].theta.device
    return payload[0].device


def bank_partition(batch: CoalescedBatch):
    """Split a shift-group batch's members into per-bank subtask lists.

    Returns ``(banks, group_sets, slots)``: the distinct ``ShiftBank``s in
    first-appearance order, each bank's requested group tuple, and for every
    member its ``(bank_index, row_index)`` into the fused kernel's per-bank
    output blocks."""
    banks, group_sets, slots = [], [], []
    index: dict[int, int] = {}
    for m in batch.members:
        bank, g = m.payload
        k = index.get(id(bank))
        if k is None:
            k = index[id(bank)] = len(banks)
            banks.append(bank)
            group_sets.append([])
        slots.append((k, len(group_sets[k])))
        group_sets[k].append(int(g))
    return banks, [tuple(gs) for gs in group_sets], slots


def execute_batch(
    batch: CoalescedBatch,
    kernel: KernelFn,
    shift_kernel: ShiftKernelFn,
    multibank_kernel: MultiBankKernelFn | None = None,
) -> list:
    """Run one coalesced batch on the local device; returns one fidelity
    entry per member, in member (submission) order.  Shared by the sync and
    async dispatchers — batch composition never changes per-lane math, so
    both paths are bit-identical.

    A row batch launches exactly its ``batch.n`` rows.  The reference pads
    it to a multiple of 128 lanes, to bound the number of shapes XLA
    compiles, and on a TPU the pad rows cost nothing; here nothing compiles
    per shape and each pad row would cost the kernel a warp.  Shift-group
    bank sets go to the fused multi-bank launch unpadded (its own lane
    segments are aligned to the kernels' warp)."""
    if isinstance(batch.key, ShiftGroupKey):
        # ONE prefix-reuse kernel launch computes every coalesced
        # (param, shift) group of every bank in the batch; member i gets
        # its group's (B,) fidelity row of its bank's block.
        spec = batch.key.spec
        banks, group_sets, slots = bank_partition(batch)
        if len(banks) == 1:
            rows = shift_kernel(
                spec,
                banks[0].theta,
                banks[0].data,
                banks[0].four_term,
                group_sets[0],
            )
            return [rows[i] for _, i in slots]
        outs = (multibank_kernel or kops.vqc_fidelity_shiftgroups_multibank)(
            spec,
            tuple(b.theta for b in banks),
            tuple(b.data for b in banks),
            batch.key.four_term,
            tuple(group_sets),
        )
        return [outs[k][i] for k, i in slots]
    spec: CircuitSpec = batch.key
    theta = torch.stack([m.payload[0] for m in batch.members])
    data = torch.stack([m.payload[1] for m in batch.members])
    return list(kernel(spec, theta, data).unbind(0))


# ------------------------------------------------------- analytic cost model
def batch_family(batch: CoalescedBatch):
    """Service-model key: batches of one structural family share an EWMA."""
    if isinstance(batch.key, ShiftGroupKey):
        return ("shift", batch.key.spec)
    return batch.key


def batch_cost_units(batch: CoalescedBatch) -> float:
    """Analytic work units of one batch: gate applications x padded lanes.

    Row batches pay the full gate sequence over their padded lane tile.
    Shift-group batches pay the analytic cost of the path the ops layer
    will actually take (``kernels.shift_cost_info`` on the UNION group
    set): the fused prefix-reuse cost — data-register pass, forward pass,
    backward pass down to the shallowest anchor, and each variant's suffix
    replay (one gate for single-use parameters, the [first, last] span for
    multi-use ones) — over the sum of the banks' padded lane segments,
    since the fused launch computes the union groups for every lane; or,
    when no plan exists / replay is analytically dearer, the per-bank
    materialized fallback cost.
    """
    spec = batch_spec(batch)
    if not isinstance(batch.key, ShiftGroupKey):
        pad = batch.padded(LANES)
        return float(len(spec.ops) * pad)
    banks, group_sets, _ = bank_partition(batch)
    pad_b = sum(math.ceil(b.n_samples / LANES) * LANES for b in banks)
    union = tuple(sorted({g for gs in group_sets for g in gs}))
    cost = shift_cost_info(spec, batch.key.four_term, union)
    if not cost["use_implicit"]:
        # fallback materializes each bank's requested groups separately
        return float(
            len(spec.ops)
            * sum(
                len(gs) * math.ceil(b.n_samples / LANES) * LANES
                for b, gs in zip(banks, group_sets)
            )
        )
    return float(cost["gate_apps_implicit"] * pad_b)


# ------------------------------------------------- per-block memory model
def _union(group_sets) -> tuple:
    return tuple(sorted({g for gs in group_sets for g in gs}))


def batch_launch_info(batch: CoalescedBatch) -> dict:
    """The launch a batch would get on one worker, under the card's
    per-block memory model: ``mode`` ("rows", "fused", "spill",
    "materialize", or "none" where no block holds the plan), ``launches``
    and ``smem_bytes``, the shared memory one block asks for (the tile
    launch's for a spilled plan, with ``forward_smem_bytes`` beside it);
    ``smem_bytes`` is 0 where no block of the kernel fits 227 KB (rows of
    15 or more qubits: their launch takes the device-memory route)."""
    spec = batch_spec(batch)
    if not isinstance(batch.key, ShiftGroupKey):
        _, smem = fused_geometry(spec.n_qubits, batch.n)
        return {"mode": "rows", "launches": 1, "smem_bytes": smem}
    banks, group_sets, _ = bank_partition(batch)
    union = _union(group_sets)
    four = batch.key.four_term
    if not shift_plan_fits(spec, four, union):
        return {"mode": "none", "launches": 0, "smem_bytes": 0}
    lanes = sum(b.n_samples for b in banks)
    info = shift_execution_info(spec, lanes, four_term=four, groups=union)
    out = {"mode": info["mode"], "launches": info["launches"], "smem_bytes": info["smem_bytes"]}
    if info["mode"] == "spill":
        out["forward_smem_bytes"] = info["forward_smem_bytes"]
        out["n_tiles"] = info["n_tiles"]
    return out


def batch_over_block(batch: CoalescedBatch) -> bool:
    """The per-block model's verdict: no block of the launch this batch
    would get fits the card's 227 KB, so no single worker runs it — rows of
    15 or more qubits, shift plans with no route.  The dispatcher sends such
    batches to the mesh (``MeshSpillExecutor``)."""
    return batch_launch_info(batch)["smem_bytes"] == 0


def kernel_span_args(batch: CoalescedBatch) -> dict:
    """Trace-span payload for one batch's kernel launch: the execution
    shape under the per-block model (``batch_launch_info``), lanes and
    members.  Shift-group lanes are the banks' samples; row lanes the rows
    launched (``batch.n``).  The port has no boundary prefetch, so a
    spilled plan's span carries no ``overlap_ratio``: each tile's boundary
    is loaded when the tile starts.  Only computed when tracing is
    enabled."""
    args = batch_launch_info(batch)
    if isinstance(batch.key, ShiftGroupKey):
        banks, _, _ = bank_partition(batch)
        args.update(kind="shift", banks=len(banks), lanes=sum(b.n_samples for b in banks))
    else:
        args.update(kind="rows", lanes=batch.n)
    args["members"] = batch.n
    return args


def shift_admission_error(spec: CircuitSpec, four_term: bool = False) -> str | None:
    """Why an implicit bank of ``spec`` cannot be served, or None.  A shift
    plan whose register holds 13 or more qubits (27-qubit QuClassi and
    wider) has no route on the card: one checkpoint and the walk's three
    states of 2 * 4 * 2**13 bytes each exceed a block's 227 KB.  The
    reference cannot lower such plans on a TPU either (one m = 13 state at
    one lane tile is 8 MiB, and its planner reserves 4 more against a 14 MiB
    budget), and no configuration of the repository uses them."""
    if shift_plan_fits(spec, four_term):
        return None
    m = build_shift_plan(spec).m
    return (
        f"no block of the shift kernels holds one sample of this {m}-qubit register "
        f"plan within {SMEM_BUDGET_BYTES} bytes of shared memory; shift plans beyond "
        "m = 12 are not supported (the reference cannot lower them on a TPU either)"
    )


class Dispatcher:
    def __init__(
        self,
        gateway: Gateway,
        workers: Sequence[WorkerConfig],
        *,
        manager: CoManager | None = None,
        kernel: KernelFn | None = None,
        shift_kernel: ShiftKernelFn | None = None,
        multibank_kernel: MultiBankKernelFn | None = None,
        mesh_spill: bool = True,
        spill_executor=None,
        clock=time.perf_counter,
        fault_tolerance: FaultToleranceConfig | None = None,
        fault_injector: FaultInjector | None = None,
    ):
        self.gateway = gateway
        self.manager = manager or CoManager(multi_tenant=True)
        self.kernel = kernel or kops.vqc_fidelity
        self.shift_kernel = shift_kernel or kops.vqc_fidelity_shiftgroups
        self.multibank_kernel = (
            multibank_kernel or kops.vqc_fidelity_shiftgroups_multibank
        )
        #: route mega-batches that fit no single worker (register width or
        #: the per-block memory model) through the whole-mesh sharded
        #: executor instead of failing fast; disable to restore the strict
        #: fail-fast contract.
        self.mesh_spill = mesh_spill
        self._spill = spill_executor  # built lazily when None
        self.clock = clock
        self.task_ids = TaskIdAllocator()
        self.batch_log: list[tuple[str, int, tuple]] = []  # (worker, n, clients)
        self._base_cru: dict[str, float] = {}
        self._outstanding_s: dict[str, float] = {}  # predicted queued seconds
        self.ft = fault_tolerance or FaultToleranceConfig()
        self.fleet = FleetHealth(self.ft)
        self.fault_injector = fault_injector
        if fault_injector is not None:
            fault_injector.start(self.clock())
        self._max_width = max((w.max_qubits for w in workers), default=0)
        for w in workers:
            self._register(w)

    # ------------------------------------------------------ live membership
    def _register(self, w: WorkerConfig) -> None:
        self.manager.register_worker(
            w.worker_id,
            w.max_qubits,
            cru=w.base_load,
            t=self.clock(),
            error_rate=w.error_rate,
        )
        self._base_cru[w.worker_id] = w.base_load
        self._outstanding_s[w.worker_id] = 0.0
        self.fleet.add(w.worker_id)

    def _recompute_max_width(self) -> None:
        self._max_width = max(
            (v.max_qubits for v in self.manager.workers.values()), default=0
        )

    def register_worker(self, worker: WorkerConfig) -> None:
        """Add a worker to the fleet at runtime; it becomes placeable on
        the next batch."""
        if worker.worker_id in self._base_cru:
            raise ValueError(f"worker {worker.worker_id!r} already registered")
        self._register(worker)
        self._max_width = max(self._max_width, worker.max_qubits)

    def drain_worker(self, worker_id: str, timeout: float = 30.0) -> None:
        """Remove a worker from the fleet: stop placing on it, let in-flight
        work land, then forget it.  The sync dispatcher has no cross-call
        in-flight work, so removal is immediate."""
        if worker_id not in self._base_cru:
            raise KeyError(f"unknown worker {worker_id!r}")
        self.fleet.mark_draining(worker_id)
        self._forget_worker(worker_id)

    def _forget_worker(self, worker_id: str) -> None:
        self.manager.workers.pop(worker_id, None)
        self._base_cru.pop(worker_id, None)
        self._outstanding_s.pop(worker_id, None)
        self.fleet.remove(worker_id)
        self._recompute_max_width()

    # ------------------------------------------------------ CRU cost model
    def _estimate_s(self, batch: CoalescedBatch) -> float:
        return self.gateway.telemetry.service.estimate(
            batch_family(batch), batch_cost_units(batch)
        )

    def _charge(self, wid: str, seconds: float) -> None:
        """Add/remove predicted outstanding work from a worker's CRU: the
        EWMA service estimate is the co-Manager's view of classical load."""
        self._outstanding_s[wid] = max(
            0.0, self._outstanding_s.get(wid, 0.0) + seconds
        )
        view = self.manager.workers.get(wid)
        if view is not None:
            view.cru = self._base_cru.get(wid, 0.0) + self._outstanding_s[wid]

    def _observe(self, batch: CoalescedBatch, seconds: float) -> None:
        self.gateway.telemetry.service.update(
            batch_family(batch), batch_cost_units(batch), seconds
        )

    # ----------------------------------------------------------- execution
    @staticmethod
    def _width(batch: CoalescedBatch) -> int:
        return batch_spec(batch).n_qubits

    def _oversized(self, batch: CoalescedBatch) -> bool:
        """No single worker can run this batch: register width above every
        worker's capacity, or no block of its launch fits the card's 227 KB
        (``batch_over_block``).
        Memoized on the batch — composition is immutable after coalescing,
        and the async ready-queue scan re-asks on every placement pass
        (often under its condition lock)."""
        verdict = getattr(batch, "_oversized_verdict", None)
        if verdict is None:
            verdict = (
                self._width(batch) > self._max_width
                or batch_over_block(batch)
            )
            batch._oversized_verdict = verdict
        return verdict

    def _spill_executor(self):
        if self._spill is None:
            from repro_torch.comanager.dataplane import MeshSpillExecutor

            self._spill = MeshSpillExecutor()
        return self._spill

    def _spill_fns(self):
        """(kernel, shift_kernel, multibank_kernel) triple backed by the
        whole-mesh spill executor, so ``execute_batch`` runs unchanged."""
        ex = self._spill_executor()
        return (
            lambda spec, t, d: ex.rows(spec, t, d),
            lambda spec, t, d, ft, gs: ex.banks(
                spec, (t,), (d,), ft, (tuple(gs),)
            )[0],
            lambda spec, ts, ds, ft, gss: ex.banks(spec, ts, ds, ft, gss),
        )

    def _record(self, batch: CoalescedBatch) -> None:
        """Per-launch telemetry shared by the sync and async paths."""
        if isinstance(batch.key, ShiftGroupKey):
            banks, _, _ = bank_partition(batch)
            self.gateway.telemetry.on_fused_launch(len(banks))

    def run_spilled(self, batch: CoalescedBatch) -> str:
        """Execute one oversized batch on the whole device mesh (no single
        worker is charged — the spill path is its own resource)."""
        tr = self.gateway.telemetry.trace
        t0 = self.clock()
        if tr.enabled:
            seqs = [m.seq for m in batch.members]
            tr.batch_stage(seqs, "placed", t0, worker="mesh")
            tr.batch_stage(seqs, "dispatched", t0)
            tr.batch_stage(seqs, "kernel_start", t0)
        fids = execute_batch(batch, *self._spill_fns())
        t1 = self.clock()
        if tr.enabled:
            tr.worker_span(
                "mesh", t0, t1, kind="spill", args=kernel_span_args(batch)
            )
        self.gateway.telemetry.service.update(
            ("spill", batch_family(batch)),
            batch_cost_units(batch),
            t1 - t0,
        )
        self.gateway.telemetry.on_spill(batch.lane_count)
        self._record(batch)
        self.gateway.complete(batch, fids, self.clock())
        self.batch_log.append(("mesh", batch.n, tuple(sorted(batch.clients()))))
        return "mesh"

    def run_batch(self, batch: CoalescedBatch) -> str:
        """Place one batch via Algorithm 2 and execute it on the spot,
        retrying in place on failure and then migrating the batch to a
        surviving worker through the gateway's re-coalescing requeue."""
        now = self.clock()
        if self.mesh_spill and self._oversized(batch):
            return self.run_spilled(batch)
        est = self._estimate_s(batch)
        task = CircuitTask(
            task_id=next(self.task_ids),
            client_id="gateway",
            demand=self._width(batch),
            service_time=est,
        )
        wid = self.manager.assign(task, now, exclude=self.fleet.unplaceable(now))
        if wid is None:
            if self.mesh_spill:
                return self.run_spilled(batch)
            caps = [v.max_qubits for v in self.manager.workers.values()]
            raise RuntimeError(
                f"no worker fits a {task.demand}-qubit batch (capacities: {caps})"
            )
        self._charge(wid, est)
        self.fleet.on_dispatch(wid)
        tel = self.gateway.telemetry
        tr = tel.trace
        seqs = [m.seq for m in batch.members]
        t0 = self.clock()
        if tr.enabled:
            tr.batch_stage(seqs, "placed", t0, worker=wid)
            tr.batch_stage(seqs, "dispatched", t0)
            tr.batch_stage(seqs, "kernel_start", t0)
        attempts = 0
        while True:
            t0 = self.clock()
            try:
                if self.fault_injector is not None:
                    self.fault_injector.check(wid, t0)
                fids = execute_batch(
                    batch, self.kernel, self.shift_kernel, self.multibank_kernel
                )
                break
            except Exception as exc:
                err = exc
            now = self.clock()
            tripped = self.fleet.on_failure(wid, now)
            tel.on_worker_failure(wid)
            if tripped:
                tel.on_worker_offline(wid)
                if tr.enabled:
                    tr.batch_stage(seqs, "worker_offline", now, worker=wid)
            attempts += 1
            if attempts <= self.ft.retry_limit and self.fleet.retryable(wid, now):
                self.fleet.record_retry(wid)
                tel.on_worker_retry(wid)
                if tr.enabled:
                    tr.batch_stage(seqs, "retried", now, worker=wid)
                if self.ft.retry_backoff_s:
                    time.sleep(self.ft.retry_backoff_s * 2 ** (attempts - 1))
                continue
            # out of retries: release the failed worker's capacity, then
            # migrate through the coalescer if any surviving worker fits
            self._charge(wid, -est)
            self.manager.complete(wid, task, now)
            self.fleet.on_release(wid)
            bad = self.fleet.unplaceable(now)
            survivors = [
                w
                for w, v in self.manager.workers.items()
                if w != wid and w not in bad and v.max_qubits >= task.demand
            ]
            if survivors:
                self.fleet.record_migration(wid)
                tel.on_worker_migration(wid)
                if tr.enabled:
                    tr.batch_stage(seqs, "migrated", now, worker=wid)
                self.gateway.requeue(batch, now)
                return wid
            self.gateway.fail(batch, err, now)
            raise err
        t1 = self.clock()
        if tr.enabled:
            tr.worker_span(wid, t0, t1, args=kernel_span_args(batch))
        self._observe(batch, t1 - t0)
        self._record(batch)
        self._charge(wid, -est)
        self.manager.complete(wid, task, self.clock())
        self.fleet.on_success(wid)
        self.fleet.on_release(wid)
        self.gateway.complete(batch, fids, self.clock())
        self.batch_log.append((wid, batch.n, tuple(sorted(batch.clients()))))
        return wid

    # ---------------------------------------------------------------- pump
    def pump(self) -> int:
        """Coalesce what's admitted; run every emitted batch.  Returns the
        number of batches executed."""
        batches = self.gateway.pump(self.clock())
        for b in batches:
            self.run_batch(b)
        return len(batches)

    def drain(self) -> int:
        """Force-flush partial buffers and run everything (end of a bank).
        Loops until the gateway is empty so batches migrated back through
        the coalescer after a worker failure are re-emitted and re-placed."""
        n = 0
        while True:
            batches = self.gateway.flush(self.clock())
            if not batches:
                return n
            for b in batches:
                self.run_batch(b)
            n += len(batches)

    # lifecycle no-ops so sync/async runtimes share a shutdown path
    def start(self) -> None:
        pass

    def kick(self) -> None:
        pass

    def close(self) -> None:
        pass

    def absorb_backpressure(self) -> None:
        """A tenant queue is full: inline execution is the only way the sync
        dispatcher frees it (the async override waits for a completion
        instead of quiescing everything)."""
        self.drain()


class GatewayRuntime:
    """Bundled gateway + dispatcher + telemetry for local serving.

    The unit the trainer and the benchmarks hold on to: multiple training
    clients share one runtime, and their circuit banks coalesce across
    tenants into shared kernel launches.

    ``mode``: "sync" executes each mega-batch inline on the submitting
    thread; "async" starts an ``AsyncDispatcher`` — a pump thread plus a
    per-worker execution pool (``slots_per_worker`` in-flight mega-batches
    per worker), so kernel execution overlaps with admission, coalescing,
    and placement, and futures resolve out of order.
    """

    def __init__(
        self,
        workers: Sequence[WorkerConfig] | None = None,
        *,
        target: int | None = None,
        deadline: float = 1.0,
        kernel: KernelFn | None = None,
        shift_kernel: ShiftKernelFn | None = None,
        multibank_kernel: MultiBankKernelFn | None = None,
        mesh_spill: bool = True,
        spill_executor=None,
        evict_over_slo: bool = False,
        clock=time.perf_counter,
        mode: str = "sync",
        slots_per_worker: int = 1,
        observability=None,
        fault_tolerance: FaultToleranceConfig | None = None,
        fault_injector: FaultInjector | None = None,
        **gateway_opts,
    ):
        if mode not in ("sync", "async"):
            raise ValueError(f"unknown mode {mode!r}")
        if workers is None:
            workers = [
                WorkerConfig(f"w{i + 1}", q) for i, q in enumerate((5, 10, 15, 20))
            ]
        self.mode = mode
        self.telemetry = Telemetry(observability=observability)
        self.gateway = Gateway(
            target=target,
            deadline=deadline,
            telemetry=self.telemetry,
            **gateway_opts,
        )
        common = dict(
            kernel=kernel,
            shift_kernel=shift_kernel,
            multibank_kernel=multibank_kernel,
            mesh_spill=mesh_spill,
            spill_executor=spill_executor,
            clock=clock,
            fault_tolerance=fault_tolerance,
            fault_injector=fault_injector,
        )
        if mode == "async":
            from repro_torch.serve.async_dispatcher import AsyncDispatcher

            self.dispatcher = AsyncDispatcher(
                self.gateway,
                workers,
                slots_per_worker=slots_per_worker,
                evict_over_slo=evict_over_slo,
                **common,
            )
        else:
            if evict_over_slo:
                raise ValueError(
                    "evict_over_slo requires mode='async' "
                    "(the sync dispatcher has no ready queue)"
                )
            self.dispatcher = Dispatcher(self.gateway, workers, **common)
        # kernel profiling hook: shift-plan launches report their execution
        # shape (fused/spill/materialize) to this runtime's recorder for as
        # long as the runtime is open; restored on close so runtimes nest.
        self._prev_observer = None
        self._observer_installed = False
        if self.telemetry.trace.enabled:
            self._prev_observer = kops.set_launch_observer(
                self.telemetry.trace.on_kernel_launch
            )
            self._observer_installed = True
        self.dispatcher.start()

    def close(self) -> None:
        """Stop the pump thread and worker pool (async mode; sync no-op)."""
        if self._observer_installed:
            kops.set_launch_observer(self._prev_observer)
            self._observer_installed = False
        self.dispatcher.close()

    def __enter__(self) -> "GatewayRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def executor(
        self,
        spec: CircuitSpec,
        client_id: str,
        *,
        weight: float = 1.0,
        priority: int = 1,
        slo_ms: float | None = None,
    ):
        """A ``shift_rule.Executor`` that routes a circuit bank through the
        gateway row by row and gathers fidelities in submission order —
        ``shift_rule.assemble_gradient`` consumes the result unchanged.

        In async mode submission overlaps with execution: rows stream into
        the pump loop as they are admitted, and the final gather blocks on
        the out-of-order futures."""
        if client_id not in self.gateway.tenants:
            self.gateway.register_client(
                client_id, weight=weight, priority=priority, slo_ms=slo_ms
            )

        def run(theta_bank: torch.Tensor, data_bank: torch.Tensor) -> torch.Tensor:
            origin = submit_origin(theta_bank.device)
            rows = list(zip(theta_bank.unbind(0), data_bank.unbind(0)))
            futures = [self._submit(client_id, spec, row, 1, origin) for row in rows]
            self.dispatcher.drain()
            return torch.stack([f.value for f in futures])

        return run

    def _submit(self, client_id, key, payload, lanes: int, origin):
        """Admit one item, absorbing backpressure (sync: drain in-flight
        work; async: wait for a completion to free queue space without
        quiescing), then wake the pump."""
        while True:
            try:
                fut = self.gateway.submit(
                    client_id, key, payload, now=self.dispatcher.clock(),
                    lanes=lanes, origin=origin,
                )
                break
            except Backpressure:
                self.dispatcher.absorb_backpressure()
        self.dispatcher.kick()
        return fut

    def shift_executor(
        self,
        spec: CircuitSpec,
        client_id: str,
        *,
        weight: float = 1.0,
        priority: int = 1,
        slo_ms: float | None = None,
    ):
        """A shift-aware ``shift_rule.Executor``: an implicit ``ShiftBank``
        enters the gateway as per-(param, shift) GROUP subtasks — 1 + 2P
        admissions instead of (1 + 2P) * B — which the coalescer packs into
        joint prefix-reuse kernel launches and the co-Manager places as
        whole-batch tasks.  Batches are keyed by circuit STRUCTURE
        (``ShiftGroupKey``), so concurrent tenants training the same spec
        fuse their banks' subtasks into shared multi-bank launches.  Group
        fidelities come back in bank order, so
        ``shift_rule.assemble_gradient`` consumes them unchanged.  A bank
        whose shift plan has no route on the card is refused here, before
        any of it is admitted (``shift_admission_error``).

        Plain ``(theta_bank, data_bank)`` calls are also accepted and fall
        back to per-row submission, so the executor composes with every bank
        mode."""
        row_run = self.executor(
            spec, client_id, weight=weight, priority=priority, slo_ms=slo_ms
        )

        def run(bank, data_bank=None) -> torch.Tensor:
            if data_bank is not None:
                return row_run(bank, data_bank)
            reason = shift_admission_error(spec, bank.four_term)
            if reason is not None:
                raise NotImplementedError(reason)
            key = ShiftGroupKey(spec, bank.four_term)
            origin = submit_origin(bank.theta.device)
            futures = [
                self._submit(client_id, key, (bank, g), bank.n_samples, origin)
                for g in range(bank.n_groups)
            ]
            self.dispatcher.drain()
            return torch.cat([f.value for f in futures])

        return declare(run, shiftbank=True)


def submit_origin(device: torch.device):
    """(ready event, stream) of the submitting thread on a CUDA device, or
    None on the CPU: the event is recorded on the submitter's current stream
    after the payload was made, so an async slot's stream can wait on it
    (``PendingCircuit.origin``)."""
    if device.type != "cuda":
        return None
    stream = torch.cuda.current_stream(device)
    ready = torch.cuda.Event()
    ready.record(stream)
    return ready, stream
