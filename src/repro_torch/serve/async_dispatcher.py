"""Async serving runtime: non-blocking dispatch with per-worker slots.

The synchronous ``Dispatcher`` executes every coalesced mega-batch inline on
the submitting thread, so one slow kernel launch head-of-line-blocks every
tenant — exactly the uncontrolled behavior the paper's co-Manager exists to
avoid.  ``AsyncDispatcher`` decouples the stages:

  * a PUMP THREAD moves admitted circuits through the weighted-fair
    scheduler and the coalescer, places emitted batches via Algorithm 2,
    and re-arms itself on the coalescer's next SLO/deadline flush;
  * a WORKER POOL executes placed batches — each registered worker owns
    ``slots_per_worker`` execution slots, one in-flight mega-batch each, so
    distinct workers (and slots) overlap kernel execution with admission,
    coalescing, and placement;
  * ``CircuitFuture``s resolve OUT OF ORDER as their batches finish; a
    batch that cannot currently be placed waits in a ready queue without
    blocking later batches that fit another worker.

Placement charges each batch's EWMA-predicted service seconds to the chosen
worker's CRU for the time it is outstanding (see ``repro_torch.serve.dispatcher``),
so Algorithm 2 keeps steering work toward the least-loaded worker even
though completions now arrive asynchronously.

Locking: the gateway has its own re-entrant lock; this class guards its
scheduler state (ready queue, slot counts, co-Manager views) with one
condition variable.  The two are never held nested in the
gateway-then-condition order, so there is no lock-ordering cycle.

On the card every slot thread runs its batch on its own CUDA stream
(``_on_slot_stream``), so batches of distinct slots overlap on the device.
The slot's stream first waits on the stream the payloads were made on (the
submitter's ready event, ``PendingCircuit.origin``, and the device's
default stream), and the slot resolves its futures only after its stream's
work is done; the results' memory is marked as used by the submitters'
streams, so it is not reused before they have read it.  The kernel
wrappers' counters, device tables, library cache and launch observer are
locked (``repro_torch.kernels``), so slot threads share them safely.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import torch

from repro_torch.comanager.dataplane import SlotStreams
from repro_torch.comanager.faults import FaultToleranceConfig
from repro_torch.comanager.manager import CoManager
from repro_torch.comanager.worker import CircuitTask, WorkerConfig
from repro_torch.serve.coalescer import CoalescedBatch
from repro_torch.serve.dispatcher import (
    Dispatcher,
    KernelFn,
    MultiBankKernelFn,
    ShiftKernelFn,
    batch_cost_units,
    batch_device,
    batch_family,
    execute_batch,
    kernel_span_args,
)
from repro_torch.serve.fleet import FaultInjector
from repro_torch.serve.gateway import Gateway


class AsyncDispatcher(Dispatcher):
    """Non-blocking dispatcher: pump loop + per-worker execution pool."""

    #: ring-buffer capacity for execution errors kept for inspection — a
    #: long-lived dispatcher on a flaky fleet must not grow an unbounded
    #: error list; overflow increments ``errors_dropped`` instead.
    ERRORS_CAPACITY = 256

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
        evict_over_slo: bool = False,
        clock=time.perf_counter,
        slots_per_worker: int = 1,
        fault_tolerance: FaultToleranceConfig | None = None,
        fault_injector: FaultInjector | None = None,
    ):
        super().__init__(
            gateway,
            workers,
            manager=manager,
            kernel=kernel,
            shift_kernel=shift_kernel,
            multibank_kernel=multibank_kernel,
            mesh_spill=mesh_spill,
            spill_executor=spill_executor,
            clock=clock,
            fault_tolerance=fault_tolerance,
            fault_injector=fault_injector,
        )
        if slots_per_worker < 1:
            raise ValueError(f"slots_per_worker must be >= 1, got {slots_per_worker}")
        self.slots_per_worker = slots_per_worker
        #: preemptively evict ready-queue batches whose every member's SLO
        #: budget has fully elapsed (guaranteed misses): their futures
        #: resolve with DeadlineExceeded and the capacity serves work that
        #: can still make its deadline.  Off by default — eviction turns
        #: late results into errors, which only SLO-strict serving wants.
        self.evict_over_slo = evict_over_slo
        self._cv = threading.Condition()
        self._slot_free = {w.worker_id: slots_per_worker for w in workers}
        self._spill_slot_free = True  # one whole-mesh batch at a time
        self._ready: list[CoalescedBatch] = []
        self._in_flight = 0
        self._pumping = False  # a _pump_once holds popped-but-unqueued batches
        self._kicked = False
        self._stop = False
        self._errors: deque[BaseException] = deque(maxlen=self.ERRORS_CAPACITY)
        self._errors_dropped = 0
        self._pump_errors: list[BaseException] = []
        # in-flight runner registry for hedging and first-result-wins:
        # id(batch) -> {batch, outstanding, winner, wid, t0, est, hedged}
        self._runners: dict[int, dict] = {}
        # +1 thread: the whole-mesh spill slot runs alongside full worker pools
        self._pool = ThreadPoolExecutor(
            max_workers=len(workers) * slots_per_worker + 1,
            thread_name_prefix="serve-slot",
        )
        self._pump_thread: threading.Thread | None = None
        self._streams = SlotStreams()  # one CUDA stream per slot thread

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        """Launch the pump thread (idempotent)."""
        if self._pump_thread is not None and self._pump_thread.is_alive():
            return
        self._stop = False
        self._pump_thread = threading.Thread(
            target=self._pump_loop, name="serve-pump", daemon=True
        )
        self._pump_thread.start()

    def close(self) -> None:
        """Stop the pump thread and wait for in-flight batches to finish."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=10.0)
            self._pump_thread = None
        self._pool.shutdown(wait=True)

    def __enter__(self) -> "AsyncDispatcher":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def kick(self) -> None:
        """Wake the pump loop (call after submitting work)."""
        with self._cv:
            self._kicked = True
            self._cv.notify_all()

    # ----------------------------------------------------------- pump loop
    def _wait_timeout(self) -> float | None:
        """Seconds until the pump must wake for a deadline flush; a short
        safety poll while batches wait for capacity; None to sleep until
        kicked/notified."""
        nd = self.gateway.next_deadline()
        timeout = None
        with self._cv:
            if self._ready:
                timeout = 0.05
            if self.ft.hedge_k is not None and self._runners:
                # hedging watches in-flight slots against the EWMA estimate
                timeout = 0.01 if timeout is None else min(timeout, 0.01)
        if nd is not None:
            until = max(nd - self.clock(), 1e-3)
            timeout = until if timeout is None else min(timeout, until)
        return timeout

    def _pump_loop(self) -> None:
        while True:
            timeout = self._wait_timeout()
            with self._cv:
                if self._stop:
                    return
                if not self._kicked:
                    self._cv.wait(timeout)
                self._kicked = False
                if self._stop:
                    return
            try:
                self._pump_once()
            except Exception as exc:  # keep the loop alive; drain() raises it
                with self._cv:
                    self._pump_errors.append(exc)
                    self._cv.notify_all()

    def _pump_once(self) -> None:
        # _pumping marks the window where batches have been popped from the
        # gateway but not yet queued in _ready: drain() must not conclude
        # "quiesced" while their futures are still in limbo.
        with self._cv:
            self._pumping = True
        try:
            batches = self.gateway.pump(self.clock())
            with self._cv:
                self._ready.extend(batches)
        finally:
            with self._cv:
                self._pumping = False
                self._cv.notify_all()
        self._place_ready()
        self._maybe_hedge()

    def _expired(self, batch: CoalescedBatch, now: float) -> bool:
        """True when EVERY member's SLO budget has fully elapsed: the batch
        is a guaranteed miss for all of them, so executing it can only
        delay work that might still make its deadline.  A member without an
        SLO (best-effort) keeps the batch alive — its result is still
        wanted whenever it arrives."""
        saw_slo = False
        for m in batch.members:
            st = self.gateway.tenants.get(m.client_id)
            if st is None or st.slo_s is None:
                return False
            saw_slo = True
            if now <= m.arrival + st.slo_s:
                return False
        return saw_slo

    def _place_ready(self) -> None:
        """Try to place every ready batch; no head-of-line blocking — a
        batch that fits no worker right now is skipped, later batches may
        fit a different worker.  Oversized batches (register width above
        every worker, or over the per-block memory model) route to the whole-mesh spill slot;
        fully-over-SLO batches are preemptively evicted when enabled."""
        while True:
            now = self.clock()
            launch = spill = evict = None
            with self._cv:
                exclude = {
                    w for w, free in self._slot_free.items() if free <= 0
                } | self.fleet.unplaceable(now)
                for i, batch in enumerate(self._ready):
                    if self.evict_over_slo and self._expired(batch, now):
                        evict = self._ready.pop(i)
                        break
                    if self.mesh_spill and self._oversized(batch):
                        if not self._spill_slot_free:
                            continue  # mesh busy; later batches may fit workers
                        self._spill_slot_free = False
                        self._in_flight += 1
                        spill = self._ready.pop(i)
                        break
                    width = self._width(batch)
                    if not self.mesh_spill and width > self._max_width:
                        # spill disabled: the pre-spill contract — fail fast
                        # on register width only (a batch over the per-block model
                        # that fits a worker's register still executes there)
                        self._ready.pop(i)
                        err = RuntimeError(
                            f"no worker fits a {width}-qubit batch "
                            f"(largest worker: {self._max_width} qubits)"
                        )
                        self._push_error_locked(err)
                        self.gateway.fail(batch, err, now)
                        break
                    est = self._estimate_s(batch)
                    task = CircuitTask(
                        task_id=next(self.task_ids),
                        client_id="gateway",
                        demand=self._width(batch),
                        service_time=est,
                    )
                    wid = self.manager.assign(task, now, exclude=exclude)
                    if wid is None:
                        continue
                    self._ready.pop(i)
                    self._slot_free[wid] -= 1
                    self._in_flight += 1
                    self._charge(wid, est)
                    self.fleet.on_dispatch(wid)
                    self._runners[id(batch)] = {
                        "batch": batch,
                        "outstanding": 1,
                        "winner": None,
                        "wid": wid,
                        "t0": now,
                        "est": est,
                        "hedged": False,
                    }
                    launch = (batch, task, wid, est)
                    break
                else:
                    return  # nothing placeable right now
            tr = self.gateway.telemetry.trace
            if evict is not None:
                self.gateway.evict(evict, now)
            elif spill is not None:
                if tr.enabled:
                    tr.batch_stage(
                        (m.seq for m in spill.members), "placed", now,
                        worker="mesh",
                    )
                self._pool.submit(self._run_spill, spill)
            elif launch is not None:
                if tr.enabled:
                    tr.batch_stage(
                        (m.seq for m in launch[0].members), "placed", now,
                        worker=launch[2],
                    )
                self._pool.submit(self._run, *launch)

    def _run_spill(self, batch: CoalescedBatch) -> None:
        """Spill-slot thread: execute one oversized batch on the whole
        device mesh, resolve its futures, release the spill slot."""
        tr = self.gateway.telemetry.trace
        t0 = self.clock()
        if tr.enabled:
            seqs = [m.seq for m in batch.members]
            tr.batch_stage(seqs, "dispatched", t0)
            tr.batch_stage(seqs, "kernel_start", t0)
        err: BaseException | None = None
        fids = None
        try:
            fids = self._on_slot_stream(
                batch, lambda: execute_batch(batch, *self._spill_fns())
            )
        except BaseException as exc:
            err = exc
        dt = self.clock() - t0
        now = self.clock()
        if err is None:
            if tr.enabled:
                tr.worker_span(
                    "mesh", t0, t0 + dt, kind="spill",
                    args=kernel_span_args(batch),
                )
            self.gateway.telemetry.service.update(
                ("spill", batch_family(batch)), batch_cost_units(batch), dt
            )
            self.gateway.telemetry.on_spill(batch.lane_count)
            self._record(batch)
            self.gateway.complete(batch, fids, now)
        else:
            self.gateway.fail(batch, err, now)
        with self._cv:
            self._spill_slot_free = True
            self._in_flight -= 1
            self.batch_log.append(
                ("mesh", batch.n, tuple(sorted(batch.clients())))
            )
            if err is not None:
                self._push_error_locked(err)
            self._kicked = True
            self._cv.notify_all()

    def _run(
        self,
        batch: CoalescedBatch,
        task: CircuitTask | None,
        wid: str,
        est: float,
        hedge: bool = False,
    ) -> None:
        """Worker-slot thread: execute one batch, resolve its futures (out
        of submission order relative to other batches), release the slot.

        Failure tolerance: a failed attempt retries in place (bounded by
        ``FaultToleranceConfig.retry_limit`` with exponential backoff), then
        the batch migrates to a surviving worker through the gateway's
        re-coalescing requeue.  With hedging, two runners may race on one
        batch: the first success claims it (resolving the futures exactly
        once) and the loser's result is discarded — kernel launches cannot
        be interrupted, so safe cancellation means the loser lands without
        side effects."""
        tel = self.gateway.telemetry
        tr = tel.trace
        seqs = [m.seq for m in batch.members]
        t0 = self.clock()
        if tr.enabled and not hedge:
            tr.batch_stage(seqs, "dispatched", t0)
            tr.batch_stage(seqs, "kernel_start", t0)
        err: BaseException | None = None
        fids = None
        attempts = 0
        while True:
            t0 = self.clock()
            err = None
            try:
                if self.fault_injector is not None:
                    self.fault_injector.check(wid, t0)
                fids = self._on_slot_stream(
                    batch,
                    lambda: execute_batch(
                        batch, self.kernel, self.shift_kernel, self.multibank_kernel
                    ),
                )
                if self.fault_injector is not None:
                    # mirror the simulation's slowdown fault in wall time
                    extra = (
                        self.fault_injector.slowdown_factor(wid, t0) - 1.0
                    ) * (self.clock() - t0)
                    if extra > 0:
                        time.sleep(extra)
            except BaseException as exc:
                err = exc
            if err is None:
                break
            now = self.clock()
            tripped = self.fleet.on_failure(wid, now)
            tel.on_worker_failure(wid)
            if tripped:
                tel.on_worker_offline(wid)
                if tr.enabled:
                    tr.batch_stage(seqs, "worker_offline", now, worker=wid)
            attempts += 1
            if (
                not hedge
                and attempts <= self.ft.retry_limit
                and self.fleet.retryable(wid, now)
            ):
                self.fleet.record_retry(wid)
                tel.on_worker_retry(wid)
                if tr.enabled:
                    tr.batch_stage(seqs, "retried", now, worker=wid)
                if self.ft.retry_backoff_s:
                    time.sleep(self.ft.retry_backoff_s * 2 ** (attempts - 1))
                continue
            break
        dt = self.clock() - t0
        now = self.clock()
        # settle against the (possibly hedged) runner set: the first
        # successful runner claims the batch, the LAST failed runner with
        # no winner owns migration/terminal failure.
        with self._cv:
            entry = self._runners.get(id(batch))
            if entry is not None:
                entry["outstanding"] -= 1
                last = entry["outstanding"] <= 0
                claimed = err is None and entry["winner"] is None
                if claimed:
                    entry["winner"] = wid
                winner_exists = entry["winner"] is not None
                if last:
                    self._runners.pop(id(batch), None)
            else:  # defensive: every launch registers an entry
                last, claimed, winner_exists = True, err is None, err is None
        migrated = False
        if claimed:
            if tr.enabled:
                tr.worker_span(wid, t0, t0 + dt, args=kernel_span_args(batch))
            self._observe(batch, dt)
            self._record(batch)
            self.gateway.complete(batch, fids, now)
        elif err is not None and last and not winner_exists:
            bad = self.fleet.unplaceable(now)
            with self._cv:
                survivors = [
                    w
                    for w, v in self.manager.workers.items()
                    if w != wid
                    and w not in bad
                    and v.max_qubits >= self._width(batch)
                ]
            if survivors:
                migrated = True
                self.fleet.record_migration(wid)
                tel.on_worker_migration(wid)
                if tr.enabled:
                    tr.batch_stage(seqs, "migrated", now, worker=wid)
                self.gateway.requeue(batch, now)
            else:
                self.gateway.fail(batch, err, now)
        if err is None:
            self.fleet.on_success(wid)
        # futures are resolved BEFORE the slot is released, so drain()'s
        # "no in-flight batches" implies "every future resolved".
        with self._cv:
            if task is not None:
                self.manager.complete(wid, task, now)
            self._charge(wid, -est)
            if wid in self._slot_free:  # the worker may have been drained
                self._slot_free[wid] += 1
            self._in_flight -= 1
            self.fleet.on_release(wid)
            if claimed or (err is not None and last and not winner_exists):
                self.batch_log.append(
                    (wid, batch.n, tuple(sorted(batch.clients())))
                )
            if err is not None and last and not winner_exists and not migrated:
                self._push_error_locked(err)
            self._kicked = True  # freed capacity: ready batches may now place
            self._cv.notify_all()

    def _on_slot_stream(self, batch: CoalescedBatch, run) -> list:
        """``run()`` (the batch's execution) on this slot thread's own CUDA
        stream (``SlotStreams.run``), ordered after this thread's default
        stream and the submitters' ready events; returns once the stream's
        work is done, with the results' memory marked as used by the
        submitters' streams.  On the CPU it just runs."""
        dev = batch_device(batch)
        default = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        origins = {id(m.origin[0]): m.origin for m in batch.members if m.origin is not None}
        waits = [default, *(ready for ready, _ in origins.values())]
        fids, done = self._streams.run(threading.get_ident(), dev, waits, run)
        if done is None:
            return fids
        done.synchronize()  # futures resolve on the host, after the slot's work
        readers = {s.cuda_stream: s for _, s in origins.values()}
        readers[default.cuda_stream] = default
        SlotStreams.wait(done, tuple(readers.values()), fids)
        return fids

    def _maybe_hedge(self) -> None:
        """Hedged duplicate dispatch: an in-flight batch whose slot has
        exceeded ``hedge_k x`` its ServiceModel estimate is duplicated onto
        a free surviving worker; first result wins."""
        k = self.ft.hedge_k
        if k is None:
            return
        now = self.clock()
        launches = []
        with self._cv:
            for entry in self._runners.values():
                if entry["hedged"] or entry["winner"] is not None:
                    continue
                if now - entry["t0"] < k * max(entry["est"], 1e-9):
                    continue
                batch = entry["batch"]
                width = self._width(batch)
                wid2 = None
                for w in sorted(self._slot_free):
                    if w == entry["wid"] or self._slot_free[w] <= 0:
                        continue
                    v = self.manager.workers.get(w)
                    if v is None or v.max_qubits < width:
                        continue
                    if not self.fleet.placeable(w, now):
                        continue
                    wid2 = w
                    break
                if wid2 is None:
                    continue
                entry["hedged"] = True
                entry["outstanding"] += 1
                self._slot_free[wid2] -= 1
                self._in_flight += 1
                self._charge(wid2, entry["est"])
                self.fleet.on_dispatch(wid2)
                launches.append((batch, entry["wid"], wid2, entry["est"]))
        tel = self.gateway.telemetry
        tr = tel.trace
        for batch, straggler, wid2, est in launches:
            self.fleet.record_hedge(straggler)
            tel.on_worker_hedge(straggler)
            if tr.enabled:
                tr.batch_stage(
                    (m.seq for m in batch.members), "hedged", now, worker=wid2
                )
            self._pool.submit(self._run, batch, None, wid2, est, True)

    # ------------------------------------------------------------- control
    def pump(self) -> int:
        """Non-blocking: wake the pump loop and return immediately."""
        self.kick()
        return 0

    def drain(self) -> int:
        """Force-flush partial buffers and block until the gateway is idle
        and every in-flight batch has resolved its futures.  Returns the
        number of batches executed while draining.  Raises the first pump-
        loop error instead of spinning forever on a wedged pump."""
        self.start()
        n0 = len(self.batch_log)
        while True:
            batches = self.gateway.flush(self.clock())
            with self._cv:
                if self._pump_errors:
                    raise self._pump_errors[0]
                self._ready.extend(batches)
                self._kicked = True
                self._cv.notify_all()
                quiesced = (
                    not self._ready
                    and self._in_flight == 0
                    and not self._pumping
                )
            if quiesced and self.gateway.idle:
                break
            with self._cv:
                self._cv.wait(0.02)
        return len(self.batch_log) - n0

    def absorb_backpressure(self) -> None:
        """Backpressure-retry hook: wake the pump, then wait briefly for a
        completion to free queue space — WITHOUT quiescing the whole runtime
        (the sync dispatcher has no choice but to drain inline; here a full
        drain would collapse the submission/execution overlap)."""
        self.kick()
        with self._cv:
            if self._pump_errors:
                raise self._pump_errors[0]
            self._cv.wait(0.05)

    # ------------------------------------------------------ live membership
    def register_worker(self, worker: WorkerConfig) -> None:
        """Grow the fleet at runtime: the new worker gets its execution
        slots and becomes placeable on the next pump cycle."""
        # manager.workers is read under _cv by the pump and runner threads,
        # so membership mutations happen under the same lock
        with self._cv:
            super().register_worker(worker)
            self._slot_free[worker.worker_id] = self.slots_per_worker
            # grow the slot pool so the new worker's slots can actually run
            # concurrently (ThreadPoolExecutor spawns threads on demand up
            # to _max_workers, so raising the cap is safe at runtime)
            self._pool._max_workers += self.slots_per_worker
            self._kicked = True
            self._cv.notify_all()

    def drain_worker(self, worker_id: str, timeout: float = 30.0) -> None:
        """Live drain: stop placing on the worker, wait for its in-flight
        slots to land (results resolve, or migrate through the failure
        path), then remove it from the fleet."""
        deadline = time.monotonic() + timeout
        with self._cv:
            if worker_id not in self._slot_free:
                raise KeyError(f"unknown worker {worker_id!r}")
            self.fleet.mark_draining(worker_id)
            while self._slot_free[worker_id] < self.slots_per_worker:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"drain_worker({worker_id!r}): in-flight work did "
                        f"not land within {timeout}s"
                    )
                self._cv.wait(min(remaining, 0.05))
            del self._slot_free[worker_id]
            self._forget_worker(worker_id)
        self.kick()

    # ------------------------------------------------------------- metrics
    @property
    def in_flight_batches(self) -> int:
        with self._cv:
            return self._in_flight

    def _push_error_locked(self, err: BaseException) -> None:
        """Append to the bounded error ring (caller holds ``_cv``)."""
        if len(self._errors) == self._errors.maxlen:
            self._errors_dropped += 1
        self._errors.append(err)

    @property
    def errors(self) -> list[BaseException]:
        with self._cv:
            return list(self._pump_errors) + list(self._errors)

    @property
    def errors_dropped(self) -> int:
        """Errors evicted from the bounded ring (oldest-first overflow)."""
        with self._cv:
            return self._errors_dropped
