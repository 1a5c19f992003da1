"""The multi-tenant system simulation: EventLoop + workers + CoManager.

Wires the paper's full runtime together on the virtual clock:
  * workers register at t=0 and send heartbeats every ``heartbeat_period``;
  * clients submit jobs (circuit banks) at their submit times;
  * the co-Manager drains the pending queue on every state change
    (submission / completion / heartbeat), per Algorithm 2;
  * completions loop results back to the classical side.

This is the engine behind every runtime figure reproduction (the Fig 3, 4,
5 and 6 experiments).  It runs on the host only, so its reports are the
reference's, field for field.

The typed front door is ``repro_torch.api``: ``SimulationConfig`` carries this
constructor's kwarg pile and ``QuantumCluster.simulate`` forwards open
sessions' ``TenantPolicy``s into the per-tenant override maps below.
"""

from __future__ import annotations

import dataclasses

from repro_torch.comanager.events import EventLoop
from repro_torch.comanager.faults import normalize_failures
from repro_torch.comanager.manager import CoManager
from repro_torch.comanager.tenancy import JobResult, JobSpec, TaskIdAllocator
from repro_torch.comanager.worker import CircuitTask, QuantumWorker, WorkerConfig


@dataclasses.dataclass
class SimulationReport:
    jobs: dict[str, JobResult]
    total_circuits: int
    makespan: float
    assignments: list
    evictions: list
    worker_busy_time: dict[str, float]
    #: mean over executed circuits of (1 - error_rate_w)^depth — the
    #: fraction of SWAP-test signal surviving depolarization (1.0 = ideal).
    fidelity_retention: float = 1.0
    #: circuits shed by gateway admission control (``Backpressure`` raised
    #: at submit under ``gateway_max_pending``/``gateway_max_system_pending``);
    #: they count as drained — never executed, never in ``jobs`` latencies.
    rejected: int = 0
    #: serve-gateway telemetry (per-tenant latency, lane-fill) when the
    #: simulation ran with gateway=True; None otherwise.
    gateway_summary: dict | None = None
    #: the gateway telemetry's ``TraceRecorder`` (lifecycle traces, worker
    #: timelines, Chrome-trace export) when the simulation ran with
    #: gateway=True; None otherwise.
    trace: object | None = None

    @property
    def circuits_per_second(self) -> float:
        return self.total_circuits / max(self.makespan, 1e-9)


def _validate_tenant_maps(jobs, *, worker_ids, worker_failures=None, **maps):
    """Reject per-tenant override maps that name unknown client ids.

    ``tenant_weights`` / ``tenant_priorities`` / ``tenant_slos_ms`` /
    ``arrivals`` keys must each be a submitted job's client id (a typo'd
    key used to pass silently — the override simply never applied);
    ``worker_failures`` keys must name configured workers."""
    known = {j.client_id for j in jobs}
    for name, mapping in maps.items():
        unknown = sorted(set(mapping or ()) - known)
        if unknown:
            raise ValueError(
                f"{name} refers to unknown client id(s) {unknown}; "
                f"known clients: {sorted(known)}"
            )
    bad_workers = sorted(set(worker_failures or ()) - worker_ids)
    if bad_workers:
        raise ValueError(
            f"worker_failures refers to unknown worker id(s) {bad_workers}; "
            f"known workers: {sorted(worker_ids)}"
        )
    # malformed fault specs (negative/NaN times, recover-before-fail, bad
    # probabilities) raise here, naming the offending worker id
    normalize_failures(worker_failures)


class SystemSimulation:
    def __init__(
        self,
        worker_cfgs: list[WorkerConfig],
        jobs: list[JobSpec],
        *,
        env: str = "ibmq",
        multi_tenant: bool = True,
        tenancy: str | None = None,
        policy: str = "cru",
        fidelity_floor: float = 0.0,
        eager_completion: bool = True,
        heartbeat_period: float = 5.0,
        assign_latency: float = 0.01,
        classical_overhead: float = 0.0,
        lockstep: bool = False,
        fair_queue: bool = False,
        run_until: float = 1e7,
        worker_failures: dict[str, float] | None = None,
        gateway: bool = False,
        gateway_target: int | None = None,
        gateway_deadline: float = 1.0,
        gateway_async: bool = False,
        gateway_max_pending: int | None = None,
        gateway_max_system_pending: int | None = None,
        gateway_max_pending_per_tier: dict[int, int] | None = None,
        tenant_weights: dict[str, float] | None = None,
        tenant_priorities: dict[str, int] | None = None,
        tenant_slos_ms: dict[str, float] | None = None,
        arrivals: dict[str, list[float]] | None = None,
        observability=None,
    ):
        """``assign_latency``: manager->worker dispatch cost per circuit.

        ``classical_overhead``: SERIAL per-circuit time on the classical
        manager (logical-circuit generation + quantum-state analysis).  The
        paper's runtime figures show strongly diminishing returns with more
        workers (5q/1L: 94.7s -> 73.1s for 1 -> 4 workers, not 4x) because the
        classical side — a single laptop/VM — processes every circuit
        serially.  Modeling it as a serial resource reproduces those curves;
        see benchmarks/runtime_uncontrolled.py for the calibration.

        ``lockstep``: reproduce the paper's Algorithm-1 dispatch loop
        ("for Circuit in cB: Result = Algorithm2(Circuit)"): the client sends
        one circuit per worker, then waits for the whole round to return
        before dispatching the next — round time ~ w*t_cl + t_q, which is
        exactly the diminishing-returns shape of Figs 3-5 (see
        benchmarks/calibration notes).

        ``classical_overhead`` is charged to a PER-CLIENT serial ledger: each
        client's classical process generates/analyzes its own circuits
        serially, which is the real bottleneck on the paper's classical side.

        ``worker_failures``: worker_id -> fault schedule.  The legacy float
        form (time at which the worker silently stops heartbeating, which
        exercises the 3-missed-heartbeats eviction path) still works; a
        ``FaultSpec`` — or a dict of its fields — selects a typed fault:
        ``crash`` (silent forever), ``crash_recover`` (re-registers at
        ``recover_at``, abandoning and requeueing anything it was running),
        ``slowdown`` (service times stretched by ``factor`` inside the
        window), ``flaky`` (each completion dropped-and-requeued with
        deterministic probability ``p``).  The same schedules drive the real
        dispatchers via ``repro_torch.serve.fleet.FaultInjector``.

        ``gateway``: route submissions through the online serving gateway
        (repro_torch.serve): circuits are admitted to per-client queues, dequeued
        weighted-fair, coalesced across tenants into lane-aligned mega-batches
        keyed by circuit structure, and each batch is ONE logical task for
        Algorithm 2 (demand = circuit width).  Batch execution follows the
        fused-kernel cost model: a batch of n compatible circuits takes
        ceil(n / LANES) service times (lanes execute in parallel), so packing
        LANES circuits into one dispatch costs one circuit's time — the
        coalescing throughput win, on the virtual clock.

        ``gateway_async``: virtual-clock counterpart of the real runtime's
        ``AsyncDispatcher`` worker pool.  The synchronous gateway charges
        every batch's dispatch overhead to ONE serial classical ledger (the
        pump thread executing batches inline), so a slow dispatch
        head-of-line-blocks all workers; async mode charges it to a
        PER-WORKER ledger — each worker's execution slot pipelines its own
        admissions — so in-flight batches on different workers overlap.

        ``tenant_priorities`` / ``tenant_slos_ms`` (gateway mode): strict
        scheduling tier (lower = first) and end-to-end latency SLO per
        client, forwarded to ``Gateway.register_client``; SLOs shorten the
        coalescer's flush deadline and arm deadline-miss accounting in the
        gateway telemetry (``slo_attainment`` in ``gateway_summary``).

        ``arrivals`` (gateway mode): client_id -> per-circuit arrival-time
        offsets (relative to the job's submit_time); circuits then stream in
        open-loop instead of arriving as one epoch-sized burst — the
        high-traffic serving stand-in used by benchmarks/gateway_throughput.

        ``gateway_max_pending`` / ``gateway_max_system_pending`` /
        ``gateway_max_pending_per_tier`` (gateway mode): per-tenant, global,
        and per-priority-tier admission caps.  A submission the
        gateway rejects (``Backpressure``) is counted in
        ``SimulationReport.rejected`` and drained — shed load, not executed
        work.  The global cap is the weighted-fair admission control the
        scale harness calibrates at the throughput knee
        (``repro_torch.scale.knee``); both default to None (admit everything).

        Every per-tenant override map is validated against the submitted
        jobs' client ids (and ``worker_failures`` against the worker fleet):
        unknown keys raise ``ValueError`` instead of silently never applying.
        """
        _validate_tenant_maps(
            jobs,
            tenant_weights=tenant_weights,
            tenant_priorities=tenant_priorities,
            tenant_slos_ms=tenant_slos_ms,
            arrivals=arrivals,
            worker_failures=worker_failures,
            worker_ids={c.worker_id for c in worker_cfgs},
        )
        self.loop = EventLoop()
        self.manager = CoManager(
            multi_tenant=multi_tenant,
            tenancy=tenancy,
            eager_completion=eager_completion,
            policy=policy,
            fidelity_floor=fidelity_floor,
        )
        self.workers = {c.worker_id: QuantumWorker(c) for c in worker_cfgs}
        self.jobs = {j.client_id: j for j in jobs}
        self.env = env
        self.heartbeat_period = heartbeat_period
        self.assign_latency = assign_latency
        self.classical_overhead = classical_overhead
        self.lockstep = lockstep
        self.fair_queue = fair_queue  # round-robin across clients in the queue
        self._client_free: dict[str, float] = {}  # per-client serial CPU
        self._in_flight: dict[str, int] = {}  # per-client outstanding
        self.run_until = run_until
        self.failures = normalize_failures(worker_failures)
        self._flaky_attempts: dict[tuple[str, int], int] = {}
        self._recovery_scheduled: set[str] = set()

        self._remaining: dict[str, int] = {}
        self._results: dict[str, JobResult] = {}
        self._total = 0
        self.task_ids = TaskIdAllocator()  # per-simulation id space

        self.gateway = None
        self.gateway_async = gateway_async
        self.arrivals = arrivals or {}
        self.rejected = 0
        #: fired as ``cb(client_id, t)`` when a job's last circuit finishes —
        #: the hook round-structured controllers (repro_torch.federated) ride to
        #: observe per-tenant update arrival times on the virtual clock.
        self.job_callbacks: list = []
        self._tenant_weights = dict(tenant_weights or {})
        self._tenant_priorities = dict(tenant_priorities or {})
        self._tenant_slos_ms = dict(tenant_slos_ms or {})
        if gateway:
            # the serving layer's lane width (the reference's 128), not the
            # kernels' warp of 32: batches, cost passes and lane fill count
            # in the reference's units
            from repro_torch.serve.coalescer import LANES
            from repro_torch.serve.gateway import Backpressure, Gateway
            from repro_torch.serve.metrics import Telemetry

            self.gw_lanes = LANES
            self._backpressure = Backpressure
            gw_kwargs = {}
            if gateway_max_pending is not None:
                gw_kwargs["max_pending"] = gateway_max_pending
            if gateway_max_pending_per_tier is not None:
                gw_kwargs["max_pending_per_tier"] = gateway_max_pending_per_tier
            self.gateway = Gateway(
                target=gateway_target or LANES,
                deadline=gateway_deadline,
                lanes=LANES,
                max_system_pending=gateway_max_system_pending,
                telemetry=Telemetry(lanes=LANES, observability=observability),
                **gw_kwargs,
            )
            for j in jobs:
                self.gateway.register_client(
                    j.client_id,
                    weight=(tenant_weights or {}).get(j.client_id, 1.0),
                    priority=(tenant_priorities or {}).get(j.client_id, 1),
                    slo_ms=(tenant_slos_ms or {}).get(j.client_id),
                )
            self._gw_batches: dict[int, object] = {}  # batch task_id -> batch
            self._gw_dispatched: set[int] = set()  # handed to a worker
            self._gw_flush_at: float | None = None

        lp = self.loop
        lp.on("register", self._on_register)
        lp.on("heartbeat", self._on_heartbeat)
        lp.on("submit", self._on_submit)
        lp.on("submit_circuit", self._on_submit_circuit)
        lp.on("gw_flush", self._on_gw_flush)
        lp.on("start", self._on_start)
        lp.on("complete", self._on_complete)
        lp.on("liveness", self._on_liveness)

    # ------------------------------------------------------------ handlers
    def _on_register(self, t: float, wid: str) -> None:
        w = self.workers[wid]
        for task in w.abandon(t):
            # crash_recover re-registration: the worker lost its in-memory
            # state, so anything it was running is requeued — unless the
            # liveness eviction already returned it to the queue, or a
            # replay finished elsewhere in the meantime
            if task.task_id in self.manager.completed_ids:
                continue
            if any(p.task_id == task.task_id for p in self.manager.pending):
                continue
            if any(
                task.task_id in v.in_flight
                for w2, v in self.manager.workers.items()
                if w2 != wid
            ):
                continue
            if self.gateway is not None and task.client_id == "__gw__":
                if task.task_id in self._gw_batches:
                    self._in_flight[task.client_id] -= 1
                    self._gw_requeue(t, task)
                continue
            self._in_flight[task.client_id] -= 1
            self.manager.submit(task)
        self.manager.register_worker(
            wid, w.max_qubits, w.cru(t), t, error_rate=w.cfg.error_rate
        )
        self.loop.schedule(t + self.heartbeat_period, "heartbeat", wid)
        self._drain(t)

    def _on_heartbeat(self, t: float, wid: str) -> None:
        f = self.failures.get(wid)
        if f is not None and f.crashed_between(t - self.heartbeat_period, t):
            # worker went silent: no report, no reschedule.  A crash_recover
            # schedules exactly one re-registration at its recovery time.
            if f.recover_at is not None and wid not in self._recovery_scheduled:
                self._recovery_scheduled.add(wid)
                self.loop.schedule(max(f.recover_at, t), "register", wid)
            return
        if self._all_done():
            return  # system idle: let the event loop drain
        w = self.workers[wid]
        self.manager.heartbeat(w.heartbeat_payload(t), t)
        self._drain(t)
        self.loop.schedule(t + self.heartbeat_period, "heartbeat", wid)

    def _on_liveness(self, t: float, _) -> None:
        self.manager.liveness_check(t, self.heartbeat_period)
        if self.gateway is not None:
            # batches requeued off an evicted worker go back through the
            # coalescer (re-coalesced), not straight back to Algorithm 2
            lost = [
                task
                for task in self.manager.pending
                if task.task_id in self._gw_dispatched
            ]
            if lost:
                self.manager.pending = [
                    task
                    for task in self.manager.pending
                    if task.task_id not in self._gw_dispatched
                ]
                for task in lost:
                    self._gw_requeue(t, task)
        self._drain(t)
        if not self._all_done():
            self.loop.schedule(t + self.heartbeat_period, "liveness", None)

    def _all_done(self) -> bool:
        jobs_submitted = len(self._remaining) == len(self.jobs)
        done = (
            jobs_submitted
            and not any(self._remaining.values())
            and not self.manager.pending
        )
        if done and self.gateway is not None:
            done = self.gateway.idle and not self._gw_batches
        return done

    def _on_submit(self, t: float, job: JobSpec) -> None:
        tasks = job.circuits(self.env, self.task_ids)
        self._remaining[job.client_id] = len(tasks)
        self._total += len(tasks)
        if self.gateway is not None:
            offsets = self.arrivals.get(job.client_id)
            if offsets is not None:
                # open-loop streaming: one admission event per circuit
                assert len(offsets) >= len(tasks), job.client_id
                for task, dt in zip(tasks, offsets):
                    self.loop.schedule(t + dt, "submit_circuit", task)
            else:
                for task in tasks:
                    self._gw_admit(t, task)
                self._gw_pump(t)
            return
        for task in tasks:
            self.manager.submit(task)
        self._drain(t)

    # -------------------------------------------------- gateway (serve/) path
    def _on_submit_circuit(self, t: float, task: CircuitTask) -> None:
        self._gw_admit(t, task)
        self._gw_pump(t)

    def _gw_admit(self, t: float, task: CircuitTask) -> None:
        key = (task.demand, task.service_time, task.depth)  # structural key
        try:
            self.gateway.submit(task.client_id, key, task, now=t)
        except self._backpressure:
            # admission control shed the circuit: it still counts as drained
            # (the job finishes with fewer executed circuits), never executed
            self.rejected += 1
            self._finish_one(task.client_id, t)

    def _gw_pump(self, t: float) -> None:
        """Coalesce admitted circuits; submit emitted batches to Algorithm 2
        as single lane-packed tasks; keep a flush timer armed for partials."""
        for batch in self.gateway.pump(t):
            self._gw_dispatch(t, batch)
        nd = self.gateway.next_deadline()
        if nd is not None and (
            self._gw_flush_at is None
            or nd < self._gw_flush_at - 1e-12
            or self._gw_flush_at <= t
        ):
            self._gw_flush_at = max(nd, t)
            self.loop.schedule(self._gw_flush_at, "gw_flush", None)
        self._drain(t)

    def _on_gw_flush(self, t: float, _) -> None:
        self._gw_flush_at = None
        self._gw_pump(t)

    def _gw_dispatch(self, t: float, batch) -> None:
        """One coalesced batch = one logical circuit-bank task: demand is the
        member circuits' width, service time is the fused-kernel cost
        ceil(n / LANES) * per-circuit time (lanes run in parallel)."""
        proto: CircuitTask = batch.members[0].payload
        n_passes = -(-batch.n // self.gw_lanes)
        bt = CircuitTask(
            task_id=next(self.task_ids),
            client_id="__gw__",
            demand=proto.demand,
            service_time=n_passes * proto.service_time,
            depth=proto.depth,
        )
        self._gw_batches[bt.task_id] = batch
        self.manager.submit(bt)

    def _gw_requeue(self, t: float, batch_task: CircuitTask) -> None:
        """An assigned batch came back (worker evicted / died before start):
        return its members to the coalescer so they are RE-coalesced —
        possibly merged with newer arrivals — rather than replayed as-is."""
        batch = self._gw_batches.pop(batch_task.task_id)
        self._gw_dispatched.discard(batch_task.task_id)
        self.gateway.requeue(batch, now=t)
        self._gw_pump(t)

    def _on_start(self, t: float, payload) -> None:
        task, wid = payload
        w = self.workers.get(wid)
        if w is None or task.demand > w.available_qubits:
            # worker died (or optimistic over-commit after eviction): requeue
            self._in_flight[task.client_id] -= 1
            if self.gateway is not None and task.task_id in self._gw_batches:
                self._gw_requeue(t, task)
            else:
                self.manager.submit(task)
            return
        finish = w.start(task, t)
        f = self.failures.get(wid)
        if f is not None:
            factor = f.slowdown_factor(t)
            if factor != 1.0:
                finish = t + (finish - t) * factor
                w.active[task.task_id].finish_time = finish
        if self.gateway is not None and task.task_id in self._gw_batches:
            tr = self.gateway.telemetry.trace
            if tr.enabled:
                batch = self._gw_batches[task.task_id]
                seqs = [m.seq for m in batch.members]
                tr.batch_stage(seqs, "dispatched", t, worker=wid)
                tr.batch_stage(seqs, "kernel_start", t)
                tr.worker_span(
                    wid,
                    t,
                    finish,
                    name=f"batch x{batch.n}",
                    args={
                        "members": batch.n,
                        "service_time": round(finish - t, 9),
                    },
                )
        self.loop.schedule(finish, "complete", (task, wid, t))

    def _on_complete(self, t: float, payload) -> None:
        task, wid, t_start = payload
        f = self.failures.get(wid)
        if f is not None and f.crashed_between(t_start, t):
            return  # worker died mid-execution: result never loops back
        if task.task_id in self.manager.completed_ids:
            return  # duplicate (requeued-then-finished-twice guard)
        w = self.workers[wid]
        if task.task_id not in w.active:
            return  # abandoned at a crash_recover re-registration
        if f is not None and f.kind == "flaky":
            key = (wid, task.task_id)
            attempt = self._flaky_attempts.get(key, 0)
            self._flaky_attempts[key] = attempt + 1
            if f.drops(task.task_id, attempt, t):
                # the execution happened but its result is garbage: release
                # the worker and requeue the task for another attempt
                w.finish(task.task_id, t)
                view = self.manager.workers.get(wid)
                if view is not None:
                    view.in_flight.pop(task.task_id, None)
                self._in_flight[task.client_id] -= 1
                if self.gateway is not None and task.task_id in self._gw_batches:
                    self._gw_requeue(t, task)
                else:
                    self.manager.submit(task)
                self._drain(t)
                return
        w.finish(task.task_id, t)
        self.manager.complete(wid, task, t)
        cid = task.client_id
        self._in_flight[cid] -= 1
        if self.gateway is not None and task.task_id in self._gw_batches:
            batch = self._gw_batches.pop(task.task_id)
            self._gw_dispatched.discard(task.task_id)
            self.gateway.complete(batch, None, t)
            for m in batch.members:
                self._finish_one(m.client_id, t)
        else:
            self._finish_one(cid, t)
        self._drain(t)

    def _finish_one(self, cid: str, t: float) -> None:
        self._remaining[cid] -= 1
        if self._remaining[cid] == 0:
            job = self.jobs[cid]
            self._results[cid] = JobResult(cid, job.n_circuits, job.submit_time, t)
            for cb in self.job_callbacks:
                cb(cid, t)

    def _drain(self, t: float) -> None:
        def launch(task, wid):
            # dispatch occupies the client's serial classical process first
            # (in gateway mode the ledger is the gateway's: one dispatch
            # cost per BATCH — the amortization that coalescing buys).
            # gateway_async splits that ledger PER WORKER: each worker's
            # execution slot pipelines its own dispatches, so batch dispatch
            # on one worker no longer head-of-line-blocks the others.
            cid = task.client_id
            ledger = cid
            if (
                self.gateway_async
                and self.gateway is not None
                and task.task_id in self._gw_batches
            ):
                ledger = f"{cid}/{wid}"
            free = max(self._client_free.get(ledger, 0.0), t) + self.classical_overhead
            self._client_free[ledger] = free
            self._in_flight[cid] = self._in_flight.get(cid, 0) + 1
            if self.gateway is not None and task.task_id in self._gw_batches:
                self._gw_dispatched.add(task.task_id)
                tr = self.gateway.telemetry.trace
                if tr.enabled:
                    tr.batch_stage(
                        (m.seq for m in self._gw_batches[task.task_id].members),
                        "placed",
                        t,
                        worker=wid,
                    )
            self.loop.schedule(free + self.assign_latency, "start", (task, wid))

        if self.lockstep:
            # round barrier: a client dispatches a new wave only when its
            # previous wave has fully returned (Algorithm 1's serial loop),
            # and at most one circuit per worker per wave.
            busy = {c for c, n in self._in_flight.items() if n > 0}
            placed = 0
            remaining = []
            used_workers: set[str] = set()
            for task in self.manager.pending:
                if task.client_id in busy:
                    remaining.append(task)
                    continue
                wid = self.manager.assign(task, t, exclude=used_workers)
                if wid is None:
                    remaining.append(task)
                    continue
                used_workers.add(wid)
                launch(task, wid)
                placed += 1
            self.manager.pending = remaining
        else:
            if self.fair_queue and self.manager.pending:
                self.manager.pending = _round_robin(self.manager.pending)
            self.manager.drain_pending(t, launch)

    # ---------------------------------------------------------------- run
    def submit_job(
        self,
        job: JobSpec,
        *,
        weight: float = 1.0,
        priority: int = 1,
        slo_ms: float | None = None,
    ) -> None:
        """Admit a job into a running (or not-yet-run) simulation.

        The constructor's job list is closed-world: every client is known at
        t=0 and its policy overrides are validated up front.  Round-structured
        controllers (the federated driver) instead open jobs as virtual time
        advances — a tenant's round-r local-training job is only knowable
        when round r-1 closes — so this entry point registers the job's
        gateway client with an explicit policy and schedules its submission
        at ``max(job.submit_time, now)``."""
        if job.client_id in self.jobs:
            raise ValueError(f"job {job.client_id!r} already submitted")
        self.jobs[job.client_id] = job
        if self.gateway is not None:
            self.gateway.register_client(
                job.client_id,
                weight=self._tenant_weights.get(job.client_id, weight),
                priority=self._tenant_priorities.get(job.client_id, priority),
                slo_ms=self._tenant_slos_ms.get(job.client_id, slo_ms),
            )
        self.loop.schedule(max(job.submit_time, self.loop.now), "submit", job)

    def start(self) -> None:
        """Schedule worker registrations, the liveness sweep, and every
        pre-declared job; the caller then drives ``loop.run`` itself (the
        federated driver interleaves round control events) and collects the
        report with ``finish()``.  ``run()`` remains the one-shot path."""
        for wid in self.workers:
            self.loop.schedule(0.0, "register", wid)
        self.loop.schedule(self.heartbeat_period, "liveness", None)
        for job in self.jobs.values():
            self.loop.schedule(job.submit_time, "submit", job)

    def run(self) -> SimulationReport:
        self.start()
        end = self.loop.run(until=self.run_until)
        return self.finish(end)

    def finish(self, end: float | None = None) -> SimulationReport:
        if end is None:
            end = self.loop.now
        makespan = max((r.finish_time for r in self._results.values()), default=end)
        # noise ledger: retention of each completed circuit on its worker
        rets, reg = [], self.manager.task_registry
        for _, tid, wid in self.manager.assignments:
            task, w = reg.get(tid), self.workers.get(wid)
            if task is not None and w is not None and tid in self.manager.completed_ids:
                rets.append((1.0 - w.cfg.error_rate) ** task.depth)
        return SimulationReport(
            jobs=dict(self._results),
            total_circuits=self._total,
            makespan=makespan,
            assignments=list(self.manager.assignments),
            evictions=list(self.manager.evictions),
            worker_busy_time={wid: w.busy_time for wid, w in self.workers.items()},
            fidelity_retention=(sum(rets) / len(rets)) if rets else 1.0,
            rejected=self.rejected,
            gateway_summary=(
                self.gateway.telemetry.summary() if self.gateway is not None else None
            ),
            trace=(
                self.gateway.telemetry.trace if self.gateway is not None else None
            ),
        )


def _round_robin(tasks):
    """Interleave the queue across clients (fair multi-client service),
    preserving each client's internal order."""
    by_client: dict[str, list] = {}
    order: list[str] = []
    for task in tasks:
        if task.client_id not in by_client:
            by_client[task.client_id] = []
            order.append(task.client_id)
        by_client[task.client_id].append(task)
    out, i = [], 0
    while any(by_client.values()):
        cid = order[i % len(order)]
        if by_client[cid]:
            out.append(by_client[cid].pop(0))
        i += 1
    return out


def homogeneous_workers(n: int, max_qubits: int, **kw) -> list[WorkerConfig]:
    return [
        WorkerConfig(worker_id=f"w{i + 1}", max_qubits=max_qubits, **kw)
        for i in range(n)
    ]
