"""The quantum-classical co-Manager (paper Algorithm 2, line-by-line).

Four management modules:
  (1) co-Manager Initialization      — __init__ / bootstrap()
  (2) Quantum Worker Registration    — register_worker()      (lines 2-6)
  (3) Periodic Worker Management     — heartbeat() + liveness (lines 7-13)
  (4) Workload Assignment            — assign()               (lines 14-20)

Faithfulness notes:
* OR_w is recomputed from the heartbeat-reported active-circuit set
  (lines 8-9), AR_w = MR_w - OR_w (line 10), CRU_w(t+1) from the worker's
  "sys call" (line 11).
* A worker missing three consecutive heartbeats is evicted (lines 12-13).
* Assignment filters candidates by AR_w > D_c (STRICT inequality, as written
  on line 16), sorts ascending by most recent CRU (line 19) and returns the
  head (line 20).
* Between heartbeats the manager tracks its own assignments optimistically
  (it knows what it handed out) — otherwise it would over-commit a worker
  within one 5-second heartbeat period.  Completions are learned either
  eagerly (result return == completion, like the paper's RPC loop-back) or
  only at the next heartbeat (``eager_completion=False``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.comanager.worker import CircuitTask


@dataclasses.dataclass
class WorkerView:
    """The co-Manager's bookkeeping for one registered worker."""

    worker_id: str
    max_qubits: int  # MR_w
    reported_or: int = 0  # OR_w from last heartbeat
    reported_active: set = dataclasses.field(default_factory=set)
    cru: float = 0.0  # CRU_w(t) from last heartbeat
    last_heartbeat: float = 0.0
    missed_heartbeats: int = 0
    in_flight: dict = dataclasses.field(default_factory=dict)  # tid -> demand
    client_affinity: Optional[str] = None  # single-tenant mode ownership
    error_rate: float = 0.0  # beyond paper: reported gate error

    @property
    def occupied_qubits(self) -> int:
        return self.reported_or + sum(self.in_flight.values())

    @property
    def available_qubits(self) -> int:  # AR_w (line 10)
        return self.max_qubits - self.occupied_qubits


class CoManager:
    """``tenancy``:
    * "multi"          — circuits from any client co-reside on a worker up to
                         its qubit capacity (the paper's system);
    * "single_circuit" — one circuit occupies the entire machine at a time
                         ("one user occupies the entire machine while others
                         wait in a queue"), any client may use any machine
                         next — the Fig-6 single-tenant baseline;
    * "user_exclusive" — additionally a machine stays with one client until
                         that client's queue drains (IBM-Q-style account
                         exclusivity).
    """

    def __init__(
        self,
        *,
        eager_completion: bool = True,
        miss_limit: int = 3,
        multi_tenant: bool = True,
        tenancy: str | None = None,
        policy: str = "cru",
        fidelity_floor: float = 0.0,
    ):
        # (1) co-Manager Initialization (line 1)
        self.workers: dict[str, WorkerView] = {}  # W + MR dictionary
        self.pending: list[CircuitTask] = []  # client-submitted circuits
        self.miss_limit = miss_limit
        self.eager_completion = eager_completion
        if tenancy is None:
            tenancy = "multi" if multi_tenant else "user_exclusive"
        assert tenancy in ("multi", "single_circuit", "user_exclusive"), tenancy
        self.tenancy = tenancy
        self.multi_tenant = tenancy == "multi"
        # BEYOND PAPER: assignment policy.  "cru" = Algorithm 2 lines 18-19;
        # "noise_aware" sorts candidates by reported gate-error first (then
        # CRU) — addresses the paper's §V limitation #2.
        assert policy in ("cru", "noise_aware"), policy
        self.policy = policy
        # minimum acceptable (1-error)^depth per circuit: workers too noisy
        # for a given circuit DEPTH are not candidates (the circuit queues
        # for a cleaner machine instead) — runtime/fidelity trade-off knob.
        self.fidelity_floor = fidelity_floor
        self.assignments: list[tuple[float, int, str]] = []  # (t, task, worker)
        self.evictions: list[tuple[float, str]] = []
        self.task_registry: dict[int, CircuitTask] = {}
        self.completed_ids: set[int] = set()

    # ------------------------------------------------- (2) registration
    def register_worker(
        self,
        worker_id: str,
        max_qubits: int,
        cru: float,
        t: float,
        error_rate: float = 0.0,
    ) -> WorkerView:
        """Lines 2-6: join W; OR=0; AR=MR; record CRU."""
        v = WorkerView(
            worker_id=worker_id,
            max_qubits=max_qubits,
            cru=cru,
            last_heartbeat=t,
            error_rate=error_rate,
        )
        self.workers[worker_id] = v
        return v

    # --------------------------------------------- (3) periodic management
    def heartbeat(self, payload: dict, t: float) -> None:
        """Lines 7-11: recompute OR from the reported active set; AR; CRU."""
        v = self.workers.get(payload["worker_id"])
        if v is None:
            return  # stale heartbeat from an evicted worker
        active = payload["active"]
        completed = payload.get("completed", set())
        v.reported_or = sum(active.values())  # lines 8-9
        v.reported_active = set(active)
        # in-flight entries the worker now reports active (counted in OR) or
        # has finished are settled out of the optimistic ledger.
        v.in_flight = {
            tid: d
            for tid, d in v.in_flight.items()
            if tid not in active and tid not in completed
        }
        v.cru = payload["cru"]  # line 11
        v.error_rate = payload.get("error_rate", v.error_rate)
        v.last_heartbeat = t
        v.missed_heartbeats = 0
        self._maybe_release_affinity(v)

    def _maybe_release_affinity(self, v: WorkerView) -> None:
        """Single-tenant: free the machine once its client has drained."""
        if self.multi_tenant or v.client_affinity is None:
            return
        if v.occupied_qubits == 0 and not any(
            task.client_id == v.client_affinity for task in self.pending
        ):
            v.client_affinity = None

    def liveness_check(self, t: float, period: float) -> list[str]:
        """Lines 12-13: evict workers silent for ``miss_limit`` periods."""
        dead = []
        for wid, v in self.workers.items():
            missed = int((t - v.last_heartbeat) / period + 1e-9)
            v.missed_heartbeats = missed
            if missed >= self.miss_limit:
                dead.append(wid)
        for wid in dead:
            v = self.workers.pop(wid)
            self.evictions.append((t, wid))
            # circuits lost with the worker are requeued for reassignment
            lost = set(v.in_flight) | v.reported_active
            for tid in sorted(lost):
                task = self.task_registry.get(tid)
                if task is not None and tid not in self.completed_ids:
                    self.pending.insert(0, task)
        return dead

    # ------------------------------------------------- (4) workload assign
    def assign(
        self, task: CircuitTask, t: float, exclude: set | None = None
    ) -> Optional[str]:
        """Lines 14-20.  Returns the chosen worker id, or None (stays pending).

        ``exclude``: workers to skip for this call — used by the lockstep
        (Algorithm-1 round) dispatcher to hand at most one circuit per worker
        per round even while the CRU view is stale between heartbeats.

        Capacity predicate: the paper's pseudocode writes AR > D (strict), but
        its Fig 6 discussion ("worker-1, which only has 5 qubits, is useless
        to a 7-qubit circuit" — i.e. it IS usable by 5-qubit ones) requires
        exact fits to be schedulable, so we use AR >= D.

        Single-tenant baseline (multi_tenant=False) models the IBM-Q-style
        semantics the paper compares against: "one user occupies the entire
        machine while others wait in a queue" — at most one circuit resident
        per worker, and the worker stays with one client until its job drains.
        """
        held = None
        if self.tenancy == "user_exclusive":
            held = next(
                (
                    v
                    for v in self.workers.values()
                    if v.client_affinity == task.client_id
                ),
                None,
            )
        candidates = []
        for wid, v in self.workers.items():  # line 15
            if exclude and wid in exclude:
                continue
            if v.available_qubits >= task.demand:  # line 16 (see note)
                if (
                    self.policy == "noise_aware"
                    and self.fidelity_floor
                    and task.depth
                    and (1.0 - v.error_rate) ** task.depth < self.fidelity_floor
                ):
                    continue  # too noisy for this depth
                if not self.multi_tenant and v.occupied_qubits > 0:
                    continue  # machine fully occupied
                if self.tenancy == "user_exclusive":
                    if held is not None and v is not held:
                        continue  # one machine per client
                    if v.client_affinity not in (None, task.client_id):
                        continue  # others wait in queue
                candidates.append(v)  # line 17
        if not candidates:
            return None
        if self.policy == "noise_aware":
            candidates.sort(key=lambda v: (v.error_rate, v.cru, v.worker_id))
        else:
            candidates.sort(key=lambda v: (v.cru, v.worker_id))  # lines 18-19
        best = candidates[0]  # line 20
        best.in_flight[task.task_id] = task.demand
        if self.tenancy == "user_exclusive":
            best.client_affinity = task.client_id
        self.assignments.append((t, task.task_id, best.worker_id))
        return best.worker_id

    def complete(self, worker_id: str, task: CircuitTask, t: float) -> None:
        """Result looped back.  Eager mode frees capacity immediately."""
        self.completed_ids.add(task.task_id)
        v = self.workers.get(worker_id)
        if v is None:
            return
        if self.eager_completion:
            if task.task_id in v.in_flight:
                v.in_flight.pop(task.task_id)
            elif task.task_id in v.reported_active:
                # the last heartbeat counted it in OR; discount until refresh
                v.reported_active.discard(task.task_id)
                v.reported_or = max(0, v.reported_or - task.demand)
            self._maybe_release_affinity(v)

    # ------------------------------------------------------------- queue
    def submit(self, task: CircuitTask) -> None:
        self.task_registry[task.task_id] = task
        self.pending.append(task)

    def drain_pending(self, t: float, start_fn) -> int:
        """Try to place pending circuits (FIFO).  ``start_fn(task, wid)``
        actually launches the circuit.  Returns number placed."""
        placed = 0
        remaining: list[CircuitTask] = []
        for task in self.pending:
            wid = self.assign(task, t)
            if wid is None:
                remaining.append(task)
            else:
                start_fn(task, wid)
                placed += 1
        self.pending = remaining
        return placed
