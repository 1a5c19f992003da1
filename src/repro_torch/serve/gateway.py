"""Online serving gateway: admission, fairness, backpressure, SLOs.

Streaming circuit submissions from many concurrent clients enter per-client
FIFO queues; a two-level scheduler feeds the cross-tenant coalescer:

  * strict PRIORITY tiers — a lower ``priority`` number is served strictly
    first; tier 0 (interactive/latency-critical) always preempts tier 1
    (batch training), which preempts tier 2, and so on;
  * weighted-fair STRIDE within a tier — each dequeue advances the client's
    virtual pass by ``1/weight``; the eligible client with the smallest pass
    goes next.

SLO-aware deadlines: a tenant registered with ``slo_ms`` gives every one of
its circuits a flush budget of ``SLO_FLUSH_FRACTION`` of the SLO (the rest
is reserved for placement + kernel execution); the coalescer flushes a
shared buffer at the MIN of its members' budgets, so one latency-sensitive
tenant pulls the whole cross-tenant batch forward.  Deadline misses are
counted per tenant in ``Telemetry`` (``slo_attainment``).

Backpressure is two-level, both bounded per tenant:
  * ``max_pending``   — admission queue depth; a client that outruns the
    system gets ``Backpressure`` raised at ``submit`` (shed load / slow the
    stream) instead of growing memory without bound;
  * ``max_in_flight`` — circuits dequeued-but-not-completed; a client at its
    cap is skipped by the fair scheduler until results return, so one heavy
    tenant cannot monopolize the coalescer's buffers either.

A third, GLOBAL bound arms calibrated admission control: with
``max_system_pending`` set (see ``repro_torch.scale.knee.calibrate_admission`` —
knee throughput x knee p99 x slack, per Little's law), once the total
OUTSTANDING count (queued + dequeued-but-not-completed, i.e. every admitted
circuit still inside the system) reaches the cap, a submit is rejected when
the tenant already holds its weighted share of the cap (floored at one
circuit, so light interactive tenants retain liveness while the heavy
hitters above their share shed).  Past the saturation knee this converts
unbounded queueing — certain SLO misses — into prompt ``Backpressure``.

The gateway is clock-agnostic: every entry point takes ``now`` (virtual
seconds under the simulation's event loop, ``time.perf_counter()`` in the
real data plane).

Thread safety: all mutating entry points (``submit``, ``pump``, ``flush``,
``complete``, ``fail``, ``requeue``) take an internal re-entrant lock, so
the async dispatcher's pump loop and worker-pool completion threads can run
concurrently with user threads calling ``submit``.  ``CircuitFuture``
resolution is single-assignment behind that lock; ``CircuitFuture.result``
blocks on an event and is safe to call from any thread.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
import threading
from collections import deque
from typing import Any, Hashable, Optional

from repro_torch.serve.coalescer import LANES, Coalescer, CoalescedBatch, PendingCircuit
from repro_torch.serve.metrics import Telemetry

#: fraction of a tenant's latency SLO spent waiting in the coalescer; the
#: remainder is budget for placement + kernel execution + scatter-back.
SLO_FLUSH_FRACTION = 0.5


class Backpressure(RuntimeError):
    """Raised when a tenant's admission queue is full."""


class DeadlineExceeded(RuntimeError):
    """A circuit's full SLO budget elapsed before execution and it was
    preemptively evicted from the ready queue (load shedding: finishing it
    could only produce an already-missed result while delaying others)."""


class CircuitFuture:
    """Single-assignment result slot for one submitted circuit.

    Under the async dispatcher, futures resolve out of submission order from
    worker-pool threads: ``done``/``value`` stay cheap for polling loops, and
    ``result(timeout)`` blocks on an event for cross-thread waits.  A failed
    batch execution resolves its futures with ``set_error``; reading them
    re-raises the execution error in the waiting thread.
    """

    __slots__ = (
        "client_id",
        "seq",
        "submit_time",
        "_value",
        "_error",
        "done",
        "_event",
    )

    def __init__(self, client_id: str, seq: int, submit_time: float):
        self.client_id = client_id
        self.seq = seq
        self.submit_time = submit_time
        self._value = None
        self._error = None
        self.done = False
        self._event = threading.Event()

    def set(self, value) -> None:
        assert not self.done, f"future {self.seq} resolved twice"
        self._value = value
        self.done = True
        self._event.set()

    def set_error(self, exc: BaseException) -> None:
        assert not self.done, f"future {self.seq} resolved twice"
        self._error = exc
        self.done = True
        self._event.set()

    @property
    def value(self):
        if not self.done:
            raise RuntimeError(f"circuit {self.seq} not completed yet")
        if self._error is not None:
            raise self._error
        return self._value

    def result(self, timeout: float | None = None):
        """Block until resolved; returns the value or re-raises the batch's
        execution error."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"circuit {self.seq} not completed within {timeout}s"
            )
        return self.value


@dataclasses.dataclass
class TenantState:
    weight: float = 1.0
    priority: int = 1     # strict tier: lower value = served strictly first
    slo_s: Optional[float] = None  # end-to-end latency SLO (None: best-effort)
    max_pending: int = 100_000
    max_in_flight: int = 100_000
    queue: deque = dataclasses.field(default_factory=deque)
    in_flight: int = 0
    vpass: float = 0.0    # stride-scheduling virtual pass (within its tier)
    #: the (priority, vpass, cid) entry currently live in the scheduler heap
    #: for this tenant, or None; compared by IDENTITY so popped entries from
    #: an earlier registration can never masquerade as current.
    heap_key: Optional[tuple] = dataclasses.field(default=None, repr=False)


class Gateway:
    def __init__(
        self,
        *,
        target: int | None = None,
        deadline: float = 1.0,
        lanes: int | None = None,
        target_lanes: int | None = None,
        max_pending: int = 100_000,
        max_in_flight: int = 100_000,
        max_system_pending: int | None = None,
        max_pending_per_tier: dict[int, int] | None = None,
        telemetry: Telemetry | None = None,
    ):
        lanes = lanes or LANES
        self.coalescer = Coalescer(
            target=target or lanes,
            deadline=deadline,
            lanes=lanes,
            target_lanes=target_lanes,
        )
        self.telemetry = telemetry or Telemetry(lanes=lanes)
        self._defaults = dict(max_pending=max_pending, max_in_flight=max_in_flight)
        self.max_system_pending = max_system_pending
        # per-priority-tier admission caps: the global weighted-fair cap
        # alone still lets a low-tier burst consume headroom a high tier
        # needs between refresh points; a tier cap bounds each tier's
        # outstanding circuits (queued + in flight) independently, shedding
        # weighted-fair WITHIN the tier.
        for tier, tier_cap in (max_pending_per_tier or {}).items():
            if tier_cap < 1:
                raise ValueError(
                    f"max_pending_per_tier[{tier}] must be >= 1, got {tier_cap}"
                )
        self.max_pending_per_tier = dict(max_pending_per_tier or {})
        self._tier_outstanding: dict[int, int] = {}
        self._tier_weight: dict[int, float] = {}
        self.tenants: dict[str, TenantState] = {}
        self._seq = 0
        # scheduler heap of (priority, vpass, cid): every ELIGIBLE tenant
        # (non-empty queue, below its in-flight cap) has exactly one entry
        # carrying its current pass; stale entries are invalidated lazily on
        # pop via the tenant's ``heap_key`` identity marker.  Makes the fair
        # dequeue O(log T) instead of an O(T) scan — the difference between
        # minutes and hours on a 10k-tenant storm.
        self._heap: list[tuple] = []
        self._pending_total = 0     # sum of all tenant queue depths
        self._inflight_total = 0    # sum of all tenant in-flight counts
        self._weight_total = 0.0    # sum of registered tenant weights
        # min vpass per priority tier, for O(1) late-joiner placement; an
        # entry goes None (dirty -> recompute on next use) when the tenant
        # that owned the minimum advances its pass.
        self._tier_vmin: dict[int, float | None] = {}
        # serializes queue/coalescer/telemetry mutation against the async
        # dispatcher's pump + completion threads; re-entrant because flush()
        # pumps and submit() may auto-register under the same lock.
        self._lock = threading.RLock()
        # the latest time a submission or requeue was stamped with: see
        # _not_before
        self._latest = -math.inf

    # ---------------------------------------------------------- admission
    def register_client(
        self,
        client_id: str,
        *,
        weight: float = 1.0,
        priority: int = 1,
        slo_ms: float | None = None,
        max_pending: int | None = None,
        max_in_flight: int | None = None,
    ) -> TenantState:
        """``priority``: strict scheduling tier (lower = first).  ``slo_ms``:
        end-to-end latency SLO; shortens the coalescer flush deadline for
        this tenant's circuits and arms deadline-miss accounting."""
        with self._lock:
            st = TenantState(
                weight=weight,
                priority=priority,
                slo_s=None if slo_ms is None else slo_ms / 1e3,
                max_pending=max_pending or self._defaults["max_pending"],
                max_in_flight=max_in_flight or self._defaults["max_in_flight"],
            )
            # a late joiner starts at the current minimum virtual pass OF ITS
            # TIER — not 0, which would hand it absolute priority within the
            # tier until it "caught up" with tenants served for a while.
            vmin = self._tier_vmin.get(priority)
            if vmin is None:
                vmin = min(
                    (t.vpass for t in self.tenants.values() if t.priority == priority),
                    default=0.0,
                )
            st.vpass = vmin
            self._tier_vmin[priority] = vmin  # joiner AT the min keeps it exact
            prev = self.tenants.get(client_id)
            if prev is not None:  # re-registration replaces the old state
                self._weight_total -= prev.weight
                self._pending_total -= len(prev.queue)
                self._inflight_total -= prev.in_flight
                self._tier_weight[prev.priority] -= prev.weight
                self._tier_outstanding[prev.priority] = self._tier_outstanding.get(
                    prev.priority, 0
                ) - (len(prev.queue) + prev.in_flight)
                if prev.priority != priority:
                    self._tier_vmin[prev.priority] = None
            self._weight_total += weight
            self._tier_weight[priority] = (
                self._tier_weight.get(priority, 0.0) + weight
            )
            self.tenants[client_id] = st
            self._mark_ready(client_id, st)
            self.telemetry.set_slo(client_id, st.slo_s)
            return st

    def _tenant(self, client_id: str) -> TenantState:
        st = self.tenants.get(client_id)
        if st is None:
            st = self.register_client(client_id)
        return st

    def submit(
        self,
        client_id: str,
        key: Hashable,
        payload: Any,
        now: float,
        lanes: int = 1,
        origin: Any = None,
    ) -> CircuitFuture:
        """Admit one circuit.  Raises ``Backpressure`` at the queue bound.

        ``lanes``: kernel lanes the item occupies (1 for a row circuit; a
        shift-group subtask covers its bank's B sample lanes) — feeds the
        lane-fill telemetry, not admission accounting.  ``origin``: see
        ``PendingCircuit.origin`` (``GatewayRuntime`` sets it)."""
        with self._lock:
            st = self._tenant(client_id)
            if len(st.queue) >= st.max_pending:
                self.telemetry.on_reject(client_id)
                self.telemetry.trace.circuit_reject(self._seq, client_id, key, now)
                raise Backpressure(
                    f"{client_id}: {len(st.queue)} pending >= {st.max_pending}"
                )
            cap = self.max_system_pending
            outstanding = self._pending_total + self._inflight_total
            if cap is not None and outstanding >= cap:
                # system saturated (every admitted circuit still inside it
                # counts — queued OR in flight): shed from tenants at/above
                # their weighted share of the cap (floored at one circuit,
                # so light tenants keep liveness while the hitters above
                # share take the hit).
                share = max(1.0, cap * st.weight / max(self._weight_total, 1e-9))
                mine = len(st.queue) + st.in_flight
                if mine + 1 > share:
                    self.telemetry.on_reject(client_id)
                    self.telemetry.trace.circuit_reject(
                        self._seq, client_id, key, now
                    )
                    raise Backpressure(
                        f"{client_id}: system at admission cap "
                        f"({outstanding} >= {cap}) and tenant above its "
                        f"weighted share ({mine} >= {share:.1f})"
                    )
            tier_cap = self.max_pending_per_tier.get(st.priority)
            if tier_cap is not None:
                tier_out = self._tier_outstanding.get(st.priority, 0)
                if tier_out >= tier_cap:
                    # tier saturated: shed weighted-fair WITHIN the tier
                    # (same floor-at-one rule as the global cap), so one
                    # tier's burst can never consume another tier's headroom
                    tier_w = max(self._tier_weight.get(st.priority, 0.0), 1e-9)
                    share = max(1.0, tier_cap * st.weight / tier_w)
                    mine = len(st.queue) + st.in_flight
                    if mine + 1 > share:
                        self.telemetry.on_reject(client_id)
                        self.telemetry.trace.circuit_reject(
                            self._seq, client_id, key, now
                        )
                        raise Backpressure(
                            f"{client_id}: tier {st.priority} at admission "
                            f"cap ({tier_out} >= {tier_cap}) and tenant "
                            f"above its weighted share ({mine} >= "
                            f"{share:.1f})"
                        )
            fut = CircuitFuture(client_id, self._seq, now)
            flush_by = (
                None
                if st.slo_s is None
                else now
                + min(self.coalescer.deadline, SLO_FLUSH_FRACTION * st.slo_s)
            )
            st.queue.append(
                PendingCircuit(
                    key=key,
                    client_id=client_id,
                    seq=self._seq,
                    arrival=now,
                    payload=payload,
                    future=fut,
                    lanes=lanes,
                    flush_by=flush_by,
                    origin=origin,
                )
            )
            self._seq += 1
            self._latest = max(self._latest, now)
            self._pending_total += 1
            self._tier_outstanding[st.priority] = (
                self._tier_outstanding.get(st.priority, 0) + 1
            )
            self._mark_ready(client_id, st)
            self.telemetry.on_submit(client_id, now)
            self.telemetry.trace.circuit_submit(
                fut.seq, client_id, key, now, queue_depth=len(st.queue)
            )
            return fut

    # ------------------------------------------------- fair dequeue + pump
    def _mark_ready(self, cid: str, st: TenantState) -> None:
        """Arm the tenant's scheduler-heap entry if it is eligible for
        dequeue and has none live.  ``heap_key`` holds the live entry (by
        identity); priority/vpass only change while no entry is live, so a
        live entry always carries the tenant's current pass."""
        if st.heap_key is None and st.queue and st.in_flight < st.max_in_flight:
            entry = (st.priority, st.vpass, cid)
            st.heap_key = entry
            heapq.heappush(self._heap, entry)

    def _next_client(self) -> Optional[str]:
        """Two-level pick: strict priority tier first, then smallest virtual
        pass within the tier (weighted fair); ties break on client id for
        determinism.  O(log T) heap pop with lazy invalidation — entries
        that no longer match their tenant's ``heap_key`` (superseded) or
        whose tenant turned ineligible are discarded; every eligible tenant
        has a current entry, so the first live hit IS the global minimum,
        exactly what the old O(T) scan returned."""
        while self._heap:
            entry = heapq.heappop(self._heap)
            st = self.tenants.get(entry[2])
            if st is None or entry is not st.heap_key:
                continue  # stale: superseded or from a dead registration
            st.heap_key = None  # consumed; caller re-arms after the dequeue
            if st.queue and st.in_flight < st.max_in_flight:
                return entry[2]
            # current but ineligible (drained / at in-flight cap): drop it;
            # submit()/complete()/fail()/evict() re-arm on state change.
        return None

    def pump(self, now: float) -> list[CoalescedBatch]:
        """Move admitted circuits into the coalescer in priority-then-fair
        order, then collect size-triggered and deadline-due batches."""
        with self._lock:
            now = self._not_before(now)
            tr = self.telemetry.trace
            batches: list[CoalescedBatch] = []
            while True:
                cid = self._next_client()
                if cid is None:
                    break
                st = self.tenants[cid]
                item = st.queue.popleft()
                self._pending_total -= 1
                vmin = self._tier_vmin.get(st.priority)
                if vmin is not None and st.vpass <= vmin:
                    # the tier minimum may have advanced: recompute lazily
                    self._tier_vmin[st.priority] = None
                st.vpass += 1.0 / st.weight
                st.in_flight += 1
                self._inflight_total += 1
                self._mark_ready(cid, st)
                tr.circuit_stage(item.seq, "admit", now)
                batches.extend(self.coalescer.add(item))
            batches.extend(self.coalescer.flush_due(now))
            for b in batches:
                self.telemetry.on_batch(
                    b.lane_count,
                    padded=b.padded(self.coalescer.lanes),
                    by_deadline=b.by_deadline,
                )
                if tr.enabled:
                    tr.batch_stage((m.seq for m in b.members), "coalesced", now)
            tr.coalescer_sample(
                self.coalescer.buffered, self.coalescer.buffered_lanes
            )
            return batches

    def flush(self, now: float) -> list[CoalescedBatch]:
        """pump() then force-drain every partial buffer (end of a bank)."""
        with self._lock:
            now = self._not_before(now)
            batches = self.pump(now)
            forced = self.coalescer.flush_all(now)
            tr = self.telemetry.trace
            for b in forced:
                self.telemetry.on_batch(
                    b.lane_count,
                    padded=b.padded(self.coalescer.lanes),
                    by_deadline=b.by_deadline,
                )
                if tr.enabled:
                    tr.batch_stage((m.seq for m in b.members), "coalesced", now)
            return batches + forced

    def _not_before(self, now: float) -> float:
        """``now``, raised to the latest submission or requeue time (caller
        holds the lock).  The async pump reads its clock before it takes the
        lock, so a circuit submitted or requeued from another thread in
        between carries a later time than the pump's: without the raise it
        would be admitted or re-coalesced before it arrived, and its trace
        would run backwards.  Callers on one thread with a monotone clock
        never see a difference."""
        return max(now, self._latest)

    # ------------------------------------------------------------ results
    def complete(self, batch: CoalescedBatch, values, now: float) -> None:
        """Scatter one executed batch's fidelities back to its futures, in
        member (submission) order.  ``values`` may be None in clock-only
        runtimes (simulation) where there is no fidelity payload."""
        with self._lock:
            for i, m in enumerate(batch.members):
                st = self.tenants[m.client_id]
                if st.in_flight > 0:
                    st.in_flight -= 1
                    self._inflight_total -= 1
                    self._tier_outstanding[st.priority] = (
                        self._tier_outstanding.get(st.priority, 1) - 1
                    )
                self._mark_ready(m.client_id, st)
                if m.future is not None:
                    m.future.set(values[i] if values is not None else None)
                self.telemetry.on_complete(m.client_id, m.arrival, now)
                self.telemetry.trace.circuit_end(m.seq, "complete", now)

    def fail(self, batch: CoalescedBatch, exc: BaseException, now: float) -> None:
        """Resolve a batch whose execution errored: every member future
        re-raises ``exc``; tenant in-flight accounting is released so the
        scheduler is not wedged by a poisoned batch."""
        with self._lock:
            for m in batch.members:
                st = self.tenants[m.client_id]
                if st.in_flight > 0:
                    st.in_flight -= 1
                    self._inflight_total -= 1
                    self._tier_outstanding[st.priority] = (
                        self._tier_outstanding.get(st.priority, 1) - 1
                    )
                self._mark_ready(m.client_id, st)
                if m.future is not None:
                    m.future.set_error(exc)
                self.telemetry.trace.circuit_end(m.seq, "fail", now)

    def evict(self, batch: CoalescedBatch, now: float) -> None:
        """Preemptively shed a batch whose members' SLO budgets fully
        elapsed before placement: every future resolves with
        ``DeadlineExceeded`` (already a guaranteed miss) and the misses are
        accounted per tenant, freeing the ready queue for work that can
        still make its deadline."""
        with self._lock:
            for m in batch.members:
                st = self.tenants[m.client_id]
                if st.in_flight > 0:
                    st.in_flight -= 1
                    self._inflight_total -= 1
                    self._tier_outstanding[st.priority] = (
                        self._tier_outstanding.get(st.priority, 1) - 1
                    )
                self._mark_ready(m.client_id, st)
                if m.future is not None:
                    m.future.set_error(
                        DeadlineExceeded(
                            f"circuit {m.seq} ({m.client_id}): SLO budget "
                            f"elapsed after {now - m.arrival:.3f}s in queue"
                        )
                    )
                self.telemetry.on_evict(m.client_id)
                self.telemetry.trace.circuit_end(m.seq, "evict", now)

    def requeue(self, batch: CoalescedBatch, now: float | None = None) -> None:
        """Return a failed (evicted-worker) batch for re-coalescing; the
        members keep their futures and original arrivals, so nothing is
        dropped and the deadline policy re-emits them promptly.  They remain
        counted in-flight: they never went back through admission."""
        with self._lock:
            if now is not None:
                self._latest = max(self._latest, now)
            self.coalescer.requeue(batch)
            self.telemetry.on_requeue(len(batch.members))
            tr = self.telemetry.trace
            if now is not None and tr.enabled:
                tr.batch_stage((m.seq for m in batch.members), "requeue", now)

    # --------------------------------------------------------- inspection
    def next_deadline(self) -> Optional[float]:
        with self._lock:
            return self.coalescer.next_deadline()

    @property
    def idle(self) -> bool:
        """True when nothing is queued or buffered (in-flight may remain).
        O(1) via the pending counter — this is polled once per completion,
        so an O(T) tenant scan would dominate storm-scale simulations."""
        with self._lock:
            return self.coalescer.buffered == 0 and self._pending_total == 0
