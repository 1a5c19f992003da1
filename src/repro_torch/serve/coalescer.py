"""Cross-tenant circuit-bank coalescing.

The fused statevector kernel executes a batch of structurally identical
circuits (same gate sequence, per-lane angles) in one launch, so one launch
of many circuits costs far less than as many launches of one.  The
coalescer exploits that: circuits submitted by *different* tenants are keyed
by circuit structure and packed into shared mega-batches, so a worker
dispatch carries up to ``target`` circuits instead of one.

Flush policy is size-or-deadline:
  * size   — the moment a key's buffer reaches ``target`` circuits (a
             multiple of ``lanes``), a full batch is emitted;
  * deadline — a buffered circuit never waits longer than ``deadline``
             (bounded latency under light load: partial batches are emitted
             when their oldest member ages out).  An item may carry its own
             earlier ``flush_by`` (SLO-aware gateways set it from the
             tenant's latency SLO): a buffer's effective flush deadline is
             the MIN over its members, so one latency-sensitive circuit
             pulls the whole shared batch forward.

Keys are any hashable: the real data plane uses the ``CircuitSpec`` itself
(frozen dataclass — hash == structural identity), the virtual-clock
simulation uses ``(demand, service_time, depth)`` tuples.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Hashable, Optional

#: the serving layer's lane width: coalescing targets, ``padded()``, cost
#: units, lane fill and telemetry count in lanes of 128, the reference's
#: TPU lane, so that batches and counters match the reference's.  It is not
#: the kernels' width: ``repro_torch.kernels.vqc_statevector.LANES`` is a
#: warp (32), and the dispatcher launches only a batch's real rows
#: (``repro_torch.serve.dispatcher.execute_batch``).
LANES = 128


@dataclasses.dataclass
class PendingCircuit:
    """One admitted circuit waiting to be coalesced."""
    key: Hashable
    client_id: str
    seq: int              # gateway-wide admission sequence number
    arrival: float
    payload: Any          # (theta_row, data_row) | simulation CircuitTask
    future: Any = None    # CircuitFuture in the real data plane
    lanes: int = 1        # kernel lanes this item occupies (a shift-group
                          # subtask covers its bank's B sample lanes)
    flush_by: Optional[float] = None  # SLO-derived flush deadline; None ->
                                      # default (arrival + deadline)
    origin: Any = None    # (ready event, stream) of a submitter on a CUDA
                          # device: the async dispatcher's slot stream waits
                          # on the event before it reads the payload


@dataclasses.dataclass
class CoalescedBatch:
    """A lane-packable unit of work: all members share ``key``."""
    key: Hashable
    members: list[PendingCircuit]
    created: float
    by_deadline: bool = False

    @property
    def n(self) -> int:
        return len(self.members)

    @property
    def lane_count(self) -> int:
        """Kernel lanes the members actually occupy (== n for row circuits)."""
        return sum(m.lanes for m in self.members)

    def padded(self, lanes: int = LANES) -> int:
        """Lanes the kernel launch actually pays for.

        Row circuits share lane rows, so the batch pads once as a whole; a
        multi-lane member (shift-group subtask) gets its own kernel rows and
        pads its B sample lanes independently."""
        if all(m.lanes == 1 for m in self.members):
            return math.ceil(self.n / lanes) * lanes
        return sum(math.ceil(m.lanes / lanes) * lanes for m in self.members)

    @property
    def lane_fill(self) -> float:
        return self.lane_count / self.padded()

    def clients(self) -> set[str]:
        return {m.client_id for m in self.members}


class Coalescer:
    def __init__(
        self,
        *,
        target: int = LANES,
        deadline: float = 1.0,
        lanes: int = LANES,
        target_lanes: int | None = None,
    ):
        if target % lanes:
            raise ValueError(f"target {target} must be a multiple of lanes {lanes}")
        self.target = target
        self.deadline = deadline
        self.lanes = lanes
        #: optional LANE-weighted size trigger: a buffer whose members
        #: occupy this many kernel lanes flushes even below ``target``
        #: members.  Row circuits occupy one lane each, so member count is
        #: the right measure for them — but a shift-group subtask occupies
        #: its bank's B sample lanes, and a buffer of a few dozen such
        #: members can already be a multi-thousand-lane fused launch.
        self.target_lanes = target_lanes
        self._buffers: dict[Hashable, list[PendingCircuit]] = {}

    # ------------------------------------------------------------- intake
    def _size_due(self, buf: list[PendingCircuit]) -> int:
        """Members to emit for a size-triggered flush (0 = not due)."""
        if len(buf) >= self.target:
            return self.target
        if self.target_lanes is not None:
            filled = 0
            for i, m in enumerate(buf):
                filled += m.lanes
                if filled >= self.target_lanes:
                    return i + 1
        return 0

    def add(self, item: PendingCircuit) -> list[CoalescedBatch]:
        """Buffer one circuit; returns any size-triggered full batches."""
        buf = self._buffers.setdefault(item.key, [])
        buf.append(item)
        out = []
        while True:
            n = self._size_due(buf)
            if not n:
                break
            out.append(CoalescedBatch(item.key, buf[:n], created=item.arrival))
            del buf[:n]
        return out

    def requeue(self, batch: CoalescedBatch) -> None:
        """Return a failed batch's members to the FRONT of their buffer
        (eviction recovery).  Their original arrival times are kept, so the
        deadline policy flushes them promptly, possibly merged with newer
        arrivals — the batch is genuinely re-coalesced, not replayed."""
        buf = self._buffers.setdefault(batch.key, [])
        buf[:0] = batch.members

    def _due_at(self, buf: list[PendingCircuit]) -> float:
        """Effective flush deadline of one buffer: min over members of their
        SLO-derived ``flush_by`` (falling back to arrival + deadline)."""
        return min(
            m.arrival + self.deadline if m.flush_by is None else m.flush_by
            for m in buf
        )

    # -------------------------------------------------------------- flush
    def flush_due(self, now: float) -> list[CoalescedBatch]:
        """Emit partial batches whose flush deadline has passed (the oldest
        member aged out, or a member's SLO budget ran down)."""
        out = []
        for key, buf in self._buffers.items():
            if buf and now + 1e-12 >= self._due_at(buf):
                out.append(
                    CoalescedBatch(
                        key, buf[: self.target], created=now, by_deadline=True
                    )
                )
                del buf[: self.target]
        self._drop_empty()
        return out

    def flush_all(self, now: float) -> list[CoalescedBatch]:
        """Drain everything (end of a bank / shutdown)."""
        out = []
        for key, buf in self._buffers.items():
            while buf:
                out.append(
                    CoalescedBatch(
                        key, buf[: self.target], created=now, by_deadline=True
                    )
                )
                del buf[: self.target]
        self._drop_empty()
        return out

    def _drop_empty(self) -> None:
        """Retire emptied buffers: single-use keys (one per submitted
        ShiftBank) would otherwise accumulate forever and every pump scans
        the whole dict."""
        for key in [k for k, buf in self._buffers.items() if not buf]:
            del self._buffers[key]

    # ---------------------------------------------------------- inspection
    def next_deadline(self) -> Optional[float]:
        """Earliest time at which some buffered circuit must be flushed."""
        dues = [self._due_at(buf) for buf in self._buffers.values() if buf]
        return min(dues) if dues else None

    @property
    def buffered(self) -> int:
        return sum(len(b) for b in self._buffers.values())

    @property
    def buffered_lanes(self) -> int:
        """Lane-weighted buffer depth: kernel lanes the buffered circuits
        will occupy when flushed (== ``buffered`` for row circuits; a
        shift-group subtask weighs its bank's sample width).  The depth
        metric the observability layer samples each pump."""
        return sum(m.lanes for b in self._buffers.values() for m in b)

    def oldest_wait(self, now: float) -> float:
        """Age of the oldest buffered circuit (0.0 when empty)."""
        arrivals = [m.arrival for b in self._buffers.values() for m in b]
        return now - min(arrivals) if arrivals else 0.0
