"""Federated aggregation rounds: the timing-agnostic coordinator core.

``FederatedCoordinator`` owns the global parameter tree and the round state
machine; it never looks at a clock of its own — every transition takes a
caller-supplied ``now`` (virtual seconds under the simulation driver,
``perf_counter`` seconds in a live deployment), which is what makes the
whole loop bit-deterministic on the virtual clock.

Round protocol (driver's calls in order):

    begin_round(r, now, participants)   # opens the round, traces round_start
    status = offer(tenant, update, now) # per arriving update:
                                        #   participated / late_folded /
                                        #   late_dropped / nan_rejected
    quorum_reached() / all_arrived()    # close-condition queries
    record = close_round(now)           # FedAvg (+ folds, masks, DP noise),
                                        #   applies the aggregate, traces
                                        #   round_aggregated

Aggregation is weighted FedAvg over parameter-DELTA trees (local params
minus the round's starting global params): on-time updates carry their
tenant weight, folded late updates from earlier rounds carry
``weight * staleness_alpha ** rounds_late``.  All arithmetic is numpy
float64, so secure-aggregation mask cancellation stays ~1e-12.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

from repro_torch.federated.config import FederatedConfig
from repro_torch.federated.secure import (
    PrivacyAccountant,
    clip_update,
    gaussian_noise,
    pairwise_masks,
)

#: update trees are dicts of arrays (the ``quclassi.init_params`` layout);
#: flat float64 vectors are the aggregation/masking currency.
ParamTree = dict


def tree_flatten(tree: ParamTree) -> np.ndarray:
    """Concatenate a param tree's leaves (sorted by key) into float64."""
    return np.concatenate(
        [np.asarray(tree[k], dtype=np.float64).ravel() for k in sorted(tree)]
    )


def tree_unflatten(vec: np.ndarray, like: ParamTree) -> ParamTree:
    """Inverse of ``tree_flatten`` against a template tree's shapes."""
    out, i = {}, 0
    for k in sorted(like):
        a = np.asarray(like[k])
        n = a.size
        out[k] = vec[i:i + n].reshape(a.shape)
        i += n
    assert i == vec.size, (i, vec.size)
    return out


@dataclasses.dataclass
class _Fold:
    """A late update carried into a future round's aggregate."""

    tenant: str
    round_idx: int  # the round it trained against
    vec: np.ndarray
    weight: float


@dataclasses.dataclass
class RoundRecord:
    """One closed aggregation round, for ``FederatedReport``."""

    round_idx: int
    started_at: float
    closed_at: float
    deadline: Optional[float]
    participants: list[str]
    on_time: list[str]
    folded: list[str]  # late updates from EARLIER rounds folded in here
    nan_rejected: list[str]
    quorum_wait_s: float
    update_norm: float
    mean_update_norm: float
    weight_total: float

    @property
    def duration_s(self) -> float:
        return self.closed_at - self.started_at

    def to_dict(self) -> dict:
        return {
            "round": self.round_idx,
            "started_at": round(self.started_at, 9),
            "closed_at": round(self.closed_at, 9),
            "deadline": None if self.deadline is None else round(self.deadline, 9),
            "participants": list(self.participants),
            "on_time": list(self.on_time),
            "folded": list(self.folded),
            "nan_rejected": list(self.nan_rejected),
            "quorum_wait_s": round(self.quorum_wait_s, 9),
            "update_norm": round(self.update_norm, 9),
            "mean_update_norm": round(self.mean_update_norm, 9),
        }


@dataclasses.dataclass
class FederatedReport:
    """What a federated run hands back: the final global parameters, the
    per-round records, convergence telemetry, and the privacy ledger."""

    config: FederatedConfig
    params: ParamTree
    rounds: list[RoundRecord]
    #: resolution counts per tenant: participated / late / dropped
    participation: dict[str, dict[str, int]]
    #: accuracy after each round on a held-out set (session layer fills it
    #: in when an eval_fn is configured; empty otherwise).
    accuracy_by_round: list[float] = dataclasses.field(default_factory=list)
    privacy: Optional[dict] = None
    #: the underlying SimulationReport when the run was driven on the
    #: virtual clock (None for pure in-process runs).
    simulation: object | None = None

    @property
    def total_seconds(self) -> float:
        if not self.rounds:
            return 0.0
        return self.rounds[-1].closed_at - self.rounds[0].started_at

    @property
    def rounds_per_second(self) -> float:
        return len(self.rounds) / max(self.total_seconds, 1e-9)

    @property
    def quorum_wait_share(self) -> float:
        """Share of total round time spent holding the round open after the
        first on-time update had already arrived — the straggler tax the
        quorum + deadline policy exists to bound."""
        total = sum(r.duration_s for r in self.rounds)
        wait = sum(r.quorum_wait_s for r in self.rounds)
        return wait / max(total, 1e-9)

    def summary(self) -> dict:
        out = {
            "rounds": len(self.rounds),
            "total_seconds": round(self.total_seconds, 6),
            "rounds_per_second": round(self.rounds_per_second, 6),
            "quorum_wait_share": round(self.quorum_wait_share, 6),
            "participation": {
                t: dict(c) for t, c in sorted(self.participation.items())
            },
            "round_records": [r.to_dict() for r in self.rounds],
        }
        if self.accuracy_by_round:
            out["accuracy_by_round"] = [
                round(a, 6) for a in self.accuracy_by_round
            ]
        if self.privacy is not None:
            out["privacy"] = self.privacy
        return out


class FederatedCoordinator:
    """Gateway-side aggregation-round state machine (see module docstring).

    ``weights``: per-tenant FedAvg weight (only used when
    ``config.weighted``; defaults to 1.0).  ``telemetry`` /
    ``trace``: optional ``repro_torch.serve.metrics.Telemetry`` and
    ``repro_torch.obs.TraceRecorder`` hooks — participation counters and
    ``FEDERATED_STAGES`` round events flow through them when given.
    """

    def __init__(
        self,
        config: FederatedConfig,
        params: ParamTree,
        *,
        weights: Optional[dict[str, float]] = None,
        telemetry=None,
        trace=None,
    ):
        self.config = config
        self.params = {
            k: np.asarray(v, dtype=np.float64) for k, v in params.items()
        }
        self.weights = dict(weights or {})
        self.telemetry = telemetry
        self.trace = trace if trace is not None else getattr(
            telemetry, "trace", None
        )
        self.accountant = PrivacyAccountant()
        self.records: list[RoundRecord] = []
        self.participation: dict[str, dict[str, int]] = {}
        # ---- open-round state
        self.round_idx: int = -1
        self.open = False
        self._started_at = 0.0
        self._deadline: Optional[float] = None
        self._participants: list[str] = []
        self._arrived: dict[str, np.ndarray] = {}  # on-time, in arrival order
        self._first_arrival: Optional[float] = None
        self._nan_rejected: list[str] = []
        self._folds: list[_Fold] = []  # late updates awaiting the next close

    # -------------------------------------------------------------- helpers
    def _weight(self, tenant: str) -> float:
        return self.weights.get(tenant, 1.0) if self.config.weighted else 1.0

    def _count(self, tenant: str, status: str) -> None:
        c = self.participation.setdefault(
            tenant, {"participated": 0, "late": 0, "dropped": 0}
        )
        c[status] += 1
        if self.telemetry is not None:
            self.telemetry.on_federated_update(tenant, status)

    def _trace(self, stage: str, now: float, tenant=None, args=None) -> None:
        if self.trace is not None:
            self.trace.round_event(
                self.round_idx, stage, now, tenant=tenant, args=args
            )

    @property
    def quorum_needed(self) -> int:
        if self.config.barrier:
            return len(self._participants)
        return max(
            1, math.ceil(self.config.quorum * len(self._participants))
        )

    def quorum_reached(self) -> bool:
        return len(self._arrived) >= self.quorum_needed

    def all_arrived(self) -> bool:
        return len(self._arrived) >= len(self._participants)

    # ------------------------------------------------------------ round API
    def begin_round(
        self,
        round_idx: int,
        now: float,
        participants: list[str],
        *,
        deadline: Optional[float] = None,
    ) -> None:
        if self.open:
            raise RuntimeError(f"round {self.round_idx} still open")
        if not participants:
            raise ValueError("a round needs at least one participant")
        self.round_idx = round_idx
        self.open = True
        self._started_at = now
        self._deadline = deadline
        self._participants = list(participants)
        self._arrived = {}
        self._first_arrival = None
        self._nan_rejected = []
        self._trace(
            "round_start",
            now,
            args={
                "participants": list(participants),
                "deadline": deadline,
                "quorum_needed": self.quorum_needed,
            },
        )

    def offer(self, tenant: str, update: ParamTree, now: float) -> str:
        """One tenant's update arrives (on time or late); returns its
        resolution: ``participated`` / ``late_folded`` / ``late_dropped`` /
        ``nan_rejected``.  ``update`` is a parameter-DELTA tree against the
        round's starting global params."""
        vec = tree_flatten(update)
        on_time = (
            self.open
            and tenant in self._participants
            and tenant not in self._arrived
        )
        if on_time and not np.isfinite(vec).all():
            # NaN/Inf guard: a diverged local update never reaches the
            # aggregate (and never poisons a fold).
            self._nan_rejected.append(tenant)
            self._count(tenant, "dropped")
            self._trace("update_received", now, tenant=tenant,
                        args={"nan": True})
            return "nan_rejected"
        if on_time:
            self._arrived[tenant] = vec
            if self._first_arrival is None:
                self._first_arrival = now
            self._count(tenant, "participated")
            self._trace(
                "update_received",
                now,
                tenant=tenant,
                args={"norm": round(float(np.linalg.norm(vec)), 9)},
            )
            return "participated"
        # not on time: the tenant's round already closed (or it was never a
        # participant of the open one) — same resolution as any straggler.
        return self.offer_late(tenant, update, now, self.round_idx)

    def offer_late(self, tenant: str, update: ParamTree, now: float,
                   trained_round: int) -> str:
        """A straggler's update from ``trained_round`` arriving after that
        round closed (possibly several closes ago).  Folds it into the next
        aggregate with the staleness discount, or drops it."""
        vec = tree_flatten(update)
        if not np.isfinite(vec).all():
            self._count(tenant, "dropped")
            self._trace("update_late", now, tenant=tenant, args={"nan": True})
            return "nan_rejected"
        # next close is round self.round_idx when open, else round_idx + 1
        next_close = self.round_idx if self.open else self.round_idx + 1
        rounds_late = max(1, next_close - trained_round)
        if (
            self.config.late_policy == "drop"
            or rounds_late > self.config.max_staleness
        ):
            self._count(tenant, "dropped")
            self._trace("update_late", now, tenant=tenant,
                        args={"resolution": "dropped",
                              "rounds_late": rounds_late})
            return "late_dropped"
        w = self._weight(tenant) * (
            self.config.staleness_alpha ** rounds_late
        )
        self._folds.append(_Fold(tenant, trained_round, vec, w))
        self._count(tenant, "late")
        self._trace(
            "update_late",
            now,
            tenant=tenant,
            args={
                "resolution": "folded",
                "rounds_late": rounds_late,
                "weight": round(w, 9),
            },
        )
        return "late_folded"

    def resolve_missing(self, tenant: str) -> None:
        """A straggler whose update never arrived at all (crashed tenant,
        end of experiment): counts as dropped in the participation ledger."""
        self._count(tenant, "dropped")

    def close_round(self, now: float) -> RoundRecord:
        """Aggregate and apply: weighted FedAvg over the on-time updates
        plus any pending staleness-discounted folds, optionally through the
        pairwise-mask secure path and with Gaussian DP noise."""
        if not self.open:
            raise RuntimeError("no open round to close")
        cfg = self.config
        dim = tree_flatten(self.params).size
        entries: list[tuple[str, np.ndarray, float]] = []
        for tenant, vec in self._arrived.items():
            entries.append(
                (tenant, clip_update(vec, cfg.dp_clip), self._weight(tenant))
            )
        folds, self._folds = self._folds, []
        for f in folds:
            entries.append((f.tenant, clip_update(f.vec, cfg.dp_clip), f.weight))

        weight_total = sum(w for _, _, w in entries)
        if entries:
            if cfg.secure_aggregation:
                # the aggregator only ever sums MASKED weighted updates; the
                # pairwise masks cancel in the total (secure.pairwise_masks).
                names = [f"{t}#{i}" for i, (t, _, _) in enumerate(entries)]
                masks = pairwise_masks(cfg.seed, self.round_idx, names, dim)
                total = np.zeros(dim, dtype=np.float64)
                for name, (_, vec, w) in zip(names, entries):
                    total += vec * w + masks[name]
            else:
                total = np.zeros(dim, dtype=np.float64)
                for _, vec, w in entries:
                    total += vec * w
            agg = total / weight_total
            if cfg.dp_noise_multiplier > 0:
                scale = cfg.dp_noise_multiplier * cfg.dp_clip / len(entries)
                agg = agg + gaussian_noise(cfg.seed, self.round_idx, dim, scale)
                self.accountant.spend(cfg.dp_noise_multiplier)
            flat = tree_flatten(self.params) + agg
            self.params = tree_unflatten(flat, self.params)
            update_norm = float(np.linalg.norm(agg))
            mean_norm = float(
                np.mean([np.linalg.norm(v) for _, v, _ in entries])
            )
        else:
            # nobody made it: the round closes empty and params stand still
            update_norm = 0.0
            mean_norm = 0.0

        wait = (
            now - self._first_arrival
            if self._first_arrival is not None
            else now - self._started_at
        )
        rec = RoundRecord(
            round_idx=self.round_idx,
            started_at=self._started_at,
            closed_at=now,
            deadline=self._deadline,
            participants=list(self._participants),
            on_time=list(self._arrived),
            folded=[f.tenant for f in folds],
            nan_rejected=list(self._nan_rejected),
            quorum_wait_s=max(wait, 0.0),
            update_norm=update_norm,
            mean_update_norm=mean_norm,
            weight_total=weight_total,
        )
        self.records.append(rec)
        self.open = False
        self._trace(
            "round_aggregated",
            now,
            args={
                "on_time": len(rec.on_time),
                "folded": len(rec.folded),
                "update_norm": round(update_norm, 9),
            },
        )
        if self.telemetry is not None:
            self.telemetry.on_round_aggregated()
        return rec

    # -------------------------------------------------------------- report
    def report(
        self,
        *,
        accuracy_by_round: Optional[list[float]] = None,
        simulation=None,
    ) -> FederatedReport:
        privacy = None
        if self.accountant.rounds:
            privacy = self.accountant.summary(self.config.dp_delta)
        return FederatedReport(
            config=self.config,
            params=dict(self.params),
            rounds=list(self.records),
            participation={
                t: dict(c) for t, c in self.participation.items()
            },
            accuracy_by_round=list(accuracy_by_round or []),
            privacy=privacy,
            simulation=simulation,
        )


def fedavg(
    updates: dict[str, ParamTree],
    weights: Optional[dict[str, float]] = None,
) -> ParamTree:
    """One-shot (weighted) FedAvg over delta trees — the stateless core the
    coordinator applies per round, exposed for direct use and tests."""
    if not updates:
        raise ValueError("fedavg needs at least one update")
    names = sorted(updates)
    w = np.array(
        [1.0 if weights is None else weights.get(n, 1.0) for n in names],
        dtype=np.float64,
    )
    vecs = np.stack([tree_flatten(updates[n]) for n in names])
    agg = (vecs * w[:, None]).sum(axis=0) / w.sum()
    return tree_unflatten(agg, updates[names[0]])


UpdateFn = Callable[[str, int, ParamTree], ParamTree]

__all__ = [
    "FederatedCoordinator",
    "FederatedReport",
    "RoundRecord",
    "UpdateFn",
    "fedavg",
    "tree_flatten",
    "tree_unflatten",
]
