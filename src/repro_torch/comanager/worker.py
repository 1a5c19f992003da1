"""Quantum worker model (Algorithm 2 state: MR / AR / OR / CRU / AC).

A worker executes assigned circuits concurrently, subject to its qubit
capacity ``MR``.  Two execution backends:

* simulated service times — calibrated per-(qc, layers) rates so the paper's
  runtime figures can be reproduced deterministically on the virtual clock;
* real kernel execution — the worker's batch is handed to the fused
  statevector kernel (repro_torch.kernels.ops), which is how the GPU data
  plane runs.

Contention model: quantum hardware executes co-resident circuits on disjoint
qubits truly concurrently, while the paper's *simulator* workers are
CPU-bound.  ``contention`` interpolates: the service time of a circuit that
starts with k other active circuits is scaled by (1 + contention * k).
"""

from __future__ import annotations

import dataclasses

#: paper-calibrated 1-worker processing speeds (circuits/sec) from Figs 3b/4b,
#: IBM-Q backends: (qc, n_layers) -> circuits per second.
PAPER_RATES_IBMQ = {
    (5, 1): 15.2,
    (5, 2): 6.2,
    (5, 3): 5.9,
    (7, 1): 12.4,
    (7, 2): 7.1,
    (7, 3): 4.4,
}
#: controlled-environment (GCP e2-medium) rates from Fig 5b.
PAPER_RATES_GCP = {
    (5, 1): 3.8,
    (5, 2): 3.0,
    (5, 3): 2.4,
    (7, 1): 3.0,
    (7, 2): 2.4,
    (7, 3): 1.9,
}


@dataclasses.dataclass(frozen=True)
class WorkerConfig:
    worker_id: str
    max_qubits: int  # MR_w
    speed: float = 1.0  # relative service-rate multiplier
    heartbeat_period: float = 5.0  # paper: "every 5 seconds"
    contention: float = 0.15  # co-residency slowdown factor
    base_load: float = 0.0  # external classical load (uncontrolled env)
    # BEYOND PAPER (their §V limitation #2): per-gate depolarizing error of
    # this machine.  A depth-g circuit's state is fully depolarized with
    # probability 1-(1-error_rate)**g, pulling the observed SWAP-test
    # fidelity toward 1/2.  0.0 = the paper's noiseless setting.
    error_rate: float = 0.0


@dataclasses.dataclass
class ActiveCircuit:
    task: "CircuitTask"
    start_time: float
    finish_time: float


@dataclasses.dataclass(frozen=True)
class CircuitTask:
    """One bank entry as the co-Manager sees it.

    ``demand`` is D_c in Algorithm 2 (qubit width); ``service_time`` is the
    1x-speed, zero-contention execution time; ``payload`` indexes the client
    job's (theta, data) bank row for real execution.
    """

    task_id: int
    client_id: str
    demand: int
    service_time: float
    payload: int = -1
    depth: int = 0  # gate count (noise-aware scheduling extension)

    def __post_init__(self):
        assert self.demand >= 1 and self.service_time > 0


class QuantumWorker:
    """Runtime state of one quantum worker."""

    def __init__(self, cfg: WorkerConfig):
        self.cfg = cfg
        self.active: dict[int, ActiveCircuit] = {}  # AC_w
        self.completed: list[int] = []
        self.busy_time = 0.0  # integral of n_active dt
        self._last_t = 0.0

    # ----------------------------------------------------------- resources
    @property
    def max_qubits(self) -> int:  # MR_w
        return self.cfg.max_qubits

    @property
    def occupied_qubits(self) -> int:  # OR_w = sum of D_c
        return sum(a.task.demand for a in self.active.values())

    @property
    def available_qubits(self) -> int:  # AR_w = MR_w - OR_w
        return self.max_qubits - self.occupied_qubits

    def cru(self, t: float) -> float:
        """Classical resource usage CRU_w(t): the sys_w 'system call'.

        Modeled as base external load + fraction of capacity occupied by
        concurrently executing circuits (a CPU-bound simulator's utilization
        tracks its resident circuit count).
        """
        util = len(self.active) / max(1, self.max_qubits // 5)
        return self.cfg.base_load + min(1.0, util)

    # ----------------------------------------------------------- execution
    def exec_time(self, task: CircuitTask) -> float:
        """Service time for ``task`` if started now (contention-scaled)."""
        k = len(self.active)
        return (task.service_time / self.cfg.speed) * (1.0 + self.cfg.contention * k)

    def start(self, task: CircuitTask, now: float) -> float:
        """Begin executing; returns the finish time to schedule."""
        if task.demand > self.available_qubits:
            raise RuntimeError(
                f"{self.cfg.worker_id}: demand {task.demand} > AR "
                f"{self.available_qubits}"
            )
        self._accumulate(now)
        finish = now + self.exec_time(task)
        self.active[task.task_id] = ActiveCircuit(task, now, finish)
        return finish

    def finish(self, task_id: int, now: float) -> CircuitTask:
        self._accumulate(now)
        ac = self.active.pop(task_id)
        self.completed.append(task_id)
        return ac.task

    def abandon(self, now: float) -> list[CircuitTask]:
        """Drop every resident circuit without completing it.

        Crash recovery: a worker that re-registers after a crash lost its
        in-memory state, so its active set is cleared (capacity returns,
        busy time accrues up to ``now``) and the orphaned tasks are handed
        back to the caller for requeueing.
        """
        self._accumulate(now)
        orphans = [ac.task for ac in self.active.values()]
        self.active.clear()
        return orphans

    def _accumulate(self, now: float) -> None:
        self.busy_time += len(self.active) * (now - self._last_t)
        self._last_t = now

    # --------------------------------------------------------------- noise
    def depolarization(self, depth: int) -> float:
        """lambda = P(state fully depolarized) for a depth-``depth`` circuit."""
        return 1.0 - (1.0 - self.cfg.error_rate) ** depth

    def observed_p0(self, ideal_p0: float, depth: int) -> float:
        """Global-depolarizing readout: P0 -> (1-l)*P0 + l/2."""
        lam = self.depolarization(depth)
        return (1.0 - lam) * ideal_p0 + lam * 0.5

    # ------------------------------------------------------------ heartbeat
    def heartbeat_payload(self, t: float) -> dict:
        """What w_i reports to the co-Manager every heartbeat period."""
        return {
            "worker_id": self.cfg.worker_id,
            "active": {tid: a.task.demand for tid, a in self.active.items()},
            "completed": set(self.completed),
            "cru": self.cru(t),
            "max_qubits": self.max_qubits,
            "error_rate": self.cfg.error_rate,
        }
