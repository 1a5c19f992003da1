"""Multi-tenant client/job model.

A *client* submits a training job; a *job* expands into the circuit bank for
one epoch (or one gradient step) of its QuClassi workload.  The paper's
multi-tenant evaluation (Fig 6) runs four concurrent clients
(5Q/1L, 5Q/2L, 7Q/1L, 7Q/2L) against four heterogeneous workers
(5/10/15/20 qubits).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator

from repro_torch.comanager.worker import CircuitTask, PAPER_RATES_GCP, PAPER_RATES_IBMQ


class TaskIdAllocator:
    """Per-runtime task-id source.

    Each ``SystemSimulation`` / serving gateway owns one of these, so two
    concurrently constructed runtimes can never interleave ids (the old
    module-global counter made task ids depend on construction order
    process-wide, which breaks multi-stream ingestion).
    """

    def __init__(self, start: int = 0):
        self._it = itertools.count(start)

    def __next__(self) -> int:
        return next(self._it)

    def __iter__(self) -> Iterator[int]:
        return self


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One client's training job for runtime experiments."""

    client_id: str
    qc: int  # circuit width (5 or 7)
    n_layers: int  # 1..3
    n_circuits: int  # bank size for the epoch
    submit_time: float = 0.0
    service_override: float | None = None  # quantum-side seconds/circuit

    def service_time(self, env: str = "ibmq") -> float:
        """Per-circuit 1-worker service time calibrated from the paper."""
        if self.service_override is not None:
            return self.service_override
        rates = PAPER_RATES_IBMQ if env == "ibmq" else PAPER_RATES_GCP
        return 1.0 / rates[(self.qc, self.n_layers)]

    def circuits(
        self, env: str = "ibmq", ids: Iterator[int] | None = None
    ) -> list[CircuitTask]:
        """Expand into the epoch's circuit bank.  ``ids`` is the owning
        runtime's task-id allocator (defaults to a fresh one, for callers
        that only ever build a single job)."""
        st = self.service_time(env)
        ids = ids if ids is not None else TaskIdAllocator()
        from repro_torch.core import circuits as qcirc

        depth = len(qcirc.build_quclassi_circuit(self.qc, self.n_layers).ops)
        return [
            CircuitTask(
                task_id=next(ids),
                client_id=self.client_id,
                demand=self.qc,
                service_time=st,
                payload=i,
                depth=depth,
            )
            for i in range(self.n_circuits)
        ]


#: paper's per-epoch circuit counts (§IV-C): 5q -> 1440/2880/4320,
#: 7q -> 2016/4032/6048 for 1/2/3 layers.
PAPER_CIRCUIT_COUNTS = {
    (5, 1): 1440,
    (5, 2): 2880,
    (5, 3): 4320,
    (7, 1): 2016,
    (7, 2): 4032,
    (7, 3): 6048,
}


def paper_job(
    client_id: str,
    qc: int,
    n_layers: int,
    submit_time: float = 0.0,
    scale: float = 1.0,
) -> JobSpec:
    n = int(PAPER_CIRCUIT_COUNTS[(qc, n_layers)] * scale)
    return JobSpec(client_id, qc, n_layers, n, submit_time)


@dataclasses.dataclass
class JobResult:
    client_id: str
    n_circuits: int
    submit_time: float
    finish_time: float

    @property
    def makespan(self) -> float:
        return self.finish_time - self.submit_time

    @property
    def circuits_per_second(self) -> float:
        return self.n_circuits / max(self.makespan, 1e-9)
