"""End-to-end driver: train the paper's QuClassi classifier (1/5 digits)
with the DISTRIBUTED parameter-shift path — every gradient step's circuit
bank is scheduled by the co-Manager onto 4 quantum workers and executed by
the statevector kernels per worker, exactly the paper's architecture
(Fig 1).

Run:  PYTHONPATH=src python -m repro_torch.examples.distributed_training [--epochs 12] [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.comanager import dataplane, tenancy
from repro_torch.comanager.simulation import SystemSimulation, homogeneous_workers
from repro_torch.core import quclassi
from repro_torch.core.quclassi import QuClassiConfig
from repro_torch.core.trainer import train
from repro_torch.data import mnist
from repro_torch.examples import arg_parser, parse

N_WORKERS = 4


def comanaged_executor(cfg: QuClassiConfig, n_bank: int):
    """Build an executor whose worker assignment comes from an actual
    co-Manager run (Algorithm 2) over this bank; -> (executor, circuits a
    worker)."""
    jobs = [tenancy.JobSpec("client", cfg.qc, cfg.n_layers, n_bank,
                            service_override=0.05)]
    workers = homogeneous_workers(N_WORKERS, max_qubits=2 * cfg.qc)
    sim = SystemSimulation(workers, jobs)
    rep = sim.run()
    order = {f"w{i + 1}": i for i in range(N_WORKERS)}
    assignment = np.zeros(n_bank, int)
    payload = {t.task_id: t.payload for t in sim.manager.task_registry.values()}
    for (_, tid, wid) in rep.assignments:
        assignment[payload[tid]] = order[wid]
    counts = np.bincount(assignment, minlength=N_WORKERS)
    print(f"  co-Manager spread {n_bank} circuits over workers: {counts.tolist()}")
    return dataplane.worker_batched_executor(cfg.spec, assignment, N_WORKERS), counts.tolist()


def main(argv=None, *, params=None) -> dict:
    """``params`` (QuClassi weights, tensors) replace the trainer's seeded
    draw (the reference's is ``jax.random.PRNGKey(0)``)."""
    ap = arg_parser(__doc__)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=8)
    args, dev = parse(ap, argv)

    cfg = QuClassiConfig(qc=5, n_layers=1)
    x, y = mnist.make_pair_dataset(1, 5, n_per_class=24, seed=0)
    (xtr, ytr), (xte, yte) = mnist.train_test_split(x, y)
    print(f"task 1/5: {len(ytr)} train, {len(yte)} test images")

    n_bank = quclassi.total_bank_circuits(cfg, args.batch_size) // cfg.n_classes
    executor, spread = comanaged_executor(cfg, n_bank)

    t0 = time.time()
    rep = train(cfg, (xtr, ytr), (xte, yte), epochs=args.epochs,
                batch_size=args.batch_size, lr=0.05, optimizer="adam",
                grad_mode="shift", executor=executor, init_params=params,
                device=dev, log=lambda s: print(f"  {s}"))
    seconds = time.time() - t0
    circuits = sum(e.circuits_executed for e in rep.epochs)
    print(f"final test accuracy: {rep.final_test_accuracy:.1%} "
          f"({seconds:.0f}s, "
          f"{circuits} circuits executed "
          f"across {N_WORKERS} workers)")
    return {"spread": spread, "report": rep, "seconds": seconds, "circuits": circuits}


if __name__ == "__main__":
    main()
