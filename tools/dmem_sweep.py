#!/usr/bin/env python3
"""Launch-shape sweep of the fidelity kernel's device-memory route, and
repeats of free-running two-tenant training through the gateway, on one GPU.

    python3 tools/dmem_sweep.py [--repeats 8]

Part 1 gives ``vqc_p0`` 1-layer QuClassi rows of 15 and 17 qubits (C = 256)
and 19 qubits (C = 64), and times (CUDA events, 5 calls after 1) every
block width of ``DMEM_THREADS`` (1,024, 512, 256) against chunk sizes from
the whole batch in one launch down to chunks whose states fit the 50 MB L2
(``DMEM_WORKSPACE_BYTES``), in turns: the chunk sizes in order, then
reversed.  Every result is checked against the plain version (1e-5), and
every chunking of one block width must give the bits of its one launch.

Part 2 trains quclassi-7q-3l (batch 64, implicit banks, 3 steps) as two
free-running tenants on one async runtime of 4 workers (``train_tenants``
in ``chip_smoke.py``, phase 6b) ``--repeats`` times, after one solo warm-up,
and logs steps/s and how many batches held both tenants.

Prints a log and writes the records to ``chiprun_out/dmem_sweep.json``.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
from chip_smoke import TOL, log, smi_line, time_ms, train_tenants  # noqa: E402

SHAPES = ((17, 256, (256, 128, 64, 48, 40, 32, 24, 16)),
          (15, 256, (256, 192, 160, 128, 96, 64, 32)),
          (19, 64, (64, 32, 16, 12, 8)))


def sweep(K, circuits, dev, card: str) -> list:
    out = []
    for q, c, chunks in SHAPES:
        spec = circuits.build_quclassi_circuit(q, 1)
        rng = np.random.default_rng(q)
        th = torch.tensor(rng.uniform(0, np.pi, (c, spec.n_theta)), dtype=torch.float32,
                          device=dev)
        dt = torch.tensor(rng.uniform(0, np.pi, (c, spec.n_data)), dtype=torch.float32,
                          device=dev)
        want = K._fused_plain(spec, th, dt, want_state=False)
        for threads in (1024, 512, 256):
            K.DMEM_THREADS = threads
            whole = None
            for chunk in chunks + tuple(reversed(chunks)):
                K.DMEM_WORKSPACE_BYTES = chunk * K._state_bytes(q, 1)
                got = K.vqc_p0(spec, th, dt)
                whole = got if whole is None else whole
                err = float((got - want).abs().max())
                if not err <= TOL or not torch.equal(got, whole):
                    raise AssertionError(f"{q}q threads {threads} chunk {chunk}: max|diff| "
                                         f"{err}, bits of one launch {torch.equal(got, whole)}")
                ms = time_ms(lambda: K.vqc_p0(spec, th, dt), iters=5, warmup=1)
                rec = {"q": q, "C": c, "threads": threads, "chunk": chunk, "ms": ms,
                       "max_abs_err": err}
                out.append(rec)
                log(f"{json.dumps(rec)} [{card}]")
    return out


def tenants(dev, card: str, repeats: int) -> list:
    from repro_torch.comanager import dataplane
    from repro_torch.comanager.worker import WorkerConfig
    from repro_torch.configs.quclassi_paper import get_quclassi
    from repro_torch.core import quclassi
    from repro_torch.core.trainer import train
    from repro_torch.data.mnist import make_pair_dataset, train_test_split

    cfg = get_quclassi("quclassi-7q-3l")
    x, y = make_pair_dataset(1, 5, n_per_class=128, seed=0)
    (xtr, ytr), test_set = train_test_split(x, y)
    batch = (xtr[:64], ytr[:64])
    kw = dict(epochs=3, batch_size=64, lr=1e-3, bank_mode="implicit", device=dev)
    seeds = {"tenant-a": 0, "tenant-b": 1}
    inits = {cid: quclassi.init_params(cfg, torch.Generator().manual_seed(s), dev)
             for cid, s in seeds.items()}
    workers = [WorkerConfig(f"w{i + 1}", q) for i, q in enumerate((5, 10, 15, 20))]
    n_groups = 1 + 2 * cfg.n_theta
    run = dataplane.worker_batched_executor(
        cfg.spec, dataplane.round_robin_assignment(n_groups, 4), 4)
    train(cfg, batch, test_set, executor=run, seed=0, init_params=inits["tenant-a"], **kw)
    out = []
    for rep in range(repeats):
        rt, reps, seconds = train_tenants(dev, workers, cfg, batch, test_set, inits, seeds, kw)
        rec = {"repeat": rep, "seconds": seconds, "steps_per_s": 6 / seconds,
               "batches": len(rt.dispatcher.batch_log),
               "mixed": sum(1 for b in rt.dispatcher.batch_log if len(b[2]) > 1),
               "first_losses": {cid: r.epochs[0].loss for cid, r in sorted(reps.items())}}
        out.append(rec)
        log(f"{json.dumps(rec)} [{card}]")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dmem_sweep: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.core import circuits
    from repro_torch.kernels import vqc_statevector as K

    dev, card = torch.device("cuda", 0), smi_line()
    log(card)
    result = {"card": card, "dmem": sweep(K, circuits, dev, card),
              "tenants": tenants(dev, card, args.repeats)}
    out = ROOT / "chiprun_out" / "dmem_sweep.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    log(f"wrote {out.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
