"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \
      --reduced --steps 50 --batch 8 --seq 64 --device cpu

``--reduced`` runs real steps of the smoke-scale config on ``--device``
(default ``cuda``).  Without it the full config is dry-run against the
production mesh (``launch.dryrun.run_one``: shapes and counts on the
``meta`` device, nothing allocated) and its record written.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import base as cfg_base
from repro_torch.launch import steps
from repro_torch.models import multimodal, transformer


def run_reduced(arch: str, steps_n: int, batch: int, seq: int, ckpt: str | None = None,
                log_every: int = 10, device="cuda") -> float:
    """Train the reduced ``arch`` (the port's seeded init) for ``steps_n``
    steps of ``batch`` x ``seq``, step i on ``batch_for(..., seed=i)``;
    with ``ckpt``, save the parameters in the reference's pytree and file
    format.  Returns the last step's loss."""
    cfg = cfg_base.get(arch).reduced()
    train_step, optimizer, model = steps.make_train_step(cfg, global_batch=batch, device=device)
    n = transformer.param_count(model)
    print(f"[train] {arch} (reduced): {n/1e6:.1f}M params, batch {batch} x seq {seq}")
    opt_state = optimizer.init(dict(model.named_parameters()))

    losses, t0 = [], time.time()
    for i in range(steps_n):
        opt_state, loss = train_step(opt_state, multimodal.batch_for(cfg, batch, seq, seed=i))
        losses.append(float(loss))
        if i % log_every == 0 or i == steps_n - 1:
            print(f"[train] step {i:4d}  loss {losses[-1]:.4f}")
    dt = time.time() - t0
    print(f"[train] {steps_n} steps in {dt:.1f}s ({batch * seq * steps_n / dt:,.0f} tok/s) on "
          f"{model.device}; loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    if ckpt:
        from repro_torch.checkpoint import checkpoint
        checkpoint.save(ckpt, transformer.params_to_numpy(cfg, model),
                        metadata={"arch": arch, "step": steps_n})
        print(f"[train] checkpoint -> {ckpt}")
    return losses[-1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    if args.reduced:
        return run_reduced(args.arch, args.steps, args.batch, args.seq, args.ckpt,
                           device=args.device)
    print("[train] full config -> dry-run against the production mesh (meta device)")
    from repro_torch.launch import dryrun
    return dryrun.run_one(args.arch, args.shape, multi_pod=args.multi_pod)


if __name__ == "__main__":
    main()
