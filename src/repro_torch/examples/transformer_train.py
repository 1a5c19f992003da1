"""Train a ~100M-param smollm-family model for a few hundred steps — the
classical-architecture substrate end-to-end: config -> Model ->
microbatched train_step -> optimizer -> checkpoint.

The co-management connection: this is the same train_step the multi-pod
dry-run counts for the production mesh; here it runs real steps at full
width and reduced depth on synthetic tokens.

Run:  PYTHONPATH=src python -m repro_torch.examples.transformer_train [--steps 200] [--device cpu]
"""
from __future__ import annotations

import os
import time

import torch

from repro_torch.checkpoint import checkpoint
from repro_torch.configs import base as cfg_base
from repro_torch.data import pipeline
from repro_torch.examples import arg_parser, parse
from repro_torch.launch import steps
from repro_torch.models import transformer


def model_config(arch: str, batch: int):
    """~100M-scale variant of ``arch``: full d_model, fewer layers."""
    return cfg_base.get(arch).with_(
        n_layers=8, vocab=8192, microbatch=max(1, batch // 2),
        dtype="float32", remat=False)


def train_loop(cfg, model, n_steps: int, batch: int, seq: int) -> tuple[list[float], float]:
    """``n_steps`` of ``make_train_step`` on ``model`` (its parameters
    updated in place), step i on ``synthetic_tokens(i, ...)``; prints the
    reference's step lines; -> (losses, tokens/s of the whole loop)."""
    train_step, optimizer, _ = steps.make_train_step(cfg, global_batch=batch, model=model)
    opt_state = optimizer.init(dict(model.named_parameters()))
    losses, t0, tps = [], time.time(), 0.0
    for i in range(n_steps):
        tokens = pipeline.synthetic_tokens(i, batch, seq, cfg.vocab).to(model.device)
        opt_state, loss = train_step(opt_state, {"tokens": tokens})
        losses.append(float(loss))
        if i % 20 == 0 or i == n_steps - 1:
            dt = time.time() - t0
            tps = batch * seq * (i + 1) / dt
            print(f"step {i:4d}  loss {losses[-1]:.4f}  ({tps:,.0f} tok/s)")
    return losses, tps


def checkpoint_round_trip(cfg, model, path: str, metadata: dict) -> tuple[bool, dict]:
    """Save the parameters in the reference's pytree and ``.npz`` format,
    load them back and compare with the model's bit for bit; -> (equal,
    metadata read back)."""
    tree = transformer.params_to_numpy(cfg, model)
    checkpoint.save(path, tree, metadata=metadata)
    restored, meta = checkpoint.load(path, like=tree)
    state = transformer.params_from_numpy(cfg, restored, model.device)
    same = all(torch.equal(state[k], v) for k, v in model.state_dict().items())
    return same, meta


def main(argv=None, *, params=None) -> dict:
    """``params`` (the reference's parameter pytree, numpy arrays) replaces
    the model's seeded init (the reference's is ``jax.random.PRNGKey(0)``)."""
    ap = arg_parser(__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default="/tmp/repro_transformer.npz")
    args, dev = parse(ap, argv)

    # ~100M-scale variant of the assigned arch: full d_model, fewer layers
    cfg = model_config(args.arch, args.batch)
    model = transformer.Model(cfg, device=dev)
    if params is not None:
        model.load_state_dict(transformer.params_from_numpy(cfg, params, dev))
    n = transformer.param_count(model)
    print(f"{args.arch} variant: {cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab} -> {n/1e6:.1f}M params")

    losses, tps = train_loop(cfg, model, args.steps, args.batch, args.seq)
    assert losses[-1] < losses[0], "loss must decrease"
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} steps")

    same, meta = checkpoint_round_trip(cfg, model, args.ckpt,
                                       {"step": args.steps, "arch": args.arch})
    print(f"checkpoint round-trip at step {meta['step']}: {'OK' if same else 'FAIL'}")
    os.remove(args.ckpt)
    return {"config": cfg, "params": n, "losses": losses, "tokens_per_s": tps,
            "checkpoint_ok": same}


if __name__ == "__main__":
    main()
