"""train_step / serve_step / prefill_step factories — the units the
launchers drive.

``make_train_step``: microbatched gradient accumulation over interleaved
row slices, float32 accumulators, global-norm clipping, the optimizer
update.  ``make_serve_step``: one-token decode against a threaded KV
cache.  ``make_prefill_step``: the full-sequence forward, through the flash
kernel when ``cfg.attention_impl == "flash"``.

The reference's steps take the parameters as an argument; here the
``Model`` holds them, and each factory returns the step with the model it
runs (built with its seeded init on ``device`` unless one is passed).  The
train step updates the model's parameters in place; the serving steps run
without autograd.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.optim import optimizers as opt_mod


def _model(cfg: ModelConfig, model, device) -> transformer.Model:
    return model if model is not None else transformer.Model(cfg, device=device)


def make_loss_fn(model: transformer.Model) -> Callable:
    return lambda batch: model.loss(batch)


def micro_split(batch: dict, n_micro: int) -> list[dict]:
    """(B, ...) -> ``n_micro`` batches of B / n_micro rows, INTERLEAVED as
    the reference's ``_micro_split``: microbatch i takes rows i, i + n,
    i + 2n, ..."""
    for key, a in batch.items():
        if a.shape[0] % n_micro:
            raise ValueError(f"batch[{key!r}] has {a.shape[0]} rows, not a multiple of "
                             f"{n_micro} microbatches")
    return [{k: a[i::n_micro] for k, a in batch.items()} for i in range(n_micro)]


def _value_and_grad(loss_fn, params: dict, batch: dict):
    """(loss, {name: grad}); a parameter the loss does not reach gets a
    zero gradient, as ``jax.grad`` gives it."""
    loss = loss_fn(batch)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for (n, p), g in zip(params.items(), grads)}


def make_train_step(cfg: ModelConfig, *, global_batch: int, clip_norm: float = 1.0,
                    model=None, device="cuda"):
    """-> (train_step, optimizer, model).

    ``train_step(opt_state, batch, stats=None) -> (opt_state, loss)`` with
    ``opt_state = optimizer.init(dict(model.named_parameters()))``: the
    loss is the mean over ``max(1, global_batch // cfg.microbatch)``
    interleaved microbatches (MoE capacity is reckoned per microbatch, as
    in the reference), the gradients are summed in float32 and divided by
    their count, clipped to ``clip_norm`` by global norm, and
    ``cfg.optimizer``'s update is added to the parameters in place.
    ``stats``, when given, receives ``grad_norm`` (before clipping) and
    ``grads`` (what the optimizer was given)."""
    model = _model(cfg, model, device)
    optimizer = opt_mod.make(cfg.optimizer, cfg.learning_rate)
    loss_fn = make_loss_fn(model)
    n_micro = max(1, global_batch // max(cfg.microbatch, 1))
    params = dict(model.named_parameters())

    def train_step(opt_state, batch: dict, stats: dict | None = None):
        if n_micro == 1:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        else:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for mbatch in micro_split(batch, n_micro):
                l, g = _value_and_grad(loss_fn, params, mbatch)
                for n in grads:
                    grads[n] += g[n].to(torch.float32)
                loss = loss + l
                del g
            grads = {n: g / n_micro for n, g in grads.items()}
            loss = loss / n_micro
        with torch.no_grad():
            gnorm = None
            if clip_norm:
                grads, gnorm = opt_mod.clip_by_global_norm(grads, clip_norm)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            for n, new in opt_mod.apply_updates(params, updates).items():
                params[n].copy_(new)
        if stats is not None:
            stats.update(grad_norm=gnorm, grads=grads)
        return opt_state, loss

    return train_step, optimizer, model


def make_serve_step(cfg: ModelConfig, *, model=None, device="cuda"):
    """serve_step(batch, caches, pos) -> (logits, new_caches).  ``batch``
    holds the single new token; ``pos`` its absolute position."""
    model = _model(cfg, model, device)

    @torch.no_grad()
    def serve_step(batch, caches, pos):
        return model.decode_step(batch, caches, pos)

    return serve_step, model


def make_prefill_step(cfg: ModelConfig, *, model=None, device="cuda"):
    """prefill_step(batch) -> logits (B, S, V)."""
    model = _model(cfg, model, device)

    @torch.no_grad()
    def prefill_step(batch):
        logits, _ = model.prefill(batch)
        return logits

    return prefill_step, model
