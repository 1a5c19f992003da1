"""serve_step / prefill_step factories — the units the launchers drive.

``make_serve_step``: one-token decode against a threaded KV cache.
``make_prefill_step``: the full-sequence forward, through the flash kernel
when ``cfg.attention_impl == "flash"``.

The reference's steps take the parameters as an argument; here the
``Model`` holds them, and each factory returns the step with the model it
runs (built with its seeded init on ``device`` unless one is passed).  Both steps
run without autograd.  ``make_train_step`` raises: it waits for the
training slice (ROADMAP Queue 1 item 14h).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def _model(cfg: ModelConfig, model, device) -> transformer.Model:
    return model if model is not None else transformer.Model(cfg, device=device)


def make_train_step(cfg: ModelConfig, *, global_batch: int, clip_norm: float = 1.0):
    """The reference's microbatched train step; not ported yet."""
    raise NotImplementedError(
        f"{cfg.name}: make_train_step waits for the training slice (ROADMAP Queue 1 item 14h)")


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
