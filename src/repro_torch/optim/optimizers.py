"""Functional optimizers over (nested) dictionaries of tensors.

The API mirrors the reference's (and optax's): ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``; ``apply_updates``
adds them.  The step count is a Python int, so a schedule ``lr(step)``
receives an int.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _map(fn, tree, *rest):
    """Apply ``fn`` leafwise over dicts of tensors with the same keys."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def apply_updates(params, updates):
    return _map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _zeros_like_f32(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def sgd(lr: float | Callable[[int], float]) -> Optimizer:
    def init(params):
        return {"step": 0}

    def update(grads, state, params=None):
        step = state["step"] + 1
        eta = lr(step) if callable(lr) else lr
        return _map(lambda g: -eta * g, grads), {"step": step}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"step": 0, "m": _zeros_like_f32(params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        eta = lr(step) if callable(lr) else lr
        m = _map(lambda m_, g: beta * m_ + g, state["m"], grads)
        if nesterov:
            ups = _map(lambda m_, g: -eta * (beta * m_ + g), m, grads)
        else:
            ups = _map(lambda m_: -eta * m_, m)
        return ups, {"step": step, "m": m}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam / AdamW (decoupled decay when weight_decay > 0)."""
    def init(params):
        return {"step": 0, "m": _zeros_like_f32(params), "v": _zeros_like_f32(params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        eta = lr(step) if callable(lr) else lr
        m = _map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32), state["m"], grads)
        v = _map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(torch.float32)),
                 state["v"], grads)
        bc1 = 1 - b1**step
        bc2 = 1 - b2**step

        def upd(m_, v_, p=None):
            u = -eta * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay and p is not None:
                u = u - eta * weight_decay * p.to(torch.float32)
            return u

        ups = _map(upd, m, v) if params is None else _map(upd, m, v, params)
        return ups, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adamw(lr, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def clip_by_global_norm(grads, max_norm: float):
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in _leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return _map(lambda g: g * scale, grads), gn


BY_NAME = {"sgd": sgd, "momentum": momentum, "adam": adam, "adamw": adamw}


def make(name: str, lr, **kw) -> Optimizer:
    return BY_NAME[name](lr, **kw)
