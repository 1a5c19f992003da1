"""Learning-rate schedules (pure functions of the step counter).

The step arrives as the port's optimizers pass it, a Python ``int``, or as
a 0-d tensor.  Each schedule returns the rate as a 0-d float32 tensor,
computed in float32 in the reference's order of operations.
"""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(_F32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=_F32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        s = _step(step)
        warm = peak_lr * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup_steps, warm, cos)
    return fn


def inverse_sqrt(peak_lr: float, warmup_steps: int = 1000):
    def fn(step):
        s = torch.clamp(_step(step), min=1.0)
        return peak_lr * torch.minimum(s / warmup_steps, torch.sqrt(warmup_steps / s))
    return fn
