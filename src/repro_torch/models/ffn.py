"""Feed-forward blocks: gated (SwiGLU), plain GeLU, squared-ReLU (Nemotron)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import common


def is_gated(activation: str) -> bool:
    return activation.endswith("_gated")


def init_ffn_params(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
                    dtype) -> nn.ParameterDict:
    """``w_in`` / ``w_out`` (and ``w_gate`` when gated), laid out (in, out)
    as the reference's so ``x @ w`` reads the same."""
    p = {"w_in": common.init_dense(gen, d_model, d_ff, dtype),
         "w_out": common.init_dense(gen, d_ff, d_model, dtype)}
    if is_gated(activation):
        p["w_gate"] = common.init_dense(gen, d_model, d_ff, dtype)
    return nn.ParameterDict(p)


def ffn(params, x: torch.Tensor, activation: str) -> torch.Tensor:
    act = common.activation_fn(activation.replace("_gated", ""))
    h = x @ params["w_in"]
    if is_gated(activation):
        h = act(x @ params["w_gate"]) * h
    else:
        h = act(h)
    return h @ params["w_out"]
