"""Mixture-of-Experts FFN with capacity-based token dispatch.

The reference's ``models/moe.py``, which is plain JAX (no Pallas kernel):
  * router: softmax top-k over ``n_experts`` with optional always-on
    shared experts (DeepSeek-V3: 1 shared + 256 routed, top-8).  Equal
    probabilities go to the lower expert index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order on
    CUDA, so the selection is a stable descending sort);
  * dispatch: each kept (token, k) pair lands in its expert's slot of an
    (E, C + 1, D) buffer, slot = its first-come-first-served position in
    that expert (token-major for ``"flat"``, k-major for ``"per_k"``);
    pairs past capacity go to the overflow slot C and are dropped (gate
    weight 0).  Capacity is the reference's integer arithmetic,
    ``max(8, -(-T*K*int(100*cf) // (100*E)))``, and T*K (dropless) when
    ``dropless`` or T*K <= 64;
  * experts: one batched gated FFN over the leading E axis (``torch.bmm``);
  * load-balance auxiliary loss: E * sum_e f_e * p_e * router_aux_weight.
``pad_to`` adds dead experts to the bank (never routed).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, ffn as ffn_mod

#: experts drawn at a time in float32 before the cast (bounds the
#: float32 temporary of a full-width bank)
_DRAW_EXPERTS = 8


class MoEParams(nn.Module):
    """``router`` (D, E), ``experts`` (``w_in``, ``w_out``, ``w_gate``:
    stacked (E_bank, din, dout)) and, with shared experts, ``shared`` (a
    dense FFN of width ``d_ff_expert * n_shared_experts``); indexed like
    the reference's dict."""

    def __init__(self, router: torch.Tensor, experts: dict, shared: dict | None):
        super().__init__()
        self.router = nn.Parameter(router)
        self.experts = nn.ParameterDict(experts)
        if shared is not None:
            self.shared = shared

    def __getitem__(self, key: str):
        return getattr(self, key)


def _stack(gen: torch.Generator, n: int, din: int, dout: int, dtype) -> torch.Tensor:
    """(n, din, dout), N(0, 1) * din ** -0.5, drawn in float32 a few
    experts at a time."""
    out = torch.empty((n, din, dout), dtype=dtype, device=gen.device)
    for e0 in range(0, n, _DRAW_EXPERTS):
        e1 = min(n, e0 + _DRAW_EXPERTS)
        w = common.randn(gen, (e1 - e0, din, dout))
        out[e0:e1] = (w * din ** -0.5).to(dtype)
    return out


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> MoEParams:
    m = cfg.moe
    n_bank = max(m.n_experts, m.pad_to)   # dead pad experts (never routed)
    router = common.init_dense(gen, cfg.d_model, m.n_experts, dtype, scale=0.02)
    experts = {"w_in": _stack(gen, n_bank, cfg.d_model, m.d_ff_expert, dtype),
               "w_out": _stack(gen, n_bank, m.d_ff_expert, cfg.d_model, dtype)}
    if ffn_mod.is_gated(cfg.activation):
        experts["w_gate"] = _stack(gen, n_bank, cfg.d_model, m.d_ff_expert, dtype)
    shared = None
    if m.n_shared_experts:
        shared = ffn_mod.init_ffn_params(gen, cfg.d_model, m.d_ff_expert * m.n_shared_experts,
                                         cfg.activation, dtype)
    return MoEParams(router, experts, shared)


def _expert_ffn(experts, xs: torch.Tensor, activation: str) -> torch.Tensor:
    """xs: (E, C, D) -> (E, C, D), batched over experts."""
    act = common.activation_fn(activation.replace("_gated", ""))
    h = torch.bmm(xs, experts["w_in"])
    if "w_gate" in experts:
        h = act(torch.bmm(xs, experts["w_gate"])) * h
    else:
        h = act(h)
    return torch.bmm(h, experts["w_out"])


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots an expert holds for ``t`` tokens (the reference's formula)."""
    m = cfg.moe
    if m.dropless or t * m.top_k <= 64:
        return t * m.top_k
    return max(8, -(-t * m.top_k * int(100 * m.capacity_factor) // (100 * m.n_experts)))


def route(params, xt: torch.Tensor, cfg: ModelConfig):
    """xt (T, D) -> (probs (T, E) float32, gate_vals (T, K) renormalized,
    expert_idx (T, K)): top-k by descending probability, ties to the lower
    expert index."""
    logits = (xt @ params["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = order.values[:, :cfg.moe.top_k]
    expert_idx = order.indices[:, :cfg.moe.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def _fcfs(e: torch.Tensor, e_bank: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Position of each entry of ``e`` among the earlier entries with the
    same expert, and the count per expert: the reference's cumulative count
    of one-hot rows, as a stable sort by expert (no (N, E) one-hot, and no
    host synchronisation)."""
    order = torch.sort(e, stable=True).indices
    counts = torch.zeros((e_bank,), dtype=e.dtype, device=e.device)
    counts.index_add_(0, e, torch.ones_like(e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(e.numel(), device=e.device) - starts[e[order]]
    return torch.empty_like(e).scatter_(0, order, rank), counts


def dispatch(expert_idx: torch.Tensor, cap: int, e_bank: int, mode: str):
    """(slot (T, K), keep (T, K)) of every (token, k) pair: FCFS position
    in its expert, token-major (``"flat"``) or k-major (``"per_k"``); the
    overflow slot ``cap`` where it is past capacity."""
    t, k = expert_idx.shape
    if mode == "per_k":
        counts = torch.zeros((e_bank,), dtype=expert_idx.dtype, device=expert_idx.device)
        cols = []
        for j in range(k):
            e_k = expert_idx[:, j]
            pos, n = _fcfs(e_k, e_bank)
            cols.append(counts[e_k] + pos)
            counts = counts + n
        pos = torch.stack(cols, 1)
    else:
        pos, _ = _fcfs(expert_idx.reshape(-1), e_bank)
        pos = pos.reshape(t, k)
    keep = pos < cap
    return torch.where(keep, pos, torch.full_like(pos, cap)), keep


def moe_ffn(params, x: torch.Tensor, cfg: ModelConfig, *, stats: dict | None = None):
    """x (B, S, D) -> (y (B, S, D), aux_loss float32 scalar).  ``stats``,
    when given, receives the routing: ``expert_idx``, ``keep`` (T, K),
    ``capacity``."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    e_bank = max(m.n_experts, m.pad_to)   # buffer/bank size incl. dead pads

    probs, gate_vals, expert_idx = route(params, xt, cfg)
    cap = capacity(cfg, t)
    slot, keep = dispatch(expert_idx, cap, e_bank, m.dispatch)

    # every kept pair has a slot of its own; dropped pairs all land in the
    # overflow slot ``cap``, which is never read, so a plain store gives the
    # reference's scatter-add
    buf = torch.zeros((e_bank, cap + 1, d), dtype=x.dtype, device=x.device)
    if m.dispatch == "per_k":
        # K scatters of (T, D): never the (T*K, D) replicated payload
        for j in range(m.top_k):
            buf.index_put_((expert_idx[:, j], slot[:, j]), xt)
    else:
        tok_rep = xt.repeat_interleave(m.top_k, dim=0)               # (T*K, D)
        buf.index_put_((expert_idx.reshape(-1), slot.reshape(-1)), tok_rep)
    expert_out = _expert_ffn(params["experts"], buf[:, :cap], cfg.activation)
    expert_out = torch.nn.functional.pad(expert_out, (0, 0, 0, 1))  # the overflow slot reads 0

    w = (gate_vals * keep).to(x.dtype)
    if m.dispatch == "per_k":
        y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
        for j in range(m.top_k):
            y = y + expert_out[expert_idx[:, j], slot[:, j]] * w[:, j, None]
    else:
        gathered = expert_out[expert_idx.reshape(-1), slot.reshape(-1)]  # (T*K, D)
        y = (gathered * w.reshape(-1)[:, None]).reshape(t, m.top_k, d).sum(1)

    # load-balance aux loss: E * sum_e (fraction routed to e) * (mean prob e)
    f_e = torch.zeros((e_bank,), dtype=torch.float32, device=x.device)
    f_e = f_e.index_add(0, expert_idx.reshape(-1), keep.reshape(-1).to(torch.float32))
    f_e = f_e[:m.n_experts]
    f_e = f_e / torch.clamp(f_e.sum(), min=1.0)
    aux = m.n_experts * torch.sum(f_e * probs.mean(0)) * m.router_aux_weight

    if m.n_shared_experts:
        y = y + ffn_mod.ffn(params["shared"], xt, cfg.activation)
    if stats is not None:
        stats.update(expert_idx=expert_idx, keep=keep, capacity=cap)
    return y.reshape(b, s, d), aux
