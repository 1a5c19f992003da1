"""Attention blocks: GQA/MQA (+qk_norm, sliding window).

Shapes: x (B, S, D).  KV caches are explicit dicts that ``decode_step``
threads from call to call.  All softmax/logit math is float32; projections
run in the model dtype.

Cache layout:
  GQA : {"k": (B, T, KV, hd), "v": (B, T, KV, hd)} — T is the cache
        capacity (seq_len, or the sliding window for windowed archs,
        maintained as a ring buffer).

``chunked_gqa_attention`` and MLA are not ported yet (ROADMAP Queue 1
item 14).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import apply_rope, causal_mask, rms_norm, softmax_f32


# ----------------------------------------------------------------- params
def init_gqa_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> nn.ParameterDict:
    hd = cfg.resolved_head_dim
    p = {
        "wq": common.init_dense(gen, cfg.d_model, cfg.n_heads * hd, dtype),
        "wk": common.init_dense(gen, cfg.d_model, cfg.kv_heads * hd, dtype),
        "wv": common.init_dense(gen, cfg.d_model, cfg.kv_heads * hd, dtype),
        "wo": common.init_dense(gen, cfg.n_heads * hd, cfg.d_model, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=gen.device)
    return nn.ParameterDict(p)


# ------------------------------------------------------------- GQA apply
def _qk_normalize(q, k, params, cfg: ModelConfig, eps: float):
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], eps)
        k = rms_norm(k, params["k_norm"], eps)
    return q, k


def project_qkv(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """q (B, S, H, hd), k and v (B, S, KV, hd): projected, qk-normed, and
    q and k rotated at ``positions``."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (x @ params["wq"]).reshape(b, s, cfg.n_heads, hd)
    k = (x @ params["wk"]).reshape(b, s, cfg.kv_heads, hd)
    v = (x @ params["wv"]).reshape(b, s, cfg.kv_heads, hd)
    q, k = _qk_normalize(q, k, params, cfg, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(params, x: torch.Tensor, cfg: ModelConfig, *, positions=None) -> torch.Tensor:
    """Full (or sliding-window) causal self-attention over x (B, S, D),
    materializing the (B, KV, G, S, S) scores: the oracle of the flash
    path."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.kv_heads
    g = h // kv
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = project_qkv(params, x, cfg, positions)

    qg = q.reshape(b, s, kv, g, hd)
    scores = torch.einsum("bsigd,btid->bigst", qg, k).to(torch.float32)
    scores = scores * (hd ** -0.5)
    scores = scores + causal_mask(s, s, 0, cfg.sliding_window, x.device)[None, None, None]
    probs = softmax_f32(scores).to(x.dtype)
    out = torch.einsum("bigst,btid->bsigd", probs, v).reshape(b, s, h * hd)
    return out @ params["wo"]


def init_gqa_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, device) -> dict:
    hd = cfg.resolved_head_dim
    t = min(capacity, cfg.sliding_window) if cfg.sliding_window else capacity
    shape = (batch, t, cfg.kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(params, x: torch.Tensor, cache: dict, pos: int, cfg: ModelConfig):
    """One decode step.  x (B, 1, D); ``pos`` = absolute position of the new
    token.  Returns (out (B, 1, D), cache).  The cache is updated in place
    (one slot written, no copy of the (B, T, KV, hd) buffers) and returned,
    so callers thread it as the reference threads its new cache."""
    b, s, _ = x.shape
    assert s == 1
    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.kv_heads
    g = h // kv
    t = cache["k"].shape[1]

    ppos = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = project_qkv(params, x, cfg, ppos)

    slot = (pos % t) if cfg.sliding_window else pos   # ring buffer when windowed
    ck, cv = cache["k"], cache["v"]
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)

    qg = q.reshape(b, kv, g, hd)
    scores = torch.einsum("bigd,btid->bigt", qg, ck).to(torch.float32) * (hd ** -0.5)
    # valid slots: every filled position (a windowed ring is full once
    # pos >= t)
    slot_idx = torch.arange(t, device=x.device)
    valid = slot_idx <= pos
    if cfg.sliding_window and pos >= t:
        valid = torch.ones_like(valid)
    scores = torch.where(valid[None, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    probs = softmax_f32(scores).to(x.dtype)
    out = torch.einsum("bigt,btid->bigd", probs, cv).reshape(b, 1, h * hd)
    return out @ params["wo"], cache
