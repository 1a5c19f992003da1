"""Attention blocks: GQA/MQA (+qk_norm, sliding window), its chunked
online-softmax form, and DeepSeek MLA.

Shapes: x (B, S, D).  KV caches are explicit dicts that ``decode_step``
threads from call to call, updated in place.  All softmax/logit math is
float32; projections run in the model dtype.

Cache layouts:
  GQA : {"k": (B, T, KV, hd), "v": (B, T, KV, hd)} — T is the cache
        capacity (seq_len, or the sliding window for windowed archs,
        maintained as a ring buffer).
  MLA : {"ckv": (B, T, kv_lora), "krope": (B, T, rope_dim)} — the
        compressed latent is cached once, not per head (kv_lora + rope
        values a token).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import MLAConfig, ModelConfig
from repro_torch.models import common
from repro_torch.models.common import apply_rope, causal_mask, rms_norm, softmax_f32
from repro_torch.models.sharding import shard_hint


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


def init_mla_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> nn.ParameterDict:
    m = cfg.mla
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    ones = lambda n: torch.ones((n,), dtype=dtype, device=gen.device)  # noqa: E731
    return nn.ParameterDict({
        "wq_a": common.init_dense(gen, cfg.d_model, m.q_lora_rank, dtype),
        "q_norm": ones(m.q_lora_rank),
        "wq_b": common.init_dense(gen, m.q_lora_rank, cfg.n_heads * qk_head, dtype),
        "wkv_a": common.init_dense(gen, cfg.d_model, m.kv_lora_rank + m.qk_rope_head_dim, dtype),
        "kv_norm": ones(m.kv_lora_rank),
        "wkv_b": common.init_dense(gen, m.kv_lora_rank,
                                   cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim), dtype),
        "wo": common.init_dense(gen, cfg.n_heads * m.v_head_dim, cfg.d_model, dtype),
    })


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


def chunked_gqa_attention(params, x: torch.Tensor, cfg: ModelConfig, *,
                          positions=None) -> torch.Tensor:
    """Causal (or sliding-window) attention as the reference's
    ``chunked_gqa_attention``: per query chunk, an online softmax over
    every KV chunk in order (the running max starts at -inf, masked scores
    are -1e30, p is cast to the model dtype before P·V), so the
    (B, H, S, S) scores are never materialized.  Fully masked chunks run
    and contribute 0.  ``"chunked_seqpar"`` runs the same loop with the
    query chunks hinted over the ``model`` axis, as the reference's
    ``shard_hint``s spread them."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.kv_heads
    g = h // kv
    ck = min(cfg.attention_chunk, s)
    if s % ck:
        raise ValueError(f"sequence length {s} is not a multiple of attention_chunk {ck}")
    n_chunks = s // ck
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = project_qkv(params, x, cfg, positions)

    qg = q.reshape(b, n_chunks, ck, kv, g, hd) * (hd ** -0.5)
    seqpar = cfg.attention_impl == "chunked_seqpar"
    if seqpar:
        qg = shard_hint(qg, "batch", "model", None, None, None, None)
    kc = k.reshape(b, n_chunks, ck, kv, hd)
    vc = v.reshape(b, n_chunks, ck, kv, hd)
    ar = torch.arange(ck, device=x.device)
    neg = torch.tensor(-1e30, dtype=torch.float32, device=x.device)
    outs = []
    for qi in range(n_chunks):
        q_tile = qg[:, qi]                                           # (b, ck, kv, g, hd)
        m_run = torch.full((b, kv, g, ck), float("-inf"), dtype=torch.float32, device=x.device)
        l_run = torch.zeros((b, kv, g, ck), dtype=torch.float32, device=x.device)
        acc = torch.zeros((b, kv, g, ck, hd), dtype=torch.float32, device=x.device)
        q_pos = qi * ck + ar[:, None]
        for kj in range(n_chunks):
            scores = torch.einsum("bsigd,btid->bigst", q_tile, kc[:, kj]).to(torch.float32)
            k_pos = kj * ck + ar[None, :]
            ok = k_pos <= q_pos
            if cfg.sliding_window:
                ok = ok & (k_pos > q_pos - cfg.sliding_window)
            scores = torch.where(ok, scores, neg)
            m_new = torch.maximum(m_run, scores.amax(-1))            # (b, kv, g, ck)
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            pv = torch.einsum("bigst,btid->bigsd", p.to(x.dtype), vc[:, kj]).to(torch.float32)
            acc = acc * corr[..., None] + pv
            m_run = m_new
        out = acc / torch.clamp(l_run[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))                     # (b, ck, kv, g, hd)
    outs = torch.stack(outs, dim=1)                                  # (b, n, ck, kv, g, hd)
    if seqpar:
        outs = shard_hint(outs, "batch", "model", None, None, None, None)
    out = outs.reshape(b, s, h * hd).to(x.dtype)
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


# ------------------------------------------------------------- MLA apply
def _mla_dims(m: MLAConfig):
    return m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim


def _mla_query(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """q_nope (B, S, H, nope) and q_rope (B, S, H, rope), rotated."""
    b, s, _ = x.shape
    nope, rope_d, _ = _mla_dims(cfg.mla)
    q_lat = rms_norm(x @ params["wq_a"], params["q_norm"], cfg.norm_eps)
    q = (q_lat @ params["wq_b"]).reshape(b, s, cfg.n_heads, nope + rope_d)
    return q[..., :nope], apply_rope(q[..., nope:], positions, cfg.rope_theta)


def _mla_latent(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """The cached pair: ckv (B, S, kv_lora), normed, and k_rope
    (B, S, 1, rope), rotated."""
    r = cfg.mla.kv_lora_rank
    kv_a = x @ params["wkv_a"]                                      # (B, S, kv_lora + rope)
    ckv = rms_norm(kv_a[..., :r], params["kv_norm"], cfg.norm_eps)
    return ckv, apply_rope(kv_a[..., None, r:], positions, cfg.rope_theta)


def mla_attention(params, x: torch.Tensor, cfg: ModelConfig, *, positions=None) -> torch.Tensor:
    """Prefill MLA in the decompressed form: K and V per head from the
    latent, causal softmax over (B, H, S, S) scores."""
    b, s, _ = x.shape
    nope, rope_d, vd = _mla_dims(cfg.mla)
    h = cfg.n_heads
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q_nope, q_rope = _mla_query(params, x, cfg, positions)
    ckv, k_rope = _mla_latent(params, x, cfg, positions)
    kvb = (ckv @ params["wkv_b"]).reshape(b, s, h, nope + vd)
    k_nope, v = kvb[..., :nope], kvb[..., nope:]

    scale = (nope + rope_d) ** -0.5
    scores = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
              + torch.einsum("bshd,btxd->bhst", q_rope, k_rope.expand(b, s, 1, rope_d)))
    scores = scores.to(torch.float32) * scale
    scores = scores + causal_mask(s, s, 0, 0, x.device)[None, None]
    probs = softmax_f32(scores).to(x.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, v).reshape(b, s, h * vd)
    return out @ params["wo"]


def init_mla_cache(cfg: ModelConfig, batch: int, capacity: int, dtype, device) -> dict:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, capacity, m.kv_lora_rank), dtype=dtype, device=device),
            "krope": torch.zeros((batch, capacity, m.qk_rope_head_dim), dtype=dtype,
                                 device=device)}


def mla_decode(params, x: torch.Tensor, cache: dict, pos: int, cfg: ModelConfig):
    """One decode step in the absorbed latent form: W^UK folds into the
    query and W^UV into the output, so the scores and the context live in
    the kv_lora_rank space and the cache holds kv_lora + rope values a
    token.  The cache is updated in place and returned.  ``pos`` past the
    cache raises (the reference's ``dynamic_update_slice`` clamps it)."""
    b, s, _ = x.shape
    assert s == 1
    m = cfg.mla
    nope, rope_d, vd = _mla_dims(m)
    h = cfg.n_heads
    t = cache["ckv"].shape[1]
    if not 0 <= pos < t:
        raise IndexError(f"decode position {pos} is outside the MLA cache of {t} slots")

    ppos = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_query(params, x, cfg, ppos)
    ckv_new, kr_new = _mla_latent(params, x, cfg, ppos)
    ckv, krope = cache["ckv"], cache["krope"]
    ckv[:, pos] = ckv_new[:, 0].to(ckv.dtype)
    krope[:, pos] = kr_new[:, 0, 0].to(krope.dtype)

    # absorb W^UK into the query: q_abs[b,h,r] = sum_d q_nope[b,h,d] * Wuk[r,h,d]
    wkv_b = params["wkv_b"].reshape(m.kv_lora_rank, h, nope + vd)
    w_uk, w_uv = wkv_b[..., :nope], wkv_b[..., nope:]
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)          # (B, H, R)

    scale = (nope + rope_d) ** -0.5
    scores = (torch.einsum("bhr,btr->bht", q_abs, ckv)
              + torch.einsum("bhd,btd->bht", q_rope[:, 0], krope))
    scores = scores.to(torch.float32) * scale
    valid = torch.arange(t, device=x.device) <= pos
    scores = torch.where(valid[None, None, :], scores, torch.full_like(scores, -1e30))
    probs = softmax_f32(scores).to(x.dtype)
    ctx = torch.einsum("bht,btr->bhr", probs, ckv)                    # latent context
    out = torch.einsum("bhr,rhd->bhd", ctx, w_uv).reshape(b, 1, h * vd)
    return out @ params["wo"], cache
