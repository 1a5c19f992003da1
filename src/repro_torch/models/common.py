"""Shared model substrate: norms, RoPE, initializers, masks, cross-entropy."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalise in float32, cast back to ``x``'s dtype, then scale in it."""
    dt = x.dtype
    xf = x.to(torch.float32)
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv).to(dt) * scale.to(dt)


class ShapeOnly:
    """Stands in for a ``torch.Generator`` on the ``meta`` device, which has
    none: a model built with it has every parameter's shape and dtype and
    draws nothing."""

    device = torch.device("meta")


def randn(gen, shape: tuple[int, ...]) -> torch.Tensor:
    """N(0, 1) float32 of ``shape`` drawn on ``gen`` (a ``ShapeOnly``
    generator gives an empty ``meta`` tensor)."""
    if isinstance(gen, ShapeOnly):
        return torch.empty(shape, dtype=torch.float32, device=gen.device)
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)


#: a weight past this many elements is drawn a block of rows at a time, so
#: its float32 temporaries stay near 1 GiB (a full-width embedding is 4.7 G)
DRAW_ELEMS = 1 << 28


def _draw(gen: torch.Generator, rows: int, cols: int, scale: float, dtype) -> torch.Tensor:
    """(rows, cols), N(0, 1) * scale, drawn in float32 on ``gen``'s device."""
    if rows * cols <= DRAW_ELEMS:
        w = randn(gen, (rows, cols))
        return (w * scale).to(dtype)
    out = torch.empty((rows, cols), dtype=dtype, device=gen.device)
    step = max(1, DRAW_ELEMS // cols)
    for r0 in range(0, rows, step):
        n = min(rows, r0 + step) - r0
        w = randn(gen, (n, cols))
        out[r0:r0 + n] = (w * scale).to(dtype)
    return out


def init_dense(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    """(in_dim, out_dim) weight, N(0, 1) * scale (default in_dim ** -0.5),
    drawn in float32 on ``gen``'s device."""
    return _draw(gen, in_dim, out_dim, scale if scale is not None else in_dim ** -0.5, dtype)


def init_embed(gen: torch.Generator, vocab: int, d_model: int, dtype) -> torch.Tensor:
    return _draw(gen, vocab, d_model, 0.02, dtype)


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    Rotates the interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` and
    interleaves them again (the reference's convention, not the half-split
    one)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                               # (hd/2,)
    ang = positions[..., :, None, None].to(torch.float32) * freqs         # (...,S,1,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = x[..., 0::2].to(torch.float32)
    x2 = x[..., 1::2].to(torch.float32)
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def causal_mask(q_len: int, kv_len: int, q_offset: int, window: int = 0,
                device=None) -> torch.Tensor:
    """(q_len, kv_len) additive float32 mask.  ``q_offset`` = absolute
    position of query row 0.  ``window`` > 0 -> sliding-window causal."""
    q_pos = q_offset + torch.arange(q_len, device=device)[:, None]
    k_pos = torch.arange(kv_len, device=device)[None, :]
    ok = k_pos <= q_pos
    if window:
        ok = ok & (k_pos > q_pos - window)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def softmax_f32(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(logits.to(torch.float32), dim=dim)


def activation_fn(name: str):
    if name == "silu_gated" or name == "silu":
        return F.silu
    if name == "gelu":                  # jax.nn.gelu's default is the tanh form
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":                 # Nemotron-4 squared ReLU
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE in float32.  logits (..., V), labels (...) int."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
