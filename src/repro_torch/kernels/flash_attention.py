"""Flash-attention forward for Hopper — the dense-LM prefill's kernel.

``csrc/flash_attn.cu`` ``flash_fwd_kernel`` replaces the Pallas
``_flash_kernel`` of ``repro/kernels/flash_attention.py`` (launched from its
``flash_attention``): causal, sliding-window or full attention over
(BH, S, hd) with an online softmax, so no (S, S) score tensor leaves the
chip.  Scale is pre-applied by the caller.

The function, on every device:
  * q, k, v are float32 or bfloat16; scores, softmax and the P·V product
    are float32 (the reference casts q, k, v to float32 in its kernel and
    keeps p in float32); the output is ``acc / max(l, 1e-30)`` in q's dtype;
  * masked scores are ``-1e30``, not ``-inf``: a row whose first kv tile
    is fully masked then gives ``exp(0) = 1`` terms that the next unmasked
    tile multiplies by ``exp(-1e30 - m) = 0``, never ``NaN``;
  * GQA: k and v may hold ``BH / groups`` heads; query head ``bh`` reads
    kv head ``bh // groups`` (the reference's ``jnp.repeat`` over groups,
    without materializing the repeat).

The kernel works on tiles of 64 query rows by 64 keys and skips kv tiles
that the mask hides entirely (their terms are exactly 0, so the function
is the same).  ``_flash_plain`` is the same computation in PyTorch, kv
tile after kv tile in the reference's order with no skip.  On a CPU
tensor the wrapper takes the plain version; on a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import project_qkv

NEG_INF = -1e30
#: the kernel's tile: query rows per block and keys per staged kv tile
BLOCK = 64
#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the count was last zeroed (CUDA path only)
LAUNCHES = {"flash": 0}


def _check(q, k, v, groups: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"expected (BH, S, hd) tensors, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, hd = q.shape
    if groups < 1 or bh % groups or k.shape != (bh // groups, s, hd) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} with groups={groups} needs k and v of "
                         f"shape {(bh // max(groups, 1), s, hd)}, got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in {tuple(_DTYPES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash-attention kernel for device {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, groups: int = 1) -> torch.Tensor:
    """q (BH, S, hd), k and v (BH / groups, S, hd), scale pre-applied ->
    (BH, S, hd) in q's dtype."""
    _check(q, k, v, groups)
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, causal=causal, window=window, groups=groups)
    return _flash_cuda(q, k, v, causal, window, groups)


def _flash_plain(q, k, v, *, causal: bool = True, window: int = 0,
                 groups: int = 1) -> torch.Tensor:
    """Plain version of ``flash_fwd_kernel``: per query tile, the online
    softmax over every kv tile in order, as the reference's grid runs it."""
    bh, s, hd = q.shape
    if groups > 1:
        k = k.repeat_interleave(groups, dim=0)
        v = v.repeat_interleave(groups, dim=0)
    out = torch.empty_like(q)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    for q0 in range(0, s, BLOCK):
        qb = q[:, q0:q0 + BLOCK].to(torch.float32)                   # (BH, Qb, hd)
        n_q = qb.shape[1]
        m = torch.full((bh, n_q), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((bh, n_q), dtype=torch.float32, device=q.device)
        acc = torch.zeros((bh, n_q, hd), dtype=torch.float32, device=q.device)
        q_pos = q0 + torch.arange(n_q, device=q.device)[:, None]
        for k0 in range(0, s, BLOCK):
            kb = k[:, k0:k0 + BLOCK].to(torch.float32)                 # (BH, Kb, hd)
            vb = v[:, k0:k0 + BLOCK].to(torch.float32)
            scores = qb @ kb.transpose(1, 2)                            # (BH, Qb, Kb)
            k_pos = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
            ok = torch.ones((n_q, kb.shape[1]), dtype=torch.bool, device=q.device)
            if causal:
                ok = ok & (k_pos <= q_pos)
            if window:
                ok = ok & (k_pos > q_pos - window)
            scores = torch.where(ok, scores, neg)
            m_new = torch.maximum(m, scores.amax(dim=2))
            p = torch.exp(scores - m_new[:, :, None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=2)
            acc = acc * corr[:, :, None] + p @ vb
            m = m_new
        out[:, q0:q0 + BLOCK] = (acc / torch.clamp(l, min=1e-30)[:, :, None]).to(q.dtype)
    return out


@functools.cache
def _lib():
    lib = _build.load("flash_attn")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attn_launch.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.flash_attn_launch.restype = i32
    lib.flash_error_string.argtypes = [i32]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _flash_cuda(q, k, v, causal: bool, window: int, groups: int) -> torch.Tensor:
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bh, s, hd = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    dev = q.device
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.flash_attn_launch(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
                                   bh, s, hd, groups, int(causal), int(window), _DTYPES[q.dtype],
                                   _build.stream(dev))
    if rc != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: "
                           f"{lib.flash_error_string(rc).decode()}")
    LAUNCHES["flash"] += 1
    return out


def gqa_flash_attention(params, x: torch.Tensor, cfg, *, positions=None) -> torch.Tensor:
    """Drop-in replacement for ``models.attention.gqa_attention`` through
    the flash kernel (``attention_impl == "flash"``)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.kv_heads
    g = h // kv
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = project_qkv(params, x, cfg, positions)

    # flatten (b, kv, g) -> BH for q and (b, kv) for k and v; head bh reads
    # kv head bh // g, the reference's repeat over groups
    qf = (q.reshape(b, s, kv, g, hd) * hd ** -0.5).permute(0, 2, 3, 1, 4)
    qf = qf.reshape(b * kv * g, s, hd).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(b * kv, s, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(b * kv, s, hd).contiguous()

    o = flash_attention(qf, kf, vf, causal=True, window=cfg.sliding_window, groups=g)
    o = o.reshape(b, kv, g, s, hd).permute(0, 3, 1, 2, 4).reshape(b, s, h * hd)
    return o @ params["wo"]


def flash_hbm_bytes(b, s, h, kv, hd, dtype_bytes: int = 2, block_q: int = 512) -> int:
    """The reference's analytic per-layer HBM traffic of its kernel: Q read
    once, K/V read once per q-block pass (grid revisits them), O written
    once."""
    n_q = s // block_q
    q_o = 2 * b * h * s * hd * dtype_bytes
    kv_reads = 2 * b * h * s * hd * dtype_bytes * n_q
    return q_o + kv_reads
