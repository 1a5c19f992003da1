"""Flash-attention forward for Hopper — the dense-LM prefill's kernel.

It replaces the Pallas ``_flash_kernel`` of
``repro/kernels/flash_attention.py`` (launched from its ``flash_attention``):
causal, sliding-window or full attention over (BH, S, hd) with an online
softmax, so no (S, S) score tensor leaves the chip.  Scale is pre-applied by
the caller.

The function, on every device:
  * scores, softmax, ``m`` and ``l`` are float32 (the reference casts q, k,
    v to float32 in its kernel); the output is ``acc / max(l, 1e-30)`` in
    q's dtype;
  * for bfloat16 q, the probabilities are rounded to bfloat16 before P·V
    (the one place where the function departs from the reference kernel,
    which keeps p in float32; the reference's naive path rounds them the
    same way); float32 keeps p in float32;
  * masked scores are ``-1e30``, not ``-inf``: a row whose first kv tile
    is fully masked then gives ``exp(0) = 1`` terms that the next unmasked
    tile multiplies by ``exp(-1e30 - m) = 0``, never ``NaN``;
  * GQA: k and v may hold ``BH / groups`` heads; query head ``bh`` reads
    kv head ``bh // groups`` (the reference's ``jnp.repeat`` over groups,
    without materializing the repeat).

On a CUDA tensor the route is fixed by the dtype, and neither falls back
to the other or to the plain version:
  * bfloat16 -> ``csrc/flash_attn_sm90.cu`` ``flash_wgmma_kernel``: both
    products as ``wgmma`` tensor-core tiles with float32 accumulators, Q, K
    and V tiles copied by TMA into a ring of stages, one producer warpgroup
    and three consumer warpgroups of 64 query rows (two at hd 192, whose
    accumulator needs the registers of the third).  At the prefill's
    S = 2048 the tensor cores' rate bounds the work (4·hd flops per visible
    pair against 2·(BH + 2·BH/g)·S·hd bytes); every pointer must be 16-byte
    aligned;
  * float32 -> ``csrc/flash_attn.cu`` ``flash_fwd_kernel``: float32 FMAs in
    the CUDA cores (no tensor-core type holds the float32 tolerance), 4 x 4
    register micro-tiles of scores from float4 fragments, the head dim of
    the accumulator split over a half warp, K and V tiles staged by
    ``cp.async`` while the other half of a tile's work runs; bound by the
    float32 rate and, below it, by its shared-memory loads.
Both skip kv tiles that the mask hides from a whole block (their terms are
exactly 0, so the function is the same).  ``_flash_plain`` is the same
computation in PyTorch, 64-row by 64-key tiles in the reference's order
with no skip.  On a CPU tensor the wrapper takes the plain version, at any
head dim; on a CUDA tensor it launches its route's kernel (compiled for
``HEAD_DIMS``) or raises.  Like the reference's kernel, the function has no
backward: with grad enabled and an input that requires grad it raises on
both devices, where the CUDA launch would return a tensor with no autograd
history and a CPU run would train through the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import project_qkv

NEG_INF = -1e30
#: the plain version's tile: query rows and keys per step
BLOCK = 64
#: head dims the kernel is compiled for
HEAD_DIMS = (16, 32, 64, 96, 128, 192)

#: the kernel each dtype launches on a CUDA tensor (a key of LAUNCHES)
ROUTES = {torch.bfloat16: "flash_wgmma", torch.float32: "flash_simt"}
#: per route: its library and launch entry point
ENTRIES = {"flash_wgmma": ("flash_attn_sm90", "flash_sm90_launch"),
           "flash_simt": ("flash_attn", "flash_attn_launch")}

#: kernel launches since the counts were last zeroed (CUDA path only):
#: "flash" counts both routes
LAUNCHES = _build.launch_counts("flash", "flash_wgmma", "flash_simt")


def _check(q, k, v, groups: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"expected (BH, S, hd) tensors, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, hd = q.shape
    if groups < 1 or bh % groups or k.shape != (bh // groups, s, hd) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} with groups={groups} needs k and v of "
                         f"shape {(bh // max(groups, 1), s, hd)}, got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in {tuple(ROUTES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no backward (neither has the reference's Pallas kernel, "
            "which jax.grad cannot transpose): train through attention_impl='naive' or "
            "'chunked', or call it under torch.no_grad()")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, groups: int = 1) -> torch.Tensor:
    """q (BH, S, hd), k and v (BH / groups, S, hd), scale pre-applied ->
    (BH, S, hd) in q's dtype.  Forward only: with grad enabled and any of
    q, k, v requiring grad it raises a ``RuntimeError`` on every device."""
    _check(q, k, v, groups)
    if q.device.type == "cpu":
        return _flash_plain(q, k, v, causal=causal, window=window, groups=groups)
    return _flash_cuda(q, k, v, causal, window, groups)


def _flash_plain(q, k, v, *, causal: bool = True, window: int = 0,
                 groups: int = 1) -> torch.Tensor:
    """Plain version of both kernels: per query tile, the online softmax
    over every kv tile in order, as the reference's grid runs it; P is
    rounded to q's dtype before P·V when that is bfloat16."""
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
            acc = acc * corr[:, :, None] + p.to(q.dtype).to(torch.float32) @ vb
            m = m_new
        out[:, q0:q0 + BLOCK] = (acc / torch.clamp(l, min=1e-30)[:, :, None]).to(q.dtype)
    return out


def check_tma_aligned(*tensors: torch.Tensor) -> None:
    """TMA copies need every base address 16-byte aligned: raise if not."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"the wgmma flash kernel reads through TMA and needs 16-byte "
                             f"aligned tensors; got address {t.data_ptr():#x} "
                             f"(shape {tuple(t.shape)}, storage offset {t.storage_offset()})")


def _flash_cuda(q, k, v, causal: bool, window: int, groups: int) -> torch.Tensor:
    if q.shape[-1] not in HEAD_DIMS:  # the plain version takes any head dim
        raise ValueError(f"head dim {q.shape[-1]}: the flash kernels are compiled for head "
                         f"dims {HEAD_DIMS} only")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    bh, s, hd = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    route = ROUTES[q.dtype]
    if route == "flash_wgmma":
        check_tma_aligned(q, k, v, out)
    else:  # cp.async copies 16 bytes: a view off that alignment is copied
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    _build.launch(*ENTRIES[route], f"flash-attention ({route})", q.device,
                  _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
                  bh, s, hd, groups, int(causal), int(window), count=("flash", route))
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
