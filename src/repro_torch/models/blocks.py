"""Block wiring: (mixer -> FFN) with pre-norm residuals, per layer kind.

A model is ``n_layers`` blocks, layer ``i`` of kind
``cfg.layer_kinds[i]``.  The port runs the ``"attn"`` kind with GQA and a
dense FFN; ``attention_impl`` picks the naive path (``"naive"``) or the
flash kernel (``"flash"``).  The reference's ``shard_hint`` calls are the
identity without a mesh and are left out.  What is not ported raises
``NotImplementedError`` naming its ``ROADMAP.md`` item.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import gqa_flash_attention
from repro_torch.models import attention, ffn as ffn_mod
from repro_torch.models.common import rms_norm

_WAITS = {
    "chunked": "chunked_gqa_attention is not ported yet (ROADMAP Queue 1 item 14b)",
    "mla": "MLA attention is not ported yet (ROADMAP Queue 1 item 14c)",
    "moe": "the MoE FFN is not ported yet (ROADMAP Queue 1 item 14d)",
    "ssm": "the SSM / xLSTM mixers are not ported yet (ROADMAP Queue 1 item 14e)",
}


def check_supported(kind: str, use_moe: bool, cfg: ModelConfig) -> None:
    """Raise for a layer this port cannot run yet."""
    if kind in ("mamba", "mlstm", "slstm"):
        raise NotImplementedError(f"{cfg.name}: {kind}: {_WAITS['ssm']}")
    if kind != "attn":
        raise ValueError(kind)
    if cfg.mla:
        raise NotImplementedError(f"{cfg.name}: {_WAITS['mla']}")
    if use_moe:
        raise NotImplementedError(f"{cfg.name}: {_WAITS['moe']}")
    if cfg.attention_impl in ("chunked", "chunked_seqpar"):
        raise NotImplementedError(f"{cfg.name}: {_WAITS['chunked']}")
    if cfg.attention_impl not in ("naive", "flash"):
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")


class Block(nn.Module):
    """One layer's parameters: ``norm1``, ``mixer`` (wq, wk, wv, wo and the
    qk norms), and, when ``d_ff``, ``norm2`` and ``ffn``."""

    def __init__(self, gen: torch.Generator, kind: str, use_moe: bool, cfg: ModelConfig, dtype):
        super().__init__()
        check_supported(kind, use_moe, cfg)
        ones = torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)
        self.norm1 = nn.Parameter(ones)
        self.mixer = attention.init_gqa_params(gen, cfg, dtype)
        if cfg.d_ff:
            self.norm2 = nn.Parameter(ones.clone())
            self.ffn = ffn_mod.init_ffn_params(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype)


def init_block_params(gen: torch.Generator, kind: str, use_moe: bool, cfg: ModelConfig,
                      dtype) -> Block:
    return Block(gen, kind, use_moe, cfg, dtype)


def apply_block(params: Block, x: torch.Tensor, kind: str, use_moe: bool, cfg: ModelConfig, *,
                cache=None, pos=None):
    """-> (x, aux_loss, new_cache).  ``cache`` enables one-token decode."""
    check_supported(kind, use_moe, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    new_cache = None
    if cache is not None:
        out, new_cache = attention.gqa_decode(params.mixer, h, cache, pos, cfg)
    elif cfg.attention_impl == "flash":
        out = gqa_flash_attention(params.mixer, h, cfg)
    else:
        out = attention.gqa_attention(params.mixer, h, cfg)
    x = x + out

    if hasattr(params, "ffn"):
        h2 = rms_norm(x, params.norm2, cfg.norm_eps)
        x = x + ffn_mod.ffn(params.ffn, h2, cfg.activation)
    return x, aux, new_cache


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, capacity: int, dtype, device):
    check_supported(kind, False, cfg)
    return attention.init_gqa_cache(cfg, batch, capacity, dtype, device)
