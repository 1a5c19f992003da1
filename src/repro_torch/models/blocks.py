"""Block wiring: (mixer -> FFN/MoE) with pre-norm residuals, per layer kind.

A model is ``n_layers`` blocks, layer ``i`` of kind
``cfg.layer_kinds[i]``: ``"attn"`` (MLA when ``cfg.mla``, else GQA through
``attention_impl``: ``"naive"``, ``"chunked"`` / ``"chunked_seqpar"`` or the
flash kernel, ``"flash"``), or one of the SSM / xLSTM mixers of
``models/ssm.py`` (``"mamba"``, ``"mlstm"``, ``"slstm"``), then an MoE or
dense FFN where the config has one.  The residual stream carries the
reference's ``shard_hint``s (``models/sharding.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import gqa_flash_attention
from repro_torch.models import attention, ffn as ffn_mod, moe as moe_mod, ssm
from repro_torch.models.common import rms_norm
from repro_torch.models.sharding import shard_hint

_IMPLS = ("naive", "chunked", "chunked_seqpar", "flash")
#: per SSM / xLSTM kind: (init params, mixer, init state)
_SSM = {"mamba": (ssm.init_mamba_params, ssm.mamba_mixer, ssm.init_mamba_state),
        "mlstm": (ssm.init_mlstm_params, ssm.mlstm_mixer, ssm.init_mlstm_state),
        "slstm": (ssm.init_slstm_params, ssm.slstm_mixer, ssm.init_slstm_state)}


def check_supported(kind: str, cfg: ModelConfig) -> None:
    """Raise for a layer kind or attention impl the reference does not have."""
    if kind in _SSM:
        return
    if kind != "attn":
        raise ValueError(kind)
    if cfg.attention_impl not in _IMPLS:
        raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")


class Block(nn.Module):
    """One layer's parameters: ``norm1``, ``mixer`` (GQA: wq, wk, wv, wo
    and the qk norms; MLA: wq_a, q_norm, wq_b, wkv_a, kv_norm, wkv_b, wo;
    the SSM kinds: their ``models/ssm.py`` leaves), and, when ``d_ff`` or
    MoE, ``norm2`` and ``ffn``."""

    def __init__(self, gen: torch.Generator, kind: str, use_moe: bool, cfg: ModelConfig, dtype):
        super().__init__()
        check_supported(kind, cfg)
        ones = torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)
        self.norm1 = nn.Parameter(ones)
        if kind in _SSM:
            self.mixer = _SSM[kind][0](gen, cfg, dtype)
        else:
            self.mixer = (attention.init_mla_params(gen, cfg, dtype) if cfg.mla
                          else attention.init_gqa_params(gen, cfg, dtype))
        if cfg.d_ff or use_moe:
            self.norm2 = nn.Parameter(ones.clone())
            self.ffn = (moe_mod.init_moe_params(gen, cfg, dtype) if use_moe else
                        ffn_mod.init_ffn_params(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype))


def init_block_params(gen: torch.Generator, kind: str, use_moe: bool, cfg: ModelConfig,
                      dtype) -> Block:
    return Block(gen, kind, use_moe, cfg, dtype)


def _prefill_attention(cfg: ModelConfig):
    if cfg.mla:
        return attention.mla_attention
    if cfg.attention_impl in ("chunked", "chunked_seqpar"):
        return attention.chunked_gqa_attention
    if cfg.attention_impl == "flash":
        return gqa_flash_attention
    return attention.gqa_attention


def apply_block(params: Block, x: torch.Tensor, kind: str, use_moe: bool, cfg: ModelConfig, *,
                cache=None, pos=None):
    """-> (x, aux_loss, new_cache).  ``cache`` enables one-token decode."""
    check_supported(kind, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, params.norm1, cfg.norm_eps)
    new_cache = None
    if kind in _SSM:
        out, new_cache = _SSM[kind][1](params.mixer, h, cfg, state=cache)
    elif cache is not None:
        decode = attention.mla_decode if cfg.mla else attention.gqa_decode
        out, new_cache = decode(params.mixer, h, cache, pos, cfg)
    else:
        out = _prefill_attention(cfg)(params.mixer, h, cfg)
    x = shard_hint(x + out, "batch", None, "model_act")

    if hasattr(params, "ffn"):
        h2 = rms_norm(x, params.norm2, cfg.norm_eps)
        if use_moe:
            y, aux = moe_mod.moe_ffn(params.ffn, h2, cfg)
        else:
            y = ffn_mod.ffn(params.ffn, h2, cfg.activation)
        x = shard_hint(x + y, "batch", None, "model_act")
    return x, aux, new_cache


def init_block_cache(kind: str, cfg: ModelConfig, batch: int, capacity: int, dtype, device):
    check_supported(kind, cfg)
    if kind in _SSM:
        return _SSM[kind][2](cfg, batch, dtype, device)
    init = attention.init_mla_cache if cfg.mla else attention.init_gqa_cache
    return init(cfg, batch, capacity, dtype, device)
