"""The language-model core: embeddings -> one block per layer -> head.

The reference scans over periods of its layer pattern so that its lowered
HLO stays one period long; PyTorch runs eagerly, so here the layers are an
``nn.ModuleList`` walked in order.  Layer ``p * len(pattern) + j`` is
period ``p``'s copy of pattern entry ``j``, the reference's slice ``p`` of
``params["blocks"][j]`` (``params_from_numpy`` maps one onto the other).

Dense text models only: the multimodal frontends, multi-token prediction
and the training loss wait (ROADMAP Queue 1 items 14f and 14g).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.trainer import resolve_device
from repro_torch.models import blocks, common
from repro_torch.models.common import rms_norm


class Model(nn.Module):
    """Parameters of ``cfg`` drawn from ``seed`` on ``device`` (the port's
    own init: the reference's ``jax.random`` stream cannot be reproduced,
    so parity runs load its weights with ``params_from_numpy``)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        if cfg.n_codebooks or cfg.n_prefix_embeds:
            raise NotImplementedError(
                f"{cfg.name}: multimodal inputs are not ported yet (ROADMAP Queue 1 item 14f)")
        if cfg.mtp_depth:
            raise NotImplementedError(
                f"{cfg.name}: multi-token prediction is not ported yet "
                "(ROADMAP Queue 1 item 14g)")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        p = len(cfg.pattern)
        self.use_moe = tuple(cfg.is_moe_layer(j) for j in range(p))
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        self.embed = nn.Parameter(common.init_embed(gen, cfg.vocab, cfg.d_model, self.dtype))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                common.init_dense(gen, cfg.d_model, cfg.vocab, self.dtype))
        self.final_norm = nn.Parameter(
            torch.ones((cfg.d_model,), dtype=self.dtype, device=gen.device))
        self.blocks = nn.ModuleList(
            blocks.init_block_params(gen, kind, self.use_moe[i % p], cfg, self.dtype)
            for i, kind in enumerate(cfg.layer_kinds))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -------------------------------------------------------------- embed
    def embed_inputs(self, batch: dict) -> torch.Tensor:
        return self.embed[batch["tokens"].to(self.device)]

    # ------------------------------------------------------------ forward
    def forward(self, x: torch.Tensor, *, caches=None, pos=None):
        """x (B, S, D) -> (hidden (B, S, D), aux, new_caches)."""
        cfg = self.cfg
        decode = caches is not None
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = [] if decode else None
        for i, (blk, kind) in enumerate(zip(self.blocks, cfg.layer_kinds)):
            x, a, nc = blocks.apply_block(blk, x, kind, self.use_moe[i % len(cfg.pattern)], cfg,
                                          cache=caches[i] if decode else None, pos=pos)
            aux = aux + a
            if decode:
                new_caches.append(nc)
        return x, aux, new_caches

    def hidden_to_logits(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        return h @ head

    # -------------------------------------------------------------- decode
    def init_caches(self, batch: int, capacity: int) -> list:
        """One cache per layer, in layer order."""
        return [blocks.init_block_cache(kind, self.cfg, batch, capacity, self.dtype, self.device)
                for kind in self.cfg.layer_kinds]

    def decode_step(self, batch: dict, caches: list, pos: int):
        """One-token decode: ``batch`` holds the NEW token, ``pos`` its
        position.  Returns (logits (B, 1, V), new_caches)."""
        x = self.embed_inputs(batch)
        h, _, new_caches = self(x, caches=caches, pos=pos)
        return self.hidden_to_logits(h), new_caches

    # ------------------------------------------------------------ prefill
    def prefill(self, batch: dict):
        """Full-sequence forward returning (logits, aux); no cache is built
        (cached generation re-feeds tokens through ``decode_step``)."""
        x = self.embed_inputs(batch)
        h, aux, _ = self(x)
        return self.hidden_to_logits(h), aux


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cpu") -> dict[str, torch.Tensor]:
    """The reference's parameter pytree (numpy arrays; ``blocks`` is one
    dict per pattern entry with a leading ``n_periods`` axis) as this
    port's ``state_dict``, in ``cfg.dtype`` on ``device``."""
    dtype = getattr(torch, cfg.dtype)

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)

    state = {k: tensor(v) for k, v in tree.items() if k != "blocks"}
    n_pat = len(cfg.pattern)
    for j, entry in enumerate(tree["blocks"]):
        for name, arr in _flatten(entry):
            for p in range(cfg.n_periods):
                state[f"blocks.{p * n_pat + j}.{name}"] = tensor(arr[p])
    return state
