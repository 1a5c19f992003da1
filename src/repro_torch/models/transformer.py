"""The language-model core: embeddings -> one block per layer -> head.

The reference scans over periods of its layer pattern so that its lowered
HLO stays one period long; PyTorch runs eagerly, so here the layers are an
``nn.ModuleList`` walked in order.  Layer ``p * len(pattern) + j`` is
period ``p``'s copy of pattern entry ``j``, the reference's slice ``p`` of
``params["blocks"][j]`` (``params_from_numpy`` maps one onto the other).

Every family of the reference: dense or MoE, GQA or MLA, the SSM / xLSTM
mixers (``pattern``), and the stub multimodal frontends:
  vlm   : precomputed patch embeddings (``image_embeds``) through the
          ``projector``, prepended to the text tokens;
  audio : K codebook embeddings summed per frame, K output heads, logits
          (B, S, K, V).
DeepSeek's multi-token prediction head (``mtp_proj``, ``mtp_norm``) enters
``Model.loss`` only, as in the reference: serving does not use it.

``loss`` is the training forward.  With ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` (non-reentrant) while grad is enabled: its
activations are recomputed in the backward, as the reference's
``jax.checkpoint`` of its scan body recomputes them.  That changes memory,
not numbers.  ``prefill`` and ``decode_step`` are the serving forwards and
run without autograd.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.checkpoint.checkpoint import to_numpy
from repro_torch.core.trainer import resolve_device
from repro_torch.models import blocks, common, ssm
from repro_torch.models.common import cross_entropy, rms_norm
from repro_torch.models.sharding import shard_hint


class Model(nn.Module):
    """Parameters of ``cfg`` drawn from ``seed`` on ``device`` (the port's
    own init: the reference's ``jax.random`` stream cannot be reproduced,
    so parity runs load its weights with ``params_from_numpy``).  On
    ``device="meta"`` the model is shape-only: it draws nothing and
    allocates nothing (the dry-run's counterpart of ``jax.eval_shape``)."""

    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        p = len(cfg.pattern)
        self.use_moe = tuple(cfg.is_moe_layer(j) for j in range(p))
        dev = torch.device(device)
        gen = (common.ShapeOnly() if dev.type == "meta"
               else torch.Generator(device=resolve_device(dev)).manual_seed(seed))
        if cfg.n_codebooks:
            k = cfg.n_codebooks
            self.embed = nn.Parameter(torch.stack(
                [common.init_embed(gen, cfg.vocab, cfg.d_model, self.dtype) for _ in range(k)]))
            self.heads = nn.Parameter(torch.stack(
                [common.init_dense(gen, cfg.d_model, cfg.vocab, self.dtype) for _ in range(k)]))
        else:
            self.embed = nn.Parameter(common.init_embed(gen, cfg.vocab, cfg.d_model, self.dtype))
            if not cfg.tie_embeddings:
                self.lm_head = nn.Parameter(
                    common.init_dense(gen, cfg.d_model, cfg.vocab, self.dtype))
        if cfg.n_prefix_embeds:
            self.projector = nn.Parameter(
                common.init_dense(gen, cfg.prefix_embed_dim, cfg.d_model, self.dtype))
        self.final_norm = nn.Parameter(
            torch.ones((cfg.d_model,), dtype=self.dtype, device=gen.device))
        if cfg.mtp_depth:
            self.mtp_proj = nn.Parameter(
                common.init_dense(gen, 2 * cfg.d_model, cfg.d_model, self.dtype))
            self.mtp_norm = nn.Parameter(
                torch.ones((cfg.d_model,), dtype=self.dtype, device=gen.device))
        self.blocks = nn.ModuleList(
            blocks.init_block_params(gen, kind, self.use_moe[i % p], cfg, self.dtype)
            for i, kind in enumerate(cfg.layer_kinds))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -------------------------------------------------------------- embed
    def embed_inputs(self, batch: dict) -> torch.Tensor:
        """``tokens`` (B, S) or, for audio, ``codes`` (B, S, K) -> (B, S, D);
        a VLM batch's ``image_embeds`` (B, P, prefix_dim), projected, go
        first (B, P + S, D)."""
        cfg = self.cfg
        if cfg.n_codebooks:
            codes = batch["codes"].to(self.device)
            x = torch.zeros(codes.shape[:2] + (cfg.d_model,), dtype=self.dtype,
                            device=self.device)
            for k in range(cfg.n_codebooks):
                x = x + self.embed[k][codes[..., k]]
        else:
            x = self.embed[batch["tokens"].to(self.device)]
        if cfg.n_prefix_embeds and "image_embeds" in batch:
            prefix = batch["image_embeds"].to(self.device, self.dtype) @ self.projector
            x = torch.cat([prefix, x], dim=1)
        return shard_hint(x, "batch", None, None)

    # ------------------------------------------------------------ forward
    def forward(self, x: torch.Tensor, *, caches=None, pos=None):
        """x (B, S, D) -> (hidden (B, S, D), aux, new_caches).  Each layer
        is checkpointed when ``cfg.remat``, grad is enabled and there is
        no cache."""
        cfg = self.cfg
        decode = caches is not None
        remat = cfg.remat and not decode and torch.is_grad_enabled()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = [] if decode else None
        for i, (blk, kind) in enumerate(zip(self.blocks, cfg.layer_kinds)):
            use_moe = self.use_moe[i % len(cfg.pattern)]
            if remat:
                x, a = checkpoint(self._layer, blk, x, kind, use_moe, use_reentrant=False)
            else:
                x, a, nc = blocks.apply_block(blk, x, kind, use_moe, cfg,
                                              cache=caches[i] if decode else None, pos=pos)
                if decode:
                    new_caches.append(nc)
            aux = aux + a
        return x, aux, new_caches

    def _layer(self, blk, x, kind: str, use_moe: bool):
        x, a, _ = blocks.apply_block(blk, x, kind, use_moe, self.cfg)
        return x, a

    def hidden_to_logits(self, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = rms_norm(h, self.final_norm, cfg.norm_eps)
        if cfg.n_codebooks:
            return torch.einsum("bsd,kdv->bskv", h, self.heads)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        return shard_hint(h @ head, "batch", None, "model")

    # --------------------------------------------------------------- loss
    def loss(self, batch: dict) -> torch.Tensor:
        """The reference's training loss, a float32 scalar: next-token
        cross-entropy (for a VLM batch over the text after the
        ``n_prefix_embeds`` patches; for audio over every codebook), plus
        DeepSeek's MTP term at weight 0.3 (``tokens[:, 2:]`` predicted from
        ``[h_t ; embed(tok_{t+1})]`` through ``mtp_proj`` and ``mtp_norm``),
        plus the MoE aux loss."""
        cfg = self.cfg
        x = self.embed_inputs(batch)
        h, aux, _ = self(x)
        logits = self.hidden_to_logits(h)
        if cfg.n_codebooks:
            codes = batch["codes"].to(self.device)
            ce = cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab), codes[:, 1:].reshape(-1))
        else:
            labels = batch["tokens"].to(self.device)
            pfx = cfg.n_prefix_embeds if "image_embeds" in batch else 0
            lg = logits[:, pfx:]                                     # text region only
            ce = cross_entropy(lg[:, :-1], labels[:, 1:])
            if cfg.mtp_depth:
                hh = h[:, pfx:]
                emb_next = self.embed[labels[:, 1:]]
                z = torch.cat([hh[:, :-1], emb_next], dim=-1) @ self.mtp_proj
                z = rms_norm(z, self.mtp_norm, cfg.norm_eps)
                head = self.embed.T if cfg.tie_embeddings else self.lm_head
                ce = ce + 0.3 * cross_entropy(z[:, :-1] @ head, labels[:, 2:])
        return ce + aux

    # -------------------------------------------------------------- decode
    def init_caches(self, batch: int, capacity: int) -> list:
        """One cache per layer, in layer order."""
        return [blocks.init_block_cache(kind, self.cfg, batch, capacity, self.dtype, self.device)
                for kind in self.cfg.layer_kinds]

    @torch.no_grad()
    def decode_step(self, batch: dict, caches: list, pos: int):
        """One-token decode: ``batch`` holds the NEW token, ``pos`` its
        position.  Returns (logits (B, 1, V) or (B, 1, K, V), new_caches)."""
        x = self.embed_inputs(batch)
        h, _, new_caches = self(x, caches=caches, pos=pos)
        return self.hidden_to_logits(h), new_caches

    # ------------------------------------------------------------ prefill
    @torch.no_grad()
    def prefill(self, batch: dict):
        """Full-sequence forward returning (logits, aux); no cache is built
        (cached generation re-feeds tokens through ``decode_step``)."""
        x = self.embed_inputs(batch)
        h, aux, _ = self(x)
        return self.hidden_to_logits(h), aux


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def active_param_count(cfg: ModelConfig, model: nn.Module) -> int:
    """Parameters touched per token (MoE counts top_k + shared experts):
    the reference's count, which takes the routed experts' share from the
    config's shapes."""
    total = param_count(model)
    if cfg.moe is None:
        return total
    m = cfg.moe
    inactive_frac = 1.0 - (m.top_k / m.n_experts)
    moe_layers = sum(cfg.is_moe_layer(j) for j in range(len(cfg.pattern))) * cfg.n_periods
    gated = cfg.activation.endswith("_gated")
    per_layer_expert = m.n_experts * m.d_ff_expert * cfg.d_model * (3 if gated else 2)
    return int(total - inactive_frac * per_layer_expert * moe_layers)


def _flatten(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _leaf_dtype(cfg: ModelConfig, kind: str, name: str) -> torch.dtype:
    """The dtype of leaf ``name`` of a layer of ``kind``: float32 for the
    SSM mixers' ``ssm.FLOAT32_LEAVES`` (as the reference's inits draw
    them), else ``cfg.dtype``."""
    if name.startswith("mixer.") and name[len("mixer."):] in ssm.FLOAT32_LEAVES.get(kind, ()):
        return torch.float32
    return getattr(torch, cfg.dtype)


def params_from_numpy(cfg: ModelConfig, tree: dict, device="cpu") -> dict[str, torch.Tensor]:
    """The reference's parameter pytree (numpy arrays; ``blocks`` is one
    dict per pattern entry with a leading ``n_periods`` axis) as this
    port's ``state_dict`` on ``device``, each leaf in its ``_leaf_dtype``:
    the float32 leaves of a bf16 model keep their values unrounded.
    bfloat16 leaves may be ``ml_dtypes`` arrays (the reference's) or the
    2-byte ``V2`` records of ``params_to_numpy``."""
    dtype = getattr(torch, cfg.dtype)

    def tensor(a, dt):
        a = np.asarray(a)
        if a.dtype.kind == "V" and a.dtype.itemsize == 2:
            t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=device, dtype=dt)

    state = {k: tensor(v, dtype) for k, v in tree.items() if k != "blocks"}
    n_pat = len(cfg.pattern)
    for j, entry in enumerate(tree["blocks"]):
        for name, arr in _flatten(entry):
            dt = _leaf_dtype(cfg, cfg.pattern[j], name)
            for p in range(cfg.n_periods):
                state[f"blocks.{p * n_pat + j}.{name}"] = tensor(arr[p], dt)
    return state


def params_to_numpy(cfg: ModelConfig, model: nn.Module) -> dict:
    """The inverse of ``params_from_numpy``: the reference's parameter
    pytree of ``model`` as numpy arrays (``blocks`` one nested dict per
    pattern entry, stacked over periods), so ``checkpoint.save`` writes
    the file the reference's ``checkpoint.load(like=params)`` restores.
    bfloat16 leaves become the 2-byte ``V2`` records the reference writes."""
    return params_tree(cfg, model.state_dict(), to_numpy, np.stack)


def grads_to_numpy(cfg: ModelConfig, model: nn.Module) -> dict:
    """The parameters' ``.grad`` in the reference's pytree, as
    ``params_to_numpy`` lays out the parameters: a leaf the loss did not
    touch (``.grad`` None) is zeros, as ``jax.grad`` gives it."""
    return params_tree(cfg, {name: torch.zeros_like(p) if p.grad is None else p.grad
                             for name, p in model.named_parameters()}, to_numpy, np.stack)


def params_tree(cfg: ModelConfig, state: dict[str, torch.Tensor], leaf, stack) -> dict:
    """``state`` (named as this port's ``state_dict``) in the reference's
    pytree layout, ``leaf(tensor)`` at each leaf and ``stack(leaves)``
    joining a pattern entry's leaves over periods: ``params_to_numpy`` is
    ``leaf=to_numpy, stack=np.stack``; the dry-run passes shape records."""
    tree: dict = {k: leaf(v) for k, v in state.items() if not k.startswith("blocks.")}
    n_pat = len(cfg.pattern)
    blocks_tree = []
    for j in range(n_pat):
        prefix = f"blocks.{j}."
        entry: dict = {}
        for key in state:
            if not key.startswith(prefix):
                continue
            name = key[len(prefix):]
            stacked = stack([leaf(state[f"blocks.{p * n_pat + j}.{name}"])
                             for p in range(cfg.n_periods)])
            *path, last = name.split(".")
            node = entry
            for part in path:
                node = node.setdefault(part, {})
            node[last] = stacked
        blocks_tree.append(entry)
    tree["blocks"] = blocks_tree
    return tree
