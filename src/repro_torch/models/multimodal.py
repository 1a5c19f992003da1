"""Token batches for the text models, seeded with numpy exactly as the
reference's ``models/multimodal.py`` seeds them, so both packages see the
same tokens.  The vision and audio frontends wait (ROADMAP Queue 1 item
14g)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def _text_only(cfg: ModelConfig) -> None:
    if cfg.n_codebooks or cfg.n_prefix_embeds:
        raise NotImplementedError(
            f"{cfg.name}: multimodal batches are not ported yet (ROADMAP Queue 1 item 14g)")


def text_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0) -> dict:
    """{"tokens": (batch, seq_len) int64} on the CPU."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, seq_len), dtype=np.int32)
    return {"tokens": torch.from_numpy(toks).long()}


def decode_batch_for(cfg: ModelConfig, batch: int, seed: int = 0) -> dict:
    """The single new token fed to ``serve_step``: {"tokens": (batch, 1)}."""
    _text_only(cfg)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, 1), dtype=np.int32)
    return {"tokens": torch.from_numpy(toks).long()}
