"""Modality frontends — stubs, as in the reference.

The [vlm] and [audio] architectures run the transformer backbone; the
ViT/SigLIP vision tower and the EnCodec audio codec are not rebuilt.  These
helpers make the precomputed embeddings / token grids the backbones
consume, seeded with numpy exactly as the reference's
``models/multimodal.py`` seeds them, so both packages see the same arrays.
All on the CPU: integer arrays as int64, embeddings as float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def vlm_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0) -> dict:
    """Phi-3-vision style: ``image_embeds`` (B, P, prefix_dim) precomputed
    patch features + ``tokens`` (B, seq_len - P) filling the rest of the
    sequence."""
    p = cfg.n_prefix_embeds
    if seq_len <= p:
        raise ValueError(f"seq_len {seq_len} leaves no text after {p} patch embeddings")
    rng = np.random.default_rng(seed)
    embeds = rng.standard_normal((batch, p, cfg.prefix_embed_dim), np.float32) * 0.5
    toks = rng.integers(0, cfg.vocab, (batch, seq_len - p), dtype=np.int32)
    return {"image_embeds": torch.from_numpy(embeds), "tokens": torch.from_numpy(toks).long()}


def audio_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0) -> dict:
    """MusicGen style: the EnCodec RVQ token grid ``codes`` (B, S, K), one
    token per codebook per frame (the parallel codebook pattern)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, cfg.vocab, (batch, seq_len, cfg.n_codebooks), dtype=np.int32)
    return {"codes": torch.from_numpy(codes).long()}


def text_batch(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0) -> dict:
    """{"tokens": (batch, seq_len) int64} on the CPU."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (batch, seq_len), dtype=np.int32)
    return {"tokens": torch.from_numpy(toks).long()}


def batch_for(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0) -> dict:
    if cfg.n_codebooks:
        return audio_batch(cfg, batch, seq_len, seed)
    if cfg.n_prefix_embeds:
        return vlm_batch(cfg, batch, seq_len, seed)
    return text_batch(cfg, batch, seq_len, seed)


def decode_batch_for(cfg: ModelConfig, batch: int, seed: int = 0) -> dict:
    """The single new token fed to ``serve_step``: ``codes`` (B, 1, K) for
    audio, else ``tokens`` (B, 1) (a VLM decodes text only)."""
    rng = np.random.default_rng(seed)
    if cfg.n_codebooks:
        codes = rng.integers(0, cfg.vocab, (batch, 1, cfg.n_codebooks), np.int32)
        return {"codes": torch.from_numpy(codes).long()}
    toks = rng.integers(0, cfg.vocab, (batch, 1), dtype=np.int32)
    return {"tokens": torch.from_numpy(toks).long()}
