"""MusicGen-large [arXiv:2306.05284] — decoder-only over EnCodec RVQ tokens.

4 codebooks @ 2048 entries; embeddings summed per frame, one output head per
codebook (we model the parallel/flattened codebook pattern; the EnCodec
codec itself is a stubbed frontend per the brief)."""
from repro_torch.configs.base import ModelConfig, register

MUSICGEN_LARGE = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    kv_heads=32,           # full MHA
    d_ff=8192,
    vocab=2048,            # per-codebook
    n_codebooks=4,
    activation="gelu",
    optimizer="adamw",
    microbatch=16,
    source="arXiv:2306.05284 (MusicGen)",
))
