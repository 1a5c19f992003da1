"""Qwen3-4B [hf:Qwen/Qwen3-8B family] — GQA kv=8 with per-head QK RMSNorm."""
from repro_torch.configs.base import ModelConfig, register

QWEN3_4B = register(ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    kv_heads=8,
    head_dim=128,          # Qwen3 decouples head_dim from d_model/n_heads
    d_ff=9728,
    vocab=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    activation="silu_gated",
    optimizer="adamw",
    microbatch=16,
    source="hf:Qwen/Qwen3-4B",
))
