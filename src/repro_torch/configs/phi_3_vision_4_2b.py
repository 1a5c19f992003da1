"""Phi-3-vision-128k-instruct [hf:microsoft/Phi-3-vision-128k-instruct] —
phi3-mini language backbone + CLIP ViT-L/14 frontend (stubbed: precomputed
patch embeddings, 576 patches @ 1024-dim, projected to d_model)."""
from repro_torch.configs.base import ModelConfig, register

PHI_3_VISION = register(ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    kv_heads=32,           # spec: GQA kv=32 (full MHA)
    d_ff=8192,
    vocab=32_064,
    activation="silu_gated",
    n_prefix_embeds=576,   # CLIP ViT-L/14 @ 336px -> 24x24 patches
    prefix_embed_dim=1024,
    optimizer="adamw",
    microbatch=8,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
))
