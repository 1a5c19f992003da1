"""Granite-3.0-3B-A800M MoE [hf:ibm-granite/granite-3.0-1b-a400m-base family].

Assigned spec: 32L d_model=1536 24H (kv=8) expert d_ff=512 vocab=49155,
"MoE 40e top-8".  NOTE: the pool entry's gloss says "32 experts top-8" but
the explicit config field says 40e — we follow the explicit field (40).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

GRANITE_MOE_3B = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    kv_heads=8,
    d_ff=0,                          # every FFN is MoE
    vocab=49_155,
    activation="silu_gated",
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512, every=1),
    optimizer="adamw",
    microbatch=16,
    source="hf:ibm-granite/granite-3.0-3b-a800m-base",
))
