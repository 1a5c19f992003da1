"""Granite-34B-Code [arXiv:2405.04324] — llama-arch, MQA (kv=1), 88 layers."""
from repro_torch.configs.base import ModelConfig, register

GRANITE_34B = register(ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    kv_heads=1,            # MQA
    d_ff=24576,
    vocab=49_152,
    activation="silu_gated",
    optimizer="momentum",
    microbatch=16,
    source="arXiv:2405.04324 (Granite Code Models)",
))
