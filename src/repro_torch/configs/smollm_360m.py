"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-135M family] — small llama-arch."""
from repro_torch.configs.base import ModelConfig, register

SMOLLM_360M = register(ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    kv_heads=5,            # GQA kv=5
    head_dim=64,
    d_ff=2560,
    vocab=49_152,
    activation="silu_gated",
    optimizer="adamw",
    microbatch=32,
    source="hf:HuggingFaceTB/SmolLM-360M",
))
