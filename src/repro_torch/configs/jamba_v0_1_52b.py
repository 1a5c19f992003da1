"""Jamba-v0.1 52B [arXiv:2403.19887] — hybrid Mamba+attention (1:7 ratio,
attention at period offset 4), MoE 16e top-2 on every second layer."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register

JAMBA_V01_52B = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    d_ff=14336,
    vocab=65_536,
    # 8-block period: attn at index 4, Mamba elsewhere (1:7 interleave)
    pattern=("mamba", "mamba", "mamba", "mamba",
             "attn", "mamba", "mamba", "mamba"),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, chunk=256),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, every=2),
    activation="silu_gated",
    optimizer="momentum",
    microbatch=8,
    source="arXiv:2403.19887 (Jamba)",
))
