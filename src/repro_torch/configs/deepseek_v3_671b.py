"""DeepSeek-V3 671B [arXiv:2412.19437] — MLA attention, 1 shared + 256
routed experts (top-8), multi-token prediction head.

The assigned pool spec gives d_ff=2048 (the routed-expert width) and MoE on
all layers; DeepSeek-V3's first-3-dense-layer detail is not part of the
assigned config and is omitted (noted in DESIGN.md)."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, register

DEEPSEEK_V3_671B = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    kv_heads=128,          # MLA: latent cache is shared; heads decompress
    d_ff=0,
    vocab=129_280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, every=1),
    mtp_depth=1,
    activation="silu_gated",
    optimizer="momentum",
    microbatch=8,
    source="arXiv:2412.19437 (DeepSeek-V3)",
))
