"""Nemotron-4-340B [arXiv:2402.16819] — dense GQA with squared-ReLU MLP."""
from repro_torch.configs.base import ModelConfig, register

NEMOTRON_4_340B = register(ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    kv_heads=8,            # GQA kv=8
    head_dim=192,
    d_ff=73728,
    vocab=256_000,
    activation="relu2",    # squared ReLU, non-gated (4x d_model FFN)
    rope_theta=10_000.0,
    optimizer="momentum",  # adam states would not fit 16 GB/chip at 340B/256
    microbatch=16,
    source="arXiv:2402.16819 (Nemotron-4 340B)",
))
