"""xLSTM-125M [arXiv:2405.04517] — alternating mLSTM (matrix-memory,
chunk-parallel) and sLSTM (scalar-memory, sequential) blocks; no FFN
(d_ff=0): the cells carry their own projections."""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

XLSTM_125M = register(ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    kv_heads=4,
    d_ff=0,
    vocab=50_304,
    pattern=("mlstm", "slstm"),
    ssm=SSMConfig(n_heads=4, chunk=256),
    activation="gelu",
    optimizer="adamw",
    microbatch=32,
    source="arXiv:2405.04517 (xLSTM)",
))
