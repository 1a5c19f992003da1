"""Model / run configuration system for the architecture zoo.

A copy of ``repro/configs/base.py``: the dataclasses, ``reduced()`` (its
numbers are what the parity tests compare), the registry and
``INPUT_SHAPES``.  Each architecture the port runs gets a ``ModelConfig``
in its own module under ``repro_torch.configs``; the registry maps
``--arch <id>`` to it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0       # DeepSeek-style always-on shared expert(s)
    every: int = 1                  # MoE FFN every Nth layer (Jamba: 2)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    dropless: bool = False          # capacity = T*K (exact; tests/decode-math)
    pad_to: int = 0                 # pad expert bank to this count (0 = off):
                                    # dead experts are never routed to; lets
                                    # E shard over the mesh when n_experts
                                    # doesn't divide the model axis (§Perf)
    dispatch: str = "flat"          # "flat": one (T*K, D) scatter stream;
                                    # "per_k": K scatters of (T, D) — avoids
                                    # materializing the K-fold token payload
                                    # (its f32 backward gather dominated the
                                    # deepseek collective term, §Perf)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba / xLSTM cell dims."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                 # d_inner = expand * d_model
    chunk: int = 256                # chunked-scan block length
    n_heads: int = 4                # xLSTM heads


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # layer pattern: list of block kinds, tiled over n_layers.
    # kinds: "attn" | "mamba" | "mlstm" | "slstm"
    pattern: tuple[str, ...] = ("attn",)
    # attention details
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0         # 0 = full attention
    mla: Optional[MLAConfig] = None
    # "naive" materializes (B,H,S,S) scores; "chunked" is the flash-style
    # online-softmax over KV blocks (beyond-paper §Perf optimization)
    attention_impl: str = "naive"
    attention_chunk: int = 1024
    # ffn
    activation: str = "silu_gated"  # silu_gated | gelu | relu2 (squared ReLU)
    moe: Optional[MoEConfig] = None
    # ssm
    ssm: Optional[SSMConfig] = None
    # multimodal stub frontends
    n_prefix_embeds: int = 0        # VLM: patch embeddings prepended
    prefix_embed_dim: int = 0       # raw frontend dim (projector maps to d_model)
    n_codebooks: int = 0            # audio: EnCodec codebook count
    # multi-token prediction (DeepSeek-V3)
    mtp_depth: int = 0
    # norms / misc
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # training
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    microbatch: int = 8             # grad-accum microbatch (global batch rows)
    remat: bool = True
    dtype: str = "bfloat16"
    # citation for the assigned-architecture pool
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"pattern period {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    def is_moe_layer(self, idx_in_period: int, period_idx: int = 0) -> bool:
        if self.moe is None:
            return False
        global_idx = period_idx * len(self.pattern) + idx_in_period
        return (global_idx % self.moe.every) == (self.moe.every - 1)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 periods, d_model<=512, <=4 experts."""
        pat = self.pattern
        n_layers = len(pat) * min(2, self.n_periods)
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        kv = max(1, min(self.kv_heads, n_heads, 2))
        hd = max(16, d_model // n_heads)
        moe = None
        if self.moe:
            moe = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(2, self.moe.top_k),
                d_ff_expert=min(self.moe.d_ff_expert, 128))
        mla = None
        if self.mla:
            mla = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                            qk_nope_head_dim=hd, qk_rope_head_dim=hd // 2,
                            v_head_dim=hd)
        ssm = None
        if self.ssm:
            ssm = dataclasses.replace(self.ssm, d_state=8, chunk=32,
                                      n_heads=min(2, self.ssm.n_heads))
        return self.with_(
            n_layers=n_layers, d_model=d_model, n_heads=n_heads, kv_heads=kv,
            head_dim=hd, d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512), moe=moe, mla=mla, ssm=ssm,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            n_prefix_embeds=min(self.n_prefix_embeds, 8) or self.n_prefix_embeds,
            prefix_embed_dim=min(self.prefix_embed_dim, 64) if self.prefix_embed_dim else 0,
            microbatch=2, dtype="float32")


# --------------------------------------------------------------- registry
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import all config modules lazily
        from repro_torch import configs as _c  # noqa
        _c.load_all()
    return _REGISTRY[name]


def all_names() -> list[str]:
    from repro_torch import configs as _c
    _c.load_all()
    return sorted(_REGISTRY)


# ----------------------------------------------------------- input shapes
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
