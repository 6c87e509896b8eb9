"""Normalized model hyperparameters (counterpart of
``xalm_tpu/models/config.py``): the same fields, defaults and the
max_seq_len clamp to 4096 with a ``context`` override, plus the geometries
of the chip smoke: ``MISTRAL_7B``, ``MIXTRAL_8X7B``, ``QWEN2_5_7B``,
``QWEN3_8B``, ``LLAMA3_1_8B``, ``GEMMA2_9B``, ``GEMMA_7B`` and
``PHI3_MINI_4K``, each from its Hugging Face ``config.json`` with the
window clamped to 4096, and the family fields as the JAX converter writes
them (``xalm_tpu/convert/convert.py``)."""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "ModelConfig", "KV_SINKS", "MISTRAL_7B", "MIXTRAL_8X7B", "QWEN2_5_7B", "QWEN3_8B",
    "LLAMA3_1_8B", "GEMMA2_9B", "GEMMA_7B", "PHI3_MINI_4K",
]

# StreamingLLM attention-sink count
KV_SINKS = 2

_MAX_SEQ_LEN_CLAMP = 4096


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    dim: int
    hidden_dim: int
    head_dim: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    vocab_size: int
    max_seq_len: int
    rope_theta: float
    rotary_dim: int
    norm_eps: float = 1e-5
    act: str = "gelu"  # gelu | silu
    norm_type: str = "rmsnorm"
    qkv_clip: float = math.inf  # inf = no clipping
    tie_word_embeddings: bool = False
    embed_scale: float = 1.0
    n_experts: int = 0
    n_experts_active: int = 0
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    post_norms: bool = False
    qk_norm: bool = False
    rope_scaling: str = "none"
    rope_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_pos: int = 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def group_size(self) -> int:
        return self.n_heads // self.n_kv_heads

    def __post_init__(self):
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.rotary_dim % 2 != 0 or self.rotary_dim > self.head_dim:
            raise ValueError("rotary_dim must be even and <= head_dim")
        if self.act not in ("gelu", "silu"):
            raise ValueError(f"unsupported act {self.act}")
        if self.norm_type != "rmsnorm":
            raise ValueError(f"unsupported norm_type {self.norm_type}")
        if self.rope_scaling not in ("none", "linear", "llama3"):
            raise ValueError(f"unsupported rope_scaling {self.rope_scaling}")
        if self.rope_scaling == "llama3" and self.rope_original_max_pos <= 0:
            raise ValueError("llama3 rope_scaling needs rope_original_max_pos")
        if self.n_experts and not 0 < self.n_experts_active <= self.n_experts:
            raise ValueError("n_experts_active must be in (0, n_experts]")

    @classmethod
    def from_metadata(cls, metadata: dict, context: int = 0) -> "ModelConfig":
        """Parse the stringly-typed .xalm config."""
        max_seq_len = min(int(metadata["max_seq_len"]), _MAX_SEQ_LEN_CLAMP)
        if context:
            max_seq_len = context
        return cls(
            dim=int(metadata["dim"]),
            hidden_dim=int(metadata["hidden_dim"]),
            head_dim=int(metadata["head_dim"]),
            n_layers=int(metadata["n_layers"]),
            n_heads=int(metadata["n_heads"]),
            n_kv_heads=int(metadata["n_kv_heads"]),
            vocab_size=int(metadata["vocab_size"]),
            max_seq_len=max_seq_len,
            rope_theta=float(metadata["rope_theta"]),
            rotary_dim=int(metadata["rotary_dim"]),
            norm_eps=float(metadata.get("norm_eps", "1e-5")),
            act=metadata.get("act_type", "gelu"),
            norm_type=metadata.get("norm_type", "rmsnorm"),
            qkv_clip=float(metadata["qkv_clip"]) if "qkv_clip" in metadata else math.inf,
            tie_word_embeddings=metadata.get("tie_word_embeddings") == "True",
            embed_scale=float(metadata.get("embed_scale", "1.0")),
            n_experts=int(metadata.get("n_experts", "0")),
            n_experts_active=int(metadata.get("n_experts_active", "0")),
            attn_softcap=float(metadata.get("attn_softcap", "0.0")),
            logit_softcap=float(metadata.get("logit_softcap", "0.0")),
            post_norms=metadata.get("post_norms") == "True",
            qk_norm=metadata.get("qk_norm") == "True",
            rope_scaling=metadata.get("rope_scaling", "none"),
            rope_factor=float(metadata.get("rope_factor", "1.0")),
            rope_low_freq_factor=float(metadata.get("rope_low_freq_factor", "1.0")),
            rope_high_freq_factor=float(metadata.get("rope_high_freq_factor", "4.0")),
            rope_original_max_pos=int(metadata.get("rope_original_max_pos", "0")),
        )


# Mistral-7B-Instruct-v0.2 geometry (HF config), window clamped to 4096
MISTRAL_7B = ModelConfig(
    dim=4096,
    hidden_dim=14336,
    head_dim=128,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    vocab_size=32000,
    max_seq_len=4096,
    rope_theta=1e6,
    rotary_dim=128,
    norm_eps=1e-5,
    act="silu",
    tie_word_embeddings=False,
)

# Mixtral-8x7B-v0.1 geometry (HF config: 8 local experts, 2 per token),
# window clamped to 4096
MIXTRAL_8X7B = dataclasses.replace(MISTRAL_7B, n_experts=8, n_experts_active=2)

# Qwen2.5-7B-Instruct (Qwen/Qwen2.5-7B-Instruct config.json): q/k/v
# projection bias (the container's l.{i}.attn.{q,k,v}.bias), GQA group 7
QWEN2_5_7B = ModelConfig(
    dim=3584,
    hidden_dim=18944,
    head_dim=128,
    n_layers=28,
    n_heads=28,
    n_kv_heads=4,
    vocab_size=152064,
    max_seq_len=4096,
    rope_theta=1e6,
    rotary_dim=128,
    norm_eps=1e-6,
    act="silu",
    tie_word_embeddings=False,
)

# Qwen3-8B (Qwen/Qwen3-8B config.json): per-head q/k RMS norms before rope
QWEN3_8B = ModelConfig(
    dim=4096,
    hidden_dim=12288,
    head_dim=128,
    n_layers=36,
    n_heads=32,
    n_kv_heads=8,
    vocab_size=151936,
    max_seq_len=4096,
    rope_theta=1e6,
    rotary_dim=128,
    norm_eps=1e-6,
    act="silu",
    tie_word_embeddings=False,
    qk_norm=True,
)

# Llama-3.1-8B-Instruct (meta-llama/Llama-3.1-8B-Instruct config.json):
# rope_scaling "llama3", factor 8, low 1, high 4, original context 8192
LLAMA3_1_8B = ModelConfig(
    dim=4096,
    hidden_dim=14336,
    head_dim=128,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    vocab_size=128256,
    max_seq_len=4096,
    rope_theta=5e5,
    rotary_dim=128,
    norm_eps=1e-5,
    act="silu",
    tie_word_embeddings=False,
    rope_scaling="llama3",
    rope_factor=8.0,
    rope_low_freq_factor=1.0,
    rope_high_freq_factor=4.0,
    rope_original_max_pos=8192,
)

# Gemma-2-9B (google/gemma-2-9b-it config.json): head_dim 256, gelu (tanh),
# the sqrt(hidden_size) embed scale, attention and final-logit softcaps 50
# and 30, post-attention and post-feedforward norms, tied embeddings. The
# converter stores max_seq_len as min(max_position_embeddings 8192,
# sliding_window 4096), where the alternating local/global attention is one
# behaviour, and folds query_pre_attn_scalar 256 (== head_dim) into wq.
GEMMA2_9B = ModelConfig(
    dim=3584,
    hidden_dim=14336,
    head_dim=256,
    n_layers=42,
    n_heads=16,
    n_kv_heads=8,
    vocab_size=256000,
    max_seq_len=4096,
    rope_theta=1e4,
    rotary_dim=256,
    norm_eps=1e-6,
    act="gelu",
    tie_word_embeddings=True,
    embed_scale=3584.0 ** 0.5,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norms=True,
)

# Gemma-7B (google/gemma-7b config.json): head_dim 256 with q_dim 4096 !=
# dim 3072, GQA group 1, gelu (tanh), the sqrt(hidden_size) embed scale,
# tied embeddings; the window clamped to 4096 (of 8192)
GEMMA_7B = ModelConfig(
    dim=3072,
    hidden_dim=24576,
    head_dim=256,
    n_layers=28,
    n_heads=16,
    n_kv_heads=16,
    vocab_size=256000,
    max_seq_len=4096,
    rope_theta=1e4,
    rotary_dim=256,
    norm_eps=1e-6,
    act="gelu",
    tie_word_embeddings=True,
    embed_scale=3072.0 ** 0.5,
)

# Phi-3-mini-4k-instruct (microsoft/Phi-3-mini-4k-instruct config.json):
# head_dim 96, GQA group 1, vocab 32064, untied head. Its sliding_window of
# 2047 is not modelled: the port follows the JAX package, which attends
# over the whole 4096-slot window.
PHI3_MINI_4K = ModelConfig(
    dim=3072,
    hidden_dim=8192,
    head_dim=96,
    n_layers=32,
    n_heads=32,
    n_kv_heads=32,
    vocab_size=32064,
    max_seq_len=4096,
    rope_theta=1e4,
    rotary_dim=96,
    norm_eps=1e-5,
    act="silu",
    tie_word_embeddings=False,
)
