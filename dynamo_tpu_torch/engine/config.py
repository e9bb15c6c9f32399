"""Model architecture configuration + presets.

The engine-side architecture record: the same fields and presets as the
JAX package's, so one preset name means one set of widths in both.
Options this port does not implement yet raise ``NotImplementedError``
naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 8192
    # Paged KV cache block size in tokens.
    block_size: int = 16
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    # MoE (0 experts = dense).
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_dispatch: str = "auto"
    moe_capacity_factor: float = 2.0
    # Architecture family: "llama" (GQA) or "mla".
    architecture: str = "llama"
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # Attention implementation. "auto" and "megakernel" both select the
    # ragged paged-attention kernel (engine/attention/megakernel.py): one
    # launch per layer serves every row of a step. The JAX package's
    # "gather" and "paged" paths are not ported yet.
    attention_impl: str = "auto"
    prefill_impl: str = "auto"
    # KV cache storage dtype: "auto" follows the compute dtype.
    kv_cache_dtype: str = "auto"
    # Weight storage dtype: "auto" follows the compute dtype.
    weight_dtype: str = "auto"

    def __post_init__(self):
        if self.attention_impl not in ("auto", "gather", "paged", "megakernel"):
            raise ValueError(
                "attention_impl must be auto|gather|paged|megakernel, "
                f"got {self.attention_impl!r}"
            )
        if self.attention_impl in ("gather", "paged"):
            raise NotImplementedError(
                f"attention_impl={self.attention_impl!r} is not ported yet "
                "(ROADMAP Queue 1 item 4: gather path; Queue 2 item 2: paged decode kernel); "
                "use 'auto' or 'megakernel'"
            )
        if self.prefill_impl not in ("auto", "flash", "xla"):
            raise ValueError(f"prefill_impl must be auto|flash|xla, got {self.prefill_impl!r}")
        if self.prefill_impl != "auto":
            raise NotImplementedError(
                f"prefill_impl={self.prefill_impl!r} is not ported yet (ROADMAP Queue 2 item 1: "
                "flash chunk kernel); 'auto' runs prefill through the ragged attention kernel"
            )
        if self.moe_dispatch not in ("auto", "dense", "ragged", "capacity"):
            raise ValueError(
                f"moe_dispatch must be auto|dense|ragged|capacity, got {self.moe_dispatch!r}"
            )
        if self.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(f"kv_cache_dtype must be auto|int8, got {self.kv_cache_dtype!r}")
        if self.weight_dtype not in ("auto", "int8"):
            raise ValueError(f"weight_dtype must be auto|int8, got {self.weight_dtype!r}")
        if self.kv_cache_dtype == "int8":
            raise NotImplementedError(
                "kv_cache_dtype='int8' is not ported yet (ROADMAP Queue 1 item 14, Queue 2 item 6: int8 "
                "variant of the ragged paged-attention kernel)"
            )
        if self.weight_dtype == "int8":
            raise NotImplementedError(
                "weight_dtype='int8' is not ported yet (ROADMAP Queue 1 item 14: int8 weights)"
            )
        if self.num_experts > 0:
            raise NotImplementedError(
                "MoE (num_experts > 0) is not ported yet (ROADMAP Queue 1 item 16: other model families)"
            )
        if self.architecture != "llama":
            raise NotImplementedError(
                f"architecture={self.architecture!r} is not ported yet "
                "(ROADMAP Queue 1 item 16: other model families)"
            )

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    def replace(self, **kwargs) -> "ModelConfig":
        return dataclasses.replace(self, **kwargs)


# Dense llama-family presets, at the published widths (the JAX package's
# MoE and MLA presets wait for their model families to be ported).
PRESETS = {
    # Tiny config for unit tests: fast on a single CPU core.
    "tiny": ModelConfig(
        name="tiny",
        vocab_size=256,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        intermediate_size=128,
        max_seq_len=256,
        block_size=16,
        rope_theta=10000.0,
    ),
    "qwen2.5-7b": ModelConfig(
        name="qwen2.5-7b",
        vocab_size=152064,
        hidden_size=3584,
        num_layers=28,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        intermediate_size=18944,
        rope_theta=1000000.0,
        max_seq_len=32768,
    ),
    "mistral-7b": ModelConfig(
        name="mistral-7b",
        vocab_size=32768,
        hidden_size=4096,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=14336,
        rope_theta=1000000.0,
        max_seq_len=32768,
    ),
    "llama-3.2-1b": ModelConfig(
        name="llama-3.2-1b",
        vocab_size=128256,
        hidden_size=2048,
        num_layers=16,
        num_heads=32,
        num_kv_heads=8,
        head_dim=64,
        intermediate_size=8192,
        max_seq_len=131072,
        tie_word_embeddings=True,
    ),
    "llama-3.2-3b": ModelConfig(
        name="llama-3.2-3b",
        vocab_size=128256,
        hidden_size=3072,
        num_layers=28,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=8192,
        max_seq_len=131072,
        tie_word_embeddings=True,
    ),
    "llama-3-8b": ModelConfig(
        name="llama-3-8b",
        vocab_size=128256,
        hidden_size=4096,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=14336,
        max_seq_len=8192,
    ),
    "llama-3-70b": ModelConfig(
        name="llama-3-70b",
        vocab_size=128256,
        hidden_size=8192,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=28672,
        max_seq_len=8192,
    ),
}


def get_config(name: str) -> ModelConfig:
    if name in PRESETS:
        return PRESETS[name]
    raise KeyError(f"unknown model preset: {name} (have {sorted(PRESETS)})")
