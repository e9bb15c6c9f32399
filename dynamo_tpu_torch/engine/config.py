"""Model architecture configuration + presets.

The engine-side architecture record: the same fields and presets as the
JAX package's, so one preset name means one set of widths in both.
``kv_cache_dtype="int8"`` and ``weight_dtype="int8"`` are served (int8
codes with f32 scales, engine/kv_cache.py and engine/quant.py). Three
families are served: dense llama, llama with expert layers
(``num_experts > 0``, models/llama.py's MoE feed-forward) and DeepSeek-style
multi-head latent attention (``architecture="mla"``, models/mla.py), whose
feed-forward may have experts too. int8 weights are llama-dense only, as in
the JAX package.
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
    # MoE dispatch (models/llama._mlp):
    # - "dense":    every expert computes every token (exact, tiny models).
    # - "ragged":   each expert's feed-forward over only the rows routed to
    #               it, the rows sorted by expert (exact, no token drops).
    # - "capacity": GShard-style one-hot dispatch/combine into C slots per
    #               expert; assignments past an expert's capacity drop to the
    #               residual and are counted (moe_dropped_total).
    # - "auto":     "ragged"; resolve_moe_dispatch makes it "capacity" when
    #               experts are split over ep > 1 ranks.
    moe_dispatch: str = "auto"
    # Per-expert slot budget for "capacity" dispatch, as a multiple of the
    # balanced load T*K/E.
    moe_capacity_factor: float = 2.0
    # Architecture family: "llama" (GQA) or "mla" (DeepSeek-style multi-head
    # latent attention over a paged latent cache, models/mla.py).
    architecture: str = "llama"
    # MLA dims (ignored for llama): per-head nope/rope query dims, value dim,
    # and the shared latent rank. Cache row = kv_lora_rank + qk_rope_head_dim.
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # Attention implementation (models/llama.resolve_attention_impl):
    # - "megakernel": the ragged paged-attention kernel
    #   (attention/megakernel.py): one launch per layer serves every row
    #   of a step — prefill chunks, mixed steps and decode rows.
    # - "paged": the per-piece path. Decode rows attend their cached
    #   prefix through the paged flash-decode kernel
    #   (attention/decode.py), which returns online-softmax partials, and
    #   merge them with the current token's in-register piece; prefill
    #   chunks go through attention/ragged.py.
    # - "gather": as "paged", with the prefix gathered through the block
    #   table and attended in PyTorch instead of the kernel.
    # - "auto": "megakernel", on the card and on the CPU alike (the JAX
    #   package resolves "auto" to "gather" off the TPU).
    attention_impl: str = "auto"
    # Prefill chunk attention on the non-megakernel paths (phase-separated
    # prefills and the chunk row of mixed steps): "flash" runs the chunk's
    # causal self-attention in the flash kernel (attention/prefill.py) and
    # merges a cached-prefix partial outside it; "xla" takes one masked
    # softmax over [prefix ; chunk] in PyTorch; "auto" is "flash" on a
    # CUDA device and "xla" on the CPU (the scheduler resolves it). The
    # megakernel path ignores it.
    prefill_impl: str = "auto"
    # KV cache storage dtype: "auto" follows the compute dtype; "int8"
    # stores int8 codes with one f32 scale per (token, KV head)
    # (kv_cache.QuantKv), twice the blocks per byte of bf16.
    kv_cache_dtype: str = "auto"
    # Weight storage dtype: "auto" follows the compute dtype; "int8" stores
    # the layer matmul weights as int8 codes with per-output-channel f32
    # scales (engine/quant.py), dequantized one layer at a time.
    weight_dtype: str = "auto"

    def __post_init__(self):
        if self.attention_impl not in ("auto", "gather", "paged", "megakernel"):
            raise ValueError(
                "attention_impl must be auto|gather|paged|megakernel, "
                f"got {self.attention_impl!r}"
            )
        if self.prefill_impl not in ("auto", "flash", "xla"):
            raise ValueError(f"prefill_impl must be auto|flash|xla, got {self.prefill_impl!r}")
        if self.moe_dispatch not in ("auto", "dense", "ragged", "capacity"):
            raise ValueError(
                f"moe_dispatch must be auto|dense|ragged|capacity, got {self.moe_dispatch!r}"
            )
        if self.kv_cache_dtype not in ("auto", "int8"):
            raise ValueError(f"kv_cache_dtype must be auto|int8, got {self.kv_cache_dtype!r}")
        if self.weight_dtype not in ("auto", "int8"):
            raise ValueError(f"weight_dtype must be auto|int8, got {self.weight_dtype!r}")
        if self.weight_dtype == "int8" and self.architecture != "llama":
            raise ValueError(
                "weight_dtype='int8' is llama-family only (MLA layer loops "
                "do not dequantize yet)"
            )
        if self.weight_dtype == "int8" and self.num_experts > 0:
            raise ValueError(
                "weight_dtype='int8' does not cover MoE expert stacks "
                "(ragged/capacity dispatch would re-dequantize per expert)"
            )

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    def replace(self, **kwargs) -> "ModelConfig":
        return dataclasses.replace(self, **kwargs)


# The JAX package's presets, every field equal, at the published widths.
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
    # Tiny MoE config for EP tests.
    "tiny-moe": ModelConfig(
        name="tiny-moe",
        vocab_size=256,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        intermediate_size=64,
        max_seq_len=256,
        block_size=16,
        rope_theta=10000.0,
        num_experts=4,
        num_experts_per_tok=2,
    ),
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b",
        vocab_size=32000,
        hidden_size=4096,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        intermediate_size=14336,
        rope_theta=1000000.0,
        max_seq_len=32768,
        num_experts=8,
        num_experts_per_tok=2,
    ),
    # Wide-EP MoE decode target (ref recipe: recipes/gpt-oss-120b) —
    # architecture approximated from public specs.
    "gpt-oss-120b": ModelConfig(
        name="gpt-oss-120b",
        vocab_size=201088,
        hidden_size=2880,
        num_layers=36,
        num_heads=64,
        num_kv_heads=8,
        head_dim=64,
        intermediate_size=2880,
        max_seq_len=131072,
        num_experts=128,
        num_experts_per_tok=4,
    ),
    # Tiny MLA config (DeepSeek-style latent attention) for unit tests.
    "tiny-mla": ModelConfig(
        name="tiny-mla",
        vocab_size=256,
        hidden_size=64,
        num_layers=2,
        num_heads=4,
        num_kv_heads=1,
        head_dim=16,
        intermediate_size=128,
        max_seq_len=256,
        block_size=16,
        rope_theta=10000.0,
        architecture="mla",
        kv_lora_rank=32,
        qk_nope_head_dim=16,
        qk_rope_head_dim=8,
        v_head_dim=16,
    ),
    # DeepSeek-V2-Lite (public specs): MLA + 64-expert MoE.
    "deepseek-v2-lite": ModelConfig(
        name="deepseek-v2-lite",
        vocab_size=102400,
        hidden_size=2048,
        num_layers=27,
        num_heads=16,
        num_kv_heads=1,
        head_dim=128,
        intermediate_size=1408,
        max_seq_len=32768,
        rope_theta=10000.0,
        architecture="mla",
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        num_experts=64,
        num_experts_per_tok=6,
    ),
    # DeepSeek-V3 / R1 (public specs): the wide-EP MLA decode target
    # (ref recipe: components/backends/sglang slurm_jobs DeepSeek-R1).
    "deepseek-v3": ModelConfig(
        name="deepseek-v3",
        vocab_size=129280,
        hidden_size=7168,
        num_layers=61,
        num_heads=128,
        num_kv_heads=1,
        head_dim=128,
        intermediate_size=2048,
        max_seq_len=131072,
        rope_theta=10000.0,
        architecture="mla",
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        num_experts=256,
        num_experts_per_tok=8,
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


def resolve_moe_dispatch(config: ModelConfig, ep: int) -> ModelConfig:
    """Resolve "auto" MoE dispatch against the actual expert-parallel degree.

    The scheduler resolves it at ``ep == 1`` (the port runs no expert
    parallelism yet): "ragged", the exact grouped dispatch. Wide-EP meshes
    would need "capacity". Direct model calls keep the "auto" → "ragged"
    default in ``models/llama._mlp``."""
    if config.num_experts and config.moe_dispatch == "auto":
        return config.replace(moe_dispatch="capacity" if ep > 1 else "ragged")
    return config
