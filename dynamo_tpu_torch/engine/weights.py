"""Model parameters: checkpoints on disk, the JAX package's parameter
pytree, and seeded random initialization.

The port keeps the JAX layout: stacked per-layer weights ``[L, in, out]``
used as ``x @ w`` (not ``F.linear``'s ``[out, in]``), so converting a JAX
pytree is a plain copy and both packages compute the same products. int8
layer weights (engine/quant.py) carry across as their codes and scales.

``load_checkpoint`` reads a Hugging Face safetensors directory (one file
or shards) or a GGUF file with the JAX loader's semantics, through the
port's own readers (``engine/safetensors_reader.py``, ``llm/gguf.py``):
no safetensors, ml_dtypes or gguf wheel. It streams one tensor at a time
into the stacked tensors on the device (the JAX loader holds the whole
checkpoint on the host, then a stacked copy of it) and transposes HF's
``[out, in]`` there.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.quant import QUANT_KEYS, QuantW, quantize_weight
from dynamo_tpu_torch.engine.safetensors_reader import SafetensorsFile

Params = Dict[str, object]


def param_shapes(c: ModelConfig) -> dict:
    """Expected shape of every parameter, the JAX ``init_params`` layout of
    the config's family: llama's attention (``models/llama.py``) or MLA's
    (``wq`` over every head's nope and rope dims, the latent down-projection
    ``w_dkv`` and its norm, the shared rope key ``w_kr``, the per-head
    absorbed ``w_uk`` and ``w_uv``: ``models/mla.py``), then a dense SwiGLU
    or, with ``num_experts > 0``, a ``router`` ``[L, D, E]`` and stacked
    experts ``[L, E, D, F]`` / ``[L, E, F, D]``."""
    L, D, I = c.num_layers, c.hidden_size, c.intermediate_size
    if c.architecture == "mla":
        H = c.num_heads
        layers = {
            "attn_norm": (L, D),
            "mlp_norm": (L, D),
            "kv_norm": (L, c.kv_lora_rank),
            "wq": (L, D, H * (c.qk_nope_head_dim + c.qk_rope_head_dim)),
            "w_dkv": (L, D, c.kv_lora_rank),
            "w_kr": (L, D, c.qk_rope_head_dim),
            "w_uk": (L, H, c.qk_nope_head_dim, c.kv_lora_rank),
            "w_uv": (L, H, c.kv_lora_rank, c.v_head_dim),
            "wo": (L, H * c.v_head_dim, D),
        }
    else:
        layers = {
            "attn_norm": (L, D),
            "mlp_norm": (L, D),
            "wq": (L, D, c.q_size),
            "wk": (L, D, c.kv_size),
            "wv": (L, D, c.kv_size),
            "wo": (L, c.q_size, D),
        }
    if c.num_experts == 0:
        layers.update(w_gate=(L, D, I), w_up=(L, D, I), w_down=(L, I, D))
    else:
        E = c.num_experts
        layers.update(router=(L, D, E), w_gate=(L, E, D, I), w_up=(L, E, D, I), w_down=(L, E, I, D))
    shapes = {"embed": (c.vocab_size, D), "final_norm": (D,), "layers": layers}
    if not c.tie_word_embeddings:
        shapes["lm_head"] = (D, c.vocab_size)
    return shapes


def params_from_numpy(
    tree: dict, config: ModelConfig, device: str = "cuda", dtype: torch.dtype = torch.bfloat16
) -> Params:
    """The JAX parameter pytree as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``) → the port's params,
    checked against the config's shapes. A layer weight the JAX package
    quantized (its ``QuantW``, a pair of int8 codes ``[L, in, out]`` and
    f32 scales ``[L, 1, out]``) becomes the port's ``QuantW``."""
    shapes = param_shapes(config)

    def conv(name, arr, shape):
        if isinstance(arr, tuple) and len(arr) == 2:
            codes, scale = (np.asarray(a) for a in arr)
            want = (*shape[:-2], 1, shape[-1])
            if codes.dtype != np.int8 or tuple(codes.shape) != tuple(shape):
                raise ValueError(f"{name}: expected int8 codes of shape {shape}, got {codes.dtype} {codes.shape}")
            if tuple(scale.shape) != want:
                raise ValueError(f"{name}: expected scales of shape {want}, got {tuple(scale.shape)}")
            return QuantW(torch.from_numpy(codes.copy()).to(device),
                          torch.from_numpy(np.array(scale, dtype=np.float32)).to(device))
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(arr.shape)}")
        return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=dtype)

    extra = set(tree) - set(shapes)
    if extra:
        raise ValueError(f"unexpected parameters: {sorted(extra)}")
    out: Params = {}
    for name, shape in shapes.items():
        if name not in tree:
            raise ValueError(f"missing parameter: {name}")
        if name == "layers":
            layers = tree["layers"]
            extra = set(layers) - set(shape)
            if extra:
                raise ValueError(f"unexpected layer parameters: {sorted(extra)}")
            out["layers"] = {k: conv(f"layers.{k}", layers[k], s) for k, s in shape.items()}
        else:
            out[name] = conv(name, tree[name], shape)
    return out


def init_params(
    config: ModelConfig,
    generator: Optional[torch.Generator] = None,
    device: str = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> Params:
    """Random weights with the JAX ``init_params`` shapes and scales (normal
    draws times ``in**-0.5`` for matmul weights, 0.02 for the embedding and
    head, ones for norms), drawn from ``generator`` on ``device``. The
    values differ from ``jax.random``'s for the same seed."""
    shapes = param_shapes(config)

    def dense(shape, scale=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        if len(shape) == 4:
            # Stacked experts (and MLA's per-head projections): drawn one
            # layer at a time, so the f32 draw never holds a whole stack
            # (DeepSeek-V2-Lite's w_gate is 20 GB in f32).
            out = torch.empty(shape, device=device, dtype=dtype)
            for l in range(shape[0]):
                out[l] = torch.randn(shape[1:], generator=generator, device=device, dtype=torch.float32) * scale
            return out
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (x * scale).to(dtype)

    layer_shapes = shapes["layers"]
    params: Params = {"embed": dense(shapes["embed"], scale=0.02)}
    params["final_norm"] = torch.ones(shapes["final_norm"], device=device, dtype=dtype)
    params["layers"] = {
        k: (torch.ones(s, device=device, dtype=dtype) if k.endswith("_norm") else dense(s))
        for k, s in layer_shapes.items()
    }
    if "lm_head" in shapes:
        params["lm_head"] = dense(shapes["lm_head"], scale=0.02)
    return params


# ---------------------------------------------------------------------------
# Checkpoints on disk
# ---------------------------------------------------------------------------

# Parameter → tensor name in each format; "{}" is the layer index. Layer
# matmul weights are stored ``[out, in]`` in both formats (GGUF's reversed
# ne reads back the same way, llm/gguf.read_tensor).
HF_NAMES = {
    "embed": "model.embed_tokens.weight",
    "final_norm": "model.norm.weight",
    "lm_head": "lm_head.weight",
    "attn_norm": "model.layers.{}.input_layernorm.weight",
    "mlp_norm": "model.layers.{}.post_attention_layernorm.weight",
    "wq": "model.layers.{}.self_attn.q_proj.weight",
    "wk": "model.layers.{}.self_attn.k_proj.weight",
    "wv": "model.layers.{}.self_attn.v_proj.weight",
    "wo": "model.layers.{}.self_attn.o_proj.weight",
    "w_gate": "model.layers.{}.mlp.gate_proj.weight",
    "w_up": "model.layers.{}.mlp.up_proj.weight",
    "w_down": "model.layers.{}.mlp.down_proj.weight",
}
GGUF_NAMES = {
    "embed": "token_embd.weight",
    "final_norm": "output_norm.weight",
    "lm_head": "output.weight",
    "attn_norm": "blk.{}.attn_norm.weight",
    "mlp_norm": "blk.{}.ffn_norm.weight",
    "wq": "blk.{}.attn_q.weight",
    "wk": "blk.{}.attn_k.weight",
    "wv": "blk.{}.attn_v.weight",
    "wo": "blk.{}.attn_output.weight",
    "w_gate": "blk.{}.ffn_gate.weight",
    "w_up": "blk.{}.ffn_up.weight",
    "w_down": "blk.{}.ffn_down.weight",
}


def config_from_hf(path: str) -> ModelConfig:
    """The architecture record of a Hugging Face checkpoint directory
    (``config.json``), with the JAX package's defaults."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    head_dim = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    return ModelConfig(
        name=os.path.basename(path.rstrip("/")),
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        intermediate_size=hf["intermediate_size"],
        rope_theta=hf.get("rope_theta", 500000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_seq_len=hf.get("max_position_embeddings", 8192),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
    )


def config_from_gguf(path: str) -> ModelConfig:
    """The architecture record from a GGUF file's metadata. RoPE scaling
    is refused: the engine does not apply it."""
    from dynamo_tpu_torch.llm.gguf import parse_gguf

    meta = parse_gguf(path)
    hidden = int(meta.arch_field("embedding_length") or 0)
    heads = int(meta.arch_field("attention.head_count") or 0)
    vocab = None
    for t in meta.tensors:
        if t.name == "token_embd.weight":
            vocab = int(t.shape[-1])  # ne = [hidden, vocab]
    if vocab is None:
        toks = meta.tokens
        vocab = len(toks) if toks else 0
    has_head = any(t.name == "output.weight" for t in meta.tensors)
    # attention.key_length, where present, is the head width (it differs
    # from hidden / heads in some exports).
    key_len = meta.arch_field("attention.key_length")
    if key_len:
        head_dim = int(key_len)
    else:
        if heads and hidden % heads != 0:
            raise ValueError(
                f"GGUF {path}: embedding_length {hidden} not divisible by "
                f"head_count {heads} and no attention.key_length present"
            )
        head_dim = hidden // max(heads, 1)
    scaling_type = meta.arch_field("rope.scaling.type")
    scaling_factor = float(meta.arch_field("rope.scaling.factor") or 1.0)
    if scaling_type and str(scaling_type) != "none" and scaling_factor != 1.0:
        raise ValueError(
            f"GGUF {path}: rope.scaling.type={scaling_type!r} factor="
            f"{scaling_factor} is not applied by this engine — refusing to "
            "load with silently-wrong RoPE"
        )
    return ModelConfig(
        name=meta.model_name or os.path.basename(path),
        vocab_size=vocab,
        hidden_size=hidden,
        num_layers=int(meta.num_layers or 0),
        num_heads=heads,
        num_kv_heads=int(meta.arch_field("attention.head_count_kv") or heads),
        head_dim=head_dim,
        intermediate_size=int(meta.arch_field("feed_forward_length") or 0),
        rope_theta=float(meta.arch_field("rope.freq_base") or 500000.0),
        rms_norm_eps=float(meta.arch_field("attention.layer_norm_rms_epsilon") or 1e-5),
        max_seq_len=int(meta.context_length or 8192),
        tie_word_embeddings=not has_head,
    )


def _stream(get: Callable[[str], torch.Tensor], release: Callable[[str], None], has: Callable[[str], bool],
            names: Dict[str, str], config: ModelConfig, dtype: torch.dtype, device, quantize: bool,
            where: str) -> Params:
    """Params from a checkpoint's tensors, one at a time: each host tensor
    is copied to ``device`` in its own dtype, cast (or, under ``quantize``,
    quantized from its own precision as the JAX loader's
    ``quantize_weight_np`` does) and transposed there into its layer of the
    stacked tensor, then its host pages are released."""
    shapes = param_shapes(config)
    L = config.num_layers

    def load_into(put: Callable[[torch.Tensor], None], name: str, shape: tuple, transpose: bool) -> None:
        if not has(name):
            raise ValueError(f"{where}: no tensor {name!r}")
        t = get(name)
        want = shape[::-1] if transpose else shape
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{where}: tensor {name!r} has shape {tuple(t.shape)}, the config needs {tuple(want)}")
        t = t.to(device)
        put(t.T if transpose else t)
        del t
        release(name)

    def single(key: str, transpose: bool = False) -> torch.Tensor:
        out = torch.empty(shapes[key], dtype=dtype, device=device)
        load_into(out.copy_, names[key], shapes[key], transpose)
        return out

    def stack(key: str):
        shape = shapes["layers"][key]
        transpose = key not in ("attn_norm", "mlp_norm")
        if quantize and key in QUANT_KEYS:
            q = torch.empty(shape, dtype=torch.int8, device=device)
            scale = torch.empty((L, 1, shape[-1]), dtype=torch.float32, device=device)
            for l in range(L):
                def put(w, l=l):
                    q[l], scale[l] = quantize_weight(w)
                load_into(put, names[key].format(l), shape[1:], transpose)
            return QuantW(q, scale)
        out = torch.empty(shape, dtype=dtype, device=device)
        for l in range(L):
            load_into(out[l].copy_, names[key].format(l), shape[1:], transpose)
        return out

    params: Params = {"embed": single("embed"), "final_norm": single("final_norm"),
                      "layers": {k: stack(k) for k in shapes["layers"]}}
    # The head only where the embeddings are not tied and the file has one
    # (without it the model multiplies by embed.T, as the JAX package's).
    if not config.tie_word_embeddings and has(names["lm_head"]):
        params["lm_head"] = single("lm_head", transpose=True)
    return params


def _check_family(config: ModelConfig) -> None:
    """The readers know the dense llama family's tensor names only, as the
    JAX package's loader does: an MoE or MLA config is refused before any
    file is read."""
    if config.num_experts > 0 or config.architecture != "llama":
        raise NotImplementedError(
            f"{config.name}: no checkpoint reader for MoE or MLA tensor names exists "
            "(num_experts > 0 or architecture != 'llama'); serve it on seeded random weights"
        )


def load_checkpoint(path: str, config: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                    device="cuda") -> Params:
    """A llama-family checkpoint → the port's params on ``device``: every
    ``*.safetensors`` of the directory ``path`` (sorted; a later file's
    tensor of the same name wins), else its first ``.gguf`` (or ``path``
    itself when it is a ``.gguf`` file), else ``FileNotFoundError``. Under
    ``config.weight_dtype == "int8"`` the layer matmul weights of a
    safetensors checkpoint are quantized as they are loaded, from the
    file's own precision, with the JAX loader's codes and scales. A config
    of the MoE or MLA family raises ``NotImplementedError``."""
    _check_family(config)
    if os.path.isfile(path) and path.endswith(".gguf"):
        return load_gguf_checkpoint(path, config, dtype=dtype, device=device)
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        ggufs = sorted(f for f in os.listdir(path) if f.endswith(".gguf"))
        if ggufs:
            return load_gguf_checkpoint(os.path.join(path, ggufs[0]), config, dtype=dtype, device=device)
        raise FileNotFoundError(f"no .safetensors or .gguf files in {path}")
    opened = []
    try:
        index: Dict[str, SafetensorsFile] = {}
        for fname in files:
            f = SafetensorsFile(os.path.join(path, fname))
            opened.append(f)
            for key in f.keys():
                index[key] = f
        return _stream(lambda n: index[n].get(n), lambda n: index[n].release(n), index.__contains__,
                       HF_NAMES, config, dtype, torch.device(device), config.weight_dtype == "int8", path)
    finally:
        for f in opened:
            f.close()


def load_gguf_checkpoint(path: str, config: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                         device="cuda") -> Params:
    """A GGUF llama-family checkpoint → the port's params on ``device``:
    each tensor dequantized to f32 on the host (``llm/gguf.read_tensor``),
    one at a time, then cast on the device. int8 weights are quantized by
    the engine afterwards, from the cast params, as the JAX package does.
    A config of the MoE or MLA family raises ``NotImplementedError``."""
    from dynamo_tpu_torch.llm.gguf import parse_gguf, read_tensor

    _check_family(config)
    meta = parse_gguf(path)
    infos = {t.name: t for t in meta.tensors}
    with open(path, "rb") as f:
        return _stream(lambda n: torch.from_numpy(np.require(read_tensor(f, meta, infos[n]), requirements="W")),
                       lambda n: None,
                       infos.__contains__, GGUF_NAMES, config, dtype, torch.device(device), False, path)


def _has_weights(d: str) -> bool:
    try:
        return any(f.endswith((".safetensors", ".gguf")) for f in os.listdir(d))
    except OSError:
        return False


def resolve_model(name_or_path: str) -> Optional[str]:
    """A name or path → a local checkpoint, or None (no network):

    1. a directory holding safetensors or GGUF files, or a GGUF file;
    2. the Hugging Face cache layout, under ``$HF_HOME`` (default
       ``~/.cache/huggingface``): ``hub/models--ORG--NAME/snapshots/<rev>/``,
       the revision read from ``refs/main`` where it exists.
    """
    if os.path.isfile(name_or_path) and name_or_path.endswith(".gguf"):
        return name_or_path
    if os.path.isdir(name_or_path) and _has_weights(name_or_path):
        return name_or_path
    root = os.environ.get("HF_HOME") or os.path.expanduser("~/.cache/huggingface")
    repo = os.path.join(root, "hub", f"models--{name_or_path.replace('/', '--')}")
    snaps = os.path.join(repo, "snapshots")
    if os.path.isdir(snaps):
        rev = None
        ref_main = os.path.join(repo, "refs", "main")
        if os.path.isfile(ref_main):
            with open(ref_main) as f:
                rev = f.read().strip()
        candidates = [rev] if rev else sorted(os.listdir(snaps))
        for r in candidates:
            d = os.path.join(snaps, r) if r else None
            if d and os.path.isdir(d) and _has_weights(d):
                return d
    return None
