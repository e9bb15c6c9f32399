"""Model parameters: conversion from the JAX package's parameter pytree and
seeded random initialization.

The port keeps the JAX layout: stacked per-layer weights ``[L, in, out]``
used as ``x @ w`` (not ``F.linear``'s ``[out, in]``), so converting a JAX
pytree is a plain copy and both packages compute the same products.
Loading a checkpoint from disk is not ported yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine.config import ModelConfig

Params = Dict[str, object]

_LAYER_KEYS = ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def param_shapes(c: ModelConfig) -> dict:
    """Expected shape of every parameter (the JAX ``init_params`` layout)."""
    L, D, I = c.num_layers, c.hidden_size, c.intermediate_size
    shapes = {
        "embed": (c.vocab_size, D),
        "final_norm": (D,),
        "layers": {
            "attn_norm": (L, D),
            "mlp_norm": (L, D),
            "wq": (L, D, c.q_size),
            "wk": (L, D, c.kv_size),
            "wv": (L, D, c.kv_size),
            "wo": (L, c.q_size, D),
            "w_gate": (L, D, I),
            "w_up": (L, D, I),
            "w_down": (L, I, D),
        },
    }
    if not c.tie_word_embeddings:
        shapes["lm_head"] = (D, c.vocab_size)
    return shapes


def params_from_numpy(
    tree: dict, config: ModelConfig, device: str = "cuda", dtype: torch.dtype = torch.bfloat16
) -> Params:
    """The JAX parameter pytree as numpy arrays
    (``jax.tree_util.tree_map(np.asarray, params)``) → the port's params,
    checked against the config's shapes."""
    shapes = param_shapes(config)

    def conv(name, arr, shape):
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
            extra = set(layers) - set(_LAYER_KEYS)
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
