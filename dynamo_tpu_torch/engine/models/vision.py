"""ViT image encoder for the encode worker (image prompts).

The counterpart of the JAX package's ``engine/models/vision.py``: patchify
as one reshape and matmul, a bidirectional transformer, then a projection
to the language model's hidden size, so the output rows drop into
prefill's embedding stream (``llama.prefill(mm_feats=...)``). The JAX
tower is XLA with no Pallas kernel, so this one is torch ops, with JAX's
numerics: LayerNorm in f32 (cast back), attention scores from a product
in the activation dtype then cast to f32 and scaled, the softmax in f32
and its probabilities cast back before PV, GELU with the tanh
approximation (``jax.nn.gelu``'s default), and an f32 output after
``proj``. Attention over the 256 patches of a 224-pixel image is a plain
softmax(QKᵀ)V.

Parameters keep the JAX layout (stacked ``[L, in, out]`` weights applied
as ``x @ w``); ``params_from_numpy`` carries a JAX pytree across.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, object]


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 12
    num_heads: int = 16
    intermediate_size: int = 4096
    lm_hidden_size: int = 2048  # projection target (the LM's hidden size)
    layer_norm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


PRESETS = {
    # Small tower for tests (CPU-friendly).
    "tiny-vit": VisionConfig(
        image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
        intermediate_size=64, lm_hidden_size=64,
    ),
    # CLIP-L/14-class tower (12 layers, as the JAX preset) projected to the 1B LM width.
    "vit-l-14": VisionConfig(lm_hidden_size=2048),
}


def param_shapes(c: VisionConfig) -> dict:
    L, D, F_ = c.num_layers, c.hidden_size, c.intermediate_size
    return {
        "patch_embed": (c.patch_size * c.patch_size * 3, D),
        "pos_embed": (c.num_patches, D),
        "layers": {"ln1": (L, D), "ln1_b": (L, D), "ln2": (L, D), "ln2_b": (L, D), "wq": (L, D, D),
                   "wk": (L, D, D), "wv": (L, D, D), "wo": (L, D, D), "w_up": (L, D, F_), "w_down": (L, F_, D)},
        "final_ln": (D,),
        "final_ln_b": (D,),
        "proj": (D, c.lm_hidden_size),
    }


def init_params(config: VisionConfig, generator: Optional[torch.Generator] = None, device: str = "cuda",
                dtype: torch.dtype = torch.bfloat16) -> Params:
    """Random weights with the JAX ``init_params`` shapes (normal draws
    times 0.02 for the embeddings and the fan-in's ``in**-0.5`` for the
    matmul weights; LayerNorm weights one, biases zero), drawn from
    ``generator`` on ``device``. The values differ from ``jax.random``'s,
    and so does the stacked layers' scale: JAX's ``dense`` takes
    ``shape[0]**-0.5``, the layer count for an ``[L, in, out]`` stack, where
    its llama init (and this one) takes the fan-in."""
    shapes = param_shapes(config)

    def dense(shape, scale=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        return (torch.randn(shape, generator=generator, device=device, dtype=torch.float32) * scale).to(dtype)

    ls = shapes["layers"]
    params: Params = {"patch_embed": dense(shapes["patch_embed"], 0.02), "pos_embed": dense(shapes["pos_embed"], 0.02)}
    layers = {k: dense(ls[k]) for k in ("wq", "wk", "wv", "wo", "w_up", "w_down")}
    for k in ("ln1", "ln2"):
        layers[k] = torch.ones(ls[k], device=device, dtype=dtype)
        layers[k + "_b"] = torch.zeros(ls[k], device=device, dtype=dtype)
    params["layers"] = layers
    params["final_ln"] = torch.ones(shapes["final_ln"], device=device, dtype=dtype)
    params["final_ln_b"] = torch.zeros(shapes["final_ln_b"], device=device, dtype=dtype)
    params["proj"] = dense(shapes["proj"])
    return params


def params_from_numpy(tree: dict, config: VisionConfig, device: str = "cuda",
                      dtype: torch.dtype = torch.bfloat16) -> Params:
    """The JAX parameter pytree as numpy arrays → the port's params, checked
    against the config's shapes."""
    shapes = param_shapes(config)

    def conv(name, arr, shape):
        arr = np.asarray(arr, dtype=np.float32)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(arr.shape)}")
        return torch.from_numpy(arr.copy()).to(device=device, dtype=dtype)

    if set(tree) != set(shapes) or set(tree["layers"]) != set(shapes["layers"]):
        raise ValueError(f"expected parameters {sorted(shapes)} with layers {sorted(shapes['layers'])}")
    out: Params = {k: conv(k, tree[k], s) for k, s in shapes.items() if k != "layers"}
    out["layers"] = {k: conv(f"layers.{k}", tree["layers"][k], s) for k, s in shapes["layers"].items()}
    return out


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()).to(x.dtype)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] → [B, P, patch*patch*3] (row-major patch grid)."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


@torch.no_grad()
def encode(params: Params, config: VisionConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] (f32 in [0, 1]) → features [B, P, lm_hidden] f32,
    in the weights' dtype until the projection's output."""
    c = config
    dt = params["patch_embed"].dtype
    h = patchify(images, c.patch_size).to(dt) @ params["patch_embed"] + params["pos_embed"][None]
    B, P, D = h.shape
    nh, hd = c.num_heads, c.head_dim
    scale = hd**-0.5
    layers = params["layers"]
    for l in range(c.num_layers):
        x = _layer_norm(h, layers["ln1"][l], layers["ln1_b"][l], c.layer_norm_eps)
        q = (x @ layers["wq"][l]).view(B, P, nh, hd)
        k = (x @ layers["wk"][l]).view(B, P, nh, hd)
        v = (x @ layers["wv"][l]).view(B, P, nh, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
        p = torch.softmax(s, dim=-1).to(dt)
        attn = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, P, D)
        h = h + attn @ layers["wo"][l]
        x = _layer_norm(h, layers["ln2"][l], layers["ln2_b"][l], c.layer_norm_eps)
        h = h + F.gelu(x @ layers["w_up"][l], approximate="tanh") @ layers["w_down"][l]
    h = _layer_norm(h, params["final_ln"], params["final_ln_b"], c.layer_norm_eps)
    return (h @ params["proj"]).float()
