"""Weight-only int8 quantization: about twice the model per byte of device
memory.

The layer matmul weights are stored as int8 codes with a symmetric scale
per output channel and dequantized to the compute dtype one LAYER at a
time inside the layer loop, so the resident footprint is the int8 codes
plus one layer's transient weights. The embedding and ``lm_head`` stay in
the compute dtype: dequantizing a vocabulary-sized matrix every step
would add its bytes to every token. The same codes, scales and rounding
as the JAX package's ``engine/quant.py``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

# Dense layer matmul weights stored in int8.
QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class QuantW(NamedTuple):
    """int8 weight and its per-output-channel f32 scale."""

    q: torch.Tensor  # int8 [..., in, out]
    scale: torch.Tensor  # f32 [..., 1, out]


def quantize_weight(w: torch.Tensor) -> QuantW:
    """Symmetric int8 over the input axis: scale ``amax / 127`` per output
    column (1 where a column is all zeros), codes rounded half to even and
    clipped to ±127."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantW(q, scale)


def wt(x, dtype: torch.dtype = torch.bfloat16):
    """Dequantize a QuantW to the compute dtype; plain tensors pass through.

    The product runs in f32 (codes are exact in f32, the scale is stored in
    f32) and only the result is cast: multiplying in bf16 would round the
    scale to 8 mantissa bits and round the product a second time."""
    if isinstance(x, QuantW):
        return (x.q.float() * x.scale).to(dtype)
    return x


def dequant_layer(lp: Dict, dtype: torch.dtype) -> Dict:
    """One layer's weights in the compute dtype (a transient copy of this
    layer's matmul weights, never the stack)."""
    if not any(isinstance(v, QuantW) for v in lp.values()):
        return lp
    return {k: wt(v, dtype) for k, v in lp.items()}


def quantize_params(params: Dict) -> Dict:
    """Quantize the dense layer matmul weights of a param tree IN PLACE, one
    layer slice at a time, releasing each full-precision stack before the
    next: the stack and its int8 copy never sit side by side, nor the f32
    intermediates of a whole stack."""
    layers = params["layers"]
    for k in QUANT_KEYS:
        if k in layers and not isinstance(layers[k], QuantW):
            w = layers.pop(k)
            if w.dim() >= 3:
                q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
                scale = torch.empty((*w.shape[:-2], 1, w.shape[-1]), dtype=torch.float32, device=w.device)
                for l in range(w.shape[0]):
                    q[l], scale[l] = quantize_weight(w[l])
                layers[k] = QuantW(q, scale)
            else:
                layers[k] = QuantW(*quantize_weight(w))
            del w
    return params


def params_quantized(params: Dict) -> bool:
    return any(isinstance(v, QuantW) for v in params.get("layers", {}).values())
