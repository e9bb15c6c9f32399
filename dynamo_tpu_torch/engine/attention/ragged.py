"""Ragged prefill-chunk attention: one chunk row over ``[cached prefix ; chunk]``.

The piece behind both phase-separated prefill and the chunk row of mixed
prefill+decode steps on the non-megakernel paths, as in the JAX package's
``attention/ragged.py``. A chunk row has ``cache_len`` tokens already in
the paged cache and ``valid_len`` fresh tokens that attend causally within
the chunk and fully over the prefix. Two branches:

- **flash**: the chunk's causal self-attention runs in the flash kernel
  (attention/prefill.py) and the cached-prefix piece is an online-softmax
  partial in PyTorch, merged outside the kernel; fresh chunks
  (``has_prefix=False``) skip the prefix piece and need no gather.
- **xla** (the JAX package's name for it): one masked softmax over the
  concatenated ``[prefix ; chunk]`` keys in PyTorch.

The prefix partial and the xla branch run outside any kernel in the JAX
package too; here they are PyTorch einsums in the inputs' dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from dynamo_tpu_torch.engine.attention import prefill

NEG_INF = -1e30


def ragged_chunk_attention(
    q: torch.Tensor,  # [T, H, HD] post-rope chunk queries
    k_new: torch.Tensor,  # [T, KVH, HD] post-rope chunk keys
    v_new: torch.Tensor,  # [T, KVH, HD]
    k_ctx: Optional[torch.Tensor],  # [ctx, KVH, HD] gathered cached prefix (None iff flash and fresh)
    v_ctx: Optional[torch.Tensor],
    valid_len: int,  # the row's fresh tokens
    cache_len: int,  # the row's cached prefix length
    *,
    num_kv_heads: int,
    use_flash: bool = False,
    has_prefix: bool = True,
) -> torch.Tensor:
    """Attention for one ragged chunk row over ``[cached prefix ; chunk]``.
    Returns ``[T, H, HD]`` in q's dtype."""
    T, H, HD = q.shape
    kvh = num_kv_heads
    G = H // kvh
    scale = HD**-0.5
    qg = q.reshape(T, kvh, G, HD)

    if use_flash:
        out2, m2, l2 = prefill.flash_chunk_attention(q, k_new, v_new, valid_len, num_kv_heads=kvh)
        if not has_prefix:
            return out2
        # Cached-prefix partial, merged with the kernel's chunk piece.
        key_pos = torch.arange(k_ctx.shape[0], device=q.device)
        s = torch.einsum("tkgd,skd->ktgs", qg, k_ctx).float() * scale
        s = s.masked_fill((key_pos >= cache_len)[None, None, None, :], NEG_INF)
        m1 = s.amax(dim=-1)  # [KVH, T, G]
        p = torch.exp(s - m1[..., None])
        l1 = p.sum(dim=-1)
        acc1 = torch.einsum("ktgs,skd->ktgd", p.to(v_ctx.dtype), v_ctx).float()
        return prefill.merge_attention_pieces(out2, m2, l2, m1, l1, acc1)

    # One masked softmax over [prefix ; chunk]. A fresh chunk (cache_len 0)
    # masks the whole prefix, so ``has_prefix`` changes nothing here.
    ctx = k_ctx.shape[0]
    key_pos = torch.arange(ctx, device=q.device)
    chunk_q = torch.arange(T, device=q.device)
    prefix_mask = (key_pos[None, :] < cache_len).expand(T, ctx)
    chunk_mask = (chunk_q[None, :] <= chunk_q[:, None]) & (chunk_q[None, :] < valid_len)
    mask = torch.cat([prefix_mask, chunk_mask], dim=1)  # [T, ctx + T]
    k_all = torch.cat([k_ctx, k_new])
    v_all = torch.cat([v_ctx, v_new])
    scores = torch.einsum("tkgd,skd->ktgs", qg, k_all).float() * scale
    scores = scores.masked_fill(~mask[None, :, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("ktgs,skd->tkgd", probs, v_all)
    return out.reshape(T, H, HD)
