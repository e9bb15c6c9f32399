"""Llama-family transformer: forward passes over a paged KV cache.

The counterpart of the JAX package's ``models/llama.py`` on its megakernel
path. Every attention call goes through
``megakernel.ragged_paged_attention`` — one launch per layer per step —
with the same ``build_meta`` rows as the JAX megakernel branches, so
``prefill``, ``decode`` and ``mixed_step`` differ only in how they lay out
the step's ragged rows.

Write-after-attend: inside the layer loop the cache is read-only. Each
layer's fresh K/V rows are attended from ``k_extra`` and stacked, and the
cache is written once per step after the loop; padded rows sink to
scratch block 0. Norms and rope run in f32; logits are f32.

Parameters keep the JAX layout (engine/weights.py): stacked ``[L, in, out]``
weights applied as ``x @ w``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.attention import megakernel
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.kv_cache import ragged_scatter_targets
from dynamo_tpu_torch.engine.weights import Params

# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (norm * weight.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-halves rotary embedding. x: [T, heads, head_dim]; positions: [T]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)  # [hd/2]
    angles = positions[:, None].float() * freqs  # [T, hd/2]
    cos = torch.cos(angles)[:, None, :]
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _mlp(x: torch.Tensor, layers: Dict[str, torch.Tensor], l: int) -> torch.Tensor:
    """Dense SwiGLU feed-forward."""
    return (F.silu(x @ layers["w_gate"][l]) * (x @ layers["w_up"][l])) @ layers["w_down"][l]


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    return emb[tokens.long().clamp(0, emb.shape[0] - 1)]


def _logits(params: Params, c: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm + head in f32 logits; tied embeddings use ``embed.T``."""
    head = params.get("lm_head")
    h = rms_norm(h, params["final_norm"], c.rms_norm_eps)
    return (h @ (head if head is not None else params["embed"].T)).float()


def _layers(
    params: Params,
    c: ModelConfig,
    k_cache: torch.Tensor,  # [L, N, BS, KVH, HD] — read-only here
    v_cache: torch.Tensor,
    h: torch.Tensor,  # [T, D] embedded rows of the step
    positions: torch.Tensor,  # [T]
    tables: torch.Tensor,  # [R, W] block tables of the step's rows (layer 0)
    meta: torch.Tensor,  # [5, T] build_meta
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layer stack. Returns (h, k_rows, v_rows) with the fresh K/V rows
    stacked ``[L, T, KVH, HD]`` for the caller's single cache write."""
    L, N, bs = c.num_layers, k_cache.shape[1], c.block_size
    T = h.shape[0]
    H, KVH, HD = c.num_heads, c.num_kv_heads, c.head_dim
    # Layer-flat page pool: layer l's pages are rows l*N .. l*N+N-1, so the
    # tables are offset by l*N and block 0 of every layer stays its scratch.
    k_flat = k_cache.view(L * N, bs, KVH, HD)
    v_flat = v_cache.view(L * N, bs, KVH, HD)
    tables = tables.to(torch.int32)
    meta = meta.contiguous()
    k_rows = h.new_empty((L, T, KVH, HD))
    v_rows = h.new_empty((L, T, KVH, HD))
    lay = params["layers"]
    for l in range(L):
        x = rms_norm(h, lay["attn_norm"][l], c.rms_norm_eps)
        q = apply_rope((x @ lay["wq"][l]).view(T, H, HD), positions, c.rope_theta)
        k = apply_rope((x @ lay["wk"][l]).view(T, KVH, HD), positions, c.rope_theta)
        v = (x @ lay["wv"][l]).view(T, KVH, HD)
        attn = megakernel.ragged_paged_attention(
            q, k, v, k_flat, v_flat, (tables + l * N).contiguous(), meta,
            num_kv_heads=KVH, block_size=bs,
        )
        h = h + attn.reshape(T, c.q_size) @ lay["wo"][l]
        x = rms_norm(h, lay["mlp_norm"][l], c.rms_norm_eps)
        h = h + _mlp(x, lay, l)
        k_rows[l] = k
        v_rows[l] = v
    return h, k_rows, v_rows


def _write_kv(k_cache, v_cache, k_rows, v_rows, tgt_blocks, tgt_offs) -> None:
    """One all-layer cache write of the step's fresh rows. In place: the
    JAX package donates the cache buffers to its jitted step and gets the
    updated arrays back; here ``index_put_`` updates the same storage."""
    L, T = k_rows.shape[0], k_rows.shape[1]
    layer_idx = torch.arange(L, device=k_rows.device)[:, None].expand(L, T)
    blocks = tgt_blocks.long()[None, :].expand(L, T)
    offs = tgt_offs.long()[None, :].expand(L, T)
    k_cache.index_put_((layer_idx, blocks, offs), k_rows)
    v_cache.index_put_((layer_idx, blocks, offs), v_rows)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(
    params: Params,
    config: ModelConfig,
    k_cache: torch.Tensor,  # [L, N, BS, KVH, HD]
    v_cache: torch.Tensor,
    tokens: torch.Tensor,  # [T] bucket-padded token ids
    valid_len: int,  # actual new tokens
    cache_len: int,  # tokens already in the block table (prefix reuse / chunks)
    block_table: torch.Tensor,  # [W] block ids (0 = scratch)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One prefill (or prefill chunk): one ragged row of T queries, query i
    attending the ``cache_len`` cached tokens and fresh keys ``[0, i+1)``.
    Returns (last_logits [V] f32, k_cache, v_cache); the caches are
    updated in place."""
    c = config
    T = tokens.shape[0]
    dev = tokens.device
    iq = torch.arange(T, dtype=torch.int32, device=dev)
    positions = cache_len + iq
    valid_q = iq < valid_len
    h = _embed(params, tokens)
    tgt_blocks, tgt_offs = ragged_scatter_targets(block_table, positions, valid_q, c.block_size)
    meta = megakernel.build_meta(
        torch.zeros_like(iq), torch.full_like(iq, cache_len), torch.zeros_like(iq), iq + 1, valid_q
    )
    h, k_rows, v_rows = _layers(params, c, k_cache, v_cache, h, positions, block_table[None, :], meta)
    _write_kv(k_cache, v_cache, k_rows, v_rows, tgt_blocks, tgt_offs)
    return _logits(params, c, h[max(valid_len - 1, 0)]), k_cache, v_cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_targets(
    positions: torch.Tensor,  # [B]
    block_tables: torch.Tensor,  # [B, max_blocks]
    active: torch.Tensor,  # [B] bool
    block_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paged-KV write targets for one decode step: (tgt_blocks [B],
    tgt_offs [B]). Inactive rows sink to scratch block 0 (never
    allocated)."""
    slots = torch.where(active, positions, torch.zeros_like(positions)).long()
    picked = torch.gather(block_tables.long(), 1, (slots // block_size)[:, None])[:, 0]
    return torch.where(active, picked, torch.zeros_like(picked)), slots % block_size


def decode(
    params: Params,
    config: ModelConfig,
    k_cache: torch.Tensor,  # [L, N, BS, KVH, HD]
    v_cache: torch.Tensor,
    tokens: torch.Tensor,  # [B] current token per sequence
    positions: torch.Tensor,  # [B] position of each token (its write slot)
    block_tables: torch.Tensor,  # [B, max_blocks]
    active: torch.Tensor,  # [B] bool — padded batch slots are False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for a batch: B length-1 rows, row b attending its
    cached prefix and its own fresh key. Returns (logits [B, V] f32,
    k_cache, v_cache)."""
    c = config
    B = tokens.shape[0]
    dev = tokens.device
    ctx = block_tables.shape[1] * c.block_size
    positions = positions.to(torch.int32)
    h = _embed(params, tokens)
    tgt_blocks, tgt_offs = decode_targets(positions, block_tables, active, c.block_size)
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    meta = megakernel.build_meta(
        rows, positions.clamp(max=ctx), rows, rows + 1, torch.ones_like(rows)
    )
    h, k_rows, v_rows = _layers(params, c, k_cache, v_cache, h, positions, block_tables, meta)
    _write_kv(k_cache, v_cache, k_rows, v_rows, tgt_blocks, tgt_offs)
    return _logits(params, c, h), k_cache, v_cache


# ---------------------------------------------------------------------------
# Mixed prefill + decode
# ---------------------------------------------------------------------------


def mixed_step(
    params: Params,
    config: ModelConfig,
    k_cache: torch.Tensor,  # [L, N, BS, KVH, HD]
    v_cache: torch.Tensor,
    p_tokens: torch.Tensor,  # [S] prefill-chunk token ids (bucket-padded)
    p_valid: int,  # actual chunk tokens
    p_cache_len: int,  # tokens already materialized for the chunk's sequence
    p_table: torch.Tensor,  # [Wp] the chunk sequence's block table
    d_tokens: torch.Tensor,  # [B] current token per decode row
    d_positions: torch.Tensor,  # [B] write slot of each decode token
    d_tables: torch.Tensor,  # [B, Wd] decode block tables
    d_active: torch.Tensor,  # [B] bool — padded decode lanes are False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One mixed step: a prefill chunk row plus the decode batch in one
    ragged batch, one attention launch per layer. The token axis is
    ``[chunk (S) ; decode rows (B)]``; chunk query i sees fresh keys
    ``[0, i+1)``, decode row d sees only ``[S+d, S+d+1)``. Returns
    ``(logits [1+B, V] f32, k_cache, v_cache)`` — row 0 is the chunk's
    last valid position, rows 1.. the decode rows."""
    c = config
    bs = c.block_size
    S, B = p_tokens.shape[0], d_tokens.shape[0]
    dev = p_tokens.device
    s_iq = torch.arange(S, dtype=torch.int32, device=dev)
    d_iq = torch.arange(B, dtype=torch.int32, device=dev)
    p_positions = p_cache_len + s_iq
    p_valid_q = s_iq < p_valid
    d_positions = d_positions.to(torch.int32)
    positions_all = torch.cat([p_positions, d_positions])
    h = _embed(params, torch.cat([p_tokens.long(), d_tokens.long()]))

    Wp, Wd = p_table.shape[0], d_tables.shape[1]
    tables = torch.zeros((1 + B, max(Wp, Wd)), dtype=torch.int32, device=dev)
    tables[0, :Wp] = p_table
    tables[1:, :Wd] = d_tables
    meta = megakernel.build_meta(
        torch.cat([torch.zeros_like(s_iq), 1 + d_iq]),
        torch.cat([torch.full_like(s_iq, p_cache_len), d_positions.clamp(max=Wd * bs)]),
        torch.cat([torch.zeros_like(s_iq), S + d_iq]),
        torch.cat([s_iq + 1, S + d_iq + 1]),
        torch.cat([p_valid_q, d_active.bool()]),
    )
    h, k_rows, v_rows = _layers(params, c, k_cache, v_cache, h, positions_all, tables, meta)

    p_blocks, p_offs = ragged_scatter_targets(p_table, p_positions, p_valid_q, bs)
    d_blocks, d_offs = decode_targets(d_positions, d_tables, d_active.bool(), bs)
    _write_kv(
        k_cache, v_cache, k_rows, v_rows,
        torch.cat([p_blocks.long(), d_blocks]), torch.cat([p_offs.long(), d_offs]),
    )
    # Logits only at each sequence's last row: [1+B, D], never [S+B, V].
    h_rows = torch.cat([h[max(p_valid - 1, 0)][None], h[S:]], dim=0)
    return _logits(params, c, h_rows), k_cache, v_cache
