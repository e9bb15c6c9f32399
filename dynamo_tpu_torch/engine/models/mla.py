"""Multi-head latent attention (MLA, the DeepSeek-V2/V3 family) over a
paged latent KV cache: the counterpart of the JAX package's
``models/mla.py``.

- **Latent cache**: each token stores one row of ``kv_lora_rank +
  qk_rope_head_dim`` values (512 + 64 for DeepSeek-V2-Lite) instead of
  per-head K and V: ``k`` is ``[L, N, BS, 1, R]``, ``v`` a placeholder
  (engine/kv_cache.py). The blocks are paged like llama's (block 0 is the
  scratch sink), so the scheduler, the prefix cache, KVBM and the exports
  move them unchanged.
- **Absorbed projections**: queries are multiplied by ``w_uk`` first
  (``q_eff = q_nope · W_uk``), so scores contract against the latent
  directly; values decompress once, after the probability-weighted latent
  sum (``out = (p · c_kv) · W_uv``).

The JAX package's MLA attention is a gather through the block table and
einsums, with no Pallas kernel, so here it is PyTorch ops on tensors (the
scheduler runs it on the ``"gather"`` path: no ragged kernel, no flash
prefill, no fused window). Inside the layer loop the cache is read-only;
each layer's fresh latent rows are stacked and written with ONE in-place
write after the loop (a decode window's, after its last step), as in the
JAX version. The feed-forward is llama's ``_mlp``: dense, or MoE with the
live rows as ``valid``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.engine import prng
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.kv_cache import ragged_scatter_targets
from dynamo_tpu_torch.engine.models.llama import (
    NEG_INF, _embed, _gather_kv, _layer_weights, _logits, _mlp, _write_rows, decode_targets, rms_norm,
    rope_angles, rotate,
)
from dynamo_tpu_torch.engine.sampling import sample_batch_device
from dynamo_tpu_torch.engine.weights import Params

# Calls of ``_attend_latent`` (one a layer a forward step), read by chip_smoke.
ATTEND_CALLS = 0


def latent_width(config: ModelConfig) -> int:
    return config.kv_lora_rank + config.qk_rope_head_dim


def _project_q(x: torch.Tensor, lp, c: ModelConfig, rope) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[T, D]`` → (q_eff ``[T, H, r]`` absorbed through ``w_uk``, q_rope
    ``[T, H, rope]`` rotated by ``rope``, the positions' ``rope_angles``)."""
    T = x.shape[0]
    nope = c.qk_nope_head_dim
    q = (x @ lp["wq"]).view(T, c.num_heads, nope + c.qk_rope_head_dim)
    q_rope = rotate(q[..., nope:], *rope)
    q_eff = torch.einsum("thn,hnr->thr", q[..., :nope], lp["w_uk"])  # absorb W_uk
    return q_eff, q_rope


def _latent_kv(x: torch.Tensor, lp, c: ModelConfig, rope) -> torch.Tensor:
    """x ``[T, D]`` → latent rows ``[T, R]`` = ``[norm(c_kv) ‖ rope(k_rope)]``."""
    c_kv = rms_norm(x @ lp["w_dkv"], lp["kv_norm"], c.rms_norm_eps)
    k_rope = rotate((x @ lp["w_kr"])[:, None, :], *rope)[:, 0]
    return torch.cat([c_kv, k_rope], dim=-1)


def _attend_latent(
    q_eff: torch.Tensor,  # [..., T, H, r]
    q_rope: torch.Tensor,  # [..., T, H, rope]
    latent: torch.Tensor,  # [..., S, R]
    mask: torch.Tensor,  # [..., T, S] bool
    lp,
    c: ModelConfig,
) -> torch.Tensor:
    """Latent attention → ``[..., T, H * v_head_dim]``: scores against the
    latent's two parts, an f32 softmax, the weighted latent sum, then
    ``w_uv`` once. A leading batch axis carries decode rows, each over its
    own latent (the JAX version's vmap)."""
    global ATTEND_CALLS
    ATTEND_CALLS += 1
    r = c.kv_lora_rank
    c_kv, k_rope = latent[..., :r], latent[..., r:]
    scale = (c.qk_nope_head_dim + c.qk_rope_head_dim) ** -0.5
    scores = (torch.einsum("...thr,...sr->...ths", q_eff, c_kv)
              + torch.einsum("...the,...se->...ths", q_rope, k_rope)).float() * scale
    scores = scores.masked_fill(~mask.unsqueeze(-2), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q_eff.dtype)
    attn_lat = torch.einsum("...ths,...sr->...thr", probs, c_kv)  # weighted latent sum
    out = torch.einsum("...thr,hrv->...thv", attn_lat, lp["w_uv"])  # decompress once
    return out.reshape(*out.shape[:-2], c.num_heads * c.v_head_dim)


def _layer_loop(params: Params, c: ModelConfig, k_cache, h: torch.Tensor, positions: torch.Tensor,
                attend, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer stack over rows ``h [T, D]`` at ``positions [T]``:
    ``attend(l, lp, q_eff, q_rope, latent_new, k_flat)`` gives layer l's
    attention ``[T, H*v]``. Returns (h, the fresh latent rows ``[L, T, R]``
    in the compute dtype)."""
    L, N, bs = c.num_layers, k_cache.shape[1], c.block_size
    k_flat = k_cache.reshape(L * N, bs, 1, latent_width(c))
    rope = rope_angles(positions, c.qk_rope_head_dim, c.rope_theta)
    rows = h.new_empty((L, h.shape[0], latent_width(c)))
    for l in range(L):
        lp = _layer_weights(params["layers"], l, h.dtype)
        x = rms_norm(h, lp["attn_norm"], c.rms_norm_eps)
        q_eff, q_rope = _project_q(x, lp, c, rope)
        latent_new = _latent_kv(x, lp, c, rope)
        h = h + attend(l, lp, q_eff, q_rope, latent_new, k_flat) @ lp["wo"]
        x = rms_norm(h, lp["mlp_norm"], c.rms_norm_eps)
        h = h + _mlp(x, lp, c, valid)
        rows[l] = latent_new
    return h, rows


def prefill(
    params: Params,
    config: ModelConfig,
    k_cache,  # [L, N, BS, 1, R] tensor or QuantKv
    v_cache: torch.Tensor,  # unused placeholder
    tokens: torch.Tensor,  # [T] bucket-padded token ids
    valid_len,  # actual new tokens (int or 0-d tensor)
    cache_len,  # tokens already in the block table
    block_table: torch.Tensor,  # [W] block ids (0 = scratch)
) -> Tuple[torch.Tensor, object, torch.Tensor]:
    """One prefill chunk: query i attends the ``cache_len`` cached latent
    rows and the chunk's rows ``[0, i]``. Returns (last_logits [V] f32,
    k_cache, v_cache); the latent cache is written in place."""
    c = config
    bs = c.block_size
    T = tokens.shape[0]
    dev = tokens.device
    ctx = block_table.shape[0] * bs
    valid_len, cache_len = int(valid_len), int(cache_len)
    iq = torch.arange(T, dtype=torch.int32, device=dev)
    positions = cache_len + iq
    valid_q = iq < valid_len
    prefix_mask = (torch.arange(ctx, device=dev) < cache_len)[None, :].expand(T, ctx)
    chunk_mask = (iq[None, :] <= iq[:, None]) & valid_q[None, :]
    mask = torch.cat([prefix_mask, chunk_mask], dim=1)  # [T, ctx+T]
    table = block_table.long()
    N = k_cache.shape[1]

    def attend(l, lp, q_eff, q_rope, latent_new, k_flat):
        latent_ctx = _gather_kv(k_flat, table + l * N, q_eff.dtype).reshape(ctx, latent_width(c))
        return _attend_latent(q_eff, q_rope, torch.cat([latent_ctx, latent_new]), mask, lp, c)

    h, rows = _layer_loop(params, c, k_cache, _embed(params, tokens), positions, attend, valid_q)
    tgt_blocks, tgt_offs = ragged_scatter_targets(block_table, positions, valid_q, bs)
    _write_rows(k_cache, rows[:, :, None, :], tgt_blocks, tgt_offs)
    return _logits(params, c, h[max(valid_len - 1, 0)][None])[0], k_cache, v_cache


def decode(
    params: Params,
    config: ModelConfig,
    k_cache,  # [L, N, BS, 1, R]
    v_cache: torch.Tensor,  # unused placeholder
    tokens: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B] each token's position (its write slot)
    block_tables: torch.Tensor,  # [B, W]
    active: torch.Tensor,  # [B] bool
) -> Tuple[torch.Tensor, object, torch.Tensor]:
    """One decode step: row b attends its cached latent rows (keys before
    ``positions[b]``) and its own fresh row, in-register. Returns (logits
    [B, V] f32, k_cache, v_cache); the cache is written in place after the
    loop."""
    c = config
    B = tokens.shape[0]
    dev = tokens.device
    ctx = block_tables.shape[1] * c.block_size
    R = latent_width(c)
    N = k_cache.shape[1]
    positions = positions.to(torch.int32)
    tables = block_tables.long()
    mask = torch.cat([torch.arange(ctx, device=dev)[None, :] < positions[:, None],
                      torch.ones((B, 1), dtype=torch.bool, device=dev)], dim=1)[:, None, :]  # [B, 1, ctx+1]

    def attend(l, lp, q_eff, q_rope, latent_new, k_flat):
        latent_ctx = _gather_kv(k_flat, tables + l * N, q_eff.dtype).reshape(B, ctx, R)
        latent = torch.cat([latent_ctx, latent_new[:, None]], dim=1)
        return _attend_latent(q_eff[:, None], q_rope[:, None], latent, mask, lp, c)[:, 0]

    h, rows = _layer_loop(params, c, k_cache, _embed(params, tokens), positions, attend, active)
    _write_rows(k_cache, rows[:, :, None, :], *decode_targets(positions, block_tables, active, c.block_size))
    return _logits(params, c, h), k_cache, v_cache


def decode_multi(
    params: Params,
    config: ModelConfig,
    k_cache,  # [L, N, BS, 1, R]
    v_cache: torch.Tensor,  # unused placeholder
    tokens: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B] write slot of the current token
    block_tables: torch.Tensor,  # [B, W] — must cover positions + num_steps
    active: torch.Tensor,  # [B] bool
    temps,  # [B] f32 (0 = greedy), numpy or tensor
    top_ks,  # [B] i32 (0 = off)
    top_ps,  # [B] f32 (1 = off)
    rng_key: Optional[np.ndarray],  # [2] uint32 threefry key (None: an all-greedy window)
    num_steps: int,
) -> Tuple[torch.Tensor, object, torch.Tensor]:
    """``num_steps`` decode steps with on-device sampling and token
    feedback, one host sync when the caller reads the tokens. Returns
    (tokens_out [num_steps, B] int32, k_cache, v_cache). Window-local
    latent rows, as in the JAX version: the cache is read-only for the
    whole window (each step attends the window start's prefix), the
    window's rows ride a carry in the compute dtype, and ONE write after
    the last step puts them in the cache (int8 quantizes each row once,
    there). Each step draws with the next subkey of ``rng_key``, as
    llama's ``decode_multi`` does."""
    c = config
    B = tokens.shape[0]
    dev = tokens.device
    bs, L, R = c.block_size, c.num_layers, latent_width(c)
    ctx = block_tables.shape[1] * bs
    N = k_cache.shape[1]
    positions = positions.to(torch.int32)
    tables = block_tables.long()
    keys = None if rng_key is None else torch.from_numpy(prng.split_many(rng_key, num_steps).view(np.int32)).to(dev)
    samp = [torch.as_tensor(x).to(dev) for x in (temps, top_ks, top_ps)]
    mask0 = torch.arange(ctx, device=dev)[None, :] < positions[:, None]  # fixed: the cache is not written in-window
    win = torch.zeros((L, num_steps, B, R), dtype=params["embed"].dtype, device=dev)
    out = torch.zeros((num_steps, B), dtype=torch.int32, device=dev)
    toks = tokens.to(torch.int32)
    ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
    for i in range(num_steps):
        live = (torch.arange(num_steps, device=dev) < i)[None, :].expand(B, num_steps)
        mask = torch.cat([mask0, live, ones], dim=1)[:, None, :]  # [B, 1, ctx+w+1]

        def attend(l, lp, q_eff, q_rope, latent_new, k_flat):
            latent_ctx = _gather_kv(k_flat, tables + l * N, q_eff.dtype).reshape(B, ctx, R)
            latent = torch.cat([latent_ctx, win[l].transpose(0, 1), latent_new[:, None]], dim=1)
            return _attend_latent(q_eff[:, None], q_rope[:, None], latent, mask, lp, c)[:, 0]

        h, rows = _layer_loop(params, c, k_cache, _embed(params, toks), positions + i, attend, active)
        win[:, i] = rows
        toks = sample_batch_device(_logits(params, c, h), *samp, None if keys is None else keys[i])
        out[i] = toks
    # One write for the whole window: row (l, j, b) → slot positions[b] + j.
    steps = torch.arange(num_steps, dtype=torch.int32, device=dev)
    slots = (positions[None, :] + steps[:, None]).reshape(-1)  # [w*B], step-major
    live = active.bool()[None, :].expand(num_steps, B).reshape(-1)
    tgt_blocks, tgt_offs = decode_targets(slots, tables.repeat(num_steps, 1), live, bs)
    _write_rows(k_cache, win.reshape(L, num_steps * B, 1, R), tgt_blocks, tgt_offs)
    return out, k_cache, v_cache
