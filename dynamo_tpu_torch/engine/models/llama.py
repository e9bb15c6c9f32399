"""Llama-family transformer: forward passes over a paged KV cache.

The counterpart of the JAX package's ``models/llama.py``. Attention takes
one of three paths (``resolve_attention_impl``):

- **megakernel**: every attention call goes through
  ``megakernel.ragged_paged_attention``, one launch per layer per step,
  with the same ``build_meta`` rows as the JAX megakernel branches, so
  ``prefill``, ``decode`` and ``mixed_step`` differ only in how they lay
  out the step's ragged rows.
- **paged** / **gather** (the per-piece paths): a prefill chunk attends
  through ``ragged.ragged_chunk_attention`` (the flash chunk kernel plus a
  cached-prefix partial, or one masked softmax), and a decode row merges
  two online-softmax pieces: its cached prefix (the paged flash-decode
  kernel, or a gather through the block table) and its current token,
  in-register. A mixed step runs both.

Write-after-attend: inside the layer loop the cache is read-only. Each
layer's fresh K/V rows are attended in-register and stacked, and the cache
is written once per step after the loop; padded rows sink to scratch
block 0. Norms and rope run in f32; logits are f32.

int8 storage, as in the JAX package: an int8 KV cache (``QuantKv``)
quantizes rows where they are written and is read as codes and scales by
the ragged kernel, or dequantized where the per-piece paths gather pages
(the paged kernel has no int8 branch: ``"paged"`` resolves to the gather);
int8 layer weights (``quant.QuantW``) are dequantized one layer at a time
at the top of the layer loop.

Parameters keep the JAX layout (engine/weights.py): stacked ``[L, in, out]``
weights applied as ``x @ w``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import logging

import numpy as np
import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.attention import decode as paged_decode
from dynamo_tpu_torch.engine.attention import megakernel, ragged
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.kv_cache import QuantKv, quantize_kv_rows, ragged_scatter_targets
from dynamo_tpu_torch.engine import prng
from dynamo_tpu_torch.engine.quant import QuantW, dequant_layer
from dynamo_tpu_torch.engine.sampling import sample_batch_device, sample_from_uniforms
from dynamo_tpu_torch.engine.weights import Params

NEG_INF = -1e30
logger = logging.getLogger(__name__)

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


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) ``[T, 1, hd/2]`` of the rotary angles at ``positions [T]``:
    made once a step and shared by every layer's queries and keys."""
    angles = positions[:, None].float() * rope_frequencies(head_dim, theta, positions.device)  # [T, hd/2]
    return torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Split-halves rotary embedding of x ``[T, heads, head_dim]`` by
    ``rope_angles``."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-halves rotary embedding. x: [T, heads, head_dim]; positions: [T]."""
    return rotate(x, *rope_angles(positions, x.shape[-1], theta))


def _mlp(x: torch.Tensor, lp: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Dense SwiGLU feed-forward of one layer's weights."""
    return (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]


def _layer_weights(layers: Dict, l: int, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s slice of the stacked weights in the compute dtype: int8
    weights are dequantized here, once per layer (``quant.dequant_layer``)."""
    lp = {k: QuantW(w.q[l], w.scale[l]) if isinstance(w, QuantW) else w[l] for k, w in layers.items()}
    return dequant_layer(lp, dtype)


def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    return emb[tokens.long().clamp(0, emb.shape[0] - 1)]


def _logits(params: Params, c: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Final norm + head in f32 logits; tied embeddings use ``embed.T``."""
    head = params.get("lm_head")
    h = rms_norm(h, params["final_norm"], c.rms_norm_eps)
    return (h @ (head if head is not None else params["embed"].T)).float()


def resolve_attention_impl(c: ModelConfig, k_cache=None) -> str:
    """``ModelConfig.attention_impl`` and the cache → one of ``"gather" |
    "paged" | "megakernel"``. ``"auto"`` is the megakernel on the card and on
    the CPU alike (the JAX package keeps the gather off the TPU, where its
    Pallas kernels only interpret). The paged kernel has no int8 branch, so
    ``"paged"`` over an int8 cache degrades to the gather, as in the JAX
    package (``warn_attention_impl_degrade`` says so once)."""
    impl = "megakernel" if c.attention_impl == "auto" else c.attention_impl
    if impl == "paged" and isinstance(k_cache, QuantKv):
        impl = "gather"
    return impl


_warned_paged_int8 = False


def warn_attention_impl_degrade(c: ModelConfig, k_cache) -> None:
    """Log the paged + int8 degrade once, from setup code (the scheduler's
    init), as the JAX package does."""
    global _warned_paged_int8
    if c.attention_impl == "paged" and isinstance(k_cache, QuantKv) and not _warned_paged_int8:
        _warned_paged_int8 = True
        logger.warning(
            "attention_impl='paged' has no int8-KV path — degrading to the gather for this deployment. "
            "Use attention_impl='megakernel' for the ragged kernel's int8 branch."
        )


# attend(l, q, k, v, k_flat, v_flat) -> [T, H, HD]: layer l's attention for
# the step's rows; layer l's pages are rows l*N.. of the layer-flat pool, so
# its block tables are offset by l*N.
Attend = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor, object, object], torch.Tensor]


def _layers(
    params: Params,
    c: ModelConfig,
    k_cache,  # [L, N, BS, KVH, HD] tensor or QuantKv — read-only here
    v_cache,
    h: torch.Tensor,  # [T, D] embedded rows of the step
    positions: torch.Tensor,  # [T]
    attend: Attend,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layer stack. Returns (h, k_rows, v_rows) with the fresh K/V rows
    stacked ``[L, T, KVH, HD]`` in the compute dtype for the caller's single
    cache write."""
    L, N, bs = c.num_layers, k_cache.shape[1], c.block_size
    T = h.shape[0]
    H, KVH, HD = c.num_heads, c.num_kv_heads, c.head_dim
    # Layer-flat page pool: layer l's pages are rows l*N .. l*N+N-1, so the
    # tables are offset by l*N and block 0 of every layer stays its scratch.
    k_flat = k_cache.reshape(L * N, bs, KVH, HD)
    v_flat = v_cache.reshape(L * N, bs, KVH, HD)
    k_rows = h.new_empty((L, T, KVH, HD))
    v_rows = h.new_empty((L, T, KVH, HD))
    rope = rope_angles(positions, HD, c.rope_theta)
    for l in range(L):
        lp = _layer_weights(params["layers"], l, h.dtype)
        x = rms_norm(h, lp["attn_norm"], c.rms_norm_eps)
        q = rotate((x @ lp["wq"]).view(T, H, HD), *rope)
        k = rotate((x @ lp["wk"]).view(T, KVH, HD), *rope)
        v = (x @ lp["wv"]).view(T, KVH, HD)
        attn = attend(l, q, k, v, k_flat, v_flat).to(h.dtype)
        h = h + attn.reshape(T, c.q_size) @ lp["wo"]
        x = rms_norm(h, lp["mlp_norm"], c.rms_norm_eps)
        h = h + _mlp(x, lp)
        k_rows[l] = k
        v_rows[l] = v
    return h, k_rows, v_rows


def _mega_attend(c: ModelConfig, tables: torch.Tensor, meta: torch.Tensor, num_blocks: int) -> Attend:
    """One ragged megakernel launch per layer for all of the step's rows
    (an int8 cache's codes and scales go to the kernel as they are)."""
    tables = tables.to(torch.int32)
    meta = meta.contiguous()

    def attend(l, q, k, v, k_flat, v_flat):
        return megakernel.ragged_paged_attention(
            q, k, v, k_flat, v_flat, (tables + l * num_blocks).contiguous(), meta,
            num_kv_heads=c.num_kv_heads, block_size=c.block_size,
        )

    return attend


def _gather_kv(flat, idx: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Pages through a block-table index: ``[..., W]`` → ``[..., W, BS,
    KVH, HD]``. An int8 cache dequantizes on the way out, directly in the
    compute dtype (code and scale each cast to ``dtype``, their product in
    ``dtype``), as the JAX package's gather does."""
    idx = idx.long()
    if isinstance(flat, QuantKv):
        return flat.q[idx].to(dtype) * flat.scale[idx].to(dtype)
    return flat[idx]


def _attend_piece(qg, kp, vp, maskp, scale):
    """Partial attention over one KV piece → (m, l, acc) online-softmax
    state, unnormalized. qg [B,KVH,G,hd]; kp/vp [B,S,KVH,hd]; maskp [B,S].
    The paged kernel produces the same partials for the cached prefix, so
    the pieces merge identically."""
    s = torch.einsum("bkgd,bskd->bkgs", qg, kp).float() * scale
    s = s.masked_fill(~maskp[:, None, None, :], NEG_INF)
    m = s.amax(dim=-1)  # [B, KVH, G]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskd->bkgd", p.to(vp.dtype), vp).float()
    return m, l, acc


def _token_piece(qg, k, v, scale):
    """``_attend_piece`` over a one-key piece (each decode row's current
    token), in closed form: the softmax of one score is exp(0) = 1, so the
    state is (s, 1, v) exactly. qg [B,KVH,G,hd]; k/v [B,KVH,hd]."""
    m = torch.einsum("bkgd,bkd->bkg", qg, k).float() * scale
    return m, torch.ones_like(m), v.float()[:, :, None, :].expand(qg.shape)


def _merge_pieces(m1, l1, acc1, m2, l2, acc2) -> torch.Tensor:
    """Close the online softmax across two attention pieces → [B,KVH,G,hd]
    f32 (caller casts). Empty pieces (m = -1e30, l = 0) drop out."""
    m_t = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m_t)
    a2 = torch.exp(m2 - m_t)
    l_t = l1 * a1 + l2 * a2
    acc = acc1 * a1[..., None] + acc2 * a2[..., None]
    return acc / l_t.clamp_min(1e-30)[..., None]


def _paged_prefix_partials(c: ModelConfig, q, k_flat, v_flat, tables_l, lengths):
    """Kernel-backed prefix piece in the ``_attend_piece`` partial layout;
    ``tables_l`` and ``lengths`` are int32."""
    return paged_decode.paged_decode_partials(
        q, k_flat, v_flat, tables_l, lengths, num_kv_heads=c.num_kv_heads, block_size=c.block_size,
    )


def _decode_prefix(impl: str, block_tables: torch.Tensor, positions: torch.Tensor, block_size: int):
    """Per-step operands of ``_decode_rows_attention``: the block tables
    (int32 for the paged kernel, int64 for the gather) and the prefix each
    row attends — its length for the kernel, its key mask for the gather."""
    ctx = block_tables.shape[1] * block_size
    if impl == "paged":
        return block_tables.to(torch.int32), positions.clamp(max=ctx).to(torch.int32)
    return block_tables.long(), torch.arange(ctx, device=positions.device)[None, :] < positions[:, None]


def _decode_rows_attention(
    c: ModelConfig,
    impl: str,
    q: torch.Tensor,  # [B, H, HD] decode queries
    k: torch.Tensor,  # [B, KVH, HD] each row's current key
    v: torch.Tensor,
    k_flat,
    v_flat,
    tables_l: torch.Tensor,  # [B, W] layer-offset block tables (_decode_prefix)
    prefix: torch.Tensor,  # [B] prefix lengths (paged) or [B, ctx] prefix mask (gather)
    window: Optional[tuple] = None,  # (k_win [B, w, KVH, HD], v_win, live [B, w]) of a decode window
) -> torch.Tensor:
    """Decode rows as two online-softmax pieces, merged: the cached prefix
    (paged kernel, or the gather) and the in-register rows — the current
    token alone, or inside a decode window ``[window rows ; current]``.
    Returns ``[B, H, HD]`` f32."""
    B, H, HD = q.shape
    KVH = c.num_kv_heads
    scale = HD**-0.5
    qg = q.reshape(B, KVH, H // KVH, HD)
    if impl == "paged":
        m1, l1, acc1 = _paged_prefix_partials(c, q, k_flat, v_flat, tables_l, prefix)
    else:
        ctx = tables_l.shape[1] * c.block_size
        k_ctx = _gather_kv(k_flat, tables_l, q.dtype).reshape(B, ctx, KVH, HD)
        v_ctx = _gather_kv(v_flat, tables_l, q.dtype).reshape(B, ctx, KVH, HD)
        m1, l1, acc1 = _attend_piece(qg, k_ctx, v_ctx, prefix, scale)
    if window is None:
        m2, l2, acc2 = _token_piece(qg, k, v, scale)
    else:
        kw, vw, live = window
        ones = torch.ones((B, 1), dtype=torch.bool, device=q.device)
        m2, l2, acc2 = _attend_piece(qg, torch.cat([kw, k[:, None]], 1), torch.cat([vw, v[:, None]], 1),
                                     torch.cat([live, ones], 1), scale)
    return _merge_pieces(m1, l1, acc1, m2, l2, acc2).reshape(B, H, HD)


def _chunk_attention(
    c: ModelConfig,
    q, k, v, k_flat, v_flat,
    table_l: torch.Tensor,  # [W] the chunk sequence's layer-offset block table
    valid_len: int,
    cache_len: int,
    use_flash: bool,
    has_prefix: bool,
) -> torch.Tensor:
    """A chunk row over [cached prefix ; chunk] (attention/ragged.py); the
    prefix gather is bounded by the caller's width-bucketed table, and flash
    fresh chunks skip it."""
    KVH, HD = c.num_kv_heads, c.head_dim
    if use_flash and not has_prefix:
        k_ctx = v_ctx = None
    else:
        ctx = table_l.shape[0] * c.block_size
        k_ctx = _gather_kv(k_flat, table_l, q.dtype).reshape(ctx, KVH, HD)
        v_ctx = _gather_kv(v_flat, table_l, q.dtype).reshape(ctx, KVH, HD)
    return ragged.ragged_chunk_attention(
        q, k, v, k_ctx, v_ctx, valid_len, cache_len,
        num_kv_heads=KVH, use_flash=use_flash, has_prefix=has_prefix,
    )


def _write_kv(k_cache, v_cache, k_rows, v_rows, tgt_blocks, tgt_offs) -> None:
    """One all-layer cache write of the step's fresh rows ``[L, T, KVH,
    HD]`` at ``tgt_blocks``/``tgt_offs`` ``[T]``. In place: the JAX package
    donates the cache buffers to its jitted step and gets the updated arrays
    back; here ``index_put_`` updates the same storage. An int8 cache
    quantizes the rows on the way in and writes codes and scales (JAX's
    ``_scatter_kv``)."""
    L, T = k_rows.shape[0], k_rows.shape[1]
    layer_idx = torch.arange(L, device=k_rows.device)[:, None].expand(L, T)
    idx = (layer_idx, tgt_blocks.long()[None, :].expand(L, T), tgt_offs.long()[None, :].expand(L, T))
    for cache, rows in ((k_cache, k_rows), (v_cache, v_rows)):
        if isinstance(cache, QuantKv):
            qr = quantize_kv_rows(rows)
            cache.q.index_put_(idx, qr.q)
            cache.scale.index_put_(idx, qr.scale)
        else:
            cache.index_put_(idx, rows)


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def _scalar(x, dev) -> torch.Tensor:
    """A step's scalar (a Python int, or already a 0-d device tensor) as a
    0-d int32 tensor on ``dev``, as the JAX package traces it."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=torch.int32, device=dev)


def _row(h: torch.Tensor, last) -> torch.Tensor:
    """Row ``max(last, 0)`` of ``h`` → ``[1, D]``; a device scalar index is
    never read back to the host."""
    if not isinstance(last, torch.Tensor):
        return h[max(last, 0)][None]
    return h.index_select(0, last.clamp(min=0).reshape(1).long())


def prefill(
    params: Params,
    config: ModelConfig,
    k_cache: torch.Tensor,  # [L, N, BS, KVH, HD]
    v_cache: torch.Tensor,
    tokens: torch.Tensor,  # [T] bucket-padded token ids
    valid_len,  # actual new tokens: a 0-d int device tensor (or a Python int)
    cache_len,  # tokens already in the block table (prefix reuse / chunks), as valid_len
    block_table: torch.Tensor,  # [W] block ids (0 = scratch)
    use_flash: bool = False,  # per-piece paths: the flash kernel for the chunk piece
    has_prefix: bool = True,  # False ⇒ cache_len == 0: flash skips the prefix piece
    all_logits: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One prefill (or prefill chunk): one ragged row of T queries, query i
    attending the ``cache_len`` cached tokens and fresh keys ``[0, i+1)``.
    Returns (last_logits [V] f32, or with ``all_logits`` every row's [T,
    V], k_cache, v_cache); the caches are updated in place. On the
    megakernel path ``valid_len`` and ``cache_len`` stay on the device, so
    a CUDA graph replays the step for any of their values; it ignores
    ``use_flash`` and ``has_prefix``. The per-piece paths read them as
    Python ints."""
    c = config
    T = tokens.shape[0]
    dev = tokens.device
    iq = torch.arange(T, dtype=torch.int32, device=dev)
    h = _embed(params, tokens)
    N = k_cache.shape[1]
    if resolve_attention_impl(c, k_cache) == "megakernel":
        valid_len, cache_len = _scalar(valid_len, dev), _scalar(cache_len, dev)
        positions = cache_len + iq
        valid_q = iq < valid_len
        meta = megakernel.build_meta(
            torch.zeros_like(iq), cache_len.expand_as(iq), torch.zeros_like(iq), iq + 1, valid_q
        )
        attend = _mega_attend(c, block_table[None, :], meta, N)
    else:
        valid_len, cache_len = int(valid_len), int(cache_len)
        positions = cache_len + iq
        valid_q = iq < valid_len
        table = block_table.long()

        def attend(l, q, k, v, k_flat, v_flat):
            return _chunk_attention(c, q, k, v, k_flat, v_flat, table + l * N, valid_len, cache_len,
                                    use_flash, has_prefix)

    tgt_blocks, tgt_offs = ragged_scatter_targets(block_table, positions, valid_q, c.block_size)
    h, k_rows, v_rows = _layers(params, c, k_cache, v_cache, h, positions, attend)
    _write_kv(k_cache, v_cache, k_rows, v_rows, tgt_blocks, tgt_offs)
    if all_logits:
        return _logits(params, c, h), k_cache, v_cache
    return _logits(params, c, _row(h, valid_len - 1))[0], k_cache, v_cache


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
    cached prefix and its own fresh key (one megakernel launch per layer,
    or the two-piece merge of the per-piece paths). Returns (logits [B, V]
    f32, k_cache, v_cache)."""
    c = config
    B = tokens.shape[0]
    dev = tokens.device
    ctx = block_tables.shape[1] * c.block_size
    positions = positions.to(torch.int32)
    h = _embed(params, tokens)
    tgt_blocks, tgt_offs = decode_targets(positions, block_tables, active, c.block_size)
    impl = resolve_attention_impl(c, k_cache)
    N = k_cache.shape[1]
    if impl == "megakernel":
        rows = torch.arange(B, dtype=torch.int32, device=dev)
        meta = megakernel.build_meta(
            rows, positions.clamp(max=ctx), rows, rows + 1, torch.ones_like(rows)
        )
        attend = _mega_attend(c, block_tables, meta, N)
    else:
        tables, prefix = _decode_prefix(impl, block_tables, positions, c.block_size)

        def attend(l, q, k, v, k_flat, v_flat):
            return _decode_rows_attention(c, impl, q, k, v, k_flat, v_flat, tables + l * N, prefix)

    h, k_rows, v_rows = _layers(params, c, k_cache, v_cache, h, positions, attend)
    _write_kv(k_cache, v_cache, k_rows, v_rows, tgt_blocks, tgt_offs)
    return _logits(params, c, h), k_cache, v_cache


# ---------------------------------------------------------------------------
# Multi-step decode windows
# ---------------------------------------------------------------------------


def decode_sample(
    params: Params,
    config: ModelConfig,
    k_cache: torch.Tensor,  # [L, N, BS, KVH, HD]
    v_cache: torch.Tensor,
    tpa: torch.Tensor,  # [3, B] i32 — rows: (tokens, positions, active)
    block_tables: torch.Tensor,  # [B, W]
    temps: torch.Tensor,  # [B] f32 (0 = greedy)
    top_ks: torch.Tensor,  # [B] i32 (0 = off)
    top_ps: torch.Tensor,  # [B] f32 (1 = off)
    rng_key,  # [2] threefry key, numpy or a device tensor
) -> Tuple[torch.Tensor, ...]:
    """One decode step and its draw for the overlapped pipeline, all on the
    device: ``decode``, then ``sample_batch_device``, then the next step's
    inputs ``next_tpa = [sampled; positions + 1; active]``. Returns
    ``(sampled [B] i32, next_tpa [3, B] i32, k_cache, v_cache)``: the
    scheduler hands ``next_tpa`` straight back to launch step N+1 before it
    reads step N's tokens (the JAX ``decode_sample``)."""
    positions = tpa[1].to(torch.int32)
    logits, _, _ = decode(params, config, k_cache, v_cache, tpa[0], positions, block_tables, tpa[2].bool())
    sampled = sample_batch_device(logits, temps, top_ks, top_ps, rng_key)
    return sampled, torch.stack([sampled, positions + 1, tpa[2].to(torch.int32)]), k_cache, v_cache


@dataclass
class WindowCarry:
    """A decode window's device state across its steps: the fresh K/V rows
    of the steps so far ``[L, w, B, KVH, HD]`` in the compute dtype, the
    token each row feeds the next step, the tokens out ``[w, B]`` and, for
    a window that returns them, each step's logits ``[w, B, V]`` f32."""

    k_win: torch.Tensor
    v_win: torch.Tensor
    toks: torch.Tensor
    out: torch.Tensor
    logits: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, params: Params, c: ModelConfig, steps: int, batch: int, device,
               return_logits: bool = False) -> "WindowCarry":
        k_win = torch.zeros((c.num_layers, steps, batch, c.num_kv_heads, c.head_dim), dtype=params["embed"].dtype,
                            device=device)
        logits = None
        if return_logits:
            logits = torch.zeros((steps, batch, params["embed"].shape[0]), dtype=torch.float32, device=device)
        return cls(k_win, torch.zeros_like(k_win), torch.zeros((batch,), dtype=torch.int32, device=device),
                   torch.zeros((steps, batch), dtype=torch.int32, device=device), logits)


def decode_multi(
    params: Params,
    config: ModelConfig,
    k_cache: torch.Tensor,  # [L, N, BS, KVH, HD]
    v_cache: torch.Tensor,
    tokens: torch.Tensor,  # [B] current token per sequence
    positions: torch.Tensor,  # [B] write slot of the current token
    block_tables: torch.Tensor,  # [B, max_blocks] — must cover positions+num_steps
    active: torch.Tensor,  # [B] bool
    temps,  # [B] f32 (0 = greedy), numpy or tensor
    top_ks,  # [B] i32 (0 = off)
    top_ps,  # [B] f32 (1 = off)
    rng_key: Optional[np.ndarray],  # [2] uint32 threefry key (None: an all-greedy window)
    num_steps: int,
    moe_stats: bool = False,
    return_logits: bool = False,
    uniforms: Optional[torch.Tensor] = None,  # [num_steps, B] f32 — inverse-CDF draws
) -> Tuple[torch.Tensor, ...]:
    """``num_steps`` autoregressive decode steps with on-device sampling
    and token feedback: the host syncs once per window, when it reads the
    result. Returns ``(tokens_out [num_steps, B] int32, k_cache,
    v_cache)``, with ``return_logits`` ``(tokens_out, logits [num_steps,
    B, V] f32, k_cache, v_cache)`` (the per-round spec path's draft window
    needs each step's distribution). Stop conditions are checked by the
    caller afterwards.

    The inputs go to the device once, before the loop; each step is
    ``decode_multi_step`` (what a CUDA graph of the window replays). Each
    step splits ``rng_key`` and draws with the subkey, as the JAX version
    does (``prng.split_many`` makes the subkeys at once); with ``uniforms``
    it picks through ``sample_from_uniforms(..., uniforms[i])`` instead,
    the fused window's sampled contract. ``moe_stats`` is not ported yet."""
    if moe_stats:
        raise NotImplementedError("decode_multi: moe_stats is not ported yet (ROADMAP Queue 1 item 16)")
    dev = tokens.device
    carry = WindowCarry.create(params, config, num_steps, tokens.shape[0], dev, return_logits=return_logits)
    keys = None if rng_key is None else torch.from_numpy(prng.split_many(rng_key, num_steps).view(np.int32)).to(dev)
    samp = [torch.as_tensor(x).to(dev) for x in (temps, top_ks, top_ps)]
    if uniforms is not None:
        uniforms = uniforms.to(dev)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(num_steps):
        decode_multi_step(params, config, k_cache, v_cache, tokens, positions, block_tables, active, *samp, keys,
                          step, carry, uniforms=uniforms)
    if return_logits:
        return carry.out, carry.logits, k_cache, v_cache
    return carry.out, k_cache, v_cache


def decode_multi_step(
    params: Params,
    config: ModelConfig,
    k_cache: torch.Tensor,  # [L, N, BS, KVH, HD]
    v_cache: torch.Tensor,
    tokens: torch.Tensor,  # [B] the window's first tokens
    positions: torch.Tensor,  # [B] the window's first write slots
    block_tables: torch.Tensor,  # [B, W] — must cover positions + w
    active: torch.Tensor,  # [B] bool
    temps: torch.Tensor,  # [B] f32 (0 = greedy)
    top_ks: torch.Tensor,  # [B] i32 (0 = off)
    top_ps: torch.Tensor,  # [B] f32 (1 = off)
    keys: Optional[torch.Tensor],  # [w, 2] the steps' threefry keys (None: an all-greedy window)
    step: torch.Tensor,  # 0-d int32: this step's index in the window, advanced in place
    carry: WindowCarry,
    uniforms: Optional[torch.Tensor] = None,  # [w, B] f32 — inverse-CDF draws instead of keys
) -> None:
    """Step ``step`` of a decode window, all on the device: step 0 feeds
    ``tokens``, a later step the carry's tokens. Window-local KV, as in the
    JAX version: the cached prefix each step attends is the window start's,
    and the window's earlier rows come from the carry, in the compute dtype
    (on the megakernel path as the ragged kernel's fresh keys, ``[current ;
    window rows]`` per row; on the per-piece paths as the in-register
    piece). The step writes its own rows to the cache at ``positions +
    step``, past the prefix every step reads, so the cache ends as the JAX
    version's single write leaves it (with an int8 cache each row is
    quantized once, from the compute dtype, as there)."""
    c = config
    L, KVH, HD, bs = c.num_layers, c.num_kv_heads, c.head_dim, c.block_size
    k_win, v_win = carry.k_win, carry.v_win
    w, B = k_win.shape[1], tokens.shape[0]
    N = k_cache.shape[1]
    dev = tokens.device
    positions = positions.to(torch.int32)
    ctx = block_tables.shape[1] * bs
    impl = resolve_attention_impl(c, k_cache)
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    cur = torch.where(step == 0, tokens.to(torch.int32), carry.toks)
    if impl == "megakernel":
        # Row b's fresh keys are its slice [current ; window rows] of the
        # carry; rows past this step are masked by the causal frontier.
        meta = megakernel.build_meta(rows, positions.clamp(max=ctx), rows * (w + 1), rows * (w + 1) + 1 + step,
                                     torch.ones_like(rows))
        mega = _mega_attend(c, block_tables, meta, N)

        def attend(l, q, k, v, k_flat, v_flat):
            k_extra = torch.cat([k[:, None], k_win[l].transpose(0, 1)], 1).reshape(B * (w + 1), KVH, HD)
            v_extra = torch.cat([v[:, None], v_win[l].transpose(0, 1)], 1).reshape(B * (w + 1), KVH, HD)
            return mega(l, q, k_extra, v_extra, k_flat, v_flat)
    else:
        tables, prefix = _decode_prefix(impl, block_tables, positions, bs)
        live = (torch.arange(w, device=dev) < step)[None, :].expand(B, w)

        def attend(l, q, k, v, k_flat, v_flat):
            window = (k_win[l].transpose(0, 1), v_win[l].transpose(0, 1), live)
            return _decode_rows_attention(c, impl, q, k, v, k_flat, v_flat, tables + l * N, prefix, window)

    h, k_rows, v_rows = _layers(params, c, k_cache, v_cache, _embed(params, cur), positions + step, attend)
    idx = step.reshape(1).long()
    k_win.index_copy_(1, idx, k_rows[:, None])
    v_win.index_copy_(1, idx, v_rows[:, None])
    _write_kv(k_cache, v_cache, k_rows, v_rows, *decode_targets(positions + step, block_tables, active, bs))
    logits = _logits(params, c, h)
    if carry.logits is not None:
        carry.logits.index_copy_(0, idx, logits[None])
    if uniforms is not None:
        toks = sample_from_uniforms(logits, temps, top_ks, top_ps, uniforms.index_select(0, idx)[0])
    else:
        toks = sample_batch_device(logits, temps, top_ks, top_ps, None if keys is None else keys[idx][0])
    carry.toks.copy_(toks)
    carry.out.index_copy_(0, idx, toks[None])
    step.add_(1)


def decode_multi_fused(
    params: Params,
    config: ModelConfig,
    k_cache: torch.Tensor,  # [L, N, BS, KVH, HD]
    v_cache: torch.Tensor,
    tokens: torch.Tensor,  # [B] current token per sequence
    positions: torch.Tensor,  # [B] write slot of the current token
    block_tables: torch.Tensor,  # [B, W] — must cover positions+num_steps
    active: torch.Tensor,  # [B] bool
    num_steps: int,
    temps=None,  # [B] f32 (with sampled=True), tensor or numpy
    top_ks=None,  # [B] i32
    top_ps=None,  # [B] f32
    uniforms: Optional[torch.Tensor] = None,  # [num_steps, B] f32 (make_window_uniforms)
    guided_rows=None,  # [B] i32 mask-pool rows (with guided=True), tensor or numpy
    mask_pool: Optional[torch.Tensor] = None,  # [P, ceil(V/32)] int32 packed allow bits
    next_pool: Optional[torch.Tensor] = None,  # [P, V] i32 FSM next-row pool
    sampled: bool = False,
    guided: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A whole window in ONE launch of the fused decode-window kernel
    (``megakernel.fused_decode_window``): every layer of every step, the KV
    writes, the head and each row's pick, with the token fed back on the
    device. Returns ``(tokens_out [num_steps, B] int32, k_cache, v_cache)``,
    the caches written in place; the same tokens and cache contents as
    ``decode_multi`` (greedy, or with ``uniforms=`` when ``sampled``: rows
    with a temperature > 0 draw from the host's uniforms through the
    kernel's sampled epilogue). ``guided=True`` masks each row by its FSM
    row of ``mask_pool`` and advances the rows through ``next_pool`` inside
    the launch (llm/guided's pools; unguided rows at row 0). Dense llama
    only; callers gate with ``megakernel.fused_window_fits``."""
    c = config
    dev = tokens.device
    samp = (None,) * 4
    if sampled:
        samp = tuple(torch.as_tensor(x).to(dev) for x in (temps, top_ks, top_ps, uniforms))
    guide = ()
    if guided:
        if guided_rows is None or mask_pool is None or next_pool is None:
            raise ValueError("decode_multi_fused: guided=True needs guided_rows, mask_pool and next_pool")
        guide = (torch.as_tensor(guided_rows).to(dev), mask_pool, next_pool)
    toks = megakernel.fused_decode_window(
        *_window_weights(params), k_cache, v_cache, tokens, positions, block_tables, active, *samp, *guide,
        num_steps=num_steps, num_heads=c.num_heads, num_kv_heads=c.num_kv_heads,
        head_dim=c.head_dim, block_size=c.block_size, rms_eps=c.rms_norm_eps, theta=c.rope_theta,
    )
    return toks, k_cache, v_cache


def _window_weights(params: Params) -> tuple:
    """A model's weights in the fused kernels' order: embed, head (None when
    tied), final norm, the layers' norms and matrices."""
    lp = params["layers"]
    return (params["embed"], params.get("lm_head"), params["final_norm"], lp["attn_norm"], lp["mlp_norm"],
            lp["wq"], lp["wk"], lp["wv"], lp["wo"], lp["w_gate"], lp["w_up"], lp["w_down"])


def decode_spec_fused(
    target_params: Params,
    target_config: ModelConfig,
    draft_params: Params,
    draft_config: ModelConfig,
    k_t: torch.Tensor,  # [Lt, N, BS, KVHt, HDt] target cache
    v_t: torch.Tensor,
    k_d: torch.Tensor,  # [Ld, N, BS, KVHd, HDd] draft cache
    v_d: torch.Tensor,
    tokens: torch.Tensor,  # [B] i32 last confirmed token
    xprev: torch.Tensor,  # [B] i32 token at positions - 1
    positions: torch.Tensor,  # [B] i32 position of the last confirmed token
    tables_t: torch.Tensor,  # [B, W] i32
    tables_d: torch.Tensor,  # [B, W] i32
    active: torch.Tensor,  # [B] bool
    temps,  # [B] f32, tensor or numpy
    top_ks,  # [B] i32
    top_ps,  # [B] f32
    uniforms: torch.Tensor,  # [rounds, B, 2*gamma+1] f32
    rounds: int,
    gamma: int,
) -> Tuple[torch.Tensor, ...]:
    """``rounds`` speculative rounds (draft γ-burst, target verify,
    rejection sampling) in ONE launch of the fused spec-window kernel
    (``megakernel.fused_spec_window``), both llama models' weights in the
    kernel's order. Returns ``(tokens_out [rounds, B, γ+1], accepted
    [rounds, B], k_t, v_t, k_d, v_d)``, the caches written in place."""
    tc, dc = target_config, draft_config
    dev = tokens.device
    samp = [torch.as_tensor(x).to(dev) for x in (temps, top_ks, top_ps)]
    toks, acc = megakernel.fused_spec_window(
        *_window_weights(target_params), *_window_weights(draft_params),
        k_t, v_t, k_d, v_d, tokens, xprev, positions, tables_t, tables_d, active, *samp, uniforms.to(dev),
        rounds=rounds, gamma=gamma, block_size=tc.block_size,
        t_num_heads=tc.num_heads, t_num_kv_heads=tc.num_kv_heads, t_head_dim=tc.head_dim,
        t_rms_eps=tc.rms_norm_eps, t_theta=tc.rope_theta,
        d_num_heads=dc.num_heads, d_num_kv_heads=dc.num_kv_heads, d_head_dim=dc.head_dim,
        d_rms_eps=dc.rms_norm_eps, d_theta=dc.rope_theta,
    )
    return toks, acc, k_t, v_t, k_d, v_d


# ---------------------------------------------------------------------------
# Batched chunks: wave admission and the per-round spec path
# ---------------------------------------------------------------------------


def _chunk_piece(qg, kp, vp, mask, scale):
    """``_attend_piece`` with S query positions a row: qg [B,S,KVH,G,hd];
    kp/vp [B,S_k,KVH,hd]; mask [B,S_k] (one for every query) or [B,S,S_k]
    → (m, l, acc) with a query axis, [B,KVH,G,S(,hd)]."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kp).float() * scale
    m_b = mask[:, None, None, None, :] if mask.dim() == 2 else mask[:, None, None, :, :]
    s = s.masked_fill(~m_b, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bkgqs,bskd->bkgqd", p.to(vp.dtype), vp).float()
    return m, p.sum(dim=-1), acc


def chunk_decode(
    params: Params,
    config: ModelConfig,
    k_cache: torch.Tensor,  # [L, N, BS, KVH, HD]
    v_cache: torch.Tensor,
    tokens: torch.Tensor,  # [B, S] per-row token chunks (padded)
    positions0: torch.Tensor,  # [B] position of tokens[:, 0]
    valid: torch.Tensor,  # [B] valid tokens per row (0 = inactive row)
    block_tables: torch.Tensor,  # [B, W]
    all_logits: bool = False,
    moe_stats: bool = False,
    last_logits: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched multi-token decode: row b consumes its first ``valid[b]``
    tokens at positions ``positions0[b]..`` in ONE pass, each attending the
    row's cached prefix (keys before ``positions0[b]``) and its own chunk
    causally. Returns ``(argmax [B, S] i32, k_cache, v_cache)``; with
    ``all_logits`` every position's logits ``[B, S, V]`` f32 (the spec
    verify), with ``last_logits`` only each row's last valid position's
    ``[B, V]`` f32, the head run on ``[B, D]`` rows (a wave's first
    tokens). The caches are written in place: slot (b, s) at
    ``positions0[b] + s`` for ``s < valid[b]``, the rest to scratch block 0.

    On the megakernel path the B·S queries are one ragged batch, ONE
    ``megakernel.ragged_paged_attention`` launch per layer: row b's queries
    read only its prefix pages, its fresh keys its own chunk, each row
    padded to a whole number of the kernel's chunk tiles; queries past
    ``valid[b]`` are dead (their logits are not the JAX function's, whose
    padding positions attend anyway; the valid ones are). On the per-piece
    paths attention is the JAX function's own: the whole table gathered
    into a dense prefix and the chunk, two online-softmax pieces merged.
    All inputs stay on the device, so a CUDA graph replays it for any
    values."""
    if moe_stats:
        raise NotImplementedError("chunk_decode: moe_stats is not ported yet (ROADMAP Queue 1 item 16)")
    c = config
    bs, H, KVH, HD = c.block_size, c.num_heads, c.num_kv_heads, c.head_dim
    B, S = tokens.shape
    T = B * S
    dev = tokens.device
    ctx = block_tables.shape[1] * bs
    N = k_cache.shape[1]
    positions0 = positions0.to(torch.int32)
    valid = valid.to(torch.int32)
    s_i = torch.arange(S, dtype=torch.int32, device=dev)
    positions = positions0[:, None] + s_i[None, :]  # [B, S]
    live = s_i[None, :] < valid[:, None]  # [B, S]
    if resolve_attention_impl(c, k_cache) == "megakernel":
        # Each row's queries start a tile of the kernel's chunk path: a row
        # shorter than a tile (a spec verify's γ+1) is padded to one with
        # dead queries, so no tile straddles two rows (whose queries would
        # all but the first row's take the split path, 2.8× slower at the
        # 1B verify's 8 × 5, PERF.md §6).
        bq = megakernel.queries_per_tile(H, KVH)
        P = S if S % bq == 0 else -(-S // bq) * bq
        p_i = torch.arange(P, dtype=torch.int32, device=dev)
        rows = torch.arange(B, dtype=torch.int32, device=dev)[:, None].expand(B, P)
        meta = megakernel.build_meta(rows, positions0.clamp(max=ctx)[:, None].expand(B, P), rows * P,
                                     rows * P + p_i[None, :] + 1, p_i[None, :] < valid[:, None]).reshape(5, B * P)
        mega = _mega_attend(c, block_tables, meta, N)

        def pad(x):
            return x if P == S else F.pad(x.view(B, S, -1), (0, 0, 0, P - S)).view(B * P, *x.shape[1:])

        def attend(l, q, k, v, k_flat, v_flat):
            out = mega(l, pad(q), pad(k), pad(v), k_flat, v_flat)
            return out if P == S else out.view(B, P, H, HD)[:, :S].reshape(T, H, HD)
    else:
        tables = block_tables.long()
        scale = HD**-0.5
        prefix_mask = torch.arange(ctx, device=dev)[None, :] < positions0[:, None]  # [B, ctx]
        chunk_mask = (s_i[None, None, :] <= s_i[None, :, None]) & (s_i[None, None, :] < valid[:, None, None])

        def attend(l, q, k, v, k_flat, v_flat):
            qg = q.view(B, S, KVH, H // KVH, HD)
            k_ctx = _gather_kv(k_flat, tables + l * N, q.dtype).reshape(B, ctx, KVH, HD)
            v_ctx = _gather_kv(v_flat, tables + l * N, q.dtype).reshape(B, ctx, KVH, HD)
            m1, l1, acc1 = _chunk_piece(qg, k_ctx, v_ctx, prefix_mask, scale)
            m2, l2, acc2 = _chunk_piece(qg, k.view(B, S, KVH, HD), v.view(B, S, KVH, HD), chunk_mask, scale)
            attn = _merge_pieces(m1, l1, acc1, m2, l2, acc2).to(q.dtype)  # [B, KVH, G, S, HD]
            return attn.permute(0, 3, 1, 2, 4).reshape(T, H, HD)

    slots = torch.where(live, positions, torch.zeros_like(positions))
    tgt_blocks = torch.where(live, torch.gather(block_tables.long(), 1, (slots // bs).long()), 0)
    h, k_rows, v_rows = _layers(params, c, k_cache, v_cache, _embed(params, tokens.reshape(T)),
                                positions.reshape(T), attend)
    _write_kv(k_cache, v_cache, k_rows, v_rows, tgt_blocks.reshape(T), (slots % bs).reshape(T))
    if last_logits:
        last = (valid - 1).clamp(min=0).long()
        h_last = h.view(B, S, -1)[torch.arange(B, device=dev), last]
        return _logits(params, c, h_last), k_cache, v_cache
    logits = _logits(params, c, h).view(B, S, -1)
    if all_logits:
        return logits, k_cache, v_cache
    return logits.argmax(dim=-1).to(torch.int32), k_cache, v_cache


# ---------------------------------------------------------------------------
# Mixed prefill + decode
# ---------------------------------------------------------------------------


def mixed_step(
    params: Params,
    config: ModelConfig,
    k_cache: torch.Tensor,  # [L, N, BS, KVH, HD]
    v_cache: torch.Tensor,
    p_tokens: torch.Tensor,  # [S] prefill-chunk token ids (bucket-padded)
    p_valid,  # actual chunk tokens: a 0-d int device tensor (or a Python int)
    p_cache_len,  # tokens already materialized for the chunk's sequence, as p_valid
    p_table: torch.Tensor,  # [Wp] the chunk sequence's block table
    d_tokens: torch.Tensor,  # [B] current token per decode row
    d_positions: torch.Tensor,  # [B] write slot of each decode token
    d_tables: torch.Tensor,  # [B, Wd] decode block tables
    d_active: torch.Tensor,  # [B] bool — padded decode lanes are False
    use_flash: bool = False,  # per-piece paths: the flash kernel for the chunk piece
    has_prefix: bool = True,  # False ⇒ p_cache_len == 0: flash skips the prefix piece
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One mixed step: a prefill chunk row plus the decode batch in one
    ragged batch. The token axis is ``[chunk (S) ; decode rows (B)]``;
    chunk query i sees fresh keys ``[0, i+1)``, decode row d sees only its
    own. On the megakernel path the whole batch is one attention launch per
    layer, ``p_valid`` and ``p_cache_len`` stay on the device and the
    chunk's table and the decode tables share one width (the wider; the
    scheduler sends both at one width, so a CUDA graph keys on one); on the
    per-piece paths the chunk goes through ``ragged_chunk_attention``
    (prefill's exact math, its scalars as Python ints) and the decode rows
    through the two-piece merge (decode's). Returns ``(logits [1+B, V]
    f32, k_cache, v_cache)`` — row 0 is the chunk's last valid position,
    rows 1.. the decode rows."""
    c = config
    bs = c.block_size
    S, B = p_tokens.shape[0], d_tokens.shape[0]
    dev = p_tokens.device
    s_iq = torch.arange(S, dtype=torch.int32, device=dev)
    d_iq = torch.arange(B, dtype=torch.int32, device=dev)
    impl = resolve_attention_impl(c, k_cache)
    if impl == "megakernel":
        p_valid, p_cache_len = _scalar(p_valid, dev), _scalar(p_cache_len, dev)
    else:
        p_valid, p_cache_len = int(p_valid), int(p_cache_len)
    p_positions = p_cache_len + s_iq
    p_valid_q = s_iq < p_valid
    d_positions = d_positions.to(torch.int32)
    positions_all = torch.cat([p_positions, d_positions])
    h = _embed(params, torch.cat([p_tokens.long(), d_tokens.long()]))

    Wp, Wd = p_table.shape[0], d_tables.shape[1]
    N = k_cache.shape[1]
    if impl == "megakernel":
        W = max(Wp, Wd)
        tables = torch.cat([F.pad(p_table.to(torch.int32), (0, W - Wp))[None],
                            F.pad(d_tables.to(torch.int32), (0, W - Wd))])
        meta = megakernel.build_meta(
            torch.cat([torch.zeros_like(s_iq), 1 + d_iq]),
            torch.cat([p_cache_len.expand_as(s_iq), d_positions.clamp(max=Wd * bs)]),
            torch.cat([torch.zeros_like(s_iq), S + d_iq]),
            torch.cat([s_iq + 1, S + d_iq + 1]),
            torch.cat([p_valid_q, d_active.bool()]),
        )
        attend = _mega_attend(c, tables, meta, N)
    else:
        p_tab = p_table.long()
        d_tabs, d_prefix = _decode_prefix(impl, d_tables, d_positions, bs)

        def attend(l, q, k, v, k_flat, v_flat):
            attn_p = _chunk_attention(c, q[:S], k[:S], v[:S], k_flat, v_flat, p_tab + l * N, p_valid,
                                      p_cache_len, use_flash, has_prefix)
            attn_d = _decode_rows_attention(c, impl, q[S:], k[S:], v[S:], k_flat, v_flat, d_tabs + l * N,
                                            d_prefix)
            return torch.cat([attn_p, attn_d.to(attn_p.dtype)])

    h, k_rows, v_rows = _layers(params, c, k_cache, v_cache, h, positions_all, attend)

    p_blocks, p_offs = ragged_scatter_targets(p_table, p_positions, p_valid_q, bs)
    d_blocks, d_offs = decode_targets(d_positions, d_tables, d_active.bool(), bs)
    _write_kv(
        k_cache, v_cache, k_rows, v_rows,
        torch.cat([p_blocks.long(), d_blocks]), torch.cat([p_offs.long(), d_offs]),
    )
    # Logits only at each sequence's last row: [1+B, D], never [S+B, V].
    h_rows = torch.cat([_row(h, p_valid - 1), h[S:]], dim=0)
    return _logits(params, c, h_rows), k_cache, v_cache
