"""Token sampling: greedy / temperature / top-k / top-p, and seeded draws.

Sampling parameters arrive per request; the scheduler packs them into
per-row arrays so one call serves a mixed-parameter batch. The sampling
distribution (``filtered_probs_rows``) and the inverse-CDF pick from
precomputed uniforms (``sample_from_uniforms``) are the JAX package's,
so both packages pick the same token from the same logits and uniforms.
Keys are the JAX package's threefry keys (``engine/prng.py``): the
per-step draw (``sample_batch_device``, no host read), the per-row keys
of seeded requests (``make_row_keys``) and a fused window's uniforms
(``make_window_uniforms``)
give the JAX package's values for the same scheduler key and seeds.

The per-request extras are the JAX package's functions too: OpenAI
frequency/presence penalties over the generated tokens
(``apply_penalties``), the chosen token's log-probability
(``compute_logprobs``) and the ``TOP_LOGPROBS_CAP`` most likely tokens
(``compute_topk_logprobs``, ties broken toward the lower id as
``jax.lax.top_k`` breaks them), and the draws that return them
(``sample_batch_logprobs`` / ``sample_batch_top_logprobs`` and their
guided forms, whose logprobs are of the masked distribution). They are
plain PyTorch on the logits' device: the JAX package computes them in XLA,
outside any Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine import prng


@dataclass
class SamplingParams:
    """Host-side per-request sampling options."""

    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1 = disabled; temperature 0 = greedy
    # Per-request PRNG: the same seed and prompt draw from the same keys
    # whatever the batch around them (the key folds in the request's token
    # position, not the scheduler's step counter).
    seed: Optional[int] = None
    # OpenAI penalties over the generated tokens (not the prompt), applied
    # to the logits before temperature, top-k and top-p.
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    # The chosen token's log-probability with each token, and the number of
    # most likely alternatives beside it (implies ``logprobs``).
    logprobs: bool = False
    top_logprobs: int = 0
    # Per-request processors (logits_processing), applied on the device.
    logits_processors: List = field(default_factory=list)

    @property
    def has_penalties(self) -> bool:
        return self.frequency_penalty != 0.0 or self.presence_penalty != 0.0


def pack_param_rows(samplings: List[SamplingParams], bucket: int):
    """Pack per-request sampling params into per-row numpy arrays padded to
    ``bucket``. Pad rows are greedy (temperature 0.0, top_p 1.0)."""
    temps = np.zeros((bucket,), dtype=np.float32)
    top_ks = np.zeros((bucket,), dtype=np.int32)
    top_ps = np.ones((bucket,), dtype=np.float32)
    for i, s in enumerate(samplings):
        temps[i] = s.temperature
        top_ks[i] = s.top_k
        top_ps[i] = s.top_p
    return temps, top_ks, top_ps


def _exact_thresholds(scaled, lse, top_k, top_p):
    """Full-vocab top-k/top-p truncation thresholds (one descending sort)."""
    V = scaled.shape[-1]
    srt = torch.sort(scaled, dim=-1, descending=True).values  # [B, V]
    k_idx = (torch.where(top_k > 0, top_k, torch.full_like(top_k, V)) - 1).clamp(0, V - 1)
    kth = torch.gather(srt, 1, k_idx[:, None].long())[:, 0]
    neg_inf = torch.full_like(kth, -float("inf"))
    k_thresh = torch.where(top_k > 0, kth, neg_inf)

    probs = torch.exp(srt - lse)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]
    min_kept = torch.where(keep, srt, torch.full_like(srt, float("inf"))).amin(dim=-1)
    p_thresh = torch.where(top_p < 1.0, min_kept, neg_inf)
    return torch.maximum(k_thresh, p_thresh)


def filtered_probs_rows(
    logits: torch.Tensor,  # [B, V] f32
    temps: torch.Tensor,  # [B] f32 (0 = greedy)
    top_ks: torch.Tensor,  # [B] i32 (0 = off)
    top_ps: torch.Tensor,  # [B] f32 (1 = off)
) -> torch.Tensor:
    """The reference sampling distribution: temperature scale + exact
    top-k/top-p truncation + softmax, per row. Greedy rows (temperature 0)
    return a one-hot argmax distribution."""
    V = logits.shape[-1]
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))
    scaled = logits / safe_t[:, None]
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    thresh = _exact_thresholds(scaled, lse, top_ks, top_ps)
    masked = torch.where(scaled >= thresh[:, None], scaled, torch.full_like(scaled, -float("inf")))
    probs = torch.softmax(masked, dim=-1)
    greedy = torch.nn.functional.one_hot(torch.argmax(logits, dim=-1), V).to(probs.dtype)
    return torch.where((temps > 0)[:, None], probs, greedy)


def pick_from_probs(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw: the first index whose cumulative probability
    exceeds ``u`` (per row). The fp-degenerate tail (u beyond the row's
    total mass) falls back to the row's mode."""
    cum = torch.cumsum(probs, dim=-1)
    hit = cum > u[:, None]
    picked = torch.argmax(hit.to(torch.int32), dim=-1)
    fallback = torch.argmax(probs, dim=-1)
    return torch.where(hit[:, -1], picked, fallback).to(torch.int32)


def sample_from_uniforms(
    logits: torch.Tensor,  # [B, V] f32
    temps: torch.Tensor,  # [B] f32 (0 = greedy)
    top_ks: torch.Tensor,  # [B] i32 (0 = off)
    top_ps: torch.Tensor,  # [B] f32 (1 = off)
    u: torch.Tensor,  # [B] f32 — uniforms in [0, 1)
) -> torch.Tensor:
    """One token per row from precomputed uniforms (greedy rows ride their
    one-hot distribution, which any u < 1 picks)."""
    return pick_from_probs(filtered_probs_rows(logits, temps, top_ks, top_ps), u)


def make_row_keys(
    base_key: np.ndarray,  # [2] uint32
    seeds: np.ndarray,  # [B] i32 (0 where unseeded)
    positions: np.ndarray,  # [B] i32 per-request token position
    has_seed: np.ndarray,  # [B] bool
) -> np.ndarray:
    """Per-row keys ``[B, 2]``: seeded rows fold their request position into
    ``PRNGKey(seed)`` (independent of the batch), unseeded rows fold their
    row index into the step's base key."""
    seeds = np.asarray(seeds, dtype=np.int64)
    seeded = prng.fold_in(np.stack([np.zeros_like(seeds), seeds & 0xFFFFFFFF], axis=-1), positions)
    unseeded = prng.fold_in(np.broadcast_to(np.asarray(base_key), (len(seeds), 2)), np.arange(len(seeds)))
    return np.where(np.asarray(has_seed, dtype=bool)[:, None], seeded, unseeded)


def make_window_uniforms(
    base_key: np.ndarray,  # [2] uint32
    seeds: np.ndarray,  # [B] i32 (0 where unseeded)
    positions: np.ndarray,  # [B] i32 per-request token position at window start
    has_seed: np.ndarray,  # [B] bool
    num_steps: int,
    device="cpu",
) -> torch.Tensor:
    """A fused sampled window's uniforms → float32 ``[num_steps, B]`` on
    ``device``: ``u[s, b]`` is the draw row b consumes at window step s,
    ``uniform(make_row_keys(fold_in(base_key, s), seeds, positions + s,
    has_seed)[b], ())``, so a seeded row replays the same tokens at any
    batch slot."""
    positions = np.asarray(positions, dtype=np.int64)
    keys = np.stack([
        make_row_keys(prng.fold_in(base_key, s), seeds, positions + s, has_seed) for s in range(num_steps)
    ]).reshape(num_steps, len(positions), 2)
    return prng.uniform(keys, (), device=device)


def sample_batch_device(
    logits: torch.Tensor,  # [B, V] f32
    temps,  # [B] f32 (0 = greedy), numpy or a tensor
    top_ks,  # [B] i32 (0 = off)
    top_ps,  # [B] f32 (1 = off)
    key,  # [2] threefry key: numpy, or a tensor on the logits' device (None: an all-greedy batch)
    row_keys=None,  # [B, 2] per-row keys (seeded requests), numpy or a device tensor
) -> torch.Tensor:
    """One token per row → ``[B]`` int32 on the logits' device, with no host
    read, so a decode window feeds it straight back and a CUDA graph
    replays it whatever the rows ask. The JAX ``sample_batch``: greedy rows
    take the argmax; sampled rows draw ``categorical`` over their
    temperature-scaled logits masked below the exact top-k/top-p
    threshold, from ``key`` over the whole ``[B, V]`` draw or, with
    ``row_keys``, each row from its own key. JAX takes its thresholds from
    the 64 largest logits only where that window is exact, so the full
    sort here gives the same threshold. Every row draws and greedy rows
    are selected by ``torch.where``; the caller, which knows ``temps`` on
    the host, passes no key for an all-greedy batch, which then draws
    nothing (JAX skips the draw there too)."""
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    if key is None and row_keys is None:
        return tokens
    dev = logits.device
    temps, top_ks, top_ps = (torch.as_tensor(x, device=dev) for x in (temps, top_ks, top_ps))
    safe_t = torch.where(temps > 0, temps, 1.0)
    V = logits.shape[-1]
    scaled = logits / safe_t[:, None]
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    thresh = _exact_thresholds(scaled, lse, top_ks, top_ps)
    masked = torch.where(scaled >= thresh[:, None], scaled, -float("inf"))
    shape = (V,) if row_keys is not None else tuple(logits.shape)
    noise = prng.gumbel(row_keys if row_keys is not None else key, shape, dev)
    drawn = torch.argmax(masked + noise, dim=-1).to(torch.int32)
    return torch.where(temps > 0, drawn, tokens)


def apply_token_masks(
    logits: torch.Tensor,  # [B, V] f32
    pool: torch.Tensor,  # [P, ceil(V/32)] int32: the guided mask pool's packed allow bits
    row_ids: torch.Tensor,  # [B] pool row per batch row (0 = allow-all)
) -> torch.Tensor:
    """Grammar-constrained decoding's hook (the JAX ``apply_token_masks``):
    gather each row's allowed-token bits from the mask pool by its FSM row
    and put ``-inf`` on the disallowed logits. Row 0 of the pool allows
    everything, so unguided rows pass through unchanged
    (llm/guided/processor.py owns the pool)."""
    V = logits.shape[-1]
    idx = torch.arange(V, device=logits.device)
    words = pool[row_ids.to(logits.device).long()][:, idx >> 5]  # [B, V]
    bit = (words >> (idx & 31).to(words.dtype)) & 1  # an arithmetic shift keeps bit 31 in bit 0
    return torch.where(bit.bool(), logits, torch.full_like(logits, -float("inf")))



def apply_penalties(
    logits: torch.Tensor,  # [B, V] f32
    hist,  # [B, H] i32: generated-token history, padded
    hist_len,  # [B] i32: valid history per row
    frequency_penalty,  # [B] f32
    presence_penalty,  # [B] f32
) -> torch.Tensor:
    """OpenAI frequency/presence penalties for the whole batch: per-row
    counts of the generated tokens, scattered from the padded history,
    then ``logits - freq·count - pres·(count > 0)``. The ``[B, V]`` counts
    exist only on the logits' device; padded history adds 0 to token 0."""
    dev = logits.device
    hist, hist_len, freq, pres = (torch.as_tensor(x, device=dev) for x in
                                  (hist, hist_len, frequency_penalty, presence_penalty))
    valid = torch.arange(hist.shape[1], device=dev)[None, :] < hist_len[:, None]
    tok = torch.where(valid, hist, 0).long()
    counts = torch.zeros_like(logits).scatter_add_(1, tok, valid.to(logits.dtype))
    return logits - freq[:, None] * counts - pres[:, None] * (counts > 0).to(logits.dtype)


def compute_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Log-probability of the chosen tokens: logits [B, V], tokens [B] → [B]."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, 1, tokens.long()[:, None])[:, 0]


# Alternatives computed per row whatever a row asks (the OpenAI bound is 20);
# rows trim to their own count on the host.
TOP_LOGPROBS_CAP = 20


def _topk_lower_id_first(x: torch.Tensor, k: int) -> tuple:
    """``torch.topk`` with ties broken as ``jax.lax.top_k`` breaks them, the
    lower id first: each value's order-preserving int32 image (-0.0 folded
    into +0.0) in the high half of an int64 key, the reversed id in the low
    half, so no two keys tie."""
    V = x.shape[-1]
    bits = (x + 0.0).view(torch.int32)
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    ids = torch.arange(V - 1, -1, -1, device=x.device, dtype=torch.int64)
    idx = torch.topk(ordered.to(torch.int64) * (1 << 32) + ids, k, dim=-1).indices
    return torch.gather(x, -1, idx), idx


def compute_topk_logprobs(logits: torch.Tensor, tokens: torch.Tensor) -> tuple:
    """Chosen-token logprob and the ``TOP_LOGPROBS_CAP`` most likely tokens'
    ids and logprobs: logits [B, V], tokens [B] → (chosen [B] f32,
    top_ids [B, CAP] i32, top_lps [B, CAP] f32), best first."""
    logp = torch.log_softmax(logits, dim=-1)
    chosen = torch.gather(logp, 1, tokens.long()[:, None])[:, 0]
    top_lps, top_ids = _topk_lower_id_first(logp, min(TOP_LOGPROBS_CAP, logits.shape[-1]))
    return chosen, top_ids.to(torch.int32), top_lps


def sample_batch_logprobs(logits, temps, top_ks, top_ps, key, row_keys=None) -> tuple:
    """``sample_batch_device`` and the chosen tokens' logprobs → (tokens
    [B] i32, logprobs [B] f32) on the logits' device."""
    tok = sample_batch_device(logits, temps, top_ks, top_ps, key, row_keys)
    return tok, compute_logprobs(logits, tok)


def guided_sample_batch_logprobs(logits, pool, k_rows, temps, top_ps, key, row_keys=None) -> tuple:
    """``sample_batch_logprobs`` over the FSM-allowed tokens (``k_rows``
    [2, B]: the rows' top-k, then their mask-pool rows, as in JAX), the
    logprobs of the masked distribution (the model's probability
    renormalised over the allowed tokens, the one the row drew from)."""
    k_rows = torch.as_tensor(k_rows, device=logits.device)
    masked = apply_token_masks(logits, pool, k_rows[1])
    tok = sample_batch_device(masked, temps, k_rows[0], top_ps, key, row_keys)
    return tok, compute_logprobs(masked, tok)


def sample_batch_top_logprobs(logits, temps, top_ks, top_ps, key, row_keys=None) -> tuple:
    """``sample_batch_logprobs`` with the top alternatives → (tokens [B]
    i32, logprobs [B] f32, top_ids [B, CAP] i32, top_lps [B, CAP] f32)."""
    tok = sample_batch_device(logits, temps, top_ks, top_ps, key, row_keys)
    return (tok, *compute_topk_logprobs(logits, tok))


def guided_sample_batch_top_logprobs(logits, pool, k_rows, temps, top_ps, key, row_keys=None) -> tuple:
    """``guided_sample_batch_logprobs`` with the top alternatives, all of the
    masked distribution."""
    k_rows = torch.as_tensor(k_rows, device=logits.device)
    masked = apply_token_masks(logits, pool, k_rows[1])
    tok = sample_batch_device(masked, temps, k_rows[0], top_ps, key, row_keys)
    return (tok, *compute_topk_logprobs(masked, tok))
