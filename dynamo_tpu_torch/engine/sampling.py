"""Token sampling: greedy / temperature / top-k / top-p.

Sampling parameters arrive per request; the scheduler packs them into
per-row arrays so one call serves a mixed-parameter batch. The sampling
distribution (``filtered_probs_rows``) and the inverse-CDF pick from
precomputed uniforms (``sample_from_uniforms``) are the JAX package's,
so both packages pick the same token from the same logits and uniforms.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch


@dataclass
class SamplingParams:
    """Host-side per-request sampling options."""

    temperature: float = 1.0
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1 = disabled; temperature 0 = greedy


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


def sample_batch(
    logits: torch.Tensor,  # [B, V] f32
    temps: np.ndarray,  # [B] f32 (0 = greedy)
    top_ks: np.ndarray,  # [B] i32 (0 = off)
    top_ps: np.ndarray,  # [B] f32 (1 = off)
    generator: Optional[torch.Generator],
) -> np.ndarray:
    """Sample one token per row → host ``[B]`` int32. Greedy rows take the
    argmax; sampled rows draw a uniform from ``generator`` and pick through
    ``sample_from_uniforms``. All-greedy batches skip the sort entirely."""
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    rows = np.nonzero(temps > 0)[0]
    if len(rows):
        dev = logits.device
        gen_dev = generator.device if generator is not None else torch.device("cpu")
        idx = torch.from_numpy(rows).to(dev)
        u = torch.rand((len(rows),), generator=generator, device=gen_dev).to(dev)
        tokens[idx] = sample_from_uniforms(
            logits[idx],
            torch.from_numpy(temps[rows]).to(dev),
            torch.from_numpy(top_ks[rows]).to(dev),
            torch.from_numpy(top_ps[rows]).to(dev),
            u,
        )
    return tokens.cpu().numpy()
