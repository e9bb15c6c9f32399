"""Speculative decoding: draft-model proposals, one-pass target verification.

The JAX package's ``engine/spec_decode.py``. A small draft model proposes
``gamma`` tokens, the target scores all of them in ONE forward
(``llama.prefill(..., all_logits=True)``), and the longest agreeing prefix
is accepted plus one correction or bonus token from the target. Greedy
acceptance: proposal i is accepted while it equals the target's argmax.

- ``SpecDecodeStats``: the acceptance accounting the scheduler publishes
  as ``ForwardPassMetrics.spec_decode`` (the same keys and rounding).
- ``SpecDecoder``: greedy generation for one sequence over two llama
  models with their own paged caches.
- ``spec_verify``: batched rejection sampling (speculative sampling) over
  mixed greedy and sampled rows, on the JAX package's threefry keys, so the
  same key gives the same ``(accepted, next_token)`` in both packages.

The serving path runs whole windows of speculative rounds in one kernel
launch (``llama.decode_spec_fused``); this module is its reference math.
Proposals are written into both caches as they are made; rejected rows
are never rewound, because each later write lands before anything
attends to that position.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from dynamo_tpu_torch.engine import prng
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays
from dynamo_tpu_torch.engine.models import llama
from dynamo_tpu_torch.engine.sampling import filtered_probs_rows


@dataclass
class SpecDecodeStats:
    """Acceptance accounting."""

    num_spec_tokens: int = 0  # total proposed
    num_accepted_tokens: int = 0
    num_draft_tokens: int = 0
    num_rounds: int = 0  # batch rounds (one per spec dispatch)
    num_seq_rounds: int = 0  # per-row rounds (one per record_round call)
    # How often position i of a proposal run was accepted.
    accepted_per_position: List[int] = field(default_factory=list)

    @property
    def acceptance_rate(self) -> float:
        """Accepted / proposed; 0.0 (never NaN) for γ = 0 or no rounds."""
        return self.num_accepted_tokens / self.num_draft_tokens if self.num_draft_tokens else 0.0

    @property
    def accepted_per_round(self) -> float:
        """Mean tokens confirmed per row-round, the correction or bonus
        included; 0.0 (never NaN) for an empty history."""
        if not self.num_seq_rounds:
            return 0.0
        return (self.num_accepted_tokens + self.num_seq_rounds) / self.num_seq_rounds

    def record_round(self, accepted: int, gamma: int) -> None:
        """Account one row's round: γ proposed, ``accepted`` agreed."""
        self.num_draft_tokens += gamma
        self.num_spec_tokens += gamma
        self.num_accepted_tokens += accepted
        self.num_seq_rounds += 1
        while len(self.accepted_per_position) < gamma:
            self.accepted_per_position.append(0)
        for i in range(accepted):
            self.accepted_per_position[i] += 1

    def to_dict(self) -> dict:
        return {
            "num_spec_tokens": self.num_spec_tokens,
            "num_accepted_tokens": self.num_accepted_tokens,
            "num_draft_tokens": self.num_draft_tokens,
            "num_rounds": self.num_rounds,
            "acceptance_rate": round(self.acceptance_rate, 4),
            "accepted_per_round": round(self.accepted_per_round, 4),
            "accepted_per_position": self.accepted_per_position,
        }


class SpecDecoder:
    """Greedy speculative generation over two llama-family models sharing a
    vocabulary, each with its own paged cache, one sequence at a time. The
    models run on the device of their parameters."""

    def __init__(
        self,
        target_config: ModelConfig,
        target_params,
        draft_config: ModelConfig,
        draft_params,
        *,
        gamma: int = 4,
        dtype: torch.dtype = torch.float32,
    ):
        if target_config.block_size != draft_config.block_size:
            raise ValueError("target and draft must share block_size")
        if target_config.vocab_size != draft_config.vocab_size:
            raise ValueError("target and draft must share the vocabulary")
        self.tc, self.dc = target_config, draft_config
        self.tp, self.dp = target_params, draft_params
        self.gamma = gamma
        self.dtype = dtype
        self.device = target_params["embed"].device

    def _t(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, dtype=np.int32)).to(self.device)

    def generate(
        self,
        prompt: List[int],
        max_tokens: int,
        *,
        eos_token_ids: Optional[List[int]] = None,
        stats: Optional[SpecDecodeStats] = None,
    ) -> List[int]:
        """Greedy generation; returns the generated token ids (≤ max_tokens)."""
        eos = set(eos_token_ids or [])
        bs = self.tc.block_size
        n_blocks = (len(prompt) + max_tokens + self.gamma + 2 + bs - 1) // bs
        table = self._t(np.arange(1, 1 + n_blocks))
        tk = KvCacheArrays.create(self.tc, n_blocks + 1, dtype=self.dtype, device=self.device)
        dk = KvCacheArrays.create(self.dc, n_blocks + 1, dtype=self.dtype, device=self.device)

        T = len(prompt)
        t_logits, _, _ = llama.prefill(self.tp, self.tc, tk.k, tk.v, self._t(prompt), T, 0, table)
        llama.prefill(self.dp, self.dc, dk.k, dk.v, self._t(prompt), T, 0, table)

        out: List[int] = [int(torch.argmax(t_logits))]  # first target token
        n = T  # tokens in the target cache
        d_n = T  # tokens in the draft cache (may lag n)
        one = torch.ones((1,), dtype=torch.bool, device=self.device)

        def d_decode(token: int, pos: int) -> torch.Tensor:
            logits, _, _ = llama.decode(self.dp, self.dc, dk.k, dk.v, self._t([token]), self._t([pos]),
                                        table[None, :], one)
            return logits[0]

        while len(out) < max_tokens and out[-1] not in eos:
            b = out[-1]  # last confirmed token, in neither cache yet
            # The draft catches up on the confirmed tokens it has not
            # consumed (positions d_n..n, the last one b), then proposes γ.
            logits = None
            for pos in range(d_n, n + 1):
                logits = d_decode(out[pos - T], pos)
            proposals = [int(torch.argmax(logits))]
            pos = n + 1
            for _ in range(self.gamma - 1):
                proposals.append(int(torch.argmax(d_decode(proposals[-1], pos))))
                pos += 1

            # The target verifies [b, x1..xγ] in one pass.
            chunk = [b] + proposals
            logits_all, _, _ = llama.prefill(self.tp, self.tc, tk.k, tk.v, self._t(chunk), len(chunk), n, table,
                                             all_logits=True)
            preds = torch.argmax(logits_all, dim=-1).tolist()  # preds[i]: after chunk[:i+1]
            k = 0
            while k < self.gamma and proposals[k] == preds[k]:
                k += 1
            if stats is not None:
                stats.num_rounds += 1
                stats.record_round(k, self.gamma)
            for t in proposals[:k]:
                out.append(t)
                if len(out) >= max_tokens or t in eos:
                    return out[:max_tokens]
            out.append(preds[k])  # correction (k < γ) or bonus (k = γ)
            old_n = n
            n += 1 + k  # b and the accepted proposals are in the target cache
            # The draft consumed b and proposals[:γ-1]; only the confirmed
            # prefix of them is coherent (the catch-up overwrites the rest
            # before anything attends to it).
            d_n = old_n + 1 + min(k, self.gamma - 1)
        return out[:max_tokens]


# ---------------------------------------------------------------------------
# Sampled (rejection-sampling) verification: speculative sampling over
# mixed greedy and sampled rows. Its output distribution is the target's.
# ---------------------------------------------------------------------------


def _filtered_probs(logits, temps, top_ks, top_ps):
    """``sampling.filtered_probs_rows`` over a chunk axis: logits [B, S, V],
    params [B] → probs [B, S, V]; greedy rows one-hot."""
    B, S, V = logits.shape
    flat = filtered_probs_rows(
        logits.reshape(B * S, V), temps.repeat_interleave(S), top_ks.repeat_interleave(S),
        top_ps.repeat_interleave(S),
    )
    return flat.reshape(B, S, V)


def spec_verify(
    draft_logits: torch.Tensor,  # [B, G, V] the draft's logits at each proposal
    target_logits: torch.Tensor,  # [B, G+1, V] the target's at those and the bonus position
    proposals: torch.Tensor,  # [B, G] int
    temps: torch.Tensor,  # [B] f32 (0 = greedy row)
    top_ks: torch.Tensor,  # [B] i32
    top_ps: torch.Tensor,  # [B] f32
    key: np.ndarray,  # [2] uint32 threefry key
):
    """Batched speculative verification → ``(accepted [B] int32,
    next_token [B] int32)``. A sampled row accepts proposal i with
    probability min(1, p_t(x_i) / p_d(x_i)); at the first rejection it
    draws the correction from norm(max(p_t − p_d, 0)) (p_t where that is
    degenerate); with all γ accepted, the bonus from the target's γ+1-th
    distribution. Greedy rows reduce to argmax agreement and an argmax
    correction or bonus. The key splits and draws as the JAX function's."""
    B, G, V = draft_logits.shape
    dev = draft_logits.device
    pd = _filtered_probs(draft_logits, temps, top_ks, top_ps)
    pt = _filtered_probs(target_logits[:, :G], temps, top_ks, top_ps)
    idx = proposals.long()[..., None]
    pt_x = torch.gather(pt, 2, idx)[..., 0]
    pd_x = torch.gather(pd, 2, idx)[..., 0]
    key_u, key_resid, key_bonus = prng.split(key, 3)
    u = prng.uniform(key_u, (B, G), device=dev)
    accept = u < torch.minimum(pt_x / pd_x.clamp_min(1e-20), torch.ones_like(pt_x))
    rejected = ~accept
    first_rej = torch.where(rejected.any(dim=1), torch.argmax(rejected.to(torch.int32), dim=1),
                            torch.full((B,), G, device=dev))

    k = first_rej.clamp(0, G - 1)[:, None, None].expand(B, 1, V)
    pt_k = torch.gather(pt, 1, k)[:, 0]
    pd_k = torch.gather(pd, 1, k)[:, 0]
    resid = (pt_k - pd_k).clamp_min(0.0)
    resid_sum = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(resid_sum > 1e-20, resid / resid_sum.clamp_min(1e-20), pt_k)
    corr = prng.categorical(key_resid, prng.xla_log(resid.clamp_min(1e-30)))

    pt_bonus = _filtered_probs(target_logits[:, G:], temps, top_ks, top_ps)[:, 0]
    bonus = prng.categorical(key_bonus, prng.xla_log(pt_bonus.clamp_min(1e-30)))
    next_token = torch.where(first_rej == G, bonus, corr)
    return first_rej.to(torch.int32), next_token.to(torch.int32)
