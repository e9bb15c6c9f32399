"""KV-aware worker selection: the routing cost function.

A copy of the JAX package's ``llm/kv_router/scheduler.py``:

    potential_prefill_blocks = prompt_blocks - overlap_blocks(worker)
    logit = overlap_score_weight * (potential_prefill_blocks
                                    + pending_prefill_blocks) + decode_blocks
    → softmax-sample over -logit with ``temperature``;
      temperature 0 ⇒ argmin (exact ties broken by a seeded draw).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from dynamo_tpu_torch.llm.kv_router.indexer import OverlapScores
from dynamo_tpu_torch.llm.kv_router.sequence import ActiveSequencesMultiWorker

WorkerId = int


@dataclass
class SchedulingDecision:
    worker: WorkerId
    overlap_blocks: int
    cost: float


class KvScheduler:
    def __init__(
        self,
        sequences: ActiveSequencesMultiWorker,
        *,
        overlap_score_weight: float = 1.0,
        temperature: float = 0.0,
        rng: Optional[random.Random] = None,
    ):
        self.sequences = sequences
        self.overlap_score_weight = overlap_score_weight
        self.temperature = temperature
        self.rng = rng or random.Random(0)

    def select_worker(
        self,
        workers: Sequence[WorkerId],
        prompt_blocks: int,
        overlaps: OverlapScores,
        *,
        overlap_score_weight: Optional[float] = None,
        temperature: Optional[float] = None,
        external_prefill_tokens: Optional[Dict[WorkerId, int]] = None,
        prefill_fractions: Optional[Dict[WorkerId, float]] = None,
    ) -> SchedulingDecision:
        if not workers:
            raise ValueError("no workers to select from")
        w_weight = self.overlap_score_weight if overlap_score_weight is None else overlap_score_weight
        temp = self.temperature if temperature is None else temperature
        external = external_prefill_tokens or {}
        fractions = prefill_fractions or {}

        costs: List[Tuple[WorkerId, float, int]] = []
        for w in workers:
            overlap = min(overlaps.scores.get(w, 0), prompt_blocks)
            potential_prefill_blocks = prompt_blocks - overlap
            decode_blocks = self.sequences.decode_blocks(w)
            # Pending prefill tokens keep the cost honest between metric
            # updates, plus other routers' gossiped pending prefills.
            pending = self.sequences.prefill_tokens(w) + external.get(w, 0)
            pending_prefill_blocks = pending / max(self.sequences.block_size, 1)
            # Elastic capacity dial: a worker dialed toward prefill
            # (fraction > 0.5) clears prefill blocks proportionally faster,
            # so its prefill cost shrinks by the same 2·f factor the dial
            # scales mixed_prefill_budget by (f = 0.5 ⇒ exact pre-elastic
            # cost; gossiped via ForwardPassMetrics.elastic_prefill_fraction).
            pf_scale = 1.0 / max(2.0 * fractions.get(w, 0.5), 0.1)
            cost = w_weight * (potential_prefill_blocks + pending_prefill_blocks) * pf_scale + decode_blocks
            costs.append((w, cost, overlap))

        chosen = self._softmax_sample(costs, temp)
        return SchedulingDecision(worker=chosen[0], overlap_blocks=chosen[2], cost=chosen[1])

    def _softmax_sample(self, costs: List[Tuple[WorkerId, float, int]], temperature: float):
        if temperature <= 0.0:
            # Deterministic best; EXACT ties break randomly — id-ordered
            # tie-breaking concentrated every cold request onto one worker
            # (a serial warm pass put 8 prefix groups on one worker and
            # evicted two of them).
            best = min(c[1] for c in costs)
            return self.rng.choice([c for c in costs if c[1] == best])
        # softmax over -cost/temperature
        mx = max(-c[1] / temperature for c in costs)
        weights = [math.exp(-c[1] / temperature - mx) for c in costs]
        total = sum(weights)
        r = self.rng.random() * total
        acc = 0.0
        for c, wgt in zip(costs, weights):
            acc += wgt
            if r <= acc:
                return c
        return costs[-1]
