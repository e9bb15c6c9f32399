"""ApproxKvIndexer: KV awareness without engine events.

A copy of the JAX package's ``llm/kv_router/approx.py``: the blocks of a
routed request are assumed to live on the chosen worker for a TTL, indexed
in the same radix tree. With ``KvRouterConfig(use_kv_events=False)`` the
KV router's main index is one (``approx_ttl_s``) and it subscribes to no
events; in exact mode it keeps one over decisions whose KV events have not
come yet (``pending_index``, ``pending_overlap_ttl_s``).
"""

from __future__ import annotations

import heapq
import time
from typing import List, Optional, Sequence, Tuple

from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, OverlapScores, WorkerId
from dynamo_tpu_torch.llm.tokens import compute_block_hashes

DEFAULT_TTL_S = 120.0


class ApproxKvIndexer(KvIndexer):
    def __init__(self, block_size: int = 16, ttl_s: float = DEFAULT_TTL_S):
        super().__init__(block_size)
        self.ttl_s = ttl_s
        # Min-heap of (expiry, worker, hashes) pending removal.
        self._expiry: List[Tuple[float, WorkerId, tuple]] = []

    def process_routing_decision(self, worker: WorkerId, token_ids: Sequence[int]) -> None:
        """Assume the chosen worker now caches this prompt's blocks."""
        hashes = compute_block_hashes(token_ids, self.block_size)
        if not hashes:
            return
        self.tree.apply_stored(worker, hashes, None)
        heapq.heappush(self._expiry, (time.monotonic() + self.ttl_s, worker, tuple(hashes)))

    def expire(self, now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        n = 0
        while self._expiry and self._expiry[0][0] <= now:
            _, worker, hashes = heapq.heappop(self._expiry)
            self.tree.apply_removed(worker, list(hashes))
            n += 1
        return n

    def find_matches(self, block_hashes) -> OverlapScores:
        self.expire()
        return super().find_matches(block_hashes)
