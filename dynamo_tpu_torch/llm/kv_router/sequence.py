"""Per-worker in-flight load: the load terms of the routing cost.

A copy of the JAX package's ``llm/kv_router/sequence.py``: per worker, the
in-flight prefill tokens (not yet prefilled) and the decode blocks of its
active requests. They feed ``KvScheduler``'s cost; they are the router's
*predicted* load, updated at scheduling time and corrected on completion.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

WorkerId = int


@dataclass
class _ActiveSeq:
    worker: WorkerId
    prefill_tokens: int  # tokens still needing prefill when scheduled
    decode_blocks: int
    prefill_done: bool = False
    started: float = field(default_factory=time.monotonic)


class ActiveSequencesMultiWorker:
    def __init__(self, block_size: int = 16):
        self.block_size = block_size
        self._seqs: Dict[str, _ActiveSeq] = {}
        self._prefill_tokens: Dict[WorkerId, int] = {}
        self._decode_blocks: Dict[WorkerId, int] = {}

    # --- worker set maintenance --------------------------------------------
    def ensure_worker(self, worker: WorkerId) -> None:
        self._prefill_tokens.setdefault(worker, 0)
        self._decode_blocks.setdefault(worker, 0)

    def remove_worker(self, worker: WorkerId) -> None:
        self._prefill_tokens.pop(worker, None)
        self._decode_blocks.pop(worker, None)
        for rid in [r for r, s in self._seqs.items() if s.worker == worker]:
            del self._seqs[rid]

    # --- request lifecycle --------------------------------------------------
    def add_request(
        self,
        request_id: str,
        worker: WorkerId,
        prompt_tokens: int,
        overlap_blocks: int,
    ) -> None:
        """Register a scheduled request: prefill need = tokens beyond the
        worker's cached prefix; decode load = the NEW blocks this request
        adds. Overlapped blocks are shared with the resident prefix — they
        cost the worker no extra HBM and no extra write bandwidth, so
        counting them at full weight made the cost model route high-overlap
        requests AWAY from their warm worker the moment it had one request
        in flight (the engine's prefix-cache hit then never happened)."""
        self.ensure_worker(worker)
        prefill = max(0, prompt_tokens - overlap_blocks * self.block_size)
        blocks = (prompt_tokens + self.block_size - 1) // self.block_size
        blocks = max(0, blocks - overlap_blocks)
        seq = _ActiveSeq(worker=worker, prefill_tokens=prefill, decode_blocks=blocks)
        self._seqs[request_id] = seq
        self._prefill_tokens[worker] += prefill
        self._decode_blocks[worker] += blocks

    def mark_prefill_done(self, request_id: str) -> None:
        seq = self._seqs.get(request_id)
        if seq is not None and not seq.prefill_done:
            seq.prefill_done = True
            self._prefill_tokens[seq.worker] = max(0, self._prefill_tokens.get(seq.worker, 0) - seq.prefill_tokens)

    def free(self, request_id: str) -> Optional[WorkerId]:
        seq = self._seqs.pop(request_id, None)
        if seq is None:
            return None
        if not seq.prefill_done:
            self._prefill_tokens[seq.worker] = max(0, self._prefill_tokens.get(seq.worker, 0) - seq.prefill_tokens)
        self._decode_blocks[seq.worker] = max(0, self._decode_blocks.get(seq.worker, 0) - seq.decode_blocks)
        return seq.worker

    # --- load queries -------------------------------------------------------
    def prefill_tokens(self, worker: WorkerId) -> int:
        return self._prefill_tokens.get(worker, 0)

    def decode_blocks(self, worker: WorkerId) -> int:
        return self._decode_blocks.get(worker, 0)

    def active_requests(self, worker: WorkerId) -> int:
        return sum(1 for s in self._seqs.values() if s.worker == worker)
