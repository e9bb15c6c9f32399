"""Sharded KV indexer: parallel event application for high event rates.

A copy of the JAX package's ``llm/kv_router/sharded.py``. The router's
index is sharded by *worker assignment*:

- every worker is pinned to exactly one shard (the shard with the fewest
  workers at registration — load balancing);
- KV events route to the owning shard only, so shards apply events with no
  cross-shard synchronization (per-worker event order is preserved because
  one worker's events all land on one single-consumer shard);
- match requests scatter-gather across all shards and merge their
  ``OverlapScores`` (a worker's blocks exist only in its shard, so the merge
  is a disjoint union).

Each shard owns a radix tree (``make_radix_tree``: the port's host library
unless ``DYN_NATIVE=0``) behind a lock and
a dedicated applier thread draining a per-shard event queue. Lookups take
the shard locks in the caller's thread (cheap reads, no cross-thread
round-trip); writes scale with the shard count because the expensive
``apply_stored`` work happens in per-shard threads.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Sequence

from dynamo_tpu_torch.llm.kv_router.indexer import OverlapScores, make_radix_tree
from dynamo_tpu_torch.llm.tokens import compute_block_hashes
from dynamo_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)

WorkerId = int
BlockHash = int

_STOP = object()


class _Shard:
    def __init__(self, idx: int):
        self.idx = idx
        self.tree = make_radix_tree()
        self.lock = threading.Lock()
        self.queue: "queue.Queue" = queue.Queue()
        self.thread = threading.Thread(target=self._run, name=f"kv-indexer-shard-{idx}", daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while True:
            item = self.queue.get()
            if item is _STOP:
                # Release any flush fences enqueued behind the stop marker so
                # a flush() racing close() returns instead of timing out.
                while not self.queue.empty():
                    trailing = self.queue.get_nowait()
                    if trailing is not _STOP and trailing[0] == "flush":
                        trailing[2].set()
                return
            kind, worker, payload = item
            try:
                if kind == "flush":
                    payload.set()  # all prior items fully applied (FIFO queue)
                    continue
                with self.lock:
                    if kind == "stored":
                        self.tree.apply_stored(worker, payload[0], payload[1])
                    elif kind == "removed":
                        self.tree.apply_removed(worker, payload)
                    elif kind == "remove_worker":
                        self.tree.remove_worker(worker)
            except Exception:  # noqa: BLE001 — a bad event must not kill the shard
                logger.exception("shard %d: event application failed", self.idx)

    def stop(self) -> None:
        self.queue.put(_STOP)
        self.thread.join(timeout=5.0)


class KvIndexerSharded:
    """Drop-in for :class:`KvIndexer` with ``num_shards`` parallel appliers.

    ``flush()`` drains all shard queues — tests and snapshot capture use it
    to observe a consistent point; the serving path never needs to.
    """

    def __init__(self, block_size: int = 16, num_shards: int = 4):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.block_size = block_size
        self.shards = [_Shard(i) for i in range(num_shards)]
        self._assignment: Dict[WorkerId, int] = {}
        self._counts = [0] * num_shards
        self._assign_lock = threading.Lock()
        self.events_applied = 0

    # --- worker→shard assignment -------------------------------------------
    def _shard_of(self, worker: WorkerId) -> _Shard:
        with self._assign_lock:
            idx = self._assignment.get(worker)
            if idx is None:
                idx = min(range(len(self.shards)), key=lambda i: self._counts[i])
                self._assignment[worker] = idx
                self._counts[idx] += 1
            return self.shards[idx]

    # --- event application (async, per-shard ordered) -----------------------
    def apply_event(self, worker: WorkerId, event: dict) -> None:
        kind = event.get("kind")
        shard = self._shard_of(worker)
        if kind == "stored":
            shard.queue.put(("stored", worker, (event.get("block_hashes") or [], event.get("parent_hash"))))
        elif kind == "removed":
            shard.queue.put(("removed", worker, event.get("block_hashes") or []))
        elif kind == "cleared":
            shard.queue.put(("remove_worker", worker, None))
        self.events_applied += 1

    def remove_worker(self, worker: WorkerId) -> None:
        with self._assign_lock:
            idx = self._assignment.pop(worker, None)
            if idx is not None:
                self._counts[idx] -= 1
        shard = self.shards[idx] if idx is not None else None
        if shard is not None:
            shard.queue.put(("remove_worker", worker, None))

    # --- queries (scatter-gather) ------------------------------------------
    def find_matches(self, block_hashes: Sequence[BlockHash]) -> OverlapScores:
        merged: Dict[WorkerId, int] = {}
        for shard in self.shards:
            with shard.lock:
                scores = shard.tree.find_matches(block_hashes).scores
            merged.update(scores)  # disjoint by construction (worker→one shard)
        return OverlapScores(scores=merged)

    def find_matches_for_tokens(self, token_ids: Sequence[int]) -> OverlapScores:
        return self.find_matches(compute_block_hashes(token_ids, self.block_size))

    # --- maintenance --------------------------------------------------------
    def flush(self, timeout: float = 10.0) -> None:
        """Block until every event enqueued before this call has been fully
        *applied* (quiesce point). Queue emptiness is not enough — the
        applier pops an item before applying it, so an empty queue can
        coexist with an event mid-apply; a per-shard sentinel processed
        in FIFO order cannot."""
        import time

        deadline = time.monotonic() + timeout
        fences = []
        for shard in self.shards:
            ev = threading.Event()
            shard.queue.put(("flush", None, ev))
            fences.append(ev)
        for shard, ev in zip(self.shards, fences):
            while not ev.wait(0.05):
                if not shard.thread.is_alive():
                    break  # shard closed: applier gone, nothing in flight
                if time.monotonic() > deadline:
                    raise TimeoutError("shard queues did not drain")

    def size(self) -> int:
        total = 0
        for shard in self.shards:
            with shard.lock:
                total += shard.tree.size()
        return total

    def dump(self) -> bytes:
        """Merged snapshot across shards (shard-disjoint record union)."""
        import json

        records: List[dict] = []
        for shard in self.shards:
            with shard.lock:
                records.extend(json.loads(shard.tree.dump()))
        return json.dumps(records).encode()

    def load_snapshot(self, raw: bytes) -> None:
        """Restore a snapshot, routing each record to its worker's shard."""
        import json

        for rec in json.loads(raw):
            for w in rec["w"]:
                self.apply_event(w, {"kind": "stored", "block_hashes": [rec["h"]], "parent_hash": rec["p"]})
        self.flush()

    def close(self) -> None:
        for shard in self.shards:
            shard.stop()
