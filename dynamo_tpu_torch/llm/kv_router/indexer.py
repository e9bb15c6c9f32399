"""Radix tree over chained block hashes: which workers hold which prefixes.

A copy of the JAX package's ``llm/kv_router/indexer.py``: ``RadixTree``
(pure Python, the plain version), ``NativeRadixTree`` (the same interface
over the port's host library, ``native.py``), ``KvIndexer`` (a
single-threaded event applier over whichever ``make_radix_tree`` gives:
the native tree unless ``DYN_NATIVE=0``), ``OverlapScores`` and snapshot
dump/load.

Block hashes chain (each block's hash seeds from its parent's,
``llm/tokens.py``), so a block hash identifies its whole prefix: the tree
keeps a flat index (hash → node) for O(1) event application while
``find_matches`` walks parent→child links for the longest shared prefix per
worker.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from dynamo_tpu_torch.llm.tokens import compute_block_hashes
from dynamo_tpu_torch.native import available, get_native

WorkerId = int
BlockHash = int


@dataclass
class OverlapScores:
    """Per-worker count of matched prefix blocks."""

    scores: Dict[WorkerId, int] = field(default_factory=dict)


class _Node:
    __slots__ = ("block_hash", "workers", "children", "parent", "last_access")

    def __init__(self, block_hash: Optional[BlockHash], parent: Optional["_Node"]):
        self.block_hash = block_hash
        self.workers: Set[WorkerId] = set()
        self.children: Dict[BlockHash, "_Node"] = {}
        self.parent = parent
        self.last_access = time.monotonic()


class RadixTree:
    """The prefix index."""

    def __init__(self):
        self.root = _Node(None, None)
        self._by_hash: Dict[BlockHash, _Node] = {}
        # Per-worker membership for O(worker) removal on instance death.
        self._worker_nodes: Dict[WorkerId, Set[BlockHash]] = {}

    # --- queries ------------------------------------------------------------
    def find_matches(self, block_hashes: Sequence[BlockHash], early_exit: bool = False) -> OverlapScores:
        """Walk the chain; each worker's score is the depth of the deepest
        node on the path that it holds (contiguous from root by construction)."""
        scores: Dict[WorkerId, int] = {}
        node = self.root
        depth = 0
        for h in block_hashes:
            child = node.children.get(h)
            if child is None:
                break
            depth += 1
            child.last_access = time.monotonic()
            for w in child.workers:
                scores[w] = depth
            node = child
            if early_exit and len(node.children) == 0:
                break
        return OverlapScores(scores=scores)

    def size(self) -> int:
        return len(self._by_hash)

    def workers(self) -> List[WorkerId]:
        return sorted(self._worker_nodes)

    # --- mutation (event application) --------------------------------------
    def apply_stored(
        self, worker: WorkerId, block_hashes: Sequence[BlockHash], parent_hash: Optional[BlockHash]
    ) -> None:
        parent = self.root if parent_hash is None else self._by_hash.get(parent_hash)
        if parent is None:
            # Orphan chain (we missed the parent's event — e.g. joined after
            # snapshot purge): root it so partial matching still works.
            parent = self.root
        node = parent
        for h in block_hashes:
            existing = self._by_hash.get(h)
            if existing is not None:
                node = existing
            else:
                child = node.children.get(h)
                if child is None:
                    child = _Node(h, node)
                    node.children[h] = child
                    self._by_hash[h] = child
                node = child
            node.workers.add(worker)
            self._worker_nodes.setdefault(worker, set()).add(h)

    def apply_removed(self, worker: WorkerId, block_hashes: Sequence[BlockHash]) -> None:
        for h in block_hashes:
            node = self._by_hash.get(h)
            if node is None:
                continue
            node.workers.discard(worker)
            wn = self._worker_nodes.get(worker)
            if wn is not None:
                wn.discard(h)
            self._maybe_prune(node)

    def remove_worker(self, worker: WorkerId) -> None:
        for h in list(self._worker_nodes.get(worker, ())):
            node = self._by_hash.get(h)
            if node is not None:
                node.workers.discard(worker)
                self._maybe_prune(node)
        self._worker_nodes.pop(worker, None)

    def _maybe_prune(self, node: _Node) -> None:
        """Remove leaf nodes no worker holds (cascade toward root)."""
        while node is not self.root and not node.workers and not node.children:
            parent = node.parent
            if parent is not None and node.block_hash is not None:
                parent.children.pop(node.block_hash, None)
            if node.block_hash is not None:
                self._by_hash.pop(node.block_hash, None)
            node = parent if parent is not None else self.root

    # --- snapshot (the subscriber uploads it to the object store) ----------
    def dump(self) -> bytes:
        """Serialize as (worker, parent, hashes) chains, BFS order so parents
        restore before children."""
        out = []
        stack = [self.root]
        while stack:
            node = stack.pop()
            for child in node.children.values():
                out.append(
                    {
                        "h": child.block_hash,
                        "p": node.block_hash,
                        "w": sorted(child.workers),
                    }
                )
                stack.append(child)
        return json.dumps(out).encode()

    @classmethod
    def load(cls, raw: bytes) -> "RadixTree":
        return _load_into(cls(), raw)


class NativeRadixTree:
    """Same interface as :class:`RadixTree`, on the port's host library
    (``csrc/native.cc``)."""

    def __init__(self, _impl=None):
        self._impl = _impl if _impl is not None else get_native().RadixTree()

    def find_matches(self, block_hashes: Sequence[BlockHash], early_exit: bool = False) -> OverlapScores:
        return OverlapScores(scores=self._impl.find_matches(block_hashes, early_exit=early_exit))

    def size(self) -> int:
        return self._impl.size()

    def workers(self) -> List[WorkerId]:
        return self._impl.workers()

    def apply_stored(
        self, worker: WorkerId, block_hashes: Sequence[BlockHash], parent_hash: Optional[BlockHash]
    ) -> None:
        self._impl.apply_stored(worker, block_hashes, parent_hash)

    def apply_removed(self, worker: WorkerId, block_hashes: Sequence[BlockHash]) -> None:
        self._impl.apply_removed(worker, block_hashes)

    def remove_worker(self, worker: WorkerId) -> None:
        self._impl.remove_worker(worker)

    def dump(self) -> bytes:
        out = [{"h": h, "p": p, "w": ws} for h, p, ws in self._impl.dump_records()]
        return json.dumps(out).encode()

    @classmethod
    def load(cls, raw: bytes) -> "NativeRadixTree":
        return _load_into(cls(), raw)


def _load_into(tree, raw: bytes):
    """Restore snapshot records (BFS order: parents before children) into
    either tree: the one place that owns the {"h","p","w"} record schema."""
    for rec in json.loads(raw):
        for w in rec["w"]:
            tree.apply_stored(w, [rec["h"]], rec["p"])
    return tree


def make_radix_tree():
    """The native tree, or the pure-Python one when ``DYN_NATIVE=0``."""
    return NativeRadixTree() if available() else RadixTree()


def load_radix(raw: bytes):
    """Restore a snapshot into the tree ``make_radix_tree`` picks."""
    return _load_into(make_radix_tree(), raw)


class KvIndexer:
    """Single-consumer event applier over a RadixTree.
    All events for one worker must arrive in order; cross-worker order is
    irrelevant (per-worker state is independent)."""

    def __init__(self, block_size: int = 16):
        self.tree = make_radix_tree()
        self.block_size = block_size
        self.events_applied = 0

    def apply_event(self, worker: WorkerId, event: dict) -> None:
        kind = event.get("kind")
        if kind == "stored":
            self.tree.apply_stored(worker, event.get("block_hashes") or [], event.get("parent_hash"))
        elif kind == "removed":
            self.tree.apply_removed(worker, event.get("block_hashes") or [])
        elif kind == "cleared":
            self.tree.remove_worker(worker)
        self.events_applied += 1

    def find_matches(self, block_hashes: Sequence[BlockHash]) -> OverlapScores:
        return self.tree.find_matches(block_hashes)

    def find_matches_for_tokens(self, token_ids: Sequence[int]) -> OverlapScores:
        return self.find_matches(compute_block_hashes(token_ids, self.block_size))

    def remove_worker(self, worker: WorkerId) -> None:
        self.tree.remove_worker(worker)

    # Snapshot surface (subscriber.py calls these).
    def dump(self) -> bytes:
        return self.tree.dump()

    def load_snapshot(self, raw: bytes) -> None:
        self.tree = load_radix(raw)

    def size(self) -> int:
        return self.tree.size()

    def flush(self) -> None:
        pass  # synchronous applier: nothing queued
