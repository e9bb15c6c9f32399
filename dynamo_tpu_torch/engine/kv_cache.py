"""Paged KV cache: device tensors + host-side block allocator with prefix
caching and KV event emission.

The device cache is a global block pool: ``k``/``v`` tensors of shape
``[layers, num_blocks, block_size, kv_heads, head_dim]``, or with
``kv_cache_dtype="int8"`` a :class:`QuantKv` pair of int8 codes and one
f32 scale per (token, KV head). Sequences own *block tables* (lists of
block indices); attention reads pages through them. Block 0 is reserved
as a scratch sink: padded rows write there.

Prefix caching: completed full blocks are registered under their chained
block hash (``dynamo_tpu_torch.llm.tokens``). New sequences match their
prefix hashes against the registry and skip prefill for matched blocks.
Eviction is LRU over unreferenced cached blocks. Every register/evict
emits a KV event for the KV-aware router. The allocator is a copy of the
JAX package's, so both emit the same event sequences.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.llm.tokens import BlockHash


class QuantKv(NamedTuple):
    """int8-quantized KV tensor: codes and a symmetric scale per (token,
    head), the JAX package's layout. Model code dispatches on the type where
    it gathers and writes pages (``dequantize_kv`` / ``quantize_kv_rows``);
    the ragged kernel reads the codes and scales as they are."""

    q: torch.Tensor  # int8, [L, N, BS, KVH, HD]
    scale: torch.Tensor  # f32, [L, N, BS, KVH, 1]

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    def reshape(self, *shape) -> "QuantKv":
        # Layer-flat views ([L*N, ...]) of both members. ``view``, never a
        # copy: the kernel and the cache write must see the same storage.
        return QuantKv(self.q.view(*shape), self.scale.view(*shape[:-1], 1))


def quantize_kv_rows(rows: torch.Tensor) -> QuantKv:
    """Symmetric int8 quantization over the trailing (head_dim) axis: scale
    ``amax / 127`` (1 where a row is all zeros), codes rounded half to even
    and clipped to ±127."""
    x = rows.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return QuantKv(q, scale)


def dequantize_kv(x, dtype: torch.dtype = torch.bfloat16):
    """QuantKv → real-valued rows (code × scale in f32, cast to ``dtype``);
    plain tensors pass through."""
    if isinstance(x, QuantKv):
        return (x.q.float() * x.scale).to(dtype)
    return x


def ragged_scatter_targets(
    block_table: torch.Tensor,  # [W] block ids for one sequence (0 = scratch)
    positions: torch.Tensor,  # [T] absolute write slot per token row
    live: torch.Tensor,  # [T] bool — dead rows (bucket padding) sink to block 0
    block_size: int,
):
    """Paged-KV scatter targets for a ragged run of token rows sharing one
    block table (a prefill chunk, or one sequence's slice of a mixed
    batch). Returns ``(tgt_blocks [T], tgt_offs [T])``; dead rows target
    the reserved scratch block 0 so no real block is corrupted."""
    slots = torch.where(live, positions, torch.zeros_like(positions))
    blocks = block_table.long()[(slots // block_size).long()]
    return torch.where(live, blocks, torch.zeros_like(blocks)), slots % block_size


@dataclass
class KvCacheArrays:
    """Device-side block pool (one tensor pair covering all layers). With
    ``config.kv_cache_dtype == "int8"`` the members are :class:`QuantKv`
    pairs in the JAX package's shapes, so caches carry across unchanged."""

    k: Any  # torch.Tensor | QuantKv — [L, N, BS, KVH, HD]
    v: Any

    @classmethod
    def create(
        cls,
        config: ModelConfig,
        num_blocks: int,
        dtype: torch.dtype = torch.bfloat16,
        device: str = "cuda",
    ) -> "KvCacheArrays":
        """The block pool of ``config``'s family. MLA stores one shared
        latent row a token (``kv_lora_rank + qk_rope_head_dim`` values) in
        ``k``, shape ``[L, N, BS, 1, R]``; ``v`` is a ``[L, 1, 1, 1, 1]``
        placeholder (values decompress from the latent, models/mla.py), and
        an int8 latent keeps one scale a token, as in the JAX package."""
        if config.architecture == "mla":
            width = config.kv_lora_rank + config.qk_rope_head_dim
            shape = (config.num_layers, num_blocks, config.block_size, 1, width)
            if config.kv_cache_dtype == "int8":
                k = QuantKv(torch.zeros(shape, dtype=torch.int8, device=device),
                            torch.zeros((*shape[:-1], 1), dtype=torch.float32, device=device))
            else:
                k = torch.zeros(shape, dtype=dtype, device=device)
            return cls(k=k, v=torch.zeros((config.num_layers, 1, 1, 1, 1), dtype=dtype, device=device))
        shape = (config.num_layers, num_blocks, config.block_size, config.num_kv_heads, config.head_dim)

        def mk():
            if config.kv_cache_dtype == "int8":
                return QuantKv(torch.zeros(shape, dtype=torch.int8, device=device),
                               torch.zeros((*shape[:-1], 1), dtype=torch.float32, device=device))
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(k=mk(), v=mk())


class OutOfBlocksError(Exception):
    pass


@dataclass
class KvEvent:
    """Engine→router cache event."""

    kind: str  # "stored" | "removed"
    block_hashes: List[int]
    parent_hash: Optional[int] = None
    ts: float = field(default_factory=time.time)

    def to_wire(self) -> dict:
        return {
            "kind": self.kind,
            "block_hashes": [h & 0xFFFFFFFFFFFFFFFF for h in self.block_hashes],
            "parent_hash": self.parent_hash,
            "ts": self.ts,
        }


class BlockAllocator:
    """Host-side bookkeeping for the device block pool.

    Block states:
    - free      — on the free list, contents dead.
    - active    — referenced by ≥1 live sequence (refcount > 0).
    - cached    — refcount 0 but registered under a block hash; evictable LRU.
    """

    def __init__(self, num_blocks: int, on_event: Optional[Callable[[KvEvent], None]] = None):
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._refcount: Dict[int, int] = {}
        # block_hash -> block_id for completed, reusable blocks.
        self._by_hash: Dict[BlockHash, int] = {}
        self._hash_of: Dict[int, BlockHash] = {}
        # LRU over cached (refcount-0, hashed) blocks.
        self._cached_lru: "OrderedDict[int, None]" = OrderedDict()
        self.on_event = on_event
        # Called (block_id, block_hash) when a cached block is evicted for
        # reuse (content is still intact at call time).
        self.on_evict: Optional[Callable[[int, int], None]] = None
        # Prefix-cache accounting (monotonic).
        self.hit_blocks_total = 0
        self.miss_blocks_total = 0
        self.evicted_blocks_total = 0

    # --- queries ------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free) + len(self._cached_lru)

    @property
    def num_active(self) -> int:
        return sum(1 for c in self._refcount.values() if c > 0)

    @property
    def num_cached(self) -> int:
        return len(self._cached_lru)

    def usage(self) -> float:
        return 1.0 - len(self._free) / max(self.num_blocks, 1)

    # --- prefix matching ----------------------------------------------------
    def match_prefix(self, block_hashes: Sequence[BlockHash]) -> List[int]:
        """Longest prefix of ``block_hashes`` present in cache; acquires a
        reference on each matched block (caller owns them)."""
        matched: List[int] = []
        for h in block_hashes:
            bid = self._by_hash.get(h)
            if bid is None:
                break
            self._acquire(bid)
            matched.append(bid)
        self.hit_blocks_total += len(matched)
        self.miss_blocks_total += len(block_hashes) - len(matched)
        return matched

    def ref_count(self, bid: int) -> int:
        """Live references on a block (0 = cached/free). The scheduler's
        copy-on-write check: a matched block with other holders must not be
        written in place."""
        return self._refcount.get(bid, 0)

    # --- allocation ---------------------------------------------------------
    def allocate(self, n: int) -> List[int]:
        """Take n fresh blocks, evicting LRU cached blocks as needed."""
        out: List[int] = []
        removed_hashes: List[int] = []
        try:
            for _ in range(n):
                if self._free:
                    bid = self._free.pop()
                elif self._cached_lru:
                    bid, _ = self._cached_lru.popitem(last=False)  # LRU evict
                    h = self._hash_of.pop(bid)
                    del self._by_hash[h]
                    removed_hashes.append(h)
                    self.evicted_blocks_total += 1
                    if self.on_evict is not None:
                        self.on_evict(bid, h)
                else:
                    raise OutOfBlocksError(f"need {n} blocks, {len(out)} available")
                self._refcount[bid] = 1
                out.append(bid)
        except OutOfBlocksError:
            for bid in out:
                self.release([bid])
            raise
        finally:
            if removed_hashes and self.on_event:
                self.on_event(KvEvent(kind="removed", block_hashes=removed_hashes))
        return out

    def _acquire(self, bid: int) -> None:
        c = self._refcount.get(bid, 0)
        if c == 0 and bid in self._cached_lru:
            del self._cached_lru[bid]
        self._refcount[bid] = c + 1

    def acquire(self, block_ids: Sequence[int]) -> None:
        for bid in block_ids:
            self._acquire(bid)

    def release(self, block_ids: Sequence[int]) -> None:
        """Drop a reference; refcount-0 blocks become cached (if hashed) or
        free (if not).

        Blocks enter the LRU in REVERSE list order: block tables are chain-
        ordered (prefix head first) and a chained prefix is only matchable
        up to its first missing block, so eviction must consume chains
        tail-first — matches degrade to shorter prefixes instead of zero."""
        for bid in reversed(list(block_ids)):
            c = self._refcount.get(bid, 0) - 1
            if c > 0:
                self._refcount[bid] = c
                continue
            self._refcount.pop(bid, None)
            if bid in self._hash_of:
                self._cached_lru[bid] = None
                self._cached_lru.move_to_end(bid)
            else:
                self._free.append(bid)

    # --- hash registration --------------------------------------------------
    def register_hashes(self, block_ids: Sequence[int], block_hashes: Sequence[BlockHash]) -> None:
        """Publish completed blocks for reuse. Emits a ``stored`` KV event."""
        stored: List[int] = []
        event_parent: Optional[int] = None
        parent: Optional[int] = None  # hash of the previous block in the chain
        for bid, h in zip(block_ids, block_hashes):
            if bid in self._hash_of:
                parent = self._hash_of[bid]
                continue
            existing = self._by_hash.get(h)
            if existing is not None and existing != bid:
                # Duplicate content: keep the existing registration.
                parent = h
                continue
            self._by_hash[h] = bid
            self._hash_of[bid] = h
            if not stored:
                event_parent = parent  # chain linkage for the router index
            stored.append(h)
            parent = h
        if stored and self.on_event:
            self.on_event(KvEvent(kind="stored", block_hashes=stored, parent_hash=event_parent))

    def touch(self, block_ids: Sequence[int]) -> None:
        for bid in block_ids:
            if bid in self._cached_lru:
                self._cached_lru.move_to_end(bid)

    def clear_cached(self) -> int:
        """Drop all refcount-0 cached blocks. Returns count cleared."""
        n = len(self._cached_lru)
        removed = []
        for bid in list(self._cached_lru):
            h = self._hash_of.pop(bid)
            del self._by_hash[h]
            removed.append(h)
            self._free.append(bid)
        self._cached_lru.clear()
        self.evicted_blocks_total += n
        if removed and self.on_event:
            self.on_event(KvEvent(kind="removed", block_hashes=removed))
        return n
