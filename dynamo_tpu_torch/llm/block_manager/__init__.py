"""KVBM: multi-tier KV block management (HBM → host → disk → object store).

The counterpart of the JAX package's ``llm/block_manager``:
- **G1**, the card: the engine's paged ``KvCacheArrays`` and its
  ``BlockAllocator``;
- **G2**, host memory (``HostPool``): filled by the offload cascade when G1
  evicts a cached block. The eviction hook snapshots the block on the card,
  queued before the block's next write; the queue drains to the host in one
  batched copy into pinned memory (``flush_pending``);
- **G3**, local disk (``DiskPool``): one ``.npz`` a block, spilled from G2;
- **G4**, the control plane's object store (``RemotePool``): spilled from
  G3 (or G2), onboardable by any worker that shares the store.

A lookup walks the tiers: a G1 hit is free; a G2/G3/G4 hit is *onboarded*,
copied back into fresh G1 blocks with one stacked host → device upload and
one in-place scatter, queued ahead of the prefill of the prompt's rest.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dynamo_tpu_torch.engine.kv_cache import BlockAllocator, KvCacheArrays, QuantKv
from dynamo_tpu_torch.llm.block_manager.storage import DiskPool, HostPool
from dynamo_tpu_torch.llm.block_manager.transfer import gather_blocks_async, scatter_blocks_device
from dynamo_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)


class CacheLevel(enum.Enum):
    G1 = "device"
    G2 = "host"
    G3 = "disk"
    G4 = "remote"


@dataclass
class KvbmMetrics:
    offloads_g2: int = 0
    offloads_g3: int = 0
    offloads_g4: int = 0
    onboards_g2: int = 0
    onboards_g3: int = 0
    onboards_g4: int = 0
    matched_tokens_g1: int = 0
    matched_tokens_tiered: int = 0


@dataclass
class TieredMatch:
    """A tiered prefix lookup: G1 blocks (references acquired) and the
    deeper tiers' hits as onboard candidates ``(hash, tier)``."""

    g1_blocks: List[int] = field(default_factory=list)
    onboardable: List[Tuple[int, CacheLevel]] = field(default_factory=list)

    @property
    def total_blocks(self) -> int:
        return len(self.g1_blocks) + len(self.onboardable)


class KvBlockManager:
    """The tier hierarchy around a device cache and its allocator."""

    def __init__(
        self,
        cache: KvCacheArrays,
        allocator: BlockAllocator,
        *,
        host_blocks: int = 0,
        disk_dir: Optional[str] = None,
        disk_blocks: int = 0,
    ):
        self.cache = cache
        self.allocator = allocator
        self.host = HostPool(capacity=host_blocks) if host_blocks > 0 else None
        self.disk = DiskPool(disk_dir, capacity=disk_blocks) if disk_dir and disk_blocks > 0 else None
        self.remote = None  # G4: attach_remote()
        self.metrics = KvbmMetrics()
        # Offload snapshots queued on the card, drained to the host in one
        # batched copy (flush_pending), so an eviction never waits for one.
        self._pending: Dict[int, Tuple] = {}
        self._pending_cap = 32
        allocator.on_evict = self._offload_block

    def attach_remote(self, remote) -> None:
        """Enable the G4 tier (``storage.RemotePool``): the offload cascade's
        deepest spill, onboardable by any worker sharing the object store."""
        self.remote = remote

    # --- offload cascade (G1 → G2 → G3 → G4) --------------------------------
    def _offload_block(self, block_id: int, block_hash: int) -> None:
        """The allocator's eviction hook, on the admission path: queue a
        device snapshot of the block and return."""
        if self.host is None:
            return
        if (
            block_hash in self._pending
            or self.host.has(block_hash)
            or (self.disk is not None and self.disk.has(block_hash))
        ):
            return
        self._pending[block_hash] = gather_blocks_async(self.cache, block_id)
        if len(self._pending) >= self._pending_cap:
            self.flush_pending()

    def flush_pending(self) -> int:
        """Drain the queued snapshots to the host tier in ONE device → host
        copy (into pinned memory on a card). Called when the queue fills,
        before a tier lookup (queued blocks must be onboardable) and at
        shutdown. Returns the blocks drained."""
        if not self._pending:
            return 0
        items, self._pending = list(self._pending.items()), {}
        has_v = items[0][1][1] is not None
        host = self._to_host([t for _, pair in items for t in (pair if has_v else pair[:1])])
        per = 2 if has_v else 1
        for i, (h, _) in enumerate(items):
            # Each block its own host memory: a pool entry must not pin the
            # whole batch's buffer.
            k = host[per * i].clone()
            v = host[per * i + 1].clone() if has_v else torch.zeros((0,), dtype=k.dtype)
            self._cascade_put(h, k, v)
        return len(items)

    @staticmethod
    def _to_host(rows: List[torch.Tensor]) -> torch.Tensor:
        """``torch.stack(rows)`` in host memory: one stack on the device, one
        copy into pinned memory on a card, waited for."""
        stacked = torch.stack(rows)
        dev = stacked.device
        host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=dev.type == "cuda")
        host.copy_(stacked, non_blocking=True)
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return host

    def _cascade_put(self, block_hash: int, k: torch.Tensor, v: torch.Tensor) -> None:
        spilled = self.host.put(block_hash, k, v)
        self.metrics.offloads_g2 += 1
        if spilled is not None and self.disk is not None:
            sh, sk, sv = spilled
            if not self.disk.has(sh):
                spilled = self.disk.put(sh, sk, sv)
                self.metrics.offloads_g3 += 1
            else:
                spilled = None
        if spilled is not None and self.remote is not None:
            sh, sk, sv = spilled
            if not self.remote.has(sh):
                self.remote.put(sh, sk, sv)
                self.metrics.offloads_g4 += 1

    # --- tiered lookup ------------------------------------------------------
    def match_prefix(self, block_hashes: Sequence[int]) -> TieredMatch:
        """Longest-prefix match across the tiers. G1 blocks come back with
        references acquired, deeper hits as onboard candidates. The chain
        stays contiguous: a miss in every tier ends the walk."""
        self.flush_pending()
        match = TieredMatch()
        g1 = self.allocator.match_prefix(block_hashes)
        match.g1_blocks = g1
        self.metrics.matched_tokens_g1 += len(g1)
        for h in block_hashes[len(g1):]:
            if self.host is not None and self.host.has(h):
                match.onboardable.append((h, CacheLevel.G2))
            elif self.disk is not None and self.disk.has(h):
                match.onboardable.append((h, CacheLevel.G3))
            elif self.remote is not None and self.remote.has(h):
                match.onboardable.append((h, CacheLevel.G4))
            else:
                break
        self.metrics.matched_tokens_tiered += len(match.onboardable)
        return match

    # --- onboarding ---------------------------------------------------------
    def onboard(self, match: TieredMatch, block_hashes: Sequence[int]) -> List[int]:
        """Copy the onboardable blocks into fresh G1 blocks; returns every
        device block the match now holds (G1's, then the onboarded). When
        the allocation fails the match falls back to its G1 prefix (the
        caller prefills the rest).

        The blocks are read from their tiers before the G1 blocks are
        allocated: the allocation may evict, and the evictions' drain may
        spill G2, which must not push out a block this onboard is about to
        take (the JAX package allocates first, and loses such a hit: the
        chain then stops there). The write does not sync the host: every
        block rides ONE stacked host → device upload (from pinned memory
        on a card) and one in-place scatter, queued on the current stream
        ahead of whatever the caller enqueues next (the prefill of the
        prompt's rest)."""
        if not match.onboardable:
            return match.g1_blocks
        entries = []
        for h, tier in match.onboardable:
            pool = self.host if tier == CacheLevel.G2 else self.disk if tier == CacheLevel.G3 else self.remote
            entry = pool.get(h)
            if entry is None:  # it left its pool meanwhile: stop here
                break
            entries.append(entry)
        match.onboardable = match.onboardable[:len(entries)]
        if not entries:
            return match.g1_blocks
        try:
            new_blocks = self.allocator.allocate(len(entries))
        except Exception:
            match.onboardable = []
            return match.g1_blocks
        for _, tier in match.onboardable:
            if tier == CacheLevel.G2:
                self.metrics.onboards_g2 += 1
            elif tier == CacheLevel.G3:
                self.metrics.onboards_g3 += 1
            else:
                self.metrics.onboards_g4 += 1
        self._upload(entries, new_blocks)
        # Onboarded blocks go live under their hashes: the next request hits
        # them in G1.
        n_g1 = len(match.g1_blocks)
        self.allocator.register_hashes(new_blocks, list(block_hashes[n_g1:n_g1 + len(new_blocks)]))
        return match.g1_blocks + new_blocks

    def _upload(self, entries: List[Tuple[torch.Tensor, torch.Tensor]], block_ids: List[int]) -> None:
        """Host blocks → the cache's ``block_ids``: one upload of
        ``[2 (k, v) or 1, n, L, BS, KVH, HD]``, staged in pinned memory on a
        card, and one in-place scatter of ``[L, n, ...]`` views of it."""
        dev = (self.cache.k.q if isinstance(self.cache.k, QuantKv) else self.cache.k).device
        has_v = entries[0][1].numel() > 0
        k0 = entries[0][0]
        staged = torch.empty((2 if has_v else 1, len(entries), *k0.shape), dtype=k0.dtype,
                             pin_memory=dev.type == "cuda")
        for i, (k, v) in enumerate(entries):
            staged[0, i].copy_(k)
            if has_v:
                staged[1, i].copy_(v)
        up = staged.to(dev, non_blocking=True).transpose(1, 2)
        scatter_blocks_device(self.cache, block_ids, up[0], up[1] if has_v else None)

    # --- introspection ------------------------------------------------------
    def usage(self) -> Dict[str, float]:
        out = {"g1": self.allocator.usage()}
        if self.host is not None:
            out["g2"] = self.host.usage()
        if self.disk is not None:
            out["g3"] = self.disk.usage()
        if self.remote is not None:
            out["g4_known_blocks"] = float(len(self.remote))
        return out

    def reset_tier(self, level: CacheLevel) -> int:
        """Empty one tier; returns the blocks it dropped."""
        if level == CacheLevel.G1:
            return self.allocator.clear_cached()
        if level == CacheLevel.G2 and self.host is not None:
            self._pending.clear()
            return self.host.clear()
        if level == CacheLevel.G3 and self.disk is not None:
            return self.disk.clear()
        return 0
