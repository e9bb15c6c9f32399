"""Router-side background: consume KV events into the indexer; snapshot
and purge for bounded replay.

A copy of the JAX package's ``llm/kv_router/subscriber.py``: on start,
restore the radix snapshot from the object store (``radix-bucket``), or,
with ``reset_states``, delete it and purge the stream instead; then
consume the durable stream; past ``snapshot_threshold`` events, upload a
fresh snapshot under the store lock (``locks/router-snapshot``) and purge
the stream so replicas resync cheaply.
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional

from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.transports.kvstore import KeyExists

logger = get_logger(__name__)

RADIX_STATE_BUCKET = "radix-bucket"
ROUTER_SNAPSHOT_LOCK = "locks/router-snapshot"


class KvRouterSubscriber:
    def __init__(
        self,
        drt,
        indexer: KvIndexer,
        stream_name: str,
        *,
        snapshot_threshold: int = 1_000_000,
        reset_states: bool = False,
    ):
        self.drt = drt
        self.indexer = indexer
        self.stream_name = stream_name
        self.snapshot_threshold = snapshot_threshold
        self.reset_states = reset_states
        self._task: Optional[asyncio.Task] = None
        self._events_since_snapshot = 0
        self._consumed_seq = 0

    async def start(self) -> None:
        bucket = await self.drt.bus.object_store(RADIX_STATE_BUCKET)
        if self.reset_states:
            await bucket.delete(self.stream_name)
            stream = await self.drt.bus.stream(self.stream_name)
            await stream.purge()
        else:
            snap = await bucket.get(self.stream_name)
            if snap is not None:
                try:
                    self.indexer.load_snapshot(snap)
                    logger.info("restored radix snapshot: %d nodes", self.indexer.size())
                except Exception:
                    logger.exception("radix snapshot restore failed; starting empty")
        self._task = asyncio.get_running_loop().create_task(self._consume())

    async def _consume(self) -> None:
        stream = await self.drt.bus.stream(self.stream_name)
        try:
            async for msg in stream.consume(from_seq=1):
                try:
                    event = json.loads(msg.data)
                    self.indexer.apply_event(int(event["worker_id"]), event)
                except (ValueError, KeyError):
                    logger.warning("malformed kv event on %s", self.stream_name)
                self._consumed_seq = msg.seq
                self._events_since_snapshot += 1
                if self._events_since_snapshot >= self.snapshot_threshold:
                    await self._snapshot(stream)
        except asyncio.CancelledError:
            pass

    async def _snapshot(self, stream) -> None:
        """Upload snapshot + purge, single-writer via a store lock."""
        self._events_since_snapshot = 0
        try:
            await self.drt.store.put(ROUTER_SNAPSHOT_LOCK, b"1", create_only=True)
        except KeyExists:
            return  # another replica is snapshotting
        try:
            # Quiesce the sharded indexer's appliers so the snapshot holds
            # everything up to _consumed_seq before the stream is purged.
            self.indexer.flush()
            bucket = await self.drt.bus.object_store(RADIX_STATE_BUCKET)
            await bucket.put(self.stream_name, self.indexer.dump())
            await stream.purge(up_to_seq=self._consumed_seq)
            logger.info("radix snapshot uploaded (%d nodes), stream purged to %d",
                        self.indexer.size(), self._consumed_seq)
        finally:
            await self.drt.store.delete(ROUTER_SNAPSHOT_LOCK)

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
