"""Endpoint client with live instance discovery.

A copy of the JAX package's ``runtime/client.py``: the client watches the
endpoint's instance prefix in the KV store; a dead worker's lease expiry
deletes its key and the watch prunes it within one delivery.
``scrape_stats`` asks every live instance for its stats over request/reply.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

from dynamo_tpu_torch.runtime import msgpack_codec as msgpack
from dynamo_tpu_torch.runtime.component import Endpoint, Instance
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.transports.kvstore import EventType

logger = get_logger(__name__)


class Client:
    """Tracks live instances of one endpoint."""

    def __init__(self, endpoint: Endpoint):
        self.endpoint = endpoint
        self.drt = endpoint.drt
        self.instances: Dict[int, Instance] = {}
        self._static = False
        self._watch = None
        self._watch_task: Optional[asyncio.Task] = None
        self._changed = asyncio.Event()

    async def start(self, static_instances: Optional[List[Instance]] = None) -> None:
        if static_instances is not None:
            self._static = True
            self.instances = {i.instance_id: i for i in static_instances}
            return
        snapshot, self._watch = await self.drt.store.get_and_watch_prefix(self.endpoint.instance_prefix)
        for entry in snapshot:
            inst = Instance.from_json(entry.value)
            self.instances[inst.instance_id] = inst
        self._watch_task = asyncio.get_running_loop().create_task(self._watch_loop())

    async def _watch_loop(self) -> None:
        async for ev in self._watch:
            if ev.type == EventType.PUT and ev.value is not None:
                inst = Instance.from_json(ev.value)
                self.instances[inst.instance_id] = inst
            elif ev.type == EventType.DELETE:
                # key: instances/{ns}/{comp}/{ep}:{lease:x}
                try:
                    lease_hex = ev.key.rsplit(":", 1)[1]
                    self.instances.pop(int(lease_hex, 16), None)
                except (IndexError, ValueError):
                    pass
            self._changed.set()
            self._changed = asyncio.Event()

    def change_event(self) -> asyncio.Event:
        """The event the next change of the instance set sets (taken before
        a check of ``instances``, it also wakes for a change right after)."""
        return self._changed

    def instance_ids(self) -> List[int]:
        return sorted(self.instances)

    async def wait_for_instances(self, min_count: int = 1, timeout: float = 30.0) -> List[Instance]:
        deadline = asyncio.get_running_loop().time() + timeout
        while len(self.instances) < min_count:
            remaining = deadline - asyncio.get_running_loop().time()
            if remaining <= 0:
                raise TimeoutError(
                    f"endpoint {self.endpoint.path}: {len(self.instances)}/{min_count} instances after {timeout}s"
                )
            changed = self._changed
            try:
                await asyncio.wait_for(changed.wait(), min(remaining, 0.5))
            except asyncio.TimeoutError:
                pass
        return [self.instances[i] for i in sorted(self.instances)]

    async def scrape_stats(self, timeout: float = 2.0) -> Dict[int, dict]:
        """Request/reply stats scrape of every live instance."""
        out: Dict[int, dict] = {}

        async def one(inst: Instance):
            try:
                msg = await self.drt.bus.request(inst.stats_subject, b"{}", timeout=timeout)
                out[inst.instance_id] = msgpack.unpackb(msg.data)
            except asyncio.TimeoutError:
                pass

        await asyncio.gather(*(one(i) for i in list(self.instances.values())))
        return out

    async def close(self) -> None:
        if self._watch is not None:
            await self._watch.cancel()
        if self._watch_task is not None:
            self._watch_task.cancel()
            try:
                await self._watch_task
            except asyncio.CancelledError:
                pass
