"""Worker-side publishers: KV cache events and load metrics.

A copy of the JAX package's ``llm/kv_router/publisher.py``, with the same
subjects and JSON payloads:
- stream  ``kv_events.{ns}.{component}``  — durable, replayable, snapshotted;
- subject ``kv_metrics.{ns}.{component}`` — fire-and-forget load gossip.
The engine raises KV events on its step thread: ``publish_threadsafe``
hops them to the event loop in order.
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional

from dynamo_tpu_torch.engine.kv_cache import KvEvent
from dynamo_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)


def kv_events_stream_name(namespace: str, component: str) -> str:
    return f"kv_events.{namespace}.{component}"


def kv_metrics_subject(namespace: str, component: str) -> str:
    return f"kv_metrics.{namespace}.{component}"


class KvEventPublisher:
    """Forwards engine KV events onto the durable stream, stamped with the
    worker id (lease id). Events are queued synchronously (the engine step
    loop must not await) and drained by a background task."""

    def __init__(self, drt, namespace: str, component: str, worker_id: int):
        self.drt = drt
        self.stream_name = kv_events_stream_name(namespace, component)
        self.worker_id = worker_id
        self._queue: "asyncio.Queue[Optional[dict]]" = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._drain())

    def publish(self, event: KvEvent) -> None:
        """Synchronous enqueue — safe to call from the scheduler thread via
        loop.call_soon_threadsafe."""
        self._queue.put_nowait({"worker_id": self.worker_id, **event.to_wire()})

    def publish_threadsafe(self, loop: asyncio.AbstractEventLoop, event: KvEvent) -> None:
        loop.call_soon_threadsafe(self.publish, event)

    async def _drain(self) -> None:
        stream = await self.drt.bus.stream(self.stream_name)
        while True:
            item = await self._queue.get()
            if item is None:
                return
            try:
                await stream.publish(self.stream_name, json.dumps(item).encode())
            except Exception:
                logger.exception("kv event publish failed")

    async def stop(self) -> None:
        if self._task is not None:
            self._queue.put_nowait(None)
            await self._task
            self._task = None


class WorkerMetricsPublisher:
    """Periodically publishes ForwardPassMetrics for the router's load input
    and busy-threshold gating."""

    def __init__(self, drt, namespace: str, component: str, worker_id: int, metrics_fn, interval_s: float = 1.0):
        self.drt = drt
        self.subject = kv_metrics_subject(namespace, component)
        self.worker_id = worker_id
        self.metrics_fn = metrics_fn
        self.interval_s = interval_s
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def _loop(self) -> None:
        try:
            while True:
                try:
                    m = self.metrics_fn()
                    payload = {"worker_id": self.worker_id, **(m.to_wire() if hasattr(m, "to_wire") else dict(m))}
                    await self.drt.bus.publish(self.subject, json.dumps(payload).encode())
                except Exception:
                    logger.exception("metrics publish failed")
                await asyncio.sleep(self.interval_s)
        except asyncio.CancelledError:
            pass

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
