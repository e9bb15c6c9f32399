"""Inter-router pending-prefill accounting.

A copy of the JAX package's ``llm/kv_router/prefill_counter.py``. With
replicated routers, each router only sees its *own* in-flight prefills, so
two routers can stampede the same worker. They gossip prefill events on a
shared subject of the port's control plane: every router publishes ``NewPrefill(request_id,
worker_id, tokens)`` when it routes and ``CompletePrefill(request_id)`` when
the first token arrives; every router applies *other* routers' events
(skipping its own by ``router_id``) into per-worker counters. The scheduler
then folds the global pending-prefill token sum per worker into its cost.

Wire shape (JSON on ``prefill_events.{ns}.{component}``):
``{"router_id": ..., "request_id": ..., "worker_id": ..., "kind":
"new"|"complete", "tokens": N}``
"""

from __future__ import annotations

import asyncio
import json
import uuid
from typing import Dict, Optional

from dynamo_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)

WorkerId = int


def prefill_events_subject(namespace: str, component: str) -> str:
    return f"prefill_events.{namespace}.{component}"


class PrefillCounter:
    """Pending prefill tokens for one worker, keyed by request id (a map
    and its running sum)."""

    def __init__(self):
        self._tokens: Dict[str, int] = {}
        self._sum = 0

    def insert(self, request_id: str, tokens: int) -> None:
        old = self._tokens.get(request_id)
        if old is not None:
            self._sum -= old
        self._tokens[request_id] = tokens
        self._sum += tokens

    def remove(self, request_id: str) -> Optional[int]:
        tokens = self._tokens.pop(request_id, None)
        if tokens is not None:
            self._sum -= tokens
        return tokens

    @property
    def running_sum(self) -> int:
        return self._sum

    def __len__(self) -> int:
        return len(self._tokens)


class PrefillCountersMultiWorker:
    """All workers' counters and the cross-router gossip loop."""

    def __init__(self, drt, namespace: str, component: str):
        self.drt = drt
        self.subject = prefill_events_subject(namespace, component)
        self.router_id = uuid.uuid4().hex
        self.counters: Dict[WorkerId, PrefillCounter] = {}
        self._request_worker: Dict[str, WorkerId] = {}
        self._task: Optional[asyncio.Task] = None
        self._sub = None

    # --- local publish ------------------------------------------------------
    # Own routing decisions are NOT applied to the local counters: the local
    # ActiveSequencesMultiWorker already carries them in the scheduler cost,
    # so the counters hold only *other* routers' pending prefills and the two
    # terms add without double counting.
    async def new_prefill(self, request_id: str, worker: WorkerId, tokens: int) -> None:
        await self._publish({"kind": "new", "request_id": request_id, "worker_id": worker, "tokens": tokens})

    async def complete_prefill(self, request_id: str, worker: Optional[WorkerId] = None) -> None:
        await self._publish({"kind": "complete", "request_id": request_id, "worker_id": worker})

    async def _publish(self, body: dict) -> None:
        body["router_id"] = self.router_id
        try:
            await self.drt.bus.publish(self.subject, json.dumps(body).encode())
        except (ConnectionError, OSError) as e:
            logger.warning("prefill event publish failed: %s", e)

    def _apply_new(self, request_id: str, worker: WorkerId, tokens: int) -> None:
        existing = self._request_worker.get(request_id)
        if existing is not None and existing != worker:
            logger.warning("request %s already tracked on worker %x", request_id, existing)
        self._request_worker[request_id] = worker
        self.counters.setdefault(worker, PrefillCounter()).insert(request_id, tokens)

    def _apply_complete(self, request_id: str, worker_hint: Optional[WorkerId] = None) -> None:
        worker = self._request_worker.pop(request_id, None)
        if worker is None:
            worker = worker_hint  # "complete" seen without its "new" (e.g. joined late)
        if worker is None:
            return
        counter = self.counters.get(worker)
        if counter is not None:
            counter.remove(request_id)

    # --- queries ------------------------------------------------------------
    def pending_tokens(self, worker: WorkerId) -> int:
        c = self.counters.get(worker)
        return c.running_sum if c is not None else 0

    def remove_worker(self, worker: WorkerId) -> None:
        self.counters.pop(worker, None)
        self._request_worker = {r: w for r, w in self._request_worker.items() if w != worker}

    # --- gossip loop --------------------------------------------------------
    async def start(self) -> None:
        self._sub = await self.drt.bus.subscribe(self.subject)
        self._task = asyncio.get_running_loop().create_task(self._consume())

    async def _consume(self) -> None:
        try:
            async for msg in self._sub:
                try:
                    ev = json.loads(msg.data)
                except ValueError:
                    continue
                if ev.get("router_id") == self.router_id:
                    continue  # own events already applied locally
                if ev.get("kind") == "new":
                    self._apply_new(ev["request_id"], int(ev["worker_id"]), int(ev.get("tokens", 0)))
                elif ev.get("kind") == "complete":
                    hint = ev.get("worker_id")
                    self._apply_complete(ev["request_id"], None if hint is None else int(hint))
        except asyncio.CancelledError:
            pass

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        if self._sub is not None:
            await self._sub.unsubscribe()
            self._sub = None
