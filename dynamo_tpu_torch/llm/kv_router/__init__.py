"""KV-aware request routing.

A copy of the JAX package's ``llm/kv_router/__init__.py``: ``KvPushRouter``
wraps the push router with KV-aware worker selection: prompt block hashes →
radix-tree overlap per worker → a cost over (prefill need, decode load) →
softmax or argmin choice → a direct-routed push. The durable KV-event
stream feeds the indexer; a second TTL index over in-flight decisions
(``PENDING_OVERLAP_TTL_S``, 10 s) counts a prefix as cached on the worker
it was sent to until its events arrive. Worker metrics gossip feeds the
busy threshold (which, unlike the JAX router's, gates the KV choice too)
and the cost model; instance death prunes both indexes. The first response
frame's ``cached_tokens`` closes the loop on the predicted reuse
(``stats()``). Only the JAX package's default configuration is ported: its
approximate main index (no KV events), snapshot and reset knobs, sharded
indexer and prefill counters (``sharded.py``, ``prefill_counter.py``) wait
for ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.llm.kv_router.approx import ApproxKvIndexer
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, OverlapScores, RadixTree
from dynamo_tpu_torch.llm.kv_router.publisher import (
    KvEventPublisher,
    WorkerMetricsPublisher,
    kv_events_stream_name,
    kv_metrics_subject,
)
from dynamo_tpu_torch.llm.kv_router.scheduler import KvScheduler, SchedulingDecision
from dynamo_tpu_torch.llm.kv_router.sequence import ActiveSequencesMultiWorker
from dynamo_tpu_torch.llm.kv_router.subscriber import KvRouterSubscriber
from dynamo_tpu_torch.llm.tokens import compute_block_hashes
from dynamo_tpu_torch.runtime.client import Client
from dynamo_tpu_torch.runtime.engine import Annotated, Context
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.push_router import PushRouter, RouterMode, WorkerMonitor

logger = get_logger(__name__)

__all__ = [
    "KvRouterConfig",
    "KvPushRouter",
    "KvIndexer",
    "ApproxKvIndexer",
    "RadixTree",
    "OverlapScores",
    "KvScheduler",
    "ActiveSequencesMultiWorker",
    "KvEventPublisher",
    "WorkerMetricsPublisher",
    "KvRouterSubscriber",
    "kv_events_stream_name",
    "kv_metrics_subject",
]


# In-flight prefix awareness: routed-but-not-yet-registered prompts count
# as overlap on their chosen worker for this long, so a burst of same-prefix
# requests CONCENTRATES on one worker instead of spreading its prefix across
# the fleet (each spread copy prefills cold AND pollutes another worker's
# cache). The engine registers blocks at prompt completion and the exact
# index takes over well inside the TTL. The JAX package's default.
PENDING_OVERLAP_TTL_S = 10.0


@dataclass
class KvRouterConfig:
    """The router's knobs (a request may override the weight and the
    temperature with ``router_overrides``). The JAX config's other fields
    keep their defaults here as constants: exact KV events with the pending
    index above, the subscriber's snapshot threshold, no state reset, one
    indexer shard and no prefill counters (ROADMAP Queue 1 item 7)."""

    overlap_score_weight: float = 1.0
    temperature: float = 0.0
    block_size: int = 16
    # KV usage at or above which a worker is skipped unless every live
    # worker is (None: never), from the workers' load gossip.
    busy_threshold: Optional[float] = None


class KvPushRouter:
    """AsyncEngine-shaped KV router."""

    def __init__(self, client: Client, config: KvRouterConfig):
        self.client = client
        self.config = config
        self.push = PushRouter(client, RouterMode.DIRECT, monitor=WorkerMonitor(config.busy_threshold))
        self.sequences = ActiveSequencesMultiWorker(block_size=config.block_size)
        self.scheduler = KvScheduler(
            self.sequences,
            overlap_score_weight=config.overlap_score_weight,
            temperature=config.temperature,
        )
        self.indexer = KvIndexer(block_size=config.block_size)
        # A second, TTL'd radix tree over in-flight routing decisions;
        # find_matches merges both, taking the max per worker.
        self.pending_index = ApproxKvIndexer(block_size=config.block_size, ttl_s=PENDING_OVERLAP_TTL_S)
        self.subscriber: Optional[KvRouterSubscriber] = None
        self._metrics_task: Optional[asyncio.Task] = None
        # Reuse accounting: predicted overlap (scheduling time) vs the
        # engine's ACTUAL cached_tokens report (first response frame). A
        # persistent gap means the index is stale or the engine is evicting
        # under pressure — the router is steering to cold workers either way.
        self.predicted_cached_tokens_total = 0
        self.cached_tokens_total = 0
        self.cached_tokens_by_worker: dict = {}
        # Elastic capacity dial (gossiped ForwardPassMetrics): per-worker
        # prefill fraction feeds the cost model so routing follows the
        # fleet's live prefill:decode shape, not just its KV state.
        self.elastic_fraction_by_worker: dict = {}

    @classmethod
    async def create(cls, client: Client, config: Optional[KvRouterConfig] = None) -> "KvPushRouter":
        config = config or KvRouterConfig()
        router = cls(client, config)
        ep = client.endpoint
        router.subscriber = KvRouterSubscriber(client.drt, router.indexer, kv_events_stream_name(ep.namespace, ep.component))
        await router.subscriber.start()
        router._metrics_task = asyncio.get_running_loop().create_task(
            router.push.monitor.follow(client.drt.bus, kv_metrics_subject(ep.namespace, ep.component), router._on_metrics))
        return router

    def _on_metrics(self, wid: int, m: dict) -> None:
        """Worker load gossip → the capacity-dial fractions of the cost
        model (the push router's monitor takes the KV usage)."""
        self.elastic_fraction_by_worker[wid] = float(m.get("elastic_prefill_fraction", 0.5) or 0.5)

    def _sync_workers(self) -> list:
        """Reconcile tracked state with the live instance set."""
        live = self.client.instance_ids()
        live_set = set(live)
        for w in list(self.sequences._prefill_tokens):
            if w not in live_set:
                self.sequences.remove_worker(w)
                self.indexer.remove_worker(w)
                self.pending_index.remove_worker(w)
                self.elastic_fraction_by_worker.pop(w, None)
        for w in live:
            self.sequences.ensure_worker(w)
        return live

    async def schedule(self, token_ids, router_overrides: Optional[dict] = None) -> SchedulingDecision:
        workers = self._sync_workers()
        # Circuit breaker and busy threshold (push router): skip workers
        # with an OPEN circuit or KV usage at the threshold, as the push
        # router's candidates do — all busy degrades to the unblocked set,
        # all blocked to every worker (availability beats purity).
        blocked = self.push.breaker.blocked_instances()
        busy = self.push.monitor.busy_instances()
        if blocked or busy:
            free = [w for w in workers if w not in blocked and w not in busy]
            workers = free or [w for w in workers if w not in blocked] or workers
        hashes = compute_block_hashes(token_ids, self.config.block_size)
        prompt_blocks = max(1, (len(token_ids) + self.config.block_size - 1) // self.config.block_size)
        overlaps = self.indexer.find_matches(hashes)
        # Merge in-flight decisions: a prefix mid-prefill on a worker is
        # (about to be) cached there even though no KV event says so yet.
        for w, s in self.pending_index.find_matches(hashes).scores.items():
            overlaps.scores[w] = max(overlaps.scores.get(w, 0), s)
        overrides = router_overrides or {}
        return self.scheduler.select_worker(
            workers,
            prompt_blocks,
            overlaps,
            overlap_score_weight=overrides.get("overlap_score_weight"),
            temperature=overrides.get("temperature"),
            prefill_fractions=self.elastic_fraction_by_worker,
        )

    async def generate(self, request: Any, context: Optional[Context] = None) -> AsyncIterator[Annotated]:
        ctx = context or Context()
        token_ids = list(request.get("token_ids") or [])
        decision = await self.schedule(token_ids, request.get("router_overrides"))
        rid = ctx.id
        self.sequences.add_request(rid, decision.worker, len(token_ids), decision.overlap_blocks)
        self.pending_index.process_routing_decision(decision.worker, token_ids)
        logger.debug(
            "kv-routed %s -> %x (overlap=%d blocks, cost=%.1f)", rid, decision.worker, decision.overlap_blocks, decision.cost
        )
        self.predicted_cached_tokens_total += decision.overlap_blocks * self.config.block_size
        first = True
        try:
            async for item in self.push.generate(request, ctx, instance_id=decision.worker):
                if first and (not isinstance(item, Annotated) or not item.is_annotation()):
                    self.sequences.mark_prefill_done(rid)
                    first = False
                    # Engine-reported reuse (first frame): close the loop on
                    # the predicted overlap so the router's accounting
                    # reflects blocks actually skipped, not hoped for.
                    data = item.data if isinstance(item, Annotated) else item
                    if isinstance(data, dict) and data.get("cached_tokens") is not None:
                        n = int(data["cached_tokens"])
                        self.cached_tokens_total += n
                        self.cached_tokens_by_worker[decision.worker] = (
                            self.cached_tokens_by_worker.get(decision.worker, 0) + n
                        )
                yield item
        finally:
            self.sequences.free(rid)

    def stats(self) -> dict:
        """Router-side reuse accounting: predicted (index overlap at
        scheduling time) vs actual (engine-reported cached_tokens)."""
        return {
            "predicted_cached_tokens_total": self.predicted_cached_tokens_total,
            "cached_tokens_total": self.cached_tokens_total,
            "cached_tokens_by_worker": dict(self.cached_tokens_by_worker),
        }

    async def close(self) -> None:
        if self.subscriber is not None:
            await self.subscriber.stop()
        if self._metrics_task is not None:
            self._metrics_task.cancel()
            try:
                await self._metrics_task
            except asyncio.CancelledError:
                pass
