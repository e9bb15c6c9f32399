"""KV-aware request routing.

A copy of the JAX package's ``llm/kv_router/__init__.py``: ``KvPushRouter``
wraps the push router with KV-aware worker selection: prompt block hashes →
radix-tree overlap per worker → a cost over (prefill need, decode load) →
softmax or argmin choice → a direct-routed push. The durable KV-event
stream feeds the indexer (exact mode; ``num_indexer_shards > 1`` shards it,
``sharded.py``), or, with ``use_kv_events=False``, the router's own
decisions feed a TTL index (approximate mode, ``approx.py``). In exact
mode a second TTL index over in-flight decisions
(``pending_overlap_ttl_s``) counts a prefix as cached on the worker it was
sent to until its events arrive. With ``track_prefill_counters``,
replicated routers gossip their pending prefills (``prefill_counter.py``)
and each folds the others' into its cost. Worker metrics gossip feeds the
busy threshold (which, unlike the JAX router's, gates the KV choice too)
and the cost model; instance death prunes every index. The first response
frame's ``cached_tokens`` closes the loop on the predicted reuse
(``stats()``).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.llm.kv_router.approx import ApproxKvIndexer
from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, NativeRadixTree, OverlapScores, RadixTree
from dynamo_tpu_torch.llm.kv_router.prefill_counter import PrefillCountersMultiWorker
from dynamo_tpu_torch.llm.kv_router.publisher import (
    KvEventPublisher,
    WorkerMetricsPublisher,
    kv_events_stream_name,
    kv_metrics_subject,
)
from dynamo_tpu_torch.llm.kv_router.scheduler import KvScheduler, SchedulingDecision
from dynamo_tpu_torch.llm.kv_router.sequence import ActiveSequencesMultiWorker
from dynamo_tpu_torch.llm.kv_router.sharded import KvIndexerSharded
from dynamo_tpu_torch.llm.kv_router.subscriber import KvRouterSubscriber
from dynamo_tpu_torch.llm.tokens import compute_block_hashes
from dynamo_tpu_torch.runtime.client import Client
from dynamo_tpu_torch.runtime.engine import Annotated, Context
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.push_router import InstanceGone, NoInstancesError, PushRouter, RouterMode, WorkerMonitor

logger = get_logger(__name__)

__all__ = [
    "KvRouterConfig",
    "KvPushRouter",
    "KvIndexer",
    "KvIndexerSharded",
    "PrefillCountersMultiWorker",
    "ApproxKvIndexer",
    "RadixTree",
    "NativeRadixTree",
    "OverlapScores",
    "KvScheduler",
    "ActiveSequencesMultiWorker",
    "KvEventPublisher",
    "WorkerMetricsPublisher",
    "KvRouterSubscriber",
    "kv_events_stream_name",
    "kv_metrics_subject",
]


@dataclass
class KvRouterConfig:
    """The router's knobs, every field of the JAX package's with its default
    (a request may override the weight and the temperature with
    ``router_overrides``), and the port's ``busy_threshold``."""

    overlap_score_weight: float = 1.0
    temperature: float = 0.0
    block_size: int = 16
    use_kv_events: bool = True  # False → ApproxKvIndexer
    approx_ttl_s: float = 120.0
    snapshot_threshold: int = 1_000_000
    reset_states: bool = False
    # >1 ⇒ KvIndexerSharded: parallel event appliers, worker-pinned shards.
    num_indexer_shards: int = 1
    # Gossip pending prefills between replicated routers so they don't
    # stampede one worker.
    track_prefill_counters: bool = False
    # In-flight prefix awareness (exact mode): routed-but-not-yet-registered
    # prompts count as overlap on their chosen worker for this long, so a
    # burst of same-prefix requests CONCENTRATES on one worker instead of
    # spreading its prefix across the fleet (each spread copy prefills cold
    # AND pollutes another worker's cache). The engine registers blocks at
    # prompt completion and the exact index takes over well inside the TTL.
    # 0 disables.
    pending_overlap_ttl_s: float = 10.0
    # KV usage at or above which a worker is skipped unless every live
    # worker is (None: never), from the workers' load gossip.
    busy_threshold: Optional[float] = None


class KvPushRouter:
    """AsyncEngine-shaped KV router."""

    def __init__(self, client: Client, config: KvRouterConfig, *, metrics=None):
        self.client = client
        self.config = config
        # metrics: a runtime.metrics.MetricsRegistry for the push router's
        # circuit_open{worker} gauges.
        self.push = PushRouter(client, RouterMode.DIRECT, monitor=WorkerMonitor(config.busy_threshold),
                               metrics=metrics)
        self.sequences = ActiveSequencesMultiWorker(block_size=config.block_size)
        self.scheduler = KvScheduler(
            self.sequences,
            overlap_score_weight=config.overlap_score_weight,
            temperature=config.temperature,
        )
        if not config.use_kv_events:
            self.indexer = ApproxKvIndexer(block_size=config.block_size, ttl_s=config.approx_ttl_s)
        elif config.num_indexer_shards > 1:
            self.indexer = KvIndexerSharded(block_size=config.block_size, num_shards=config.num_indexer_shards)
        else:
            self.indexer = KvIndexer(block_size=config.block_size)
        # Exact mode: a second, TTL'd radix tree over in-flight routing
        # decisions (approximate mode already feeds decisions into its main
        # index). find_matches merges both, taking the max per worker.
        self.pending_index: Optional[ApproxKvIndexer] = (
            ApproxKvIndexer(block_size=config.block_size, ttl_s=config.pending_overlap_ttl_s)
            if config.use_kv_events and config.pending_overlap_ttl_s > 0
            else None
        )
        self.prefill_counters: Optional[PrefillCountersMultiWorker] = None
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
    async def create(cls, client: Client, config: Optional[KvRouterConfig] = None, *,
                     metrics=None) -> "KvPushRouter":
        config = config or KvRouterConfig()
        router = cls(client, config, metrics=metrics)
        ep = client.endpoint
        if config.use_kv_events:
            router.subscriber = KvRouterSubscriber(
                client.drt,
                router.indexer,
                kv_events_stream_name(ep.namespace, ep.component),
                snapshot_threshold=config.snapshot_threshold,
                reset_states=config.reset_states,
            )
            await router.subscriber.start()
        if config.track_prefill_counters:
            router.prefill_counters = PrefillCountersMultiWorker(client.drt, ep.namespace, ep.component)
            await router.prefill_counters.start()
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
                if self.pending_index is not None:
                    self.pending_index.remove_worker(w)
                if self.prefill_counters is not None:
                    self.prefill_counters.remove_worker(w)
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
        if self.pending_index is not None:
            # Merge in-flight decisions: a prefix mid-prefill on a worker is
            # (about to be) cached there even though no KV event says so yet.
            for w, s in self.pending_index.find_matches(hashes).scores.items():
                overlaps.scores[w] = max(overlaps.scores.get(w, 0), s)
        overrides = router_overrides or {}
        external = (
            {w: self.prefill_counters.pending_tokens(w) for w in workers}
            if self.prefill_counters is not None
            else None
        )
        return self.scheduler.select_worker(
            workers,
            prompt_blocks,
            overlaps,
            overlap_score_weight=overrides.get("overlap_score_weight"),
            temperature=overrides.get("temperature"),
            external_prefill_tokens=external,
            prefill_fractions=self.elastic_fraction_by_worker,
        )

    async def generate(self, request: Any, context: Optional[Context] = None) -> AsyncIterator[Annotated]:
        ctx = context or Context()
        token_ids = list(request.get("token_ids") or [])
        while True:
            try:
                async for item in self._route(request, ctx, token_ids):
                    yield item
                return
            except InstanceGone as e:
                # Nobody took the request (its worker died before calling
                # home): schedule it again over the instances left.
                logger.warning("%s; scheduling request %s again", e, ctx.id)

    async def _route(self, request: Any, ctx: Context, token_ids: list) -> AsyncIterator[Annotated]:
        decision = await self.schedule(token_ids, request.get("router_overrides"))
        rid = ctx.id
        self.sequences.add_request(rid, decision.worker, len(token_ids), decision.overlap_blocks)
        if isinstance(self.indexer, ApproxKvIndexer):
            self.indexer.process_routing_decision(decision.worker, token_ids)
        elif self.pending_index is not None:
            self.pending_index.process_routing_decision(decision.worker, token_ids)
        if self.prefill_counters is not None:
            await self.prefill_counters.new_prefill(rid, decision.worker, len(token_ids))
        logger.debug(
            "kv-routed %s -> %x (overlap=%d blocks, cost=%.1f)", rid, decision.worker, decision.overlap_blocks, decision.cost
        )
        self.predicted_cached_tokens_total += decision.overlap_blocks * self.config.block_size
        first = True
        try:
            async for item in self.push.generate(request, ctx, instance_id=decision.worker):
                if first and (not isinstance(item, Annotated) or not item.is_annotation()):
                    self.sequences.mark_prefill_done(rid)
                    if self.prefill_counters is not None:
                        await self.prefill_counters.complete_prefill(rid, decision.worker)
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
        except NoInstancesError:
            if decision.worker in self.client.instances:
                raise
            # The chosen worker left between the choice and the push.
            raise InstanceGone(f"instance {decision.worker:x} left before the request went out") from None
        finally:
            self.sequences.free(rid)
            if first and self.prefill_counters is not None:
                # Stream ended before the first token (abort/error): retract
                # the pending-prefill gossip too.
                await self.prefill_counters.complete_prefill(rid, decision.worker)

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
        if self.prefill_counters is not None:
            await self.prefill_counters.stop()
        if isinstance(self.indexer, KvIndexerSharded):
            self.indexer.close()
        if self._metrics_task is not None:
            self._metrics_task.cancel()
            try:
                await self._metrics_task
            except asyncio.CancelledError:
                pass
