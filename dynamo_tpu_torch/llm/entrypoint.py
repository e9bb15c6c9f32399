"""Entry points: pipeline assembly, worker registration and the frontend.

The counterpart of the JAX package's ``llm/entrypoint.py``:
``build_local_pipeline`` (preprocessor → backend → engine in one process),
``build_routed_pipeline`` (preprocessor → backend → migration → router, the
frontend's side, with an ``availability_probe`` for the HTTP layer),
``register_llm`` (a worker serves its engine on an endpoint and publishes
its model under a key bound to its lease) and ``start_frontend`` (the
OpenAI service over a ``ModelManager`` that discovery fills, with TLS and
a default request deadline). ``encoder=`` / ``encode_client=`` put the
image stage (``llm/multimodal.EncodeOperator``) into either pipeline, and
``FrontendConfig.encode_component`` points the frontend's at an encode
worker pool; ``build_embeddings_pipeline`` serves ``/v1/embeddings``. The
frontend's HTTP service and its routers share one metrics registry (the
``circuit_open{worker}`` gauges and ``migrations_total`` land on the same
``/metrics``), and it judges requests against ``FrontendConfig``'s SLO
targets. Not ported yet: gRPC (ROADMAP Queue 1 item 19).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Any, AsyncIterator, Optional

from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.kv_router import KvPushRouter, KvRouterConfig, kv_metrics_subject
from dynamo_tpu_torch.llm.migration import Migration
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, ModelEntry
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor, PromptFormatter
from dynamo_tpu_torch.llm.tokenizer import Tokenizer, load_tokenizer
from dynamo_tpu_torch.runtime.component import Endpoint
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Annotated, AsyncEngine, Context
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.metrics import FRONTEND_PREFIX, MetricsRegistry
from dynamo_tpu_torch.runtime.pipeline import Operator, link
from dynamo_tpu_torch.runtime.push_router import CircuitBreaker, PushRouter, RetryPolicy, RouterMode, WorkerMonitor
from dynamo_tpu_torch.runtime.telemetry import SloConfig

logger = get_logger(__name__)


class RouterEngine:
    """Adapts a PushRouter (or KvPushRouter) to the AsyncEngine shape."""

    def __init__(self, router):
        self.router = router

    def generate(self, request: Any, context: Context) -> AsyncIterator[Annotated]:
        return self.router.generate(request, context)


def _encode_op(encoder, encode_client):
    if encoder is None and encode_client is None:
        return None
    from dynamo_tpu_torch.llm.multimodal import EncodeOperator

    return EncodeOperator(encoder=encoder, client=encode_client)


def build_local_pipeline(tokenizer: Tokenizer, engine: AsyncEngine, card: Optional[ModelDeploymentCard] = None, *,
                         tool_call_parser: Optional[str] = None,
                         reasoning_parser: Optional[str] = None, encoder=None,
                         encode_client=None) -> AsyncEngine:
    """Aggregated in-process pipeline: OpenAI body → token ids → [image
    features] → engine → detokenized text frames. ``encoder`` (a
    ``LocalVisionEncoder``) or ``encode_client`` (a router to an encode
    worker) enables image prompts. Chat prompts render the card's chat template
    (the default one without a card or template, as in the JAX package,
    whatever the tokenizer's config carries). Guided decoding needs the
    served tokenizer on the engine's side (token-FSM lifting): it is
    attached unless the engine has one. ``tool_call_parser`` /
    ``reasoning_parser`` name the model's output parsers (llm/parsers),
    the card's where not given; ``run`` passes neither."""
    if hasattr(engine, "attach_guided_tokenizer") and getattr(engine.scheduler, "guided", None) is None:
        engine.attach_guided_tokenizer(tokenizer)
    pre = OpenAIPreprocessor(
        tokenizer,
        PromptFormatter(card.chat_template if card else None),
        tool_call_parser=tool_call_parser or (card.tool_call_parser if card else None),
        reasoning_parser=reasoning_parser or (card.reasoning_parser if card else None),
    )
    enc = _encode_op(encoder, encode_client)
    return link([pre] + ([enc] if enc else []) + [Backend(tokenizer)], engine)


def build_routed_pipeline(
    tokenizer: Tokenizer,
    router,
    card: Optional[ModelDeploymentCard] = None,
    *,
    migration_limit: int = 0,
    on_migrate=None,
    encoder=None,
    encode_client=None,
) -> AsyncEngine:
    """Frontend-side routed pipeline: preprocessor → [image features] →
    backend → migration → router. Chat prompts render the card's chat
    template (the default one without), and the card's output parsers are
    armed."""
    pre = OpenAIPreprocessor(
        tokenizer,
        PromptFormatter(card.chat_template if card else None),
        tool_call_parser=card.tool_call_parser if card else None,
        reasoning_parser=card.reasoning_parser if card else None,
    )
    enc = _encode_op(encoder, encode_client)
    ops = [pre] + ([enc] if enc else []) + [Backend(tokenizer)]
    limit = migration_limit if migration_limit else (card.migration_limit if card else 0)
    if limit > 0:
        ops.append(Migration(limit, on_migrate=on_migrate))
    composed = link(ops, RouterEngine(router))
    # Pre-flight availability for the HTTP layer: zero live instances ⇒ an
    # immediate retryable 503 instead of a 500 after the retry budget burns.
    client = getattr(router, "client", None)
    if client is not None:
        composed.availability_probe = lambda: len(client.instances)
    return composed


async def register_llm(
    drt: DistributedRuntime,
    endpoint: Endpoint,
    engine: AsyncEngine,
    card: ModelDeploymentCard,
    *,
    stats_handler=None,
) -> tuple:
    """Worker side: serve the engine on the endpoint and publish the model
    entry so frontends discover it. → (ServeHandle, ModelEntry). The engine
    itself is served (the JAX package serves its bound ``generate``), so the
    worker's control ops reach it: ``set_dial`` finds its capacity dial."""
    handle = await endpoint.serve_endpoint(engine, stats_handler=stats_handler)
    entry = ModelEntry(
        name=card.name,
        namespace=endpoint.namespace,
        component=endpoint.component,
        endpoint=endpoint.name,
        card=card,
    )
    # One key per instance, bound to its lease: N workers serving the same
    # model register N keys, so the frontend's watcher drops the model only
    # when the LAST one goes.
    key = f"{entry.store_key}:{handle.lease.id:x}"
    await drt.store.put(key, entry.to_json(), lease_id=handle.lease.id)
    logger.info("registered model %s at %s", card.name, key)
    return handle, entry


@dataclass
class FrontendConfig:
    """The frontend's knobs, with the JAX package's names, for what is
    ported."""

    host: str = "0.0.0.0"
    port: int = 8000
    router_mode: str = "round-robin"  # round-robin | random | kv
    # KV usage at or above which a worker is skipped (None: never), from
    # the workers' load gossip; in every mode (the JAX frontend sets it on
    # the plain routers only, whose monitor nothing feeds there).
    busy_threshold: Optional[float] = None
    migration_limit: int = 0
    kv_overlap_score_weight: float = 1.0
    kv_temperature: float = 0.0
    # Kept from the JAX package's config: its watcher, as this one, serves
    # the models of every namespace.
    namespace: str = "dynamo"
    # Router failure lifecycle: NoInstances retry budget (jittered
    # exponential backoff) and the per-worker circuit breaker.
    retry_max: int = 3
    retry_backoff_base_s: float = 0.05
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 5.0
    # TLS termination: both PEM paths or neither.
    tls_cert: Optional[str] = None
    tls_key: Optional[str] = None
    # Image prompts go to the encode worker pool at this component (round
    # robin); None refuses them with a 400.
    encode_component: Optional[str] = None
    # Default end-to-end request deadline; a client ``timeout`` (seconds)
    # overrides it per request. None = no deadline.
    request_timeout_ms: Optional[float] = None
    # SLO targets of the frontend's e2e judgments and goodput account
    # (None: the phase is not judged).
    slo_ttft_ms: Optional[float] = None
    slo_tpot_ms: Optional[float] = None


async def start_frontend(drt: DistributedRuntime, config: FrontendConfig) -> HttpService:
    """Start the OpenAI frontend with dynamic model discovery: every model
    registered in the KV store gets a routed pipeline. The service's
    ``watcher`` and ``routers`` (model name → router) stop with it."""
    manager = ModelManager()
    routers = {}
    metrics = MetricsRegistry(prefix=FRONTEND_PREFIX)

    async def engine_factory(entry: ModelEntry) -> AsyncEngine:
        ep = drt.namespace(entry.namespace).component(entry.component).endpoint(entry.endpoint)
        client = await ep.client()
        retry = RetryPolicy(max_retries=config.retry_max, backoff_base_s=config.retry_backoff_base_s)
        if config.router_mode == "kv":
            router = await KvPushRouter.create(
                client,
                KvRouterConfig(
                    overlap_score_weight=config.kv_overlap_score_weight,
                    temperature=config.kv_temperature,
                    block_size=entry.card.kv_cache_block_size,
                    busy_threshold=config.busy_threshold,
                ),
                metrics=metrics,
            )
            router.push.retry = retry
            router.push.breaker = CircuitBreaker(
                threshold=config.breaker_threshold, cooldown_s=config.breaker_cooldown_s,
                on_transition=router.push._on_circuit_transition,
            )
        else:
            mode = RouterMode.RANDOM if config.router_mode == "random" else RouterMode.ROUND_ROBIN
            router = PushRouter(client, mode, monitor=WorkerMonitor(config.busy_threshold), retry=retry,
                                metrics=metrics)
            router.breaker = CircuitBreaker(
                threshold=config.breaker_threshold, cooldown_s=config.breaker_cooldown_s,
                on_transition=router._on_circuit_transition,
            )
            if config.busy_threshold is not None:
                router.follow_load(kv_metrics_subject(entry.namespace, entry.component))
        # A model that left and came back gets a new router; the old one's
        # background tasks stop here.
        old = routers.pop(entry.name, None)
        if old is not None:
            await old.close()
        routers[entry.name] = router
        # A real vocabulary takes seconds to read: off the event loop.
        tokenizer = await asyncio.to_thread(load_tokenizer, entry.card.tokenizer_path)
        encode_client = None
        if config.encode_component:
            enc_ep = drt.namespace(entry.namespace).component(config.encode_component).endpoint(entry.endpoint)
            encode_client = PushRouter(await enc_ep.client(), RouterMode.ROUND_ROBIN)
            encoders[entry.name] = encode_client
        model = entry.card.name
        return build_routed_pipeline(
            tokenizer, router, entry.card, migration_limit=config.migration_limit, encode_client=encode_client,
            on_migrate=lambda: service.note_migration(model))

    encoders = {}
    # Built first: a half-given TLS pair is refused before anything starts.
    service = HttpService(manager, host=config.host, port=config.port, metrics=metrics, tls_cert=config.tls_cert,
                          tls_key=config.tls_key, slo=SloConfig(ttft_ms=config.slo_ttft_ms, tpot_ms=config.slo_tpot_ms),
                          request_timeout_ms=config.request_timeout_ms)
    watcher = ModelWatcher(drt, manager, engine_factory)
    await watcher.start()
    service.watcher = watcher
    service.routers = routers
    service.encoders = encoders
    await service.start()
    return service


async def stop_frontend(service: HttpService) -> None:
    """Stop the service, its discovery watch and its routers' background
    tasks (KV-event subscribers, load-gossip consumers)."""
    await service.watcher.stop()
    await service.stop()
    for router in service.routers.values():
        await router.close()
    for router in service.encoders.values():
        await router.close()
        await router.client.close()


class EmbeddingsPreprocessor(Operator):
    """Tokenizes ``/v1/embeddings`` input (a string, strings, token ids or
    lists of them) into ``batch_token_ids`` for the ``EmbeddingEngine``."""

    def __init__(self, tokenizer: Tokenizer):
        self.tokenizer = tokenizer

    async def transform_request(self, request: dict, context: Context) -> dict:
        inp = request.get("input")
        if isinstance(inp, str):
            batches = [self.tokenizer.encode(inp)]
        elif inp and isinstance(inp[0], int):
            batches = [list(inp)]
        elif inp and isinstance(inp[0], list):
            batches = [list(x) for x in inp]
        else:
            batches = [self.tokenizer.encode(s) for s in (inp or [])]
        return {"batch_token_ids": batches, "model": request.get("model", "")}


def build_embeddings_pipeline(tokenizer: Tokenizer, engine: AsyncEngine) -> AsyncEngine:
    """Embeddings pipeline: tokenize → ``EmbeddingEngine``."""
    return link([EmbeddingsPreprocessor(tokenizer)], engine)
