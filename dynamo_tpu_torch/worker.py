"""Worker CLI: serve a ``TorchEngine`` as a discoverable endpoint.

    python -m dynamo_tpu_torch.worker --model llama-3.2-1b --checkpoint DIR --tokenizer DIR

The counterpart of ``python -m dynamo_tpu.worker``, with the JAX CLI's
flag names for what is ported. ``--role`` is ``aggregated`` (the default),
``prefill`` or ``decode`` (disaggregated serving, ``llm/disagg.py``): a
prefill worker serves ``{namespace}/prefill/{endpoint}`` for the decode
workers and exports its requests' KV (``--kv-transfer`` is the decode
worker's choice: ``device``, through CUDA IPC, or ``host``, over TCP); it
does not register the model. A decode worker registers it, prefills
prompts longer than ``--max-local-prefill-length`` on the prefill pool and
decodes from the pulled KV; both refuse an MLA model (``check_role``).
An ``encode`` worker serves the ViT of ``--vision-model`` (``tiny-vit``
by default, or ``vit-l-14``) on seeded random weights (``--vision-seed``)
on ``{namespace}/encode/{endpoint}`` for the frontends'
``--encode-component``: image URLs in, features out
(``llm/multimodal.EncodeWorkerHandler``); it registers no model and
builds no LM engine, and its stats scrape answers ``request_total``.
The component defaults to ``backend`` for an
aggregated worker, else to the role. ``--kvbm-host-blocks`` (with
``--kvbm-disk-dir`` / ``--kvbm-disk-blocks`` and ``--kvbm-remote``) gives
the engine KVBM tiers (``llm/block_manager``). The worker builds
the engine on the card (``--device cuda``, the default, raises without
CUDA), serves it on ``{namespace}/{component}/{endpoint}`` (``dynamo/
backend/generate``), registers the model for the frontends' discovery,
publishes its KV events (hopped from the engine's step thread to the event
loop) and its load metrics, answers stats scrapes with
``TorchEngine.stats_handler``, and on SIGINT or SIGTERM deregisters,
drains and exits. It reaches the control plane named by
``DYN_CONTROL_PLANE`` / ``DYN_CONTROL_PLANE_ADDRESS``. The weights come
from ``--checkpoint`` (a safetensors directory or a GGUF file; the draft's
from ``--draft-checkpoint``), else seeded random at the preset's widths
(``--seed``). ``--tokenizer`` goes on the model card, so the frontends
tokenize with it, and guided decoding lifts grammars against it; without
it both use the byte-level tokenizer.

Observability, as the JAX worker wires it: ``--trace-file`` /
``--trace-sample`` / ``--trace-ring`` / ``--trace-tail`` (or
``DYN_TRACE_FILE`` / ``DYN_TRACE_SAMPLE`` / ``DYN_TRACE_RING`` /
``DYN_TRACE_TAIL``) configure the process tracer, service
``worker-{role}``; given none of them, it keeps its ring of the last 256
records (the incident bundles' trace evidence) and exports nothing. The
tracer is flushed at drain and at shutdown. ``--slo-ttft-ms`` / ``--slo-tpot-ms``
set the engine's SLO judge, ``--stall-after-s`` its stall watchdog.
``--health-port`` (0 picks a free port), or ``DYN_SYSTEM_ENABLED`` with
``DYN_SYSTEM_PORT`` / ``DYN_SYSTEM_HOST``, serves
``runtime/health.SystemStatusServer`` from before the worker registers (it
logs ``health server on host:port``): ``/health`` (``DYN_SYSTEM_STARTING_
HEALTH_STATUS`` until the endpoint is served, then ready; with
``DYN_SYSTEM_USE_ENDPOINT_HEALTH_STATUS`` the served endpoint's health;
notready while the watchdog reads a stall; with the watchdog's keys and
``compiles_after_warmup_total``), ``/live``, ``/metrics`` (the engine's
latency digests as ``dynamo_component_<stream>_seconds`` histograms and
quantile gauges), ``/debug/state`` (``TorchEngine.debug_state``),
``/debug/stacks``, ``POST /debug/profile`` (the engine's
``DeviceProfiler``; ``kind=host`` the stack sampler) and ``POST /drain``.

The black box, as the JAX worker wires it: ``--incident-dir`` (or
``DYN_INCIDENT_DIR``) receives the incident bundles (``tools/autopsy.py``
reads them), at most ``--incident-keep``; ``--profile-on-incident`` adds a
short device capture to each; the continuous device-truth sampler opens a
``--profile-window-s`` window every ``--profile-interval-s`` (off with
``--no-continuous-profiling``); ``--profile-dir`` (or ``DYN_PROFILE_DIR``)
is every capture's root.

At shutdown it logs one line, ``worker launch counters: {json}``: each
kernel wrapper's launches and plain calls, the scheduler's step, request,
onboard and export counters, all counted from the moment it registered,
the step graphs captured since its warmup,
and on a decode worker its disaggregation counters (``"disagg"``). SIGUSR1
logs the same line (less the disaggregation counters) and serves on.

JAX flags whose feature is not ported are not declared, so argparse
refuses them (ROADMAP Queue 1, by item):
- 20: ``--mocker``, ``--speedup-ratio``, ``--fault-scenario``, and
  ``--block-size`` (it sizes the mocker's blocks; the card here takes the
  model's block size);
- 17: ``--tp``, ``--dp``, ``--ep``, ``--pp``, ``--num-processes``,
  ``--process-id``, ``--coordinator``, ``--multihost-group``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
from typing import Optional

import torch

from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.llm.disagg import DisaggDecodeHandler, DisaggRouter, DisaggRouterConf, KvExportService
from dynamo_tpu_torch.llm.entrypoint import register_llm
from dynamo_tpu_torch.llm.kv_router import KvEventPublisher, WorkerMetricsPublisher
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
from dynamo_tpu_torch.runtime.config import Config, SystemConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.health import HEALTHY, SystemHealth, SystemStatusServer
from dynamo_tpu_torch.runtime.logging import get_logger, init_logging
from dynamo_tpu_torch.runtime.metrics import COMPONENT_PREFIX, MetricsRegistry
from dynamo_tpu_torch.runtime.telemetry import DigestCollector
from dynamo_tpu_torch.runtime.tracing import add_trace_args, get_tracer, setup_tracing

logger = get_logger(__name__)

# Scheduler counters reported at shutdown.
STEP_COUNTERS = ("request_total", "forward_steps_total", "prefill_steps_total", "decode_steps_total",
                 "mixed_steps_total", "wave_steps_total", "window_steps_total", "multi_windows_total",
                 "fused_windows_total", "fused_sampled_windows_total", "fused_guided_windows_total",
                 "draft_prefill_steps_total", "spec_fused_windows_total", "spec_rounds_total",
                 "prefix_onboard_total", "exports_total", "exports_taken_total", "exports_expired_total")


# A decode worker's disaggregation counters (its stats_handler's keys).
DISAGG_COUNTERS = ("remote_prefills", "local_prefills", "degrade_disagg_to_colocated_total",
                   "degrade_colocated_to_disagg_total", "split_prefills_total")


def _kernel_counters() -> dict:
    """name → (module, launch-count attribute, plain-call attribute) of each
    kernel wrapper the serving path can reach."""
    from dynamo_tpu_torch.engine.attention import decode, megakernel, prefill

    return {"ragged_paged_attention": (megakernel, "KERNEL_LAUNCHES", "REF_CALLS"),
            "ragged_paged_attention_int8": (megakernel, "KERNEL_LAUNCHES_INT8", "REF_CALLS_INT8"),
            "flash_chunk_attention": (prefill, "KERNEL_LAUNCHES", "REF_CALLS"),
            "paged_decode_partials": (decode, "KERNEL_LAUNCHES", "REF_CALLS"),
            "fused_decode_window": (megakernel, "WINDOW_KERNEL_LAUNCHES", "WINDOW_REF_CALLS"),
            "fused_decode_window_sampled": (megakernel, "WINDOW_SAMPLED_LAUNCHES", "WINDOW_SAMPLED_REF_CALLS"),
            "fused_decode_window_guided": (megakernel, "WINDOW_GUIDED_LAUNCHES", "WINDOW_GUIDED_REF_CALLS"),
            "fused_spec_window": (megakernel, "SPEC_KERNEL_LAUNCHES", "SPEC_REF_CALLS")}


def launch_counters(engine: TorchEngine) -> dict:
    """The kernel wrappers' launch and plain-call counts, the scheduler's
    step and request counters, and the step graphs captured since warmup
    (None without one), as they stand."""
    sched = engine.scheduler
    return {"kernels": {name: {"launches": getattr(mod, launches), "plain_calls": getattr(mod, plain)}
                        for name, (mod, launches, plain) in _kernel_counters().items()},
            "steps": {k: getattr(sched, k) for k in STEP_COUNTERS},
            "captures_after_warmup": sched.graph_captures_after_warmup}


def counters_since(engine: TorchEngine, base: dict) -> dict:
    now = launch_counters(engine)
    return {"kernels": {name: {k: v - base["kernels"][name][k] for k, v in c.items()}
                        for name, c in now["kernels"].items()},
            "steps": {k: v - base["steps"][k] for k, v in now["steps"].items()},
            "captures_after_warmup": now["captures_after_warmup"]}


class Worker:
    """A served engine: its endpoint handle, its KV-event and metrics
    publishers, and by role its KV export service (prefill) or its disagg
    handler and router (decode). ``stop`` deregisters, drains within
    ``drain_timeout_s`` (streams still open then are severed, and their
    callers migrate) and stops the rest; the engine is the caller's."""

    def __init__(self, drt: DistributedRuntime, handle, publishers: list, base: dict, *, kvx=None,
                 handler=None, disagg_router=None):
        self.drt = drt
        self.handle = handle
        self.publishers = publishers
        self.base = base  # launch_counters(engine) just before it registered
        self.kvx = kvx
        self.handler = handler
        self.disagg_router = disagg_router

    @property
    def instance_id(self) -> int:
        return self.handle.instance.instance_id

    async def stop(self, drain_timeout_s: Optional[float] = None) -> None:
        await self.handle.stop(drain=True, timeout_s=drain_timeout_s)
        for pub in self.publishers:
            await pub.stop()
        if self.kvx is not None:
            await self.kvx.stop()
        if self.disagg_router is not None:
            await self.disagg_router.stop()


def check_role(role: str, config) -> None:
    """A prefill or decode worker hands KV over in the JAX package's host
    frames, whose reader splits a frame's body into equal k and v halves:
    an MLA block (its latent k and an empty v) does not round-trip there
    (ROADMAP Queue 3), so those roles refuse an MLA model until a wire for
    it exists in the reference."""
    if role in ("prefill", "decode") and config.architecture == "mla":
        raise ValueError(f"--role {role} does not serve MLA models ({config.name}): the KV hand-over's host "
                         "frames carry k and v halves, and an MLA block has no v")


async def serve_engine(
    drt: DistributedRuntime,
    engine: TorchEngine,
    card: ModelDeploymentCard,
    *,
    namespace: str = "dynamo",
    component: str = "backend",
    endpoint: str = "generate",
    role: str = "aggregated",
    kv_transfer: str = "device",
    max_local_prefill_length: int = 0,
) -> Worker:
    """Serve ``engine`` on ``drt`` as one worker of ``card``'s model in
    ``role``: an aggregated or decode worker registers the model (a decode
    worker behind a ``DisaggDecodeHandler`` over the ``prefill`` component
    of ``namespace``); a prefill worker serves its endpoint and its KV
    exports. Every role publishes its KV events and load metrics."""
    if role not in ("aggregated", "prefill", "decode"):
        raise ValueError(f"unknown role {role!r}")
    check_role(role, engine.scheduler.mc)
    if card.kv_cache_block_size != engine.scheduler.mc.block_size:
        raise ValueError(f"the card's KV block size {card.kv_cache_block_size} is not the engine's "
                         f"{engine.scheduler.mc.block_size}: the router would hash other blocks")
    ep = drt.namespace(namespace).component(component).endpoint(endpoint)
    base = launch_counters(engine)
    handler = disagg_router = kvx = None
    if role == "decode":
        prefill_client = await drt.namespace(namespace).component("prefill").endpoint(endpoint).client()
        disagg_router = DisaggRouter(drt, card.name,
                                     conf=DisaggRouterConf(max_local_prefill_length=max_local_prefill_length))
        await disagg_router.start()
        handler = DisaggDecodeHandler(drt, engine, prefill_client, disagg_router, kv_transfer=kv_transfer,
                                      block_size=engine.scheduler.mc.block_size)
    if role == "prefill":
        # The prefill pool is internal: no model entry for the frontends.
        handle = await ep.serve_endpoint(engine.generate, stats_handler=engine.stats_handler)
        kvx = KvExportService(drt, engine, handle.instance)
        await kvx.start()
    else:
        served = handler or engine
        handle, _ = await register_llm(drt, ep, served, card, stats_handler=served.stats_handler)
    worker_id = handle.instance.instance_id
    kv_pub = KvEventPublisher(drt, namespace, component, worker_id)
    kv_pub.start()
    loop = asyncio.get_running_loop()
    # The engine raises KV events on its step thread: hop them to the loop.
    engine.set_kv_event_sink(lambda ev: kv_pub.publish_threadsafe(loop, ev))
    m_pub = WorkerMetricsPublisher(drt, namespace, component, worker_id, engine.metrics)
    m_pub.start()
    return Worker(drt, handle, [kv_pub, m_pub], base, kvx=kvx, handler=handler, disagg_router=disagg_router)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="dynamo-tpu worker on PyTorch/CUDA", allow_abbrev=False)
    p.add_argument("--model", default="tiny", help="model preset name")
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default=None, help="defaults to 'backend' (aggregated), else the role")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--role", choices=["aggregated", "decode", "prefill", "encode"], default="aggregated")
    p.add_argument("--vision-model", default="tiny-vit",
                   help="encode role: the ViT preset (tiny-vit, vit-l-14) whose features the LM's prefill takes")
    p.add_argument("--vision-seed", type=int, default=0, help="encode role: seed of the ViT's random weights")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain path)")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights and of sampling")
    p.add_argument("--checkpoint", default=None,
                   help="weights: a safetensors directory or a GGUF file (default: seeded random weights)")
    p.add_argument("--tokenizer", default=None,
                   help="a tokenizer.json or its directory, named on the model card (default: byte-level)")
    p.add_argument("--num-blocks", type=int, default=512)
    p.add_argument("--max-running", type=int, default=16)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--kv-cache-dtype", choices=["auto", "int8"], default="auto")
    p.add_argument("--weight-dtype", choices=["auto", "int8"], default="auto")
    p.add_argument("--draft-model", default=None, help="draft model preset for speculative decoding")
    p.add_argument("--draft-checkpoint", default=None,
                   help="the draft's weights (default: seeded random weights)")
    p.add_argument("--spec-gamma", type=int, default=4, help="speculative tokens proposed per round")
    p.add_argument("--warmup-ctx", type=int, default=0,
                   help="capture the step graphs for contexts up to this many tokens before serving "
                        "(0 = capture each on first use)")
    p.add_argument("--kvbm-host-blocks", type=int, default=0, help="KVBM host tier (G2) in blocks (0 = off)")
    p.add_argument("--kvbm-disk-dir", default=None, help="KVBM disk tier (G3) directory")
    p.add_argument("--kvbm-disk-blocks", type=int, default=0, help="KVBM disk tier (G3) in blocks")
    p.add_argument("--kvbm-remote", action="store_true",
                   help="enable the G4 remote KV tier on the control-plane object store")
    p.add_argument("--max-local-prefill-length", type=int, default=0,
                   help="decode role: prompts up to this many tokens prefill locally")
    p.add_argument("--kv-transfer", choices=["device", "host"], default="device",
                   help="decode role: pull the KV on the card (CUDA IPC) or as host bytes over TCP")
    add_trace_args(p)
    p.add_argument("--slo-ttft-ms", type=float, default=None,
                   help="TTFT SLO target in ms (enables the slo_*/goodput counters)")
    p.add_argument("--slo-tpot-ms", type=float, default=None, help="per-output-token latency SLO target in ms")
    p.add_argument("--stall-after-s", type=float, default=120.0,
                   help="watchdog: step loop idle this long with work queued => engine_stalled")
    p.add_argument("--health-port", type=int, default=None,
                   help="serve /health, /live, /metrics and /debug/state on this port (0 = a free one)")
    p.add_argument("--incident-dir", default=None,
                   help="write anomaly-triggered incident bundles here "
                        "(default DYN_INCIDENT_DIR; unset = detect + count only)")
    p.add_argument("--incident-keep", type=int, default=16, help="LRU retention cap on incident bundle files")
    p.add_argument("--profile-on-incident", action="store_true",
                   help="attach a short device capture (torch.profiler) to each incident bundle")
    p.add_argument("--no-continuous-profiling", action="store_true",
                   help="disarm the background device-truth sampler")
    p.add_argument("--profile-window-s", type=float, default=0.25,
                   help="continuous sampler capture window (seconds)")
    p.add_argument("--profile-interval-s", type=float, default=30.0,
                   help="seconds between continuous capture windows (duty-cycle-clamped)")
    p.add_argument("--profile-dir", default=None,
                   help="artifact root for all device captures (default DYN_PROFILE_DIR)")
    return p


def build_engine(args: argparse.Namespace) -> TorchEngine:
    tokenizer = load_tokenizer(args.tokenizer)
    engine = TorchEngine.build(
        EngineArgs(
            model=args.model,
            dtype=args.dtype,
            seed=args.seed,
            device=args.device,
            checkpoint_path=args.checkpoint,
            eos_token_ids=tokenizer.eos_token_ids,
            scheduler=SchedulerConfig(num_blocks=args.num_blocks, max_running=args.max_running,
                                      slo_ttft_ms=args.slo_ttft_ms, slo_tpot_ms=args.slo_tpot_ms,
                                      stall_after_s=args.stall_after_s),
            draft_model=args.draft_model,
            draft_checkpoint_path=args.draft_checkpoint,
            spec_gamma=args.spec_gamma,
            kv_cache_dtype=args.kv_cache_dtype,
            weight_dtype=args.weight_dtype,
            warmup_ctx=args.warmup_ctx,
            kvbm_host_blocks=args.kvbm_host_blocks,
            kvbm_disk_dir=args.kvbm_disk_dir,
            kvbm_disk_blocks=args.kvbm_disk_blocks,
            incident_dir=args.incident_dir,
            incident_keep=args.incident_keep,
            profile_on_incident=args.profile_on_incident,
            continuous_profiling=not args.no_continuous_profiling,
            profile_window_s=args.profile_window_s,
            profile_interval_s=args.profile_interval_s,
            profile_dir=args.profile_dir,
        )
    )
    # Guided decoding lifts grammars against the tokenizer the frontend
    # detokenizes with: the one the card names.
    engine.attach_guided_tokenizer(tokenizer)
    return engine


def build_card(args: argparse.Namespace, engine: TorchEngine) -> ModelDeploymentCard:
    """The model card the worker publishes: its name, the tokenizer the
    frontends load (``--tokenizer``) and the engine's KV block size."""
    return ModelDeploymentCard(name=args.served_model_name or args.model, model_type="chat",
                               tokenizer_path=args.tokenizer, kv_cache_block_size=engine.scheduler.mc.block_size)


async def serve_encoder(args: argparse.Namespace) -> None:
    """``--role encode``: the ViT behind ``{namespace}/encode/{endpoint}``
    until SIGINT or SIGTERM; no model registration, no LM engine."""
    from dynamo_tpu_torch.llm.multimodal import EncodeWorkerHandler, LocalVisionEncoder

    handler = EncodeWorkerHandler(LocalVisionEncoder(preset=args.vision_model, seed=args.vision_seed,
                                                     device=args.device, dtype=getattr(torch, args.dtype)))
    drt = await DistributedRuntime.from_settings()
    drt.runtime.install_signal_handlers()
    ep = drt.namespace(args.namespace).component(args.component or "encode").endpoint(args.endpoint)
    handle = await ep.serve_endpoint(handler.generate, stats_handler=handler.stats_handler)
    logger.info("encode worker ready: vision=%s instance=%x", args.vision_model, handle.instance.instance_id)
    try:
        await drt.runtime.cancellation.cancelled()
    finally:
        await handle.stop(drain=True)
        await drt.shutdown()
        logger.info("encode worker counters: %s", json.dumps(handler.stats_handler()))


def system_config(args: argparse.Namespace) -> SystemConfig:
    """The status server's settings: ``DYN_SYSTEM_*``, where
    ``--health-port`` turns the server on at its port."""
    cfg = Config.from_env().system
    if args.health_port is not None:
        cfg.enabled, cfg.port = True, args.health_port
    return cfg


async def start_health_server(cfg: SystemConfig, engine: TorchEngine) -> SystemStatusServer:
    """The system status server at ``cfg.host:cfg.port``, started before the
    worker registers: until ``mark_served`` its readiness is
    ``cfg.starting_health_status`` (or, with
    ``cfg.use_endpoint_health_status``, that of the served endpoints: none
    yet). Readiness also follows the stall watchdog (the compile tracker's
    count rides along), ``/debug/state`` is the engine's, and ``/metrics``
    renders the engine's latency digests as the ``dynamo_component_*``
    histogram and quantile families; ``POST /debug/profile`` captures
    through the engine's ``DeviceProfiler``, the one its incident plane and
    continuous sampler share."""
    health = SystemHealth(starting_status=cfg.starting_health_status,
                          use_endpoint_health=cfg.use_endpoint_health_status)
    health.attach_engine(lambda: {**engine.watchdog.to_stats(),
                                  "compiles_after_warmup_total": engine.scheduler.flight.compiles_after_warmup_total})
    metrics = MetricsRegistry(prefix=COMPONENT_PREFIX)
    DigestCollector(COMPONENT_PREFIX, registry=metrics.registry, telemetry=engine.scheduler.telemetry)
    server = SystemStatusServer(health, metrics=metrics, config=cfg, state_probe=engine.debug_state,
                                profiler=engine.profiler)
    await server.start()
    logger.info("health server on %s:%d", cfg.host, server.port)
    return server


def mark_served(server: SystemStatusServer, drt: DistributedRuntime, worker: Worker, endpoint_path: str) -> None:
    """The worker serves ``endpoint_path``: the process and the endpoint
    read ready, and ``POST /drain`` now removes the endpoint, deregisters,
    drains, flushes the tracer and ends the process as SIGTERM does."""
    health = server.health
    health.set_endpoint_health(endpoint_path, HEALTHY)
    health.set_system_ready()

    async def drain_and_exit() -> None:
        logger.warning("drain requested for instance %x", worker.instance_id)
        health.remove_endpoint(endpoint_path)
        await worker.handle.stop(drain=True)
        get_tracer().flush()
        drt.runtime.trigger_shutdown()

    server.drain_cb = drain_and_exit


async def amain(args: argparse.Namespace) -> None:
    if args.role == "encode":
        await serve_encoder(args)
        return
    check_role(args.role, get_config(args.model))  # before any weights load
    engine = build_engine(args)
    drt = await DistributedRuntime.from_settings()
    drt.runtime.install_signal_handlers()
    if args.kvbm_remote and engine.kvbm is not None:
        from dynamo_tpu_torch.llm.block_manager.storage import RemotePool

        engine.kvbm.attach_remote(RemotePool(drt, asyncio.get_running_loop()))
    card = build_card(args, engine)
    component = args.component or ("backend" if args.role == "aggregated" else args.role)
    sys_cfg = system_config(args)
    status_server = await start_health_server(sys_cfg, engine) if sys_cfg.enabled else None
    worker = await serve_engine(drt, engine, card, namespace=args.namespace, component=component,
                                endpoint=args.endpoint, role=args.role, kv_transfer=args.kv_transfer,
                                max_local_prefill_length=args.max_local_prefill_length)
    if status_server is not None:
        mark_served(status_server, drt, worker, f"{args.namespace}/{component}/{args.endpoint}")
    logger.info("worker ready: role=%s model=%s instance=%x", args.role, card.name, worker.instance_id)
    asyncio.get_running_loop().add_signal_handler(
        signal.SIGUSR1, lambda: logger.info("worker launch counters: %s", json.dumps(counters_since(engine, worker.base))))
    try:
        await drt.runtime.cancellation.cancelled()
    finally:
        disagg = worker.handler.stats_handler() if worker.handler is not None else None
        if status_server is not None:
            await status_server.stop()
        await worker.stop()
        get_tracer().flush()
        await drt.shutdown()
        await engine.stop()
        counters = counters_since(engine, worker.base)
        if disagg is not None:
            counters["disagg"] = {k: disagg[k] for k in DISAGG_COUNTERS}
        logger.info("worker launch counters: %s", json.dumps(counters))


def main() -> None:
    init_logging()
    args = build_parser().parse_args()
    setup_tracing(args, f"worker-{args.role}")
    asyncio.run(amain(args))


if __name__ == "__main__":
    main()
