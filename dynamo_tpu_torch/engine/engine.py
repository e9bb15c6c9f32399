"""TorchEngine: the AsyncEngine facade over the continuous-batching scheduler.

The counterpart of the JAX package's ``TpuEngine``, with the part of its
surface the port serves: ``build``, ``start``, ``stop``, ``generate``,
``abort``, ``metrics``, ``stats``, ``stats_handler``, ``debug_state``,
``set_capacity_dial`` (the elastic prefill:decode split, reachable over
the wire as the worker's ``set_dial`` control op),
``set_kv_event_sink``, ``attach_guided_tokenizer``, and for disaggregation
``take_export`` / ``take_export_device``. Its stall watchdog (``watchdog``,
``runtime/telemetry.StallWatchdog``) marks the engine stalled when work is
queued and no step has completed for ``SchedulerConfig.stall_after_s``; the
stats scrape and ``/health`` evaluate it. The black box: an
``IncidentPlane`` (``incidents``) checks every stats scrape and writes a
bundle (``EngineArgs.incident_dir``, or ``DYN_INCIDENT_DIR``) when a signal
fires, with the engine's state, the flight recorder's ring, the
configuration and the tenant ledger's snapshot; one ``DeviceProfiler``
(``profiler``) serves every capture path (``/debug/profile``, incident
captures, the continuous sampler); the continuous sampler
(``continuous_profiler``, armed by ``EngineArgs.continuous_profiling``
after warmup) feeds the flight recorder's measured windows. A request's
``tenant`` (resolved by the frontend) goes to the scheduler's tenant
ledger. A request whose trace records (the process tracer's sampling
decision on its context's ``traceparent``) hands the scheduler its
``(trace_id, parent span)``, so the scheduler's lifecycle events join the
caller's trace. With ``kvbm_host_blocks > 0`` it owns a KVBM
(``llm/block_manager``): G1 evictions offload to host memory, then disk,
then the object store, and prefix hits onboard back.

Request wire shape (PreprocessedRequest):
``{"token_ids": [...], "sampling_options": {...}, "stop_conditions": {...}}``,
plus ``"guided_decoding"`` (llm/guided's spec) for a structured output,
``"disagg_params": {"do_remote_decode": true}`` on a prefill worker (the
request's blocks wait for the decode worker's pull) and ``"_prefilled"``
on a decode worker (the pulled KV, ``Scheduler._inject_prefilled``), and
``"multimodal"`` for an image prompt (its feature rows, injected at the
prompt's first positions, ``Scheduler.add_request(mm_features=)``).
``sampling_options`` takes the JAX package's keys: temperature, top_k,
top_p, seed, logprobs, top_logprobs, frequency_penalty, presence_penalty
and logit_bias (a ``LogitBiasProcessor`` on the request's row).
Response frames (LLMEngineOutput): ``{"token_ids": [t], "finish_reason": ...,
"index": 0}``, with ``"logprobs"`` (one per token) and ``"top_logprobs"``
(``[[id, logprob], ...]`` per token) when asked — detokenization happens
upstream in the Backend operator.

Single-task ownership: only the engine's step-loop task mutates the
scheduler; ``generate``/``abort`` stage work through event-loop-local lists,
and the blocking device step runs on a thread of the engine's own so
serving IO never stalls. A request's grammar compiles on a second one:
neither waits for a thread of the event loop's default pool, which the
serving IO around the engine may hold.
"""

from __future__ import annotations

import asyncio
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, List, Optional

import torch

from dynamo_tpu_torch.engine.config import ModelConfig, get_config
from dynamo_tpu_torch.engine.kv_cache import KvEvent
from dynamo_tpu_torch.engine.quant import params_quantized, quantize_params
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import (
    ForwardPassMetrics,
    Scheduler,
    SchedulerConfig,
    StepOutput,
    StopConditions,
)
from dynamo_tpu_torch.engine.weights import init_params, load_checkpoint
from dynamo_tpu_torch.logits_processing import LogitBiasProcessor
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.incidents import (
    INCIDENT_DIR_ENV, IncidentConfig, IncidentPlane, register_evidence_probe,
)
from dynamo_tpu_torch.runtime.profiling import ContinuousProfileConfig, ContinuousProfiler, DeviceProfiler
from dynamo_tpu_torch.runtime.telemetry import StallWatchdog
from dynamo_tpu_torch.runtime.tracing import get_tracer

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device: str) -> torch.device:
    """The device an entry point runs on. ``cuda`` (the default everywhere)
    raises when no card is visible: the port never moves to the CPU unless
    the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but CUDA is not available; pass device='cpu' "
            "explicitly to run the plain PyTorch path"
        )
    return dev


@dataclass
class EngineArgs:
    model: str = "tiny"
    model_config: Optional[ModelConfig] = None
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    dtype: str = "bfloat16"
    seed: int = 0
    eos_token_ids: List[int] = field(default_factory=list)
    device: str = "cuda"
    # A checkpoint (engine/weights.load_checkpoint: a safetensors directory
    # or a GGUF file); None serves seeded random weights.
    checkpoint_path: Optional[str] = None
    # Speculative decoding: a draft model preset proposing spec_gamma tokens
    # per round (its checkpoint, TorchEngine.build's draft_params, or seeded
    # random weights).
    draft_model: Optional[str] = None
    draft_checkpoint_path: Optional[str] = None
    spec_gamma: int = 4
    # KV cache storage dtype override ("auto" | "int8") — config.py.
    kv_cache_dtype: str = "auto"
    # Weight storage dtype override ("auto" | "int8") — config.py weight_dtype.
    weight_dtype: str = "auto"
    # MoE dispatch override ("auto" | "dense" | "ragged" | "capacity") —
    # config.py moe_dispatch; "auto" keeps the config's.
    moe_dispatch: str = "auto"
    # Capture the step graphs for contexts up to this many tokens before
    # taking traffic (Scheduler.warmup; 0 = capture each on first use).
    warmup_ctx: int = 0
    # KVBM tiers (0 / None = off): host blocks (G2), and a disk directory
    # with its block count (G3).
    kvbm_host_blocks: int = 0
    kvbm_disk_dir: Optional[str] = None
    kvbm_disk_blocks: int = 0
    # Incident plane (runtime/incidents.py): bundles go here (None: the
    # DYN_INCIDENT_DIR environment, else detect and count only), at most
    # incident_keep of them; profile_on_incident adds a short device capture.
    incident_dir: Optional[str] = None
    incident_keep: int = 16
    profile_on_incident: bool = False
    # The continuous device-truth sampler (runtime/profiling.py): a
    # profile_window_s capture every profile_interval_s (duty-cycle
    # clamped), armed after warmup. profile_dir is every capture's root
    # (None: DYN_PROFILE_DIR).
    continuous_profiling: bool = True
    profile_window_s: float = 0.25
    profile_interval_s: float = 30.0
    profile_dir: Optional[str] = None


def _attach_logprobs(frame: dict, logprobs: list, top_logprobs: list) -> None:
    if logprobs:
        frame["logprobs"] = logprobs
    if top_logprobs:
        frame["top_logprobs"] = top_logprobs


class TorchEngine:
    def __init__(
        self,
        scheduler: Scheduler,
        *,
        kv_event_sink: Optional[Callable[[KvEvent], None]] = None,
    ):
        self.scheduler = scheduler
        self._staged_adds: List[tuple] = []
        self._staged_aborts: List[str] = []
        self._wake = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        self._closed = False
        self._kv_event_sink = kv_event_sink
        self.kvbm = None  # llm/block_manager.KvBlockManager, when built with tiers
        self._step_thread = ThreadPoolExecutor(max_workers=1, thread_name_prefix="engine-step")
        self._compile_thread = ThreadPoolExecutor(max_workers=1, thread_name_prefix="grammar-compile")
        # Stall watchdog: evaluated lazily on every stats scrape and health
        # probe, no thread of its own.
        self.watchdog = StallWatchdog(probe=lambda: (scheduler.has_work(), scheduler.flight.last_step_ts),
                                      stall_after_s=scheduler.sc.stall_after_s)
        # One DeviceProfiler per engine: the serialisation point of every
        # capture path; its windows hold whole scheduler iterations and never
        # overlap a step-graph capture.
        self.profiler = DeviceProfiler(device=scheduler.device, guard=scheduler.capture_lock,
                                       step_lock=scheduler.step_lock)
        # The incident plane rides every stats scrape; build() points it at
        # its bundle directory. The tenant ledger's snapshot rides every
        # bundle (process-global: a later engine replaces the probe).
        self.incidents = IncidentPlane(IncidentConfig(), state_probe=self.debug_state,
                                       flight_probe=scheduler.flight.ring_snapshot,
                                       config_probe=scheduler.config_snapshot, profiler=self.profiler)
        register_evidence_probe("tenant_ledger", scheduler.ledger.snapshot)
        self.continuous_profiler: Optional[ContinuousProfiler] = None

    # --- construction -------------------------------------------------------
    @classmethod
    def build(
        cls,
        args: EngineArgs,
        *,
        params=None,
        draft_params=None,
        kv_event_sink: Optional[Callable[[KvEvent], None]] = None,
    ) -> "TorchEngine":
        mc = args.model_config or get_config(args.model)
        if args.kv_cache_dtype != "auto":
            mc = mc.replace(kv_cache_dtype=args.kv_cache_dtype)
        if args.weight_dtype != "auto":
            mc = mc.replace(weight_dtype=args.weight_dtype)
        if args.moe_dispatch != "auto":
            mc = mc.replace(moe_dispatch=args.moe_dispatch)
        if args.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {args.dtype!r}")
        dtype = _DTYPES[args.dtype]
        device = resolve_device(args.device)
        if params is None and args.checkpoint_path:
            params = load_checkpoint(args.checkpoint_path, mc, dtype=dtype, device=device)
        elif params is None:
            logger.warning("no checkpoint: initializing random weights for %s", mc.name)
            gen = torch.Generator(device=device).manual_seed(args.seed)
            params = init_params(mc, gen, device=device, dtype=dtype)
        if mc.weight_dtype == "int8" and not params_quantized(params):
            params = quantize_params(params)
            logger.info("int8 weight-only quantization applied (layer matmul weights)")
        engine = cls(
            Scheduler(
                mc,
                params,
                args.scheduler,
                dtype=dtype,
                device=device,
                eos_token_ids=args.eos_token_ids,
                on_kv_event=lambda ev: engine._on_kv_event(ev),
                rng_seed=args.seed,
            ),
            kv_event_sink=kv_event_sink,
        )
        if args.draft_model:
            dc = get_config(args.draft_model)
            if draft_params is None and args.draft_checkpoint_path:
                draft_params = load_checkpoint(args.draft_checkpoint_path, dc, dtype=dtype, device=device)
            elif draft_params is None:
                logger.warning("no draft checkpoint: random weights for %s", dc.name)
                gen = torch.Generator(device=device).manual_seed(args.seed + 1)
                draft_params = init_params(dc, gen, device=device, dtype=dtype)
            engine.scheduler.attach_draft(dc, draft_params, gamma=args.spec_gamma)
        if args.warmup_ctx > 0:
            n = engine.scheduler.warmup(args.warmup_ctx)
            logger.info("captured %d step graphs (ctx %d)", n, args.warmup_ctx)
        # Traffic may start: graphs captured from here on are the compile
        # tracker's compiles after warmup.
        engine.scheduler.flight.mark_warmup_done(warmed=args.warmup_ctx > 0)
        incident_dir = args.incident_dir or os.environ.get(INCIDENT_DIR_ENV) or None
        if args.profile_dir:
            engine.profiler.out_dir = args.profile_dir
        elif args.profile_on_incident and incident_dir:
            engine.profiler.out_dir = os.path.join(incident_dir, "profiles")
        engine.incidents = IncidentPlane(
            IncidentConfig(dir=incident_dir, keep=args.incident_keep, profile_on_incident=args.profile_on_incident),
            state_probe=engine.debug_state, flight_probe=engine.scheduler.flight.ring_snapshot,
            config_probe=engine.scheduler.config_snapshot, profiler=engine.profiler)
        if args.continuous_profiling:
            # Armed after warmup, so no window meets the warmup's captures.
            flight = engine.scheduler.flight
            engine.continuous_profiler = ContinuousProfiler(
                engine.profiler, ContinuousProfileConfig(window_s=args.profile_window_s,
                                                         interval_s=args.profile_interval_s),
                cost_probe=flight.roofline_totals, sink=flight.record_measured_window)
            engine.continuous_profiler.start()
        if args.kvbm_host_blocks > 0:
            from dynamo_tpu_torch.llm.block_manager import KvBlockManager

            engine.kvbm = KvBlockManager(engine.scheduler.cache, engine.scheduler.allocator,
                                         host_blocks=args.kvbm_host_blocks, disk_dir=args.kvbm_disk_dir,
                                         disk_blocks=args.kvbm_disk_blocks)
            engine.scheduler.attach_kvbm(engine.kvbm)
        return engine

    def set_kv_event_sink(self, sink: Optional[Callable[[KvEvent], None]]) -> None:
        """Where the allocator's KV events go. They are raised on the step
        thread (and on the event loop for an abort): a sink that feeds the
        loop must hop, e.g. ``KvEventPublisher.publish_threadsafe``."""
        self._kv_event_sink = sink

    def _on_kv_event(self, ev: KvEvent) -> None:
        if self._kv_event_sink is not None:
            self._kv_event_sink(ev)

    # --- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._loop_task is None:
            self._loop_task = asyncio.get_running_loop().create_task(self._loop(), name="engine-step-loop")

    async def stop(self) -> None:
        self._closed = True
        self._wake.set()
        if self.continuous_profiler is not None:
            await asyncio.get_running_loop().run_in_executor(None, self.continuous_profiler.stop)
        if self._loop_task is not None:
            await self._loop_task
            self._loop_task = None
        if self.kvbm is not None:
            # Queued offload snapshots reach the host and disk tiers: a G3
            # directory outlives the process.
            await asyncio.get_running_loop().run_in_executor(self._step_thread, self.kvbm.flush_pending)
        self._step_thread.shutdown(wait=False)
        self._compile_thread.shutdown(wait=False, cancel_futures=True)
        self.scheduler.close()

    async def _loop(self) -> None:
        try:
            while not self._closed:
                n = self.scheduler.expire_exports()
                if n:
                    logger.warning("reclaimed %d unpulled KV exports past their TTL", n)
                if not (self._staged_adds or self._staged_aborts or self.scheduler.has_work()):
                    self._wake.clear()
                    if self.scheduler._pending_exports:
                        # Exports await their pull: wake to expire them even
                        # when nothing else comes.
                        try:
                            await asyncio.wait_for(self._wake.wait(), timeout=1.0)
                        except asyncio.TimeoutError:
                            pass
                    else:
                        await self._wake.wait()
                    continue
                for rid, tokens, sampling, stop, guided, extras, queue in self._staged_adds:
                    try:
                        seq = self.scheduler.add_request(rid, tokens, sampling, stop, guided=guided, **extras)
                        seq.out_queue = queue
                    except ValueError as e:
                        queue.put_nowait(StepOutput(token_id=-1, finished=True, finish_reason=f"error:{e}"))
                self._staged_adds.clear()
                for rid in self._staged_aborts:
                    self.scheduler.abort(rid)
                self._staged_aborts.clear()

                outputs = await asyncio.get_running_loop().run_in_executor(self._step_thread, self.scheduler.step)
                for seq, out in outputs:
                    seq.out_queue.put_nowait(out)
        except Exception:
            logger.exception("engine step loop crashed")
            # Engine death: fail all in-flight requests so their streams end.
            for seq in list(self.scheduler.by_id.values()):
                seq.out_queue.put_nowait(StepOutput(token_id=-1, finished=True, finish_reason="error:engine_dead"))
            raise

    # --- AsyncEngine --------------------------------------------------------
    async def generate(self, request: Any, context: Context) -> AsyncIterator[dict]:
        self.start()
        rid = context.id
        sampling_d = request.get("sampling_options") or {}
        temp = sampling_d.get("temperature")
        seed = sampling_d.get("seed")
        tlp = int(sampling_d.get("top_logprobs") or 0)
        sampling = SamplingParams(
            temperature=1.0 if temp is None else float(temp),  # null ≡ unset ≡ default
            top_k=int(sampling_d.get("top_k") or 0),
            top_p=float(sampling_d.get("top_p") or 1.0),
            seed=int(seed) if seed is not None else None,
            logprobs=bool(sampling_d.get("logprobs")) or tlp > 0,
            top_logprobs=tlp,
            frequency_penalty=float(sampling_d.get("frequency_penalty") or 0.0),
            presence_penalty=float(sampling_d.get("presence_penalty") or 0.0),
        )
        logit_bias = sampling_d.get("logit_bias")
        if logit_bias:
            # Applied before the draw through the row's processor chain.
            sampling.logits_processors = [LogitBiasProcessor(logit_bias)]
        stop = StopConditions.from_dict(request.get("stop_conditions"))
        queue: "asyncio.Queue[StepOutput]" = asyncio.Queue()
        guided = request.get("guided_decoding")  # a grammar spec (llm/guided), or None
        if guided is not None and self.scheduler.guided is not None:
            # The grammar compiles to its token FSM here, off the event loop
            # and the step loop (up to seconds for a large grammar at a 128k
            # vocabulary); the step loop only writes its rows into the pool.
            try:
                guided = await asyncio.get_running_loop().run_in_executor(
                    self._compile_thread, self.scheduler.guided.prepare, guided)
            except ValueError as e:
                raise RuntimeError(str(e)) from e
        disagg = request.get("disagg_params") or {}
        # A prefill worker keeps the blocks for the decode worker's pull; a
        # decode worker starts from the KV it pulled.
        extras = {"keep_blocks_on_finish": bool(disagg.get("do_remote_decode")),
                  "prefilled": request.get("_prefilled"),
                  # The capacity ledger's tenant, resolved by the frontend.
                  "tenant": request.get("tenant") or "anon"}
        mm = request.get("multimodal")
        if mm is not None:
            # Image features (llm/multimodal.py): an array in process, else
            # their wire form.
            from dynamo_tpu_torch.llm.multimodal import features_from_wire

            extras["mm_features"] = mm if hasattr(mm, "shape") else features_from_wire(mm)
        # A trace that records (head-sampled, or every trace in tail mode,
        # whose records stay in the ring until promoted) hands the scheduler
        # its (trace_id, parent span).
        tracer = get_tracer()
        tp = context.traceparent
        if tracer.enabled and tp is not None and tracer.record_allowed(tp.trace_id):
            extras["trace"] = (tp.trace_id, tp.parent_id)
        self._staged_adds.append((rid, list(request["token_ids"]), sampling, stop, guided, extras, queue))
        self._wake.set()

        finished = False
        stop_task = asyncio.create_task(context.stopped())
        try:
            while True:
                # Drain whatever the last step already queued into one frame.
                outs = []
                try:
                    while True:
                        outs.append(queue.get_nowait())
                        if outs[-1].finished:
                            break
                except asyncio.QueueEmpty:
                    pass
                if not outs:
                    get_task = asyncio.create_task(queue.get())
                    done, _ = await asyncio.wait({get_task, stop_task}, return_when=asyncio.FIRST_COMPLETED)
                    if stop_task in done and get_task not in done:
                        get_task.cancel()
                        self.abort(rid)
                        out = await queue.get()
                        while not out.finished:
                            out = await queue.get()
                        finished = True
                        return
                    outs.append(get_task.result())

                frame = {"token_ids": [], "finish_reason": None, "index": 0}
                logprobs, top_logprobs = [], []
                for out in outs:
                    if out.finish_reason and out.finish_reason.startswith("error:"):
                        if frame["token_ids"]:
                            _attach_logprobs(frame, logprobs, top_logprobs)
                            yield frame  # tokens decoded before the error
                        finished = True
                        raise RuntimeError(out.finish_reason[6:])
                    if out.token_id >= 0:
                        frame["token_ids"].append(out.token_id)
                    if out.logprob is not None:
                        logprobs.append(out.logprob)
                    if out.top_logprobs is not None:
                        # [[alt_id, logprob], ...] per token, aligned with
                        # "logprobs" (top_logprobs implies logprobs).
                        top_logprobs.append([[t, lp] for t, lp in out.top_logprobs])
                    if out.queue_s is not None and "queue_s" not in frame:
                        frame["queue_s"] = out.queue_s
                    if out.cached_tokens is not None and "cached_tokens" not in frame:
                        # Prefix-cache reuse (first frame) → OpenAI
                        # usage.prompt_tokens_details.cached_tokens.
                        frame["cached_tokens"] = out.cached_tokens
                    if out.finished:
                        frame["finish_reason"] = out.finish_reason
                _attach_logprobs(frame, logprobs, top_logprobs)
                yield frame
                if frame["finish_reason"]:
                    finished = True
                    return
        finally:
            stop_task.cancel()
            # Abandoned stream (disconnect without kill): stop decoding a
            # request nobody is reading.
            if not finished:
                self.abort(rid)

    def abort(self, request_id: str) -> None:
        self._staged_aborts.append(request_id)
        self._wake.set()

    # --- disaggregation -----------------------------------------------------
    async def take_export(self, request_id: str):
        """A finished prefill-role request's KV as host block pairs, its
        blocks released: ``(blocks, hashes, prompt_len)`` or None. Runs on
        the step thread, between steps."""
        return await asyncio.get_running_loop().run_in_executor(
            self._step_thread, self.scheduler.take_export, request_id)

    async def take_export_device(self, request_id: str):
        """The same as stacked device tensors, with no host round trip:
        ``((k_stack, v_stack), hashes, prompt_len)`` or None."""
        return await asyncio.get_running_loop().run_in_executor(
            self._step_thread, self.scheduler.take_export_device, request_id)

    # --- elastic capacity dial ---------------------------------------------
    def set_capacity_dial(self, prefill_fraction: float) -> dict:
        """Re-split this worker's budget between prefill and decode, live
        (``Scheduler.set_capacity_dial``; thread-safe). Reachable remotely
        through the ``set_dial`` op on the worker's control subject.
        Returns the applied values."""
        return self.scheduler.set_capacity_dial(prefill_fraction)

    # --- introspection ------------------------------------------------------
    def metrics(self) -> ForwardPassMetrics:
        return self.scheduler.metrics()

    def stats(self) -> dict:
        """``stats_handler``'s keys, the step graphs' counters, the served
        family and the capacity-MoE counters (the JAX package reports the
        last two in its config snapshot and its ForwardPassMetrics)."""
        sched = self.scheduler
        return {**self.stats_handler(), "graph_captures_total": sched.graph_captures_total,
                "graph_captures_after_warmup": sched.graph_captures_after_warmup,
                "architecture": sched.mc.architecture, "num_experts": sched.mc.num_experts,
                "moe_dispatch": sched.mc.moe_dispatch, "moe_dropped_total": sched.moe_dropped_total,
                "moe_assignments_total": sched.moe_assignments_total}

    def stats_handler(self) -> dict:
        """The worker's stats scrape: the keys of the JAX engine's
        ``stats_handler``, with their names and meanings, and no other: the
        flight recorder's (measured windows included), the continuous
        sampler's, SLO and goodput, the watchdog's, the digests
        (``digests``), the tenant ledger's (``tenant_ledger`` the wire the
        aggregator merges) and the incident plane's, which checks this very
        scrape. Not here yet: the fault keys (ROADMAP Queue 1 item 20)."""
        m = self.scheduler.metrics()
        stats = {
            "kv_usage": m.kv_usage,
            "kv_total_blocks": m.kv_total_blocks,
            "kv_active_blocks": m.kv_active_blocks,
            "num_running": m.num_running,
            "num_waiting": m.num_waiting,
            "preemptions_total": self.scheduler.preempt_total,
            "request_timeouts_total": self.scheduler.timeouts_total,
            "mixed_steps_total": m.mixed_steps_total,
            "mixed_prefill_tokens_total": m.mixed_prefill_tokens_total,
            "mixed_decode_tokens_total": m.mixed_decode_tokens_total,
            "overlap_steps_total": m.overlap_steps_total,
            "overlap_flushes_total": m.overlap_flushes_total,
            "cached_tokens_total": m.cached_tokens_total,
            "prefix_hit_blocks_total": m.prefix_hit_blocks_total,
            "prefix_miss_blocks_total": m.prefix_miss_blocks_total,
            "prefix_evicted_blocks_total": m.prefix_evicted_blocks_total,
            "prefix_onboard_total": m.prefix_onboard_total,
            # First-token latency decomposition: queue (arrival →
            # admission) and prefill (admission → first token) sums.
            "queue_wait_seconds_total": round(self.scheduler.queue_wait_s_total, 6),
            "prefill_wait_seconds_total": round(self.scheduler.prefill_wait_s_total, 6),
            "first_tokens_total": self.scheduler.first_tokens_total,
            # Elastic capacity dial: the live prefill:decode split.
            "elastic_prefill_fraction": m.elastic_prefill_fraction,
            "elastic_prefill_budget": m.elastic_prefill_budget,
            "elastic_decode_slots": m.elastic_decode_slots,
            "elastic_dial_changes_total": m.elastic_dial_changes_total,
        }
        # The flight recorder: per-phase step, token, FLOP and byte counters,
        # mfu_* / hbm_frac_* over the card's peaks, the host gap, the fused
        # windows and the graph captures after warmup.
        self.scheduler.flight.check_compiles()
        stats.update(self.scheduler.flight.to_stats())
        stats.update(self.scheduler.window_stats())
        if self.continuous_profiler is not None:
            stats.update(self.continuous_profiler.to_stats())
        stats.update(self.scheduler.kv_gauges())
        stats.update(self.scheduler.slo.to_stats())
        stats.update(self.watchdog.to_stats())
        # Mergeable latency digests: an aggregator merges them across workers
        # into fleet quantiles (averaging per-worker p99s does not compose).
        stats["digests"] = self.scheduler.telemetry.to_wire()
        # The tenant ledger: flat billed totals, and the sketch wire the
        # aggregator merges into fleet per-tenant families.
        stats.update(self.scheduler.ledger.to_stats())
        stats["tenant_ledger"] = self.scheduler.ledger.to_wire()
        if self.scheduler.guided is not None:
            stats.update(self.scheduler.guided.stats())
        # The incident plane checks this snapshot (the scrape is its poll)
        # and may write a bundle; its counters ride the same scrape.
        self.incidents.observe(stats)
        stats.update(self.incidents.to_stats())
        return stats

    def debug_state(self) -> dict:
        """Live engine introspection for the health server's /debug/state:
        the scheduler's ``debug_state``, the watchdog's state and the
        incident plane's (``incidents``: retained bundles, the detector's
        evidence, the profiler's status)."""
        state = self.scheduler.debug_state()
        state["watchdog"] = self.watchdog.to_stats()
        state["watchdog"]["stall_after_s"] = self.watchdog.stall_after_s
        state["incidents"] = self.incidents.debug_info()
        return state

    def attach_guided_tokenizer(self, tokenizer) -> None:
        """Enable guided decoding: grammars lift to token FSMs against
        ``tokenizer`` (``build_local_pipeline`` attaches the served one)."""
        self.scheduler.attach_guided(tokenizer)
