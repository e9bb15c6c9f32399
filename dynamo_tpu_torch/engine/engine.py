"""TorchEngine: the AsyncEngine facade over the continuous-batching scheduler.

The counterpart of the JAX package's ``TpuEngine``, with the part of its
surface the port serves: ``build``, ``start``, ``stop``, ``generate``,
``abort``, ``metrics``, ``stats`` and ``attach_guided_tokenizer``.

Request wire shape (PreprocessedRequest):
``{"token_ids": [...], "sampling_options": {...}, "stop_conditions": {...}}``,
plus ``"guided_decoding"`` (llm/guided's spec) for a structured output.
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
from dynamo_tpu_torch.engine.weights import init_params
from dynamo_tpu_torch.logits_processing import LogitBiasProcessor
from dynamo_tpu_torch.runtime.engine import Context

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
    # Speculative decoding: a draft model preset proposing spec_gamma tokens
    # per round (seeded random weights, or TorchEngine.build's draft_params).
    draft_model: Optional[str] = None
    draft_checkpoint_path: Optional[str] = None
    spec_gamma: int = 4
    # KV cache storage dtype override ("auto" | "int8") — config.py.
    kv_cache_dtype: str = "auto"
    # Weight storage dtype override ("auto" | "int8") — config.py weight_dtype.
    weight_dtype: str = "auto"
    # Capture the step graphs for contexts up to this many tokens before
    # taking traffic (Scheduler.warmup; 0 = capture each on first use).
    warmup_ctx: int = 0

    def __post_init__(self):
        if self.draft_checkpoint_path:
            raise NotImplementedError("checkpoint loading is not ported yet (ROADMAP Queue 1 item 3)")


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
        self._step_thread = ThreadPoolExecutor(max_workers=1, thread_name_prefix="engine-step")
        self._compile_thread = ThreadPoolExecutor(max_workers=1, thread_name_prefix="grammar-compile")

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
        if args.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {args.dtype!r}")
        dtype = _DTYPES[args.dtype]
        device = resolve_device(args.device)
        if params is None:
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
            if draft_params is None:
                logger.warning("no draft checkpoint: random weights for %s", dc.name)
                gen = torch.Generator(device=device).manual_seed(args.seed + 1)
                draft_params = init_params(dc, gen, device=device, dtype=dtype)
            engine.scheduler.attach_draft(dc, draft_params, gamma=args.spec_gamma)
        if args.warmup_ctx > 0:
            n = engine.scheduler.warmup(args.warmup_ctx)
            logger.info("captured %d step graphs (ctx %d)", n, args.warmup_ctx)
        return engine

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
        if self._loop_task is not None:
            await self._loop_task
            self._loop_task = None
        self._step_thread.shutdown(wait=False)
        self._compile_thread.shutdown(wait=False, cancel_futures=True)
        self.scheduler.close()

    async def _loop(self) -> None:
        try:
            while not self._closed:
                if not (self._staged_adds or self._staged_aborts or self.scheduler.has_work()):
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                for rid, tokens, sampling, stop, guided, queue in self._staged_adds:
                    try:
                        seq = self.scheduler.add_request(rid, tokens, sampling, stop, guided=guided)
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
        self._staged_adds.append((rid, list(request["token_ids"]), sampling, stop, guided, queue))
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

    # --- introspection ------------------------------------------------------
    def metrics(self) -> ForwardPassMetrics:
        return self.scheduler.metrics()

    def stats(self) -> dict:
        """The worker's stats: the load snapshot's keys, the step graphs'
        counters, and with a tokenizer attached the guided-decoding
        counters."""
        stats = self.metrics().to_wire()
        sched = self.scheduler
        stats["graph_captures_total"] = sched.graph_captures_total
        stats["graph_captures_after_warmup"] = sched.graph_captures_after_warmup
        if self.scheduler.guided is not None:
            stats.update(self.scheduler.guided.stats())
        return stats

    def attach_guided_tokenizer(self, tokenizer) -> None:
        """Enable guided decoding: grammars lift to token FSMs against
        ``tokenizer`` (``build_local_pipeline`` attaches the served one)."""
        self.scheduler.attach_guided(tokenizer)
