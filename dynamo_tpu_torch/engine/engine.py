"""TorchEngine: the AsyncEngine facade over the continuous-batching scheduler.

The counterpart of the JAX package's ``TpuEngine``, with the part of its
surface the port serves: ``build``, ``start``, ``stop``, ``generate``,
``abort`` and ``metrics``.

Request wire shape (PreprocessedRequest):
``{"token_ids": [...], "sampling_options": {...}, "stop_conditions": {...}}``
Response frames (LLMEngineOutput): ``{"token_ids": [t], "finish_reason": ...,
"index": 0}`` — detokenization happens upstream in the Backend operator.

Single-task ownership: only the engine's step-loop task mutates the
scheduler; ``generate``/``abort`` stage work through event-loop-local lists,
and the blocking device step runs via ``asyncio.to_thread`` so serving IO
never stalls.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, List, Optional

import torch

from dynamo_tpu_torch.engine.config import ModelConfig, get_config
from dynamo_tpu_torch.engine.kv_cache import KvEvent
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.scheduler import (
    ForwardPassMetrics,
    Scheduler,
    SchedulerConfig,
    StepOutput,
    StopConditions,
)
from dynamo_tpu_torch.engine.weights import init_params
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

    # --- construction -------------------------------------------------------
    @classmethod
    def build(
        cls,
        args: EngineArgs,
        *,
        params=None,
        kv_event_sink: Optional[Callable[[KvEvent], None]] = None,
    ) -> "TorchEngine":
        mc = args.model_config or get_config(args.model)
        if args.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {args.dtype!r}")
        dtype = _DTYPES[args.dtype]
        device = resolve_device(args.device)
        if params is None:
            logger.warning("no checkpoint: initializing random weights for %s", mc.name)
            gen = torch.Generator(device=device).manual_seed(args.seed)
            params = init_params(mc, gen, device=device, dtype=dtype)
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

    async def _loop(self) -> None:
        try:
            while not self._closed:
                if not (self._staged_adds or self._staged_aborts or self.scheduler.has_work()):
                    self._wake.clear()
                    await self._wake.wait()
                    continue
                for rid, tokens, sampling, stop, queue in self._staged_adds:
                    try:
                        seq = self.scheduler.add_request(rid, tokens, sampling, stop)
                        seq.out_queue = queue
                    except ValueError as e:
                        queue.put_nowait(StepOutput(token_id=-1, finished=True, finish_reason=f"error:{e}"))
                self._staged_adds.clear()
                for rid in self._staged_aborts:
                    self.scheduler.abort(rid)
                self._staged_aborts.clear()

                outputs = await asyncio.to_thread(self.scheduler.step)
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
        sampling = SamplingParams(
            temperature=1.0 if temp is None else float(temp),  # null ≡ unset ≡ default
            top_k=int(sampling_d.get("top_k") or 0),
            top_p=float(sampling_d.get("top_p") or 1.0),
        )
        stop = StopConditions.from_dict(request.get("stop_conditions"))
        queue: "asyncio.Queue[StepOutput]" = asyncio.Queue()
        self._staged_adds.append((rid, list(request["token_ids"]), sampling, stop, queue))
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
                for out in outs:
                    if out.finish_reason and out.finish_reason.startswith("error:"):
                        if frame["token_ids"]:
                            yield frame  # tokens decoded before the error
                        finished = True
                        raise RuntimeError(out.finish_reason[6:])
                    if out.token_id >= 0:
                        frame["token_ids"].append(out.token_id)
                    if out.queue_s is not None and "queue_s" not in frame:
                        frame["queue_s"] = out.queue_s
                    if out.cached_tokens is not None and "cached_tokens" not in frame:
                        # Prefix-cache reuse (first frame) → OpenAI
                        # usage.prompt_tokens_details.cached_tokens.
                        frame["cached_tokens"] = out.cached_tokens
                    if out.finished:
                        frame["finish_reason"] = out.finish_reason
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
