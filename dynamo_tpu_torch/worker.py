"""Worker CLI: serve a ``TorchEngine`` as a discoverable endpoint.

    python -m dynamo_tpu_torch.worker --model llama-3.2-1b

The counterpart of ``python -m dynamo_tpu.worker`` in its ``aggregated``
role, with the JAX CLI's flag names for what is ported. The worker builds
the engine on the card (``--device cuda``, the default, raises without
CUDA), serves it on ``{namespace}/{component}/{endpoint}`` (``dynamo/
backend/generate``), registers the model for the frontends' discovery,
publishes its KV events (hopped from the engine's step thread to the event
loop) and its load metrics, answers stats scrapes with
``TorchEngine.stats_handler``, and on SIGINT or SIGTERM deregisters,
drains and exits. It reaches the control plane named by
``DYN_CONTROL_PLANE`` / ``DYN_CONTROL_PLANE_ADDRESS``. The weights are
seeded random at the preset's published widths (``--seed``; checkpoint
loading is not ported yet) and the tokenizer is the byte-level one.

At shutdown it logs one line, ``worker launch counters: {json}``: each
kernel wrapper's launches and plain calls, and the scheduler's step and
request counters, all counted from the moment it registered.

JAX flags whose feature is not ported are not declared, so argparse
refuses them (ROADMAP Queue 1, by item):
- 20: ``--mocker``, ``--speedup-ratio``, ``--fault-scenario``, and
  ``--block-size`` (it sizes the mocker's blocks; the card here takes the
  model's block size);
- 15: ``--role decode|prefill``, ``--kvbm-host-blocks``, ``--kvbm-disk-dir``,
  ``--kvbm-disk-blocks``, ``--kvbm-remote``, ``--max-local-prefill-length``,
  ``--kv-transfer``;
- 16: ``--role encode``, ``--vision-model``, ``--vision-seed``;
- 17: ``--tp``, ``--dp``, ``--ep``, ``--pp``, ``--num-processes``,
  ``--process-id``, ``--coordinator``, ``--multihost-group``;
- 18: ``--trace-file``, ``--trace-sample``, ``--trace-ring``, ``--trace-tail``,
  ``--incident-dir``, ``--incident-keep``, ``--profile-on-incident``,
  ``--no-continuous-profiling``, ``--profile-window-s``,
  ``--profile-interval-s``, ``--profile-dir``, ``--slo-ttft-ms``,
  ``--slo-tpot-ms``, ``--stall-after-s``, ``--health-port``;
- 3 and 12: ``--checkpoint``, ``--draft-checkpoint``, ``--tokenizer``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
from typing import Optional

from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.llm.entrypoint import register_llm
from dynamo_tpu_torch.llm.kv_router import KvEventPublisher, WorkerMetricsPublisher
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.logging import get_logger, init_logging

logger = get_logger(__name__)

# Scheduler counters reported at shutdown.
STEP_COUNTERS = ("request_total", "forward_steps_total", "prefill_steps_total", "decode_steps_total",
                 "mixed_steps_total", "wave_steps_total", "window_steps_total", "multi_windows_total",
                 "fused_windows_total", "fused_sampled_windows_total", "fused_guided_windows_total",
                 "draft_prefill_steps_total", "spec_fused_windows_total", "spec_rounds_total")


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
    """The kernel wrappers' launch and plain-call counts and the scheduler's
    step and request counters, as they stand."""
    sched = engine.scheduler
    return {"kernels": {name: {"launches": getattr(mod, launches), "plain_calls": getattr(mod, plain)}
                        for name, (mod, launches, plain) in _kernel_counters().items()},
            "steps": {k: getattr(sched, k) for k in STEP_COUNTERS}}


def counters_since(engine: TorchEngine, base: dict) -> dict:
    now = launch_counters(engine)
    return {"kernels": {name: {k: v - base["kernels"][name][k] for k, v in c.items()}
                        for name, c in now["kernels"].items()},
            "steps": {k: v - base["steps"][k] for k, v in now["steps"].items()}}


class Worker:
    """A served engine: its endpoint handle and its KV-event and metrics
    publishers. ``stop`` deregisters, drains within ``drain_timeout_s``
    (streams still open then are severed, and their callers migrate) and
    stops the publishers; the engine is the caller's."""

    def __init__(self, drt: DistributedRuntime, handle, publishers: list, base: dict):
        self.drt = drt
        self.handle = handle
        self.publishers = publishers
        self.base = base  # launch_counters(engine) just before it registered

    @property
    def instance_id(self) -> int:
        return self.handle.instance.instance_id

    async def stop(self, drain_timeout_s: Optional[float] = None) -> None:
        await self.handle.stop(drain=True, timeout_s=drain_timeout_s)
        for pub in self.publishers:
            await pub.stop()


async def serve_engine(
    drt: DistributedRuntime,
    engine: TorchEngine,
    card: ModelDeploymentCard,
    *,
    namespace: str = "dynamo",
    component: str = "backend",
    endpoint: str = "generate",
) -> Worker:
    """Serve ``engine`` on ``drt`` as one aggregated worker of ``card``'s
    model: register it, and publish its KV events and load metrics."""
    if card.kv_cache_block_size != engine.scheduler.mc.block_size:
        raise ValueError(f"the card's KV block size {card.kv_cache_block_size} is not the engine's "
                         f"{engine.scheduler.mc.block_size}: the router would hash other blocks")
    ep = drt.namespace(namespace).component(component).endpoint(endpoint)
    base = launch_counters(engine)
    handle, _ = await register_llm(drt, ep, engine, card, stats_handler=engine.stats_handler)
    worker_id = handle.instance.instance_id
    kv_pub = KvEventPublisher(drt, namespace, component, worker_id)
    kv_pub.start()
    loop = asyncio.get_running_loop()
    # The engine raises KV events on its step thread: hop them to the loop.
    engine.set_kv_event_sink(lambda ev: kv_pub.publish_threadsafe(loop, ev))
    m_pub = WorkerMetricsPublisher(drt, namespace, component, worker_id, engine.metrics)
    m_pub.start()
    return Worker(drt, handle, [kv_pub, m_pub], base)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="dynamo-tpu worker on PyTorch/CUDA", allow_abbrev=False)
    p.add_argument("--model", default="tiny", help="model preset name")
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default=None, help="defaults to 'backend'")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--role", choices=["aggregated"], default="aggregated")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain path)")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights and of sampling")
    p.add_argument("--num-blocks", type=int, default=512)
    p.add_argument("--max-running", type=int, default=16)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--kv-cache-dtype", choices=["auto", "int8"], default="auto")
    p.add_argument("--weight-dtype", choices=["auto", "int8"], default="auto")
    p.add_argument("--draft-model", default=None,
                   help="draft model preset for speculative decoding (seeded random weights)")
    p.add_argument("--spec-gamma", type=int, default=4, help="speculative tokens proposed per round")
    p.add_argument("--warmup-ctx", type=int, default=0,
                   help="capture the step graphs for contexts up to this many tokens before serving "
                        "(0 = capture each on first use)")
    return p


def build_engine(args: argparse.Namespace) -> TorchEngine:
    tokenizer = load_tokenizer()
    engine = TorchEngine.build(
        EngineArgs(
            model=args.model,
            dtype=args.dtype,
            seed=args.seed,
            device=args.device,
            eos_token_ids=tokenizer.eos_token_ids,
            scheduler=SchedulerConfig(num_blocks=args.num_blocks, max_running=args.max_running),
            draft_model=args.draft_model,
            spec_gamma=args.spec_gamma,
            kv_cache_dtype=args.kv_cache_dtype,
            weight_dtype=args.weight_dtype,
            warmup_ctx=args.warmup_ctx,
        )
    )
    # Guided decoding lifts grammars against the tokenizer the frontend
    # detokenizes with (the card names none: the byte tokenizer).
    engine.attach_guided_tokenizer(tokenizer)
    return engine


async def amain(args: argparse.Namespace) -> None:
    engine = build_engine(args)
    drt = await DistributedRuntime.from_settings()
    drt.runtime.install_signal_handlers()
    card = ModelDeploymentCard(name=args.served_model_name or args.model, model_type="chat",
                               kv_cache_block_size=engine.scheduler.mc.block_size)
    worker = await serve_engine(drt, engine, card, namespace=args.namespace,
                                component=args.component or "backend", endpoint=args.endpoint)
    logger.info("worker ready: role=%s model=%s instance=%x", args.role, card.name, worker.instance_id)
    try:
        await drt.runtime.cancellation.cancelled()
    finally:
        await worker.stop()
        await drt.shutdown()
        await engine.stop()
        logger.info("worker launch counters: %s", json.dumps(counters_since(engine, worker.base)))


def main() -> None:
    init_logging()
    asyncio.run(amain(build_parser().parse_args()))


if __name__ == "__main__":
    main()
