"""Single-process launcher: ``python -m dynamo_tpu_torch.run in=http out=<preset>``.

Builds the engine on the card, wraps it in preprocessor → backend
(detokenizer) → engine, and serves the OpenAI HTTP surface until SIGINT or
SIGTERM. The model runs on seeded random weights at the preset's published
widths (checkpoint loading is not ported yet), with the byte-level
tokenizer.

Example:
  python -m dynamo_tpu_torch.run in=http out=llama-3.2-1b --http-port 8080
  python -m dynamo_tpu_torch.run in=http out=llama-3.2-3b --draft-model llama-3.2-1b
  python -m dynamo_tpu_torch.run in=http out=llama-3.2-1b --kv-cache-dtype int8 --weight-dtype int8
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import signal
from typing import List, Optional, Tuple

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.llm.entrypoint import build_local_pipeline
from dynamo_tpu_torch.llm.discovery import ModelManager
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.tokenizer import load_tokenizer

logger = logging.getLogger(__name__)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="dynamo-run on PyTorch/CUDA", allow_abbrev=False)
    p.add_argument("io", nargs=2, help="in=http out=<model preset>")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain path)")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--num-blocks", type=int, default=2048, help="KV cache blocks (block 0 is scratch)")
    p.add_argument("--http-host", default="0.0.0.0")
    p.add_argument("--http-port", type=int, default=8080)
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights and of sampling")
    p.add_argument("--draft-model", default=None,
                   help="draft model preset for speculative decoding (seeded random weights)")
    p.add_argument("--spec-gamma", type=int, default=4, help="speculative tokens proposed per round")
    p.add_argument("--kv-cache-dtype", choices=["auto", "int8"], default="auto",
                   help="int8 stores the KV cache as codes and per-(token, head) scales: twice the blocks per byte")
    p.add_argument("--weight-dtype", choices=["auto", "int8"], default="auto",
                   help="int8 stores the layer matmul weights quantized (about half the resident weights)")
    p.add_argument("--warmup-ctx", type=int, default=0,
                   help="capture the step graphs for contexts up to this many tokens before serving "
                        "(0 = capture each on first use)")
    args = p.parse_args(argv)
    spec = dict(part.partition("=")[::2] for part in args.io)
    if spec.get("in") != "http" or not spec.get("out"):
        p.error("expected in=http out=<model preset>")
    args.out = spec["out"]
    return args


def build_service(
    args: argparse.Namespace,
    model_config: Optional[ModelConfig] = None,
    scheduler_config: Optional[SchedulerConfig] = None,
    draft_params=None,
) -> Tuple[HttpService, TorchEngine]:
    """The engine on ``args.device`` and the HTTP service over its pipeline
    (not started). ``model_config`` replaces the preset ``args.out`` names,
    e.g. ``get_config(name).replace(attention_impl="paged",
    prefill_impl="flash")`` for the per-piece attention path.
    ``scheduler_config`` replaces the scheduler's defaults, e.g.
    ``SchedulerConfig(num_scheduler_steps=1)`` for one decode step per
    iteration; its ``num_blocks`` is set from ``--num-blocks``. With
    ``--draft-model`` the engine speculates; ``draft_params`` gives the
    draft its weights (e.g. the target's own, for self-speculation)."""
    tokenizer = load_tokenizer()
    engine = TorchEngine.build(
        EngineArgs(
            model=args.out,
            model_config=model_config,
            dtype=args.dtype,
            seed=args.seed,
            device=args.device,
            eos_token_ids=tokenizer.eos_token_ids,
            scheduler=dataclasses.replace(scheduler_config or SchedulerConfig(), num_blocks=args.num_blocks),
            draft_model=args.draft_model,
            spec_gamma=args.spec_gamma,
            kv_cache_dtype=args.kv_cache_dtype,
            weight_dtype=args.weight_dtype,
            warmup_ctx=args.warmup_ctx,
        ),
        draft_params=draft_params,
    )
    manager = ModelManager()
    manager.add_model("chat", args.out, build_local_pipeline(tokenizer, engine))
    return HttpService(manager, host=args.http_host, port=args.http_port), engine


async def amain(args: argparse.Namespace) -> None:
    service, engine = build_service(args)
    await service.start()
    print(f"serving {args.out} on :{service.port} (POST /v1/chat/completions)", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
    finally:
        await service.stop()
        await engine.stop()


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    asyncio.run(amain(parse_args(argv)))


if __name__ == "__main__":
    main()
