"""Single-process launcher: ``python -m dynamo_tpu_torch.run in=http out=<preset>``.

Builds the engine on the card, wraps it in preprocessor → backend
(detokenizer) → engine, and serves the OpenAI HTTP surface until SIGINT or
SIGTERM. The model runs on seeded random weights at the preset's published
widths (checkpoint loading is not ported yet), with the byte-level
tokenizer.

Example:
  python -m dynamo_tpu_torch.run in=http out=llama-3.2-1b --http-port 8080
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
from typing import List, Optional, Tuple

from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.llm.entrypoint import build_local_pipeline
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
    args = p.parse_args(argv)
    spec = dict(part.partition("=")[::2] for part in args.io)
    if spec.get("in") != "http" or not spec.get("out"):
        p.error("expected in=http out=<model preset>")
    args.out = spec["out"]
    return args


def build_service(args: argparse.Namespace) -> Tuple[HttpService, TorchEngine]:
    """The engine on ``args.device`` and the HTTP service over its pipeline
    (not started)."""
    tokenizer = load_tokenizer()
    engine = TorchEngine.build(
        EngineArgs(
            model=args.out,
            dtype=args.dtype,
            seed=args.seed,
            device=args.device,
            eos_token_ids=tokenizer.eos_token_ids,
            scheduler=SchedulerConfig(num_blocks=args.num_blocks),
        )
    )
    pipeline = build_local_pipeline(tokenizer, engine)
    return HttpService({args.out: pipeline}, host=args.http_host, port=args.http_port), engine


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
