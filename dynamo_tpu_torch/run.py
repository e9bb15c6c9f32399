"""Single-command launcher: ``python -m dynamo_tpu_torch.run in=X out=Y``.

- ``in=http`` serves the OpenAI HTTP surface until SIGINT or SIGTERM
  (chat, completions and ``/v1/responses``, and ``/v1/embeddings`` over
  the same weights for a llama-family ``out=<preset>``);
  ``in=text`` chats on stdin (one user message a line, the answer streamed
  to stdout; end with ctrl-d); ``in=batch:<prompts.jsonl>`` sends each
  record's ``prompt`` (or ``text``) as a completion of its ``max_tokens``
  (default ``--max-tokens``), one request at a time, and writes
  ``{"prompt", "output"}`` lines to ``--output`` (default results.jsonl).
- ``out=<preset>`` builds the engine on the card (``--device cuda``, the
  default, raises without CUDA) behind preprocessor → backend
  (detokenizer) → engine. The model runs on the weights of
  ``--checkpoint`` (a safetensors directory or a GGUF file) at the preset's
  widths, or on seeded random weights without one. ``out=dyn://ns.comp.ep``
  sends the requests to that endpoint's workers through a push router
  (round robin) over the control plane named by ``DYN_CONTROL_PLANE`` /
  ``DYN_CONTROL_PLANE_ADDRESS``, waiting ``--timeout`` seconds for one.
  ``out=mocker`` waits for the mocker (ROADMAP Queue 1 item 20).
- ``--tokenizer`` names a ``tokenizer.json`` (or its directory), else the
  byte-level tokenizer serves; ``--model-name`` names the model (default:
  the ``out=`` value). ``--temperature`` sets the text and batch requests'
  temperature (the JAX ``run`` sends none, and neither does this one
  without it).

Example:
  python -m dynamo_tpu_torch.run in=http out=llama-3.2-1b --checkpoint DIR --tokenizer DIR
  python -m dynamo_tpu_torch.run in=http out=llama-3.2-1b --http-port 8080
  python -m dynamo_tpu_torch.run in=http out=llama-3.2-3b --draft-model llama-3.2-1b
  python -m dynamo_tpu_torch.run in=http out=llama-3.2-1b --kv-cache-dtype int8 --weight-dtype int8
  python -m dynamo_tpu_torch.run in=text out=llama-3.2-1b
  python -m dynamo_tpu_torch.run in=batch:prompts.jsonl out=llama-3.2-1b --output results.jsonl
  python -m dynamo_tpu_torch.run in=http out=dyn://dynamo.backend.generate
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import logging
import signal
from typing import List, Optional, Tuple

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.engine.embeddings import EmbeddingEngine
from dynamo_tpu_torch.llm.entrypoint import RouterEngine, build_embeddings_pipeline, build_local_pipeline
from dynamo_tpu_torch.llm.discovery import ModelManager
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.tokenizer import load_tokenizer
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.push_router import PushRouter

logger = logging.getLogger(__name__)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="dynamo-run on PyTorch/CUDA", allow_abbrev=False)
    p.add_argument("io", nargs=2, help="in=http|text|batch:<file> out=<model preset>|dyn://ns.comp.ep")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs the plain path)")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--num-blocks", type=int, default=2048, help="KV cache blocks (block 0 is scratch)")
    p.add_argument("--http-host", default="0.0.0.0")
    p.add_argument("--http-port", type=int, default=8080)
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights and of sampling")
    p.add_argument("--checkpoint", default=None,
                   help="weights: a safetensors directory or a GGUF file (default: seeded random weights)")
    p.add_argument("--tokenizer", default=None,
                   help="a tokenizer.json or its directory (default: the byte-level tokenizer)")
    p.add_argument("--draft-model", default=None,
                   help="draft model preset for speculative decoding")
    p.add_argument("--draft-checkpoint", default=None,
                   help="the draft's weights (default: seeded random weights)")
    p.add_argument("--spec-gamma", type=int, default=4, help="speculative tokens proposed per round")
    p.add_argument("--kv-cache-dtype", choices=["auto", "int8"], default="auto",
                   help="int8 stores the KV cache as codes and per-(token, head) scales: twice the blocks per byte")
    p.add_argument("--weight-dtype", choices=["auto", "int8"], default="auto",
                   help="int8 stores the layer matmul weights quantized (about half the resident weights)")
    p.add_argument("--warmup-ctx", type=int, default=0,
                   help="capture the step graphs for contexts up to this many tokens before serving "
                        "(0 = capture each on first use)")
    p.add_argument("--model-name", default=None, help="the served model's name (default: the out= value)")
    p.add_argument("--max-tokens", type=int, default=128, help="text and batch requests' max_tokens")
    p.add_argument("--temperature", type=float, default=None,
                   help="text and batch requests' temperature (default: none sent)")
    p.add_argument("--output", default=None, help="in=batch's results file (default results.jsonl)")
    p.add_argument("--timeout", type=float, default=30.0, help="out=dyn://: seconds to wait for a worker")
    args = p.parse_args(argv)
    spec = dict(part.partition("=")[::2] for part in args.io)
    if "in" not in spec or not spec.get("out"):
        p.error("expected in=... out=...")
    args.mode, args.out = spec["in"], spec["out"]
    if args.mode not in ("http", "text") and not args.mode.startswith("batch:"):
        p.error(f"in={args.mode}: expected in=http, in=text or in=batch:<prompts.jsonl>")
    if args.out == "mocker":
        p.error("out=mocker: the mocker is not ported yet (ROADMAP Queue 1 item 20)")
    return args


def build_service(
    args: argparse.Namespace,
    model_config: Optional[ModelConfig] = None,
    scheduler_config: Optional[SchedulerConfig] = None,
    draft_params=None,
    params=None,
) -> Tuple[HttpService, TorchEngine]:
    """The engine on ``args.device`` and the HTTP service over its pipeline
    (not started). ``model_config`` replaces the preset ``args.out`` names,
    e.g. ``get_config(name).replace(attention_impl="paged",
    prefill_impl="flash")`` for the per-piece attention path.
    ``scheduler_config`` replaces the scheduler's defaults, e.g.
    ``SchedulerConfig(num_scheduler_steps=1)`` for one decode step per
    iteration; its ``num_blocks`` is set from ``--num-blocks``. ``params``
    gives the model its weights in place of ``--checkpoint``'s. With
    ``--draft-model`` the engine speculates; ``draft_params`` gives the
    draft its weights in place of ``--draft-checkpoint``'s (e.g. the
    target's own, for self-speculation)."""
    tokenizer = load_tokenizer(args.tokenizer)
    engine = TorchEngine.build(
        EngineArgs(
            model=args.out,
            model_config=model_config,
            dtype=args.dtype,
            seed=args.seed,
            device=args.device,
            checkpoint_path=args.checkpoint,
            eos_token_ids=tokenizer.eos_token_ids,
            scheduler=dataclasses.replace(scheduler_config or SchedulerConfig(), num_blocks=args.num_blocks),
            draft_model=args.draft_model,
            draft_checkpoint_path=args.draft_checkpoint,
            spec_gamma=args.spec_gamma,
            kv_cache_dtype=args.kv_cache_dtype,
            weight_dtype=args.weight_dtype,
            warmup_ctx=args.warmup_ctx,
        ),
        params=params,
        draft_params=draft_params,
    )
    manager = ModelManager()
    manager.add_model("chat", model_name(args), build_local_pipeline(tokenizer, engine))
    sched = engine.scheduler
    if sched.mc.architecture == "llama":
        # /v1/embeddings over the same weights (llama.embed; MLA has none).
        manager.add_model("embeddings", model_name(args),
                          build_embeddings_pipeline(tokenizer, EmbeddingEngine(sched.mc, sched.params)))
    return HttpService(manager, host=args.http_host, port=args.http_port), engine


def model_name(args: argparse.Namespace) -> str:
    return args.model_name or args.out


async def remote_service(args: argparse.Namespace, drt: DistributedRuntime) -> Tuple[HttpService, PushRouter]:
    """``out=dyn://ns.comp.ep``: the HTTP service (not started) over a push
    router to that endpoint's workers, once one is up."""
    ns, comp, ep = args.out[len("dyn://"):].split(".")
    client = await drt.namespace(ns).component(comp).endpoint(ep).client()
    await client.wait_for_instances(1, timeout=args.timeout)
    router = PushRouter(client)
    manager = ModelManager()
    manager.add_model("chat", model_name(args), build_local_pipeline(load_tokenizer(args.tokenizer),
                                                                     RouterEngine(router)))
    return HttpService(manager, host=args.http_host, port=args.http_port), router


async def _texts(pipeline, body: dict):
    """The answer's text pieces, as the pipeline streams them."""
    async for item in pipeline.generate(body, Context()):
        data = item.data if hasattr(item, "data") else item
        if data and data.get("text"):
            yield data["text"]


def _sampling(args: argparse.Namespace) -> dict:
    return {} if args.temperature is None else {"temperature": args.temperature}


async def chat_stdin(args: argparse.Namespace, pipeline) -> None:
    """``in=text``: one user message a line of stdin, each answer streamed
    to stdout, until end of input."""
    print(f"interactive chat with {model_name(args)}; ctrl-d to exit")
    loop = asyncio.get_running_loop()
    while True:
        try:
            line = await loop.run_in_executor(None, lambda: input("> "))
        except (EOFError, KeyboardInterrupt):
            break
        body = {"model": model_name(args), "messages": [{"role": "user", "content": line}],
                "max_tokens": args.max_tokens, **_sampling(args)}
        async for text in _texts(pipeline, body):
            print(text, end="", flush=True)
        print()


async def run_batch(args: argparse.Namespace, pipeline) -> str:
    """``in=batch:<file>``: each record's ``prompt`` (or ``text``) as a
    completion, one at a time; ``{"prompt", "output"}`` lines to the
    output file, whose path it returns."""
    path = args.mode.split(":", 1)[1]
    out_path = args.output or "results.jsonl"
    with open(path) as f, open(out_path, "w") as out_f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            body = {"model": model_name(args), "prompt": rec.get("prompt") or rec.get("text", ""),
                    "max_tokens": rec.get("max_tokens", args.max_tokens), **_sampling(args)}
            parts = [text async for text in _texts(pipeline, body)]
            out_f.write(json.dumps({"prompt": body["prompt"], "output": "".join(parts)}) + "\n")
    print(f"batch results written to {out_path}")
    return out_path


async def amain(args: argparse.Namespace) -> None:
    drt = engine = router = None
    if args.out.startswith("dyn://"):
        drt = await DistributedRuntime.from_settings()
        service, router = await remote_service(args, drt)
    else:
        service, engine = build_service(args)
    try:
        if args.mode == "http":
            await service.start()
            print(f"serving {model_name(args)} on :{service.port} (POST /v1/chat/completions)", flush=True)
            stop = asyncio.Event()
            loop = asyncio.get_running_loop()
            for sig in (signal.SIGINT, signal.SIGTERM):
                loop.add_signal_handler(sig, stop.set)
            try:
                await stop.wait()
            finally:
                await service.stop()
        else:
            pipeline = service.manager.get("chat", model_name(args))
            if args.mode == "text":
                await chat_stdin(args, pipeline)
            else:
                await run_batch(args, pipeline)
    finally:
        if engine is not None:
            await engine.stop()
        if router is not None:
            await router.close()
            await router.client.close()
        if drt is not None:
            await drt.shutdown()


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    asyncio.run(amain(parse_args(argv)))


if __name__ == "__main__":
    main()
