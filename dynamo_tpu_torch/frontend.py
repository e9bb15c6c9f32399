"""OpenAI frontend CLI: ``python -m dynamo_tpu_torch.frontend``.

    python -m dynamo_tpu_torch.frontend --router-mode kv --http-port 8000

The counterpart of ``python -m dynamo_tpu.frontend``, with the JAX CLI's
flag names for what is ported: it watches the control plane
(``DYN_CONTROL_PLANE`` / ``DYN_CONTROL_PLANE_ADDRESS``) for models, builds
a routed pipeline (preprocessor → backend → migration → router) for each,
and serves chat and completions over HTTP until SIGINT or SIGTERM. Router
modes: ``round-robin``, ``random`` and ``kv`` (the KV-aware router over the
workers' KV events, with ``--kv-overlap-score-weight`` and
``--router-temperature``); ``--busy-threshold`` skips a worker whose
gossiped KV usage reaches it, in every mode (the JAX frontend's flag does
nothing: nothing feeds its monitor); ``--migration-limit`` replays a dropped stream
on another worker; ``--retry-*`` and ``--breaker-*`` set the router's
failure lifecycle. ``--encode-component`` sends image parts to that
component's encode workers (round robin; without it an image request is a
400); ``--tls-cert-path`` / ``--tls-key-path`` serve HTTPS (both or
neither); ``--request-timeout-ms`` is the default deadline of a request
that sends no ``timeout`` (a 504 when it expires). ``--trace-file`` /
``--trace-sample`` / ``--trace-ring`` / ``--trace-tail`` (or the
``DYN_TRACE_*`` environment) configure the process tracer, service
``frontend`` (off without them); ``--slo-ttft-ms`` / ``--slo-tpot-ms`` set
the SLO targets each request is judged against (``/metrics``' slo and
goodput families).

JAX flags whose feature is not ported are not declared, so argparse
refuses them (ROADMAP Queue 1, by item): ``--grpc-port`` (19);
``--fault-scenario`` (20). ``--kv-cache-block-size`` is not declared
either: the JAX frontend parses it and reads the block size from each
model's card, as this one does.
"""

from __future__ import annotations

import argparse
import asyncio

from dynamo_tpu_torch.llm.entrypoint import FrontendConfig, start_frontend, stop_frontend
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.logging import get_logger, init_logging
from dynamo_tpu_torch.runtime.tracing import add_trace_args, get_tracer, setup_tracing

logger = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="dynamo-tpu OpenAI frontend", allow_abbrev=False)
    p.add_argument("--http-host", default="0.0.0.0")
    p.add_argument("--http-port", type=int, default=8000)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--router-mode", choices=["round-robin", "random", "kv"], default="round-robin")
    p.add_argument("--busy-threshold", type=float, default=None, help="kv-usage above which a worker is skipped")
    p.add_argument("--migration-limit", type=int, default=0, help="max stream-drop replays per request")
    p.add_argument("--kv-overlap-score-weight", type=float, default=1.0)
    p.add_argument("--router-temperature", type=float, default=0.0)
    p.add_argument("--retry-max", type=int, default=3,
                   help="router NoInstances retries (jittered exponential backoff)")
    p.add_argument("--retry-backoff-ms", type=float, default=50.0,
                   help="base backoff between NoInstances retries")
    p.add_argument("--breaker-threshold", type=int, default=3,
                   help="consecutive stream failures that trip a worker's circuit OPEN")
    p.add_argument("--breaker-cooldown-s", type=float, default=5.0,
                   help="seconds a tripped circuit stays OPEN before one half-open probe")
    p.add_argument("--tls-cert-path", default=None, help="PEM cert: serve HTTPS")
    p.add_argument("--tls-key-path", default=None, help="PEM private key")
    p.add_argument("--encode-component", default=None,
                   help="route image content parts to this encode-worker component")
    p.add_argument("--request-timeout-ms", type=float, default=None,
                   help="default end-to-end request deadline (a client 'timeout' overrides it)")
    add_trace_args(p)
    p.add_argument("--slo-ttft-ms", type=float, default=None,
                   help="TTFT SLO target in ms (enables SLO/goodput accounting)")
    p.add_argument("--slo-tpot-ms", type=float, default=None, help="per-output-token latency SLO target in ms")
    return p


def frontend_config(args: argparse.Namespace) -> FrontendConfig:
    return FrontendConfig(
        host=args.http_host,
        port=args.http_port,
        router_mode=args.router_mode,
        busy_threshold=args.busy_threshold,
        migration_limit=args.migration_limit,
        kv_overlap_score_weight=args.kv_overlap_score_weight,
        kv_temperature=args.router_temperature,
        namespace=args.namespace,
        retry_max=args.retry_max,
        retry_backoff_base_s=args.retry_backoff_ms / 1000.0,
        breaker_threshold=args.breaker_threshold,
        breaker_cooldown_s=args.breaker_cooldown_s,
        tls_cert=args.tls_cert_path,
        tls_key=args.tls_key_path,
        encode_component=args.encode_component,
        request_timeout_ms=args.request_timeout_ms,
        slo_ttft_ms=args.slo_ttft_ms,
        slo_tpot_ms=args.slo_tpot_ms,
    )


async def amain(args: argparse.Namespace) -> None:
    drt = await DistributedRuntime.from_settings()
    drt.runtime.install_signal_handlers()
    service = await start_frontend(drt, frontend_config(args))
    # One line on stdout that a launcher can wait for (the port is the
    # bound one: --http-port 0 picks a free port).
    print(f"frontend ready on {args.http_host}:{service.port} (router={args.router_mode})", flush=True)
    try:
        await drt.runtime.cancellation.cancelled()
    finally:
        await stop_frontend(service)
        get_tracer().flush()
        await drt.shutdown()


def main() -> None:
    init_logging()
    args = build_parser().parse_args()
    setup_tracing(args, "frontend")
    asyncio.run(amain(args))


if __name__ == "__main__":
    main()
