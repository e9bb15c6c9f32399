"""Run the built-in control-plane broker: ``python -m dynamo_tpu_torch.control_plane``.

The KV store with leases and watches (the etcd role) and pub/sub with
durable streams and an object store (the NATS role) in one process with no
dependency, on the JAX package's protocol. Workers and frontends reach it
with ``DYN_CONTROL_PLANE=tcp DYN_CONTROL_PLANE_ADDRESS=host:port``.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from dynamo_tpu_torch.runtime.logging import init_logging
from dynamo_tpu_torch.runtime.transports.tcp_control import ControlPlaneServer


async def amain(host: str, port: int) -> None:
    server = ControlPlaneServer(host=host, port=port)
    await server.start()
    print(f"control plane ready on {server.host}:{server.port}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
    finally:
        await server.close()


def main() -> None:
    init_logging()
    parser = argparse.ArgumentParser(description="dynamo-tpu built-in control plane (etcd + NATS role)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=6650)
    args = parser.parse_args()
    asyncio.run(amain(args.host, args.port))


if __name__ == "__main__":
    main()
