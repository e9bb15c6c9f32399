"""DistributedRuntime: the cluster handle.

A copy of the JAX package's ``runtime/distributed.py``: it owns the KV
store and the pub/sub bus, a lazily started TCP response-plane server, the
in-process engines by instance id and the served endpoints, and keeps
leases alive. The fault-injection hook on lease keepalive
(``lease.keepalive``) is left out (ROADMAP Queue 1 item 20).

Backends:
- ``detached()``      — in-memory store and bus: one process, tests.
- ``from_settings()`` — honours ``DYN_CONTROL_PLANE``: ``mem`` or ``tcp``
  (the built-in server, ``python -m dynamo_tpu_torch.control_plane``).

A caller in the runtime that serves an endpoint takes the in-process path
(``local_engines``) and never touches the wire: give each role a runtime
of its own to exercise it.
"""

from __future__ import annotations

import asyncio
from typing import Dict, List, Optional

from dynamo_tpu_torch.runtime.component import Namespace, ServeHandle
from dynamo_tpu_torch.runtime.config import Config
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.runtime import Runtime
from dynamo_tpu_torch.runtime.transports.kvstore import KvStore, Lease, MemKvStore
from dynamo_tpu_torch.runtime.transports.pubsub import MemPubSub, PubSub
from dynamo_tpu_torch.runtime.transports.tcp import TcpStreamServer

logger = get_logger(__name__)


class DistributedRuntime:
    def __init__(
        self,
        runtime: Optional[Runtime] = None,
        store: Optional[KvStore] = None,
        bus: Optional[PubSub] = None,
        *,
        advertise_host: str = "127.0.0.1",
    ):
        self.runtime = runtime or Runtime()
        self.config: Config = self.runtime.config
        self.store = store if store is not None else MemKvStore()
        self.bus = bus if bus is not None else MemPubSub()
        self._tcp_server = TcpStreamServer(advertise_host=advertise_host)
        self._tcp_started = False
        # In-process engines by instance id — the local fast path registry.
        self.local_engines: Dict[int, AsyncEngine] = {}
        self.serve_handles: List[ServeHandle] = []
        self._closed = False

    # --- constructors -------------------------------------------------------
    @classmethod
    async def detached(cls, runtime: Optional[Runtime] = None) -> "DistributedRuntime":
        """Single-process runtime with an in-memory control plane."""
        drt = cls(runtime=runtime)
        await drt.start()
        return drt

    @classmethod
    async def from_settings(cls, runtime: Optional[Runtime] = None) -> "DistributedRuntime":
        runtime = runtime or Runtime()
        backend = runtime.config.control_plane.backend
        if backend == "mem":
            return await cls.detached(runtime)
        if backend == "tcp":
            from dynamo_tpu_torch.runtime.transports.tcp_control import TcpKvStore, TcpPubSub, connect_control_plane

            conn = await connect_control_plane(runtime.config.control_plane.address)
            drt = cls(runtime=runtime, store=TcpKvStore(conn), bus=TcpPubSub(conn))
            await drt.start()
            return drt
        raise ValueError(f"unknown control plane backend: {backend}")

    async def start(self) -> None:
        if not self._tcp_started:
            await self._tcp_server.start()
            self._tcp_started = True

    # --- component model ----------------------------------------------------
    def namespace(self, name: Optional[str] = None) -> Namespace:
        return Namespace(self, name or self.config.namespace)

    def tcp_server_handle(self) -> TcpStreamServer:
        assert self._tcp_started, "DistributedRuntime not started"
        return self._tcp_server

    # --- leases -------------------------------------------------------------
    def spawn_lease_keepalive(self, lease: Lease) -> None:
        """Keep a lease alive at ttl/3 cadence until revoked."""

        async def keepalive():
            interval = max(lease.ttl_s / 3.0, 0.1)
            try:
                while not lease.revoked:
                    await asyncio.sleep(interval)
                    if lease.revoked:
                        return
                    try:
                        await self.store.keep_alive(lease.id)
                    except Exception:
                        logger.warning("lease %x keepalive failed", lease.id)
                        return
            except asyncio.CancelledError:
                pass

        self.runtime.spawn(keepalive(), name=f"lease-keepalive-{lease.id:x}")

    # --- shutdown -----------------------------------------------------------
    async def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        for handle in list(self.serve_handles):
            try:
                await handle.stop()
            except Exception:
                logger.exception("error stopping endpoint %s", handle.instance.etcd_key)
        await self.runtime.shutdown()
        await self._tcp_server.close()
        await self.bus.close()
        await self.store.close()
