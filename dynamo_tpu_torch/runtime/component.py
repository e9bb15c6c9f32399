"""Namespace → Component → Endpoint hierarchy with lease-bound discovery.

A copy of the JAX package's ``runtime/component.py``, with the same keys
and subjects, so either package's routers reach either package's workers:
- instance key   ``instances/{ns}/{comp}/{ep}:{lease_id:x}`` → Instance JSON,
  bound to the worker's lease (lease lapse ⇒ key vanishes ⇒ routers prune);
- request subject ``rq.{ns}.{comp}.{ep}.{lease_id:x}``, one per instance:
  the push router publishes requests here with TCP call-home info;
- control subject ``ctl.{ns}.{comp}.{ep}.{lease_id:x}``: cancel, kill and
  the capacity dial's ``set_dial`` (applied, and answered with the applied
  values when the message has a reply subject);
- stats subject   ``stats.{ns}.{comp}.{ep}.{lease_id:x}``: request/reply
  stats scrape.
A served request opens the ``worker_handle`` span on the caller's trace
(its ``traceparent``), and the engine's events parent under it. Left out:
the fault-injection hooks (``stats.reply``, ``worker.frame``, ROADMAP Queue
1 item 20).
"""

from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass
from typing import Any, AsyncIterator, Callable, Dict, Optional, TYPE_CHECKING

from dynamo_tpu_torch.runtime import msgpack_codec as msgpack
from dynamo_tpu_torch.runtime.engine import Annotated, AsyncEngine, Context
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.tracing import NULL_SPAN, get_tracer
from dynamo_tpu_torch.runtime.transports.tcp import ConnectionInfo, TcpCallHome

if TYPE_CHECKING:
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

logger = get_logger(__name__)

INSTANCE_ROOT = "instances"


def sanitize(token: str) -> str:
    return token.replace(".", "_").replace("/", "_")


@dataclass(frozen=True)
class Instance:
    """A live endpoint instance."""

    namespace: str
    component: str
    endpoint: str
    instance_id: int  # the lease id

    @property
    def etcd_key(self) -> str:
        return f"{INSTANCE_ROOT}/{self.namespace}/{self.component}/{self.endpoint}:{self.instance_id:x}"

    @property
    def subject(self) -> str:
        return f"rq.{sanitize(self.namespace)}.{sanitize(self.component)}.{sanitize(self.endpoint)}.{self.instance_id:x}"

    @property
    def control_subject(self) -> str:
        return f"ctl.{sanitize(self.namespace)}.{sanitize(self.component)}.{sanitize(self.endpoint)}.{self.instance_id:x}"

    @property
    def stats_subject(self) -> str:
        return f"stats.{sanitize(self.namespace)}.{sanitize(self.component)}.{sanitize(self.endpoint)}.{self.instance_id:x}"

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "namespace": self.namespace,
                "component": self.component,
                "endpoint": self.endpoint,
                "instance_id": self.instance_id,
            }
        ).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "Instance":
        d = json.loads(raw)
        return cls(
            namespace=d["namespace"],
            component=d["component"],
            endpoint=d["endpoint"],
            instance_id=int(d["instance_id"]),
        )


class Namespace:
    def __init__(self, drt: "DistributedRuntime", name: str):
        self.drt = drt
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self.drt, self.name, name)


class Component:
    def __init__(self, drt: "DistributedRuntime", namespace: str, name: str):
        self.drt = drt
        self.namespace = namespace
        self.name = name

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self.drt, self.namespace, self.name, name)

    @property
    def instance_prefix(self) -> str:
        return f"{INSTANCE_ROOT}/{self.namespace}/{self.name}/"


class ServeHandle:
    """A running endpoint instance: owns the lease keepalive + ingress loop."""

    def __init__(self, endpoint: "Endpoint", instance: Instance, lease, tasks,
                 ingress: Optional["_PushEndpoint"] = None):
        self.endpoint = endpoint
        self.instance = instance
        self.lease = lease
        self._tasks = tasks
        self._ingress = ingress
        self._stopped = False

    @property
    def draining(self) -> bool:
        return self._ingress.draining if self._ingress is not None else False

    async def stop(self, *, drain: bool = True, timeout_s: Optional[float] = None) -> None:
        """The drain lifecycle (the SIGTERM path):

        1. deregister from discovery — routers prune within one watch
           delivery and stop sending;
        2. stop admitting — requests already queued on the pub/sub subject
           are answered with a disconnect error, which the client's
           Migration operator replays on a surviving worker;
        3. finish in-flight work within ``timeout_s`` (default
           ``shutdown_timeout_s``) — on timeout the remaining streams are
           severed (task cancel drops the call-home sockets without a
           final frame), which *migrates* them instead of finishing them;
        4. revoke the lease.

        The wait is scoped to THIS instance's in-flight requests: in a
        multi-worker process (autoscaled mocker fleets, demo stacks) the
        runtime-global shutdown tracker never reaches zero under sustained
        fleet traffic, which turned every one-worker scale-down drain into
        a guaranteed full-timeout stall.
        """
        if self._stopped:
            return
        self._stopped = True
        drt = self.endpoint.drt
        timeout = (
            timeout_s if timeout_s is not None
            else drt.runtime.config.runtime.shutdown_timeout_s
        )
        # Deregister first so routers stop sending, then drain, then drop tasks.
        await drt.store.delete(self.instance.etcd_key)
        drt.local_engines.pop(self.instance.instance_id, None)
        if drain:
            if self._ingress is not None:
                self._ingress.begin_drain()
                drained = await self._ingress.wait_drained(timeout)
            else:
                drained = await drt.runtime.shutdown_tracker.wait_drained(timeout)
            if not drained:
                logger.warning(
                    "drain of %x timed out with %d in-flight; severing streams "
                    "(clients will migrate)",
                    self.instance.instance_id,
                    len(self._ingress.in_flight) if self._ingress is not None
                    else drt.runtime.shutdown_tracker.in_flight,
                )
                if self._ingress is not None:
                    await self._ingress.sever()
            if self._ingress is not None:
                self._ingress.finish_drain()
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        await self.lease.revoke()


class Endpoint:
    """An addressable unit of work."""

    def __init__(self, drt: "DistributedRuntime", namespace: str, component: str, name: str):
        self.drt = drt
        self.namespace = namespace
        self.component = component
        self.name = name

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.component}/{self.name}"

    @property
    def instance_prefix(self) -> str:
        return f"{INSTANCE_ROOT}/{self.namespace}/{self.component}/{self.name}:"

    async def client(self, **kwargs) -> "Client":
        from dynamo_tpu_torch.runtime.client import Client

        client = Client(self)
        await client.start(**kwargs)
        return client

    async def serve_endpoint(
        self,
        handler: AsyncEngine | Callable[[Any, Context], AsyncIterator[Any]],
        *,
        stats_handler: Optional[Callable[[], dict]] = None,
        graceful_shutdown: bool = True,
        lease_ttl_s: Optional[float] = None,
    ) -> ServeHandle:
        """Register and serve this endpoint.

        ``handler`` is an AsyncEngine or a bare async-generator function
        ``(request, context) -> AsyncIterator``.
        """
        drt = self.drt
        engine = handler if isinstance(handler, AsyncEngine) else _FnEngine(handler)
        ttl = lease_ttl_s if lease_ttl_s is not None else drt.config.control_plane.lease_ttl_s
        lease = await drt.store.grant_lease(ttl)
        drt.spawn_lease_keepalive(lease)
        instance = Instance(self.namespace, self.component, self.name, lease.id)

        ingress = _PushEndpoint(drt, instance, engine, graceful_shutdown=graceful_shutdown)
        tasks = await ingress.start(stats_handler=stats_handler)

        # In-process fast path: callers in this process bypass pub/sub + TCP.
        drt.local_engines[instance.instance_id] = engine

        # Register last: the instance only becomes routable once it can serve.
        await drt.store.put(instance.etcd_key, instance.to_json(), lease_id=lease.id)
        logger.info("serving endpoint %s as instance %x", self.path, lease.id)
        handle = ServeHandle(self, instance, lease, tasks, ingress=ingress)
        drt.serve_handles.append(handle)
        return handle


class _FnEngine:
    def __init__(self, fn):
        self._fn = fn

    def generate(self, request, context):
        return self._fn(request, context)


class _PushEndpoint:
    """Worker-side ingress loop: consumes pushed requests, runs the handler,
    streams responses back over the TCP call-home channel."""

    def __init__(self, drt: "DistributedRuntime", instance: Instance, engine: AsyncEngine, graceful_shutdown: bool):
        self.drt = drt
        self.instance = instance
        self.engine = engine
        self.graceful_shutdown = graceful_shutdown
        self.in_flight: Dict[str, Context] = {}
        # Drain lifecycle: while draining, newly pushed requests are
        # answered with a disconnect error (the client migrates) instead of
        # being admitted. drains_total counts completed drains (0 or 1 for
        # a worker process; scrape-visible while the drain runs).
        self.draining = False
        self.drains_total = 0

        self._request_tasks: set = set()

    def begin_drain(self) -> None:
        self.draining = True
        logger.info("instance %x draining: rejecting new work, %d in-flight",
                    self.instance.instance_id, len(self.in_flight))

    def finish_drain(self) -> None:
        self.drains_total += 1

    async def wait_drained(self, timeout: Optional[float] = None) -> bool:
        """Wait for THIS instance's in-flight handlers to finish. Scoped to
        the instance (not the runtime-global shutdown tracker) so a
        one-worker drain in a multi-worker process completes as soon as
        *its* streams end, however busy the rest of the fleet is."""
        deadline = None if timeout is None else asyncio.get_running_loop().time() + timeout
        while self._request_tasks:
            remaining = None
            if deadline is not None:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    return False
            _, pending = await asyncio.wait(set(self._request_tasks), timeout=remaining)
            if pending:
                return False
        return True

    async def sever(self) -> None:
        """Cancel the remaining in-flight handler tasks: each drops its
        call-home socket without a final frame, so the client observes a
        genuine StreamDisconnect and its Migration operator replays the
        request on a surviving worker."""
        tasks = list(self._request_tasks)
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)

    async def start(self, stats_handler=None) -> list:
        sub = await self.drt.bus.subscribe(self.instance.subject)
        ctl = await self.drt.bus.subscribe(self.instance.control_subject)
        stats_sub = await self.drt.bus.subscribe(self.instance.stats_subject)
        loop = asyncio.get_running_loop()
        tasks = [
            loop.create_task(self._ingress_loop(sub), name=f"ingress-{self.instance.instance_id:x}"),
            loop.create_task(self._control_loop(ctl), name=f"ctl-{self.instance.instance_id:x}"),
            loop.create_task(self._stats_loop(stats_sub, stats_handler), name=f"stats-{self.instance.instance_id:x}"),
        ]
        return tasks

    async def _ingress_loop(self, sub) -> None:
        async for msg in sub:
            try:
                payload = msgpack.unpackb(msg.data)
            except Exception:
                # A malformed message must never kill the ingress loop — the
                # instance would stay registered but unreachable.
                logger.warning("dropping malformed request on %s", self.instance.subject)
                continue
            handler = self._reject_draining if self.draining else self._handle
            task = asyncio.get_running_loop().create_task(handler(payload))
            # Hold a strong reference: the loop keeps only weak refs to tasks.
            self._request_tasks.add(task)
            task.add_done_callback(self._request_tasks.discard)

    async def _reject_draining(self, payload: dict) -> None:
        """A request raced the drain (queued on the subject before the
        deregistration propagated): answer with a disconnect error so the
        caller's Migration operator replays it on a surviving worker."""
        conn = payload.get("conn")
        try:
            call_home = TcpCallHome(ConnectionInfo.from_dict(conn))
            if await call_home.connect():
                await call_home.error("worker draining", disconnect=True)
                await call_home.close()
        except (ConnectionError, TypeError, KeyError):
            pass  # caller is gone or the payload is malformed — nothing to do

    async def _control_loop(self, sub) -> None:
        async for msg in sub:
            try:
                payload = msgpack.unpackb(msg.data)
            except Exception:
                continue
            op = payload.get("op")
            if op == "set_dial":
                # Elastic capacity dial: re-split this worker's prefill vs
                # decode budget live (engine.set_capacity_dial → scheduler).
                # Ack over reply_to when the caller wants the applied values.
                dial = getattr(self.engine, "set_capacity_dial", None)
                if dial is None:
                    logger.warning("set_dial received but engine exposes no capacity dial")
                    continue
                try:
                    applied = dial(float(payload.get("prefill_fraction", 0.5)))
                    logger.info("set_dial applied on %s: %s", self.instance.endpoint, applied)
                except Exception as e:
                    logger.exception("set_dial failed")
                    applied = {"error": str(e)}
                if msg.reply_to:
                    await self.drt.bus.publish(msg.reply_to, msgpack.packb(applied))
                continue
            if op in ("cancel", "kill"):
                ctx = self.in_flight.get(payload.get("request_id", ""))
                if ctx is not None:
                    logger.info("%s received for request %s", op, payload.get("request_id"))
                    if op == "kill":
                        # Hard abandon: the handler breaks out mid-stream.
                        ctx.kill()
                    else:
                        # Graceful: the engine aborts the sequence, frees
                        # its KV, and closes the stream with a final
                        # finish_reason="cancelled" frame — the client
                        # observes a clean end, not an error.
                        ctx.stop_generating()

    async def _stats_loop(self, sub, stats_handler) -> None:
        async for msg in sub:
            if msg.reply_to:
                data = {
                    "in_flight": len(self.in_flight),
                    # Drain lifecycle: visible on the scrape while it runs.
                    "draining": 1.0 if self.draining else 0.0,
                    "worker_drains_total": self.drains_total,
                }
                if stats_handler is not None:
                    try:
                        data.update(stats_handler() or {})
                    except Exception as e:  # stats must never break serving
                        data["stats_error"] = str(e)
                await self.drt.bus.publish(msg.reply_to, msgpack.packb(data))

    async def _handle(self, payload: dict) -> None:
        ctx = Context.from_wire(payload.get("ctx", {}))
        conn = payload.get("conn")
        request = payload.get("request")
        self.in_flight[ctx.id] = ctx
        # The worker's hop span continues the caller's trace, and the
        # context is re-rooted under it so the engine's events parent here.
        span = get_tracer().span_from(
            "worker_handle", ctx.traceparent, service="worker", endpoint=self.instance.endpoint,
            instance=f"{self.instance.instance_id:x}", request_id=ctx.id,
        )
        if span is not NULL_SPAN:
            ctx.traceparent = span.child_traceparent()
        tracker = self.drt.runtime.shutdown_tracker
        if self.graceful_shutdown:
            tracker.enter()
        call_home: Optional[TcpCallHome] = None
        try:
            call_home = TcpCallHome(ConnectionInfo.from_dict(conn))
            ok = await call_home.connect()
            if not ok:
                return  # caller is gone; drop the request
            try:
                async for item in self.engine.generate(request, ctx):
                    if ctx.is_killed():
                        break
                    wire = item.to_wire() if isinstance(item, Annotated) else {"data": item}
                    await call_home.send(wire)
                if ctx.is_killed():
                    await call_home.error("request cancelled")
                else:
                    await call_home.complete()
            except ConnectionError:
                # Engine/infrastructure death (the EngineDeadError class of
                # failure): drop the socket without a final frame so the
                # caller observes a genuine stream disconnect and the
                # Migration operator can replay elsewhere.
                logger.warning("engine connection failure for request %s; dropping stream", ctx.id)
            except Exception as e:
                logger.exception("handler error for request %s", ctx.id)
                try:
                    await call_home.error(f"{type(e).__name__}: {e}")
                except Exception:
                    pass
        except ConnectionError:
            logger.warning("call-home connection failed for request %s", ctx.id)
        finally:
            span.end()
            if call_home is not None:
                await call_home.close()
            self.in_flight.pop(ctx.id, None)
            if self.graceful_shutdown:
                tracker.exit()
