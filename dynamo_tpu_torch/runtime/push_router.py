"""Client-side request routing over live instances.

A copy of the JAX package's ``runtime/push_router.py``: round-robin, random
and direct modes (the KV mode is ``llm/kv_router``'s ``KvPushRouter``,
which direct-routes to the worker its scheduler picks) and busy-threshold
gating; the request is published over pub/sub with TCP call-home info and
its response frames come back over TCP. The failure lifecycle:
- **Retry budget**: ``NoInstancesError`` (no instance, e.g. during a rolling
  restart) is retried with jittered exponential backoff up to
  ``RetryPolicy.max_retries`` before it surfaces.
- **Circuit breaker**: a worker whose streams keep dying trips OPEN and is
  skipped for ``cooldown_s``; then one HALF-OPEN probe goes through, and
  success closes the circuit, failure re-opens it.
- **Prompt cancellation**: a watcher task publishes the cancel op the
  moment the request's context stops.
- **Re-dispatch**: a request published to an instance that leaves
  discovery before its worker calls home was taken by nobody (the worker
  died, and a migrating replay may pick it while its lease is still being
  revoked). ``InstanceGone`` ends the wait, and the request goes to
  another instance; it is no migration, as nothing was streamed. The JAX
  router waits for such a call home without end.
The breaker's ``on_transition`` hook sets the ``circuit_open{worker}``
gauge (1 open, 0.5 half-open, 0 closed) on the router's ``metrics``
registry, and every dispatch is a ``route`` event on the request's trace.
The last 64 routing decisions (``decisions``) and the breaker's state are
the ``router:<endpoint>`` evidence probe of ``runtime/incidents.py``, which
every incident bundle of the process carries ("what was sent where just
before a worker was lost").
"""

from __future__ import annotations

import asyncio
import collections
import enum
import json
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, AsyncIterator, Dict, Optional, Set

from dynamo_tpu_torch.runtime import msgpack_codec as msgpack
from dynamo_tpu_torch.runtime.client import Client
from dynamo_tpu_torch.runtime.engine import Annotated, Context, StreamDisconnect
from dynamo_tpu_torch.runtime.incidents import register_evidence_probe
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.tracing import get_tracer

logger = get_logger(__name__)


class RouterMode(enum.Enum):
    ROUND_ROBIN = "round-robin"
    RANDOM = "random"
    DIRECT = "direct"
    KV = "kv"


class InstanceGone(StreamDisconnect):
    """The chosen instance left discovery before its worker took the request
    (no frame came back): nothing was streamed, so the request may be sent
    to another instance as it is."""


class NoInstancesError(Exception):
    pass


class WorkerMonitor:
    """Tracks per-worker busy state from published load metrics (busy when
    KV-cache usage reaches the threshold). ``follow`` feeds it from the
    workers' ``WorkerMetricsPublisher`` gossip."""

    def __init__(self, busy_threshold: Optional[float] = None):
        self.busy_threshold = busy_threshold
        self._usage: dict[int, float] = {}

    def update(self, instance_id: int, kv_usage: float) -> None:
        self._usage[instance_id] = kv_usage

    async def follow(self, bus, subject: str, on_metrics=None) -> None:
        """Update from the load gossip on ``subject`` (JSON objects with
        ``worker_id`` and ``kv_usage``) until cancelled; ``on_metrics(
        worker_id, message)`` sees every well-formed message too."""
        sub = await bus.subscribe(subject)
        try:
            async for msg in sub:
                try:
                    m = json.loads(msg.data)
                    wid = int(m["worker_id"])
                    self.update(wid, float(m.get("kv_usage", 0.0)))
                    if on_metrics is not None:
                        on_metrics(wid, m)
                except (ValueError, KeyError):
                    continue
        except asyncio.CancelledError:
            pass
        finally:
            await sub.unsubscribe()

    def busy_instances(self) -> Set[int]:
        if self.busy_threshold is None:
            return set()
        return {i for i, u in self._usage.items() if u >= self.busy_threshold}


@dataclass
class RetryPolicy:
    """NoInstances retry budget with jittered exponential backoff. ``seed``
    pins the jitter for deterministic tests; production leaves it None."""

    max_retries: int = 3
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    jitter: float = 0.5  # fraction of each backoff randomized away
    seed: Optional[int] = None

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def backoff_s(self, attempt: int) -> float:
        base = min(self.backoff_max_s, self.backoff_base_s * (2.0 ** attempt))
        return base * (1.0 - self.jitter * self._rng.random())


# Circuit states (exported in snapshots).
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Per-worker consecutive-failure circuit.

    closed --(failures >= threshold)--> open --(cooldown)--> half_open
    half_open --(probe success)--> closed ; --(probe failure)--> open

    All state behind one lock: ``record_*`` fire from the routing path on
    the event loop while ``snapshot()`` may be read from other threads."""

    def __init__(self, threshold: int = 3, cooldown_s: float = 5.0,
                 clock=time.monotonic, on_transition=None):
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._on_transition = on_transition  # (instance_id, state) -> None
        self._lock = threading.Lock()
        # {instance_id: {"state", "failures", "opened_at", "probing"}}
        self._w: Dict[int, dict] = {}  # guarded-by: _lock
        self.trips_total = 0  # guarded-by: _lock

    def _entry(self, wid: int) -> dict:
        return self._w.setdefault(
            wid, {"state": CLOSED, "failures": 0, "opened_at": 0.0, "probing": False}
        )

    def _set_state(self, wid: int, e: dict, state: str) -> None:
        if e["state"] != state:
            e["state"] = state
            if self._on_transition is not None:
                self._on_transition(wid, state)

    def record_failure(self, wid: int) -> None:
        with self._lock:
            e = self._entry(wid)
            e["failures"] += 1
            e["probing"] = False
            if e["state"] == HALF_OPEN or e["failures"] >= self.threshold:
                if e["state"] != OPEN:
                    self.trips_total += 1
                    logger.warning(
                        "circuit OPEN for worker %x (%d consecutive failures)",
                        wid, e["failures"],
                    )
                self._set_state(wid, e, OPEN)
                e["opened_at"] = self._clock()

    def record_success(self, wid: int) -> None:
        with self._lock:
            e = self._entry(wid)
            if e["state"] != CLOSED:
                logger.info("circuit CLOSED for worker %x", wid)
            e["failures"] = 0
            e["probing"] = False
            self._set_state(wid, e, CLOSED)

    def blocked_instances(self) -> Set[int]:
        """Workers selection must skip right now. OPEN workers whose
        cooldown lapsed transition to HALF_OPEN here (and stop being
        blocked until a probe claims the slot)."""
        now = self._clock()
        with self._lock:
            out: Set[int] = set()
            for wid, e in self._w.items():
                if e["state"] == OPEN:
                    if now - e["opened_at"] >= self.cooldown_s:
                        self._set_state(wid, e, HALF_OPEN)
                    else:
                        out.add(wid)
                        continue
                if e["state"] == HALF_OPEN and e["probing"]:
                    out.add(wid)  # one probe at a time
            return out

    def note_dispatch(self, wid: int) -> None:
        """Selection chose this worker: a HALF_OPEN worker's dispatch is
        the probe — block further routes until it resolves."""
        with self._lock:
            e = self._w.get(wid)
            if e is not None and e["state"] == HALF_OPEN:
                e["probing"] = True

    def forget(self, wid: int) -> None:
        with self._lock:
            self._w.pop(wid, None)

    def state_of(self, wid: int) -> str:
        with self._lock:
            e = self._w.get(wid)
            return e["state"] if e is not None else CLOSED

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "trips_total": self.trips_total,
                "workers": {
                    f"{wid:x}": {"state": e["state"], "failures": e["failures"]}
                    for wid, e in self._w.items()
                },
            }


class PushRouter:
    """Routes requests to endpoint instances; returns the response stream."""

    def __init__(
        self,
        client: Client,
        mode: RouterMode = RouterMode.ROUND_ROBIN,
        *,
        monitor: Optional[WorkerMonitor] = None,
        retry: Optional[RetryPolicy] = None,
        breaker: Optional[CircuitBreaker] = None,
        metrics=None,  # a runtime.metrics.MetricsRegistry: circuit_open{worker}
    ):
        self.client = client
        self.drt = client.drt
        self.mode = mode
        self.monitor = monitor or WorkerMonitor()
        self._metrics = metrics
        self.retry = retry if retry is not None else RetryPolicy()
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            on_transition=self._on_circuit_transition
        )
        self.retries_total = 0
        self._rr = 0
        self._load_task: Optional[asyncio.Task] = None
        # The routing-decision black box an incident bundle carries.
        self.decisions: collections.deque = collections.deque(maxlen=64)
        register_evidence_probe(f"router:{client.endpoint.path}", self.routing_evidence)

    def _on_circuit_transition(self, wid: int, state: str) -> None:
        if self._metrics is not None:
            self._metrics.gauge(
                "circuit_open", "per-worker circuit state (1=open, 0.5=half-open)", worker=f"{wid:x}",
            ).set(1.0 if state == OPEN else (0.5 if state == HALF_OPEN else 0.0))

    def routing_evidence(self) -> dict:
        """Recent routing decisions and the breaker's state (incident
        bundles)."""
        return {
            "mode": self.mode.value,
            "endpoint": self.client.endpoint.path,
            "live_instances": [f"{i:x}" for i in self.client.instance_ids()],
            "recent_decisions": list(self.decisions),
            "breaker": self.breaker.snapshot(),
            "retries_total": self.retries_total,
        }

    def follow_load(self, subject: str) -> None:
        """Feed the busy monitor from the workers' load gossip on
        ``subject`` (``kv_router.kv_metrics_subject``) until ``close``."""
        self._load_task = asyncio.get_running_loop().create_task(self.monitor.follow(self.drt.bus, subject))

    async def close(self) -> None:
        if self._load_task is not None:
            self._load_task.cancel()
            try:
                await self._load_task
            except asyncio.CancelledError:
                pass  # cancelled before it subscribed
            self._load_task = None

    # --- instance selection -------------------------------------------------
    def _candidates(self) -> list[int]:
        ids = self.client.instance_ids()
        if not ids:
            raise NoInstancesError(f"no instances for {self.client.endpoint.path}")
        busy = self.monitor.busy_instances()
        blocked = self.breaker.blocked_instances()
        free = [i for i in ids if i not in busy and i not in blocked]
        if free:
            return free
        unblocked = [i for i in ids if i not in blocked]
        # all busy ⇒ degrade to the unblocked set; all circuits open ⇒
        # degrade to the full set rather than fail (availability beats
        # breaker purity when there is nowhere else to send).
        return unblocked or ids

    def select(self, instance_id: Optional[int] = None) -> int:
        if instance_id is not None:
            if instance_id not in self.client.instances:
                raise NoInstancesError(f"instance {instance_id:x} not found for {self.client.endpoint.path}")
            return instance_id
        ids = self._candidates()
        if self.mode == RouterMode.RANDOM:
            return random.choice(ids)
        # default round-robin
        chosen = ids[self._rr % len(ids)]
        self._rr += 1
        return chosen

    async def _select_with_retry(self, instance_id: Optional[int]) -> int:
        """Selection behind the retry budget: an empty instance set gets
        jittered-backoff retries (rolling restart, watch latency) before
        NoInstancesError surfaces. Direct selects (explicit instance_id)
        don't retry — the caller pinned a worker that is gone."""
        attempt = 0
        while True:
            try:
                return self.select(instance_id)
            except NoInstancesError:
                if instance_id is not None or attempt >= self.retry.max_retries:
                    raise
                delay = self.retry.backoff_s(attempt)
                attempt += 1
                self.retries_total += 1
                logger.warning(
                    "no instances for %s; retry %d/%d in %.0f ms",
                    self.client.endpoint.path, attempt, self.retry.max_retries,
                    delay * 1000.0,
                )
                await asyncio.sleep(delay)

    # --- request paths ------------------------------------------------------
    async def generate(
        self,
        request: Any,
        context: Optional[Context] = None,
        *,
        instance_id: Optional[int] = None,
    ) -> AsyncIterator[Annotated]:
        """Push the request to a selected instance and yield response frames.

        Raises :class:`StreamDisconnect` if the stream drops mid-flight, which
        the Migration operator upstream turns into a replay on another worker.
        """
        ctx = context or Context()
        while True:
            chosen = await self._select_with_retry(instance_id)
            self.decisions.append({"ts": round(time.monotonic(), 3), "request_id": ctx.id,
                                   "instance": f"{chosen:x}", "mode": self.mode.value})
            tp = ctx.traceparent
            if tp is not None:
                get_tracer().event("route", tp.trace_id, parent_id=tp.parent_id, service="frontend",
                                   instance=f"{chosen:x}", endpoint=self.client.endpoint.path, mode=self.mode.value)
            try:
                async for item in self._push(request, ctx, chosen):
                    yield item
                return
            except InstanceGone:
                if instance_id is not None:
                    raise  # pinned by the caller (the KV router re-schedules)
                logger.warning("instance %x left before taking request %s; sending it elsewhere", chosen, ctx.id)

    async def _push(self, request: Any, ctx: Context, chosen: int) -> AsyncIterator[Annotated]:
        """One dispatch to ``chosen``: its response frames, or
        ``InstanceGone`` before any if it leaves before calling home."""
        instance = self.client.instances[chosen]
        self.breaker.note_dispatch(chosen)

        local = self.drt.local_engines.get(chosen)
        if local is not None:
            # In-process fast path: skip pub/sub + TCP entirely.
            try:
                async for item in self._generate_local(local, request, ctx):
                    yield item
            except StreamDisconnect:
                self.breaker.record_failure(chosen)
                raise
            self.breaker.record_success(chosen)
            return

        conn_info, pending = self.drt.tcp_server_handle().register()
        payload = msgpack.packb({"request": request, "ctx": ctx.to_wire(), "conn": conn_info.to_dict()})
        await self.drt.bus.publish(instance.subject, payload)

        cancel_state = {"sent": False}

        async def publish_cancel() -> None:
            if cancel_state["sent"]:
                return
            cancel_state["sent"] = True
            # Two-level cancellation: stop_generating → graceful "cancel" (the engine frees KV and
            # closes the stream with finish_reason=cancelled); kill → hard
            # "kill" (the handler abandons mid-stream).
            op = "kill" if ctx.is_killed() else "cancel"
            await self.drt.bus.publish(
                instance.control_subject,
                msgpack.packb({"op": op, "request_id": ctx.id}),
            )

        async def cancel_on_stop() -> None:
            # Prompt propagation: a stopped context publishes the cancel op
            # immediately — the old path only noticed at the next frame,
            # which for a long prefill could be seconds away.
            await ctx.stopped()
            await publish_cancel()

        watcher = asyncio.get_running_loop().create_task(cancel_on_stop())
        try:
            async for frame in self._called_home(pending.frames(), chosen):
                if ctx.is_stopped():
                    await publish_cancel()
                if frame.kind == "prologue":
                    continue
                if frame.kind == "data":
                    yield Annotated.from_wire(frame.header)
                elif frame.kind == "complete":
                    self.breaker.record_success(chosen)
                    return
                elif frame.kind == "error":
                    if frame.header.get("disconnect"):
                        # Abrupt socket death too: the TCP layer surfaces it
                        # as a synthesized disconnect error frame.
                        self.breaker.record_failure(chosen)
                        raise StreamDisconnect(frame.header.get("message", "disconnect"))
                    raise RuntimeError(frame.header.get("message", "engine error"))
        finally:
            watcher.cancel()
            self.drt.tcp_server_handle().unregister(conn_info.stream_id)

    async def _called_home(self, frames: AsyncIterator, chosen: int) -> AsyncIterator:
        """``frames``, once the worker has called home (its first frame).
        Until then, ``chosen`` leaving discovery raises ``InstanceGone``."""
        frames = frames.__aiter__()
        first = asyncio.ensure_future(frames.__anext__())
        try:
            while True:
                await asyncio.sleep(0)  # a frame already queued completes ``first`` here
                if first.done():
                    break
                # Taken before the check, so a departure between the check
                # and the wait still ends the wait.
                changed = self.client.change_event()
                if chosen not in self.client.instances:  # also gone before the wait began
                    self.breaker.forget(chosen)
                    raise InstanceGone(f"instance {chosen:x} left before taking the request")
                waiter = asyncio.ensure_future(changed.wait())
                try:
                    await asyncio.wait({first, waiter}, return_when=asyncio.FIRST_COMPLETED)
                finally:
                    waiter.cancel()
        finally:
            first.cancel()
        try:
            yield first.result()
        except StopAsyncIteration:
            return
        async for frame in frames:
            yield frame

    async def _generate_local(self, engine, request, ctx) -> AsyncIterator[Annotated]:
        try:
            async for item in engine.generate(request, ctx):
                yield item if isinstance(item, Annotated) else Annotated(data=item)
        except ConnectionError as e:
            # In-process engines die with the same observable semantics as
            # the wire path: a StreamDisconnect the Migration operator can
            # replay (a raw ConnectionResetError would bubble to a 500).
            raise StreamDisconnect(str(e) or "engine connection failure") from e
