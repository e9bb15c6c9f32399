"""Disaggregated prefill/decode serving and the worker-to-worker KV hop.

The counterpart of the JAX package's ``llm/disagg.py``, on its wire. A
decode worker takes the request; a long prompt goes to a prefill worker as
a ``max_tokens=1`` request with ``disagg_params.do_remote_decode`` (pushed
to a chosen instance, ``decode_first``, or put on the durable prefill
queue for any prefill worker to take, ``prefill_first``); the prefill
worker keeps the prompt's blocks at finish; the decode worker pulls them
and decodes on from the injected KV.

The pull has two modes (``kv_transfer``):
- ``"device"`` (the default, the NIXL role): the blocks never leave the
  card. Two engines of one process hand the stacked tensors over directly
  (``_LOCAL_EXPORTERS``); across processes the prefill worker offers the
  stack through CUDA IPC and sends only the rendezvous metadata down the
  TCP response plane (``block_manager/device_transfer.py``); the decode
  worker copies it and acks on ``kvx_ack.<request id>``. The metadata is
  the port's own, so this mode is port to port.
- ``"host"``: block pairs as bytes over the TCP response plane, one frame
  a block with the JAX package's header keys and body (the k bytes, then
  the v bytes; dtype ``"bfloat16"`` or ``"float32"``), so a worker of
  either package pulls from the other.

Conditional disaggregation: prompts no longer than
``max_local_prefill_length`` prefill locally (``DisaggRouterConf``,
watched in the store). A failed remote prefill or pull degrades to a local
prefill and counts ``degrade_disagg_to_colocated_total``; nothing turns a
device pull into a host copy. Each flip of the degradation ladder is a
``mode_transition`` event on the request's trace and each remote prefill a
``disagg_hop`` event, as in the JAX handler.
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import asdict, dataclass
from typing import Any, AsyncIterator, List, Optional, Tuple

import torch

from dynamo_tpu_torch.runtime import msgpack_codec as msgpack
from dynamo_tpu_torch.runtime.client import Client
from dynamo_tpu_torch.runtime.component import Instance
from dynamo_tpu_torch.runtime.engine import Annotated, Context
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.push_router import NoInstancesError, PushRouter, RouterMode
from dynamo_tpu_torch.runtime.tracing import get_tracer
from dynamo_tpu_torch.runtime.transports.tcp import ConnectionInfo, TcpCallHome
from dynamo_tpu_torch.runtime.work_queue import WorkQueue

logger = get_logger(__name__)

DISAGG_CONF_PREFIX = "public/components/disagg_router/models"
# A device offer is held this long for its ack (a consumer died mid-pull).
OFFER_TTL_S = 60.0

_WIRE_DTYPES = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
_FROM_WIRE = {v: k for k, v in _WIRE_DTYPES.items()}


@dataclass
class DisaggRouterConf:
    """The conditional-disaggregation setting: prompts longer than
    ``max_local_prefill_length`` prefill remotely (0: every prompt, while
    a prefill pool exists)."""

    max_local_prefill_length: int = 0

    @staticmethod
    def store_key(model_type: str, model: str) -> str:
        return f"{DISAGG_CONF_PREFIX}/{model_type}/{model}"


class DisaggRouter:
    """The local-or-remote prefill decision, reloaded from the store."""

    def __init__(self, drt, model: str, model_type: str = "chat", conf: Optional[DisaggRouterConf] = None):
        self.drt = drt
        self.key = DisaggRouterConf.store_key(model_type, model)
        self.conf = conf or DisaggRouterConf()
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        entry = await self.drt.store.get(self.key)
        if entry is not None:
            self._apply(entry.value)
        _, watch = await self.drt.store.get_and_watch_prefix(self.key)
        self._watch = watch

        async def loop():
            async for ev in watch:
                if ev.value is not None:
                    self._apply(ev.value)

        self._task = asyncio.get_running_loop().create_task(loop())

    def _apply(self, raw: bytes) -> None:
        try:
            d = json.loads(raw)
            self.conf = DisaggRouterConf(max_local_prefill_length=int(d.get("max_local_prefill_length", 0)))
            logger.info("disagg conf updated: %s", self.conf)
        except (ValueError, TypeError):
            logger.warning("bad disagg conf at %s", self.key)

    def prefill_remote(self, prompt_len: int, prefill_available: bool) -> bool:
        if not prefill_available:
            return False
        return prompt_len > self.conf.max_local_prefill_length

    async def stop(self) -> None:
        if self._task is not None:
            await self._watch.cancel()
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass


# ---------------------------------------------------------------------------
# The KV hop
# ---------------------------------------------------------------------------


def kvx_subject(instance: Instance) -> str:
    return f"kvx.{instance.subject[3:]}"  # rq.<rest> → kvx.<rest>


def _block_bytes(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes()


def block_frames(blocks: List[Tuple[torch.Tensor, torch.Tensor]], prompt_len: int) -> List[Tuple[dict, bytes]]:
    """The host pull's frames ``(header, body)``, one a block: the JAX
    ``KvExportService``'s header keys and body."""
    frames = []
    for i, (k, v) in enumerate(blocks):
        header = {"seq": i, "total": len(blocks), "shape": list(k.shape), "dtype": _WIRE_DTYPES[k.dtype],
                  "prompt_len": prompt_len}
        frames.append((header, _block_bytes(k) + _block_bytes(v)))
    return frames


def block_of_frame(header: dict, body: bytes) -> Tuple[torch.Tensor, torch.Tensor]:
    shape = tuple(header["shape"])
    dtype = _FROM_WIRE[header["dtype"]]
    half = len(body) // 2
    k = torch.frombuffer(bytearray(body[:half]), dtype=dtype).reshape(shape)
    v = torch.frombuffer(bytearray(body[half:]), dtype=dtype).reshape(shape)
    return k, v


# Exporters of this process: a decode engine beside the prefill engine takes
# the stack straight from it (the NIXL same-node role).
_LOCAL_EXPORTERS: dict = {}


class KvExportService:
    """Prefill-worker side: serves the decode workers' pulls."""

    def __init__(self, drt, engine, instance: Instance):
        self.drt = drt
        self.engine = engine
        self.subject = kvx_subject(instance)
        self._task: Optional[asyncio.Task] = None
        self._reap_tasks: set = set()

    async def start(self) -> None:
        _LOCAL_EXPORTERS[self.subject] = self
        sub = await self.drt.bus.subscribe(self.subject)

        async def loop():
            async for msg in sub:
                try:
                    req = msgpack.unpackb(msg.data)
                except ValueError:
                    continue
                asyncio.get_running_loop().create_task(self._serve_pull(req))

        self._sub = sub
        self._task = asyncio.get_running_loop().create_task(loop())

    async def _serve_pull(self, req: dict) -> None:
        call_home = TcpCallHome(ConnectionInfo.from_dict(req["conn"]))
        try:
            if not await call_home.connect():
                return
            if req.get("mode") == "device":
                await self._serve_pull_device(req, call_home)
                return
            export = await self.engine.take_export(req["request_id"])
            if export is None:
                await call_home.error(f"no export for {req['request_id']}")
                return
            blocks, _hashes, prompt_len = export
            for header, body in block_frames(blocks, prompt_len):
                await call_home.send(header, body)
            await call_home.complete()
        except ConnectionError:
            logger.warning("kv export pull dropped for %s", req.get("request_id"))
        finally:
            await call_home.close()

    async def _serve_pull_device(self, req: dict, call_home: TcpCallHome) -> None:
        """Offer the stacked export through CUDA IPC and send only the
        rendezvous metadata; hold the stack until the decode worker acks
        its copy (or ``OFFER_TTL_S`` passes)."""
        from dynamo_tpu_torch.llm.block_manager.device_transfer import get_plane

        rid = req["request_id"]
        export = await self.engine.take_export_device(rid)
        if export is None:
            await call_home.error(f"no export for {rid}")
            return
        (k_stack, v_stack), _hashes, prompt_len = export
        plane = get_plane()
        try:
            meta = plane.offer(rid, [k_stack] if v_stack is None else [k_stack, v_stack])
        except (RuntimeError, ValueError) as e:
            await call_home.error(f"device offer failed: {e}")
            return
        ack_sub = await self.drt.bus.subscribe(f"kvx_ack.{rid}")
        await call_home.send({"seq": 0, "total": 1, "mode": "device", "meta": meta,
                              "prompt_len": prompt_len, "has_v": v_stack is not None}, b"")
        await call_home.complete()

        async def reap():
            try:
                await ack_sub.next(timeout=OFFER_TTL_S)
            finally:
                plane.release_offer(rid)
                await ack_sub.unsubscribe()

        # A strong reference: the loop holds tasks weakly, and a collected
        # reap task would leak the offered stack and the subscription.
        task = asyncio.get_running_loop().create_task(reap())
        self._reap_tasks.add(task)
        task.add_done_callback(self._reap_tasks.discard)

    async def stop(self) -> None:
        _LOCAL_EXPORTERS.pop(self.subject, None)
        if self._task is not None:
            await self._sub.unsubscribe()
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        for task in list(self._reap_tasks):
            task.cancel()
        if self._reap_tasks:
            await asyncio.gather(*self._reap_tasks, return_exceptions=True)


async def pull_kv_blocks(drt, instance: Instance, request_id: str) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Decode-worker side, host mode: the prefilled blocks of
    ``request_id`` as host pairs, from the prefill worker that holds them."""
    conn_info, pending = drt.tcp_server_handle().register()
    await drt.bus.publish(kvx_subject(instance),
                          msgpack.packb({"request_id": request_id, "conn": conn_info.to_dict()}))
    blocks: List[Tuple[torch.Tensor, torch.Tensor]] = []
    try:
        async for frame in pending.frames():
            if frame.kind == "data":
                blocks.append(block_of_frame(frame.header, frame.body))
            elif frame.kind == "error":
                raise RuntimeError(frame.header.get("message", "kv pull failed"))
    finally:
        drt.tcp_server_handle().unregister(conn_info.stream_id)
    return blocks


async def pull_kv_blocks_device(drt, instance: Instance, request_id: str, device: torch.device):
    """Decode-worker side, device mode: ``(k_stack, v_stack or None)`` on
    ``device``. In process, the exporter's stack itself; else the
    rendezvous metadata over the wire, a copy through CUDA IPC and an ack."""
    from dynamo_tpu_torch.llm.block_manager.device_transfer import get_plane

    svc = _LOCAL_EXPORTERS.get(kvx_subject(instance))
    if svc is not None:
        export = await svc.engine.take_export_device(request_id)
        if export is None:
            raise RuntimeError(f"no export for {request_id}")
        (k_stack, v_stack), _hashes, _plen = export
        return k_stack, v_stack

    conn_info, pending = drt.tcp_server_handle().register()
    await drt.bus.publish(kvx_subject(instance), msgpack.packb(
        {"request_id": request_id, "conn": conn_info.to_dict(), "mode": "device"}))
    meta = None
    has_v = True
    try:
        async for frame in pending.frames():
            if frame.kind == "data":
                meta = frame.header["meta"]
                has_v = bool(frame.header.get("has_v", True))
            elif frame.kind == "error":
                raise RuntimeError(frame.header.get("message", "kv pull failed"))
    finally:
        drt.tcp_server_handle().unregister(conn_info.stream_id)
    if meta is None:
        raise RuntimeError("device kv pull: no rendezvous metadata received")
    tensors = await asyncio.to_thread(get_plane().pull, meta, device)
    await drt.bus.publish(f"kvx_ack.{request_id}", b"1")
    return (tensors[0], tensors[1]) if has_v else (tensors[0], None)


# ---------------------------------------------------------------------------
# Prefill and decode workers
# ---------------------------------------------------------------------------


PREFILL_QUEUE = "prefill"


async def _first_token_of(stream) -> int:
    """A prefill response stream's first token (the prefill role emits one,
    ``max_tokens=1``)."""
    first: Optional[int] = None
    async for item in stream:
        data = item.data if isinstance(item, Annotated) else item
        if first is None and data and data.get("token_ids"):
            first = data["token_ids"][0]
    if first is None:
        raise RuntimeError("prefill returned no token")
    return first


class PrefillQueueWorker:
    """The ``prefill_first`` strategy, worker side: take prefill jobs from
    the shared durable queue, run them on the local engine and reply on the
    decode worker's subject. The blocks wait for their pull under the job's
    request id, as on the push path."""

    def __init__(self, drt, engine, instance: Instance, queue_name: str = PREFILL_QUEUE,
                 lease_id: Optional[int] = None):
        self.drt = drt
        self.engine = engine
        self.instance = instance
        self.queue_name = queue_name
        self.lease_id = lease_id
        self.queue = WorkQueue(drt.store, drt.bus, queue_name, lease_id=lease_id)
        self.jobs_served = 0
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()

    async def start(self) -> None:
        # Advertise liveness, so decode workers enqueue only while someone
        # can take the job (leased: the key dies with the worker).
        await self.drt.store.put(f"wq/{self.queue_name}/workers/{self.instance.instance_id:x}", b"",
                                 lease_id=self.lease_id)
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def _loop(self) -> None:
        while not self._stop.is_set():
            item = await self.queue.dequeue(timeout=0.2)
            if item is None:
                continue
            try:
                await self._serve_job(item.data)
            except Exception:  # noqa: BLE001 — one bad job must not end the loop
                logger.exception("prefill queue job failed")
            finally:
                await item.ack()

    async def _serve_job(self, raw: bytes) -> None:
        job = json.loads(raw)
        reply_subject = job["reply_subject"]
        reply = {"request_id": job.get("request_id")}
        # The decode worker gave up at expires_at (wall clock): prefilling
        # now would pin blocks until the export TTL reclaims them.
        expires_at = job.get("expires_at")
        if expires_at is not None and time.time() > expires_at:
            logger.warning("dropping expired prefill job %s", reply["request_id"])
            return
        try:
            ctx = Context(id=job["request_id"])
            first_token = await _first_token_of(self.engine.generate(job["request"], ctx))
            reply.update(first_token=first_token, instance=asdict(self.instance))
            self.jobs_served += 1
        except Exception as e:  # noqa: BLE001 — the error crosses the wire
            reply["error"] = str(e)
        await self.drt.bus.publish(reply_subject, json.dumps(reply).encode())

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            await self._task


class DisaggDecodeHandler:
    """The decode worker's endpoint handler: prefills remotely when the
    rule says so and a pool exists, pulls the KV, then decodes locally from
    the injected cache.

    ``strategy``: ``decode_first`` pushes the prefill to a chosen instance;
    ``prefill_first`` enqueues it on the durable queue for any prefill
    worker. ``pool_load_probe`` (a sync or async callable returning
    ``{"prefill_saturated": bool, "local_saturated": bool,
    "max_prefill_tokens": int or None}``) lets the handler degrade before
    any hop: a saturated pool sends the request to the local mixed batch, a
    saturated local engine offloads it, and ``max_prefill_tokens`` splits
    the prompt at a block boundary (the pool prefills the head, the decode
    worker the rest). Each step down the ladder is counted."""

    def __init__(
        self,
        drt,
        engine,
        prefill_client: Optional[Client] = None,
        disagg_router: Optional[DisaggRouter] = None,
        strategy: str = "decode_first",
        prefill_queue_name: str = PREFILL_QUEUE,
        queue_reply_timeout_s: float = 30.0,
        kv_transfer: str = "device",
        pool_load_probe: Optional[Any] = None,
        block_size: int = 16,
    ):
        if strategy not in ("decode_first", "prefill_first"):
            raise ValueError(f"unknown disagg strategy: {strategy}")
        if kv_transfer not in ("device", "host"):
            raise ValueError(f"unknown kv_transfer mode: {kv_transfer}")
        self.kv_transfer = kv_transfer
        self.drt = drt
        self.engine = engine
        self.prefill_client = prefill_client
        self.prefill_router = PushRouter(prefill_client, RouterMode.ROUND_ROBIN) if prefill_client else None
        self.disagg_router = disagg_router
        self.strategy = strategy
        self.queue = WorkQueue(drt.store, drt.bus, prefill_queue_name) if strategy == "prefill_first" else None
        self.queue_reply_timeout_s = queue_reply_timeout_s
        self.prefill_queue_name = prefill_queue_name
        self.remote_prefills = 0
        self.local_prefills = 0
        self.pool_load_probe = pool_load_probe
        self.block_size = max(1, int(block_size))
        self.degrade_disagg_to_colocated_total = 0
        self.degrade_colocated_to_disagg_total = 0
        self.split_prefills_total = 0
        # prefill_first: the queue workers' presence, cached, and a back-off
        # after a reply timeout, so an empty pool does not cost every
        # request queue_reply_timeout_s of TTFT.
        self._liveness_cache: Tuple[float, bool] = (0.0, False)
        self._liveness_ttl_s = 2.0
        self._backoff_until = 0.0
        self.queue_backoff_s = 15.0

    async def _pool_load(self) -> dict:
        if self.pool_load_probe is None:
            return {}
        try:
            res = self.pool_load_probe()
            if asyncio.iscoroutine(res) or isinstance(res, asyncio.Future):
                res = await res
            return res or {}
        except Exception:  # noqa: BLE001 — a broken probe must not fail serving
            logger.exception("pool load probe failed; treating as no signal")
            return {}

    async def can_prefill_remote(self) -> bool:
        if self.strategy == "prefill_first":
            now = time.monotonic()
            if now < self._backoff_until:
                return False
            ts, alive = self._liveness_cache
            if now - ts > self._liveness_ttl_s:
                workers = await self.drt.store.get_prefix(f"wq/{self.prefill_queue_name}/workers/")
                alive = bool(workers)
                self._liveness_cache = (now, alive)
            return alive
        return self.prefill_router is not None and bool(self.prefill_client.instances)

    async def _prefill_via_push(self, prefill_req: dict, prefill_ctx: Context) -> Tuple[int, Instance]:
        instance_id = self.prefill_router.select()
        instance = self.prefill_client.instances[instance_id]
        first_token = await _first_token_of(
            self.prefill_router.generate(prefill_req, prefill_ctx, instance_id=instance_id))
        return first_token, instance

    async def _prefill_via_queue(self, prefill_req: dict, prefill_ctx: Context) -> Tuple[int, Instance]:
        reply_subject = f"prefill_reply.{prefill_ctx.id}"
        sub = await self.drt.bus.subscribe(reply_subject)
        try:
            await self.queue.enqueue(json.dumps({
                "request": prefill_req,
                "request_id": prefill_ctx.id,
                "reply_subject": reply_subject,
                "expires_at": time.time() + self.queue_reply_timeout_s,
            }).encode())
            msg = await sub.next(timeout=self.queue_reply_timeout_s)
        finally:
            await sub.unsubscribe()
        if msg is None:
            raise RuntimeError("prefill queue reply timed out")
        reply = json.loads(msg.data)
        if reply.get("error"):
            raise RuntimeError(f"queued prefill failed: {reply['error']}")
        return reply["first_token"], Instance(**reply["instance"])

    def _mode_transition(self, context: Context, direction: str, reason: str, **kw) -> None:
        """A step of the degradation ladder, on the request's trace (the
        paired degrade_*_total counters count it)."""
        tp = context.traceparent
        if tp is not None:
            get_tracer().event("mode_transition", tp.trace_id, parent_id=tp.parent_id, service="worker",
                               request_id=context.id, direction=direction, reason=reason, **kw)

    async def generate(self, request: Any, context: Context) -> AsyncIterator[dict]:
        tokens = list(request.get("token_ids") or [])
        can_remote = await self.can_prefill_remote()
        remote = (self.disagg_router.prefill_remote(len(tokens), can_remote) if self.disagg_router is not None
                  else can_remote)
        load = await self._pool_load()
        split_at = 0
        if remote and load.get("prefill_saturated"):
            remote = False
            self.degrade_disagg_to_colocated_total += 1
            self._mode_transition(context, "disagg_to_colocated", "prefill_pool_saturated", prompt_tokens=len(tokens))
        elif not remote and can_remote and load.get("local_saturated"):
            remote = True
            self.degrade_colocated_to_disagg_total += 1
            self._mode_transition(context, "colocated_to_disagg", "local_saturated", prompt_tokens=len(tokens))
        if remote:
            # Token-boundary split: the pool prefills the first split_at
            # tokens (the request's own, else the probe's headroom rounded
            # down to a block), the decode worker the rest.
            dp = request.get("disagg_params") or {}
            split_at = int(dp.get("split_at") or 0)
            cap = load.get("max_prefill_tokens")
            if split_at <= 0 and cap is not None and 0 < int(cap) < len(tokens):
                split_at = (int(cap) // self.block_size) * self.block_size
            if split_at < self.block_size or split_at >= len(tokens):
                split_at = 0

        if not remote:
            self.local_prefills += 1
            async for item in self.engine.generate(request, context):
                yield item
            return

        self.remote_prefills += 1
        leg_start = time.monotonic()
        prefill_req = dict(request)
        if split_at:
            prefill_req["token_ids"] = tokens[:split_at]
            self.split_prefills_total += 1
        prefill_req["stop_conditions"] = {**(request.get("stop_conditions") or {}), "max_tokens": 1,
                                          "ignore_eos": True}
        prefill_req["disagg_params"] = {"do_remote_decode": True}
        prefill_ctx = context.child()  # the same request id crosses the wire
        tp = context.traceparent
        if tp is not None:
            get_tracer().event("disagg_hop", tp.trace_id, parent_id=tp.parent_id, service="worker",
                               request_id=context.id, prompt_tokens=len(tokens), strategy=self.strategy,
                               kv_transfer=self.kv_transfer, split_at=split_at)
        try:
            if self.strategy == "prefill_first":
                first_token, instance = await self._prefill_via_queue(prefill_req, prefill_ctx)
            else:
                first_token, instance = await self._prefill_via_push(prefill_req, prefill_ctx)
            if self.kv_transfer == "device":
                device_blocks = await pull_kv_blocks_device(self.drt, instance, prefill_ctx.id,
                                                            self.engine.scheduler.device)
                blocks = None
            else:
                blocks = await pull_kv_blocks(self.drt, instance, prefill_ctx.id)
        except (NoInstancesError, ConnectionError, RuntimeError) as e:
            # The pool failed: prefill here (availability over disagg). A
            # queue reply timeout means the registered workers are not
            # taking jobs: back off, so the next requests go local at once.
            if self.strategy == "prefill_first" and "timed out" in str(e):
                self._backoff_until = time.monotonic() + self.queue_backoff_s
            logger.warning("remote prefill failed (%s); running locally", e)
            self.degrade_disagg_to_colocated_total += 1
            self._mode_transition(context, "disagg_to_colocated", f"remote_prefill_failed:{e}",
                                  prompt_tokens=len(tokens))
            self.local_prefills += 1
            async for item in self.engine.generate(request, context):
                yield item
            return

        local_req = dict(request)
        prefilled = {"first_token": first_token}
        if blocks is not None:
            prefilled["blocks"] = blocks
        else:
            prefilled["device_blocks"] = device_blocks
        if split_at:
            # The scheduler resumes chunked prefill at split_at and samples
            # its own first token; the leg's (of a cut prompt) is dropped.
            prefilled["prefill_len"] = split_at
        local_req["_prefilled"] = prefilled
        # deadline_ms is the budget left at arrival: the decode leg arrives
        # after the hop and the pull, so they come off it.
        stop = dict(request.get("stop_conditions") or {})
        if stop.get("deadline_ms"):
            elapsed_ms = (time.monotonic() - leg_start) * 1000.0
            stop["deadline_ms"] = max(1.0, float(stop["deadline_ms"]) - elapsed_ms)
            local_req["stop_conditions"] = stop
        async for item in self.engine.generate(local_req, context):
            yield item

    def stats_handler(self) -> dict:
        base = self.engine.stats_handler() if hasattr(self.engine, "stats_handler") else {}
        return {
            **base,
            "remote_prefills": self.remote_prefills,
            "local_prefills": self.local_prefills,
            "degrade_disagg_to_colocated_total": self.degrade_disagg_to_colocated_total,
            "degrade_colocated_to_disagg_total": self.degrade_colocated_to_disagg_total,
            "split_prefills_total": self.split_prefills_total,
        }
