"""The built-in TCP control plane: KV store + pub/sub served by one broker.

A copy of the JAX package's ``runtime/transports/tcp_control.py``, on the
same protocol, so either package's client talks to either package's
server: length-prefixed msgpack maps over one TCP connection per client
(``runtime/msgpack_codec.py`` writes the bytes the ``msgpack`` package
writes). Client→server requests carry ``id`` for reply correlation;
server→client pushes (watch events, subscription messages) carry the watch
or subscription id they belong to. Unlike the JAX package's server, this
one answers a long-polling stream fetch (``s_fetch`` with ``wait``) from a
task of its own: the JAX server awaits it inline, which holds every later
op of that client (a frontend's request publishes, its stats scrapes)
until an event comes or the poll's 5 s run out. Leases are server-side with TTL reaping,
so a client's death (its socket closing) revokes its leases, as an etcd
session loss does.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Dict, List, Optional, Tuple

from dynamo_tpu_torch.runtime import msgpack_codec as msgpack
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.transports.kvstore import (
    EventType,
    KeyExists,
    KvEntry,
    KvStore,
    Lease,
    LeaseExpired,
    MemKvStore,
    Watch,
    WatchEvent,
)
from dynamo_tpu_torch.runtime.transports.pubsub import (
    MemPubSub,
    Message,
    PubSub,
    Subscription,
)

logger = get_logger(__name__)

_LEN = struct.Struct(">I")
MAX_MSG = 512 * 1024 * 1024


def _pack(obj: dict) -> bytes:
    data = msgpack.packb(obj)
    return _LEN.pack(len(data)) + data


async def _read_msg(reader: asyncio.StreamReader) -> dict:
    raw = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(raw)
    if n > MAX_MSG:
        raise ValueError(f"message too large: {n}")
    return msgpack.unpackb(await reader.readexactly(n))


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class ControlPlaneServer:
    """The broker: wraps MemKvStore + MemPubSub behind the TCP protocol."""

    def __init__(self, host: str = "0.0.0.0", port: int = 6650):
        self.host = host
        self.port = port
        self.store = MemKvStore()
        self.bus = MemPubSub()
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle_client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("control plane listening on %s:%d", self.host, self.port)

    async def serve_forever(self) -> None:
        assert self._server is not None
        await self._server.serve_forever()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        await self.bus.close()
        await self.store.close()

    async def _handle_client(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        session = _ClientSession(self, reader, writer)
        await session.run()


class _ClientSession:
    def __init__(self, server: ControlPlaneServer, reader, writer):
        self.server = server
        self.reader = reader
        self.writer = writer
        self.watches: Dict[int, Watch] = {}
        self.subs: Dict[int, Subscription] = {}
        self.leases: Dict[int, Lease] = {}
        self.tasks: List[asyncio.Task] = []
        self._wlock = asyncio.Lock()

    async def send(self, obj: dict) -> None:
        async with self._wlock:
            self.writer.write(_pack(obj))
            await self.writer.drain()

    async def run(self) -> None:
        try:
            while True:
                msg = await _read_msg(self.reader)
                try:
                    await self._dispatch(msg)
                except (KeyExists, LeaseExpired) as e:
                    await self.send({"id": msg.get("id"), "error": type(e).__name__, "message": str(e)})
                except Exception as e:
                    logger.exception("control plane op failed: %s", msg.get("op"))
                    await self.send({"id": msg.get("id"), "error": "Internal", "message": str(e)})
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            await self._cleanup()

    async def _cleanup(self) -> None:
        for t in self.tasks:
            t.cancel()
        for w in self.watches.values():
            await w.cancel()
        for s in self.subs.values():
            await s.unsubscribe()
        # Client gone ⇒ its leases die (same as etcd session loss).
        for lease in self.leases.values():
            await lease.revoke()
        try:
            self.writer.close()
        except Exception:
            pass

    async def _dispatch(self, msg: dict) -> None:
        op = msg["op"]
        mid = msg.get("id")
        store, bus = self.server.store, self.server.bus

        if op == "put":
            rev = await store.put(
                msg["key"], msg["value"], lease_id=msg.get("lease_id"), create_only=msg.get("create_only", False)
            )
            await self.send({"id": mid, "revision": rev})
        elif op == "get":
            e = await store.get(msg["key"])
            await self.send({"id": mid, "entry": _entry_wire(e)})
        elif op == "get_prefix":
            es = await store.get_prefix(msg["prefix"])
            await self.send({"id": mid, "entries": [_entry_wire(e) for e in es]})
        elif op == "delete":
            ok = await store.delete(msg["key"])
            await self.send({"id": mid, "deleted": ok})
        elif op == "delete_prefix":
            n = await store.delete_prefix(msg["prefix"])
            await self.send({"id": mid, "count": n})
        elif op == "watch":
            snapshot, watch = await store.get_and_watch_prefix(msg["prefix"])
            wid = msg["watch_id"]
            self.watches[wid] = watch
            await self.send({"id": mid, "entries": [_entry_wire(e) for e in snapshot]})
            self.tasks.append(asyncio.get_running_loop().create_task(self._pump_watch(wid, watch)))
        elif op == "watch_cancel":
            watch = self.watches.pop(msg["watch_id"], None)
            if watch:
                await watch.cancel()
            await self.send({"id": mid, "ok": True})
        elif op == "lease_grant":
            lease = await store.grant_lease(msg["ttl_s"])
            self.leases[lease.id] = lease
            await self.send({"id": mid, "lease_id": lease.id, "ttl_s": lease.ttl_s})
        elif op == "keep_alive":
            await store.keep_alive(msg["lease_id"])
            await self.send({"id": mid, "ok": True})
        elif op == "lease_revoke":
            lease = self.leases.pop(msg["lease_id"], None)
            if lease is not None:
                await lease.revoke()
            else:
                await store.revoke_lease(msg["lease_id"])
            await self.send({"id": mid, "ok": True})
        elif op == "publish":
            await bus.publish(msg["subject"], msg["data"], msg.get("headers") or {}, msg.get("reply_to"))
            if mid is not None:
                await self.send({"id": mid, "ok": True})
        elif op == "subscribe":
            sub = await bus.subscribe(msg["subject"], msg.get("queue_group"))
            sid = msg["sub_id"]
            self.subs[sid] = sub
            await self.send({"id": mid, "ok": True})
            self.tasks.append(asyncio.get_running_loop().create_task(self._pump_sub(sid, sub)))
        elif op == "unsubscribe":
            sub = self.subs.pop(msg["sub_id"], None)
            if sub:
                await sub.unsubscribe()
            await self.send({"id": mid, "ok": True})
        elif op == "s_publish":
            stream = await bus.stream(msg["stream"])
            seq = await stream.publish(msg["subject"], msg["data"], msg.get("headers") or {})
            await self.send({"id": mid, "seq": seq})
        elif op == "s_fetch":
            stream = await bus.stream(msg["stream"])
            if msg.get("wait"):
                # A long-poll waits in a task of its own: the client's later
                # ops (request publishes, stats scrapes) go on meanwhile.
                self.tasks.append(asyncio.get_running_loop().create_task(self._long_poll(stream, msg)))
            else:
                await self._send_fetch(stream, msg)
        elif op == "s_purge":
            stream = await bus.stream(msg["stream"])
            await stream.purge(msg.get("up_to_seq"))
            await self.send({"id": mid, "ok": True})
        elif op == "o_put":
            obj = await bus.object_store(msg["bucket"])
            await obj.put(msg["name"], msg["data"])
            await self.send({"id": mid, "ok": True})
        elif op == "o_get":
            obj = await bus.object_store(msg["bucket"])
            await self.send({"id": mid, "data": await obj.get(msg["name"])})
        elif op == "o_delete":
            obj = await bus.object_store(msg["bucket"])
            await self.send({"id": mid, "deleted": await obj.delete(msg["name"])})
        elif op == "o_list":
            obj = await bus.object_store(msg["bucket"])
            await self.send({"id": mid, "names": await obj.list()})
        elif op == "ping":
            await self.send({"id": mid, "ok": True})
        else:
            await self.send({"id": mid, "error": "UnknownOp", "message": op})

    async def _send_fetch(self, stream, msg: dict) -> None:
        batch = await stream.fetch(msg["from_seq"], msg.get("max_events", 1024))
        await self.send(
            {
                "id": msg.get("id"),
                "events": [
                    {"subject": m.subject, "data": m.data, "headers": m.headers, "seq": m.seq} for m in batch
                ],
                "first_seq": stream.first_seq,
                "last_seq": stream.last_seq,
            }
        )

    async def _long_poll(self, stream, msg: dict) -> None:
        """Wait for an event at or past ``from_seq`` (or the timeout), then
        answer the fetch."""
        try:
            try:
                await asyncio.wait_for(self._wait_stream(stream, msg["from_seq"]), msg.get("timeout", 5.0))
            except asyncio.TimeoutError:
                pass
            await self._send_fetch(stream, msg)
        except (ConnectionError, asyncio.CancelledError):
            pass

    async def _wait_stream(self, stream, from_seq: int) -> None:
        while stream.last_seq < from_seq:
            ev = asyncio.Event()
            async with stream._lock:
                if stream.last_seq >= from_seq:
                    return
                stream._waiters.append(ev)
            await ev.wait()

    async def _pump_watch(self, wid: int, watch: Watch) -> None:
        try:
            async for ev in watch:
                await self.send(
                    {
                        "push": "watch_event",
                        "watch_id": wid,
                        "type": ev.type.value,
                        "key": ev.key,
                        "value": ev.value,
                        "revision": ev.revision,
                    }
                )
        except (ConnectionError, asyncio.CancelledError):
            pass

    async def _pump_sub(self, sid: int, sub: Subscription) -> None:
        try:
            async for m in sub:
                await self.send(
                    {
                        "push": "msg",
                        "sub_id": sid,
                        "subject": m.subject,
                        "data": m.data,
                        "headers": m.headers,
                        "reply_to": m.reply_to,
                    }
                )
        except (ConnectionError, asyncio.CancelledError):
            pass


def _entry_wire(e: Optional[KvEntry]) -> Optional[dict]:
    if e is None:
        return None
    return {"key": e.key, "value": e.value, "lease_id": e.lease_id, "revision": e.revision}


def _entry_from_wire(d: Optional[dict]) -> Optional[KvEntry]:
    if d is None:
        return None
    return KvEntry(key=d["key"], value=d["value"], lease_id=d.get("lease_id"), revision=d.get("revision", 0))


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class ControlPlaneConnection:
    """One multiplexed connection shared by TcpKvStore + TcpPubSub."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self._next_id = 1
        self._pending: Dict[int, asyncio.Future] = {}
        self._watch_queues: Dict[int, asyncio.Queue] = {}
        self._sub_queues: Dict[int, asyncio.Queue] = {}
        self._wlock = asyncio.Lock()
        self._reader_task = asyncio.get_running_loop().create_task(self._read_loop())
        self._closed = False

    async def _read_loop(self) -> None:
        try:
            while True:
                msg = await _read_msg(self.reader)
                push = msg.get("push")
                if push == "watch_event":
                    q = self._watch_queues.get(msg["watch_id"])
                    if q is not None:
                        q.put_nowait(
                            WatchEvent(
                                EventType(msg["type"]), msg["key"], msg.get("value"), msg.get("revision", 0)
                            )
                        )
                elif push == "msg":
                    q = self._sub_queues.get(msg["sub_id"])
                    if q is not None:
                        q.put_nowait(
                            Message(
                                subject=msg["subject"],
                                data=msg["data"],
                                headers=msg.get("headers") or {},
                                reply_to=msg.get("reply_to"),
                            )
                        )
                else:
                    fut = self._pending.pop(msg.get("id"), None)
                    if fut is not None and not fut.done():
                        if "error" in msg:
                            err = msg["error"]
                            exc = {"KeyExists": KeyExists, "LeaseExpired": LeaseExpired}.get(err, RuntimeError)
                            fut.set_exception(exc(msg.get("message", err)))
                        else:
                            fut.set_result(msg)
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._closed = True
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("control plane connection lost"))
            self._pending.clear()
            for q in self._watch_queues.values():
                q.put_nowait(None)
            for q in self._sub_queues.values():
                q.put_nowait(None)

    async def call(self, op: str, **kwargs) -> dict:
        if self._closed:
            raise ConnectionError("control plane connection lost")
        mid = self._next_id
        self._next_id += 1
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[mid] = fut
        async with self._wlock:
            self.writer.write(_pack({"op": op, "id": mid, **kwargs}))
            await self.writer.drain()
        return await fut

    async def send_nowait(self, op: str, **kwargs) -> None:
        async with self._wlock:
            self.writer.write(_pack({"op": op, **kwargs}))
            await self.writer.drain()

    def new_watch_queue(self) -> Tuple[int, asyncio.Queue]:
        wid = self._next_id
        self._next_id += 1
        q: asyncio.Queue = asyncio.Queue()
        self._watch_queues[wid] = q
        return wid, q

    def new_sub_queue(self) -> Tuple[int, asyncio.Queue]:
        sid = self._next_id
        self._next_id += 1
        q: asyncio.Queue = asyncio.Queue()
        self._sub_queues[sid] = q
        return sid, q

    async def close(self) -> None:
        self._reader_task.cancel()
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except Exception:
            pass


async def connect_control_plane(address: str, timeout: float = 10.0) -> ControlPlaneConnection:
    host, port = address.rsplit(":", 1)
    reader, writer = await asyncio.wait_for(asyncio.open_connection(host, int(port)), timeout)
    conn = ControlPlaneConnection(reader, writer)
    await conn.call("ping")
    return conn


class TcpKvStore(KvStore):
    def __init__(self, conn: ControlPlaneConnection):
        self.conn = conn

    async def put(self, key, value, lease_id=None, create_only=False) -> int:
        r = await self.conn.call("put", key=key, value=value, lease_id=lease_id, create_only=create_only)
        return r["revision"]

    async def get(self, key):
        r = await self.conn.call("get", key=key)
        return _entry_from_wire(r.get("entry"))

    async def get_prefix(self, prefix):
        r = await self.conn.call("get_prefix", prefix=prefix)
        return [_entry_from_wire(e) for e in r["entries"]]

    async def delete(self, key) -> bool:
        return (await self.conn.call("delete", key=key))["deleted"]

    async def delete_prefix(self, prefix) -> int:
        return (await self.conn.call("delete_prefix", prefix=prefix))["count"]

    async def watch_prefix(self, prefix) -> Watch:
        snapshot, watch = await self.get_and_watch_prefix(prefix)
        # Re-inject the snapshot as PUT events to preserve watch_prefix semantics.
        for e in snapshot:
            watch._queue.put_nowait(WatchEvent(EventType.PUT, e.key, e.value, e.revision))
        return watch

    async def get_and_watch_prefix(self, prefix):
        wid, queue = self.conn.new_watch_queue()
        r = await self.conn.call("watch", prefix=prefix, watch_id=wid)
        snapshot = [_entry_from_wire(e) for e in r["entries"]]

        async def cancel(_watch):
            self.conn._watch_queues.pop(wid, None)
            try:
                await self.conn.call("watch_cancel", watch_id=wid)
            except ConnectionError:
                pass

        # Queue was created before the watch call; snapshot events from
        # watch_prefix are injected by the caller above.
        live_watch = Watch(queue, cancel)
        return snapshot, live_watch

    async def grant_lease(self, ttl_s) -> Lease:
        r = await self.conn.call("lease_grant", ttl_s=ttl_s)
        return Lease(self, r["lease_id"], r["ttl_s"])

    async def keep_alive(self, lease_id) -> None:
        await self.conn.call("keep_alive", lease_id=lease_id)

    async def revoke_lease(self, lease_id) -> None:
        await self.conn.call("lease_revoke", lease_id=lease_id)

    async def close(self) -> None:
        pass  # connection shared with pubsub; closed by the runtime


class _TcpStream:
    """Client-side durable stream view (server holds the log)."""

    def __init__(self, conn: ControlPlaneConnection, name: str):
        self.conn = conn
        self.name = name

    async def publish(self, subject, data, headers=None) -> int:
        r = await self.conn.call("s_publish", stream=self.name, subject=subject, data=data, headers=headers or {})
        return r["seq"]

    async def fetch(self, from_seq, max_events=1024) -> List[Message]:
        r = await self.conn.call("s_fetch", stream=self.name, from_seq=from_seq, max_events=max_events)
        return [Message(subject=e["subject"], data=e["data"], headers=e["headers"], seq=e["seq"]) for e in r["events"]]

    async def purge(self, up_to_seq=None) -> None:
        await self.conn.call("s_purge", stream=self.name, up_to_seq=up_to_seq)

    async def consume(self, from_seq: int = 1):
        seq = from_seq
        while True:
            r = await self.conn.call("s_fetch", stream=self.name, from_seq=seq, wait=True, timeout=5.0)
            for e in r["events"]:
                yield Message(subject=e["subject"], data=e["data"], headers=e["headers"], seq=e["seq"])
                seq = e["seq"] + 1
            seq = max(seq, r.get("first_seq", seq))


class _TcpObjectStore:
    def __init__(self, conn: ControlPlaneConnection, bucket: str):
        self.conn = conn
        self.bucket = bucket

    async def put(self, name, data) -> None:
        await self.conn.call("o_put", bucket=self.bucket, name=name, data=data)

    async def get(self, name):
        return (await self.conn.call("o_get", bucket=self.bucket, name=name)).get("data")

    async def delete(self, name) -> bool:
        return (await self.conn.call("o_delete", bucket=self.bucket, name=name))["deleted"]

    async def list(self):
        return (await self.conn.call("o_list", bucket=self.bucket))["names"]


class TcpPubSub(PubSub):
    def __init__(self, conn: ControlPlaneConnection):
        self.conn = conn

    async def publish(self, subject, data, headers=None, reply_to=None) -> None:
        await self.conn.send_nowait("publish", subject=subject, data=data, headers=headers or {}, reply_to=reply_to)

    async def subscribe(self, subject, queue_group=None) -> Subscription:
        sid, queue = self.conn.new_sub_queue()
        await self.conn.call("subscribe", subject=subject, sub_id=sid, queue_group=queue_group)

        async def cancel(_sub):
            self.conn._sub_queues.pop(sid, None)
            try:
                await self.conn.call("unsubscribe", sub_id=sid)
            except ConnectionError:
                pass

        return Subscription(queue, cancel)

    async def stream(self, name) -> _TcpStream:
        return _TcpStream(self.conn, name)

    async def object_store(self, bucket) -> _TcpObjectStore:
        return _TcpObjectStore(self.conn, bucket)

    async def close(self) -> None:
        await self.conn.close()
