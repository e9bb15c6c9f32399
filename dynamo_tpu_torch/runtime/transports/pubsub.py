"""Pub/sub messaging: the NATS role.

A copy of the JAX package's ``runtime/transports/pubsub.py`` without its
fault-injection hook (``faults.afire("bus.publish")``, ROADMAP Queue 1 item
20):
- :meth:`PubSub.subscribe` — subject subscription, with queue groups;
- :meth:`PubSub.request` — request/reply over inbox subjects;
- :class:`Stream` — a durable, replayable, sequence-numbered event log
  (the JetStream role; KV events ride it);
- :class:`ObjectStore` — named blobs (router radix snapshots).

Implementations: in-memory (this file) and the TCP control-plane client
(``dynamo_tpu_torch.runtime.transports.tcp_control``).
"""

from __future__ import annotations

import asyncio
import uuid
from dataclasses import dataclass, field
from typing import AsyncIterator, Dict, List, Optional, Tuple


@dataclass
class Message:
    subject: str
    data: bytes
    headers: Dict[str, str] = field(default_factory=dict)
    reply_to: Optional[str] = None
    seq: int = 0


class Subscription:
    def __init__(self, queue: "asyncio.Queue[Optional[Message]]", cancel_cb):
        self._queue = queue
        self._cancel_cb = cancel_cb
        self._done = False

    def __aiter__(self) -> AsyncIterator[Message]:
        return self._gen()

    async def _gen(self) -> AsyncIterator[Message]:
        while True:
            msg = await self._queue.get()
            if msg is None:
                return
            yield msg

    async def next(self, timeout: Optional[float] = None) -> Optional[Message]:
        try:
            if timeout is None:
                msg = await self._queue.get()
            else:
                msg = await asyncio.wait_for(self._queue.get(), timeout)
        except asyncio.TimeoutError:
            return None
        return msg

    async def unsubscribe(self) -> None:
        if not self._done:
            self._done = True
            await self._cancel_cb(self)
            self._queue.put_nowait(None)


def subject_matches(pattern: str, subject: str) -> bool:
    """NATS-style matching: tokens split on '.', '*' matches one token,
    '>' matches one or more trailing tokens (as in real NATS: 'a.>' does
    not match 'a')."""
    pt, st = pattern.split("."), subject.split(".")
    for i, tok in enumerate(pt):
        if tok == ">":
            return len(st) > i
        if i >= len(st):
            return False
        if tok != "*" and tok != st[i]:
            return False
    return len(pt) == len(st)


class PubSub:
    """Abstract pub/sub interface."""

    async def publish(
        self,
        subject: str,
        data: bytes,
        headers: Optional[Dict[str, str]] = None,
        reply_to: Optional[str] = None,
    ) -> None:
        raise NotImplementedError

    async def subscribe(self, subject: str, queue_group: Optional[str] = None) -> Subscription:
        raise NotImplementedError

    async def request(
        self,
        subject: str,
        data: bytes,
        headers: Optional[Dict[str, str]] = None,
        timeout: float = 30.0,
    ) -> Message:
        """Request/reply over an ephemeral inbox subject."""
        inbox = f"_inbox.{uuid.uuid4().hex}"
        sub = await self.subscribe(inbox)
        try:
            await self.publish(subject, data, headers, reply_to=inbox)
            msg = await sub.next(timeout=timeout)
            if msg is None:
                raise asyncio.TimeoutError(f"request to {subject} timed out")
            return msg
        finally:
            await sub.unsubscribe()

    # --- durable streams (JetStream role) ---
    async def stream(self, name: str) -> "Stream":
        raise NotImplementedError

    # --- object store ---
    async def object_store(self, bucket: str) -> "ObjectStore":
        raise NotImplementedError

    async def close(self) -> None:
        pass


class Stream:
    """Durable sequence-numbered event log with replay (the JetStream role):
    the KV-event stream the router consumes, with snapshot+purge
    compaction."""

    def __init__(self, name: str):
        self.name = name
        self._events: List[Message] = []
        self._first_seq = 1  # seq of _events[0]
        self._next_seq = 1
        self._waiters: List[asyncio.Event] = []
        self._lock = asyncio.Lock()

    async def publish(self, subject: str, data: bytes, headers: Optional[Dict[str, str]] = None) -> int:
        async with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            self._events.append(Message(subject=subject, data=data, headers=headers or {}, seq=seq))
            for w in self._waiters:
                w.set()
            self._waiters.clear()
            return seq

    @property
    def last_seq(self) -> int:
        return self._next_seq - 1

    @property
    def first_seq(self) -> int:
        return self._first_seq

    async def purge(self, up_to_seq: Optional[int] = None) -> None:
        """Drop events with seq <= up_to_seq (all if None) — used after the
        router uploads a radix snapshot."""
        async with self._lock:
            if up_to_seq is None:
                up_to_seq = self._next_seq - 1
            up_to_seq = min(up_to_seq, self._next_seq - 1)
            drop = up_to_seq - self._first_seq + 1
            if drop > 0:
                del self._events[:drop]
                self._first_seq = up_to_seq + 1

    async def fetch(self, from_seq: int, max_events: int = 1024) -> List[Message]:
        async with self._lock:
            if from_seq < self._first_seq:
                from_seq = self._first_seq
            idx = from_seq - self._first_seq
            return list(self._events[idx : idx + max_events])

    async def consume(self, from_seq: int = 1) -> AsyncIterator[Message]:
        """Yield events from ``from_seq`` onward, then follow the tail."""
        seq = max(from_seq, self._first_seq)
        while True:
            batch = await self.fetch(seq)
            if batch:
                for msg in batch:
                    yield msg
                seq = batch[-1].seq + 1
                continue
            ev = asyncio.Event()
            async with self._lock:
                if self._next_seq - 1 >= seq:
                    continue
                self._waiters.append(ev)
            await ev.wait()


class ObjectStore:
    """Named blob store (the NATS object-store role; router snapshots live
    here)."""

    def __init__(self, bucket: str):
        self.bucket = bucket
        self._objects: Dict[str, bytes] = {}

    async def put(self, name: str, data: bytes) -> None:
        self._objects[name] = data

    async def get(self, name: str) -> Optional[bytes]:
        return self._objects.get(name)

    async def delete(self, name: str) -> bool:
        return self._objects.pop(name, None) is not None

    async def list(self) -> List[str]:
        return sorted(self._objects)


class MemPubSub(PubSub):
    """In-process broker. Queue groups pick one subscriber round-robin per
    group, mirroring NATS queue semantics (used by the prefill queue)."""

    def __init__(self):
        # (pattern, queue_group, queue)
        self._subs: List[Tuple[str, Optional[str], asyncio.Queue]] = []
        self._rr: Dict[Tuple[str, str], int] = {}
        self._streams: Dict[str, Stream] = {}
        self._buckets: Dict[str, ObjectStore] = {}
        self._lock = asyncio.Lock()

    async def publish(self, subject, data, headers=None, reply_to=None) -> None:
        msg = Message(subject=subject, data=data, headers=headers or {}, reply_to=reply_to)
        async with self._lock:
            # Group queue-group subscribers; deliver to every plain subscriber.
            groups: Dict[str, List[asyncio.Queue]] = {}
            for pattern, qg, queue in self._subs:
                if not subject_matches(pattern, subject):
                    continue
                if qg is None:
                    queue.put_nowait(msg)
                else:
                    groups.setdefault(f"{pattern}|{qg}", []).append(queue)
            for key, queues in groups.items():
                idx = self._rr.get((key, subject), 0) % len(queues)
                self._rr[(key, subject)] = idx + 1
                queues[idx].put_nowait(msg)

    async def subscribe(self, subject, queue_group=None) -> Subscription:
        queue: asyncio.Queue = asyncio.Queue()
        entry = (subject, queue_group, queue)
        async with self._lock:
            self._subs.append(entry)

        async def cancel(_sub, entry=entry):
            async with self._lock:
                if entry in self._subs:
                    self._subs.remove(entry)

        return Subscription(queue, cancel)

    async def stream(self, name) -> Stream:
        async with self._lock:
            if name not in self._streams:
                self._streams[name] = Stream(name)
            return self._streams[name]

    async def object_store(self, bucket) -> ObjectStore:
        async with self._lock:
            if bucket not in self._buckets:
                self._buckets[bucket] = ObjectStore(bucket)
            return self._buckets[bucket]

    async def close(self) -> None:
        async with self._lock:
            for _, _, q in self._subs:
                q.put_nowait(None)
            self._subs.clear()
