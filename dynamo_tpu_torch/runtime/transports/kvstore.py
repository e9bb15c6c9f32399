"""Key-value store with leases and prefix watches: the control plane's
discovery and registration substrate (the etcd role).

A copy of the JAX package's ``runtime/transports/kvstore.py``:
- keys may be bound to a *lease*; when the lease expires or is revoked its
  keys are deleted and watchers see DELETE events. Instance discovery
  (``instances/{ns}/{comp}/{ep}:{lease_id:x}``) rides on this: a dead
  worker's lease lapses and every router's watch prunes it;
- ``watch_prefix`` yields the current snapshot (PUT events), then deltas;
- ``put`` has a create-only mode for locks.
"""

from __future__ import annotations

import asyncio
import enum
import time
import uuid
from dataclasses import dataclass, field
from typing import AsyncIterator, Dict, List, Optional, Tuple


class EventType(enum.Enum):
    PUT = "put"
    DELETE = "delete"


@dataclass
class WatchEvent:
    type: EventType
    key: str
    value: Optional[bytes]
    revision: int = 0


@dataclass
class KvEntry:
    key: str
    value: bytes
    lease_id: Optional[int] = None
    revision: int = 0


class LeaseExpired(Exception):
    pass


class KeyExists(Exception):
    """Raised by create-only put when the key is already present."""


class Lease:
    """A client-held lease. ``keep_alive`` is managed by the store; callers
    use the lease id to bind keys and ``revoke()`` on shutdown."""

    def __init__(self, store: "KvStore", lease_id: int, ttl_s: float):
        self.store = store
        self.id = lease_id
        self.ttl_s = ttl_s
        self._revoked = asyncio.Event()

    @property
    def revoked(self) -> bool:
        return self._revoked.is_set()

    async def revoke(self) -> None:
        if not self._revoked.is_set():
            self._revoked.set()
            await self.store.revoke_lease(self.id)


class Watch:
    """Handle returned by ``watch_prefix``: an async iterator of WatchEvents
    plus a cancel method."""

    def __init__(self, queue: "asyncio.Queue[Optional[WatchEvent]]", cancel_cb) -> None:
        self._queue = queue
        self._cancel_cb = cancel_cb
        self._cancelled = False

    def __aiter__(self) -> AsyncIterator[WatchEvent]:
        return self._gen()

    async def _gen(self) -> AsyncIterator[WatchEvent]:
        while True:
            ev = await self._queue.get()
            if ev is None:
                return
            yield ev

    async def cancel(self) -> None:
        if not self._cancelled:
            self._cancelled = True
            await self._cancel_cb(self)
            await self._queue.put(None)


class KvStore:
    """Abstract KV store interface. Async, linearizable per key."""

    async def put(
        self,
        key: str,
        value: bytes,
        lease_id: Optional[int] = None,
        create_only: bool = False,
    ) -> int:
        raise NotImplementedError

    async def get(self, key: str) -> Optional[KvEntry]:
        raise NotImplementedError

    async def get_prefix(self, prefix: str) -> List[KvEntry]:
        raise NotImplementedError

    async def delete(self, key: str) -> bool:
        raise NotImplementedError

    async def delete_prefix(self, prefix: str) -> int:
        raise NotImplementedError

    async def watch_prefix(self, prefix: str) -> Watch:
        """Snapshot (as PUT events) + live updates."""
        raise NotImplementedError

    async def get_and_watch_prefix(self, prefix: str) -> Tuple[List[KvEntry], Watch]:
        """Atomic snapshot + deltas-only watch: no gap, no duplicates."""
        raise NotImplementedError

    async def grant_lease(self, ttl_s: float) -> Lease:
        raise NotImplementedError

    async def keep_alive(self, lease_id: int) -> None:
        raise NotImplementedError

    async def revoke_lease(self, lease_id: int) -> None:
        raise NotImplementedError

    async def close(self) -> None:
        pass


@dataclass
class _MemLease:
    id: int
    ttl_s: float
    deadline: float
    keys: set = field(default_factory=set)


class MemKvStore(KvStore):
    """In-process store.

    Leases expire via a reaper task; `keep_alive` pushes the deadline out.
    Suitable for single-process deployments and unit tests; the TCP
    control-plane server wraps one of these.
    """

    def __init__(self, *, reaper_interval_s: float = 0.5):
        self._data: Dict[str, KvEntry] = {}
        self._leases: Dict[int, _MemLease] = {}
        self._watches: List[Tuple[str, asyncio.Queue]] = []
        self._revision = 0
        self._lock = asyncio.Lock()
        self._reaper_interval_s = reaper_interval_s
        self._reaper_task: Optional[asyncio.Task] = None
        self._closed = False

    def _ensure_reaper(self) -> None:
        if self._reaper_task is None or self._reaper_task.done():
            self._reaper_task = asyncio.get_running_loop().create_task(self._reaper())

    async def _reaper(self) -> None:
        try:
            while not self._closed:
                await asyncio.sleep(self._reaper_interval_s)
                now = time.monotonic()
                expired = [l.id for l in self._leases.values() if l.deadline < now]
                for lid in expired:
                    await self.revoke_lease(lid)
        except asyncio.CancelledError:
            pass

    def _notify(self, ev: WatchEvent) -> None:
        for prefix, queue in self._watches:
            if ev.key.startswith(prefix):
                queue.put_nowait(ev)

    async def put(self, key, value, lease_id=None, create_only=False) -> int:
        async with self._lock:
            if create_only and key in self._data:
                raise KeyExists(key)
            prev = self._data.get(key)
            if prev is not None and prev.lease_id is not None and prev.lease_id != lease_id:
                # Re-binding a key to a different lease (e.g. a second worker
                # re-registering the shared model entry): the OLD lease must
                # stop owning it, or that worker's drain/crash would delete a
                # key the survivor still backs.
                old = self._leases.get(prev.lease_id)
                if old is not None:
                    old.keys.discard(key)
            if lease_id is not None:
                lease = self._leases.get(lease_id)
                if lease is None:
                    raise LeaseExpired(f"lease {lease_id:x} not found")
                lease.keys.add(key)
            self._revision += 1
            entry = KvEntry(key=key, value=value, lease_id=lease_id, revision=self._revision)
            self._data[key] = entry
            self._notify(WatchEvent(EventType.PUT, key, value, self._revision))
            return self._revision

    async def get(self, key) -> Optional[KvEntry]:
        return self._data.get(key)

    async def get_prefix(self, prefix) -> List[KvEntry]:
        return [e for k, e in sorted(self._data.items()) if k.startswith(prefix)]

    async def delete(self, key) -> bool:
        async with self._lock:
            entry = self._data.pop(key, None)
            if entry is None:
                return False
            if entry.lease_id is not None:
                lease = self._leases.get(entry.lease_id)
                if lease:
                    lease.keys.discard(key)
            self._revision += 1
            self._notify(WatchEvent(EventType.DELETE, key, None, self._revision))
            return True

    async def delete_prefix(self, prefix) -> int:
        keys = [k for k in list(self._data) if k.startswith(prefix)]
        n = 0
        for k in keys:
            n += bool(await self.delete(k))
        return n

    async def watch_prefix(self, prefix) -> Watch:
        queue: asyncio.Queue = asyncio.Queue()
        async with self._lock:
            # Snapshot first, then register for deltas: no gap, no duplicates.
            for e in sorted(self._data.items()):
                if e[0].startswith(prefix):
                    queue.put_nowait(WatchEvent(EventType.PUT, e[1].key, e[1].value, e[1].revision))
            return self._register_watch(prefix, queue)

    async def get_and_watch_prefix(self, prefix) -> Tuple[List[KvEntry], Watch]:
        queue: asyncio.Queue = asyncio.Queue()
        async with self._lock:
            snapshot = [e for k, e in sorted(self._data.items()) if k.startswith(prefix)]
            return snapshot, self._register_watch(prefix, queue)

    def _register_watch(self, prefix: str, queue: "asyncio.Queue") -> Watch:
        pair = (prefix, queue)
        self._watches.append(pair)

        async def cancel(_watch, pair=pair):
            async with self._lock:
                if pair in self._watches:
                    self._watches.remove(pair)

        return Watch(queue, cancel)

    async def grant_lease(self, ttl_s) -> Lease:
        self._ensure_reaper()
        lease_id = uuid.uuid4().int & 0x7FFF_FFFF_FFFF_FFFF
        self._leases[lease_id] = _MemLease(id=lease_id, ttl_s=ttl_s, deadline=time.monotonic() + ttl_s)
        return Lease(self, lease_id, ttl_s)

    async def keep_alive(self, lease_id) -> None:
        lease = self._leases.get(lease_id)
        if lease is None:
            raise LeaseExpired(f"lease {lease_id:x} not found")
        lease.deadline = time.monotonic() + lease.ttl_s

    async def revoke_lease(self, lease_id) -> None:
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return
        for key in list(lease.keys):
            await self.delete(key)

    async def close(self) -> None:
        self._closed = True
        if self._reaper_task is not None:
            self._reaper_task.cancel()
            self._reaper_task = None
        for _, q in self._watches:
            q.put_nowait(None)
        self._watches.clear()

