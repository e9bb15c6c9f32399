"""Durable competing-consumer work queue (the NATS JetStream work-queue role).

A copy of the JAX package's ``runtime/work_queue.py`` over the port's
``KvStore`` and ``Stream``: the same keys, so both packages' producers and
consumers share one queue on one control plane.

Ref: the reference's ``NatsQueue`` (lib/bindings/python src/dynamo/_core.pyi:894
— enqueue_task/dequeue_task over a JetStream work-queue stream), used by the
trtllm backend's prefill-first disaggregation path to hand prefill work to
whichever prefill worker pulls it next.

Design on this runtime's primitives (no new transport surface):
- Items live in a durable ``Stream`` (sequence-numbered, replayable).
- A claim is an atomic create-only KV key ``wq/{name}/claim/{seq}`` bound to
  the consumer's lease: two consumers can never claim the same item, and a
  dead consumer's claim evaporates with its lease so the item is redelivered.
- Consumers without a lease get a claim *deadline* instead (``claim_ttl_s``,
  stored in the claim value): a consumer that crashes between claim and ack
  only delays redelivery until the deadline passes — items are never
  orphaned either way. The deadline is the *writer's* wall clock read by
  other hosts, so ``claim_ttl_s`` must be generous relative to inter-host
  clock skew (default 60 s ≫ NTP skew); a thief re-checks the done marker
  after winning a stolen claim, which narrows (but cannot fully close,
  absent CAS) the window where a slow-but-alive claimant's late ack races
  the steal — the queue is at-least-once, consumers must be idempotent.
- Ack writes ``wq/{name}/done/{seq}`` (unleased — completion survives the
  worker) and drops the claim; fully-acked prefixes are purged from the
  stream opportunistically.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Optional

from dynamo_tpu_torch.runtime.transports.kvstore import KeyExists, KvStore
from dynamo_tpu_torch.runtime.transports.pubsub import PubSub, Stream

_POLL_S = 0.05


@dataclass
class QueueItem:
    seq: int
    data: bytes
    _queue: "WorkQueue"

    async def ack(self) -> None:
        await self._queue._ack(self.seq)


class WorkQueue:
    """Competing-consumer queue: many producers, many consumers, each item
    delivered to exactly one live consumer (redelivered if that consumer's
    lease dies before ack)."""

    def __init__(
        self,
        store: KvStore,
        bus: PubSub,
        name: str,
        lease_id: Optional[int] = None,
        claim_ttl_s: float = 60.0,
    ):
        self.store = store
        self.bus = bus
        self.name = name
        self.lease_id = lease_id
        # Deadline for lease-less claims: a crashed consumer's claim is
        # reclaimable after this long. Leased claims expire with the lease.
        self.claim_ttl_s = claim_ttl_s
        self._stream: Optional[Stream] = None
        self._cursor = 1  # lowest seq that might still be claimable

    async def _ensure_stream(self) -> Stream:
        if self._stream is None:
            self._stream = await self.bus.stream(f"wq_{self.name}")
        return self._stream

    def _claim_key(self, seq: int) -> str:
        return f"wq/{self.name}/claim/{seq:020d}"

    def _done_key(self, seq: int) -> str:
        return f"wq/{self.name}/done/{seq:020d}"

    async def enqueue(self, payload: bytes) -> int:
        stream = await self._ensure_stream()
        return await stream.publish(self.name, payload)

    async def depth(self) -> int:
        """Items neither acked nor currently claimed (i.e. available)."""
        stream = await self._ensure_stream()
        done = {e.key for e in await self.store.get_prefix(f"wq/{self.name}/done/")}
        claimed = {e.key for e in await self.store.get_prefix(f"wq/{self.name}/claim/")}
        n = 0
        for msg in await stream.fetch(stream.first_seq):
            if self._done_key(msg.seq) not in done and self._claim_key(msg.seq) not in claimed:
                n += 1
        return n

    async def dequeue(self, timeout: Optional[float] = None) -> Optional[QueueItem]:
        """Claim the next available item, waiting up to ``timeout`` (forever
        if None). Returns None on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        stream = await self._ensure_stream()
        while True:
            item = await self._try_claim(stream)
            if item is not None:
                return item
            if deadline is not None and time.monotonic() >= deadline:
                return None
            # New items arrive via publish; reclaimable items via lease
            # expiry — both are cheap to poll at this cadence.
            await asyncio.sleep(_POLL_S)

    async def _try_claim(self, stream: Stream) -> Optional[QueueItem]:
        batch = await stream.fetch(max(self._cursor, stream.first_seq))
        advance = True
        now = time.time()
        for msg in batch:
            if await self.store.get(self._done_key(msg.seq)) is not None:
                if advance:
                    self._cursor = msg.seq + 1
                continue
            existing = await self.store.get(self._claim_key(msg.seq))
            stole = existing is not None
            if existing is not None:
                # Lease-less claims carry a deadline; expired ⇒ the claimant
                # died between claim and ack — steal it. (Delete + create_only
                # races resolve atomically: one thief wins, others KeyExists.)
                try:
                    expired = existing.value and float(existing.value) < now
                except ValueError:
                    expired = False
                if not expired:
                    advance = False  # live claim by a peer; may still come back
                    continue
                await self.store.delete(self._claim_key(msg.seq))
            claim_val = b"" if self.lease_id is not None else str(now + self.claim_ttl_s).encode()
            try:
                await self.store.put(
                    self._claim_key(msg.seq), claim_val, lease_id=self.lease_id, create_only=True
                )
            except KeyExists:
                advance = False
                continue
            # On a steal, re-check done AFTER winning the claim: the previous
            # claimant may have acked between our done-check and the
            # delete/re-claim above. This narrows the duplicate window; it
            # cannot close it (an alive-but-slow claimant can still ack after
            # this check — at-least-once semantics, see class docstring).
            # Fresh claims skip the round-trip.
            if stole and await self.store.get(self._done_key(msg.seq)) is not None:
                await self.store.delete(self._claim_key(msg.seq))
                if advance:
                    self._cursor = msg.seq + 1
                continue
            return QueueItem(seq=msg.seq, data=msg.data, _queue=self)
        return None

    async def _ack(self, seq: int) -> None:
        await self.store.put(self._done_key(seq), b"")
        await self.store.delete(self._claim_key(seq))
        await self._maybe_purge()

    async def _maybe_purge(self) -> None:
        """Purge the longest fully-acked prefix from the stream and drop its
        done-markers, bounding state growth."""
        stream = await self._ensure_stream()
        upto = 0
        for msg in await stream.fetch(stream.first_seq):
            if await self.store.get(self._done_key(msg.seq)) is None:
                break
            upto = msg.seq
        if upto:
            await stream.purge(upto)
            for e in await self.store.get_prefix(f"wq/{self.name}/done/"):
                if int(e.key.rsplit("/", 1)[1]) <= upto:
                    await self.store.delete(e.key)
