"""The port's durable work queue (``dynamo_tpu_torch/runtime/work_queue.py``)
on the port's runtime, in ``tests/test_work_queue.py``'s cases: enqueue,
claim and ack; competing consumers each take every item once; a dead
consumer's claim (its lease lapsed) is redelivered, and so is a lease-less
claim past its deadline; an acked prefix is purged from the stream with its
done markers. The keys are the JAX package's (``wq/{name}/claim|done/...``).
"""

import asyncio

from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.work_queue import WorkQueue


async def test_enqueue_dequeue_ack():
    drt = await DistributedRuntime.detached()
    try:
        q = WorkQueue(drt.store, drt.bus, "jobs")
        await q.enqueue(b"a")
        await q.enqueue(b"b")
        assert await q.depth() == 2
        item = await q.dequeue(timeout=1)
        assert item.data == b"a"
        assert await q.depth() == 1
        assert [e.key for e in await drt.store.get_prefix("wq/jobs/claim/")] == [f"wq/jobs/claim/{item.seq:020d}"]
        await item.ack()
        item2 = await q.dequeue(timeout=1)
        assert item2.data == b"b"
        await item2.ack()
        assert await q.depth() == 0
        assert await q.dequeue(timeout=0.1) is None
    finally:
        await drt.shutdown()


async def test_competing_consumers_each_item_once():
    drt = await DistributedRuntime.detached()
    try:
        producer = WorkQueue(drt.store, drt.bus, "jobs")
        for i in range(20):
            await producer.enqueue(str(i).encode())
        seen = []

        async def consume(name):
            q = WorkQueue(drt.store, drt.bus, "jobs")
            while True:
                item = await q.dequeue(timeout=0.3)
                if item is None:
                    return
                seen.append((name, item.data))
                await item.ack()

        await asyncio.gather(consume("c1"), consume("c2"), consume("c3"))
        assert sorted(int(d) for _, d in seen) == list(range(20))
    finally:
        await drt.shutdown()


async def test_dead_consumer_claim_redelivered():
    drt = await DistributedRuntime.detached()
    try:
        drt.store._reaper_interval_s = 0.05
        q = WorkQueue(drt.store, drt.bus, "jobs")
        await q.enqueue(b"task")
        lease = await drt.store.grant_lease(0.15)
        dead = WorkQueue(drt.store, drt.bus, "jobs", lease_id=lease.id)
        item = await dead.dequeue(timeout=1)
        assert item is not None and item.data == b"task"
        other = WorkQueue(drt.store, drt.bus, "jobs")
        redelivered = await other.dequeue(timeout=2)
        assert redelivered is not None and redelivered.data == b"task"
        await redelivered.ack()
    finally:
        await drt.shutdown()


async def test_leaseless_claim_stolen_after_its_deadline():
    drt = await DistributedRuntime.detached()
    try:
        q = WorkQueue(drt.store, drt.bus, "jobs", claim_ttl_s=0.1)
        await q.enqueue(b"task")
        first = await q.dequeue(timeout=1)
        other = WorkQueue(drt.store, drt.bus, "jobs")
        assert await other.dequeue(timeout=0.05) is None  # the claim is live
        await asyncio.sleep(0.15)
        stolen = await other.dequeue(timeout=1)
        assert stolen is not None and stolen.seq == first.seq
        await stolen.ack()
        assert await other.dequeue(timeout=0.1) is None
    finally:
        await drt.shutdown()


async def test_acked_prefix_purged():
    drt = await DistributedRuntime.detached()
    try:
        q = WorkQueue(drt.store, drt.bus, "jobs")
        for i in range(5):
            await q.enqueue(str(i).encode())
        for _ in range(5):
            item = await q.dequeue(timeout=1)
            await item.ack()
        stream = await drt.bus.stream("wq_jobs")
        assert stream.first_seq == 6
        assert await drt.store.get_prefix("wq/jobs/done/") == []
    finally:
        await drt.shutdown()
