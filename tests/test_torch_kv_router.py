"""The port's KV router (``dynamo_tpu_torch/llm/kv_router``) against the
JAX package's on seeded inputs: ``RadixTree`` / ``KvIndexer`` (the JAX
package's pure-Python tree; its ``KvIndexer`` may sit on the C++ one,
whose scores must agree too) give the same overlap scores, sizes, workers
and snapshot dumps over seeded KV-event streams; ``ApproxKvIndexer`` the
same scores across its TTL; ``ActiveSequencesMultiWorker`` the same load
terms; ``KvScheduler`` the same choice at temperature 0 and, from the same
seed, at temperature 1; ``KvEventPublisher`` the same stream payloads,
byte for byte, for the same allocator events; and ``KvPushRouter`` over
live workers the same routing decisions from the same events."""

import asyncio
import json
import random

import numpy as np
import pytest

import dynamo_tpu.engine.kv_cache as j_kv
import dynamo_tpu.llm.kv_router as j_router
import dynamo_tpu.llm.kv_router.indexer as j_indexer
import dynamo_tpu.llm.kv_router.scheduler as j_sched
import dynamo_tpu.runtime.distributed as j_distributed
import dynamo_tpu_torch.engine.kv_cache as p_kv
import dynamo_tpu_torch.llm.kv_router as p_router
import dynamo_tpu_torch.llm.kv_router.indexer as p_indexer
import dynamo_tpu_torch.llm.kv_router.scheduler as p_sched
import dynamo_tpu_torch.runtime.distributed as p_distributed
from dynamo_tpu.llm.tokens import compute_block_hashes as j_hashes
from dynamo_tpu_torch.llm.tokens import compute_block_hashes

BS = 4  # block size of the seeded streams


def event_stream(seed: int, n_events: int = 300, workers=(11, 22, 33)):
    """Seeded (worker, event) pairs: stored chains that branch off shared
    prefixes, removals of stored blocks, and an occasional 'cleared'."""
    rng = np.random.default_rng(seed)
    roots = [rng.integers(1, 50, size=BS * 6).tolist() for _ in range(4)]
    held = {w: [] for w in workers}
    out = []
    for _ in range(n_events):
        w = int(rng.choice(workers))
        r = rng.random()
        if r < 0.6 or not held[w]:
            root = roots[int(rng.integers(len(roots)))]
            cut = int(rng.integers(0, len(root) // BS + 1)) * BS
            tokens = root[:cut] + rng.integers(1, 50, size=BS * int(rng.integers(1, 4))).tolist()
            hashes = compute_block_hashes(tokens, BS)
            start = int(rng.integers(0, len(hashes)))
            parent = hashes[start - 1] if start else None
            out.append((w, {"kind": "stored", "block_hashes": hashes[start:], "parent_hash": parent}))
            held[w].extend(hashes[start:])
        elif r < 0.97:
            k = int(rng.integers(1, min(4, len(held[w])) + 1))
            picks = [held[w][int(i)] for i in rng.choice(len(held[w]), size=k, replace=False)]
            out.append((w, {"kind": "removed", "block_hashes": picks}))
        else:
            out.append((w, {"kind": "cleared"}))
            held[w] = []
    queries = [compute_block_hashes(root[: BS * int(rng.integers(1, 7))] + [1, 2, 3, 4], BS) for root in roots]
    return out, queries


def test_block_hashes_match_jax():
    rng = np.random.default_rng(5)
    for n in (0, 3, 4, 17, 64):
        tokens = rng.integers(0, 128256, size=n).tolist()
        assert compute_block_hashes(tokens, 16) == j_hashes(tokens, 16)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_radix_tree_and_indexer_match_jax(seed):
    events, queries = event_stream(seed)
    mine, ref, ref_native = p_indexer.KvIndexer(block_size=BS), j_indexer.RadixTree(), j_indexer.KvIndexer(BS)
    for i, (w, ev) in enumerate(events):
        mine.apply_event(w, ev)
        ref_native.apply_event(w, ev)
        j_indexer.KvIndexer.apply_event(_Shim(ref), w, ev)
        if i % 25 == 0 or i == len(events) - 1:
            for q in queries:
                want = ref.find_matches(q).scores
                assert mine.find_matches(q).scores == want == ref_native.find_matches(q).scores
            assert mine.size() == ref.size() and mine.tree.workers() == ref.workers()
    assert mine.dump() == ref.dump()
    assert mine.events_applied == len(events)
    # A snapshot restores to the same scores, in either package.
    restored = p_indexer.RadixTree.load(mine.dump())
    for q in queries:
        assert restored.find_matches(q).scores == j_indexer.RadixTree.load(ref.dump()).find_matches(q).scores
    for w in (11, 22):
        mine.remove_worker(w)
        ref.remove_worker(w)
    assert mine.dump() == ref.dump() and mine.tree.workers() == ref.workers()


class _Shim:
    """Runs JAX ``KvIndexer.apply_event`` over a given (pure-Python) tree."""

    def __init__(self, tree):
        self.tree = tree
        self.events_applied = 0


def test_find_matches_for_tokens_matches_jax():
    mine, ref = p_indexer.KvIndexer(block_size=BS), j_indexer.KvIndexer(block_size=BS)
    tokens = list(range(1, 30))
    for idx in (mine, ref):
        idx.apply_event(5, {"kind": "stored", "block_hashes": compute_block_hashes(tokens[:16], BS),
                            "parent_hash": None})
    assert mine.find_matches_for_tokens(tokens).scores == ref.find_matches_for_tokens(tokens).scores == {5: 4}


def test_approx_indexer_matches_jax_across_its_ttl():
    rng = np.random.default_rng(7)
    mine, ref = p_router.ApproxKvIndexer(block_size=BS, ttl_s=10.0), j_router.ApproxKvIndexer(block_size=BS,
                                                                                               ttl_s=10.0)
    prompts = [rng.integers(1, 20, size=int(rng.integers(4, 30))).tolist() for _ in range(20)]
    for i, p in enumerate(prompts):
        for idx in (mine, ref):
            idx.process_routing_decision(i % 3, p)
    for now_shift in (0.0, 1e9):
        base = __import__("time").monotonic() + now_shift
        assert mine.expire(base) == ref.expire(base)
        for p in prompts:
            h = compute_block_hashes(p, BS)
            assert mine.tree.find_matches(h).scores == ref.tree.find_matches(h).scores


def _load_ops(seed):
    rng = np.random.default_rng(seed)
    ops, live = [], []
    for i in range(200):
        r = rng.random()
        if r < 0.5 or not live:
            rid = f"r{i}"
            ops.append(("add", rid, int(rng.integers(0, 4)), int(rng.integers(1, 300)), int(rng.integers(0, 10))))
            live.append(rid)
        elif r < 0.75:
            ops.append(("prefill_done", live[int(rng.integers(len(live)))]))
        else:
            ops.append(("free", live.pop(int(rng.integers(len(live))))))
    return ops


@pytest.mark.parametrize("seed", [0, 1])
def test_active_sequences_match_jax(seed):
    seqs = [p_router.ActiveSequencesMultiWorker(block_size=16), j_router.ActiveSequencesMultiWorker(block_size=16)]
    for op in _load_ops(seed):
        for s in seqs:
            if op[0] == "add":
                s.add_request(*op[1:])
            elif op[0] == "prefill_done":
                s.mark_prefill_done(op[1])
            else:
                s.free(op[1])
        mine, ref = seqs
        for w in range(4):
            assert (mine.prefill_tokens(w), mine.decode_blocks(w), mine.active_requests(w)) == (
                ref.prefill_tokens(w), ref.decode_blocks(w), ref.active_requests(w))
    seqs[0].remove_worker(1)
    seqs[1].remove_worker(1)
    assert seqs[0]._seqs.keys() == seqs[1]._seqs.keys()


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_scheduler_choices_match_jax(temperature):
    rng = np.random.default_rng(3)
    loads = [p_router.ActiveSequencesMultiWorker(block_size=16), j_router.ActiveSequencesMultiWorker(block_size=16)]
    scheds = [p_sched.KvScheduler(loads[0], temperature=temperature, rng=random.Random(9)),
              j_sched.KvScheduler(loads[1], temperature=temperature, rng=random.Random(9))]
    for i in range(300):
        workers = sorted(int(w) for w in rng.choice(8, size=int(rng.integers(1, 6)), replace=False))
        scores = {w: int(rng.integers(0, 12)) for w in workers if rng.random() < 0.6}
        prompt_blocks = int(rng.integers(1, 12))
        fractions = {w: float(rng.choice([0.25, 0.5, 0.75])) for w in workers if rng.random() < 0.3}
        got = [s.select_worker(workers, prompt_blocks, mod.OverlapScores(scores=dict(scores)),
                               prefill_fractions=fractions)
               for s, mod in zip(scheds, (p_indexer, j_indexer))]
        assert (got[0].worker, got[0].overlap_blocks, got[0].cost) == (got[1].worker, got[1].overlap_blocks,
                                                                        got[1].cost)
        for s in loads:
            s.add_request(f"q{i}", got[0].worker, prompt_blocks * 16, got[0].overlap_blocks)
            if i % 3 == 0:
                s.free(f"q{i - 2}")


def _allocator_events(kv):
    """The same allocator ops on ``kv``'s BlockAllocator: allocate, register
    two chains (one extending the other), release, evict through a new
    allocation, clear the cache. → the KvEvents it raised."""
    events = []
    a = kv.BlockAllocator(6, on_event=events.append)
    a._free.remove(0)
    toks = list(range(1, 17))
    h = compute_block_hashes(toks, BS)
    first = a.allocate(2)
    a.register_hashes(first, h[:2])
    second = a.allocate(2)
    a.register_hashes(second, h[2:4])
    a.release(first + second)
    a.allocate(4)  # evicts cached blocks
    a.clear_cached()
    return events


def test_kv_event_publisher_payloads_match_jax():
    async def payloads(router_mod, drt_mod, kv):
        drt = await drt_mod.DistributedRuntime.detached()
        pub = router_mod.KvEventPublisher(drt, "dynamo", "backend", 0x1F)
        pub.start()
        loop = asyncio.get_running_loop()
        for i, ev in enumerate(_allocator_events(kv)):
            ev.ts = 1000.0 + i
            pub.publish_threadsafe(loop, ev)
        await asyncio.sleep(0.05)
        await pub.stop()
        stream = await drt.bus.stream(router_mod.kv_events_stream_name("dynamo", "backend"))
        out = [(m.subject, m.data) for m in await stream.fetch(1)]
        await drt.shutdown()
        return out

    mine = asyncio.run(payloads(p_router, p_distributed, p_kv))
    ref = asyncio.run(payloads(j_router, j_distributed, j_kv))
    assert mine == ref and len(mine) >= 3
    assert {json.loads(d)["kind"] for _, d in mine} >= {"stored", "removed"}


def test_metrics_payload_keys_are_jax_keys():
    from dynamo_tpu.engine.scheduler import ForwardPassMetrics as JaxMetrics
    from dynamo_tpu_torch.engine.scheduler import ForwardPassMetrics

    assert set(ForwardPassMetrics().to_wire()) <= set(JaxMetrics().to_wire())
    assert p_router.kv_metrics_subject("a", "b") == j_router.kv_metrics_subject("a", "b")
    assert p_router.kv_events_stream_name("a", "b") == j_router.kv_events_stream_name("a", "b")


async def _route(router_mod, drt_mod, events, prompts):
    """Two echo workers behind a KvPushRouter on one runtime (wire path);
    the KV events go on the stream under the workers' ids (worker i = the
    i-th lowest id); each prompt is routed in turn. → the chosen worker's
    rank per prompt and the router's reuse accounting."""
    drt = await drt_mod.DistributedRuntime.detached()
    try:
        ep = drt.namespace("dynamo").component("backend").endpoint("generate")

        async def echo(request, context):
            yield {"token_ids": [1], "finish_reason": "length", "cached_tokens": 8}

        for _ in range(2):
            h = await ep.serve_endpoint(echo)
            drt.local_engines.pop(h.instance.instance_id)
        client = await ep.client()
        await client.wait_for_instances(2, timeout=5)
        ids = client.instance_ids()
        router = await router_mod.KvPushRouter.create(client, router_mod.KvRouterConfig(block_size=BS))
        stream = await drt.bus.stream(router_mod.kv_events_stream_name("dynamo", "backend"))
        for rank, ev in events:
            await stream.publish(stream.name, json.dumps({"worker_id": ids[rank], **ev}).encode())
        while router.indexer.events_applied < len(events):
            await asyncio.sleep(0.01)
        chosen = []
        for p in prompts:
            decision = await router.schedule(p)
            chosen.append(ids.index(decision.worker))
            async for _ in router.generate({"token_ids": p}):
                pass
        stats = router.stats()
        await router.close()
        return chosen, stats["predicted_cached_tokens_total"], stats["cached_tokens_total"]
    finally:
        await drt.shutdown()


def test_kv_push_router_decisions_match_jax():
    rng = np.random.default_rng(11)
    fam = [rng.integers(1, 50, size=BS * 5).tolist() for _ in range(3)]
    events = [(0, {"kind": "stored", "block_hashes": compute_block_hashes(fam[0], BS), "parent_hash": None}),
              (1, {"kind": "stored", "block_hashes": compute_block_hashes(fam[1], BS), "parent_hash": None}),
              (1, {"kind": "stored", "block_hashes": compute_block_hashes(fam[0][:8], BS), "parent_hash": None})]
    prompts = [f + [7, 8, 9] for f in fam] + [fam[0][:BS * 3] + [1, 2, 3]] + [fam[2] + [5]]
    mine = asyncio.run(_route(p_router, p_distributed, events, prompts))
    ref = asyncio.run(_route(j_router, j_distributed, events, prompts))
    assert mine == ref
    assert mine[0][:2] == [0, 1]  # each family goes to the worker that holds it
