"""The KV router's options (``KvRouterConfig``'s every field) against the JAX
package's, after its ``test_sharded_indexer.py`` and ``test_kv_router.py``
cases, on seeded inputs:

- the config has every JAX field with the JAX default (and the port's
  ``busy_threshold``);
- ``KvIndexerSharded`` gives the plain indexer's and the JAX sharded
  indexer's scores, pins workers to shards, and round-trips snapshots;
- ``PrefillCountersMultiWorker``: one router's pending prefills gossip to
  the other and not to itself, a late ``complete`` is harmless, and two
  ``KvPushRouter``s with ``track_prefill_counters`` see each other's;
- approximate mode (``use_kv_events=False``): the router's own decisions
  feed its TTL index, as JAX's do, and it subscribes to no events; a repeat
  lands on its probe's worker, served from the prefix cache;
- the subscriber's ``snapshot_threshold`` uploads a snapshot a new router
  restores (and the JAX tree reads), and ``reset_states`` drops it;
- the circuit breaker's ``on_transition`` sequence equals JAX's, and the
  push router's ``circuit_open{worker}`` gauge follows it;
- a request whose instance leaves discovery before calling home is sent to
  another instance, by the push router and by the KV router.
"""

import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamo_tpu.llm.kv_router as j_router
import dynamo_tpu.llm.kv_router.prefill_counter as j_pc
import dynamo_tpu.runtime.push_router as j_push
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.llm.tokens import compute_block_hashes as j_hashes
from dynamo_tpu_torch import worker as pworker
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.kv_cache import KvEvent
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm import kv_router as p_router
from dynamo_tpu_torch.llm.kv_router import prefill_counter as p_pc
from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher
from dynamo_tpu_torch.llm.kv_router.subscriber import RADIX_STATE_BUCKET
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.tokens import compute_block_hashes
from dynamo_tpu_torch.runtime import push_router as p_push
from dynamo_tpu_torch.runtime.component import Instance
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.metrics import FRONTEND_PREFIX, MetricsRegistry

BS = 16


def ev_stored(tokens, parent=None):
    return {"kind": "stored", "block_hashes": compute_block_hashes(tokens, BS), "parent_hash": parent}


def test_config_has_every_jax_field_with_its_default():
    mine = {f.name: f.default for f in dataclasses.fields(p_router.KvRouterConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(j_router.KvRouterConfig)}
    assert {k: mine[k] for k in ref} == ref
    assert set(mine) - set(ref) == {"busy_threshold"} and mine["busy_threshold"] is None


def _random_events(seed, workers=8, n=200):
    rng = np.random.default_rng(seed)
    roots = [rng.integers(1, 500, size=BS * 8).tolist() for _ in range(4)]
    out = []
    for _ in range(n):
        w = int(rng.integers(1, workers + 1))
        root = roots[int(rng.integers(len(roots)))]
        toks = root[: BS * int(rng.integers(0, 8))] + rng.integers(1, 500, size=BS * int(rng.integers(1, 3))).tolist()
        h = j_hashes(toks, BS)
        if rng.random() < 0.8:
            out.append((w, {"kind": "stored", "block_hashes": h, "parent_hash": None}))
        elif rng.random() < 0.9:
            out.append((w, {"kind": "removed", "block_hashes": h[int(rng.integers(0, len(h))):]}))
        else:
            out.append((w, {"kind": "cleared"}))
    return out, [j_hashes(r, BS) for r in roots]


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_sharded_scores_match_plain_and_jax(shards):
    events, queries = _random_events(shards)
    plain, mine = p_router.KvIndexer(block_size=BS), p_router.KvIndexerSharded(block_size=BS, num_shards=shards)
    ref = j_router.KvIndexerSharded(block_size=BS, num_shards=shards)
    try:
        for i, (w, ev) in enumerate(events):
            for idx in (plain, mine, ref):
                idx.apply_event(w, ev)
            if i % 40 == 39:
                mine.flush()
                ref.flush()
                for q in queries:
                    assert mine.find_matches(q).scores == plain.find_matches(q).scores == ref.find_matches(q).scores
                assert mine.size() == ref.size()  # a block two shards hold counts in each
        assert sorted(mine._counts) == sorted(ref._counts) and mine._assignment == ref._assignment
    finally:
        mine.close()
        ref.close()


def test_sharded_pinning_removal_and_snapshot_roundtrip():
    idx, idx2 = p_router.KvIndexerSharded(block_size=BS, num_shards=2), p_router.KvIndexerSharded(BS, num_shards=3)
    try:
        toks = list(range(64))
        h = compute_block_hashes(toks, BS)
        for w in (1, 2, 3, 4):
            idx.apply_event(w, ev_stored(toks[:48]))
        idx.flush()
        assert sorted(idx._counts) == [2, 2] and set(idx.find_matches(h).scores) == {1, 2, 3, 4}
        idx.remove_worker(2)
        idx.apply_event(1, ev_stored(toks))
        idx.apply_event(1, {"kind": "removed", "block_hashes": h[3:]})
        idx.flush()
        assert sorted(idx._counts) == [1, 2] and idx.find_matches(h).scores == {1: 3, 3: 3, 4: 3}
        idx2.load_snapshot(idx.dump())  # into a differently-sharded indexer
        assert idx2.find_matches(h).scores == {1: 3, 3: 3, 4: 3}
        assert j_router.KvIndexer(BS).tree.load(idx.dump()).find_matches(h).scores == {1: 3, 3: 3, 4: 3}
    finally:
        idx.close()
        idx2.close()


async def _gossip(pc_mod, drt_cls):
    drt = await drt_cls.detached()
    try:
        a, b = pc_mod.PrefillCountersMultiWorker(drt, "ns", "comp"), pc_mod.PrefillCountersMultiWorker(drt, "ns", "comp")
        await a.start()
        await b.start()
        await a.new_prefill("req-1", 7, 320)
        await b.new_prefill("req-2", 9, 64)
        await asyncio.sleep(0.05)
        seen = [(a.pending_tokens(7), b.pending_tokens(7), a.pending_tokens(9), b.pending_tokens(9))]
        await a.complete_prefill("req-1", 7)
        await drt.bus.publish(pc_mod.prefill_events_subject("ns", "comp"), json.dumps(
            {"router_id": "other", "kind": "complete", "request_id": "zz", "worker_id": 3}).encode())
        await asyncio.sleep(0.05)
        seen.append((a.pending_tokens(7), b.pending_tokens(7), a.pending_tokens(3), b.pending_tokens(3)))
        a.remove_worker(9)
        seen.append((a.pending_tokens(9), b.pending_tokens(9)))
        await a.stop()
        await b.stop()
        return seen
    finally:
        await drt.shutdown()


def test_prefill_counters_gossip_as_jax_does():
    mine = asyncio.run(_gossip(p_pc, DistributedRuntime))
    from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxDrt

    assert mine == asyncio.run(_gossip(j_pc, JaxDrt))
    assert mine[0] == (0, 320, 64, 0)  # each sees the other's, not its own


def test_prefill_counters_steer_the_cost_like_jax():
    from dynamo_tpu.llm.kv_router.indexer import OverlapScores as JOverlap
    from dynamo_tpu.llm.kv_router.sequence import ActiveSequencesMultiWorker as JSeqs

    got = []
    for mod, seqs_cls, overlap in ((p_router, p_router.ActiveSequencesMultiWorker, p_router.OverlapScores),
                                   (j_router, JSeqs, JOverlap)):
        seqs = seqs_cls(block_size=BS)
        for w in (1, 2):
            seqs.ensure_worker(w)
        sched = mod.KvScheduler(seqs)
        got.append([sched.select_worker([1, 2], 4, overlap(scores=s), external_prefill_tokens=e).worker
                    for s, e in (({}, {1: 160}), ({1: 3}, {1: 16}), ({1: 3}, {1: 640}), ({}, {2: 1}))])
    assert got[0] == got[1] and got[0][0] == 2


def test_approx_index_follows_decisions_like_jax():
    mine, ref = p_router.ApproxKvIndexer(block_size=BS, ttl_s=30.0), j_router.ApproxKvIndexer(block_size=BS, ttl_s=30.0)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 300, size=int(n)).tolist() for n in rng.integers(10, 90, size=12)]
    for i, p in enumerate(prompts):
        for idx in (mine, ref):
            idx.process_routing_decision(i % 3, p)
    for p in prompts:
        h = compute_block_hashes(p, BS)
        assert mine.find_matches(h).scores == ref.find_matches(h).scores
    import time

    later = time.monotonic() + 31.0
    assert mine.expire(later) == ref.expire(later) == len([p for p in prompts if len(p) >= BS])
    assert mine.find_matches(compute_block_hashes(prompts[0], BS)).scores == {}


# ---------------------------------------------------------------------------
# Routers over live port workers (tiny, f32, CPU), one in-process runtime
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jax_config("tiny"), jax.random.PRNGKey(0), dtype=jnp.float32)
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), get_config("tiny"), device="cpu",
                             dtype=torch.float32)


def engine_of(params) -> TorchEngine:
    return TorchEngine.build(
        EngineArgs(model="tiny", dtype="float32", device="cpu", eos_token_ids=[0],
                   scheduler=SchedulerConfig(num_blocks=64, prefill_buckets=[32, 64, 128], decode_buckets=[1, 2, 4],
                                             num_scheduler_steps=1)),
        params=params)


def request(tokens, max_tokens=4):
    return {"token_ids": list(tokens), "sampling_options": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}


async def _answer(router, req):
    """(worker, token ids, cached_tokens) of one routed request."""
    toks, cached, ctx = [], None, Context()
    async for item in router.generate(req, ctx):
        data = item.data if hasattr(item, "data") else item
        if isinstance(data, dict):
            toks += data.get("token_ids") or []
            cached = data.get("cached_tokens", cached)
    return toks, cached


class Fleet:
    """Two port workers on one in-process runtime (the push router then
    calls them through ``local_engines``) and a client of their endpoint."""

    def __init__(self, params, n=2):
        self.params, self.n = params, n

    async def __aenter__(self):
        self.drt = await DistributedRuntime.detached()
        self.engines = [engine_of(self.params) for _ in range(self.n)]
        self.workers = [await pworker.serve_engine(self.drt, e, ModelDeploymentCard(name="tiny")) for e in self.engines]
        ep = self.drt.namespace("dynamo").component("backend").endpoint("generate")
        self.client = await ep.client()
        await self.client.wait_for_instances(self.n, timeout=10)
        return self

    def served(self) -> list:
        return [e.scheduler.request_total for e in self.engines]

    async def __aexit__(self, *exc):
        await self.client.close()
        for w, e in zip(self.workers, self.engines):
            await w.stop(drain_timeout_s=2)
            await e.stop()
        await self.drt.shutdown()


PROMPTS = [list(range(1, 70)), list(range(200, 260)), list(range(1, 70)) + [5, 6, 7], list(range(200, 250))]


async def _approx(params):
    async with Fleet(params) as fleet:
        router = await p_router.KvPushRouter.create(fleet.client, p_router.KvRouterConfig(use_kv_events=False))
        assert router.subscriber is None and router.pending_index is None
        assert isinstance(router.indexer, p_router.ApproxKvIndexer)
        out = []
        for p in PROMPTS:
            before = fleet.served()
            toks, cached = await _answer(router, request(p))
            after = fleet.served()
            out.append(([a - b for a, b in zip(after, before)].index(1), toks, cached))
        ref = p_router.ApproxKvIndexer(block_size=BS, ttl_s=120.0)
        for (w, _, _), p in zip(out, PROMPTS):
            ref.process_routing_decision(fleet.workers[w].instance_id, p)
        scores = [router.indexer.find_matches(compute_block_hashes(p, BS)).scores for p in PROMPTS]
        await router.close()
        return out, scores, [ref.find_matches(compute_block_hashes(p, BS)).scores for p in PROMPTS]


def test_approx_mode_routes_repeats_to_their_probe_worker(params):
    out, scores, ref = asyncio.run(_approx(params))
    assert out[2][0] == out[0][0] and out[3][0] == out[1][0]  # each repeat lands on its probe's worker
    assert out[2][2] > 0 and out[3][2] > 0  # ... and is served from its prefix cache
    assert scores == ref


async def _counting(params):
    async with Fleet(params) as fleet:
        cfg = p_router.KvRouterConfig(track_prefill_counters=True)
        a = await p_router.KvPushRouter.create(fleet.client, cfg)
        b = await p_router.KvPushRouter.create(fleet.client, cfg)
        seen = {"a": 0, "b": 0}
        gate = asyncio.Event()
        for name, mine, other in (("a", a, b), ("b", b, a)):
            orig = mine.push.generate

            async def held(req, ctx, instance_id=None, orig=orig, other=other, name=name):
                # This router's request is routed and gossiped but not yet
                # prefilled: the other router must see its tokens pending.
                for _ in range(200):
                    seen[name] = max(seen[name], sum(other.prefill_counters.pending_tokens(w)
                                                     for w in fleet.client.instance_ids()))
                    if seen[name]:
                        break
                    await asyncio.sleep(0.005)
                await gate.wait()
                async for item in orig(req, ctx, instance_id=instance_id):
                    yield item

            mine.push.generate = held
        tasks = [asyncio.ensure_future(_answer(r, request(p))) for r, p in ((a, PROMPTS[0]), (b, PROMPTS[1]))]
        await asyncio.sleep(0.3)
        gate.set()
        await asyncio.gather(*tasks)
        await asyncio.sleep(0.05)
        after = [sum(r.prefill_counters.pending_tokens(w) for w in fleet.client.instance_ids()) for r in (a, b)]
        await a.close()
        await b.close()
        return seen, after


def test_two_counting_routers_see_each_others_pending_prefills(params):
    seen, after = asyncio.run(_counting(params))
    assert seen == {"a": len(PROMPTS[0]), "b": len(PROMPTS[1])}
    assert after == [0, 0]  # completed at the first token


async def _snapshots(params):
    async with Fleet(params, n=1) as fleet:
        router = await p_router.KvPushRouter.create(fleet.client, p_router.KvRouterConfig(snapshot_threshold=2))
        for p in PROMPTS[:2]:
            await _answer(router, request(p, max_tokens=2))
        await asyncio.sleep(0.3)
        bucket = await fleet.drt.bus.object_store(RADIX_STATE_BUCKET)
        stream_name = router.subscriber.stream_name
        snap = await bucket.get(stream_name)
        router2 = await p_router.KvPushRouter.create(fleet.client, p_router.KvRouterConfig())
        restored = router2.indexer.size()
        h = compute_block_hashes(PROMPTS[0], BS)
        scores = router2.indexer.find_matches(h).scores
        jax_scores = j_router.RadixTree.load(snap).find_matches(h).scores if snap else None
        router3 = await p_router.KvPushRouter.create(fleet.client, p_router.KvRouterConfig(reset_states=True))
        reset = (await bucket.get(stream_name), router3.indexer.size())
        for r in (router, router2, router3):
            await r.close()
        return snap, restored, scores, jax_scores, reset, fleet.client.instance_ids()


def test_snapshot_threshold_and_reset_states(params):
    snap, restored, scores, jax_scores, reset, ids = asyncio.run(_snapshots(params))
    assert snap is not None and restored > 0
    assert scores == jax_scores == {ids[0]: len(PROMPTS[0]) // BS}
    assert reset == (None, 0)  # reset_states: the snapshot dropped, the stream purged


def _transitions(push_mod):
    now = [0.0]
    seen = []
    br = push_mod.CircuitBreaker(threshold=2, cooldown_s=5.0, clock=lambda: now[0],
                                 on_transition=lambda w, s: seen.append((w, s)))
    steps = [("f", 1), ("f", 1), ("b", None), ("t", 6.0), ("b", None), ("d", 1), ("b", None), ("f", 1), ("t", 12.0),
             ("b", None), ("d", 1), ("s", 1), ("f", 2), ("s", 2), ("f", 2), ("f", 2), ("x", 2), ("f", 2)]
    blocked = []
    for op, arg in steps:
        if op == "f":
            br.record_failure(arg)
        elif op == "s":
            br.record_success(arg)
        elif op == "d":
            br.note_dispatch(arg)
        elif op == "t":
            now[0] = arg
        elif op == "x":
            br.forget(arg)
        else:
            blocked.append(sorted(br.blocked_instances()))
    return seen, blocked, br.snapshot()


def test_breaker_transitions_match_jax():
    mine, ref = _transitions(p_push), _transitions(j_push)
    assert mine == ref
    assert [s for _, s in mine[0]] == ["open", "half_open", "open", "half_open", "closed", "open"]


async def _router_counts(params):
    """The router's circuit_open{worker} gauge after each transition."""
    async with Fleet(params, n=1) as fleet:
        metrics = MetricsRegistry(prefix=FRONTEND_PREFIX)
        router = p_push.PushRouter(fleet.client, metrics=metrics)
        wid = fleet.client.instance_ids()[0]
        gauge = lambda: metrics.gauge("circuit_open", worker=f"{wid:x}").value  # noqa: E731
        seen = []
        for _ in range(3):
            router.breaker.record_failure(wid)
        seen.append(gauge())
        router.breaker.record_success(wid)
        seen.append(gauge())
        return seen, metrics.render().decode()


def test_push_router_counts_circuit_transitions(params):
    seen, text = asyncio.run(_router_counts(params))
    assert seen == [1.0, 0.0]
    assert "# TYPE dynamo_frontend_circuit_open gauge" in text


async def _ghost(params, kv: bool, when: str):
    """A second instance registered with nobody behind its subject (a worker
    that died before its lease went): the router sends it the request, and
    its lease is revoked ``when``: while the router waits for the call home
    ("waiting"), while the request is being published ("publishing"), or
    between the KV router's choice and the push ("choosing"). The request
    must complete on the live worker."""
    async with Fleet(params, n=1) as fleet:
        lease = await fleet.drt.store.grant_lease(30.0)
        ghost = Instance("dynamo", "backend", "generate", lease.id)
        await fleet.drt.store.put(ghost.etcd_key, ghost.to_json(), lease_id=lease.id)
        await fleet.client.wait_for_instances(2, timeout=10)
        prompt = PROMPTS[0]

        async def revoke():
            await fleet.drt.store.revoke_lease(lease.id)
            while ghost.instance_id in fleet.client.instances:
                await asyncio.sleep(0.001)

        if kv:
            router = await p_router.KvPushRouter.create(
                fleet.client, p_router.KvRouterConfig(track_prefill_counters=when == "choosing"))
            pub = KvEventPublisher(fleet.drt, "dynamo", "backend", ghost.instance_id)
            pub.start()
            pub.publish(KvEvent(kind="stored", block_hashes=compute_block_hashes(prompt, BS)))
            for _ in range(200):  # the ghost holds the prompt: the KV router picks it
                if router.indexer.find_matches(compute_block_hashes(prompt, BS)).scores:
                    break
                await asyncio.sleep(0.01)
        else:
            router = p_push.PushRouter(fleet.client, p_push.RouterMode.ROUND_ROBIN)
            router._rr = fleet.client.instance_ids().index(ghost.instance_id)
        if when == "publishing":
            publish = fleet.drt.bus.publish

            async def publishing(subject, data, *a, **kw):
                if subject == ghost.subject:
                    await revoke()
                return await publish(subject, data, *a, **kw)

            fleet.drt.bus.publish = publishing
        elif when == "choosing":
            new_prefill = router.prefill_counters.new_prefill

            async def choosing(rid, worker, tokens):
                if worker == ghost.instance_id:
                    await revoke()
                return await new_prefill(rid, worker, tokens)

            router.prefill_counters.new_prefill = choosing
        task = asyncio.ensure_future(_answer(router, request(prompt)))
        if when == "waiting":
            await asyncio.sleep(0.3)
            assert not task.done()  # waiting for the ghost to call home
            await revoke()
        toks, _ = await asyncio.wait_for(task, 30)
        want, _ = await _answer(fleet.engines[0], request(prompt))
        if kv:
            await pub.stop()
        await router.close()
        return toks, want, fleet.served()


@pytest.mark.parametrize("kv,when", [(False, "waiting"), (True, "waiting"), (False, "publishing"),
                                     (True, "publishing"), (True, "choosing")],
                         ids=["push", "kv", "push-publishing", "kv-publishing", "kv-choosing"])
def test_request_to_an_instance_gone_before_calling_home_is_resent(params, kv, when):
    toks, want, served = asyncio.run(_ghost(params, kv, when))
    assert toks == want and len(toks) == 4 and served == [2]


class _RacingInstances(dict):
    """A client's instance map whose chosen instance leaves right after the
    push router's presence check, before its wait begins: the departure's
    callback runs ahead of the wait's first step, as the client's watch
    loop can."""

    def __init__(self, client, wid):
        super().__init__({wid: None})
        self.client, self.wid, self.armed = client, wid, True

    def __contains__(self, key):
        here = dict.__contains__(self, key)
        if key == self.wid and self.armed:
            self.armed = False
            asyncio.get_running_loop().call_soon(self.leave)
        return here

    def leave(self):
        self.pop(self.wid, None)
        self.client._changed.set()  # what Client._watch_loop does on a change
        self.client._changed = asyncio.Event()


async def _race():
    import types

    client = types.SimpleNamespace(drt=None, _changed=asyncio.Event())
    client.change_event = lambda: client._changed
    client.instances = _RacingInstances(client, 7)
    router = p_push.PushRouter(client)
    never = asyncio.Event()

    async def frames():
        await never.wait()
        yield None

    with pytest.raises(p_push.InstanceGone):
        await asyncio.wait_for(router._called_home(frames(), 7).__anext__(), 5)


def test_a_departure_between_the_check_and_the_wait_ends_the_wait():
    asyncio.run(_race())

