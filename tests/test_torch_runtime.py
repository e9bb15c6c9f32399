"""The port's runtime (``dynamo_tpu_torch/runtime``) against the JAX
package's: the scenarios of ``test_kvstore.py``, ``test_pubsub.py``,
``test_tcp_control.py`` and ``test_component.py``, each run on both
packages (the same watch-event sequences, lease expiry, message order,
routing, cancellation and disconnects), then interop: the port's client
against the JAX ``ControlPlaneServer`` and the JAX client against the
port's, down to a request routed from one package's runtime to the other's
worker."""

import asyncio
import types

import pytest

import dynamo_tpu.runtime.distributed as j_distributed
import dynamo_tpu.runtime.engine as j_engine
import dynamo_tpu.runtime.push_router as j_push_router
import dynamo_tpu.runtime.runtime as j_runtime
import dynamo_tpu.runtime.transports.kvstore as j_kvstore
import dynamo_tpu.runtime.transports.pubsub as j_pubsub
import dynamo_tpu.runtime.transports.tcp_control as j_tcp_control
import dynamo_tpu_torch.runtime.distributed as p_distributed
import dynamo_tpu_torch.runtime.engine as p_engine
import dynamo_tpu_torch.runtime.push_router as p_push_router
import dynamo_tpu_torch.runtime.runtime as p_runtime
import dynamo_tpu_torch.runtime.transports.kvstore as p_kvstore
import dynamo_tpu_torch.runtime.transports.pubsub as p_pubsub
import dynamo_tpu_torch.runtime.transports.tcp_control as p_tcp_control

PKGS = {
    "port": types.SimpleNamespace(kvstore=p_kvstore, pubsub=p_pubsub, tcp_control=p_tcp_control,
                                  distributed=p_distributed, runtime=p_runtime, push_router=p_push_router,
                                  engine=p_engine),
    "jax": types.SimpleNamespace(kvstore=j_kvstore, pubsub=j_pubsub, tcp_control=j_tcp_control,
                                 distributed=j_distributed, runtime=j_runtime, push_router=j_push_router,
                                 engine=j_engine),
}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    return PKGS[request.param]


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, 30))


# ---------------------------------------------------------------------------
# KV store (test_kvstore.py)
# ---------------------------------------------------------------------------


def test_put_get_delete(pkg):
    async def go():
        store = pkg.kvstore.MemKvStore()
        await store.put("a/b", b"1")
        entry = await store.get("a/b")
        assert entry is not None and entry.value == b"1"
        assert await store.delete("a/b")
        assert await store.get("a/b") is None
        assert not await store.delete("a/b")
        await store.close()

    run(go())


def test_get_prefix_sorted_and_create_only(pkg):
    async def go():
        store = pkg.kvstore.MemKvStore()
        await store.put("x/2", b"b")
        await store.put("x/1", b"a")
        await store.put("y/1", b"c")
        assert [e.key for e in await store.get_prefix("x/")] == ["x/1", "x/2"]
        await store.put("k", b"1", create_only=True)
        with pytest.raises(pkg.kvstore.KeyExists):
            await store.put("k", b"2", create_only=True)
        await store.close()

    run(go())


async def _watch_events(pkg, store):
    await store.put("w/1", b"a")
    watch = await store.watch_prefix("w/")
    events = []

    async def consume():
        async for ev in watch:
            events.append((ev.type.value, ev.key, ev.value))
            if len(events) == 4:
                return

    task = asyncio.create_task(consume())
    await asyncio.sleep(0.01)
    await store.put("w/2", b"b")
    await store.delete("w/1")
    await store.put("w/2", b"c")
    await asyncio.wait_for(task, 2)
    await watch.cancel()
    return events


WATCH_WANT = [("put", "w/1", b"a"), ("put", "w/2", b"b"), ("delete", "w/1", None), ("put", "w/2", b"c")]


def test_watch_snapshot_then_deltas(pkg):
    async def go():
        store = pkg.kvstore.MemKvStore()
        events = await _watch_events(pkg, store)
        await store.close()
        return events

    assert run(go()) == WATCH_WANT


def test_lease_expiry_deletes_keys_and_notifies(pkg):
    async def go():
        store = pkg.kvstore.MemKvStore(reaper_interval_s=0.05)
        lease = await store.grant_lease(ttl_s=0.15)
        await store.put("inst/a", b"x", lease_id=lease.id)
        watch = await store.watch_prefix("inst/")
        it = watch._gen()
        first = await asyncio.wait_for(it.__anext__(), 2)
        ev = await asyncio.wait_for(it.__anext__(), 2)  # no keepalive: the reaper deletes it
        gone = await store.get("inst/a")
        await watch.cancel()
        await store.close()
        return first.type.value, ev.type.value, ev.key, gone

    assert run(go()) == ("put", "delete", "inst/a", None)


def test_lease_keepalive_preserves_keys(pkg):
    async def go():
        store = pkg.kvstore.MemKvStore(reaper_interval_s=0.05)
        lease = await store.grant_lease(ttl_s=0.2)
        await store.put("inst/b", b"x", lease_id=lease.id)
        for _ in range(5):
            await asyncio.sleep(0.1)
            await store.keep_alive(lease.id)
        assert await store.get("inst/b") is not None
        await lease.revoke()
        assert await store.get("inst/b") is None
        with pytest.raises(pkg.kvstore.LeaseExpired):
            await store.keep_alive(lease.id)
        await store.close()

    run(go())


def test_shared_key_rebinds_to_newest_lease(pkg):
    async def go():
        store = pkg.kvstore.MemKvStore()
        a = await store.grant_lease(10.0)
        b = await store.grant_lease(10.0)
        await store.put("models/ns/c/e/m", b"worker-a", lease_id=a.id)
        await store.put("models/ns/c/e/m", b"worker-b", lease_id=b.id)
        await store.revoke_lease(a.id)
        entry = await store.get("models/ns/c/e/m")
        assert entry is not None and entry.value == b"worker-b"
        await store.revoke_lease(b.id)
        assert await store.get("models/ns/c/e/m") is None
        await store.close()

    run(go())


# ---------------------------------------------------------------------------
# Pub/sub (test_pubsub.py)
# ---------------------------------------------------------------------------

SUBJECT_CASES = [("a.b.c", "a.b.c"), ("a.*.c", "a.b.c"), ("a.>", "a.b.c.d"), ("a.b", "a.b.c"), ("a.b.c", "a.b"),
                 ("a.*.x", "a.b.c"), ("a.>", "a"), ("rq.*.*.*.*", "rq.dynamo.backend.generate.1f")]


def test_subject_matching(pkg):
    assert [pkg.pubsub.subject_matches(p, s) for p, s in SUBJECT_CASES] == [
        j_pubsub.subject_matches(p, s) for p, s in SUBJECT_CASES] == [True, True, True, False, False, False, False,
                                                                      True]


def test_publish_subscribe_in_order(pkg):
    async def go():
        bus = pkg.pubsub.MemPubSub()
        sub = await bus.subscribe("rq.ns.comp.ep.*")
        for i in range(5):
            await bus.publish(f"rq.ns.comp.ep.{i}", str(i).encode())
        got = [await asyncio.wait_for(sub.next(), 2) for _ in range(5)]
        await sub.unsubscribe()
        await bus.close()
        return [(m.subject, m.data) for m in got]

    assert run(go()) == [(f"rq.ns.comp.ep.{i}", str(i).encode()) for i in range(5)]


def test_queue_group_load_balance(pkg):
    async def go():
        bus = pkg.pubsub.MemPubSub()
        s1 = await bus.subscribe("work.q", queue_group="g")
        s2 = await bus.subscribe("work.q", queue_group="g")
        for i in range(4):
            await bus.publish("work.q", str(i).encode())
        got1 = [(await asyncio.wait_for(s1.next(), 2)).data for _ in range(2)]
        got2 = [(await asyncio.wait_for(s2.next(), 2)).data for _ in range(2)]
        await bus.close()
        return got1, got2

    assert run(go()) == ([b"0", b"2"], [b"1", b"3"])


def test_request_reply(pkg):
    async def go():
        bus = pkg.pubsub.MemPubSub()
        sub = await bus.subscribe("svc.echo")

        async def responder():
            msg = await sub.next()
            await bus.publish(msg.reply_to, b"pong:" + msg.data)

        task = asyncio.create_task(responder())
        reply = await asyncio.wait_for(bus.request("svc.echo", b"ping"), 2)
        await task
        await bus.close()
        return reply.data

    assert run(go()) == b"pong:ping"


def test_stream_replay_tail_and_purge(pkg):
    async def go():
        bus = pkg.pubsub.MemPubSub()
        stream = await bus.stream("kv_events")
        for i in range(3):
            await stream.publish("kv_events", str(i).encode())
        got = []

        async def consume():
            async for msg in stream.consume(from_seq=1):
                got.append((msg.seq, msg.data))
                if len(got) == 5:
                    return

        task = asyncio.create_task(consume())
        await asyncio.sleep(0.01)
        await stream.publish("kv_events", b"3")
        await stream.publish("kv_events", b"4")
        await asyncio.wait_for(task, 2)
        await stream.purge(up_to_seq=3)
        after = [(m.seq, m.data) for m in await stream.fetch(from_seq=1)]
        return got, after, stream.first_seq, stream.last_seq

    got, after, first, last = run(go())
    assert got == [(i + 1, str(i).encode()) for i in range(5)]
    assert (after, first, last) == ([(4, b"3"), (5, b"4")], 4, 5)


def test_object_store(pkg):
    async def go():
        bus = pkg.pubsub.MemPubSub()
        store = await bus.object_store("radix-bucket")
        await store.put("snapshot", b"\x00\x01")
        assert await store.get("snapshot") == b"\x00\x01"
        assert await store.list() == ["snapshot"]
        assert await store.delete("snapshot")
        assert await store.get("snapshot") is None

    run(go())


# ---------------------------------------------------------------------------
# TCP control plane (test_tcp_control.py), and interop
# ---------------------------------------------------------------------------

# (server package, client package): each alone, then across packages.
PAIRS = [("port", "port"), ("jax", "jax"), ("jax", "port"), ("port", "jax")]


async def _server(name):
    server = PKGS[name].tcp_control.ControlPlaneServer(host="127.0.0.1", port=0)
    await server.start()
    return server


async def _drt(name, server):
    tcp = PKGS[name].tcp_control
    conn = await tcp.connect_control_plane(f"127.0.0.1:{server.port}")
    drt = PKGS[name].distributed.DistributedRuntime(runtime=PKGS[name].runtime.Runtime(), store=tcp.TcpKvStore(conn),
                                                    bus=tcp.TcpPubSub(conn))
    await drt.start()
    return drt


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS)
def test_kv_pubsub_stream_and_objects_over_tcp(server_pkg, client_pkg):
    async def go():
        server = await _server(server_pkg)
        tcp = PKGS[client_pkg].tcp_control
        conn = await tcp.connect_control_plane(f"127.0.0.1:{server.port}")
        store, bus = tcp.TcpKvStore(conn), tcp.TcpPubSub(conn)
        await store.put("a/1", b"x")
        assert (await store.get("a/1")).value == b"x"
        assert [e.key for e in await store.get_prefix("a/")] == ["a/1"]
        events = await _watch_events(PKGS[client_pkg], store)
        with pytest.raises(PKGS[client_pkg].kvstore.KeyExists):
            await store.put("a/1", b"y", create_only=True)
        sub = await bus.subscribe("x.*")
        for i in range(3):
            await bus.publish(f"x.{i}", b"m%d" % i, headers={"h": str(i)})
        msgs = [await asyncio.wait_for(sub.next(), 2) for _ in range(3)]
        stream = await bus.stream("events")
        seqs = [await stream.publish("events", b"e%d" % i) for i in range(3)]
        await stream.purge(up_to_seq=1)
        batch = await stream.fetch(1)
        obj = await bus.object_store("bucket")
        await obj.put("s", b"blob")
        blob = await obj.get("s")
        await bus.close()
        await server.close()
        return events, [(m.subject, m.data, m.headers) for m in msgs], seqs, [(m.seq, m.data) for m in batch], blob

    events, msgs, seqs, batch, blob = run(go())
    assert events == WATCH_WANT
    assert msgs == [(f"x.{i}", b"m%d" % i, {"h": str(i)}) for i in range(3)]
    assert (seqs, batch, blob) == ([1, 2, 3], [(2, b"e1"), (3, b"e2")], b"blob")


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS)
def test_lease_revoked_when_client_connection_drops(server_pkg, client_pkg):
    """A client's death (its connection closing) revokes its leases: a
    watcher on another connection sees the key go."""
    async def go():
        server = await _server(server_pkg)
        tcp = PKGS[client_pkg].tcp_control
        c1 = await tcp.connect_control_plane(f"127.0.0.1:{server.port}")
        c2 = await tcp.connect_control_plane(f"127.0.0.1:{server.port}")
        s1, s2 = tcp.TcpKvStore(c1), tcp.TcpKvStore(c2)
        lease = await s1.grant_lease(30.0)
        await s1.put("instances/x:1", b"{}", lease_id=lease.id)
        snapshot, watch = await s2.get_and_watch_prefix("instances/")
        await c1.close()
        ev = await asyncio.wait_for(watch._gen().__anext__(), 5)
        await watch.cancel()
        await c2.close()
        await server.close()
        return [e.key for e in snapshot], ev.type.value, ev.key

    assert run(go()) == (["instances/x:1"], "delete", "instances/x:1")


async def _echo_handler(request, context):
    for i in range(int(request.get("n", 3))):
        yield {"i": i, "msg": request.get("msg", ""), "traceparent": context.traceparent.to_header()}


@pytest.mark.parametrize("server_pkg,worker_pkg,client_pkg",
                         [("port", "port", "port"), ("jax", "jax", "jax"), ("jax", "port", "port"),
                          ("port", "jax", "port"), ("port", "port", "jax"), ("jax", "port", "jax")])
def test_cross_runtime_routing_over_broker(server_pkg, worker_pkg, client_pkg):
    """A worker's runtime and a client's runtime joined only by a control
    plane: the request crosses pub/sub, the frames come back over TCP, the
    context's traceparent arrives unchanged, and the stats scrape answers."""
    async def go():
        server = await _server(server_pkg)
        wdrt, cdrt = await _drt(worker_pkg, server), await _drt(client_pkg, server)
        try:
            ep_w = wdrt.namespace("t").component("c").endpoint("gen")
            await ep_w.serve_endpoint(_echo_handler, stats_handler=lambda: {"kv_usage": 0.5})
            client = await cdrt.namespace("t").component("c").endpoint("gen").client()
            await client.wait_for_instances(1, timeout=5)
            router = PKGS[client_pkg].push_router.PushRouter(client)
            ctx = PKGS[client_pkg].engine.Context()
            out = [a.data async for a in router.generate({"n": 3, "msg": "hi"}, ctx)]
            stats = await client.scrape_stats()
            await client.close()
            return out, ctx.traceparent.to_header(), stats
        finally:
            await wdrt.shutdown()
            await cdrt.shutdown()
            await server.close()

    out, tp, stats = run(go())
    assert [(o["i"], o["msg"]) for o in out] == [(0, "hi"), (1, "hi"), (2, "hi")]
    assert {o["traceparent"] for o in out} == {tp}
    (s,) = stats.values()
    assert s == {"in_flight": 0, "draining": 0.0, "worker_drains_total": 0, "kv_usage": 0.5}


# ---------------------------------------------------------------------------
# Components and the push router (test_component.py)
# ---------------------------------------------------------------------------


async def _wire_drt(pkg):
    """A runtime whose served endpoints are reached over the wire only."""
    return await pkg.distributed.DistributedRuntime.detached()


async def _serve_wire(drt, ep, handler, **kw):
    handle = await ep.serve_endpoint(handler, **kw)
    drt.local_engines.pop(handle.instance.instance_id)
    return handle


def test_local_fast_path_and_wire_path(pkg):
    async def go():
        drt = await _wire_drt(pkg)
        try:
            ep = drt.namespace("test").component("comp").endpoint("gen")
            await ep.serve_endpoint(_echo_handler)
            client = await ep.client()
            await client.wait_for_instances(1, timeout=5)
            local = [a.data["i"] async for a in pkg.push_router.PushRouter(client).generate({"n": 3})]
            ep2 = drt.namespace("test").component("comp").endpoint("gen2")
            await _serve_wire(drt, ep2, _echo_handler)
            client2 = await ep2.client()
            await client2.wait_for_instances(1, timeout=5)
            wire = [a.data["i"] async for a in pkg.push_router.PushRouter(client2).generate({"n": 4})]
            return local, wire
        finally:
            await drt.shutdown()

    assert run(go()) == ([0, 1, 2], [0, 1, 2, 3])


def test_round_robin_alternates(pkg):
    async def go():
        drt = await _wire_drt(pkg)
        try:
            ep = drt.namespace("test").component("comp").endpoint("gen")

            def make_handler(tag):
                async def handler(request, context):
                    yield {"worker": tag}

                return handler

            handles = [await _serve_wire(drt, ep, make_handler(t)) for t in "ab"]
            client = await ep.client()
            await client.wait_for_instances(2, timeout=5)
            router = pkg.push_router.PushRouter(client, pkg.push_router.RouterMode.ROUND_ROBIN)
            seen = [a.data["worker"] for _ in range(4) async for a in router.generate({})]
            tags = {h.instance.instance_id: t for h, t in zip(handles, "ab")}
            return seen, [tags[i] for i in client.instance_ids()]
        finally:
            await drt.shutdown()

    seen, by_id = run(go())
    assert seen == by_id * 2  # instance-id order, round and round


def test_instance_removed_on_lease_loss_and_no_instances(pkg):
    async def go():
        drt = await _wire_drt(pkg)
        try:
            ep = drt.namespace("test").component("comp").endpoint("gen")
            handle = await ep.serve_endpoint(_echo_handler, lease_ttl_s=0.5)
            client = await ep.client()
            await client.wait_for_instances(1, timeout=5)
            await drt.store.revoke_lease(handle.lease.id)
            for _ in range(50):
                if not client.instances:
                    break
                await asyncio.sleep(0.05)
            router = pkg.push_router.PushRouter(client, retry=pkg.push_router.RetryPolicy(max_retries=2, seed=0))
            with pytest.raises(pkg.push_router.NoInstancesError):
                async for _ in router.generate({}):
                    pass
            return dict(client.instances), router.retries_total
        finally:
            await drt.shutdown()

    assert run(go()) == ({}, 2)


def test_cancel_and_kill_over_the_wire(pkg):
    """stop_generating → graceful 'cancel': the handler sees its context
    stop and the stream ends; kill → 'kill': the handler is abandoned and
    the client sees the cancellation error."""
    async def go():
        drt = await _wire_drt(pkg)
        progressed = {"polite": [], "oblivious": []}
        try:
            async def polite(request, context):
                for i in range(1000):
                    if context.is_stopped():
                        return
                    progressed["polite"].append(i)
                    yield {"i": i}
                    await asyncio.sleep(0.01)

            async def oblivious(request, context):
                for i in range(1000):
                    progressed["oblivious"].append(i)
                    yield {"i": i}
                    await asyncio.sleep(0.01)

            results = {}
            for name, handler, op in (("polite", polite, "stop_generating"), ("oblivious", oblivious, "kill")):
                ep = drt.namespace("test").component("comp").endpoint(name)
                await _serve_wire(drt, ep, handler)
                client = await ep.client()
                await client.wait_for_instances(1, timeout=5)
                ctx = pkg.engine.Context()
                got = []
                try:
                    async for a in pkg.push_router.PushRouter(client).generate({}, ctx):
                        got.append(a.data)
                        if len(got) == 3:
                            getattr(ctx, op)()
                    results[name] = "ended"
                except RuntimeError:
                    results[name] = "error"
                await asyncio.sleep(0.1)
            return results, {k: len(v) for k, v in progressed.items()}
        finally:
            await drt.shutdown()

    results, progressed = run(go())
    assert results == {"polite": "ended", "oblivious": "error"}
    assert all(n < 100 for n in progressed.values()), progressed


def test_stream_disconnect_surfaces_and_trips_breaker(pkg):
    async def go():
        drt = await _wire_drt(pkg)
        try:
            ep = drt.namespace("test").component("comp").endpoint("gen")

            async def dying(request, context):
                yield {"i": 0}
                raise ConnectionResetError("worker crash")

            handle = await _serve_wire(drt, ep, dying)
            client = await ep.client()
            await client.wait_for_instances(1, timeout=5)
            breaker = pkg.push_router.CircuitBreaker(threshold=2, cooldown_s=60.0)
            router = pkg.push_router.PushRouter(client, breaker=breaker)
            got = []
            for _ in range(2):
                with pytest.raises(pkg.engine.StreamDisconnect):
                    async for a in router.generate({}):
                        got.append(a.data)
            return got, breaker.state_of(handle.instance.instance_id), breaker.snapshot()["trips_total"]
        finally:
            await drt.shutdown()

    assert run(go()) == ([{"i": 0}, {"i": 0}], "open", 1)


def test_draining_instance_rejects_with_disconnect(pkg):
    """A request that reaches a draining instance gets a disconnect error
    (the caller's Migration operator would replay it)."""
    async def go():
        drt = await _wire_drt(pkg)
        try:
            ep = drt.namespace("test").component("comp").endpoint("gen")
            handle = await _serve_wire(drt, ep, _echo_handler)
            client = await ep.client()
            await client.wait_for_instances(1, timeout=5)
            handle._ingress.begin_drain()
            with pytest.raises(pkg.engine.StreamDisconnect):
                async for _ in pkg.push_router.PushRouter(client).generate({}):
                    pass
            return handle.draining
        finally:
            await drt.shutdown()

    assert run(go()) is True


def test_circuit_breaker_lifecycle(pkg):
    now = [0.0]
    b = pkg.push_router.CircuitBreaker(threshold=2, cooldown_s=5.0, clock=lambda: now[0])
    b.record_failure(7)
    states = [b.state_of(7)]
    b.record_failure(7)
    states.append(b.state_of(7))
    blocked = [b.blocked_instances()]
    now[0] = 6.0
    blocked.append(b.blocked_instances())  # cooldown over: half-open, unblocked
    b.note_dispatch(7)
    blocked.append(b.blocked_instances())  # the probe holds the slot
    b.record_success(7)
    states.append(b.state_of(7))
    assert states == ["closed", "open", "closed"]
    assert blocked == [{7}, set(), {7}]
    assert b.snapshot() == {"trips_total": 1, "workers": {"7": {"state": "closed", "failures": 0}}}


def test_retry_policy_backoff_is_seeded(pkg):
    a = pkg.push_router.RetryPolicy(seed=3)
    b = j_push_router.RetryPolicy(seed=3)
    assert [a.backoff_s(i) for i in range(6)] == [b.backoff_s(i) for i in range(6)]


def test_context_wire_form(pkg):
    """A context crosses the wire as {id, traceparent}; either package reads
    the other's."""
    ctx = pkg.engine.Context(id="req-1")
    for other in (p_engine, j_engine):
        back = other.Context.from_wire(ctx.to_wire())
        assert back.id == "req-1" and back.traceparent.to_header() == ctx.traceparent.to_header()
    child = ctx.child()
    assert child.traceparent.trace_id == ctx.traceparent.trace_id
    assert child.traceparent.parent_id != ctx.traceparent.parent_id
    assert pkg.engine.Context.from_wire({"id": "x", "traceparent": "junk"}).traceparent.trace_id
