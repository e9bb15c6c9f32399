"""The port's distributed main path against the JAX package's, on ``tiny``
(f32, CPU), every role with a runtime of its own joined only through the
TCP control plane, so every request crosses the wire (pub/sub request
publish, TCP call-home response frames) and never takes ``local_engines``:

1. the port's stack (control plane, two ``TorchEngine`` workers, the
   frontend with the KV router) and the JAX stack (two ``TpuEngine``
   workers, the JAX frontend) give the same greedy text, streamed and
   unary; a repeated prompt reports the same ``cached_tokens > 0`` on both
   and lands on the worker that served it first; ``/v1/models`` drops the
   model when the last worker's lease goes, and a request is then a 503;
2. a port worker behind the JAX frontend gives the JAX stack's text, the
   JAX router indexes its KV events, and the JAX client scrapes its stats:
   the wire, the KV events and the stats keys are the same;
3. with ``migration_limit=1``, stopping the worker that holds a stream
   half-way still gives the client the whole answer, and the frontend's
   ``migrations_total`` counts the replay; with no migration budget the
   unary answer is a 502 with the tokens it had streamed;
4. ``--busy-threshold`` skips a worker whose gossiped KV usage reaches
   it, in every router mode;
5. ``TorchEngine.stats_handler``'s keys are a subset of the JAX
   ``stats_handler``'s on the same request trace, and every count-valued
   key is equal but the compile trackers' (XLA compiles against graph
   captures), every gauge too but host times and what derives from them,
   and the digests hold the same streams with the same sample counts;
6. the CLIs: ``python -m dynamo_tpu_torch.control_plane`` / ``.worker
   --device cpu`` / ``.frontend`` as processes answer one request and exit
   cleanly on SIGTERM; the worker defaults to ``--device cuda`` and raises
   without CUDA; JAX flags whose feature is not ported are refused, and
   the ported observability flags parse to the JAX CLIs' defaults;
7. a port worker built by the CLI's ``build_engine`` / ``build_card`` from
   ``--checkpoint`` and ``--tokenizer`` files (tiny's widths, 1,024 ids, a
   Llama-3-layout tokenizer) behind the port's frontend and behind the JAX
   frontend, each loading the card's ``tokenizer_path`` (and rendering its
   ``chat_template`` when the card carries one), gives the text of a JAX
   worker built from the same files behind the JAX frontend.
"""

import asyncio
import dataclasses
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.engine import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.llm import entrypoint as jentry
from dynamo_tpu.llm.kv_router import KvEventPublisher as JaxKvEventPublisher
from dynamo_tpu.llm.kv_router import WorkerMetricsPublisher as JaxWorkerMetricsPublisher
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxDrt
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.runtime import Runtime as JaxRuntime
from dynamo_tpu.runtime.transports import tcp_control as jtcp
from dynamo_tpu_torch import worker as pworker
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm import entrypoint as pentry
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.metrics import parse_text
from dynamo_tpu_torch.runtime.runtime import Runtime
from dynamo_tpu_torch.runtime.transports import tcp_control as ptcp

import pytest

REPO = Path(__file__).resolve().parent.parent
BUCKETS = dict(prefill_buckets=[32, 64, 128], decode_buckets=[1, 2, 4])
MODEL = "tiny"
# A shared prefix of 4 blocks (tiny's blocks hold 16 tokens) behind each
# family's chat template, so a repeat hits the prefix cache.
SYSTEM = "You are a terse assistant. Answer in one short line, always. " * 1
BODIES = [
    ("/v1/chat/completions", {"messages": [{"role": "system", "content": SYSTEM},
                                           {"role": "user", "content": "hello there"}], "max_tokens": 12}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "stream me a line"}], "max_tokens": 10,
                              "stream": True}),
    ("/v1/completions", {"prompt": "The quick brown fox jumps over the lazy dog, again and again", "max_tokens": 9}),
    ("/v1/completions", {"prompt": "jumps over", "max_tokens": 7, "stream": True}),
]
for _, _body in BODIES:
    _body.update(model=MODEL, temperature=0.0)
REPEAT = BODIES[0]


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(jax_config("tiny"), jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_numpy(tree, get_config("tiny"), device="cpu", dtype=torch.float32)


def port_engine(tp, **sched) -> TorchEngine:
    return TorchEngine.build(
        EngineArgs(model="tiny", dtype="float32", device="cpu", eos_token_ids=[0], continuous_profiling=False,
                   scheduler=SchedulerConfig(num_blocks=64, **BUCKETS, **sched)),
        params=tp)


def jax_engine(jp, **sched) -> TpuEngine:
    return TpuEngine.build(
        JaxEngineArgs(model="tiny", dtype="float32", continuous_profiling=False, eos_token_ids=[0],
                      scheduler=jsched.SchedulerConfig(num_blocks=64, **BUCKETS, **sched)),
        params=jp)


async def port_drt(address: str) -> DistributedRuntime:
    conn = await ptcp.connect_control_plane(address)
    drt = DistributedRuntime(runtime=Runtime(), store=ptcp.TcpKvStore(conn), bus=ptcp.TcpPubSub(conn))
    await drt.start()
    return drt


async def jax_drt(address: str) -> JaxDrt:
    conn = await jtcp.connect_control_plane(address)
    drt = JaxDrt(runtime=JaxRuntime(), store=jtcp.TcpKvStore(conn), bus=jtcp.TcpPubSub(conn))
    await drt.start()
    return drt


async def serve_jax_worker(drt, engine):
    """The JAX worker CLI's wiring (``dynamo_tpu/worker.py``): register,
    KV events hopped from the step thread, load metrics."""
    ep = drt.namespace("dynamo").component("backend").endpoint("generate")
    handle, _ = await jentry.register_llm(drt, ep, engine, JaxCard(name=MODEL), stats_handler=engine.stats_handler)
    kv_pub = JaxKvEventPublisher(drt, "dynamo", "backend", handle.instance.instance_id)
    kv_pub.start()
    loop = asyncio.get_running_loop()
    engine._kv_event_sink = lambda ev: kv_pub.publish_threadsafe(loop, ev)
    m_pub = JaxWorkerMetricsPublisher(drt, "dynamo", "backend", handle.instance.instance_id, engine.metrics)
    m_pub.start()
    return handle, [kv_pub, m_pub]


class Stack:
    """A control plane, workers and a frontend, each role with its own
    runtime over TCP. ``kind`` is the frontend's package ("port" or "jax"),
    ``workers`` lists each worker's. The control plane is the port's: the
    JAX server holds a client's every op behind its KV router's long-poll
    (up to 5 s a request; ``test_torch_runtime.py`` holds either package's
    client against either server)."""

    def __init__(self, kind, workers, weights, migration_limit=0, router_mode="kv", busy_threshold=None, **sched):
        self.kind, self.worker_kinds, self.weights = kind, workers, weights
        self.migration_limit, self.sched = migration_limit, sched
        self.router_mode, self.busy_threshold = router_mode, busy_threshold
        self.workers, self.engines, self.drts = [], [], []

    async def __aenter__(self):
        self.server = ptcp.ControlPlaneServer(host="127.0.0.1", port=0)
        await self.server.start()
        address = f"127.0.0.1:{self.server.port}"
        jp, tp = self.weights
        for wk in self.worker_kinds:
            if wk == "port":
                drt, engine = await port_drt(address), port_engine(tp, **self.sched)
                self.workers.append(await pworker.serve_engine(drt, engine, ModelDeploymentCard(name=MODEL)))
            else:
                drt, engine = await jax_drt(address), jax_engine(jp, **self.sched)
                self.workers.append(await serve_jax_worker(drt, engine))
            self.drts.append(drt)
            self.engines.append(engine)
        if self.kind == "port":
            self.front_drt = await port_drt(address)
            self.service = await pentry.start_frontend(self.front_drt, pentry.FrontendConfig(
                host="127.0.0.1", port=0, router_mode=self.router_mode, migration_limit=self.migration_limit,
                busy_threshold=self.busy_threshold))
        else:
            self.front_drt = await jax_drt(address)
            self.service = await jentry.start_frontend(self.front_drt, jentry.FrontendConfig(
                host="127.0.0.1", port=0, router_mode="kv", migration_limit=self.migration_limit))
        await wait_for(lambda: self.service.port and _get(self.service.port, "/v1/models")[1]["data"], 30)
        return self

    async def __aexit__(self, *exc):
        if self.kind == "port":
            await pentry.stop_frontend(self.service)
        else:
            await self.service.watcher.stop()
            await self.service.stop()
            for router in _routers_of(self):  # its KV-event subscriber reads the control plane
                await router.close()
        await self.front_drt.shutdown()
        for w, drt, engine in zip(self.workers, self.drts, self.engines):
            if isinstance(w, pworker.Worker):
                await w.stop(drain_timeout_s=5)
            else:
                for pub in w[1]:
                    await pub.stop()
            await drt.shutdown()
            await engine.stop()
        await self.server.close()

    async def post(self, path, body, headers=None):
        return await asyncio.to_thread(_post, self.service.port, path, body, headers)


async def wait_for(cond, timeout_s):
    deadline = time.monotonic() + timeout_s
    while True:
        got = await asyncio.to_thread(cond) if not asyncio.iscoroutinefunction(cond) else await cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise TimeoutError("condition not met")
        await asyncio.sleep(0.05)


def _post(port, path, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, json.loads(raw)


def answer(path, body, raw):
    """(text, finish_reason, usage) of a unary or streamed answer."""
    if not body.get("stream"):
        data = json.loads(raw)
        choice = data["choices"][0]
        return (choice["message"]["content"] if "chat" in path else choice["text"]), choice["finish_reason"], \
            data["usage"]
    chunks = [json.loads(e[6:]) for e in raw.decode().split("\n\n") if e.startswith("data: ") and e != "data: [DONE]"]
    text, finish, usage = "", None, None
    for c in chunks:
        assert "error" not in c, c
        for ch in c.get("choices") or []:
            text += (ch.get("delta") or {}).get("content") or "" if "chat" in path else ch.get("text") or ""
            finish = ch.get("finish_reason") or finish
        usage = c.get("usage") or usage
    return text, finish, usage


def requests_served(engine) -> int:
    return engine.scheduler.request_total


async def _drive(stack):
    """BODIES through the frontend, then the repeat: → (answers, repeat
    answer, index of the worker that served BODIES[0], of the one that
    served the repeat)."""
    answers = []
    before = [requests_served(e) for e in stack.engines]
    status, raw = await stack.post(*BODIES[0])
    assert status == 200, raw
    first = [requests_served(e) - b for e, b in zip(stack.engines, before)].index(1)
    answers.append(answer(*BODIES[0], raw))
    for path, body in BODIES[1:]:
        status, raw = await stack.post(path, body)
        assert status == 200, raw
        answers.append(answer(path, body, raw))
    await asyncio.sleep(0.3)  # KV events reach the router's index
    before = [requests_served(e) for e in stack.engines]
    status, raw = await stack.post(*REPEAT)
    assert status == 200, raw
    warm = [requests_served(e) - b for e, b in zip(stack.engines, before)].index(1)
    return answers, answer(*REPEAT, raw), first, warm


async def _stacks(weights):
    out = {}
    for kind in ("port", "jax"):
        async with Stack(kind, [kind, kind], weights) as stack:
            out[kind] = await _drive(stack)
            # Both workers deregister (a drain's first step): the model is
            # still listed, and a request is a retryable 503. Then their
            # leases go: the model leaves /v1/models, and a request is a 404.
            handles = [w.handle if kind == "port" else w[0] for w in stack.workers]
            for h, drt in zip(handles, stack.drts):
                await drt.store.delete(h.instance.etcd_key)
            (router,) = stack.service.routers.values() if kind == "port" else _routers_of(stack)
            await wait_for(lambda: not router.client.instances, 10)
            out[kind + "_drained"] = (await stack.post(*BODIES[2]),
                                      await asyncio.to_thread(_get, stack.service.port, "/v1/models"))
            for h, drt in zip(handles, stack.drts):
                await drt.store.revoke_lease(h.lease.id)
            await wait_for(lambda: not _get(stack.service.port, "/v1/models")[1]["data"], 10)
            out[kind + "_gone"] = await stack.post(*BODIES[2])
    return out


def test_port_stack_matches_jax_stack(weights):
    out = asyncio.run(_stacks(weights))
    (p_answers, p_rep, p_first, p_warm), (j_answers, j_rep, j_first, j_warm) = out["port"], out["jax"]
    for (path, body), got, want in zip(BODIES, p_answers, j_answers):
        assert got[:2] == want[:2], (path, body.get("stream"))
        assert got[1] == "stop" or got[2]["completion_tokens"] == body["max_tokens"]
    # The repeat: the same text, cached tokens on both, and the worker that
    # served the prompt first serves it again.
    assert p_rep[:2] == j_rep[:2] == p_answers[0][:2]
    p_cached = p_rep[2]["prompt_tokens_details"]["cached_tokens"]
    assert p_cached > 0 and p_cached == j_rep[2]["prompt_tokens_details"]["cached_tokens"]
    assert p_warm == p_first and j_warm == j_first
    for kind in ("port", "jax"):
        (status, raw), models = out[kind + "_drained"]
        assert status == 503 and b"no workers are live" in raw, (kind, raw)
        assert [m["id"] for m in models[1]["data"]] == [MODEL]
        assert out[kind + "_gone"][0] == 404, kind


async def _mixed(weights):
    """A port worker behind the JAX control plane and frontend: its text,
    its KV events in the JAX router's index, its stats scraped by the JAX
    client."""
    async with Stack("jax", ["port"], weights) as stack:
        answers, rep, _, _ = await _drive(stack)
        assert MODEL in stack.service.manager.list_models()
        ep = stack.front_drt.namespace("dynamo").component("backend").endpoint("generate")
        client = await ep.client()
        stats = await client.scrape_stats()
        await client.close()
        worker_id = stack.workers[0].instance_id
        # The JAX router's index holds the port worker's blocks.
        (kv_router,) = _routers_of(stack)
        indexed = kv_router.indexer.tree.workers()
        return answers, rep, stats, worker_id, indexed, stack.engines[0].stats_handler()


def _routers_of(stack):
    """The KV routers the JAX frontend built (its pipelines end in one)."""
    found = []
    for engines in stack.service.manager._engines.values():
        for engine in engines.values():
            node = engine
            while node is not None:
                router = getattr(node, "router", None)
                if router is not None:
                    found.append(router)
                    break
                node = getattr(node, "downstream", None)
    return found


def test_port_worker_behind_jax_frontend(weights):
    want = asyncio.run(_stacks_jax_only(weights))
    answers, rep, stats, worker_id, indexed, local_stats = asyncio.run(_mixed(weights))
    for (path, body), got, ref in zip(BODIES, answers, want[0]):
        assert got[:2] == ref[:2], (path, body.get("stream"))
    assert rep[2]["prompt_tokens_details"]["cached_tokens"] == want[1][2]["prompt_tokens_details"]["cached_tokens"] > 0
    assert indexed == [worker_id]
    (scraped,) = stats.values()
    assert set(local_stats) <= set(scraped) and scraped["cached_tokens_total"] > 0


async def _stacks_jax_only(weights):
    async with Stack("jax", ["jax"], weights) as stack:
        answers, rep, _, _ = await _drive(stack)
    return answers, rep


async def _migrating(weights):
    """Two port workers at one decode step an iteration (tokens stream one
    at a time), the frontend with ``migration_limit=1``: a request's answer
    uninterrupted, then the same request again, whose worker deregisters
    (the router prunes it) and stops with no time to drain once two frames
    have come, so its stream is severed half-way."""
    body = {"model": MODEL, "messages": [{"role": "user", "content": "count slowly"}], "max_tokens": 40,
            "temperature": 0.0, "nvext": {"ignore_eos": True}}
    async with Stack("port", ["port", "port"], weights, migration_limit=1, num_scheduler_steps=1) as stack:
        pipeline = stack.service.manager.get("chat", MODEL)
        router = stack.service.routers[MODEL]

        async def run(stop_after=None):
            parts, frames, finish, stopped = [], 0, None, None
            async for item in pipeline.generate(dict(body), Context()):
                data = item.data
                if data is None:
                    continue
                parts.append(data.get("text") or "")
                finish = data.get("finish_reason") or finish
                frames += 1
                if frames == stop_after:
                    (i,) = [i for i, e in enumerate(stack.engines) if e.scheduler.running]
                    stopped = stack.workers[i]
                    await stopped.drt.store.delete(stopped.handle.instance.etcd_key)
                    await wait_for(lambda: stopped.instance_id not in router.client.instances, 10)
                    await stopped.stop(drain_timeout_s=0)
            return "".join(parts), finish, stopped

        whole = await run()
        before = [e.scheduler.request_total for e in stack.engines]
        migrated = await run(stop_after=2)
        served = [e.scheduler.request_total - b for e, b in zip(stack.engines, before)]
        fam = parse_text(stack.service.metrics.render().decode())["dynamo_frontend_migrations_total"]
        counted = {labels["model"]: v for name, labels, v in fam["samples"] if name.endswith("_total")}
        return whole, migrated, served, stack.workers.index(migrated[2]), counted


def test_migration_completes_a_severed_stream(weights, caplog):
    whole, migrated, served, stopped, counted = asyncio.run(_migrating(weights))
    assert migrated[:2] == whole[:2] and whole[1] == "length" and len(whole[0]) > 0
    # The frontend's /metrics counts the one replay.
    assert counted == {MODEL: 1.0}
    # The stopped worker took the request, the other the replay.
    assert served[stopped] == 1 and served[1 - stopped] == 1
    assert any("recreating stream" in r.getMessage() for r in caplog.records)


async def _exhausted(weights):
    """One port worker at one decode step an iteration and no migration
    budget: its stream is severed half-way, and the unary answer is a 502
    with the tokens it had streamed."""
    body = {"model": MODEL, "prompt": "keep going", "max_tokens": 200, "temperature": 0.0,
            "nvext": {"ignore_eos": True}}
    async with Stack("port", ["port"], weights, num_scheduler_steps=1) as stack:
        answer = asyncio.ensure_future(stack.post("/v1/completions", body))
        seqs = stack.engines[0].scheduler.running
        await wait_for(lambda: any(len(q.output_ids) >= 3 for q in list(seqs)), 30)
        (worker,) = stack.workers
        await worker.drt.store.delete(worker.handle.instance.etcd_key)
        await worker.stop(drain_timeout_s=0)
        return await answer


def test_http_502_when_migration_is_exhausted(weights):
    status, raw = asyncio.run(_exhausted(weights))
    err = json.loads(raw)["error"]
    assert status == 502 and err["code"] == 502 and err["migrations"] == 0
    assert 0 < err["partial_tokens"] < 200


async def _busy(weights, mode):
    """Worker 0 gossips a KV usage of 0.9 over its real metrics publisher:
    → (requests each worker served of BODIES, the status of one more
    request once worker 1 gossips 0.9 too)."""
    async with Stack("port", ["port", "port"], weights, router_mode=mode, busy_threshold=0.5) as stack:
        (router,) = stack.service.routers.values()
        monitor = (router.push if mode == "kv" else router).monitor
        busy, idle = stack.workers
        busy.publishers[1].metrics_fn = lambda: {"kv_usage": 0.9}
        await wait_for(lambda: monitor.busy_instances() == {busy.instance_id}, 10)
        before = [requests_served(e) for e in stack.engines]
        for path, body in BODIES:
            status, raw = await stack.post(path, body)
            assert status == 200, raw
        served = [requests_served(e) - b for e, b in zip(stack.engines, before)]
        idle.publishers[1].metrics_fn = lambda: {"kv_usage": 0.9}
        await wait_for(lambda: len(monitor.busy_instances()) == 2, 10)
        status, _ = await stack.post(*BODIES[0])  # all busy: served all the same
        return served, status


@pytest.mark.parametrize("mode", ["round-robin", "random", "kv"])
def test_busy_threshold_skips_a_busy_worker(weights, mode):
    """The frontend's ``busy_threshold`` (``--busy-threshold``) in each
    router mode: a worker whose gossiped KV usage reaches it gets no request
    while another is free, and when every worker is busy requests still go
    through. (The JAX frontend sets it where nothing feeds the monitor, so
    there is no JAX side to hold this against.)"""
    served, status = asyncio.run(_busy(weights, mode))
    assert served == [0, len(BODIES)]
    assert status == 200


# The trace both engines serve for the stats comparison: a prompt, a second
# that shares its first two blocks (a prefix-cache hit), a third, then all
# three at once.
STATS_PROMPTS = [list(range(1, 41)), list(range(1, 33)) + [7] * 9, [3, 5, 7] * 7]


async def _stats(engine, ctx_cls):
    async def one(prompt, max_tokens):
        req = {"token_ids": prompt, "sampling_options": {"temperature": 0.0},
               "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}
        return [t async for f in engine.generate(req, ctx_cls()) for t in f["token_ids"]]

    tokens = [await one(p, 6) for p in STATS_PROMPTS]
    tokens += await asyncio.gather(*(one(p, 5) for p in STATS_PROMPTS))
    stats = engine.stats_handler()
    await engine.stop()
    return tokens, stats


def test_stats_handler_keys_and_counts_match_jax(weights):
    jp, tp = weights
    p_tokens, port = asyncio.run(_stats(port_engine(tp, num_scheduler_steps=1), Context))
    j_tokens, ref = asyncio.run(_stats(jax_engine(jp, num_scheduler_steps=1), JaxContext))
    assert p_tokens == j_tokens
    assert set(port) <= set(ref), set(port) - set(ref)
    # The compile trackers count different things (XLA compiles in JAX, step
    # graph captures in the port, none on the CPU): both present, not equal.
    compiles = {"compiles_total", "compiles_after_warmup_total"}
    counts = {k for k, v in port.items() if isinstance(v, int)} - compiles
    assert counts >= {"cached_tokens_total", "prefix_hit_blocks_total", "mixed_steps_total", "kv_total_blocks",
                      "step_prefill_steps_total", "step_decode_tokens_total", "decode_host_gap_events_total"}
    assert {k: port[k] for k in counts} == {k: ref[k] for k in counts}
    assert port["cached_tokens_total"] > 0 and port["compiles_after_warmup_total"] == 0
    # Host seconds, and the rates and fractions over them, are each
    # package's own (JAX's hold its compiles), not the other's.
    timed = {k for k in port if k.endswith("_seconds_total") or k.startswith(("mfu_", "hbm_frac_"))
             or k in ("last_step_age_s", "goodput_req_per_s", "goodput_tok_per_s")}
    assert all(port[k] >= 0 and ref[k] >= 0 for k in timed) and port["prefill_wait_seconds_total"] > 0
    # The digests: the same streams, each with the same number of samples.
    assert {n: d["total"]["count"] for n, d in port.pop("digests").items()} == {
        n: d["total"]["count"] for n, d in ref["digests"].items()}
    # The tenant ledger's wire: the same bills, tokens and tenants (its
    # seconds are each package's host time).
    p_led, j_led = port.pop("tenant_ledger"), ref["tenant_ledger"]
    assert (p_led["bills"], p_led["totals"]["output_tokens"]) == (j_led["bills"], j_led["totals"]["output_tokens"])
    assert [r[0] for r in p_led["sketches"]["device_seconds"]["items"]] == ["anon"] == [
        r[0] for r in j_led["sketches"]["device_seconds"]["items"]]
    # Bytes follow the attention path's KV-read factor: the port's "auto" is
    # the ragged kernel (each page read once), JAX's on the CPU the gather
    # (read, copied and read again), so the port's are at most JAX's.
    moved = {k for k in port if k.endswith("_bytes_total")}
    assert moved and all(0 < port[k] <= ref[k] for k in moved)
    for k in set(port) - counts - compiles - timed - moved:  # gauges: usage, fragmentation, hit rate, dial, FLOPs
        assert port[k] == pytest.approx(ref[k]), k


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Lines:
    """Collects a process's output lines on a thread."""

    def __init__(self, stream):
        self.lines = []
        self._t = threading.Thread(target=lambda: [self.lines.append(ln) for ln in stream], daemon=True)
        self._t.start()

    def wait_for(self, needle: str, proc, timeout_s: float) -> str:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            for ln in list(self.lines):
                if needle in ln:
                    return ln
            assert proc.poll() is None, "".join(self.lines)
            time.sleep(0.05)
        raise TimeoutError(f"{needle!r} not seen: {''.join(self.lines)[-2000:]}")

    def join(self):
        self._t.join(timeout=10)


def test_cli_round_trip():
    """Control plane, worker and frontend as processes: the frontend finds
    the model, answers a chat request, and every process exits with 0 on
    SIGTERM; the worker's last line holds its launch counters."""
    cp_port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(REPO), DYN_CONTROL_PLANE="tcp", DYN_CONTROL_PLANE_ADDRESS=f"127.0.0.1:{cp_port}",
               DYN_LOG="INFO")
    py = [sys.executable, "-m"]
    procs = []
    try:
        cp = subprocess.Popen(py + ["dynamo_tpu_torch.control_plane", "--host", "127.0.0.1", "--port", str(cp_port)],
                              env=env, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(cp)
        _Lines(cp.stdout).wait_for("control plane ready", cp, 60)
        worker = subprocess.Popen(py + ["dynamo_tpu_torch.worker", "--device", "cpu", "--model", "tiny",
                                        "--dtype", "float32", "--num-blocks", "64"],
                                  env=env, cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        procs.append(worker)
        w_lines = _Lines(worker.stderr)
        w_lines.wait_for("worker ready", worker, 120)
        front = subprocess.Popen(py + ["dynamo_tpu_torch.frontend", "--http-host", "127.0.0.1", "--http-port", "0",
                                       "--router-mode", "kv"],
                                 env=env, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(front)
        line = _Lines(front.stdout).wait_for("frontend ready on", front, 120)
        port = int(line.split(" (")[0].rsplit(":", 1)[1])
        deadline = time.monotonic() + 30
        while not _get(port, "/v1/models")[1]["data"]:
            assert time.monotonic() < deadline
            time.sleep(0.1)
        status, raw = _post(port, "/v1/chat/completions", {"model": MODEL, "max_tokens": 5, "temperature": 0.0,
                                                            "messages": [{"role": "user", "content": "hi"}]})
        assert status == 200, raw
        assert json.loads(raw)["usage"]["completion_tokens"] <= 5
        for p in reversed(procs):
            p.send_signal(signal.SIGTERM)
            assert p.wait(timeout=60) == 0
        w_lines.join()
        (counters,) = [ln for ln in w_lines.lines if "worker launch counters: " in ln]
        counters = json.loads(counters.split("worker launch counters: ", 1)[1])
        assert counters["steps"]["request_total"] == 1 and counters["steps"]["forward_steps_total"] > 0
        # On the CPU every wrapper runs its plain version.
        assert counters["kernels"]["ragged_paged_attention"]["plain_calls"] > 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_worker_defaults_to_cuda_and_raises_without_it():
    from dynamo_tpu_torch import frontend as pfrontend

    args = pworker.build_parser().parse_args(["--model", "tiny"])
    assert args.device == "cuda" and args.role == "aggregated"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pworker.build_engine(args)
    # The JAX frontend's flags for what is ported parse to its config.
    cfg = pfrontend.frontend_config(pfrontend.build_parser().parse_args(
        ["--router-mode", "kv", "--migration-limit", "2", "--router-temperature", "0.5", "--retry-backoff-ms", "20"]))
    assert (cfg.router_mode, cfg.migration_limit, cfg.kv_temperature, cfg.retry_backoff_base_s) == ("kv", 2, 0.5, 0.02)


@pytest.mark.parametrize("cli,flags", [
    ("worker", ["--mocker"]), ("worker", ["--dp", "2"]), ("worker", ["--tp", "2"]),
    ("worker", ["--ep", "2"]), ("worker", ["--block-size", "16"]), ("worker", ["--speedup-ratio", "2"]),
    ("frontend", ["--grpc-port", "1"]), ("frontend", ["--fault-scenario", "x"]), ("worker", ["--pp", "2"]),
])
def test_unported_jax_flags_are_refused(cli, flags):
    from dynamo_tpu_torch import frontend as pfrontend

    parser = (pworker if cli == "worker" else pfrontend).build_parser()
    with pytest.raises(SystemExit):
        parser.parse_args(flags)


OBSERVABILITY_FLAGS = {
    "worker": ["trace_file", "trace_sample", "trace_ring", "trace_tail", "slo_ttft_ms", "slo_tpot_ms",
               "stall_after_s", "health_port", "incident_dir", "incident_keep", "profile_on_incident",
               "no_continuous_profiling", "profile_window_s", "profile_interval_s", "profile_dir"],
    "frontend": ["trace_file", "trace_sample", "trace_ring", "trace_tail", "slo_ttft_ms", "slo_tpot_ms"],
}


@pytest.mark.parametrize("cli", sorted(OBSERVABILITY_FLAGS))
def test_observability_flags_parse_to_jax_defaults_and_values(cli):
    """The tracer, SLO, watchdog, health, incident and profiling flags parse
    to the JAX CLI's defaults, and to its values when given."""
    from dynamo_tpu import frontend as jfrontend
    from dynamo_tpu import worker as jworker
    from dynamo_tpu_torch import frontend as pfrontend

    port, ref = (pworker, jworker) if cli == "worker" else (pfrontend, jfrontend)
    keys = OBSERVABILITY_FLAGS[cli]
    given = ["--trace-file", "t.jsonl", "--trace-sample", "0.25", "--trace-ring", "64", "--trace-tail",
             "--slo-ttft-ms", "300", "--slo-tpot-ms", "40"]
    if cli == "worker":
        given += ["--stall-after-s", "9", "--health-port", "0", "--incident-dir", "inc", "--incident-keep", "4",
                  "--profile-on-incident", "--no-continuous-profiling", "--profile-window-s", "0.1",
                  "--profile-interval-s", "5", "--profile-dir", "prof"]
    for argv in ([], given):
        a, b = vars(port.build_parser().parse_args(argv)), vars(ref.build_parser().parse_args(argv))
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}, argv
    args = port.build_parser().parse_args(given)
    if cli == "worker":
        sc = SchedulerConfig(slo_ttft_ms=args.slo_ttft_ms, slo_tpot_ms=args.slo_tpot_ms,
                             stall_after_s=args.stall_after_s)
        assert (sc.slo_ttft_ms, sc.slo_tpot_ms, sc.stall_after_s) == (300.0, 40.0, 9.0)
    else:
        cfg = pfrontend.frontend_config(args)
        assert (cfg.slo_ttft_ms, cfg.slo_tpot_ms) == (300.0, 40.0)


def test_disagg_and_kvbm_flags_parse():
    """The worker's roles and KVBM tiers, with the JAX CLI's names and
    defaults (``--kv-transfer device``)."""
    args = pworker.build_parser().parse_args(
        ["--role", "decode", "--kv-transfer", "host", "--max-local-prefill-length", "512", "--kvbm-host-blocks",
         "8", "--kvbm-disk-dir", "d", "--kvbm-disk-blocks", "16", "--kvbm-remote"])
    assert (args.role, args.kv_transfer, args.max_local_prefill_length) == ("decode", "host", 512)
    assert (args.kvbm_host_blocks, args.kvbm_disk_dir, args.kvbm_disk_blocks, args.kvbm_remote) == (8, "d", 16, True)
    args = pworker.build_parser().parse_args(["--role", "prefill"])
    assert (args.role, args.kv_transfer, args.kvbm_host_blocks, args.kvbm_remote) == ("prefill", "device", 0, False)


# ---------------------------------------------------------------------------
# 7. A worker serving model files
# ---------------------------------------------------------------------------

FILE_MODEL = "tiny-files"
FILE_BODIES = [
    ("/v1/chat/completions", {"messages": [{"role": "system", "content": "You are terse."},
                                           {"role": "user", "content": "Which worker holds the prefix?"}],
                              "max_tokens": 12}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "Stream it, please."}], "max_tokens": 10,
                              "stream": True}),
    ("/v1/completions", {"prompt": "The router hashes each block of", "max_tokens": 9}),
]
for _, _body in FILE_BODIES:
    _body.update(model=FILE_MODEL, temperature=0.0)


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """tiny's seeded JAX weights with 1,024 ids as HF safetensors, and a
    Llama-3-layout tokenizer of that size. → (checkpoint, tokenizer dir)."""
    import chip_smoke

    root = tmp_path_factory.mktemp("files")
    tcfg = get_config("tiny").replace(vocab_size=1024)
    jp = jllama.init_params(jax_config("tiny").replace(vocab_size=1024), jax.random.PRNGKey(6), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu", dtype=torch.float32)
    chip_smoke.write_hf_checkpoint(str(root / "ckpt"), tp, tcfg)
    chip_smoke.write_tokenizer(str(root / "tok"), chip_smoke.llama3_tokenizer_spec(size=768, n_special=256))
    return str(root / "ckpt"), str(root / "tok")


async def _files_stack(front: str, worker: str, files, template):
    """One worker of ``worker``'s package serving the files, behind
    ``front``'s frontend: FILE_BODIES' answers and the card it published."""
    from dynamo_tpu.llm.tokenizer import HFTokenizer as JaxHFTokenizer

    ckpt, tok_dir = files
    server = ptcp.ControlPlaneServer(host="127.0.0.1", port=0)
    await server.start()
    address = f"127.0.0.1:{server.port}"
    try:
        if worker == "port":
            args = pworker.build_parser().parse_args([
                "--model", FILE_MODEL, "--checkpoint", ckpt, "--tokenizer", tok_dir, "--device", "cpu",
                "--dtype", "float32", "--num-blocks", "64"])
            drt, engine = await port_drt(address), pworker.build_engine(args)
            card = dataclasses.replace(pworker.build_card(args, engine), chat_template=template)
            handle = await pworker.serve_engine(drt, engine, card)
        else:
            tok = JaxHFTokenizer(tok_dir)
            drt = await jax_drt(address)
            engine = TpuEngine.build(JaxEngineArgs(
                model="tiny", model_config=jax_config("tiny").replace(vocab_size=1024), dtype="float32",
                checkpoint_path=ckpt, tokenizer=tok, eos_token_ids=tok.eos_token_ids, continuous_profiling=False,
                scheduler=jsched.SchedulerConfig(num_blocks=64, max_running=16)))
            card = JaxCard(name=FILE_MODEL, model_type="chat", tokenizer_path=tok_dir, chat_template=template)
            ep = drt.namespace("dynamo").component("backend").endpoint("generate")
            handle = await jentry.register_llm(drt, ep, engine, card, stats_handler=engine.stats_handler)
        front_drt = await (port_drt if front == "port" else jax_drt)(address)
        entry = pentry if front == "port" else jentry
        service = await entry.start_frontend(front_drt, entry.FrontendConfig(host="127.0.0.1", port=0,
                                                                            router_mode="round-robin"))
        await wait_for(lambda: service.port and _get(service.port, "/v1/models")[1]["data"], 30)
        answers = []
        for path, body in FILE_BODIES:
            status, raw = await asyncio.to_thread(_post, service.port, path, body)
            assert status == 200, raw
            answers.append(answer(path, body, raw))
        if front == "port":
            await pentry.stop_frontend(service)
        else:
            await service.watcher.stop()
            await service.stop()
        await front_drt.shutdown()
        if worker == "port":
            await handle.stop(drain_timeout_s=5)
        await drt.shutdown()
        await engine.stop()
        return answers, card
    finally:
        await server.close()


@pytest.mark.parametrize("template", [None, "llama3"])
def test_worker_serves_model_files_like_jax(model_files, monkeypatch, template):
    import chip_smoke
    from dynamo_tpu_torch.engine import config as pconfig

    monkeypatch.setitem(pconfig.PRESETS, FILE_MODEL, get_config("tiny").replace(name=FILE_MODEL, vocab_size=1024))
    source = chip_smoke.LLAMA3_CHAT_TEMPLATE if template else None
    want, _ = asyncio.run(_files_stack("jax", "jax", model_files, source))
    for front in ("port", "jax"):
        got, card = asyncio.run(_files_stack(front, "port", model_files, source))
        assert card.tokenizer_path == model_files[1] and card.chat_template == source
        for (path, body), g, w in zip(FILE_BODIES, got, want):
            assert g[:2] == w[:2], (front, path, body.get("stream"))
            assert g[1] == "stop" or g[2]["completion_tokens"] == body["max_tokens"]
