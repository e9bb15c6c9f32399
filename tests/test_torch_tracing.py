"""The port's request tracing (``runtime/tracing.py``) against the JAX
package's, and one trace through the port's serving stack:

- head sampling: the same keep/drop decision for 1000 trace ids at sample
  rates 0, 0.01, 0.3 and 1 (crc32 of the id, as in JAX);
- the record schema: span and event records of the same calls have the
  same fields and values, ids and times aside;
- JAX's ``chrome_trace`` of the port's records equals the port's;
- the ring, tail keep and ``promote``: the same ring contents, promotion
  counts and exported records for the same calls;
- the demo stack of ``tests/test_tracing.py`` on the port (HTTP →
  push router over the wire → worker → scheduler) and on JAX: one trace
  id, the same (service, kind, name) records, the worker span parented by a
  frontend span, the scheduler's events by the worker span, the route event
  by the HTTP span, and the trace id echoed on the response;
- mixed stacks: a JAX frontend before a port worker and a port frontend
  before a JAX worker keep one trace id across the two packages' files;
- ``tools/trace_view.py`` renders the port's file (run with ``PYTHONPATH``
  at the repo root), as a timeline and as a Chrome trace.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.llm.discovery import ModelManager as JaxModelManager
from dynamo_tpu.llm.entrypoint import build_routed_pipeline as jax_routed
from dynamo_tpu.llm.entrypoint import register_llm as jax_register
from dynamo_tpu.llm.http.service import HttpService as JaxHttpService
from dynamo_tpu.llm.model_card import ModelDeploymentCard as JaxCard
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu.runtime import tracing as jtracing
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxDrt
from dynamo_tpu.runtime.logging import TraceParent as JaxTraceParent
from dynamo_tpu.runtime.push_router import PushRouter as JaxPushRouter
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.discovery import ModelManager
from dynamo_tpu_torch.llm.entrypoint import build_routed_pipeline, register_llm
from dynamo_tpu_torch.llm.http.service import TRACE_ID_HEADER, HttpService
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.runtime import tracing as ptracing
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.logging import TraceParent
from dynamo_tpu_torch.runtime.push_router import PushRouter

REPO = Path(__file__).resolve().parent.parent
MODEL = "tiny-traced"
TRACE_ID = "ab" * 16
HEADERS = {"traceparent": f"00-{TRACE_ID}-{'cd' * 8}-01"}
BODY = {"model": MODEL, "messages": [{"role": "user", "content": "trace me"}], "max_tokens": 4, "temperature": 0}
SCHED = dict(num_blocks=64, prefill_buckets=[16, 32, 64], decode_buckets=[1, 2, 4])


@pytest.fixture
def traced(tmp_path):
    """Both packages' process tracers on fresh JSONL files (every trace
    sampled); disabled again afterwards."""
    paths = (str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl"))
    ptracing.configure_tracing(path=paths[0], sample=1.0, service="test")
    jtracing.configure_tracing(path=paths[1], sample=1.0, service="test")
    yield paths
    ptracing.configure_tracing(path=None, sample=0.0)
    jtracing.configure_tracing(path=None, sample=0.0)


def _read(paths) -> tuple:
    ptracing.get_tracer().flush()
    jtracing.get_tracer().flush()
    return tuple(ptracing.read_trace_file(p) if os.path.exists(p) else [] for p in paths)


@pytest.mark.parametrize("sample", [0.0, 0.01, 0.3, 1.0])
def test_sampling_decisions_equal(sample):
    ids = [f"{int(x):032x}" for x in np.random.default_rng(11).integers(1, 2**62, 1000)]
    p = ptracing.Tracer(path=None, sample=sample, ring_size=4)
    j = jtracing.Tracer(path=None, sample=sample, ring_size=4)
    got = [p.sampled(t) for t in ids]
    assert got == [j.sampled(t) for t in ids]
    assert [p.record_allowed(t) for t in ids] == [j.record_allowed(t) for t in ids]
    if 0.0 < sample < 1.0:
        assert 0 < sum(got) < len(ids)


def _emit(tracer, tp_cls) -> None:
    """The same span, nested event, error span and instant event."""
    tp = tp_cls(trace_id=TRACE_ID, parent_id="cd" * 8)
    with tracer.span_from("http_request", tp, service="frontend", model="m", stream=False) as span:
        span.event("picked", worker="a1")
        span.set(status=200)
    with pytest.raises(RuntimeError):
        with tracer.span("worker_handle", TRACE_ID, parent_id=span.span_id, instance="ff"):
            raise RuntimeError("boom")
    tracer.event("first_token", TRACE_ID, parent_id="ef" * 8, service="scheduler", request_id="r1", ttft_s=0.5)
    tracer.event("bare", TRACE_ID)


def _masked(records) -> list:
    out = []
    for rec in records:
        r = {k: v for k, v in rec.items() if k not in ("span_id", "ts", "dur_s")}
        if "events" in r:
            r["events"] = [{k: v for k, v in e.items() if k != "ts"} for e in r["events"]]
        if r.get("parent_id") and r["name"] == "worker_handle":
            r["parent_id"] = "<http span>"
        out.append(r)
    return out


def test_record_schema_and_chrome_trace_equal():
    p = ptracing.Tracer(path=None, sample=1.0, service="svc", ring_size=64)
    j = jtracing.Tracer(path=None, sample=1.0, service="svc", ring_size=64)
    _emit(p, TraceParent)
    _emit(j, JaxTraceParent)
    pr, jr = p.ring_records(), j.ring_records()
    assert [sorted(r) for r in pr] == [sorted(r) for r in jr]
    assert _masked(pr) == _masked(jr)
    assert pr[1]["parent_id"] == pr[0]["span_id"] and pr[1]["attrs"]["error"] == "RuntimeError: boom"
    # JAX's converter reads the port's records as the port's does.
    assert jtracing.chrome_trace(pr) == ptracing.chrome_trace(pr)
    assert json.dumps(ptracing.chrome_trace(pr))


def test_ring_tail_and_promote_equal(tmp_path):
    ids = [f"{i:032x}" for i in range(1, 41)]
    results = []
    for mod, name in ((ptracing, "port"), (jtracing, "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        tracer = mod.Tracer(path=path, sample=0.3, service="svc", ring_size=16, tail=True)
        for i, t in enumerate(ids):
            tracer.event("e", t, seq=i)
            with tracer.span("s", t, seq=i):
                pass
        promoted = [tracer.promote(t) for t in ids[-10:]] + [tracer.promote(ids[-1])]
        ring = [(r["kind"], r["trace_id"], (r.get("attrs") or {}).get("seq")) for r in tracer.ring_records()]
        tracer.flush()
        exported = [(r["kind"], r["trace_id"], (r.get("attrs") or {}).get("seq")) for r in mod.read_trace_file(path)]
        results.append((promoted, ring, sorted(exported), tracer.enabled, tracer.tail))
    assert results[0] == results[1]
    promoted, ring, exported, enabled, tail = results[0]
    assert enabled and tail and len(ring) == 16 and any(promoted[:-1]) and promoted[-1] == 0
    # Off: no file, no ring, no records, and the default tracer records nothing.
    off = ptracing.Tracer(path=None, sample=1.0, ring_size=0)
    assert not off.enabled and off.span("x", ids[0]) is ptracing.NULL_SPAN
    assert not ptracing.Tracer().enabled


def _weights():
    jp = jllama.init_params(jax_config("tiny"), jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), get_config("tiny"), device="cpu",
                                 dtype=torch.float32)


def _post(port: int):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", json.dumps(BODY), {"Content-Type": "application/json", **HEADERS})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, resp.getheader(TRACE_ID_HEADER), json.loads(raw)


async def _demo_stack(kind: str, params):
    """frontend → push router (the wire path) → worker → scheduler, in one
    process, as ``tests/test_tracing.py`` builds it."""
    if kind == "port":
        drt = await DistributedRuntime.detached()
        engine = TorchEngine.build(EngineArgs(model="tiny", dtype="float32", device="cpu", eos_token_ids=[0],
                                              scheduler=SchedulerConfig(**SCHED)), params=params)
        card, mm, routed, register, router, tok, svc = (ModelDeploymentCard, ModelManager, build_routed_pipeline,
                                                        register_llm, PushRouter, ByteTokenizer, HttpService)
    else:
        drt = await JaxDrt.detached()
        engine = TpuEngine.build(JaxEngineArgs(model="tiny", dtype="float32", continuous_profiling=False,
                                               eos_token_ids=[0], scheduler=JaxSchedulerConfig(**SCHED)),
                                 params=params)
        card, mm, routed, register, router, tok, svc = (JaxCard, JaxModelManager, jax_routed, jax_register,
                                                        JaxPushRouter, JaxByteTokenizer, JaxHttpService)
    service = None
    try:
        ep = drt.namespace("tracetest").component("backend").endpoint("generate")
        c = card(name=MODEL, model_type="chat")
        handle, _ = await register(drt, ep, engine, c, stats_handler=engine.stats_handler)
        drt.local_engines.pop(handle.instance.instance_id)  # the wire path, not the in-process one
        client = await ep.client()
        await client.wait_for_instances(1, timeout=5)
        manager = mm()
        manager.add_model("chat", MODEL, routed(tok(), router(client), c))
        service = svc(manager, host="127.0.0.1", port=0)
        await service.start()
        return await asyncio.to_thread(_post, service.port)
    finally:
        if service is not None:
            await service.stop()
        await engine.stop()
        await drt.shutdown()


def _structure(records) -> tuple:
    names = sorted({(r["service"], r["kind"], r["name"]) for r in records})
    spans = {r["span_id"]: r for r in records if r["kind"] == "span"}
    worker = next(r for r in records if r["name"] == "worker_handle")
    http = next(r for r in records if r["name"] == "http_request")
    parents = {
        "worker": spans[worker["parent_id"]]["service"],
        "scheduler": {r["parent_id"] == worker["span_id"] for r in records if r["service"] == "scheduler"},
        "route": next(r for r in records if r["name"] == "route")["parent_id"] == http["span_id"],
        "http": http["parent_id"],
    }
    return names, parents


def test_demo_stack_one_trace_same_spans_as_jax(traced, tmp_path):
    jp, tp = _weights()
    p_status, p_echo, p_body = asyncio.run(_demo_stack("port", tp))
    j_status, j_echo, j_body = asyncio.run(_demo_stack("jax", jp))
    port_records, jax_records = _read(traced)
    assert (p_status, p_echo) == (j_status, j_echo) == (200, TRACE_ID)
    assert p_body["choices"][0]["message"] == j_body["choices"][0]["message"]
    assert port_records and {r["trace_id"] for r in port_records} == {TRACE_ID}
    assert _structure(port_records) == _structure(jax_records)
    names, parents = _structure(port_records)
    assert {("frontend", "span", "http_request"), ("frontend", "event", "route"), ("worker", "span", "worker_handle"),
            ("scheduler", "event", "queued"), ("scheduler", "event", "admitted"),
            ("scheduler", "event", "first_token"), ("scheduler", "event", "finish")} <= set(names)
    assert parents == {"worker": "frontend", "scheduler": {True}, "route": True, "http": "cd" * 8}
    # The repo's viewer reads the port's file.
    out = str(tmp_path / "chrome.json")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for argv in ([traced[0]], [traced[0], "-t", TRACE_ID], [traced[0], "--summary"], [traced[0], "--chrome", out]):
        proc = subprocess.run([sys.executable, str(REPO / "tools" / "trace_view.py"), *argv], capture_output=True,
                              text=True, timeout=120, env=env, cwd=str(REPO))
        assert proc.returncode == 0, proc.stderr
        if "-t" in argv:
            assert "worker_handle" in proc.stdout and "first_token" in proc.stdout
    assert json.load(open(out))["traceEvents"] == ptracing.chrome_trace(port_records)["traceEvents"]


async def _mixed(front: str):
    """A frontend of one package before a worker of the other, over the TCP
    control plane, one traced request."""
    sys.path.insert(0, str(REPO / "tests"))
    from test_torch_distributed import Stack

    worker = "jax" if front == "port" else "port"
    async with Stack(front, [worker], _weights()) as stack:
        status, raw = await stack.post("/v1/chat/completions", {**BODY, "model": "tiny"}, HEADERS)
        return status, raw


@pytest.mark.parametrize("front", ["port", "jax"])
def test_one_trace_across_the_two_packages(traced, front):
    status, raw = asyncio.run(_mixed(front))
    port_records, jax_records = _read(traced)
    assert status == 200, raw
    front_records, worker_records = (port_records, jax_records) if front == "port" else (jax_records, port_records)
    assert front_records and worker_records
    assert {r["trace_id"] for r in front_records + worker_records} == {TRACE_ID}
    assert {"http_request", "route"} <= {r["name"] for r in front_records}
    assert {"worker_handle", "queued", "admitted", "first_token", "finish"} <= {r["name"] for r in worker_records}
    http = next(r for r in front_records if r["name"] == "http_request")
    worker = next(r for r in worker_records if r["name"] == "worker_handle")
    assert worker["parent_id"] == http["span_id"]
