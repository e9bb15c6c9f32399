"""The rest of the port's HTTP surface against the JAX service, on ``tiny``
(f32, CPU), both servers in one loop over the same weights:

- ``/v1/responses`` unary and streamed (the JAX contracts of
  ``tests/test_embeddings_responses.py:82-187``): the same text, output
  items, usage and SSE event sequence; tools in the Responses shape with a
  forced ``tool_choice`` come back as the same ``function_call`` items; a
  bad input item, a missing input and an unknown model get JAX's bodies.
- HTTP/1.1 keep-alive: three requests on one socket, then ``Connection:
  close``; an SSE stream ends its connection.
- TLS from an ``openssl``-made certificate (as ``tests/test_http_serve.py``),
  and the refusal of only one of the two paths (service and frontend).
- ``request_timeout_ms``: a request with no ``timeout`` gets JAX's 504 body
  and the scheduler evicts its row (nothing left running).
"""

from __future__ import annotations

import asyncio
import http.client
import json
import socket
import ssl
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.engine import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.scheduler import SchedulerConfig as JaxSchedulerConfig
from dynamo_tpu.llm.discovery import ModelManager as JaxModelManager
from dynamo_tpu.llm.entrypoint import build_local_pipeline as jax_pipeline
from dynamo_tpu.llm.http.service import HttpService as JaxHttpService
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu_torch import frontend
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.discovery import ModelManager
from dynamo_tpu_torch.llm.entrypoint import FrontendConfig, build_local_pipeline
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

TCFG = get_config("tiny")
JCFG = jax_config("tiny")
MODEL = "tiny"
SCHED = dict(num_blocks=64, prefill_buckets=[16, 32, 64, 128], decode_buckets=[1, 2, 4], num_scheduler_steps=1)
TOOL = {"type": "function", "name": "get_weather", "description": "weather of a city",
        "parameters": {"type": "object", "properties": {"city": {"type": "string", "enum": ["SF", "NY"]}},
                       "required": ["city"]}}


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, device="cpu", dtype=torch.float32)


def _port_engine(tp):
    return TorchEngine.build(EngineArgs(model="tiny", dtype="float32", device="cpu", eos_token_ids=[0],
                                        scheduler=SchedulerConfig(**SCHED)), params=tp)


class _Pair:
    """The port's service and the JAX service over the same weights."""

    def __init__(self, weights, **service_kw):
        jp, tp = weights
        self.engine = _port_engine(tp)
        self.jengine = TpuEngine.build(JaxEngineArgs(model="tiny", dtype="float32", continuous_profiling=False,
                                                     eos_token_ids=[0], scheduler=JaxSchedulerConfig(**SCHED)),
                                       params=jp)
        manager, jmanager = ModelManager(), JaxModelManager()
        manager.add_model("chat", MODEL, build_local_pipeline(ByteTokenizer(), self.engine))
        jmanager.add_model("chat", MODEL, jax_pipeline(JaxByteTokenizer(), self.jengine))
        self.service = HttpService(manager, host="127.0.0.1", port=0, **service_kw)
        self.jservice = JaxHttpService(jmanager, host="127.0.0.1", port=0, **service_kw)

    async def __aenter__(self):
        await self.service.start()
        await self.jservice.start()
        return self

    async def __aexit__(self, *exc):
        await self.service.stop()
        await self.jservice.stop()
        await self.engine.stop()
        await self.jengine.stop()

    async def both(self, path, body):
        got = await asyncio.to_thread(_post, self.service.port, path, body)
        want = await asyncio.to_thread(_post, self.jservice.port, path, body)
        return got, want


def _post(port, path, body):
    """(status, parsed JSON, or the SSE events' data for a stream)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    if resp.getheader("Content-Type", "").startswith("text/event-stream"):
        return resp.status, [json.loads(ln[5:]) for ln in raw.decode().splitlines() if ln.startswith("data:")]
    return resp.status, json.loads(raw)


def _mask(obj, rid):
    """A body with its response id, timestamps, tool call ids (random in
    both) and id-derived names replaced, so two services' answers compare."""
    text = json.dumps(obj).replace(rid, "RID")
    out = json.loads(text)

    def walk(x):
        if isinstance(x, dict):
            return {k: ("T" if k in ("created_at", "call_id") else walk(v)) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        return x

    return walk(out)


RESPONSES = [
    {"model": MODEL, "input": "say hi", "instructions": "be terse", "max_output_tokens": 5},
    {"model": MODEL, "input": [{"role": "user", "content": [{"type": "input_text", "text": "two "},
                                                            {"type": "input_text", "text": "parts"}]}],
     "max_output_tokens": 7, "temperature": 0.0},
    {"model": MODEL, "input": "weather?", "tools": [TOOL], "tool_choice": {"type": "function", "name": "get_weather"},
     "max_output_tokens": 64, "temperature": 0.0},
]


async def test_responses_match_jax(weights):
    async with _Pair(weights) as pair:
        unary = []
        for body in RESPONSES:
            for stream in (False, True):
                (status, got), (jstatus, want) = await pair.both("/v1/responses", {**body, "stream": stream})
                assert status == jstatus == 200, (got, want)
                if not stream:
                    assert got["object"] == "response" and got["status"] == "completed"
                    assert _mask(got, got["id"]) == _mask(want, want["id"])
                    unary.append(got)
                    continue
                rid = got[0]["response"]["id"]
                assert [e["type"] for e in got] == [e["type"] for e in want]
                assert [e["sequence_number"] for e in got] == list(range(len(got)))
                assert _mask(got, rid) == _mask(want, want[0]["response"]["id"])
        # The forced tool call is a function_call item and no message.
        got = unary[2]
        assert [o["type"] for o in got["output"]] == ["function_call"]
        assert got["output"][0]["name"] == "get_weather" and json.loads(got["output"][0]["arguments"])["city"]
        for bad in ({"model": MODEL, "input": [42]}, {"model": MODEL}, {"model": "nope", "input": "x"},
                    {"model": MODEL, "input": "x", "text": {"format": {"type": "yaml"}}}):
            (status, got), (jstatus, want) = await pair.both("/v1/responses", bad)
            assert status == jstatus and status in (400, 404) and got == want, bad


def _read_response(sock_file):
    """One HTTP/1.1 response off a socket file → (status, headers, body)."""
    status = int(sock_file.readline().split()[1])
    headers = {}
    while True:
        line = sock_file.readline().decode().strip()
        if not line:
            break
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length", 0))
    return status, headers, sock_file.read(n) if n else b""


def _keep_alive_session(port):
    body = json.dumps({"model": MODEL, "prompt": "keep me", "max_tokens": 3, "temperature": 0.0}).encode()
    req = (b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\nContent-Length: "
           + str(len(body)).encode() + b"\r\n\r\n" + body)
    seen = []
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        f = s.makefile("rb")
        for _ in range(3):
            s.sendall(req)
            seen.append(_read_response(f))
        s.sendall(req.replace(b"Host: x\r\n", b"Host: x\r\nConnection: close\r\n"))
        seen.append(_read_response(f))
        tail = f.read()  # the server closed its end
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        stream = json.dumps({"model": MODEL, "prompt": "sse", "max_tokens": 2, "stream": True}).encode()
        s.sendall(b"POST /v1/completions HTTP/1.1\r\nContent-Length: " + str(len(stream)).encode() + b"\r\n\r\n"
                  + stream)
        sse = s.makefile("rb").read()  # read to EOF: the stream ends its connection
    return seen, tail, sse


async def test_keep_alive(weights):
    engine = _port_engine(weights[1])
    manager = ModelManager()
    manager.add_model("chat", MODEL, build_local_pipeline(ByteTokenizer(), engine))
    service = HttpService(manager, host="127.0.0.1", port=0)
    await service.start()
    try:
        seen, tail, sse = await asyncio.to_thread(_keep_alive_session, service.port)
        assert [st for st, _, _ in seen] == [200] * 4
        assert [h["connection"] for _, h, _ in seen] == ["keep-alive"] * 3 + ["close"]
        texts = [json.loads(b)["choices"][0]["text"] for _, _, b in seen]
        assert len(set(texts)) == 1 and tail == b""
        assert sse.startswith(b"HTTP/1.1 200") and b"Connection: close" in sse and sse.endswith(b"data: [DONE]\n\n")
        # An idle kept-alive connection does not hold up stop().
        idle = socket.create_connection(("127.0.0.1", service.port), timeout=10)
        await asyncio.to_thread(idle.sendall, b"GET /health HTTP/1.1\r\n\r\n")
        await asyncio.to_thread(_read_response, idle.makefile("rb"))
        await asyncio.wait_for(service.stop(), 10)
        idle.close()
    finally:
        await service.stop()
        await engine.stop()


async def test_tls(weights, tmp_path):
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key), "-out",
                    str(cert), "-days", "1", "-subj", "/CN=localhost"], capture_output=True, check=True)
    engine = _port_engine(weights[1])
    manager = ModelManager()
    manager.add_model("chat", MODEL, build_local_pipeline(ByteTokenizer(), engine))
    service = HttpService(manager, host="127.0.0.1", port=0, tls_cert=str(cert), tls_key=str(key))
    await service.start()
    try:
        ctx = ssl.create_default_context(cafile=str(cert))
        ctx.check_hostname = False

        def call():
            conn = http.client.HTTPSConnection("127.0.0.1", service.port, timeout=60, context=ctx)
            conn.request("GET", "/health")
            first = conn.getresponse()
            first.read()
            health = first.status  # and the next request rides the same TLS connection
            conn.request("POST", "/v1/chat/completions", json.dumps(
                {"model": MODEL, "messages": [{"role": "user", "content": "hi"}], "max_tokens": 3}))
            resp = conn.getresponse()
            data = json.loads(resp.read())
            conn.close()
            return health, resp.status, data

        health, status, data = await asyncio.to_thread(call)
        assert health == 200 and status == 200 and data["choices"][0]["message"]["content"] is not None
        with pytest.raises(ssl.SSLError):
            await asyncio.to_thread(lambda: http.client.HTTPSConnection(
                "127.0.0.1", service.port, timeout=10, context=ssl.create_default_context()).request("GET", "/health"))
    finally:
        await service.stop()
        await engine.stop()


def test_tls_requires_both_paths():
    for kw in ({"tls_cert": "c.pem"}, {"tls_key": "k.pem"}):
        with pytest.raises(ValueError, match="both"):
            HttpService(ModelManager(), **kw)
    args = frontend.build_parser().parse_args(["--tls-cert-path", "c.pem", "--encode-component", "encode",
                                              "--request-timeout-ms", "250"])
    cfg = frontend.frontend_config(args)
    assert (cfg.tls_cert, cfg.tls_key, cfg.encode_component, cfg.request_timeout_ms) == ("c.pem", None, "encode", 250)
    assert FrontendConfig().encode_component is None
    with pytest.raises(ValueError, match="both"):
        HttpService(ModelManager(), tls_cert=cfg.tls_cert, tls_key=cfg.tls_key)


async def test_request_timeout_gives_jax_504(weights):
    async with _Pair(weights, request_timeout_ms=1) as pair:
        body = {"model": MODEL, "messages": [{"role": "user", "content": "never in time"}], "max_tokens": 200}
        (status, got), (jstatus, want) = await pair.both("/v1/chat/completions", body)
        assert status == jstatus == 504
        assert got["error"] == want["error"] == {"message": "request deadline exceeded", "type": "timeout_error",
                                                 "code": 504}
        # The port's usage also carries its prefix-cache count (the JAX engine
        # evicts before it reports one).
        assert set(want["usage"]) <= set(got["usage"]) and got["usage"]["completion_tokens"] < 200
        # A client timeout overrides the default.
        (status, got), _ = await pair.both("/v1/chat/completions", {**body, "max_tokens": 4, "timeout": 60})
        assert status == 200 and got["usage"]["completion_tokens"] == 4
        sched = pair.engine.scheduler
        assert not sched.running and not sched.waiting and sched.allocator.num_active == 0
