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
- Request bodies: with ``Expect: 100-continue`` the interim line comes
  within a curl-like client's 1 s wait (under 0.3 s) and the answer is
  JAX's; an over-limit ``Content-Length`` is a 413 with no interim line. A
  chunked body (sizes in hex, an extension, a trailer) answers what JAX
  answers; over the limit it is a 413, a malformed chunk a 400, and a
  kept-alive connection serves the next request after it.
- ``GET /metrics`` after the same traffic on both: the same families,
  types and label sets, equal counters and equal latency-histogram and
  digest sample counts (ITL and TPOT aside: they follow how tokens batch
  into frames), SLO verdicts included; the trace id is echoed.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import socket
import ssl
import subprocess
import time

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


# ---------------------------------------------------------------------------
# Request bodies: Expect: 100-continue and chunked transfer coding
# ---------------------------------------------------------------------------

CHAT = {"model": MODEL, "messages": [{"role": "user", "content": "continue me"}], "max_tokens": 5, "temperature": 0.0}


def _head(path: str, extra: bytes) -> bytes:
    return b"POST " + path.encode() + b" HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n" + extra + b"\r\n"


def _split_response(raw: bytes):
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {k.strip().lower(): v.strip() for k, _, v in (ln.partition(":") for ln in lines[1:])}
    return int(lines[0].split()[1]), headers, body


def _curl_like(port: int, head: bytes, body: bytes, wait_s: float = 1.0):
    """A client that sends the head, waits up to ``wait_s`` for an interim
    ``100 Continue`` (curl's default for large bodies), then sends the body
    and reads to EOF (the head says ``Connection: close``) → (seconds to the
    interim line or None, status, headers, body)."""
    with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
        s.sendall(head)
        t0 = time.perf_counter()
        s.settimeout(wait_s)
        buf, interim = b"", None
        try:
            while b"\r\n\r\n" not in buf:
                data = s.recv(4096)
                if not data:
                    break
                buf += data
        except socket.timeout:
            pass
        if buf.startswith(b"HTTP/1.1 100"):
            interim = time.perf_counter() - t0
            buf = buf.split(b"\r\n\r\n", 1)[1]
        s.settimeout(120)
        if not buf:  # no final answer yet: the body goes
            s.sendall(body)
        while True:
            data = s.recv(65536)
            if not data:
                break
            buf += data
    return (interim, *_split_response(buf))


def _answer(body: bytes) -> dict:
    data = json.loads(body)
    return {k: v for k, v in data.items() if k not in ("id", "created")}


async def test_expect_100_continue_answers_within_the_wait(weights):
    """The interim line comes at once (the JAX service's aiohttp sends it
    too), and the answer equals the JAX service's; a body over the limit is
    a 413 with no interim line."""
    from dynamo_tpu_torch.llm.http import service as svc

    body = json.dumps(CHAT).encode()
    head = _head("/v1/chat/completions", b"Connection: close\r\nExpect: 100-continue\r\nContent-Length: "
                 + str(len(body)).encode() + b"\r\n")
    async with _Pair(weights) as pair:
        got = await asyncio.to_thread(_curl_like, pair.service.port, head, body)
        want = await asyncio.to_thread(_curl_like, pair.jservice.port, head, body)
        big = _head("/v1/chat/completions", b"Connection: close\r\nExpect: 100-continue\r\nContent-Length: "
                    + str(svc.MAX_BODY_BYTES + 1).encode() + b"\r\n")
        over = await asyncio.to_thread(_curl_like, pair.service.port, big, b"")
    assert got[0] is not None and got[0] < 0.3, got[0]
    assert want[0] is not None
    assert got[1] == want[1] == 200 and _answer(got[3]) == _answer(want[3])
    assert over[0] is None and over[1] == 413


def _chunked(body: bytes, sizes=(7, 1, 30)) -> bytes:
    """``body`` in chunks of ``sizes`` (the rest in the last), one with a
    chunk extension, then the last chunk and a trailer."""
    out, i = b"", 0
    for n, ext in zip(list(sizes) + [len(body)], (b"", b";name=value", b"", b"")):
        part = body[i:i + n]
        if not part:
            break
        out += f"{len(part):x}".encode() + ext + b"\r\n" + part + b"\r\n"
        i += len(part)
    return out + b"0\r\nX-Checksum: none\r\n\r\n"


async def test_chunked_bodies(weights, monkeypatch):
    """A chunked chat request answers what the JAX service answers; a
    chunked body over the limit is a 413; a bad chunk size, or chunk data not
    followed by CRLF, a 400; and a kept-alive connection serves a second
    request after a chunked one."""
    from dynamo_tpu_torch.llm.http import service as svc

    body = json.dumps(CHAT).encode()
    head = _head("/v1/chat/completions", b"Connection: close\r\nTransfer-Encoding: chunked\r\n")
    async with _Pair(weights) as pair:
        got = await asyncio.to_thread(_curl_like, pair.service.port, head, _chunked(body))
        want = await asyncio.to_thread(_curl_like, pair.jservice.port, head, _chunked(body))
        bad = [await asyncio.to_thread(_curl_like, pair.service.port, head, raw)
               for raw in (b"zz\r\n{}\r\n0\r\n\r\n", b"0x2\r\n{}\r\n0\r\n\r\n", b"2\r\n{}XX0\r\n\r\n")]

        def keep_alive(port):
            plain = json.dumps({**CHAT, "max_tokens": 2}).encode()
            with socket.create_connection(("127.0.0.1", port), timeout=120) as s:
                f = s.makefile("rb")
                s.sendall(_head("/v1/chat/completions", b"Transfer-Encoding: chunked\r\n") + _chunked(body))
                first = _read_response(f)
                s.sendall(_head("/v1/chat/completions", b"Content-Length: " + str(len(plain)).encode() + b"\r\n")
                          + plain)
                return first, _read_response(f)

        kept = await asyncio.to_thread(keep_alive, pair.service.port)
        monkeypatch.setattr(svc, "MAX_BODY_BYTES", 16)
        over = await asyncio.to_thread(_curl_like, pair.service.port, head, _chunked(body))
    assert got[1] == want[1] == 200 and _answer(got[3]) == _answer(want[3])
    assert [b[1] for b in bad] == [400, 400, 400] and all(b"chunked" in b[3] for b in bad)
    assert [r[0] for r in kept] == [200, 200] and kept[0][1]["connection"] == "keep-alive"
    assert over[1] == 413


# ---------------------------------------------------------------------------
# /metrics against the JAX service's
# ---------------------------------------------------------------------------


def _get_text(port: int, path: str, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path, headers=headers or {})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type", ""), raw.decode()


def _status(port: int, path: str, body: dict) -> int:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    resp.read()
    conn.close()
    return resp.status


def _traced_post(port: int, body: dict, traceparent: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json", "traceparent": traceparent})
    resp = conn.getresponse()
    resp.read()
    conn.close()
    return resp.status, resp.getheader("x-dynamo-trace-id")


METRIC_TRAFFIC = [
    ("/v1/chat/completions", {**CHAT, "max_tokens": 6}),
    ("/v1/chat/completions", {**CHAT, "max_tokens": 6, "stream": True}),
    ("/v1/completions", {"model": MODEL, "prompt": "count the", "max_tokens": 5, "temperature": 0.0,
                         "stream": True}),
    ("/v1/completions", {"model": MODEL, "prompt": "count the", "max_tokens": 4, "temperature": 0.0}),
    ("/v1/chat/completions", {"model": "nope", "messages": [{"role": "user", "content": "x"}]}),
    ("/v1/chat/completions", {"model": MODEL, "messages": []}),
    ("/v1/responses", {"model": MODEL, "input": "say hi", "max_output_tokens": 4}),
    ("/v1/chat/completions", {**CHAT, "max_tokens": 1}),  # no TPOT to miss: goodput
]


async def test_metrics_families_and_counters_match_jax(weights):
    """After the same requests (unary and streamed chat and completions, a
    404, a 400, a Responses call, a one-token chat) both services' ``/metrics`` hold the same
    families with the same types and label sets; every counter is equal,
    and so is each latency histogram's and digest's sample count (but ITL's,
    which follows how tokens batch into frames). SLO targets (TTFT met,
    TPOT missed on purpose) give the same verdict counters."""
    from dynamo_tpu.runtime import telemetry as jtel
    from dynamo_tpu_torch.llm.http.service import FRONTEND_DIGEST_FAMILIES
    from dynamo_tpu_torch.runtime import telemetry as ptel
    from dynamo_tpu_torch.runtime.metrics import parse_text

    async with _Pair(weights) as pair:
        for service, tel in ((pair.service, ptel), (pair.jservice, jtel)):
            service.slo = tel.SloConfig(ttft_ms=60000.0, tpot_ms=1e-6)
            service._slo_judge = tel.SloJudge(service.slo)
        for path, body in METRIC_TRAFFIC:
            status, jstatus = [await asyncio.to_thread(_status, s.port, path, body)
                               for s in (pair.service, pair.jservice)]
            assert status == jstatus, (path, body)
        tp = f"00-{'ef' * 16}-{'12' * 8}-01"
        echo = [await asyncio.to_thread(_traced_post, s.port, CHAT, tp) for s in (pair.service, pair.jservice)]
        got = await asyncio.to_thread(_get_text, pair.service.port, "/metrics")
        want = await asyncio.to_thread(_get_text, pair.jservice.port, "/metrics")
    assert echo[0] == echo[1] == (200, "ef" * 16)
    assert got[0] == want[0] == 200 and got[1].startswith("text/plain") and want[1].startswith("text/plain")
    g, w = parse_text(got[2]), parse_text(want[2])
    assert {k: v["type"] for k, v in g.items()} == {k: v["type"] for k, v in w.items()}
    for family in ("requests_total", "inflight_requests", "time_to_first_token_seconds",
                   "inter_token_latency_seconds", "request_duration_seconds", "queue_time_seconds",
                   "output_tokens_total", "input_tokens_total", "slo_attained_total", "slo_violated_total",
                   "goodput_requests_total", "goodput_tokens_total", "goodput_requests_per_s",
                   "goodput_tokens_per_s", *FRONTEND_DIGEST_FAMILIES):
        assert "dynamo_frontend_" + family in g, family

    def series(fams, name, suffix=""):
        return {tuple(sorted((k, v) for k, v in lab.items() if k != "le")): val
                for n, lab, val in fams[name]["samples"] if n == name.removesuffix("_total") + suffix}

    for name, fam in w.items():
        labels = lambda fams: sorted({tuple(sorted(lab)) for _, lab, _ in fams[name]["samples"]})  # noqa: E731
        assert labels(g) == labels(w), name
        if fam["type"] == "counter":
            assert series(g, name, "_total") == series(w, name, "_total"), name
        elif fam["type"] == "histogram" and "inter_token" not in name and "tpot" not in name:
            assert series(g, name, "_count") == series(w, name, "_count"), name
    assert series(g, "dynamo_frontend_requests_total", "_total") == {
        (("model", MODEL), ("status", "200")): 7.0, (("model", "nope"), ("status", "404")): 1.0,
        (("model", "unknown"), ("status", "400")): 1.0}
    assert series(g, "dynamo_frontend_inflight_requests") == {(("model", MODEL),): 0.0}
    assert series(g, "dynamo_frontend_slo_violated_total", "_total") == {(("model", MODEL), ("phase", "tpot")): 5.0}
    assert series(g, "dynamo_frontend_goodput_requests_total", "_total") == {(("model", MODEL),): 1.0}
