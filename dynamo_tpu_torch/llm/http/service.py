"""OpenAI-compatible HTTP frontend on the standard library.

Routes ``POST /v1/chat/completions`` and ``POST /v1/completions`` (JSON, or
SSE with ``"stream": true`` ending in ``data: [DONE]``), ``POST
/v1/embeddings`` (models registered as ``embeddings``), ``POST
/v1/responses`` (mapped onto the chat pipeline; unary, or the Responses
API's semantic SSE events), ``GET /v1/models`` and ``GET /health``, with
the same response bodies as the JAX package's aiohttp service. aiohttp is
not assumed to be installed, so this is a small HTTP/1.1 server on
``asyncio.start_server``, over TLS when given a certificate and key (the
standard library's ``ssl``): a connection serves requests until the
client closes it, sends ``Connection: close`` (or speaks HTTP/1.0 without
``keep-alive``) or idles ``KEEPALIVE_TIMEOUT_S``; an SSE stream ends its
connection. A body is sized by ``Content-Length`` or sent chunked
(``Transfer-Encoding: chunked``: hex sizes, extensions ignored, trailers
read and dropped), up to ``MAX_BODY_BYTES`` (413 past it, 400 for a
malformed chunk); a request with ``Expect: 100-continue`` gets its
``100 Continue`` before its body is read. ``request_timeout_ms``
is the default deadline of a chat or completion that sends no
``timeout``: it rides to the scheduler as ``stop_conditions.deadline_ms``,
and an expired request is a 504 with its partial usage. A
``RequestError`` raised inside the pipeline (an image request with no
encode path, an image the reader refuses) is a 400. A request with
``n > 1`` runs its choices as
separate generations (a seeded request's choice i with ``seed + i``), all
sent to the engine at once so they share its batches; a stream
interleaves their chunks by ``index``. Logprobs, tool calls and reasoning
content are rendered as the JAX service renders them. The service serves a
``ModelManager`` (``llm/discovery.py``): a frontend's watcher adds and
removes models as workers come and go; a fixed dict of pipelines (the
in-process ``run``) is served as chat models. A routed model with no live
worker is a retryable 503; a stream whose migration budget ran out is a
502 with the partial token count. A chat or completion opens the
``http_request`` span on the process tracer (continuing a ``traceparent``
header) and its context carries it on to the workers; its responses echo
the trace id (``x-dynamo-trace-id``); with tail tracing, a request that
missed its SLO is promoted. ``GET /metrics`` renders the frontend families
of the JAX service (``dynamo_frontend_*``: requests by status, in-flight,
TTFT, ITL, duration, queue time, tokens, timeouts, migrations,
no-instances, SLO and goodput counters) and its own latency digests
(``FRONTEND_DIGEST_FAMILIES``) from ``metrics``, a ``MetricsRegistry``
that the routers of ``start_frontend`` share. gRPC is not ported yet
(ROADMAP Queue 1 item 19).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import ssl
import time
from typing import AsyncIterator, Dict, Optional, Tuple

from dynamo_tpu_torch.llm.discovery import ModelManager
from dynamo_tpu_torch.llm.protocols import openai as oai
from dynamo_tpu_torch.llm.protocols.common import as_engine_output
from dynamo_tpu_torch.runtime.engine import Annotated, AsyncEngine, Context, StreamDisconnect
from dynamo_tpu_torch.runtime.logging import TraceParent
from dynamo_tpu_torch.runtime.metrics import (
    DURATION_BUCKETS,
    FRONTEND_PREFIX,
    ITL_BUCKETS,
    TTFT_BUCKETS,
    MetricsRegistry,
)
from dynamo_tpu_torch.runtime.push_router import NoInstancesError
from dynamo_tpu_torch.runtime.telemetry import DigestCollector, SloConfig, SloJudge, Telemetry
from dynamo_tpu_torch.runtime.tracing import NULL_SPAN, get_tracer

logger = logging.getLogger(__name__)

# Capacity attribution: the OpenAI ``user`` field, then this header, then a
# hash of the API key — "anon" only when the request carries nothing.
TENANT_HEADER = "x-dynamo-tenant"
# The request's trace id, echoed on its responses (SSE too), so a client's
# report maps to the JSONL trace even when the request was not sampled.
TRACE_ID_HEADER = "x-dynamo-trace-id"

# The frontend's own end-to-end digests (DigestCollector over its
# Telemetry): each stream renders as "<name>_seconds" (a cumulative
# histogram) and "<name>_seconds_quantile" (rolling p50/p90/p99 gauges).
FRONTEND_DIGEST_FAMILIES = (
    "ttft_seconds", "ttft_seconds_quantile",
    "tpot_seconds", "tpot_seconds_quantile",
    "request_seconds", "request_seconds_quantile",
)

MAX_BODY_BYTES = 64 << 20
MAX_HEADER_BYTES = 64 << 10
KEEPALIVE_TIMEOUT_S = 75.0  # an idle kept-alive connection closes after this (aiohttp's default)

_REASONS = {
    100: "Continue", 200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    413: "Payload Too Large", 500: "Internal Server Error",
    502: "Bad Gateway", 503: "Service Unavailable", 504: "Gateway Timeout",
}


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


_NO_WORKERS = "no workers are live for this model; retry shortly"


def _no_workers_body() -> dict:
    return oai.error_body(_NO_WORKERS, "service_unavailable", 503)


def _migration_exhausted_body(ctx: Context, n_tokens: int) -> dict:
    mig = ctx.metadata.get("migration") or {}
    body = oai.error_body("upstream worker stream disconnected and the migration budget is exhausted",
                          "bad_gateway", 502)
    body["error"]["partial_tokens"] = int(mig.get("tokens_emitted", n_tokens))
    body["error"]["migrations"] = int(mig.get("attempts", 0))
    return body


class _Conn:
    """One client connection: its writer, and whether it stays open after
    the response being written (``keep_alive``) or waits for the next
    request (``idle``)."""

    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.keep_alive = False
        self.idle = True

    def write(self, data: bytes) -> None:
        self.writer.write(data)

    async def drain(self) -> None:
        await self.writer.drain()


class HttpService:
    """Serves the pipelines of ``manager`` (AsyncEngines taking OpenAI
    request bodies, by model type and name) on ``host:port``; port 0 binds
    a free port, readable from ``self.port`` after ``start``. ``tls_cert``
    and ``tls_key`` (PEM paths, both or neither) serve HTTPS;
    ``request_timeout_ms`` is the default deadline of a chat or completion
    request that sends no ``timeout``; ``metrics`` the registry ``/metrics``
    renders (a fresh ``dynamo_frontend_`` one by default); ``slo`` the
    targets each finished request is judged against."""

    def __init__(self, manager: ModelManager, *, host: str = "0.0.0.0", port: int = 8000,
                 metrics: Optional[MetricsRegistry] = None, tls_cert: Optional[str] = None,
                 tls_key: Optional[str] = None, slo: Optional[SloConfig] = None,
                 request_timeout_ms: Optional[float] = None):
        self.manager = manager
        self.host = host
        self.port = port
        self.request_timeout_ms = request_timeout_ms
        if bool(tls_cert) != bool(tls_key):
            raise ValueError("TLS needs both tls_cert and tls_key")
        self._ssl = None
        if tls_cert:
            self._ssl = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            self._ssl.load_cert_chain(tls_cert, tls_key)
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self._closing = False
        self.metrics = metrics or MetricsRegistry(prefix=FRONTEND_PREFIX)
        m = self.metrics
        self._m_requests = lambda model, status: m.counter("requests_total", "HTTP requests", model=model,
                                                           status=status)
        self._m_inflight = lambda model: m.gauge("inflight_requests", "in-flight requests", model=model)
        self._m_ttft = lambda model: m.histogram("time_to_first_token_seconds", "TTFT", buckets=TTFT_BUCKETS,
                                                 model=model)
        self._m_itl = lambda model: m.histogram("inter_token_latency_seconds", "ITL", buckets=ITL_BUCKETS,
                                                model=model)
        self._m_duration = lambda model: m.histogram("request_duration_seconds", "request duration",
                                                     buckets=DURATION_BUCKETS, model=model)
        # Engine-admission queue time: the saturation signal.
        self._m_queue = lambda model: m.histogram("queue_time_seconds", "request queue time before engine admission",
                                                  buckets=TTFT_BUCKETS, model=model)
        self._m_output_tokens = lambda model: m.counter("output_tokens_total", "output tokens", model=model)
        # Failure lifecycle: deadline expiries (504s and timeout finishes),
        # exhausted migrations (502s) and no-instance rejections (503s).
        self._m_timeouts = lambda model: m.counter("request_timeouts_total", "requests that exceeded their deadline",
                                                   model=model)
        self._m_migrations = lambda model: m.counter("migrations_total", "stream drops replayed on another worker",
                                                     model=model)
        self._m_migration_exhausted = lambda model: m.counter(
            "migration_exhausted_total", "requests whose migration budget ran out (502)", model=model)
        self._m_no_instances = lambda model: m.counter(
            "no_instances_total", "requests rejected because no workers were live (503)", model=model)
        self._m_input_tokens = lambda model: m.counter("input_tokens_total", "input (prompt) tokens", model=model)
        self._m_cached_tokens = lambda model: m.counter(
            "input_cached_tokens_total", "prompt tokens served from the prefix cache", model=model)
        # The frontend's own e2e digests (ttft, tpot, request) and its SLO
        # verdicts against --slo-ttft-ms / --slo-tpot-ms: goodput is the
        # SLO-attained requests and tokens.
        self.slo = slo or SloConfig()
        self.telemetry = Telemetry()
        self._slo_judge = SloJudge(self.slo)
        self._digest_collector = DigestCollector(FRONTEND_PREFIX, registry=m.registry, telemetry=self.telemetry)
        self._m_slo = lambda model, phase, verdict: m.counter(
            "slo_attained_total" if verdict == "attained" else "slo_violated_total",
            "request phases meeting/missing the SLO target", model=model, phase=phase)
        self._m_goodput_requests = lambda model: m.counter(
            "goodput_requests_total", "requests that attained every configured SLO", model=model)
        self._m_goodput_tokens = lambda model: m.counter(
            "goodput_tokens_total", "output tokens of SLO-attained requests", model=model)
        self._m_goodput_req_s = m.gauge("goodput_requests_per_s", "SLO-attained requests/s over the rolling window")
        self._m_goodput_tok_s = m.gauge("goodput_tokens_per_s",
                                        "SLO-attained output tokens/s over the rolling window")

    def note_migration(self, model: str) -> None:
        """One stream drop of ``model`` replayed on another worker: the
        routed pipeline's migration hook (``migrations_total``)."""
        self._m_migrations(model).inc()

    def _record_request_telemetry(self, model: str, start: float, first_at: Optional[float],
                                  last_at: Optional[float], n_tokens: int, ctx: Optional[Context] = None) -> None:
        """A finished request's e2e telemetry: digests, the SLO verdict and
        goodput. A request that produced no token is a failure, not a
        latency violation, and is not judged."""
        if first_at is None:
            return
        now = time.monotonic()
        ttft_s = max(0.0, first_at - start)
        self.telemetry.observe("ttft", ttft_s)
        self.telemetry.observe("request", max(0.0, now - start))
        tpot_s = None
        if n_tokens > 1 and last_at is not None and last_at > first_at:
            tpot_s = (last_at - first_at) / (n_tokens - 1)
            self.telemetry.observe("tpot", tpot_s)
        if not self.slo.enabled:
            return
        good = self._slo_judge.judge(ttft_s, tpot_s, n_tokens)
        if not good and ctx is not None and get_tracer().tail:
            # Tail keep: the violating request's span set is promoted from
            # the ring once its root span has ended (in _serve's finally).
            ctx.metadata["_slo_promote"] = True
        if self.slo.ttft_ms is not None:
            self._m_slo(model, "ttft", "attained" if ttft_s * 1000.0 <= self.slo.ttft_ms else "violated").inc()
        if self.slo.tpot_ms is not None and tpot_s is not None:
            self._m_slo(model, "tpot", "attained" if tpot_s * 1000.0 <= self.slo.tpot_ms else "violated").inc()
        if good:
            self._m_goodput_requests(model).inc()
            self._m_goodput_tokens(model).inc(n_tokens)
        req_s, tok_s = self._slo_judge.goodput_rates()
        self._m_goodput_req_s.set(req_s)
        self._m_goodput_tok_s.set(tok_s)

    def _count_annotation(self, model: str, item: Annotated) -> None:
        """A pipeline annotation's metric: prompt tokens, queue time or
        prefix-cache reuse."""
        if item.event == "_metrics":
            self._m_input_tokens(model).inc(int(item.comment or 0))
        elif item.event == "_queue":
            self._m_queue(model).observe(float(item.comment or 0))
        elif item.event == "_cached":
            self._m_cached_tokens(model).inc(int(item.comment or 0))

    async def start(self) -> None:
        self._closing = False
        self._server = await asyncio.start_server(self._handle, self.host, self.port, ssl=self._ssl)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("OpenAI HTTP%s frontend on %s:%d", "S" if self._ssl else "", self.host, self.port)

    async def stop(self) -> None:
        """Stop listening, close the idle kept-alive connections and wait
        for the responses still being written."""
        if self._server is not None:
            self._closing = True
            self._server.close()
            for conn in list(self._conns):
                if conn.idle:
                    conn.writer.close()
            await self._server.wait_closed()
            self._server = None

    # --- connection ---------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        conn = _Conn(writer)
        self._conns.add(conn)
        try:
            while not self._closing:
                try:
                    method, path, version, headers, body = await asyncio.wait_for(_read_request(reader, writer),
                                                                                  KEEPALIVE_TIMEOUT_S)
                except HttpError as e:
                    conn.keep_alive = False
                    await _respond_json(conn, e.status, oai.error_body(str(e), code=e.status))
                    return
                except (asyncio.IncompleteReadError, ConnectionError, asyncio.TimeoutError):
                    return
                conn.idle = False
                conn.keep_alive = _keeps_alive(version, headers)
                await self._route(method, path, headers, body, conn)
                conn.idle = True
                if not conn.keep_alive:
                    return
        except ConnectionError:
            pass  # the client went away; a stream has already cancelled its request
        except Exception:
            logger.exception("HTTP handler failed")
        finally:
            self._conns.discard(conn)
            writer.close()

    async def _route(self, method: str, path: str, headers: Dict[str, str], body: bytes, writer) -> None:
        path = path.split("?", 1)[0]
        routes = {
            "/v1/chat/completions": ("POST", "chat"),
            "/v1/completions": ("POST", "completions"),
            "/v1/embeddings": ("POST", "embeddings"),
            "/v1/responses": ("POST", "responses"),
            "/v1/models": ("GET", "models"),
            "/health": ("GET", "health"),
            "/metrics": ("GET", "metrics"),
        }
        if path not in routes:
            await _respond_json(writer, 404, oai.error_body(f"no route {path}", "not_found", 404))
            return
        want, kind = routes[path]
        if method != want:
            await _respond_json(writer, 405, oai.error_body(f"{path} takes {want}", "method_not_allowed", 405))
            return
        if kind == "health":
            await _respond_json(writer, 200, {"status": "healthy", "models": self.manager.list_models()})
        elif kind == "metrics":
            await _respond(writer, 200, self.metrics.render(), "text/plain; charset=utf-8")
        elif kind == "models":
            now = int(time.time())
            data = [{"id": n, "object": "model", "created": now, "owned_by": "dynamo-tpu"}
                    for n in self.manager.list_models()]
            await _respond_json(writer, 200, {"object": "list", "data": data})
        elif kind == "embeddings":
            await self._serve_embeddings(body, writer)
        elif kind == "responses":
            await self._serve_responses(headers, body, writer)
        else:
            await self._serve(kind, headers, body, writer)

    # --- embeddings ---------------------------------------------------------
    async def _serve_embeddings(self, raw: bytes, writer) -> None:
        """``/v1/embeddings``: routed to the model registered as
        ``embeddings`` under the body's name."""
        try:
            body = oai.validate_embedding_request(json.loads(raw))
        except (json.JSONDecodeError, UnicodeDecodeError, oai.RequestError) as e:
            await _respond_json(writer, 400, oai.error_body(str(e)))
            return
        model = body["model"]
        engine = self.manager.get("embeddings", model)
        if engine is None:
            self._m_requests(model, "404").inc()
            await _respond_json(writer, 404, oai.error_body(f"no embeddings model {model!r}", "model_not_found", 404))
            return
        vectors, prompt_tokens = [], 0
        start = time.monotonic()
        self._m_inflight(model).inc()
        try:
            async for item in engine.generate(body, Context()):
                if isinstance(item, Annotated) and item.is_annotation():
                    continue
                wire = item.data if isinstance(item, Annotated) else item
                if isinstance(wire, dict) and "embeddings" in wire:
                    vectors = wire["embeddings"]
                    prompt_tokens = int(wire.get("prompt_tokens") or 0)
            self._m_input_tokens(model).inc(prompt_tokens)
        except Exception as e:
            logger.exception("embeddings request for %s failed", model)
            status, err = (400, oai.error_body(str(e))) if isinstance(e, oai.RequestError) else (
                500, oai.error_body(str(e), "internal_error", 500))
            self._m_requests(model, str(status)).inc()
            await _respond_json(writer, status, err)
            return
        finally:
            self._m_inflight(model).dec()
            self._m_duration(model).observe(time.monotonic() - start)
        self._m_requests(model, "200").inc()
        usage = oai.usage_dict(prompt_tokens=prompt_tokens, completion_tokens=0)
        await _respond_json(writer, 200, oai.embedding_response(oai.make_id("embd"), model, vectors, usage))

    # --- responses ----------------------------------------------------------
    async def _serve_responses(self, headers: Dict[str, str], raw: bytes, writer) -> None:
        """``/v1/responses``: its input items become chat messages (its
        tools, tool choice and text format the chat fields), served by the
        model's chat pipeline; unary, or streamed as the Responses API's
        events."""
        try:
            body = oai.validate_responses_request(json.loads(raw))
        except (json.JSONDecodeError, UnicodeDecodeError, oai.RequestError) as e:
            await _respond_json(writer, 400, oai.error_body(str(e)))
            return
        model = body["model"]
        engine = self.manager.get("chat", model)
        if engine is None:
            self._m_requests(model, "404").inc()
            await _respond_json(writer, 404, oai.error_body(f"model {model!r} not found", "model_not_found", 404))
            return
        rid = oai.make_id("resp")
        try:
            chat_body = {"model": model, "messages": oai.responses_input_to_messages(body), "stream": False}
            for key in ("temperature", "top_p", "max_output_tokens"):
                if body.get(key) is not None:
                    chat_body["max_tokens" if key == "max_output_tokens" else key] = body[key]
            if body.get("tools"):
                chat_body["tools"] = oai.responses_tools_to_chat(body["tools"])
            if body.get("tool_choice") is not None:
                chat_body["tool_choice"] = oai.responses_tool_choice_to_chat(body["tool_choice"])
            rf = oai.responses_text_format_to_response_format(body)
            if rf is not None:
                chat_body["response_format"] = rf
            # The chat side's checks (response_format, tools, tool_choice),
            # so a Responses client gets the same 400s.
            oai.validate_chat_request(chat_body)
        except oai.RequestError as e:
            self._m_requests(model, "400").inc()
            await _respond_json(writer, 400, oai.error_body(str(e)))
            return
        ctx = Context(traceparent=TraceParent.from_headers(headers))
        if body.get("stream"):
            await self._responses_stream(engine, chat_body, ctx, rid, model, writer)
            return
        text_parts, n_tokens, prompt_tokens, cached_tokens, tool_calls = [], 0, 0, None, None
        start = time.monotonic()
        self._m_inflight(model).inc()
        try:
            async for item in engine.generate(chat_body, ctx):
                if isinstance(item, Annotated) and item.is_annotation():
                    self._count_annotation(model, item)
                    if item.event == "_metrics":
                        prompt_tokens = int(item.comment or 0)
                    elif item.event == "_cached":
                        cached_tokens = int(item.comment or 0)
                    continue
                out = as_engine_output(item)
                if out is None:
                    continue
                if out.text:
                    text_parts.append(out.text)
                if out.tool_calls:
                    tool_calls = out.tool_calls
                n_tokens += len(out.token_ids)
            self._m_output_tokens(model).inc(n_tokens)
        except oai.RequestError as e:
            self._m_requests(model, "400").inc()
            await _respond_json(writer, 400, oai.error_body(str(e)))
            return
        except NoInstancesError:
            self._m_requests(model, "503").inc()
            await _respond_json(writer, 503, _no_workers_body(), {"Retry-After": "1"})
            return
        except Exception as e:
            logger.exception("responses request %s failed", ctx.id)
            self._m_requests(model, "500").inc()
            await _respond_json(writer, 500, oai.error_body(str(e), "internal_error", 500))
            return
        finally:
            self._m_inflight(model).dec()
            self._m_duration(model).observe(time.monotonic() - start)
        self._m_requests(model, "200").inc()
        usage = oai.usage_dict(prompt_tokens=prompt_tokens, completion_tokens=n_tokens, cached_tokens=cached_tokens)
        await _respond_json(writer, 200, oai.responses_response(rid, model, "".join(text_parts), usage,
                                                                 tool_calls=tool_calls))

    async def _responses_stream(self, engine, chat_body: dict, ctx: Context, rid: str, model: str, writer) -> None:
        """The Responses API's semantic SSE stream, as the JAX service sends
        it: response.created → response.in_progress → (output_item.added →
        content_part.added, at the first text) → output_text.delta* →
        output_text.done → content_part.done → output_item.done → (each
        function call's items) → response.completed; a failure is an
        ``error`` event."""
        _start_sse(writer)
        seq = [0]

        async def emit(etype: str, payload: dict) -> None:
            payload = {"type": etype, "sequence_number": seq[0], **payload}
            seq[0] += 1
            await _sse_event_raw(writer, etype, payload)

        msg_id = f"msg-{rid}"
        started = [False]

        async def ensure_message_started() -> None:
            # The message item opens at the first text: a tool-call-only
            # answer has no empty message item, as in the unary shape.
            if started[0]:
                return
            started[0] = True
            await emit("response.output_item.added",
                       {"output_index": 0, "item": {"type": "message", "id": msg_id, "role": "assistant",
                                                    "status": "in_progress", "content": []}})
            await emit("response.content_part.added",
                       {"item_id": msg_id, "output_index": 0, "content_index": 0,
                        "part": {"type": "output_text", "text": "", "annotations": []}})

        text_parts, n_tokens, prompt_tokens, cached_tokens, tool_calls = [], 0, 0, None, None
        start, status = time.monotonic(), "200"
        self._m_inflight(model).inc()
        try:
            envelope = oai.responses_envelope(rid, model, [], status="in_progress")
            await emit("response.created", {"response": envelope})
            await emit("response.in_progress", {"response": envelope})
            async for item in engine.generate(chat_body, ctx):
                if isinstance(item, Annotated) and item.is_annotation():
                    self._count_annotation(model, item)
                    if item.event == "_metrics":
                        prompt_tokens = int(item.comment or 0)
                    elif item.event == "_cached":
                        cached_tokens = int(item.comment or 0)
                    continue
                out = as_engine_output(item)
                if out is None:
                    continue
                n_tokens += len(out.token_ids)
                if out.text:
                    await ensure_message_started()
                    text_parts.append(out.text)
                    await emit("response.output_text.delta",
                               {"item_id": msg_id, "output_index": 0, "content_index": 0, "delta": out.text})
                if out.tool_calls:
                    tool_calls = out.tool_calls
            text = "".join(text_parts)
            output = []
            if started[0] or not tool_calls:
                await ensure_message_started()
                await emit("response.output_text.done",
                           {"item_id": msg_id, "output_index": 0, "content_index": 0, "text": text})
                await emit("response.content_part.done",
                           {"item_id": msg_id, "output_index": 0, "content_index": 0,
                            "part": {"type": "output_text", "text": text, "annotations": []}})
                output.append(oai.responses_message_item(rid, text))
                await emit("response.output_item.done", {"output_index": 0, "item": output[0]})
            for i, call in enumerate(tool_calls or []):
                idx = len(output)
                fc = oai.responses_function_call_item(rid, i, call)
                output.append(fc)
                await emit("response.output_item.added",
                           {"output_index": idx, "item": {**fc, "arguments": "", "status": "in_progress"}})
                await emit("response.function_call_arguments.delta",
                           {"item_id": fc["id"], "output_index": idx, "delta": fc["arguments"]})
                await emit("response.function_call_arguments.done",
                           {"item_id": fc["id"], "output_index": idx, "arguments": fc["arguments"]})
                await emit("response.output_item.done", {"output_index": idx, "item": fc})
            usage = oai.usage_dict(prompt_tokens=prompt_tokens, completion_tokens=n_tokens,
                                   cached_tokens=cached_tokens)
            await emit("response.completed", {"response": oai.responses_envelope(rid, model, output, usage)})
        except (ConnectionError, asyncio.CancelledError):
            ctx.stop_generating()
            status = "499"
            raise
        except Exception as e:
            logger.exception("responses stream %s failed", ctx.id)
            status = "500"
            await emit("error", {"message": str(e)})
        finally:
            self._m_inflight(model).dec()
            self._m_duration(model).observe(time.monotonic() - start)
            self._m_requests(model, status).inc()
            self._m_output_tokens(model).inc(n_tokens)

    # --- completions --------------------------------------------------------
    async def _serve(self, kind: str, headers: Dict[str, str], raw: bytes, writer) -> None:
        model = "unknown"
        try:
            body = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            await _respond_json(writer, 400, oai.error_body("invalid JSON body"))
            return
        try:
            body = oai.validate_chat_request(body) if kind == "chat" else oai.validate_completion_request(body)
            model = body["model"]
            body["_tenant"] = _resolve_tenant(body, headers)
        except oai.RequestError as e:
            self._m_requests(model, "400").inc()
            await _respond_json(writer, 400, oai.error_body(str(e)))
            return
        if body.get("timeout") is None and self.request_timeout_ms:
            # The frontend's default deadline, carried as the client's would
            # be (the preprocessor puts it on the wire).
            body["timeout"] = self.request_timeout_ms / 1000.0
        engine = self.manager.get(kind, model) or self.manager.get("chat" if kind == "completions" else "completions",
                                                                    model)
        if engine is None:
            self._m_requests(model, "404").inc()
            await _respond_json(writer, 404, oai.error_body(f"model {model!r} not found", "model_not_found", 404))
            return
        # Pre-flight availability (a routed pipeline counts its router's
        # live instances): with no worker, an immediate retryable 503.
        probe = getattr(engine, "availability_probe", None)
        if probe is not None and probe() == 0:
            await asyncio.sleep(0.05)  # one watch delivery: absorb races
            if probe() == 0:
                self._m_no_instances(model).inc()
                self._m_requests(model, "503").inc()
                await _respond_json(writer, 503, _no_workers_body(), {"Retry-After": "1"})
                return
        rid = oai.make_id("chatcmpl" if kind == "chat" else "cmpl")
        stream = bool(body.get("stream"))
        ctx = Context(traceparent=TraceParent.from_headers(headers))
        # The request's root (or continuation) span: when it records, the
        # context is re-rooted under it, so every downstream hop parents
        # here and reaches the same sampling decision.
        span = get_tracer().span_from("http_request", ctx.traceparent, service="frontend", model=model, kind=kind,
                                      stream=stream, tenant=body["_tenant"])
        if span is not NULL_SPAN:
            ctx.traceparent = span.child_traceparent()
        start = time.monotonic()
        self._m_inflight(model).inc()
        try:
            if stream:
                await self._serve_stream(engine, body, ctx, rid, kind, model, writer, start)
            else:
                await self._serve_unary(engine, body, ctx, rid, kind, model, writer, start)
        finally:
            self._m_inflight(model).dec()
            self._m_duration(model).observe(time.monotonic() - start)
            span.end()
            if ctx.metadata.pop("_slo_promote", False):
                promoted = get_tracer().promote(ctx.traceparent.trace_id)
                if promoted:
                    logger.info("slo violation: promoted %d buffered trace records for %s", promoted,
                                ctx.traceparent.trace_id)

    @staticmethod
    def _choice_bodies(body: dict) -> list:
        """Per-choice request bodies for n > 1: each choice is a generation
        of its own; a seeded request's choice i gets ``seed + i``, so the
        choices differ as OpenAI's do."""
        n = int(body.get("n") or 1)
        if n == 1:
            return [body]
        out = []
        for i in range(n):
            b = dict(body)
            b["n"] = 1
            if body.get("seed") is not None:
                b["seed"] = int(body["seed"]) + i
            out.append(b)
        return out

    async def _serve_unary(self, engine, body, ctx, rid, kind, model, writer, start: float) -> None:
        bodies = self._choice_bodies(body)
        prompt_tokens = [0]
        cached_tokens = [None]
        emitted = [0] * len(bodies)  # tokens each choice streamed so far
        first_at, last_at = [None], [None]
        trace = _trace_headers(ctx)

        async def run_choice(i: int, b: dict, c: Context) -> dict:
            text_parts, reasoning_parts = [], []
            tool_calls = None
            n_tokens = 0
            finish_reason = "stop"
            logprobs: list = []
            top_logprobs: list = []
            async for item in engine.generate(b, c):
                if isinstance(item, Annotated) and item.is_annotation():
                    if i == 0:
                        self._count_annotation(model, item)
                    if item.event == "_metrics" and i == 0:
                        prompt_tokens[0] = int(item.comment or 0)
                    elif item.event == "_cached" and i == 0:
                        cached_tokens[0] = int(item.comment or 0)
                    continue
                out = as_engine_output(item)
                if out is None:
                    continue
                if out.token_ids:
                    last_at[0] = time.monotonic()
                if out.text:
                    if first_at[0] is None:
                        first_at[0] = time.monotonic()
                        self._m_ttft(model).observe(first_at[0] - start)
                    text_parts.append(out.text)
                if out.reasoning:
                    reasoning_parts.append(out.reasoning)
                if out.tool_calls:
                    tool_calls = out.tool_calls
                if out.logprobs:
                    logprobs.extend(out.logprobs)
                    # Alternatives stay index-aligned with the chosen tokens.
                    top_logprobs.extend((out.top_logprobs or [])[: len(out.logprobs)])
                    while len(top_logprobs) < len(logprobs):
                        top_logprobs.append(None)
                n_tokens += len(out.token_ids)
                emitted[i] = n_tokens
                if out.finish_reason:
                    finish_reason = out.finish_reason
            return {"index": i, "text": "".join(text_parts), "reasoning": "".join(reasoning_parts) or None,
                    "tool_calls": tool_calls, "finish_reason": finish_reason, "n_tokens": n_tokens,
                    "logprobs": logprobs, "top_logprobs": top_logprobs if any(top_logprobs) else None}

        # Each choice has a context (and so a request id) of its own: the
        # engine keys its sequences by the id.
        ctxs = [ctx] + [ctx.child(id=f"{ctx.id}-c{i}") for i in range(1, len(bodies))]
        tasks = [asyncio.create_task(run_choice(i, b, c)) for i, (b, c) in enumerate(zip(bodies, ctxs))]
        try:
            results = await asyncio.gather(*tasks)
        except Exception as e:
            # Stop and reap the sibling choices.
            ctx.stop_generating()
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            if isinstance(e, oai.RequestError):
                self._m_requests(model, "400").inc()
                await _respond_json(writer, 400, oai.error_body(str(e)), trace)
                return
            if isinstance(e, NoInstancesError):
                self._m_no_instances(model).inc()
                self._m_requests(model, "503").inc()
                await _respond_json(writer, 503, _no_workers_body(), {"Retry-After": "1", **trace})
                return
            if isinstance(e, StreamDisconnect):
                self._m_migration_exhausted(model).inc()
                self._m_requests(model, "502").inc()
                err = _migration_exhausted_body(ctx, sum(emitted))
                err["usage"] = oai.usage_dict(prompt_tokens[0], sum(emitted))
                await _respond_json(writer, 502, err, trace)
                return
            logger.exception("request %s failed", ctx.id)
            self._m_requests(model, "500").inc()
            await _respond_json(writer, 500, oai.error_body(str(e), "internal_error", 500), trace)
            return
        total_tokens = sum(r["n_tokens"] for r in results)
        usage = oai.usage_dict(prompt_tokens[0], total_tokens, cached_tokens[0], tenant=body.get("_tenant"))
        if any(r["finish_reason"] == "timeout" for r in results):
            self._m_timeouts(model).inc()
            self._m_requests(model, "504").inc()
            err = oai.error_body("request deadline exceeded", "timeout_error", 504)
            err["usage"] = usage
            await _respond_json(writer, 504, err, trace)
            return
        self._m_requests(model, "200").inc()
        self._m_output_tokens(model).inc(total_tokens)
        self._record_request_telemetry(model, start, first_at[0], last_at[0], results[0]["n_tokens"], ctx=ctx)
        if kind == "chat":
            choices = [
                oai.chat_choice(r["index"], r["text"], r["finish_reason"], r["tool_calls"], r["reasoning"],
                                logprobs=oai.chat_logprobs_content(None, r["logprobs"], r["top_logprobs"])
                                if r["logprobs"] else None)
                for r in results
            ]
            resp = oai.chat_response_multi(rid, model, choices, usage)
        else:
            choices = [
                oai.completion_choice(r["index"], r["text"], r["finish_reason"],
                                      logprobs=oai.completion_logprobs_block(
                                          [""] * len(r["logprobs"]), r["logprobs"], r["top_logprobs"])
                                      if r["logprobs"] else None)
                for r in results
            ]
            resp = oai.completion_response_multi(rid, model, choices, usage)
        await _respond_json(writer, 200, resp, trace)

    async def _serve_stream(self, engine, body, ctx, rid, kind, model, writer, start: float) -> None:
        if int(body.get("n") or 1) > 1:
            await self._serve_stream_multi(engine, body, ctx, rid, kind, model, writer)
            return
        trace = _trace_headers(ctx)
        # The pipeline's request stages (the preprocessor's grammar build
        # among them) run before its first item: a rejection there is still
        # a 400, sent before the stream's 200.
        stream = engine.generate(body, ctx).__aiter__()
        try:
            first = [await stream.__anext__()]
        except StopAsyncIteration:
            first = []
        except oai.RequestError as e:
            self._m_requests(model, "400").inc()
            await _respond_json(writer, 400, oai.error_body(str(e)), trace)
            return
        except NoInstancesError:
            self._m_no_instances(model).inc()
            self._m_requests(model, "503").inc()
            await _respond_json(writer, 503, _no_workers_body(), {"Retry-After": "1", **trace})
            return
        except Exception as e:
            logger.exception("stream %s failed", ctx.id)
            self._m_requests(model, "500").inc()
            await _respond_json(writer, 500, oai.error_body(str(e), "internal_error", 500), trace)
            return
        _start_sse(writer, trace)
        n_tokens = 0
        prompt_tokens = 0
        cached_tokens = None
        first_at = prev_tok_at = None
        status = "200"
        try:
            if kind == "chat":
                await _sse(writer, oai.chat_chunk(rid, model, {"role": "assistant", "content": ""}))
            async for item in _chain(first, stream):
                if isinstance(item, Annotated) and item.is_annotation():
                    if item.event.startswith("_"):
                        self._count_annotation(model, item)
                        if item.event == "_metrics":
                            prompt_tokens = int(item.comment or 0)
                        elif item.event == "_cached":
                            cached_tokens = int(item.comment or 0)
                        continue
                    await _sse_event(writer, item.event, item.comment)
                    continue
                out = as_engine_output(item)
                if out is None:
                    continue
                if out.text or out.token_ids:
                    now = time.monotonic()
                    if first_at is None:
                        self._m_ttft(model).observe(now - start)
                        first_at = now
                    elif prev_tok_at is not None:
                        self._m_itl(model).observe(now - prev_tok_at)
                    prev_tok_at = now
                n_tokens += len(out.token_ids)
                await _sse_deltas(writer, rid, model, kind, out, 0)
                if out.finish_reason:
                    if out.finish_reason == "timeout":
                        # An engine-side deadline eviction: the 504 lives in
                        # the finish reason and the status counter.
                        status = "504"
                        self._m_timeouts(model).inc()
                    # The final chunk carries the usage block.
                    usage = oai.usage_dict(prompt_tokens, n_tokens, cached_tokens, tenant=body.get("_tenant"))
                    if kind == "chat":
                        chunk = oai.chat_chunk(rid, model, {}, finish_reason=out.finish_reason, usage=usage)
                    else:
                        chunk = oai.completion_chunk(rid, model, "", finish_reason=out.finish_reason)
                        chunk["usage"] = usage
                    await _sse(writer, chunk)
        except (ConnectionError, asyncio.CancelledError):
            # Client went away: cancel into the pipeline.
            ctx.stop_generating()
            status = "499"
            raise
        except NoInstancesError:
            status = "503"
            self._m_no_instances(model).inc()
            await _sse(writer, _no_workers_body())
        except StreamDisconnect:
            status = "502"
            self._m_migration_exhausted(model).inc()
            await _sse(writer, _migration_exhausted_body(ctx, n_tokens))
        except Exception as e:
            logger.exception("stream %s failed", ctx.id)
            status = "500"
            await _sse(writer, oai.error_body(str(e), "internal_error", 500))
        finally:
            self._m_requests(model, status).inc()
            self._m_output_tokens(model).inc(n_tokens)
            if status == "200":
                self._record_request_telemetry(model, start, first_at, prev_tok_at, n_tokens, ctx=ctx)
        writer.write(b"data: [DONE]\n\n")
        await writer.drain()

    async def _serve_stream_multi(self, engine, body, ctx, rid, kind, model, writer) -> None:
        """n > 1 streamed: one generation per choice, their chunks on one SSE
        stream with their choice's index, each choice with its own finish.
        A rejection in the pipeline's request stages (before any choice's
        first item) is still a 400."""
        bodies = self._choice_bodies(body)
        ctxs = [ctx] + [ctx.child(id=f"{ctx.id}-c{i}") for i in range(1, len(bodies))]
        queue: "asyncio.Queue" = asyncio.Queue()
        n_tokens, status = 0, "200"

        async def pump(i: int, b: dict, c: Context):
            try:
                async for item in engine.generate(b, c):
                    if isinstance(item, Annotated) and item.is_annotation():
                        if i == 0:
                            self._count_annotation(model, item)
                        continue
                    out = as_engine_output(item)
                    if out is not None:
                        await queue.put((i, out, None))
            except Exception as e:  # surfaced on the stream
                await queue.put((i, None, e))
            finally:
                await queue.put((i, None, None))  # the choice is done

        tasks = [asyncio.create_task(pump(i, b, c)) for i, (b, c) in enumerate(zip(bodies, ctxs))]
        live = len(tasks)
        head = await queue.get()
        try:
            if isinstance(head[2], oai.RequestError):
                status = "400"
                await _respond_json(writer, 400, oai.error_body(str(head[2])), _trace_headers(ctx))
                return
            _start_sse(writer, _trace_headers(ctx))
            if kind == "chat":
                for i in range(len(bodies)):
                    await _sse(writer, oai.chat_chunk(rid, model, {"role": "assistant", "content": ""}, index=i))
            item = head
            while True:
                i, out, err = item
                if err is not None:
                    raise err
                if out is None:
                    live -= 1
                else:
                    n_tokens += len(out.token_ids)
                    await _sse_deltas(writer, rid, model, kind, out, i)
                    if out.finish_reason:
                        chunk = (oai.chat_chunk(rid, model, {}, finish_reason=out.finish_reason, index=i)
                                 if kind == "chat"
                                 else oai.completion_chunk(rid, model, "", finish_reason=out.finish_reason, index=i))
                        await _sse(writer, chunk)
                if not live:
                    break
                item = await queue.get()
        except (ConnectionError, asyncio.CancelledError):
            status = "499"
            raise
        except Exception as e:
            logger.exception("stream %s failed", ctx.id)
            status = "500"
            await _sse(writer, oai.error_body(str(e), "internal_error", 500))
        finally:
            ctx.stop_generating()  # and its children: stop what still runs
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            self._m_requests(model, status).inc()
            self._m_output_tokens(model).inc(n_tokens)
        writer.write(b"data: [DONE]\n\n")
        await writer.drain()


def _start_sse(conn: _Conn, headers: Optional[Dict[str, str]] = None) -> None:
    """An SSE response's head; the stream ends its connection."""
    conn.keep_alive = False
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    conn.write(f"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\nCache-Control: no-cache\r\n{extra}"
               "Connection: close\r\n\r\n".encode())


def _keeps_alive(version: str, headers: Dict[str, str]) -> bool:
    """HTTP/1.1 keeps a connection open unless the client says ``close``;
    HTTP/1.0 only when it asks for ``keep-alive``."""
    tokens = {t.strip().lower() for t in headers.get("connection", "").split(",")}
    if version == "HTTP/1.0":
        return "keep-alive" in tokens
    return "close" not in tokens


async def _sse_deltas(writer, rid: str, model: str, kind: str, out, index: int) -> None:
    """The content chunks of one engine frame of choice ``index``: its
    reasoning delta (chat), its text with its tokens' logprobs (tokens whose
    text is held back still send their logprobs, on an empty delta), and
    its tool calls (chat)."""
    if out.reasoning and kind == "chat":
        await _sse(writer, oai.chat_chunk(rid, model, {"reasoning_content": out.reasoning}, index=index))
    if out.text or out.logprobs:
        text = out.text or ""
        lp = None
        if out.logprobs:
            lp = (oai.chat_logprobs_content(text, out.logprobs, out.top_logprobs) if kind == "chat"
                  else oai.completion_logprobs_block([text], out.logprobs, out.top_logprobs))
        if kind == "chat":
            await _sse(writer, oai.chat_chunk(rid, model, {"content": text}, index=index, logprobs=lp))
        else:
            await _sse(writer, oai.completion_chunk(rid, model, text, index=index, logprobs=lp))
    if out.tool_calls and kind == "chat":
        delta_calls = [{**tc, "index": j, "function": tc["function"]} for j, tc in enumerate(out.tool_calls)]
        await _sse(writer, oai.chat_chunk(rid, model, {"tool_calls": delta_calls}, index=index))


async def _chain(head: list, rest: AsyncIterator):
    """The items of ``head``, then those of ``rest``."""
    for item in head:
        yield item
    async for item in rest:
        yield item


async def _read_request(reader: asyncio.StreamReader, writer: asyncio.StreamWriter
                        ) -> Tuple[str, str, str, Dict[str, str], bytes]:
    """One request off the connection: its head, then its body (sized by
    ``Content-Length``, or chunked). A client that sent ``Expect:
    100-continue`` with a body gets ``100 Continue`` first, unless its
    ``Content-Length`` is over the limit (413 at once)."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.LimitOverrunError:
        raise HttpError(413, "request head too large")
    if len(head) > MAX_HEADER_BYTES:
        raise HttpError(413, "request head too large")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise HttpError(400, "malformed request line")
    method, path, version = parts
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise HttpError(400, "malformed header line")
        headers[name.strip().lower()] = value.strip()
    chunked = "chunked" in headers.get("transfer-encoding", "").lower()
    length = 0
    if not chunked:
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise HttpError(400, "invalid Content-Length")
        if length < 0 or length > MAX_BODY_BYTES:
            raise HttpError(413, "request body too large")
    if (chunked or length) and version == "HTTP/1.1" and headers.get("expect", "").lower() == "100-continue":
        writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        await writer.drain()
    if chunked:
        return method, path, version, headers, await _read_chunked(reader)
    body = await reader.readexactly(length) if length else b""
    return method, path, version, headers, body


_HEX = frozenset("0123456789abcdefABCDEF")


async def _read_line(reader: asyncio.StreamReader) -> bytes:
    try:
        return await reader.readuntil(b"\r\n")
    except asyncio.LimitOverrunError:
        raise HttpError(400, "malformed chunked body: line too long")


async def _read_chunked(reader: asyncio.StreamReader) -> bytes:
    """A chunked body: ``size[;extension]CRLF data CRLF`` chunks to a zero
    size, then trailer lines to an empty one (read and dropped)."""
    body = bytearray()
    while True:
        size_s = (await _read_line(reader))[:-2].split(b";", 1)[0].strip().decode("latin-1")
        if not size_s or not set(size_s) <= _HEX:
            raise HttpError(400, "malformed chunked body: bad chunk size")
        size = int(size_s, 16)
        if size == 0:
            break
        if len(body) + size > MAX_BODY_BYTES:
            raise HttpError(413, "request body too large")
        body += await reader.readexactly(size)
        if await reader.readexactly(2) != b"\r\n":
            raise HttpError(400, "malformed chunked body: chunk data not followed by CRLF")
    trailers = 0
    while True:
        line = await _read_line(reader)
        if line == b"\r\n":
            return bytes(body)
        trailers += len(line)
        if trailers > MAX_HEADER_BYTES:
            raise HttpError(413, "request trailers too large")


async def _respond_json(conn: _Conn, status: int, obj: dict, headers: Optional[Dict[str, str]] = None) -> None:
    await _respond(conn, status, json.dumps(obj, ensure_ascii=False).encode(), "application/json; charset=utf-8",
                   headers)


async def _respond(conn: _Conn, status: int, payload: bytes, content_type: str,
                   headers: Optional[Dict[str, str]] = None) -> None:
    extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    conn.write(
        f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}\r\n"
        f"Content-Type: {content_type}\r\nContent-Length: {len(payload)}\r\n"
        f"{extra}Connection: {'keep-alive' if conn.keep_alive else 'close'}\r\n\r\n".encode()
        + payload
    )
    await conn.drain()


def _trace_headers(ctx: Context) -> Dict[str, str]:
    tp = ctx.traceparent
    return {TRACE_ID_HEADER: tp.trace_id} if tp is not None else {}


async def _sse(writer: asyncio.StreamWriter, obj: dict) -> None:
    writer.write(b"data: " + json.dumps(obj, ensure_ascii=False).encode() + b"\n\n")
    await writer.drain()


async def _sse_event(writer: asyncio.StreamWriter, event: str, comment: Optional[str]) -> None:
    await _sse_event_raw(writer, event, {"event": event, "comment": comment})


async def _sse_event_raw(writer: asyncio.StreamWriter, event: str, obj: dict) -> None:
    writer.write(b"event: " + event.encode() + b"\ndata: " + json.dumps(obj, ensure_ascii=False).encode() + b"\n\n")
    await writer.drain()


def _resolve_tenant(body: dict, headers: Dict[str, str]) -> str:
    user = body.get("user")
    if user:
        return oai.validate_tenant(user, "user")
    hdr = headers.get(TENANT_HEADER)
    if hdr:
        return oai.validate_tenant(hdr, TENANT_HEADER)
    auth = headers.get("authorization") or ""
    if auth:
        # Stable pseudonymous id per API key: attribution without storing
        # (or ever re-emitting) the credential itself.
        token = auth.split(None, 1)[-1]
        return "key-" + hashlib.sha256(token.encode()).hexdigest()[:16]
    return "anon"
