"""OpenAI-compatible HTTP frontend on the standard library.

Routes ``POST /v1/chat/completions`` and ``POST /v1/completions`` (JSON, or
SSE with ``"stream": true`` ending in ``data: [DONE]``), ``GET /v1/models``
and ``GET /health``, with the same response bodies as the JAX package's
aiohttp service. aiohttp is not assumed to be installed, so this is a small
HTTP/1.1 server on ``asyncio.start_server``: one request per connection
(every response says ``Connection: close``), bodies sized by
``Content-Length``. A request with ``n > 1`` runs its choices as
separate generations (a seeded request's choice i with ``seed + i``), all
sent to the engine at once so they share its batches; a stream
interleaves their chunks by ``index``. Logprobs, tool calls and reasoning
content are rendered as the JAX service renders them. Metrics, TLS, gRPC,
embeddings and responses are not ported yet (ROADMAP Queue 1 items 18 and
19).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import time
from typing import AsyncIterator, Dict, Optional, Tuple

from dynamo_tpu_torch.llm.protocols import openai as oai
from dynamo_tpu_torch.llm.protocols.common import as_engine_output
from dynamo_tpu_torch.runtime.engine import Annotated, AsyncEngine, Context

logger = logging.getLogger(__name__)

# Capacity attribution: the OpenAI ``user`` field, then this header, then a
# hash of the API key — "anon" only when the request carries nothing.
TENANT_HEADER = "x-dynamo-tenant"

MAX_BODY_BYTES = 64 << 20
MAX_HEADER_BYTES = 64 << 10

_REASONS = {
    200: "OK", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
    411: "Length Required", 413: "Payload Too Large", 500: "Internal Server Error",
    504: "Gateway Timeout",
}


class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class HttpService:
    """Serves the pipelines in ``models`` (model name → AsyncEngine taking
    OpenAI request bodies) on ``host:port``; port 0 binds a free port,
    readable from ``self.port`` after ``start``."""

    def __init__(self, models: Dict[str, AsyncEngine], *, host: str = "0.0.0.0", port: int = 8000):
        self.models = dict(models)
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("OpenAI HTTP frontend on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # --- connection ---------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            try:
                method, path, headers, body = await _read_request(reader)
            except HttpError as e:
                await _respond_json(writer, e.status, oai.error_body(str(e), code=e.status))
                return
            except (asyncio.IncompleteReadError, ConnectionError):
                return
            await self._route(method, path, headers, body, writer)
        except ConnectionError:
            pass  # the client went away; a stream has already cancelled its request
        except Exception:
            logger.exception("HTTP handler failed")
        finally:
            writer.close()

    async def _route(self, method: str, path: str, headers: Dict[str, str], body: bytes, writer) -> None:
        path = path.split("?", 1)[0]
        routes = {
            "/v1/chat/completions": ("POST", "chat"),
            "/v1/completions": ("POST", "completions"),
            "/v1/models": ("GET", "models"),
            "/health": ("GET", "health"),
        }
        if path not in routes:
            await _respond_json(writer, 404, oai.error_body(f"no route {path}", "not_found", 404))
            return
        want, kind = routes[path]
        if method != want:
            await _respond_json(writer, 405, oai.error_body(f"{path} takes {want}", "method_not_allowed", 405))
            return
        if kind == "health":
            await _respond_json(writer, 200, {"status": "healthy", "models": sorted(self.models)})
        elif kind == "models":
            now = int(time.time())
            data = [{"id": n, "object": "model", "created": now, "owned_by": "dynamo-tpu"} for n in sorted(self.models)]
            await _respond_json(writer, 200, {"object": "list", "data": data})
        else:
            await self._serve(kind, headers, body, writer)

    # --- completions --------------------------------------------------------
    async def _serve(self, kind: str, headers: Dict[str, str], raw: bytes, writer) -> None:
        try:
            body = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            await _respond_json(writer, 400, oai.error_body("invalid JSON body"))
            return
        try:
            body = oai.validate_chat_request(body) if kind == "chat" else oai.validate_completion_request(body)
            body["_tenant"] = _resolve_tenant(body, headers)
        except oai.RequestError as e:
            await _respond_json(writer, 400, oai.error_body(str(e)))
            return
        model = body["model"]
        engine = self.models.get(model)
        if engine is None:
            await _respond_json(writer, 404, oai.error_body(f"model {model!r} not found", "model_not_found", 404))
            return
        rid = oai.make_id("chatcmpl" if kind == "chat" else "cmpl")
        ctx = Context()
        if body.get("stream"):
            await self._serve_stream(engine, body, ctx, rid, kind, model, writer)
        else:
            await self._serve_unary(engine, body, ctx, rid, kind, model, writer)

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

    async def _serve_unary(self, engine, body, ctx, rid, kind, model, writer) -> None:
        bodies = self._choice_bodies(body)
        prompt_tokens = [0]
        cached_tokens = [None]

        async def run_choice(i: int, b: dict, c: Context) -> dict:
            text_parts, reasoning_parts = [], []
            tool_calls = None
            n_tokens = 0
            finish_reason = "stop"
            logprobs: list = []
            top_logprobs: list = []
            async for item in engine.generate(b, c):
                if isinstance(item, Annotated) and item.is_annotation():
                    if item.event == "_metrics" and i == 0:
                        prompt_tokens[0] = int(item.comment or 0)
                    elif item.event == "_cached" and i == 0:
                        cached_tokens[0] = int(item.comment or 0)
                    continue
                out = as_engine_output(item)
                if out is None:
                    continue
                if out.text:
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
                await _respond_json(writer, 400, oai.error_body(str(e)))
                return
            logger.exception("request %s failed", ctx.id)
            await _respond_json(writer, 500, oai.error_body(str(e), "internal_error", 500))
            return
        usage = oai.usage_dict(prompt_tokens[0], sum(r["n_tokens"] for r in results), cached_tokens[0],
                               tenant=body.get("_tenant"))
        if any(r["finish_reason"] == "timeout" for r in results):
            err = oai.error_body("request deadline exceeded", "timeout_error", 504)
            err["usage"] = usage
            await _respond_json(writer, 504, err)
            return
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
        await _respond_json(writer, 200, resp)

    async def _serve_stream(self, engine, body, ctx, rid, kind, model, writer) -> None:
        if int(body.get("n") or 1) > 1:
            await self._serve_stream_multi(engine, body, ctx, rid, kind, model, writer)
            return
        # The pipeline's request stages (the preprocessor's grammar build
        # among them) run before its first item: a rejection there is still
        # a 400, sent before the stream's 200.
        stream = engine.generate(body, ctx).__aiter__()
        try:
            first = [await stream.__anext__()]
        except StopAsyncIteration:
            first = []
        except oai.RequestError as e:
            await _respond_json(writer, 400, oai.error_body(str(e)))
            return
        except Exception as e:
            logger.exception("stream %s failed", ctx.id)
            await _respond_json(writer, 500, oai.error_body(str(e), "internal_error", 500))
            return
        writer.write(_SSE_HEAD)
        n_tokens = 0
        prompt_tokens = 0
        cached_tokens = None
        try:
            if kind == "chat":
                await _sse(writer, oai.chat_chunk(rid, model, {"role": "assistant", "content": ""}))
            async for item in _chain(first, stream):
                if isinstance(item, Annotated) and item.is_annotation():
                    if item.event.startswith("_"):
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
                n_tokens += len(out.token_ids)
                await _sse_deltas(writer, rid, model, kind, out, 0)
                if out.finish_reason:
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
            raise
        except Exception as e:
            logger.exception("stream %s failed", ctx.id)
            await _sse(writer, oai.error_body(str(e), "internal_error", 500))
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

        async def pump(i: int, b: dict, c: Context):
            try:
                async for item in engine.generate(b, c):
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
                await _respond_json(writer, 400, oai.error_body(str(head[2])))
                return
            writer.write(_SSE_HEAD)
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
            raise
        except Exception as e:
            logger.exception("stream %s failed", ctx.id)
            await _sse(writer, oai.error_body(str(e), "internal_error", 500))
        finally:
            ctx.stop_generating()  # and its children: stop what still runs
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        writer.write(b"data: [DONE]\n\n")
        await writer.drain()


_SSE_HEAD = (b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
             b"Cache-Control: no-cache\r\nConnection: close\r\n\r\n")


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


async def _read_request(reader: asyncio.StreamReader) -> Tuple[str, str, Dict[str, str], bytes]:
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
    method, path = parts[0], parts[1]
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise HttpError(400, "malformed header line")
        headers[name.strip().lower()] = value.strip()
    if "chunked" in headers.get("transfer-encoding", "").lower():
        raise HttpError(411, "chunked request bodies are not supported; send Content-Length")
    try:
        length = int(headers.get("content-length", "0"))
    except ValueError:
        raise HttpError(400, "invalid Content-Length")
    if length < 0 or length > MAX_BODY_BYTES:
        raise HttpError(413, "request body too large")
    body = await reader.readexactly(length) if length else b""
    return method, path, headers, body


async def _respond_json(writer: asyncio.StreamWriter, status: int, obj: dict) -> None:
    payload = json.dumps(obj, ensure_ascii=False).encode()
    writer.write(
        f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}\r\n"
        f"Content-Type: application/json; charset=utf-8\r\nContent-Length: {len(payload)}\r\n"
        "Connection: close\r\n\r\n".encode()
        + payload
    )
    await writer.drain()


async def _sse(writer: asyncio.StreamWriter, obj: dict) -> None:
    writer.write(b"data: " + json.dumps(obj, ensure_ascii=False).encode() + b"\n\n")
    await writer.drain()


async def _sse_event(writer: asyncio.StreamWriter, event: str, comment: Optional[str]) -> None:
    payload = json.dumps({"event": event, "comment": comment}, ensure_ascii=False).encode()
    writer.write(b"event: " + event.encode() + b"\ndata: " + payload + b"\n\n")
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
