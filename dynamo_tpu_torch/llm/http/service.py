"""OpenAI-compatible HTTP frontend on the standard library.

Routes ``POST /v1/chat/completions`` and ``POST /v1/completions`` (JSON, or
SSE with ``"stream": true`` ending in ``data: [DONE]``), ``GET /v1/models``
and ``GET /health``, with the same response bodies as the JAX package's
aiohttp service. aiohttp is not assumed to be installed, so this is a small
HTTP/1.1 server on ``asyncio.start_server``: one request per connection
(every response says ``Connection: close``), bodies sized by
``Content-Length``. Metrics, TLS, gRPC, embeddings, responses and
multi-choice (``n > 1``) requests are not ported yet (ROADMAP Queue 1
items 10, 18 and 19).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import time
from typing import Dict, Optional, Tuple

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

    async def _serve_unary(self, engine, body, ctx, rid, kind, model, writer) -> None:
        text_parts = []
        n_tokens = 0
        prompt_tokens = 0
        cached_tokens = None
        finish_reason = "stop"
        try:
            async for item in engine.generate(body, ctx):
                if isinstance(item, Annotated) and item.is_annotation():
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
                n_tokens += len(out.token_ids)
                if out.finish_reason:
                    finish_reason = out.finish_reason
        except oai.RequestError as e:
            await _respond_json(writer, 400, oai.error_body(str(e)))
            return
        except Exception as e:
            logger.exception("request %s failed", ctx.id)
            await _respond_json(writer, 500, oai.error_body(str(e), "internal_error", 500))
            return
        usage = oai.usage_dict(prompt_tokens, n_tokens, cached_tokens, tenant=body.get("_tenant"))
        if finish_reason == "timeout":
            err = oai.error_body("request deadline exceeded", "timeout_error", 504)
            err["usage"] = usage
            await _respond_json(writer, 504, err)
            return
        text = "".join(text_parts)
        if kind == "chat":
            resp = oai.chat_response(rid, model, text, finish_reason, usage)
        else:
            resp = oai.completion_response(rid, model, text, finish_reason, usage)
        await _respond_json(writer, 200, resp)

    async def _serve_stream(self, engine, body, ctx, rid, kind, model, writer) -> None:
        writer.write(
            b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\nConnection: close\r\n\r\n"
        )
        n_tokens = 0
        prompt_tokens = 0
        cached_tokens = None
        try:
            if kind == "chat":
                await _sse(writer, oai.chat_chunk(rid, model, {"role": "assistant", "content": ""}))
            async for item in engine.generate(body, ctx):
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
                if out.text:
                    if kind == "chat":
                        await _sse(writer, oai.chat_chunk(rid, model, {"content": out.text}))
                    else:
                        await _sse(writer, oai.completion_chunk(rid, model, out.text))
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
