"""System status server: ``/health``, ``/live``, ``/metrics``, ``/debug/state``,
``/debug/stacks`` and ``/drain``.

The JAX package's ``runtime/health.py`` (``SystemHealth``, and
``SystemStatusServer`` with its routes, statuses and JSON bodies) on
``asyncio.start_server``: the card's machine has no aiohttp. A connection
serves one request. ``POST /debug/profile`` answers 501: on-demand device
profiles come with the profiling plane (ROADMAP Queue 1 item 18, second
part). Configured by ``runtime/config.SystemConfig`` (``DYN_SYSTEM_*``).
"""

from __future__ import annotations

import asyncio
import json
import sys
import threading
import traceback
from typing import Callable, Dict, Optional, Tuple

from dynamo_tpu_torch.runtime.config import SystemConfig
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

logger = get_logger(__name__)

HEALTHY = "ready"
UNHEALTHY = "notready"

_REASONS = {200: "OK", 202: "Accepted", 400: "Bad Request", 404: "Not Found", 405: "Method Not Allowed",
            413: "Payload Too Large", 500: "Internal Server Error", 501: "Not Implemented",
            503: "Service Unavailable"}
_MAX_HEAD = 64 << 10


class SystemHealth:
    """Process and per-endpoint health. ``attach_engine`` adds the engine's
    liveness to readiness: the probe returns the watchdog's and flight
    recorder's keys (``engine_stalled``, ``last_step_age_s``,
    ``compiles_after_warmup_total``), and a stalled engine reports notready
    while the process is up."""

    def __init__(self, starting_status: str = UNHEALTHY, use_endpoint_health: bool = False):
        self.system_status = starting_status
        self.use_endpoint_health = use_endpoint_health
        self.endpoints: Dict[str, str] = {}
        self._engine_probe: Optional[Callable[[], dict]] = None

    def set_system_ready(self) -> None:
        self.system_status = HEALTHY

    def set_endpoint_health(self, endpoint_path: str, status: str) -> None:
        self.endpoints[endpoint_path] = status

    def remove_endpoint(self, endpoint_path: str) -> None:
        self.endpoints.pop(endpoint_path, None)

    def attach_engine(self, probe: Callable[[], dict]) -> None:
        """``probe()`` → dict with ``engine_stalled`` (0/1) plus any extra
        liveness fields to show on /health."""
        self._engine_probe = probe

    def _engine_state(self) -> Optional[dict]:
        if self._engine_probe is None:
            return None
        try:
            return self._engine_probe()
        except Exception as e:  # noqa: BLE001 — health must answer regardless
            return {"engine_stalled": 1.0, "probe_error": str(e)}

    def is_healthy(self) -> bool:
        engine = self._engine_state()
        if engine is not None and engine.get("engine_stalled"):
            return False
        if self.use_endpoint_health:
            return bool(self.endpoints) and all(s == HEALTHY for s in self.endpoints.values())
        return self.system_status == HEALTHY

    def snapshot(self) -> dict:
        out = {
            "status": HEALTHY if self.is_healthy() else UNHEALTHY,
            "system": self.system_status,
            "endpoints": dict(self.endpoints),
        }
        engine = self._engine_state()
        if engine is not None:
            out["engine"] = engine
        return out


class SystemStatusServer:
    """The routes on ``config.host:config.port`` (port 0 binds a free one,
    readable from ``self.port`` after ``start``). ``state_probe`` feeds
    ``/debug/state`` (e.g. ``TorchEngine.debug_state``); ``drain_cb`` is
    ``POST /drain``'s coroutine (the worker's drain lifecycle)."""

    def __init__(
        self,
        health: SystemHealth,
        metrics: Optional[MetricsRegistry] = None,
        config: Optional[SystemConfig] = None,
        state_probe: Optional[Callable[[], dict]] = None,
        drain_cb: Optional[Callable[[], "asyncio.Future"]] = None,
    ):
        self.health = health
        self.metrics = metrics
        self.config = config or SystemConfig()
        self.drain_cb = drain_cb
        self._draining = False
        self.state_probe = state_probe
        self._server: Optional[asyncio.AbstractServer] = None
        self.port: Optional[int] = None
        self._routes = {
            "/health": ("GET", self._health),
            "/live": ("GET", self._live),
            "/metrics": ("GET", self._metrics),
            "/debug/state": ("GET", self._debug_state),
            "/debug/stacks": ("GET", self._debug_stacks),
            "/debug/profile": ("POST", self._debug_profile),
            "/drain": ("POST", self._drain),
        }

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._handle, self.config.host, self.config.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("system status server on %s:%d", self.config.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # --- connection ---------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
            if len(head) > _MAX_HEAD:
                await _respond(writer, 413, b"", "text/plain")
                return
            lines = head.decode("latin-1").split("\r\n")
            parts = lines[0].split(" ")
            if len(parts) != 3:
                await _respond(writer, 400, b"", "text/plain")
                return
            method, target, _ = parts
            length = 0
            for line in lines[1:]:
                name, _, value = line.partition(":")
                if name.strip().lower() == "content-length":
                    length = int(value.strip() or 0)
            if 0 < length <= _MAX_HEAD:
                await reader.readexactly(length)
            path = target.split("?", 1)[0]
            route = self._routes.get(path)
            if route is None:
                await _respond(writer, 404, b"404: Not Found", "text/plain")
                return
            want, handler = route
            if method != want:
                await _respond(writer, 405, b"405: Method Not Allowed", "text/plain")
                return
            status, body, ctype = await handler()
            await _respond(writer, status, body, ctype)
        except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, ConnectionError, ValueError):
            pass
        except Exception:
            logger.exception("status server handler failed")
        finally:
            writer.close()

    # --- routes -------------------------------------------------------------
    async def _health(self) -> Tuple[int, bytes, str]:
        snap = self.health.snapshot()
        return (200 if snap["status"] == HEALTHY else 503), _json(snap), "application/json"

    async def _live(self) -> Tuple[int, bytes, str]:
        return 200, _json({"status": "live"}), "application/json"

    async def _metrics(self) -> Tuple[int, bytes, str]:
        return 200, (self.metrics.render() if self.metrics is not None else b""), "text/plain"

    async def _debug_state(self) -> Tuple[int, bytes, str]:
        """The engine's live view (sequences, block pool, digests, SLO,
        flight recorder, watchdog): no scrape interval, no aggregation."""
        if self.state_probe is None:
            return 404, _json({"error": "no state probe attached"}), "application/json"
        try:
            state = self.state_probe()
        except Exception as e:  # noqa: BLE001 — the debug surface must answer
            state = {"error": f"{type(e).__name__}: {e}"}
        return 200, json.dumps(state, default=str).encode(), "application/json"

    async def _debug_profile(self) -> Tuple[int, bytes, str]:
        return 501, _json({"error": "on-demand device profiles are not ported yet: they come with the "
                                    "profiling plane (ROADMAP Queue 1 item 18, second part)"}), "application/json"

    async def _drain(self) -> Tuple[int, bytes, str]:
        """``POST /drain``: begin the worker's drain (deregister, stop
        admitting, finish or migrate in-flight work, exit). 202 at once; the
        drain runs in the background while /health reads notready."""
        if self.drain_cb is None:
            return 404, _json({"error": "no drain hook attached"}), "application/json"
        already = self._draining
        self._draining = True
        self.health.system_status = UNHEALTHY
        if not already:
            asyncio.get_running_loop().create_task(self.drain_cb())
        return 202, _json({"status": "draining", "already_draining": already}), "application/json"

    async def _debug_stacks(self) -> Tuple[int, bytes, str]:
        """Python stacks of every thread: the first question when the step
        loop wedges."""
        names = {t.ident: t.name for t in threading.enumerate()}
        stacks = {f"{names.get(tid, '?')}-{tid}": traceback.format_stack(frame)
                  for tid, frame in sys._current_frames().items()}
        return 200, _json(stacks), "application/json"


def _json(obj) -> bytes:
    return json.dumps(obj).encode()


async def _respond(writer: asyncio.StreamWriter, status: int, body: bytes, ctype: str) -> None:
    writer.write(
        f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}\r\n"
        f"Content-Type: {ctype}; charset=utf-8\r\nContent-Length: {len(body)}\r\nConnection: close\r\n\r\n".encode()
        + body)
    await writer.drain()
