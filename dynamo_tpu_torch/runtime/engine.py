"""AsyncEngine abstraction + request Context.

An engine is anything with ``generate(request, context) -> AsyncIterator``:
model engines and pipeline operators share the shape, which is what lets
them compose into pipelines (frontend → preprocessor → backend → migration
→ router → engine). A copy of the JAX package's ``runtime/engine.py``: a
context crosses the wire as ``{"id", "traceparent"}``, and a dropped
response stream surfaces as ``StreamDisconnect``.
"""

from __future__ import annotations

import asyncio
import uuid
from dataclasses import dataclass
from typing import Any, AsyncIterator, Dict, Optional, Protocol, runtime_checkable

from dynamo_tpu_torch.runtime.logging import TraceParent


class Context:
    """Per-request context: identity, cancellation, trace context.

    Cancellation is two-level:
    - ``stop_generating()`` — graceful: the engine should finish the current
      step and stop emitting (client disconnect, stop-conditions met).
    - ``kill()`` — hard: abandon the request immediately.

    Contexts form a tree: child contexts are stopped/killed when the parent is.
    """

    __slots__ = ("id", "traceparent", "metadata", "_stopped", "_killed", "_children")

    def __init__(
        self,
        id: Optional[str] = None,
        traceparent: Optional[TraceParent] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ):
        self.id = id or uuid.uuid4().hex
        self.traceparent = traceparent or TraceParent.new_root()
        self.metadata: Dict[str, Any] = metadata or {}
        self._stopped = asyncio.Event()
        self._killed = asyncio.Event()
        self._children: list["Context"] = []

    def child(self, id: Optional[str] = None) -> "Context":
        c = Context(id=id or self.id, traceparent=self.traceparent.child(), metadata=dict(self.metadata))
        self._children.append(c)
        if self.is_stopped():
            c.stop_generating()
        if self.is_killed():
            c.kill()
        return c

    def stop_generating(self) -> None:
        self._stopped.set()
        for c in self._children:
            c.stop_generating()

    def kill(self) -> None:
        self._killed.set()
        self._stopped.set()
        for c in self._children:
            c.kill()

    def is_stopped(self) -> bool:
        return self._stopped.is_set()

    def is_killed(self) -> bool:
        return self._killed.is_set()

    async def stopped(self) -> None:
        await self._stopped.wait()

    def to_wire(self) -> dict:
        return {"id": self.id, "traceparent": self.traceparent.to_header()}

    @classmethod
    def from_wire(cls, d: dict) -> "Context":
        tp = TraceParent.from_header(d.get("traceparent", "")) or TraceParent.new_root()
        return cls(id=d.get("id"), traceparent=tp)


@runtime_checkable
class AsyncEngine(Protocol):
    """The universal engine shape."""

    def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        ...


@dataclass
class Annotated:
    """A response envelope that can carry side-band annotations alongside (or
    instead of) data — e.g. the ``_metrics`` / ``_cached`` annotations the
    preprocessor and backend emit for the HTTP service's usage block."""

    data: Any = None
    event: Optional[str] = None
    comment: Optional[str] = None
    id: Optional[str] = None

    def is_annotation(self) -> bool:
        return self.event is not None and self.data is None

    def to_wire(self) -> dict:
        d: Dict[str, Any] = {}
        if self.data is not None:
            d["data"] = self.data
        if self.event is not None:
            d["event"] = self.event
        if self.comment is not None:
            d["comment"] = self.comment
        if self.id is not None:
            d["id"] = self.id
        return d

    @classmethod
    def from_wire(cls, d: dict) -> "Annotated":
        return cls(data=d.get("data"), event=d.get("event"), comment=d.get("comment"), id=d.get("id"))


class EngineError(Exception):
    """Base error for engine failures."""


class StreamDisconnect(EngineError):
    """The response stream dropped mid-flight (worker died, network reset).
    The Migration operator catches it and replays the request on another
    instance."""

    def __init__(self, message: str = "stream disconnected"):
        super().__init__(message)
