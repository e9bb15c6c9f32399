"""AsyncEngine abstraction + request Context.

An engine is anything with ``generate(request, context) -> AsyncIterator``:
model engines and pipeline operators share the shape, which is what lets
them compose into pipelines (preprocessor → backend → engine). A copy of
the JAX package's ``runtime/engine.py`` without its tracing and migration
parts, which this port does not have yet.
"""

from __future__ import annotations

import asyncio
import uuid
from dataclasses import dataclass
from typing import Any, AsyncIterator, Dict, Optional, Protocol, runtime_checkable


class Context:
    """Per-request context: identity and cancellation.

    Cancellation is two-level:
    - ``stop_generating()`` — graceful: the engine should finish the current
      step and stop emitting (client disconnect, stop-conditions met).
    - ``kill()`` — hard: abandon the request immediately.

    Contexts form a tree: child contexts are stopped/killed when the parent is.
    """

    __slots__ = ("id", "metadata", "_stopped", "_killed", "_children")

    def __init__(self, id: Optional[str] = None, metadata: Optional[Dict[str, Any]] = None):
        self.id = id or uuid.uuid4().hex
        self.metadata: Dict[str, Any] = metadata or {}
        self._stopped = asyncio.Event()
        self._killed = asyncio.Event()
        self._children: list["Context"] = []

    def child(self, id: Optional[str] = None) -> "Context":
        c = Context(id=id or self.id, metadata=dict(self.metadata))
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
