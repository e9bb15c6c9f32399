"""Process-local runtime: cancellation hierarchy and graceful shutdown.

A copy of the JAX package's ``runtime/runtime.py``: a root
``CancellationToken`` whose children are cancelled with it, a shutdown
tracker that waits for in-flight endpoint handlers to drain, tracked
background tasks, and SIGINT/SIGTERM handlers that trigger shutdown.
"""

from __future__ import annotations

import asyncio
import contextlib
import signal
from typing import Optional, Set

from dynamo_tpu_torch.runtime.config import Config
from dynamo_tpu_torch.runtime.logging import get_logger, init_logging

logger = get_logger(__name__)


class CancellationToken:
    """Hierarchical cancellation."""

    def __init__(self, parent: Optional["CancellationToken"] = None):
        self._event = asyncio.Event()
        self._children: Set["CancellationToken"] = set()
        self._parent = parent
        if parent is not None:
            parent._children.add(self)
            if parent.is_cancelled():
                self._event.set()

    def child_token(self) -> "CancellationToken":
        return CancellationToken(self)

    def cancel(self) -> None:
        if not self._event.is_set():
            self._event.set()
            for c in list(self._children):
                c.cancel()

    def is_cancelled(self) -> bool:
        return self._event.is_set()

    async def cancelled(self) -> None:
        await self._event.wait()


class GracefulShutdownTracker:
    """Counts in-flight endpoint handlers; shutdown waits for zero."""

    def __init__(self):
        self._count = 0
        self._zero = asyncio.Event()
        self._zero.set()

    def enter(self) -> None:
        self._count += 1
        self._zero.clear()

    def exit(self) -> None:
        self._count -= 1
        if self._count <= 0:
            self._count = 0
            self._zero.set()

    @property
    def in_flight(self) -> int:
        return self._count

    async def wait_drained(self, timeout: Optional[float] = None) -> bool:
        try:
            await asyncio.wait_for(self._zero.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False


class Runtime:
    """Process handle: config, root cancellation token, shutdown tracking."""

    def __init__(self, config: Optional[Config] = None):
        init_logging()
        self.config = config or Config.from_env()
        self.cancellation = CancellationToken()
        self.shutdown_tracker = GracefulShutdownTracker()
        self._background: Set[asyncio.Task] = set()
        self._shutdown_started = False

    def spawn(self, coro, name: Optional[str] = None) -> asyncio.Task:
        """Track a background task; cancelled at shutdown."""
        task = asyncio.get_running_loop().create_task(coro, name=name)
        self._background.add(task)
        task.add_done_callback(self._background.discard)
        return task

    def install_signal_handlers(self) -> None:
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            with contextlib.suppress(NotImplementedError, RuntimeError):
                loop.add_signal_handler(sig, self.trigger_shutdown)

    def trigger_shutdown(self) -> None:
        if not self._shutdown_started:
            logger.info("shutdown triggered")
            self._shutdown_started = True
            self.cancellation.cancel()

    async def shutdown(self, drain_timeout: Optional[float] = None) -> None:
        """Cancel, drain in-flight handlers, stop background tasks."""
        self.trigger_shutdown()
        timeout = drain_timeout if drain_timeout is not None else self.config.runtime.shutdown_timeout_s
        drained = await self.shutdown_tracker.wait_drained(timeout)
        if not drained:
            logger.warning("graceful drain timed out with %d in-flight", self.shutdown_tracker.in_flight)
        for task in list(self._background):
            task.cancel()
        if self._background:
            await asyncio.gather(*self._background, return_exceptions=True)
        self._background.clear()
