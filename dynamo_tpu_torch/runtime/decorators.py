"""Python-facing decorators for writing a worker: a copy of the JAX
package's ``runtime/decorators.py``.

``dynamo_worker`` runs an async ``main(runtime, ...)`` with a connected
``DistributedRuntime`` (``static=True``: a detached, in-process one) and
signal handling, and shuts the runtime down after it; ``dynamo_endpoint``
normalises a handler to ``(request, context) -> AsyncIterator``.
"""

from __future__ import annotations

import asyncio
import functools
import inspect
from typing import Any, AsyncIterator, Callable

from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.runtime import Runtime


def dynamo_worker(static: bool = False):
    """Wrap an async ``main(runtime: DistributedRuntime, ...)`` so it receives
    a connected DistributedRuntime and signal handling, then run it."""

    def decorator(fn: Callable):
        @functools.wraps(fn)
        async def wrapped(*args, **kwargs):
            runtime = Runtime()
            drt = await (DistributedRuntime.detached(runtime) if static else DistributedRuntime.from_settings(runtime))
            runtime.install_signal_handlers()
            try:
                return await fn(drt, *args, **kwargs)
            finally:
                await drt.shutdown()

        return wrapped

    return decorator


def dynamo_endpoint(fn: Callable) -> Callable:
    """Normalise an endpoint handler to ``(request, context) -> AsyncIterator``.

    Accepts handlers declared with or without a context parameter, returning
    either an async generator or a single awaitable value.
    """
    sig = inspect.signature(fn)
    wants_ctx = len(sig.parameters) >= 2

    if inspect.isasyncgenfunction(fn):
        if wants_ctx:
            return fn

        @functools.wraps(fn)
        async def gen_no_ctx(request: Any, context: Context) -> AsyncIterator[Any]:
            async for item in fn(request):
                yield item

        return gen_no_ctx

    @functools.wraps(fn)
    async def coro_wrapper(request: Any, context: Context) -> AsyncIterator[Any]:
        result = fn(request, context) if wants_ctx else fn(request)
        if asyncio.iscoroutine(result):
            result = await result
        if hasattr(result, "__aiter__"):
            async for item in result:
                yield item
        else:
            yield result

    return coro_wrapper
