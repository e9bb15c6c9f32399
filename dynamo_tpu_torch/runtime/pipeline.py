"""Typed operator pipeline: composable request/response transform stages.

An :class:`Operator` transforms the request on the way down and the response
stream on the way up; ``link`` folds operators around a terminal engine,
producing a single composed :class:`AsyncEngine`. A copy of the JAX
package's ``runtime/pipeline.py``.
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Sequence

from dynamo_tpu_torch.runtime.engine import AsyncEngine, Context


class Operator:
    """A bidirectional pipeline stage."""

    async def transform_request(self, request: Any, context: Context) -> Any:
        return request

    def transform_response(
        self, stream: AsyncIterator[Any], request: Any, context: Context
    ) -> AsyncIterator[Any]:
        return stream

    def attach(self, downstream: AsyncEngine) -> AsyncEngine:
        return _OperatorEngine(self, downstream)


class _OperatorEngine:
    def __init__(self, op: Operator, downstream: AsyncEngine):
        self.op = op
        self.downstream = downstream

    async def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        transformed = await self.op.transform_request(request, context)
        stream = self.downstream.generate(transformed, context)
        async for item in self.op.transform_response(stream, transformed, context):
            yield item


def link(operators: Sequence[Operator], engine: AsyncEngine) -> AsyncEngine:
    """Fold operators around the terminal engine: the first operator sees the
    original request first and the final response stream last."""
    composed = engine
    for op in reversed(list(operators)):
        composed = op.attach(composed)
    return composed
