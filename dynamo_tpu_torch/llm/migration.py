"""Migration operator: replay an in-flight request on another worker when
its response stream drops.

A copy of the JAX package's ``llm/migration.py`` without its tracing event
(ROADMAP Queue 1 item 18): on ``StreamDisconnect`` the tokens already
emitted are appended to the prompt and the request is pushed again (the
router picks a live instance), up to ``migration_limit`` times. The log
line "recreating stream" is kept verbatim. Replay accounting stays honest:

- ``max_tokens`` decrements by the tokens already emitted;
- ``deadline_ms`` decrements by the elapsed wall time;
- ``cached_tokens`` is clamped to the original prompt length and reported
  once.

On exhaustion the final StreamDisconnect re-raises with the partial token
count in ``context.metadata["migration"]``, which the HTTP service answers
as a 502.
"""

from __future__ import annotations

import time
from typing import Any, AsyncIterator, Callable, Optional

from dynamo_tpu_torch.runtime.engine import Annotated, AsyncEngine, Context, StreamDisconnect
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.pipeline import Operator
from dynamo_tpu_torch.runtime.push_router import NoInstancesError

logger = get_logger(__name__)


class Migration(Operator):
    def __init__(self, migration_limit: int, *, on_migrate: Optional[Callable[[], None]] = None):
        self.migration_limit = migration_limit
        # Counter hook, called once per replay.
        self.on_migrate = on_migrate

    def attach(self, downstream: AsyncEngine) -> AsyncEngine:
        return _MigrationEngine(self.migration_limit, downstream, on_migrate=self.on_migrate)


class _MigrationEngine:
    def __init__(self, limit: int, downstream: AsyncEngine,
                 on_migrate: Optional[Callable[[], None]] = None):
        self.limit = limit
        self.downstream = downstream
        self.on_migrate = on_migrate

    async def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        attempts_left = self.limit
        req = dict(request)
        start = time.monotonic()
        orig_prompt_len = len(req.get("token_ids") or [])
        emitted_tokens = 0
        cached_reported = False

        while True:
            try:
                async for item in self.downstream.generate(req, context):
                    out = item.data if isinstance(item, Annotated) else item
                    if isinstance(out, dict):
                        if out.get("token_ids"):
                            emitted_tokens += len(out["token_ids"])
                            # Fold emitted tokens into the replay request so a
                            # migrated continuation resumes, not restarts.
                            req = self._fold(req, out["token_ids"], start)
                        if out.get("cached_tokens") is not None:
                            item = self._honest_cached(
                                item, out, orig_prompt_len, cached_reported
                            )
                            cached_reported = True
                            if item is None:
                                continue
                    yield item
                return
            except StreamDisconnect:
                if attempts_left <= 0 or context.is_stopped():
                    # Exhausted (or the client left): annotate the context so
                    # the frontend can answer a structured 502 with the
                    # partial token count instead of an opaque 500.
                    context.metadata["migration"] = {
                        "tokens_emitted": emitted_tokens,
                        "attempts": self.limit - attempts_left,
                    }
                    raise
                attempts_left -= 1
                if self.on_migrate is not None:
                    self.on_migrate()
                logger.warning(
                    "recreating stream for request %s (%d migrations left, %d tokens emitted)",
                    context.id,
                    attempts_left,
                    emitted_tokens,
                )
            except NoInstancesError:
                if attempts_left <= 0:
                    raise
                attempts_left -= 1
                logger.warning("recreating stream for request %s: no instances yet", context.id)

    @staticmethod
    def _honest_cached(item, out: dict, orig_prompt_len: int, already_reported: bool):
        """Keep the ``cached_tokens`` report honest across attempts: clamp a
        replay's warm-prefix hit to the client's original prompt (the folded
        output tokens it also re-served were generated work, not prompt),
        and drop duplicate reports (the frontend counter inc()s per report).
        Returns the item to yield, or None to swallow it."""
        clamped = min(int(out["cached_tokens"]), orig_prompt_len)
        if already_reported:
            if not out.get("token_ids") and not out.get("finish_reason"):
                return None  # pure duplicate report — swallow the frame
            out = dict(out)
            out.pop("cached_tokens", None)
        elif clamped != out["cached_tokens"]:
            out = dict(out)
            out["cached_tokens"] = clamped
        else:
            return item
        if isinstance(item, Annotated):
            return Annotated(data=out, event=item.event, comment=item.comment, id=item.id)
        return out

    @staticmethod
    def _fold(req: dict, new_tokens, start: float) -> dict:
        req = dict(req)
        req["token_ids"] = list(req.get("token_ids") or []) + list(new_tokens)
        stop = dict(req.get("stop_conditions") or {})
        if stop.get("max_tokens"):
            stop["max_tokens"] = max(1, stop["max_tokens"] - len(new_tokens))
        if stop.get("deadline_ms"):
            # The deadline budget is relative to worker arrival: a replay
            # must carry only what remains of the client's budget, not a
            # fresh one (floor 1 ms — the worker evicts immediately, the
            # client still gets its deterministic timeout finish).
            elapsed_ms = (time.monotonic() - start) * 1000.0
            orig = req.get("_deadline_budget_ms", stop["deadline_ms"])
            req["_deadline_budget_ms"] = orig
            stop["deadline_ms"] = max(1.0, float(orig) - elapsed_ms)
        req["stop_conditions"] = stop
        return req
