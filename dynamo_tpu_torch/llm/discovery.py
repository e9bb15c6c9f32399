"""Model discovery: ModelManager (name → pipeline engine) and ModelWatcher
(a KV-store watch that adds and removes models as workers come and go).

A copy of the JAX package's ``llm/discovery.py``: the watcher watches the
``models/`` prefix; each worker registers its own key (bound to its lease),
so a model leaves the manager only when its last worker's key goes.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Dict, List, Optional

from dynamo_tpu_torch.llm.model_card import MODEL_ROOT_PATH, ModelEntry
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.transports.kvstore import EventType

logger = get_logger(__name__)


class ModelManager:
    """Registry of live model pipelines keyed by (model_type, name)."""

    def __init__(self):
        self._engines: Dict[str, Dict[str, AsyncEngine]] = {"chat": {}, "completions": {}, "embeddings": {}}
        self._entries: Dict[str, ModelEntry] = {}

    def add_model(self, model_type: str, name: str, engine: AsyncEngine) -> None:
        self._engines.setdefault(model_type, {})[name] = engine

    def remove_model(self, model_type: str, name: str) -> None:
        self._engines.get(model_type, {}).pop(name, None)

    def get(self, model_type: str, name: str) -> Optional[AsyncEngine]:
        return self._engines.get(model_type, {}).get(name)

    def list_models(self) -> List[str]:
        names = set()
        for engines in self._engines.values():
            names.update(engines)
        return sorted(names)

    def has_model(self, name: str) -> bool:
        return any(name in engines for engines in self._engines.values())


class ModelWatcher:
    """Watches discovery and keeps the ModelManager in sync.

    ``engine_factory(entry) -> AsyncEngine`` builds the routed pipeline for a
    newly discovered model (frontend → preprocessor → backend → router);
    multiple workers serving the same model share one pipeline (the router's
    instance discovery handles fan-out), mirroring watcher.rs semantics.
    """

    def __init__(
        self,
        drt,
        manager: ModelManager,
        engine_factory: Callable[[ModelEntry], "asyncio.Future"],
    ):
        self.drt = drt
        self.manager = manager
        self.engine_factory = engine_factory
        self._task: Optional[asyncio.Task] = None
        self._entries_by_key: Dict[str, ModelEntry] = {}
        self._refcount: Dict[str, int] = {}

    async def start(self) -> None:
        snapshot, watch = await self.drt.store.get_and_watch_prefix(f"{MODEL_ROOT_PATH}/")
        for entry in snapshot:
            await self._on_put(entry.key, entry.value)
        self._watch = watch
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def _loop(self) -> None:
        async for ev in self._watch:
            try:
                if ev.type == EventType.PUT and ev.value is not None:
                    await self._on_put(ev.key, ev.value)
                elif ev.type == EventType.DELETE:
                    await self._on_delete(ev.key)
            except Exception:
                logger.exception("model watcher failed handling %s %s", ev.type, ev.key)

    async def _on_put(self, key: str, value: bytes) -> None:
        entry = ModelEntry.from_json(value)
        self._entries_by_key[key] = entry
        n = self._refcount.get(entry.name, 0)
        self._refcount[entry.name] = n + 1
        if n == 0:
            engine = await self.engine_factory(entry)
            self.manager.add_model(entry.card.model_type, entry.name, engine)
            self.manager._entries[entry.name] = entry
            logger.info("model added: %s (%s) via %s/%s/%s", entry.name, entry.card.model_type, entry.namespace, entry.component, entry.endpoint)

    async def _on_delete(self, key: str) -> None:
        entry = self._entries_by_key.pop(key, None)
        if entry is None:
            return
        n = self._refcount.get(entry.name, 1) - 1
        self._refcount[entry.name] = n
        if n <= 0:
            self.manager.remove_model(entry.card.model_type, entry.name)
            self.manager._entries.pop(entry.name, None)
            self._refcount.pop(entry.name, None)
            logger.info("model removed: %s", entry.name)

    async def stop(self) -> None:
        if self._task:
            await self._watch.cancel()
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
