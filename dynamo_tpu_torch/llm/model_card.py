"""ModelDeploymentCard: the per-model record published to discovery.

A copy of the JAX package's ``llm/model_card.py``, with the same fields and
JSON, so a frontend of either package reads a worker of either: tokenizer,
chat template, context length, KV block size, ``migration_limit``, output
parsers; stored in the KV store under ``models/`` and watched by
frontends (``llm/discovery.py``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

MODEL_ROOT_PATH = "models"


@dataclass
class ModelDeploymentCard:
    name: str
    model_type: str = "chat"  # chat | completions | embeddings
    tokenizer_path: Optional[str] = None
    chat_template: Optional[str] = None
    context_length: int = 8192
    kv_cache_block_size: int = 16
    migration_limit: int = 0
    # Output parsers (``llm/parsers`` registry names; None = defaults).
    tool_call_parser: Optional[str] = None
    reasoning_parser: Optional[str] = None
    runtime_config: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "ModelDeploymentCard":
        return cls(**json.loads(raw))


@dataclass
class ModelEntry:
    """Discovery record: model name → serving endpoint + card."""

    name: str
    namespace: str
    component: str
    endpoint: str
    card: ModelDeploymentCard

    @property
    def store_key(self) -> str:
        return f"{MODEL_ROOT_PATH}/{self.namespace}/{self.component}/{self.endpoint}/{self.name}"

    def to_json(self) -> bytes:
        return json.dumps(
            {
                "name": self.name,
                "namespace": self.namespace,
                "component": self.component,
                "endpoint": self.endpoint,
                "card": self.card.__dict__,
            }
        ).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "ModelEntry":
        d = json.loads(raw)
        return cls(
            name=d["name"],
            namespace=d["namespace"],
            component=d["component"],
            endpoint=d["endpoint"],
            card=ModelDeploymentCard(**d["card"]),
        )
