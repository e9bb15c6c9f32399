"""Internal protocol types shared across the pipeline.

``PreprocessedRequest`` (the tokenized, template-rendered form the engine
consumes) and ``LLMEngineOutput`` (per-step engine emission). Kept as plain
dicts on the wire; these dataclasses are the typed construction layer. The
JAX package's wire keys, minus the fields of features this port does not
have yet (disaggregation, multimodal, guided decoding, logprobs, tools).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from dynamo_tpu_torch.runtime.engine import Annotated


@dataclass
class PreprocessedRequest:
    """What the preprocessor hands the engine: token ids + sampling + stop
    conditions + annotations."""

    token_ids: List[int]
    sampling_options: Dict[str, Any] = field(default_factory=dict)
    stop_conditions: Dict[str, Any] = field(default_factory=dict)
    annotations: List[str] = field(default_factory=list)
    model: str = ""
    tenant: str = "anon"

    def to_wire(self) -> dict:
        return {
            "token_ids": self.token_ids,
            "sampling_options": self.sampling_options,
            "stop_conditions": self.stop_conditions,
            "annotations": self.annotations,
            "model": self.model,
            "tenant": self.tenant,
        }


@dataclass
class LLMEngineOutput:
    """Per-step engine emission."""

    token_ids: List[int] = field(default_factory=list)
    text: Optional[str] = None  # set by the Backend detokenizer
    finish_reason: Optional[str] = None
    index: int = 0

    def to_wire(self) -> dict:
        d: Dict[str, Any] = {"token_ids": self.token_ids, "index": self.index}
        if self.text is not None:
            d["text"] = self.text
        if self.finish_reason is not None:
            d["finish_reason"] = self.finish_reason
        return d

    @classmethod
    def from_wire(cls, d: dict) -> "LLMEngineOutput":
        return cls(
            token_ids=list(d.get("token_ids") or []),
            text=d.get("text"),
            finish_reason=d.get("finish_reason"),
            index=d.get("index", 0),
        )


def as_engine_output(item) -> Optional[LLMEngineOutput]:
    """Normalize a stream item (Annotated wrapper or wire dict) into an
    LLMEngineOutput; None for pure annotations."""
    if isinstance(item, Annotated):
        if item.data is None:
            return None
        return LLMEngineOutput.from_wire(item.data)
    if isinstance(item, dict):
        return LLMEngineOutput.from_wire(item)
    return None
