"""Internal protocol types shared across the pipeline.

``PreprocessedRequest`` (the tokenized, template-rendered form the engine
consumes) and ``LLMEngineOutput`` (per-step engine emission). Kept as plain
dicts on the wire; these dataclasses are the typed construction layer. The
JAX package's wire keys, minus routing overrides and the disaggregation
parameters (the decode worker sets those on the wire itself).
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
    # Guided decoding: the normalized grammar spec (llm/guided) the
    # preprocessor builds from response_format / nvext guided_*.
    guided_decoding: Optional[Dict[str, Any]] = None
    # Image prompts: data URLs of the chat's image parts; the
    # EncodeOperator (llm/multimodal.py) turns them into features.
    image_urls: List[str] = field(default_factory=list)

    def to_wire(self) -> dict:
        d = {
            "token_ids": self.token_ids,
            "sampling_options": self.sampling_options,
            "stop_conditions": self.stop_conditions,
            "annotations": self.annotations,
            "model": self.model,
            "tenant": self.tenant,
        }
        if self.image_urls:
            d["_mm_image_urls"] = self.image_urls
        if self.guided_decoding:
            d["guided_decoding"] = self.guided_decoding
        return d


@dataclass
class LLMEngineOutput:
    """Per-step engine emission."""

    token_ids: List[int] = field(default_factory=list)
    text: Optional[str] = None  # set by the Backend detokenizer
    finish_reason: Optional[str] = None
    logprobs: Optional[List[float]] = None  # per-token chosen logprobs (aligned with token_ids)
    # Per-token top alternatives (OpenAI ``top_logprobs``): one
    # [[alt_token_id, logprob], ...] list per token_ids entry.
    top_logprobs: Optional[List[list]] = None
    index: int = 0
    # Set by the Backend's parser stage on the final frame (OpenAI wire shape).
    tool_calls: Optional[List[dict]] = None
    reasoning: Optional[str] = None  # reasoning_content delta

    def to_wire(self) -> dict:
        d: Dict[str, Any] = {"token_ids": self.token_ids, "index": self.index}
        if self.text is not None:
            d["text"] = self.text
        if self.finish_reason is not None:
            d["finish_reason"] = self.finish_reason
        if self.logprobs is not None:
            d["logprobs"] = self.logprobs
        if self.top_logprobs is not None:
            d["top_logprobs"] = self.top_logprobs
        if self.tool_calls is not None:
            d["tool_calls"] = self.tool_calls
        if self.reasoning is not None:
            d["reasoning"] = self.reasoning
        return d

    @classmethod
    def from_wire(cls, d: dict) -> "LLMEngineOutput":
        return cls(
            token_ids=list(d.get("token_ids") or []),
            text=d.get("text"),
            finish_reason=d.get("finish_reason"),
            logprobs=d.get("logprobs"),
            top_logprobs=d.get("top_logprobs"),
            index=d.get("index", 0),
            tool_calls=d.get("tool_calls"),
            reasoning=d.get("reasoning"),
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
