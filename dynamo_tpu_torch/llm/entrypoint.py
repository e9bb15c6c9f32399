"""Pipeline assembly: preprocessor → backend → engine in one process."""

from __future__ import annotations

from typing import Optional

from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.pipeline import link


def build_local_pipeline(tokenizer: Tokenizer, engine: AsyncEngine, *, tool_call_parser: Optional[str] = None,
                         reasoning_parser: Optional[str] = None) -> AsyncEngine:
    """Aggregated in-process pipeline: OpenAI body → token ids → engine →
    detokenized text frames. Guided decoding needs the served tokenizer on
    the engine's side (token-FSM lifting): it is attached unless the engine
    has one. ``tool_call_parser`` / ``reasoning_parser`` name the model's
    output parsers (llm/parsers), which the JAX package reads from a model
    card; the port has no model card yet, so ``run`` passes neither."""
    if hasattr(engine, "attach_guided_tokenizer") and getattr(engine.scheduler, "guided", None) is None:
        engine.attach_guided_tokenizer(tokenizer)
    pre = OpenAIPreprocessor(tokenizer, tool_call_parser=tool_call_parser, reasoning_parser=reasoning_parser)
    return link([pre, Backend(tokenizer)], engine)
