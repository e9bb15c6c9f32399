"""Pipeline assembly: preprocessor → backend → engine in one process."""

from __future__ import annotations

from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.tokenizer import Tokenizer
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.pipeline import link


def build_local_pipeline(tokenizer: Tokenizer, engine: AsyncEngine) -> AsyncEngine:
    """Aggregated in-process pipeline: OpenAI body → token ids → engine →
    detokenized text frames."""
    return link([OpenAIPreprocessor(tokenizer), Backend(tokenizer)], engine)
