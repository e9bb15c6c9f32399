"""Embedding engine: serves ``/v1/embeddings`` on the served model's weights.

The counterpart of the JAX package's ``engine/embeddings.py``: each input
runs ``llama.embed`` at a bucketed length (``[32, 128, 512, min(2048,
max_seq_len)]``), truncated to the last bucket, one sequence at a time,
off the event loop.
"""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator, List

import torch

from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.models import llama
from dynamo_tpu_torch.engine.scheduler import next_bucket
from dynamo_tpu_torch.runtime.engine import Context


class EmbeddingEngine:
    """AsyncEngine over ``llama.embed``. Request wire: ``{"token_ids":
    [...]}`` or ``{"batch_token_ids": [[...], ...]}``; one response frame
    ``{"embeddings": [[...]], "prompt_tokens", "finish_reason": "stop",
    "token_ids": [], "index": 0}``. Runs where ``params`` live."""

    def __init__(self, config: ModelConfig, params):
        self.config = config
        self.params = params
        self.buckets = [32, 128, 512, min(2048, config.max_seq_len)]
        self.device = params["embed"].device

    def embed_one(self, ids: List[int]) -> List[float]:
        ids = ids[: min(self.config.max_seq_len, self.buckets[-1])]
        bucket = next_bucket(len(ids), self.buckets)
        padded = torch.zeros(bucket, dtype=torch.int32)
        padded[: len(ids)] = torch.tensor(ids, dtype=torch.int32)
        out = llama.embed(self.params, self.config, padded.to(self.device), len(ids))
        return out.cpu().tolist()

    async def generate(self, request: Any, context: Context) -> AsyncIterator[dict]:
        batches = request.get("batch_token_ids")
        if batches is None:
            batches = [request.get("token_ids") or []]
        embeddings = []
        for ids in batches:
            embeddings.append(await asyncio.to_thread(self.embed_one, list(ids)))
        yield {
            "embeddings": embeddings,
            "prompt_tokens": sum(len(b) for b in batches),
            "finish_reason": "stop",
            "token_ids": [],
            "index": 0,
        }
