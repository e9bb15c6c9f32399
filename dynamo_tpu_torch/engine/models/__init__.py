"""Model forward passes over the paged KV cache, one module a family.

Each family's module exposes ``prefill``, ``decode`` and ``decode_multi``
with the same paged-cache signature, so the scheduler, the prefix cache,
KVBM and disaggregation drive any family the same way; the llama module
adds the paths only it has (``decode_sample``, ``chunk_decode``,
``mixed_step`` and the fused windows), which the scheduler checks for by
name, as the JAX package's does."""

from dynamo_tpu_torch.engine.config import ModelConfig


def get_module(config: ModelConfig):
    if config.architecture == "llama":
        from dynamo_tpu_torch.engine.models import llama

        return llama
    if config.architecture == "mla":
        from dynamo_tpu_torch.engine.models import mla

        return mla
    raise ValueError(f"unknown architecture {config.architecture!r}")
