"""``/v1/embeddings`` in the port against the JAX package, on ``tiny``
(f32, CPU): ``llama.embed`` against JAX's at 2e-4 (norm 1, padding
ignored), the ``EmbeddingEngine`` frame equal to JAX's (the same keys,
token counts and truncation to the last bucket), and the HTTP bodies for
a string, strings, token ids and lists of them shaped as the JAX
service's (its aiohttp server in the same loop), with the same 400 and
404 answers."""

from __future__ import annotations

import asyncio
import http.client
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.embeddings import EmbeddingEngine as JaxEmbeddingEngine
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.llm.discovery import ModelManager as JaxModelManager
from dynamo_tpu.llm.entrypoint import build_embeddings_pipeline as jax_embeddings_pipeline
from dynamo_tpu.llm.http.service import HttpService as JaxHttpService
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.embeddings import EmbeddingEngine
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.discovery import ModelManager
from dynamo_tpu_torch.llm.entrypoint import build_embeddings_pipeline
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.runtime.engine import Context

TCFG = get_config("tiny")
JCFG = jax_config("tiny")
TOL = dict(rtol=2e-4, atol=2e-4)
MODEL = "tiny-embed"


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("valid,bucket", [(5, 32), (20, 32), (100, 128)])
def test_embed_matches_jax(weights, valid, bucket):
    jp, tp = weights
    ids = np.random.default_rng(valid).integers(1, 255, size=bucket).astype(np.int32)
    want = np.asarray(jax.jit(lambda p, t, n: jllama.embed(p, JCFG, t, n))(jp, jnp.asarray(ids), jnp.int32(valid)))
    got = tllama.embed(tp, TCFG, torch.from_numpy(ids), valid)
    assert got.dtype == torch.float32 and tuple(got.shape) == (TCFG.hidden_size,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert abs(float(torch.linalg.vector_norm(got)) - 1.0) < 1e-5
    # The padding past valid_len does not move it.
    ids2 = ids.copy()
    ids2[valid:] = 99
    np.testing.assert_allclose(tllama.embed(tp, TCFG, torch.from_numpy(ids2), valid).numpy(), got.numpy(),
                               rtol=1e-5, atol=1e-5)


async def test_engine_frame_equals_jax(weights):
    jp, tp = weights
    port, jax_engine = EmbeddingEngine(TCFG, tp), JaxEmbeddingEngine(JCFG, jp)
    assert port.buckets == jax_engine.buckets == [32, 128, 512, 256]
    rng = np.random.default_rng(1)
    # The 300-id input is cut to the last bucket's 256, as JAX cuts it.
    for request in ({"token_ids": rng.integers(1, 255, size=7).tolist()},
                    {"batch_token_ids": [rng.integers(1, 255, size=n).tolist() for n in (3, 40, 300)]}):
        [got] = [f async for f in port.generate(request, Context())]
        [want] = [f async for f in jax_engine.generate(request, JaxContext())]
        assert set(got) == set(want) and {k: got[k] for k in got if k != "embeddings"} == {
            k: want[k] for k in want if k != "embeddings"}
        np.testing.assert_allclose(np.array(got["embeddings"]), np.array(want["embeddings"]), **TOL)
    # An input's vector alone and inside a list is bit-equal.
    ids = rng.integers(1, 255, size=50).tolist()
    [alone] = [f async for f in port.generate({"token_ids": ids}, Context())]
    [listed] = [f async for f in port.generate({"batch_token_ids": [[5, 6], ids]}, Context())]
    assert alone["embeddings"][0] == listed["embeddings"][1]


def _post(port, body, path="/v1/embeddings"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


BODIES = [
    {"model": MODEL, "input": "hello world"},
    {"model": MODEL, "input": ["hello world", "goodbye", "a third, longer string of text"]},
    {"model": MODEL, "input": [104, 105, 33]},
    {"model": MODEL, "input": [[104, 105], [1, 2, 3, 4, 5], [200]]},
    {"model": "nope", "input": "x"},
    {"model": MODEL, "input": []},
    {"model": MODEL, "input": [1, "mixed"]},
    {"input": "no model"},
]


async def test_http_bodies_shaped_as_jax(weights):
    jp, tp = weights
    manager = ModelManager()
    manager.add_model("embeddings", MODEL, build_embeddings_pipeline(ByteTokenizer(), EmbeddingEngine(TCFG, tp)))
    jmanager = JaxModelManager()
    jmanager.add_model("embeddings", MODEL, jax_embeddings_pipeline(JaxByteTokenizer(), JaxEmbeddingEngine(JCFG, jp)))
    service = HttpService(manager, host="127.0.0.1", port=0)
    jservice = JaxHttpService(jmanager, host="127.0.0.1", port=0)
    await service.start()
    await jservice.start()
    try:
        for body in BODIES:
            status, got = await asyncio.to_thread(_post, service.port, body)
            jstatus, want = await asyncio.to_thread(_post, jservice.port, body)
            assert status == jstatus, (body, got, want)
            if status != 200:
                assert got == want, body
                continue
            assert got["id"].startswith("embd") and want["id"].startswith("embd")
            assert {k: v for k, v in got.items() if k not in ("id", "data")} == {
                k: v for k, v in want.items() if k not in ("id", "data")}
            assert [{k: v for k, v in d.items() if k != "embedding"} for d in got["data"]] == [
                {k: v for k, v in d.items() if k != "embedding"} for d in want["data"]]
            np.testing.assert_allclose(np.array([d["embedding"] for d in got["data"]]),
                                       np.array([d["embedding"] for d in want["data"]]), **TOL)
    finally:
        await service.stop()
        await jservice.stop()
