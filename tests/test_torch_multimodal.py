"""Image prompts in the port (``llm/multimodal.py``, the scheduler's and
``llama.prefill``'s feature injection) against the JAX package, on
``tiny`` (f32, CPU) with ``tiny-vit`` features:

1. ``extract_images`` and the feature wire equal JAX's; each package's
   ``EncodeOperator`` reads the other's ``EncodeWorkerHandler`` frame, and
   the port's ``LocalVisionEncoder`` gives JAX's features for the same
   weights.
2. ``prefill(mm_feats=)`` logits and KV match JAX's at 2e-4 on the
   megakernel, per-piece (paged + flash) and gather routes, with the image
   rows split across two chunks.
3. The port's scheduler gives the JAX scheduler's greedy ids at one step
   and at 8-step windows; a repeat of an image request shows no prefix
   hit on either; oversized features and a non-llama model are refused,
   as ``tests/test_multimodal.py:155``.
4. HTTP: the two-worker encode topology over the port's runtime (the
   encode worker served on the wire) answers with the JAX pipeline's text;
   an image with no encode path, and an image the reader refuses, are
   400s.
5. An image request through the port's prefill/decode pair gives the
   aggregated engine's ids (the request dict, ``multimodal`` included,
   rides to the prefill worker as in JAX ``llm/disagg.py:571``).
"""

from __future__ import annotations

import asyncio
import base64
import http.client
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.engine import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.kv_cache import KvCacheArrays as JaxCache
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.models import vision as jvision
from dynamo_tpu.engine.sampling import SamplingParams as JaxSampling
from dynamo_tpu.llm import multimodal as jmm
from dynamo_tpu.llm.entrypoint import build_local_pipeline as jax_pipeline
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.models import vision as tvision
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.weights import init_params, params_from_numpy
from dynamo_tpu_torch.llm import disagg
from dynamo_tpu_torch.llm import multimodal as tmm
from dynamo_tpu_torch.llm.discovery import ModelManager
from dynamo_tpu_torch.llm.entrypoint import build_local_pipeline
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.push_router import PushRouter

TCFG = get_config("tiny")
JCFG = jax_config("tiny")
VIT = "tiny-vit"
TOL = dict(rtol=2e-4, atol=2e-4)
SCHED = dict(num_blocks=64, max_running=4, prefill_buckets=[16, 32, 64], decode_buckets=[4])
MODEL = "tiny-mm"


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, device="cpu", dtype=torch.float32)
    jv = jvision.init_params(jvision.PRESETS[VIT], jax.random.PRNGKey(5), dtype=jnp.float32)
    tv = tvision.params_from_numpy(jax.tree_util.tree_map(np.asarray, jv), tvision.PRESETS[VIT], device="cpu",
                                   dtype=torch.float32)
    return jp, tp, jv, tv


def _data_url(color, size=32) -> str:
    buf = io.BytesIO()
    Image.new("RGB", (size, size), color).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def _encoders(weights):
    _, _, jv, tv = weights
    return (jmm.LocalVisionEncoder(params=jv, preset=VIT),
            tmm.LocalVisionEncoder(params=tv, preset=VIT, device="cpu"))


# ---------------------------------------------------------------------------
# 1. Parts, wire and frames
# ---------------------------------------------------------------------------


def test_extract_images_and_wire_equal_jax():
    url = _data_url("red")
    messages = [{"role": "user", "content": [{"type": "text", "text": "what is "},
                                              {"type": "image_url", "image_url": {"url": url}},
                                              {"type": "input_text", "text": "this?"}, "junk"]},
                {"role": "assistant", "content": "plain string survives"}]
    assert tmm.extract_images(messages) == jmm.extract_images(messages)
    for bad in ([{"role": "user", "content": [{"type": "image_url", "image_url": {}}]}],):
        with pytest.raises(ValueError, match="missing url"):
            tmm.extract_images(bad)
    feats = np.random.default_rng(0).normal(size=(7, 5)).astype(np.float32)
    assert tmm.features_to_wire(feats) == jmm.features_to_wire(feats)
    np.testing.assert_array_equal(tmm.features_from_wire(jmm.features_to_wire(feats)), feats)
    np.testing.assert_array_equal(jmm.features_from_wire(tmm.features_to_wire(feats)), feats)


class _Frames:
    """A client that answers every call with one handler's frames."""

    def __init__(self, handler, ctx_cls):
        self.handler, self.ctx_cls = handler, ctx_cls

    async def generate(self, request, context=None):
        async for frame in self.handler.generate(request, self.ctx_cls()):
            yield frame


async def test_encode_frames_cross_read(weights):
    jenc, tenc = _encoders(weights)
    urls = [_data_url("red"), _data_url((10, 200, 30))]
    want = jenc.encode_urls(urls)
    got = tenc.encode_urls(urls)
    assert got.shape == want.shape == (2 * tvision.PRESETS[VIT].num_patches, TCFG.hidden_size)
    np.testing.assert_allclose(got, want, **TOL)
    req = {"token_ids": [5, 6, 7], "_mm_image_urls": urls}
    # The port's operator over the JAX worker's frame, and the JAX operator
    # over the port worker's.
    port_side = await tmm.EncodeOperator(client=_Frames(jmm.EncodeWorkerHandler(jenc), JaxContext)).transform_request(
        dict(req), Context())
    jax_side = await jmm.EncodeOperator(client=_Frames(tmm.EncodeWorkerHandler(tenc), Context)).transform_request(
        dict(req), JaxContext())
    n = want.shape[0]
    for out in (port_side, jax_side):
        assert out["token_ids"] == [tmm.IMAGE_PLACEHOLDER_TOKEN] * n + [5, 6, 7] and "_mm_image_urls" not in out
    np.testing.assert_array_equal(tmm.features_from_wire(port_side["multimodal"]), want)
    np.testing.assert_allclose(jmm.features_from_wire(jax_side["multimodal"]), want, **TOL)
    handler = tmm.EncodeWorkerHandler(tenc)
    [frame] = [f async for f in handler.generate({"image_urls": urls[:1]}, Context())]
    assert set(frame) == {"features_b64", "shape"} and handler.stats_handler() == {"request_total": 1}
    with pytest.raises(ValueError, match="no image_urls"):
        [f async for f in handler.generate({}, Context())]
    with pytest.raises(ValueError, match="exactly one"):
        tmm.EncodeOperator()


# ---------------------------------------------------------------------------
# 2. prefill(mm_feats=) on every route
# ---------------------------------------------------------------------------

IMPLS = {"megakernel": ("megakernel", "auto", False), "paged+flash": ("paged", "flash", True),
         "gather+xla": ("gather", "xla", False)}


@pytest.mark.parametrize("impl", list(IMPLS))
def test_prefill_mm_feats_matches_jax(weights, impl):
    """A 40-token prompt whose first 20 positions are image rows, in two
    chunks (16, then 24 over the cached 16): logits and the written KV."""
    jp, tp = weights[:2]
    attn, pre, flash = IMPLS[impl]
    jcfg, tcfg = JCFG.replace(attention_impl=attn, prefill_impl=pre), TCFG.replace(attention_impl=attn,
                                                                                     prefill_impl=pre)
    jc, tc = JaxCache.create(jcfg, 16, dtype=jnp.float32), KvCacheArrays.create(tcfg, 16, dtype=torch.float32,
                                                                              device="cpu")
    jk, jv, tk, tv = jc.k, jc.v, tc.k, tc.v
    rng = np.random.default_rng(2)
    prompt = [0] * 20 + rng.integers(1, 255, size=20).tolist()
    F = 20
    feats = np.zeros((32, TCFG.hidden_size), np.float32)  # padded as the JAX scheduler pads
    feats[:F] = rng.normal(size=(F, TCFG.hidden_size))
    table = np.array([1, 2, 3, 0], np.int32)
    for start, n, bucket in ((0, 16, 16), (16, 24, 32)):
        padded = np.zeros(bucket, np.int32)
        padded[:n] = prompt[start:start + n]
        kw = dict(use_flash=True, has_prefix=start > 0) if flash else {}
        jl, jk, jv = jax.jit(lambda p, k, v: jllama.prefill(
            p, jcfg, k, v, jnp.asarray(padded), jnp.int32(n), jnp.int32(start), jnp.asarray(table),
            mm_feats=jnp.asarray(feats), mm_len=jnp.int32(F), **kw))(jp, jk, jv)
        tl, tk, tv = tllama.prefill(tp, tcfg, tk, tv, torch.from_numpy(padded), n, start, torch.from_numpy(table),
                                    mm_feats=torch.from_numpy(feats), mm_len=F, **kw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tk[:, 1:].numpy(), np.asarray(jk)[:, 1:], atol=2e-5)
    np.testing.assert_allclose(tv[:, 1:].numpy(), np.asarray(jv)[:, 1:], atol=2e-5)
    # The features moved the logits: the same ids without them differ.
    fresh = KvCacheArrays.create(tcfg, 16, dtype=torch.float32, device="cpu")
    padded = np.zeros(16, np.int32)
    padded[:16] = prompt[:16]
    kw = dict(use_flash=True, has_prefix=False) if flash else {}
    with_f = tllama.prefill(tp, tcfg, fresh.k, fresh.v, torch.from_numpy(padded), 16, 0, torch.from_numpy(table),
                            mm_feats=torch.from_numpy(feats), mm_len=F, **kw)[0]
    without = tllama.prefill(tp, tcfg, fresh.k, fresh.v, torch.from_numpy(padded), 16, 0, torch.from_numpy(table),
                             **kw)[0]
    assert not torch.allclose(with_f, without)


# ---------------------------------------------------------------------------
# 3. The scheduler
# ---------------------------------------------------------------------------


def _mm_trace(weights):
    """(arrival step, id, prompt, max_tokens, features): A and C carry the
    same image (C repeats A), B and D text, D sharing B's first block."""
    jenc, _ = _encoders(weights)
    img = jenc.encode_urls([_data_url((200, 40, 90))])
    rng = np.random.default_rng(3)
    text_a = rng.integers(1, 255, size=12).tolist()
    b = rng.integers(1, 255, size=20).tolist()
    n = img.shape[0]
    return [
        (0, "A", [0] * n + text_a, 11, img),
        (1, "B", b, 10, None),
        (30, "C", [0] * n + text_a, 11, img),
        (30, "D", b[:16] + rng.integers(1, 255, size=6).tolist(), 5, None),
    ]


def _replay(sched, mod, sampling_cls, trace):
    outs = {}
    for step in range(300):
        for at, rid, prompt, max_tokens, feats in trace:
            if at == step:
                sched.add_request(rid, prompt, sampling_cls(temperature=0.0),
                                  mod.StopConditions(max_tokens=max_tokens), mm_features=feats)
        if step > trace[-1][0] and not sched.has_work():
            break
        for seq, out in sched.step():
            outs.setdefault(seq.request_id, []).append(out)
    assert not sched.has_work()
    return {rid: {"tokens": [o.token_id for o in res if o.token_id >= 0],
                  "cached": [o.cached_tokens for o in res if o.cached_tokens is not None]}
            for rid, res in outs.items()}


@pytest.mark.parametrize("steps", [1, 8])
def test_scheduler_mm_matches_jax(weights, steps):
    jp, tp = weights[:2]
    trace = _mm_trace(weights)
    j = jsched.Scheduler(JCFG.replace(attention_impl="megakernel"), jp,
                         jsched.SchedulerConfig(num_scheduler_steps=steps, **SCHED), dtype=jnp.float32,
                         eos_token_ids=[0])
    t = tsched.Scheduler(TCFG, tp, tsched.SchedulerConfig(num_scheduler_steps=steps, **SCHED), dtype=torch.float32,
                         device="cpu", eos_token_ids=[0])
    want = _replay(j, jsched, JaxSampling, trace)
    got = _replay(t, tsched, SamplingParams, trace)
    assert got == want
    assert got["C"]["cached"] == [0] and got["D"]["cached"] == [16]
    assert got["A"]["tokens"] == got["C"]["tokens"]
    assert t.mixed_steps_total == j.mixed_steps_total
    if steps == 8:
        assert t.fused_windows_total > 0


def test_oversized_features_and_non_llama_refused(weights):
    tp = weights[1]
    t = tsched.Scheduler(TCFG, tp, tsched.SchedulerConfig(num_blocks=32), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="more multimodal feature rows"):
        t.add_request("r", [1, 2], SamplingParams(), tsched.StopConditions(max_tokens=2),
                      mm_features=np.zeros((5, TCFG.hidden_size), np.float32))
    mla = get_config("tiny-mla")
    m = tsched.Scheduler(mla, init_params(mla, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32),
                         tsched.SchedulerConfig(num_blocks=32), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="llama prefill path"):
        m.add_request("r", [1, 2], SamplingParams(), tsched.StopConditions(max_tokens=2),
                      mm_features=np.zeros((1, mla.hidden_size), np.float32))


# ---------------------------------------------------------------------------
# 4. HTTP
# ---------------------------------------------------------------------------


def _chat(port, url, text="describe"):
    body = {"model": MODEL, "max_tokens": 6, "temperature": 0,
            "messages": [{"role": "user", "content": [{"type": "image_url", "image_url": {"url": url}},
                                                       {"type": "text", "text": text}]}]}
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    return resp.status, data


def _port_engine(weights):
    return TorchEngine.build(EngineArgs(model="tiny", dtype="float32", device="cpu",
                                        scheduler=tsched.SchedulerConfig(num_blocks=128, **{
                                            k: v for k, v in SCHED.items() if k != "num_blocks"})),
                             params=weights[1])


async def _jax_texts(weights, urls):
    jenc, _ = _encoders(weights)
    engine = TpuEngine.build(JaxEngineArgs(model="tiny", dtype="float32", continuous_profiling=False,
                                           scheduler=jsched.SchedulerConfig(num_blocks=128, **{
                                               k: v for k, v in SCHED.items() if k != "num_blocks"})),
                             params=weights[0])
    pipeline = jax_pipeline(JaxByteTokenizer(), engine, encoder=jenc)
    texts = []
    try:
        for url in urls:
            body = {"model": MODEL, "max_tokens": 6, "temperature": 0,
                    "messages": [{"role": "user", "content": [{"type": "image_url", "image_url": {"url": url}},
                                                               {"type": "text", "text": "describe"}]}]}
            parts = []
            async for item in pipeline.generate(body, JaxContext()):
                data = getattr(item, "data", None)
                if data:
                    parts.append(data.get("text") or "")
            texts.append("".join(parts))
    finally:
        await engine.stop()
    return texts


async def test_encode_worker_topology_matches_jax(weights):
    urls = [_data_url("red"), _data_url("blue")]
    want = await _jax_texts(weights, urls)
    drt = await DistributedRuntime.detached()
    engine = _port_engine(weights)
    service = None
    try:
        _, tenc = _encoders(weights)
        handler = tmm.EncodeWorkerHandler(tenc)
        ep = drt.namespace("mmtest").component("encode").endpoint("generate")
        handle = await ep.serve_endpoint(handler.generate, stats_handler=handler.stats_handler)
        drt.local_engines.pop(handle.instance.instance_id)  # over the wire, not in process
        client = await ep.client()
        await client.wait_for_instances(1, timeout=5)
        manager = ModelManager()
        manager.add_model("chat", MODEL, build_local_pipeline(ByteTokenizer(), engine,
                                                              encode_client=PushRouter(client)))
        service = HttpService(manager, host="127.0.0.1", port=0)
        await service.start()
        got = []
        for url in urls:
            status, data = await asyncio.to_thread(_chat, service.port, url)
            assert status == 200, data
            got.append(data["choices"][0]["message"]["content"])
            assert data["usage"]["prompt_tokens"] > tvision.PRESETS[VIT].num_patches
        assert got == want and got[0] != got[1]
        assert handler.requests_total == 2
        # An image the reader refuses comes back from the worker as a 400.
        gif = io.BytesIO()
        Image.new("RGB", (8, 8), "red").save(gif, "GIF")
        status, data = await asyncio.to_thread(
            _chat, service.port, "data:image/gif;base64," + base64.b64encode(gif.getvalue()).decode())
        assert status == 400 and "GIF" in data["error"]["message"]
    finally:
        if service is not None:
            await service.stop()
        await engine.stop()
        await drt.shutdown()


async def test_image_without_encode_path_is_400(weights):
    engine = _port_engine(weights)
    manager = ModelManager()
    manager.add_model("chat", MODEL, build_local_pipeline(ByteTokenizer(), engine))
    _, tenc = _encoders(weights)
    manager.add_model("chat", "with-encoder", build_local_pipeline(ByteTokenizer(), engine, encoder=tenc))
    service = HttpService(manager, host="127.0.0.1", port=0)
    await service.start()
    try:
        status, data = await asyncio.to_thread(_chat, service.port, _data_url("red"))
        assert status == 400
        assert data["error"]["message"] == ("request carries image content but no encode path is configured "
                                            "(frontend --encode-component / pipeline encoder)")
        assert engine.scheduler.request_total == 0
    finally:
        await service.stop()
        await engine.stop()


# ---------------------------------------------------------------------------
# 5. Through the prefill/decode pair
# ---------------------------------------------------------------------------


async def test_disagg_image_request_matches_aggregated(weights):
    jenc, _ = _encoders(weights)
    feats = jenc.encode_urls([_data_url((90, 30, 220))])
    request = {"token_ids": [0] * feats.shape[0] + list(range(40, 60)), "sampling_options": {"temperature": 0.0},
               "stop_conditions": {"max_tokens": 8}, "multimodal": tmm.features_to_wire(feats)}

    async def collect(engine_like):
        out = []
        async for frame in engine_like.generate(dict(request), Context()):
            data = frame.data if hasattr(frame, "data") else frame
            if data:
                out.extend(data.get("token_ids") or [])
        return out

    ref = _port_engine(weights)
    try:
        want = await collect(ref)
    finally:
        await ref.stop()
    drt = await DistributedRuntime.detached()
    prefill_engine, decode_engine = _port_engine(weights), _port_engine(weights)
    try:
        ep = drt.namespace("disagg").component("prefill").endpoint("generate")
        handle = await ep.serve_endpoint(prefill_engine.generate, stats_handler=prefill_engine.stats_handler)
        kvx = disagg.KvExportService(drt, prefill_engine, handle.instance)
        await kvx.start()
        drt.local_engines.pop(handle.instance.instance_id)
        client = await ep.client()
        await client.wait_for_instances(1, timeout=5)
        handler = disagg.DisaggDecodeHandler(drt, decode_engine, client, None, kv_transfer="host")
        got = await collect(handler)
        assert got == want and len(got) == 8
        assert handler.remote_prefills == 1 and prefill_engine.scheduler.exports_taken_total == 1
        await kvx.stop()
    finally:
        await prefill_engine.stop()
        await decode_engine.stop()
        await drt.shutdown()
