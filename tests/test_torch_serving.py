"""The port's serving path as a whole, against the JAX package.

1. Scheduler: the port's ``Scheduler`` and the JAX ``Scheduler`` (one
   decode step per iteration, overlapped decode on in both) replay one request
   trace with the same converted weights and the same attention
   configuration (megakernel; paged + flash; gather + xla): staggered
   arrivals, a prompt longer than ``mixed_prefill_budget`` (mixed steps),
   a shared prefix that hits the prefix cache, and a pool small enough to
   force a preemption, with wave admission on in both. Greedy token
   streams, finish reasons and cached tokens must be identical. A burst
   of short prompts is admitted in waves by both (``chunk_decode``), with
   a sampled row among them. With 8-step decode windows both schedulers
   replay a greedy trace through their fused windows, token for token, and
   a trace with a greedy, an unseeded sampled and a seeded top-k/top-p
   request through their fused sampled windows (threefry keys in both);
   on the port alone, a sampled row rides the fused window beside greedy
   rows, off the fused path it sends its batch to ``decode_multi`` (a
   seeded one to single steps), a stop inside a window trims the tokens
   after it, and every block comes back to the allocator.
2. HTTP: the port's server on port 0 (``tiny``, f32, CPU) answers chat
   (JSON and SSE) and completion requests with the text the JAX
   ``build_local_pipeline(ByteTokenizer(), TpuEngine)`` produces for the
   same body and weights; a sampled request with a ``seed`` gets the same
   answer twice; ``logprobs`` and ``frequency_penalty`` are served (the
   extras against JAX: test_torch_extras_serving.py) and malformed seeds
   refused.
3. Isolation: every module of ``dynamo_tpu_torch`` imports with ``jax``
   blocked and loads nothing of the JAX package, and no port file or
   ``chip_smoke.py`` names either in an import.
"""

import asyncio
import http.client
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.engine import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.sampling import SamplingParams as JaxSampling
from dynamo_tpu.llm.entrypoint import build_local_pipeline as jax_pipeline
from dynamo_tpu.llm.preprocessor import DEFAULT_CHAT_TEMPLATE as JAX_DEFAULT_CHAT_TEMPLATE
from dynamo_tpu.llm.preprocessor import PromptFormatter
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.entrypoint import build_local_pipeline
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.preprocessor import DEFAULT_CHAT_TEMPLATE, render_default_chat_template
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

REPO = Path(__file__).resolve().parent.parent
PORT_DIR = REPO / "dynamo_tpu_torch"
TCFG = get_config("tiny")
JCFG = jax_config("tiny")
BUCKETS = dict(prefill_buckets=[32, 64], decode_buckets=[1, 2, 4])


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_numpy(tree, TCFG, device="cpu", dtype=torch.float32)


# ---------------------------------------------------------------------------
# 1. Scheduler trace parity
# ---------------------------------------------------------------------------


def _trace():
    """(arrival step, request id, prompt, max_tokens). C shares A's first
    two blocks; B is longer than the mixed budget; the pool of 15 usable
    blocks cannot hold all four at their final lengths."""
    rng = np.random.default_rng(0)
    a = rng.integers(1, 255, size=40).tolist()
    return [
        (0, "A", a, 30),
        (2, "B", rng.integers(1, 255, size=80).tolist(), 20),
        (4, "C", a[:32] + rng.integers(1, 255, size=10).tolist(), 25),
        (6, "D", rng.integers(1, 255, size=20).tolist(), 40),
        (60, "E", a[:32] + rng.integers(1, 255, size=5).tolist(), 10),
    ]


def _replay(sched, mod, sampling_cls, trace=None, temps=None, stops=None, samplings=None):
    """Replay ``trace`` (default ``_trace()``), greedy unless ``temps``
    gives a request its temperature or ``samplings`` its sampling options;
    ``stops`` gives a request stop token ids."""
    trace = trace or _trace()
    temps, stops, samplings = temps or {}, stops or {}, samplings or {}
    outs = {}
    for step in range(400):
        for at, rid, prompt, max_tokens in trace:
            if at == step:
                opts = samplings.get(rid, {"temperature": temps.get(rid, 0.0)})
                sched.add_request(rid, prompt, sampling_cls(**opts),
                                  mod.StopConditions(max_tokens=max_tokens, stop_token_ids=stops.get(rid, [])))
        if step > trace[-1][0] and not sched.has_work():
            break
        for seq, out in sched.step():
            outs.setdefault(seq.request_id, []).append(out)
    assert not sched.has_work()
    return {
        rid: {
            "tokens": [o.token_id for o in res if o.token_id >= 0],
            "finish": [o.finish_reason for o in res if o.finished],
            "cached": [o.cached_tokens for o in res if o.cached_tokens is not None],
        }
        for rid, res in outs.items()
    }


# (attention_impl, prefill_impl) of each attention configuration.
IMPLS = {
    "megakernel": ("megakernel", "auto"),
    "paged+flash": ("paged", "flash"),
    "gather+xla": ("gather", "xla"),
}


@pytest.mark.parametrize("impl", list(IMPLS))
def test_scheduler_trace_matches_jax(weights, impl):
    jp, tp = weights
    attn, pre = IMPLS[impl]
    common = dict(num_blocks=16, max_running=4, mixed_prefill_budget=32, **BUCKETS)
    j = jsched.Scheduler(
        JCFG.replace(attention_impl=attn, prefill_impl=pre), jp,
        jsched.SchedulerConfig(num_scheduler_steps=1, **common),
        dtype=jnp.float32, eos_token_ids=[0],
    )
    t = tsched.Scheduler(TCFG.replace(attention_impl=attn, prefill_impl=pre), tp,
                         tsched.SchedulerConfig(num_scheduler_steps=1, **common), dtype=torch.float32,
                         device="cpu", eos_token_ids=[0])
    want = _replay(j, jsched, JaxSampling)
    got = _replay(t, tsched, SamplingParams)
    assert got == want
    assert t.preempt_total == j.preempt_total >= 1
    assert t.mixed_steps_total == j.mixed_steps_total > 0
    assert t.cached_tokens_total == j.cached_tokens_total > 0
    assert got["C"]["cached"] == [32]
    assert t._use_flash_prefill == j._use_flash_prefill == (pre == "flash")
    assert t.config_snapshot()["model"] == j.config_snapshot()["model"]
    assert t.prefill_steps_total + t.decode_steps_total + t.mixed_steps_total == t.forward_steps_total
    assert t.prefill_steps_total > 0 and t.decode_steps_total > 0


def _wave_trace():
    """A burst of four short prompts at step 0 (one wave), one sharing a
    block with the first so a later arrival hits the prefix cache, a
    sampled row among them, and a long prompt behind them that is not
    wave-eligible (longer than the wave's chunk cap), so it prefills alone."""
    rng = np.random.default_rng(4)
    a = rng.integers(1, 255, size=20).tolist()
    return [
        (0, "A", a, 12),
        (0, "B", rng.integers(1, 255, size=9).tolist(), 10),
        (0, "C", rng.integers(1, 255, size=30).tolist(), 14),
        (0, "D", rng.integers(1, 255, size=5).tolist(), 9),
        (1, "E", rng.integers(1, 255, size=100).tolist(), 6),
        (30, "F", a[:16] + rng.integers(1, 255, size=7).tolist(), 8),
        (30, "G", rng.integers(1, 255, size=12).tolist(), 8),
    ]


@pytest.mark.parametrize("impl", ["megakernel", "paged+flash"])
def test_wave_admission_matches_jax(weights, impl):
    """Both schedulers admit the burst as one wave (``chunk_decode`` with
    each row's last logits and one draw) and the later pair as another,
    and give the same tokens (B sampled), finish reasons and cached
    tokens; the waves count as forward and prefill steps."""
    jp, tp = weights
    attn, pre = IMPLS[impl]
    common = dict(num_blocks=64, max_running=8, mixed_prefill_budget=64, max_prefill_chunk=64, **BUCKETS)
    j = jsched.Scheduler(JCFG.replace(attention_impl=attn, prefill_impl=pre), jp,
                         jsched.SchedulerConfig(num_scheduler_steps=1, **common), dtype=jnp.float32, eos_token_ids=[0])
    t = tsched.Scheduler(TCFG.replace(attention_impl=attn, prefill_impl=pre), tp,
                         tsched.SchedulerConfig(num_scheduler_steps=1, **common), dtype=torch.float32,
                         device="cpu", eos_token_ids=[0])
    samplings = {"B": {"temperature": 0.9, "top_k": 30}}
    want = _replay(j, jsched, JaxSampling, _wave_trace(), samplings=samplings)
    got = _replay(t, tsched, SamplingParams, _wave_trace(), samplings=samplings)
    assert got == want
    assert t.wave_steps_total == j.flight._hists["wave"].total == 2
    assert got["F"]["cached"] == [16] and t._step_counter == j._step_counter
    assert t.prefill_steps_total + t.decode_steps_total + t.mixed_steps_total == t.forward_steps_total


def _window_trace():
    """Greedy requests for the window cases: (arrival step, request id,
    prompt, max_tokens). The budgets are not multiples of the 8-step
    window, so the last window of each request is trimmed; C arrives
    while A and B decode and rides mixed steps."""
    rng = np.random.default_rng(1)
    return [
        (0, "A", rng.integers(1, 255, size=20).tolist(), 24),
        (1, "B", rng.integers(1, 255, size=9).tolist(), 13),
        (4, "C", rng.integers(1, 255, size=40).tolist(), 19),
    ]


WINDOWS = dict(num_blocks=24, max_running=4, mixed_prefill_budget=32, num_scheduler_steps=8, **BUCKETS)


def _port_scheduler(tp, **overrides):
    return tsched.Scheduler(TCFG, tp, tsched.SchedulerConfig(**{**WINDOWS, **overrides}), dtype=torch.float32,
                            device="cpu", eos_token_ids=[0])


def test_window_scheduler_matches_jax(weights):
    jp, tp = weights
    j = jsched.Scheduler(JCFG.replace(attention_impl="megakernel"), jp,
                         jsched.SchedulerConfig(**WINDOWS),
                         dtype=jnp.float32, eos_token_ids=[0])
    t = _port_scheduler(tp)
    assert j._use_fused_window and t._use_fused_window
    want = _replay(j, jsched, JaxSampling, _window_trace())
    got = _replay(t, tsched, SamplingParams, _window_trace())
    assert got == want
    assert t.fused_windows_total == j.flight.fused_windows_total > 0
    assert t.multi_windows_total == t.window_steps_total == 0
    assert t.fused_sampled_windows_total == j.flight.fused_sampled_windows_total == 0


# (request id → sampling options) of the sampled window trace: A greedy, B
# unseeded at T = 0.8, C seeded with top-k and top-p.
SAMPLED = {"A": {"temperature": 0.0}, "B": {"temperature": 0.8},
           "C": {"temperature": 1.1, "top_k": 20, "top_p": 0.9, "seed": 1234}}


def _sampled_trace():
    """(arrival step, request id, prompt, max_tokens), at most 20 tokens
    each; C arrives while A and B decode, rides mixed steps and draws its
    first token from its seed."""
    rng = np.random.default_rng(2)
    return [
        (0, "A", rng.integers(1, 255, size=20).tolist(), 20),
        (1, "B", rng.integers(1, 255, size=9).tolist(), 14),
        (4, "C", rng.integers(1, 255, size=40).tolist(), 18),
    ]


def test_sampled_window_scheduler_matches_jax(weights):
    """Greedy, unseeded-sampled and seeded-sampled requests through both
    schedulers' fused windows (megakernel, 8-step windows): the same token
    streams, the same count of fused and fused sampled windows. Both draw
    first tokens and mixed steps from threefry keys off one step counter,
    and each sampled window from ``make_window_uniforms``."""
    jp, tp = weights
    j = jsched.Scheduler(JCFG.replace(attention_impl="megakernel"), jp,
                         jsched.SchedulerConfig(**WINDOWS),
                         dtype=jnp.float32, eos_token_ids=[0])
    t = _port_scheduler(tp)
    want = _replay(j, jsched, JaxSampling, _sampled_trace(), samplings=SAMPLED)
    got = _replay(t, tsched, SamplingParams, _sampled_trace(), samplings=SAMPLED)
    assert got == want
    assert t.fused_sampled_windows_total == j.flight.fused_sampled_windows_total > 0
    assert t.fused_windows_total == j.flight.fused_windows_total
    assert t.multi_windows_total == 0 and t._step_counter == j._step_counter


def test_windows_trim_route_sampled_batches_and_free_blocks(weights):
    _, tp = weights
    single = _replay(_port_scheduler(tp, num_scheduler_steps=1), tsched, SamplingParams, _window_trace())
    # A stop token inside a window: the tokens after it are trimmed.
    a = single["A"]["tokens"]
    stop = a[10]
    cut = a.index(stop) + 1
    t = _port_scheduler(tp)
    free0 = t.allocator.num_free
    got = _replay(t, tsched, SamplingParams, _window_trace(), stops={"A": [stop]})
    assert got["A"]["tokens"] == a[:cut] and got["A"]["finish"] == ["stop"]
    assert {rid: got[rid] for rid in "BC"} == {rid: single[rid] for rid in "BC"}
    assert t.fused_windows_total > 0 and t.multi_windows_total == 0
    assert t.allocator.num_free == free0
    # A sampled row rides the fused window with the greedy rows beside it,
    # which keep their tokens.
    t = _port_scheduler(tp)
    got = _replay(t, tsched, SamplingParams, _window_trace(), temps={"C": 0.8})
    assert {rid: got[rid] for rid in "AB"} == {rid: single[rid] for rid in "AB"}
    assert len(got["C"]["tokens"]) == 19 or got["C"]["finish"] == ["stop"]
    assert 0 < t.fused_sampled_windows_total < t.fused_windows_total
    assert t.multi_windows_total == t.window_steps_total == 0
    assert t.allocator.num_free == free0
    # Off the fused path (per-piece attention) a sampled row sends its batch
    # to decode_multi; a seeded sampled row sends it to single steps, whose
    # per-row keys honour the seed.
    paged = TCFG.replace(attention_impl="paged")
    t = tsched.Scheduler(paged, tp, tsched.SchedulerConfig(**WINDOWS), dtype=torch.float32, device="cpu",
                         eos_token_ids=[0])
    assert not t._use_fused_window
    _replay(t, tsched, SamplingParams, _window_trace(), temps={"C": 0.8})
    assert t.multi_windows_total > 0 and t.window_steps_total == 8 * t.multi_windows_total
    seeded = {"C": {"temperature": 0.8, "seed": 7}}
    t = tsched.Scheduler(paged, tp, tsched.SchedulerConfig(**WINDOWS), dtype=torch.float32, device="cpu",
                         eos_token_ids=[0])
    got = _replay(t, tsched, SamplingParams, _window_trace(), samplings=seeded)
    t1 = tsched.Scheduler(paged, tp, tsched.SchedulerConfig(**{**WINDOWS, "num_scheduler_steps": 1}),
                          dtype=torch.float32, device="cpu", eos_token_ids=[0])
    assert got["C"] == _replay(t1, tsched, SamplingParams, _window_trace(), samplings=seeded)["C"]
    assert t.multi_windows_total > 0 and t.decode_steps_total > 0 and t.allocator.num_free == free0


# ---------------------------------------------------------------------------
# 2. HTTP against the JAX pipeline
# ---------------------------------------------------------------------------


BODIES = [
    ("/v1/chat/completions", {"model": "tiny", "messages": [{"role": "system", "content": "be brief"},
                                                            {"role": "user", "content": "hello there"}],
                              "max_tokens": 12, "temperature": 0.0}),
    ("/v1/chat/completions", {"model": "tiny", "messages": [{"role": "user", "content": "stream me"}],
                              "max_tokens": 10, "temperature": 0.0, "stream": True}),
    ("/v1/completions", {"model": "tiny", "prompt": "The quick brown fox", "max_tokens": 9, "temperature": 0.0}),
    ("/v1/completions", {"model": "tiny", "prompt": "jumps over", "max_tokens": 7, "temperature": 0.0,
                         "stream": True}),
]


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw


def _text_of(path, body, raw):
    if not body.get("stream"):
        data = json.loads(raw)
        choice = data["choices"][0]
        text = choice["message"]["content"] if "chat" in path else choice["text"]
        return text, choice["finish_reason"], data["usage"]
    events = [ln[6:] for ln in raw.decode().split("\n\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    key = (lambda c: c["choices"][0]["delta"].get("content") or "") if "chat" in path else (
        lambda c: c["choices"][0]["text"])
    return "".join(key(c) for c in chunks), chunks[-1]["choices"][0]["finish_reason"], chunks[-1]["usage"]


async def _jax_texts(jp):
    engine = TpuEngine.build(
        JaxEngineArgs(model="tiny", dtype="float32", continuous_profiling=False, eos_token_ids=[0],
                      scheduler=jsched.SchedulerConfig(num_blocks=64, num_scheduler_steps=1, **BUCKETS)),
        params=jp,
    )
    pipeline = jax_pipeline(JaxByteTokenizer(), engine)
    texts = []
    try:
        for _, body in BODIES:
            parts, finish = [], None
            async for item in pipeline.generate(dict(body), JaxContext()):
                data = getattr(item, "data", None)
                if data:
                    parts.append(data.get("text") or "")
                    finish = data.get("finish_reason") or finish
            texts.append(("".join(parts), finish))
    finally:
        await engine.stop()
    return texts


async def _port_answers(tp):
    tok = ByteTokenizer()
    engine = TorchEngine.build(
        EngineArgs(model="tiny", dtype="float32", device="cpu", eos_token_ids=tok.eos_token_ids,
                   scheduler=tsched.SchedulerConfig(num_blocks=64, num_scheduler_steps=1, **BUCKETS)),
        params=tp,
    )
    service = HttpService({"tiny": build_local_pipeline(tok, engine)}, host="127.0.0.1", port=0)
    await service.start()
    try:
        answers = [await asyncio.to_thread(_post, service.port, path, body) for path, body in BODIES]
        misc = {
            "models": await asyncio.to_thread(_get, service.port, "/v1/models"),
            "health": await asyncio.to_thread(_get, service.port, "/health"),
            "unknown_model": await asyncio.to_thread(_post, service.port, "/v1/completions",
                                                     {"model": "nope", "prompt": "x"}),
            "bad_request": await asyncio.to_thread(_post, service.port, "/v1/chat/completions",
                                                   {"model": "tiny", "messages": []}),
            "logprobs_field": await asyncio.to_thread(_post, service.port, "/v1/chat/completions",
                                                      {"model": "tiny", "messages": [{"role": "user", "content": "x"}],
                                                       "logprobs": True, "max_tokens": 5}),
            "deadline": await asyncio.to_thread(_post, service.port, "/v1/completions",
                                                {"model": "tiny", "prompt": "late", "max_tokens": 50, "timeout": 0.001}),
            "wrong_method": await asyncio.to_thread(_raw, service.port, b"GET /v1/completions HTTP/1.1\r\n\r\n"),
            "no_route": await asyncio.to_thread(_raw, service.port, b"GET /v2/nothing HTTP/1.1\r\n\r\n"),
            "invalid_json": await asyncio.to_thread(
                _raw, service.port, b"POST /v1/completions HTTP/1.1\r\nContent-Length: 1\r\n\r\n{"),
            "chunked": await asyncio.to_thread(
                _raw, service.port, b"POST /v1/completions HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"),
            "malformed": await asyncio.to_thread(_raw, service.port, b"NONSENSE\r\n\r\n"),
        }
    finally:
        await service.stop()
        await engine.stop()
    return answers, misc


def _raw(port, request: bytes) -> int:
    """Send raw request bytes; returns the response's status code."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(request)
        head = s.recv(64)
    return int(head.split(b" ")[1])


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, json.loads(raw)


def test_http_server_matches_jax_pipeline(weights):
    jp, tp = weights
    want = asyncio.run(_jax_texts(jp))
    answers, misc = asyncio.run(_port_answers(tp))
    for (path, body), (status, raw), (text, finish) in zip(BODIES, answers, want):
        assert status == 200, raw
        got_text, got_finish, usage = _text_of(path, body, raw)
        assert (got_text, got_finish) == (text, finish), path
        assert usage["completion_tokens"] == body["max_tokens"] or got_finish == "stop"
        assert usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]
        assert usage["prompt_tokens_details"]["cached_tokens"] >= 0
    unary_chat = json.loads(answers[0][1])
    assert unary_chat["object"] == "chat.completion" and unary_chat["model"] == "tiny"
    assert unary_chat["choices"][0]["message"]["role"] == "assistant"
    assert misc["models"] == (200, misc["models"][1]) and misc["models"][1]["data"][0]["id"] == "tiny"
    assert misc["health"][1]["status"] == "healthy"
    assert misc["unknown_model"][0] == 404
    assert misc["bad_request"][0] == 400
    # logprobs are served: one entry per generated token.
    status, raw = misc["logprobs_field"]
    answer = json.loads(raw)
    assert status == 200 and len(answer["choices"][0]["logprobs"]["content"]) == answer["usage"]["completion_tokens"]
    assert all(e["logprob"] <= 0 for e in answer["choices"][0]["logprobs"]["content"])
    # A past-deadline request is evicted by the scheduler: 504 with partial usage.
    status, raw = misc["deadline"]
    assert status == 504 and json.loads(raw)["usage"]["completion_tokens"] < 50
    assert (misc["wrong_method"], misc["no_route"], misc["invalid_json"], misc["chunked"], misc["malformed"]) == (
        405, 404, 400, 411, 400)


async def _seeded_answers(tp):
    """A seeded sampled request answered twice by the port's server on its
    defaults (decode windows, the fused window's plain version on the
    CPU): alone, then in the second batch slot, beside a request that was
    already decoding when it arrived; then a penalised request, which is
    served, and malformed seeds, which are refused."""
    tok = ByteTokenizer()
    engine = TorchEngine.build(
        EngineArgs(model="tiny", dtype="float32", device="cpu", eos_token_ids=tok.eos_token_ids,
                   scheduler=tsched.SchedulerConfig(num_blocks=64, **BUCKETS)),
        params=tp,
    )
    service = HttpService({"tiny": build_local_pipeline(tok, engine)}, host="127.0.0.1", port=0)
    body = {"model": "tiny", "prompt": "a seeded draw", "max_tokens": 12, "temperature": 0.9, "top_p": 0.95,
            "seed": 31337}
    other = {"model": "tiny", "prompt": "a neighbour", "max_tokens": 150, "temperature": 0.0,
             "nvext": {"ignore_eos": True}}
    sched = engine.scheduler
    await service.start()
    try:
        first = await asyncio.to_thread(_post, service.port, "/v1/completions", body)
        neighbour = asyncio.ensure_future(asyncio.to_thread(_post, service.port, "/v1/completions", other))
        while not any(s.output_ids for s in sched.running):
            await asyncio.sleep(0.001)
        second = await asyncio.to_thread(_post, service.port, "/v1/completions", body)
        slots = sched.fused_sampled_windows_total
        neighbour = await neighbour
        refused = {
            name: await asyncio.to_thread(_post, service.port, "/v1/completions", {**body, **extra})
            for name, extra in (("frequency_penalty", {"frequency_penalty": 0.5}), ("big_seed", {"seed": 2**31}),
                                ("bool_seed", {"seed": True}), ("float_seed", {"seed": 1.5}))
        }
    finally:
        await service.stop()
        await engine.stop()
    return first, second, neighbour, refused, slots


def test_http_seed_is_honoured_and_unported_fields_refused(weights):
    _, tp = weights
    first, second, neighbour, refused, sampled_windows = asyncio.run(_seeded_answers(tp))
    assert first[0] == second[0] == neighbour[0] == 200
    body = {"stream": False}
    assert _text_of("/v1/completions", body, first[1]) == _text_of("/v1/completions", body, second[1])
    assert json.loads(neighbour[1])["usage"]["completion_tokens"] == 150  # still decoding beside it
    assert sampled_windows > 0  # the seeded rows rode fused sampled windows
    # A penalised request is served (single steps: penalties ride no window).
    status, raw = refused.pop("frequency_penalty")
    assert status == 200 and 0 < json.loads(raw)["usage"]["completion_tokens"] <= 12
    for name, (status, raw) in refused.items():
        assert status == 400, name
    assert b"seed" in refused["big_seed"][1]


def test_stop_string_jail_matches_jax():
    """The backend's stop-string jail emits, holds and stops exactly as the
    JAX package's on random deltas."""
    from dynamo_tpu.llm.backend import StopStringJail as JaxJail
    from dynamo_tpu_torch.llm.backend import StopStringJail

    rng = np.random.default_rng(0)
    alphabet = list("abcde")
    for _ in range(200):
        stops = ["".join(rng.choice(alphabet, size=int(rng.integers(1, 4)))) for _ in range(int(rng.integers(0, 3)))]
        mine, theirs = StopStringJail(stops), JaxJail(stops)
        for _ in range(int(rng.integers(1, 8))):
            delta = "".join(rng.choice(alphabet, size=int(rng.integers(1, 4))))
            got, want = mine.feed(delta), theirs.feed(delta)
            assert got == want, (stops, delta)
            if got[1]:
                break
        assert mine.flush() == theirs.flush()


def test_chat_template_matches_jax_formatter():
    messages = [{"role": "system", "content": "sys\nline"}, {"role": "user", "content": "héllo {{ x }}"},
                {"role": "assistant", "content": ""}, {"role": "user"}]
    assert DEFAULT_CHAT_TEMPLATE == JAX_DEFAULT_CHAT_TEMPLATE  # the template the plain renderer follows
    want = PromptFormatter().render(messages, add_generation_prompt=True)
    assert render_default_chat_template(messages, add_generation_prompt=True) == want
    assert render_default_chat_template(messages[:1], False) == PromptFormatter().render(messages[:1], False)


def test_build_service_carries_a_model_config():
    """``run.build_service`` hands a caller's model configuration (here the
    per-piece path) and scheduler configuration through ``EngineArgs`` to
    the scheduler; the defaults stay the preset's megakernel path and
    32-step decode windows."""
    from dynamo_tpu_torch import run

    args = run.parse_args(["in=http", "out=tiny", "--device", "cpu", "--dtype", "float32",
                           "--num-blocks", "8", "--http-port", "0"])
    per_piece = TCFG.replace(attention_impl="paged", prefill_impl="flash")
    _, engine = run.build_service(args, model_config=per_piece)
    assert engine.scheduler.mc is per_piece
    assert engine.scheduler.config_snapshot()["model"]["attention_impl"] == "paged"
    assert engine.scheduler._use_flash_prefill
    _, engine = run.build_service(args)
    assert engine.scheduler.config_snapshot()["model"]["attention_impl"] == "megakernel"
    assert not engine.scheduler._use_flash_prefill  # "auto" on the CPU
    assert engine.scheduler.sc.num_scheduler_steps == 32 and engine.scheduler._use_fused_window
    _, engine = run.build_service(args, scheduler_config=tsched.SchedulerConfig(num_scheduler_steps=1))
    assert engine.scheduler.sc.num_scheduler_steps == 1 and engine.scheduler.sc.num_blocks == 8
    assert not engine.scheduler._use_fused_window


def test_entry_points_default_to_cuda_and_refuse_without_it():
    from dynamo_tpu_torch import run

    assert EngineArgs().device == "cuda"
    assert run.parse_args(["in=http", "out=tiny"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchEngine.build(EngineArgs(model="tiny"))


# ---------------------------------------------------------------------------
# 3. The port stands alone
# ---------------------------------------------------------------------------


def _port_modules():
    mods = []
    for p in sorted(PORT_DIR.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_imports_without_jax_or_the_jax_package():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'dynamo_tpu' or n.startswith('dynamo_tpu.'))\n"
        "bad += sorted(n for n in sys.modules if (n == 'jax' or n.startswith('jax.')) and sys.modules[n] is not None)\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) == len(_port_modules()) > 15


_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|dynamo_tpu)(?:[.\s,]|$)", re.MULTILINE)


def test_no_port_file_names_jax_or_the_jax_package():
    files = sorted(PORT_DIR.rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [(str(f.relative_to(REPO)), m.group(0).strip()) for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not hits
    # The pattern matches the JAX package exactly, not the port's prefix.
    assert _FORBIDDEN.search("from dynamo_tpu.engine import x") and _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from dynamo_tpu_torch.engine import x")
