"""The per-request extras over HTTP: the port's server against the JAX
package's, on the same tiny f32 weights (one decode step per iteration on
both, the byte tokenizer).

Each body goes to both servers (the JAX ``HttpService`` over
``TpuEngine`` and the port's over ``TorchEngine``) and the answers must
agree: chat logprobs with ``top_logprobs``, unary and streamed;
completions ``logprobs: 3``; ``n = 3`` with a seed, unary and streamed
(choice i drawn with ``seed + i``, so the same choices); a ``logit_bias``
that steers a greedy answer; a forced ``tool_choice`` answered with
``tool_calls``; ``tools`` with ``tool_choice: "auto"`` passing through as
text. A second model on each server names its output parsers (``hermes``
tool calls, ``basic`` reasoning), as a model card names them to the JAX
pipeline: a grammar-shaped answer comes back split into
``reasoning_content`` and content, or into ``tool_calls``, unary and
streamed. The validation bodies of the JAX package's protocol tests (and its
tool-choice ones) are refused by the port's validators and server with
the JAX messages, word for word.
"""

import asyncio
import http.client
import json
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.engine import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.llm.discovery import ModelManager
from dynamo_tpu.llm.entrypoint import build_local_pipeline as jax_pipeline
from dynamo_tpu.llm.http.service import HttpService as JaxHttpService
from dynamo_tpu.llm.model_card import ModelDeploymentCard
from dynamo_tpu.llm.protocols import openai as joai
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.entrypoint import build_local_pipeline
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.protocols import openai as toai
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

TOL = 2e-4  # the f32 model tolerance of the port against JAX (test_llama_model.py)
MODEL = "tiny"
PARSED = "tiny-parsers"  # the same engine behind a pipeline with named output parsers
PARSERS = dict(tool_call_parser="hermes", reasoning_parser="basic")
SCHED = dict(num_blocks=64, num_scheduler_steps=1, prefill_buckets=[32, 64, 128], decode_buckets=[1, 2, 4, 8])
SCHEMA = {"type": "object", "properties": {"city": {"enum": ["SF", "NY"]}, "ok": {"type": "boolean"}},
          "required": ["city", "ok"]}
TOOLS = [{"type": "function", "function": {"name": "get_city", "parameters": SCHEMA}}]


class _Server:
    """An HTTP service on port 0, served from an event loop of its own in a
    thread, for the module's tests."""

    def __init__(self, make):
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever, daemon=True)
        self._thread.start()
        self.service, self.engine = self._run(make())

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(timeout=300)

    def close(self):
        async def stop():
            await self.service.stop()
            await self.engine.stop()

        self._run(stop())
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=30)
        assert not self._thread.is_alive()


@pytest.fixture(scope="module")
def servers():
    jcfg, tcfg = jax_config("tiny"), get_config("tiny")
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu", dtype=torch.float32)

    async def jax_side():
        engine = TpuEngine.build(JaxEngineArgs(model="tiny", dtype="float32", continuous_profiling=False,
                                               eos_token_ids=[0], scheduler=jsched.SchedulerConfig(**SCHED)),
                                 params=jp)
        manager = ModelManager()
        manager.add_model("chat", MODEL, jax_pipeline(JaxByteTokenizer(), engine))
        card = ModelDeploymentCard(name=PARSED, **PARSERS)
        manager.add_model("chat", PARSED, jax_pipeline(JaxByteTokenizer(), engine, card))
        service = JaxHttpService(manager, host="127.0.0.1", port=0)
        await service.start()
        return service, engine

    async def port_side():
        engine = TorchEngine.build(EngineArgs(model="tiny", dtype="float32", device="cpu", eos_token_ids=[0],
                                              scheduler=tsched.SchedulerConfig(**SCHED)), params=tp)
        service = HttpService({MODEL: build_local_pipeline(ByteTokenizer(), engine),
                               PARSED: build_local_pipeline(ByteTokenizer(), engine, **PARSERS)},
                              host="127.0.0.1", port=0)
        await service.start()
        return service, engine

    j, t = _Server(jax_side), _Server(port_side)
    yield j, t
    j.close()
    t.close()


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    if body.get("stream") and resp.status == 200:
        events = [ln[6:] for ln in raw.decode().split("\n\n") if ln.startswith("data: ")]
        assert events[-1] == "[DONE]"
        return resp.status, [json.loads(e) for e in events[:-1]]
    return resp.status, json.loads(raw)


def _both(servers, path, body, model=MODEL):
    """The JAX server's answer, then the port's."""
    return [_post(s.service.port, path, dict(body, model=model)) for s in servers]


def _chat(**kw):
    return {"messages": [{"role": "user", "content": "tell me about extras"}], "max_tokens": 10, **kw}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _chat_entries(choice_lps):
    """(tokens, logprobs, alternative ids, alternative logprobs) of a chat
    logprobs block."""
    content = choice_lps["content"]
    return ([e["token"] for e in content], [e["logprob"] for e in content],
            [[a["token"] for a in e["top_logprobs"]] for e in content],
            [[a["logprob"] for a in e["top_logprobs"]] for e in content])


def _same_chat_logprobs(got, want):
    g, w = _chat_entries(got), _chat_entries(want)
    assert g[0] == w[0] and g[2] == w[2]
    _close(g[1], w[1])
    _close(g[3], w[3])


def test_chat_logprobs_unary(servers):
    (js, jd), (ts, td) = _both(servers, "/v1/chat/completions", _chat(temperature=0.0, logprobs=True, top_logprobs=3))
    assert js == ts == 200, td
    jc, tc = jd["choices"][0], td["choices"][0]
    assert tc["message"] == jc["message"] and tc["finish_reason"] == jc["finish_reason"]
    assert len(tc["logprobs"]["content"]) == td["usage"]["completion_tokens"] == jd["usage"]["completion_tokens"]
    _same_chat_logprobs(tc["logprobs"], jc["logprobs"])
    for e in tc["logprobs"]["content"]:
        # Greedy: the chosen token is the best alternative.
        assert len(e["top_logprobs"]) == 3 and abs(e["top_logprobs"][0]["logprob"] - e["logprob"]) < 1e-6


def _stream_logprobs(chunks):
    lps, tops, text = [], [], ""
    for c in chunks:
        ch = c["choices"][0]
        text += (ch.get("delta") or {}).get("content") or ""
        for e in (ch.get("logprobs") or {}).get("content") or []:
            lps.append(e["logprob"])
            tops.append([a["token"] for a in e["top_logprobs"]])
    return text, lps, tops, chunks[-1]["choices"][0]["finish_reason"]


def test_chat_logprobs_streamed(servers):
    body = _chat(temperature=0.0, logprobs=True, top_logprobs=2, stream=True)
    (js, jd), (ts, td) = _both(servers, "/v1/chat/completions", body)
    assert js == ts == 200
    jt, tt = _stream_logprobs(jd), _stream_logprobs(td)
    assert (tt[0], tt[2], tt[3]) == (jt[0], jt[2], jt[3])
    _close(tt[1], jt[1])
    assert len(tt[1]) == 10 or tt[3] == "stop"


def test_completion_logprobs_count(servers):
    body = {"prompt": "logprobs for a completion", "max_tokens": 7, "temperature": 0.0, "logprobs": 3}
    (js, jd), (ts, td) = _both(servers, "/v1/completions", body)
    assert js == ts == 200
    jc, tc = jd["choices"][0], td["choices"][0]
    assert tc["text"] == jc["text"]
    jl, tl = jc["logprobs"], tc["logprobs"]
    assert tl["tokens"] == jl["tokens"] and len(tl["token_logprobs"]) == 7
    _close(tl["token_logprobs"], jl["token_logprobs"])
    assert [list(d) for d in tl["top_logprobs"]] == [list(d) for d in jl["top_logprobs"]]
    assert all(len(d) == 3 for d in tl["top_logprobs"])
    _close([list(d.values()) for d in tl["top_logprobs"]], [list(d.values()) for d in jl["top_logprobs"]])


def test_n_choices_unary_with_seed(servers):
    body = _chat(n=3, temperature=1.0, seed=123, max_tokens=12, nvext={"ignore_eos": True})
    (js, jd), (ts, td) = _both(servers, "/v1/chat/completions", body)
    assert js == ts == 200
    texts = [c["message"]["content"] for c in td["choices"]]
    assert [c["index"] for c in td["choices"]] == [0, 1, 2]
    assert texts == [c["message"]["content"] for c in jd["choices"]]
    assert len(set(texts)) > 1
    assert td["usage"]["completion_tokens"] == jd["usage"]["completion_tokens"] == 36
    # Choice i is the request with seed + i.
    (_, one), = [_post(servers[1].service.port, "/v1/chat/completions",
                       dict(body, model=MODEL, n=1, seed=124))]
    assert one["choices"][0]["message"]["content"] == texts[1]


def test_n_choices_streamed_with_seed(servers):
    body = {"prompt": "three streams", "max_tokens": 9, "temperature": 0.9, "seed": 7, "n": 3, "stream": True,
            "logprobs": 1, "nvext": {"ignore_eos": True}}
    (js, jd), (ts, td) = _both(servers, "/v1/completions", body)
    assert js == ts == 200

    def per_choice(chunks):
        out = {}
        for c in chunks:
            ch = c["choices"][0]
            text, lps, finish = out.get(ch["index"], ("", [], None))
            out[ch["index"]] = (text + ch["text"], lps + ((ch.get("logprobs") or {}).get("token_logprobs") or []),
                                ch["finish_reason"] or finish)
        return out

    jc, tc = per_choice(jd), per_choice(td)
    assert sorted(tc) == [0, 1, 2]
    assert {i: (t, f) for i, (t, _, f) in tc.items()} == {i: (t, f) for i, (t, _, f) in jc.items()}
    for i in tc:
        assert len(tc[i][1]) == 9 and tc[i][2] == "length"
        _close(tc[i][1], jc[i][1])
    assert len({t for t, _, _ in tc.values()}) > 1


def test_seed_fan_out_stays_in_the_key_range(servers):
    """Choice i draws with seed + i, so a seed whose last choice would leave
    the scheduler's 32-bit seed row is a 400 (unary and streamed), the
    largest seed that fits is served, and the engine serves on after both."""
    port = servers[1].service.port
    body = _chat(n=2, temperature=0.9, max_tokens=4, model=MODEL)
    for stream in (False, True):
        status, data = _post(port, "/v1/chat/completions", dict(body, seed=toai.SEED_MAX, stream=stream))
        assert status == 400 and data["error"]["message"] == f"seed + n - 1 must be at most {toai.SEED_MAX}"
    status, data = _post(port, "/v1/chat/completions", dict(body, seed=toai.SEED_MAX - 1))
    assert status == 200 and [c["index"] for c in data["choices"]] == [0, 1]
    status, data = _post(port, "/v1/chat/completions", dict(body, n=1, seed=toai.SEED_MAX))
    assert status == 200 and len(data["choices"]) == 1


def test_logit_bias_steers_greedy(servers):
    body = _chat(temperature=0.0, max_tokens=4, logit_bias={str(ord("z")): 100})
    (js, jd), (ts, td) = _both(servers, "/v1/chat/completions", body)
    assert js == ts == 200
    assert td["choices"][0]["message"]["content"] == jd["choices"][0]["message"]["content"] == "zzzz"


def test_penalties_answer_as_jax(servers):
    body = _chat(temperature=0.0, max_tokens=24, frequency_penalty=1.2, presence_penalty=0.6)
    (js, jd), (ts, td) = _both(servers, "/v1/chat/completions", body)
    assert js == ts == 200
    assert td["choices"][0]["message"] == jd["choices"][0]["message"]


def test_forced_tool_choice_answers_tool_calls(servers):
    body = _chat(temperature=0.0, max_tokens=64, tools=TOOLS,
                 tool_choice={"type": "function", "function": {"name": "get_city"}})
    (js, jd), (ts, td) = _both(servers, "/v1/chat/completions", body)
    assert js == ts == 200, td
    jc, tc = jd["choices"][0], td["choices"][0]
    assert tc["finish_reason"] == jc["finish_reason"] == "tool_calls"
    call = tc["message"]["tool_calls"][0]
    assert call["type"] == "function" and call["function"] == jc["message"]["tool_calls"][0]["function"]
    assert tc["message"]["content"] == jc["message"]["content"]
    args = json.loads(call["function"]["arguments"])
    assert call["function"]["name"] == "get_city" and args["city"] in ("SF", "NY") and isinstance(args["ok"], bool)


def test_forced_tool_choice_streams_tool_call_delta(servers):
    body = _chat(temperature=0.0, max_tokens=64, tools=TOOLS, tool_choice="required", stream=True)
    (js, jd), (ts, td) = _both(servers, "/v1/chat/completions", body)
    assert js == ts == 200

    def calls(chunks):
        return [tc["function"] for c in chunks for tc in (c["choices"][0]["delta"].get("tool_calls") or [])]

    assert calls(td) == calls(jd) and len(calls(td)) == 1
    assert td[-1]["choices"][0]["finish_reason"] == jd[-1]["choices"][0]["finish_reason"] == "tool_calls"


def test_tools_auto_passes_through(servers):
    body = _chat(temperature=0.0, tools=TOOLS, tool_choice="auto")
    (js, jd), (ts, td) = _both(servers, "/v1/chat/completions", body)
    assert js == ts == 200
    assert td["choices"][0]["message"] == jd["choices"][0]["message"]
    assert "tool_calls" not in td["choices"][0]["message"]
    assert td["choices"][0]["finish_reason"] in ("stop", "length")


def _stream_message(chunks):
    """A streamed chat answer folded into (content, reasoning_content,
    tool-call functions, finish reason)."""
    content = reasoning = ""
    calls = []
    for c in chunks:
        delta = c["choices"][0].get("delta") or {}
        content += delta.get("content") or ""
        reasoning += delta.get("reasoning_content") or ""
        calls += [tc["function"] for tc in delta.get("tool_calls") or []]
    return content, reasoning, calls, chunks[-1]["choices"][0]["finish_reason"]


@pytest.mark.parametrize("stream", [False, True], ids=["unary", "streamed"])
def test_reasoning_parser_splits_think_block(servers, stream):
    body = _chat(temperature=0.0, max_tokens=40, stream=stream,
                 nvext={"guided_regex": r"<think>[a-z]{2,6}</think>[a-z]{2,6}"})
    (js, jd), (ts, td) = _both(servers, "/v1/chat/completions", body, model=PARSED)
    assert js == ts == 200, td
    if stream:
        got, want = _stream_message(td), _stream_message(jd)
        assert got == want
        content, reasoning = got[0], got[1]
    else:
        assert td["choices"][0] == jd["choices"][0]
        content, reasoning = td["choices"][0]["message"]["content"], td["choices"][0]["message"]["reasoning_content"]
    assert re.fullmatch("[a-z]{2,6}", reasoning) and re.fullmatch("[a-z]{2,6}", content)


@pytest.mark.parametrize("stream", [False, True], ids=["unary", "streamed"])
def test_hermes_parser_finds_tool_call(servers, stream):
    call = r'<tool_call>\{"name": "get_city", "arguments": \{"city": "(SF|NY)", "ok": (true|false)\}\}</tool_call>'
    body = _chat(temperature=0.0, max_tokens=96, stream=stream, tools=TOOLS, tool_choice="auto",
                 nvext={"guided_regex": call})
    (js, jd), (ts, td) = _both(servers, "/v1/chat/completions", body, model=PARSED)
    assert js == ts == 200, td
    if stream:
        got, want = _stream_message(td), _stream_message(jd)
        assert got == want
        functions, finish = got[2], got[3]
    else:
        tc, jc = td["choices"][0], jd["choices"][0]
        assert tc["message"]["content"] == jc["message"]["content"] and tc["finish_reason"] == jc["finish_reason"]
        functions = [c["function"] for c in tc["message"]["tool_calls"]]
        assert functions == [c["function"] for c in jc["message"]["tool_calls"]]
        finish = tc["finish_reason"]
    assert finish == "tool_calls" and len(functions) == 1 and functions[0]["name"] == "get_city"
    args = json.loads(functions[0]["arguments"])
    assert args["city"] in ("SF", "NY") and isinstance(args["ok"], bool)


def _chat_body(**kw):
    return {"model": MODEL, "messages": [{"role": "user", "content": "hello protocol tests"}], "max_tokens": 6, **kw}


# test_openai_protocol_completeness.py's validation bodies, test_guided.py's
# tool-choice ones and the completions logprobs bound.
BAD_BODIES = [
    _chat_body(n=0),
    _chat_body(n=99),
    _chat_body(seed="abc"),
    _chat_body(logprobs=3),
    _chat_body(top_logprobs=5),
    _chat_body(logprobs=True, top_logprobs=21),
    _chat_body(temperature=9.0),
    _chat_body(logit_bias=[1, 2]),
    _chat_body(logit_bias={"abc": 1}),
    _chat_body(logit_bias={"5": 200}),
    _chat_body(frequency_penalty="high"),
    _chat_body(tools=[{"type": "function"}]),
    _chat_body(tools={"type": "function"}),
    _chat_body(tools=[{"type": "function", "function": {"name": "a", "parameters": 3}}]),
    _chat_body(tools=[{"type": "function", "function": {"name": "a"}}],
               tool_choice={"type": "function", "function": {"name": "b"}}),
    _chat_body(tool_choice="required"),
    _chat_body(tool_choice="maybe"),
    _chat_body(tool_choice={"type": "function"}),
    {"model": MODEL, "prompt": "hi", "logprobs": 9},
    {"model": MODEL, "prompt": "hi", "n": 9},
]


def _message(mod, body):
    validate = mod.validate_chat_request if "messages" in body else mod.validate_completion_request
    with pytest.raises(mod.RequestError) as e:
        validate(dict(body))
    return str(e.value)


@pytest.mark.parametrize("body", BAD_BODIES)
def test_validation_message_is_jax(body):
    assert _message(toai, body) == _message(joai, body)


def test_http_refuses_bad_bodies_with_jax_messages(servers):
    for body in BAD_BODIES:
        path = "/v1/chat/completions" if "messages" in body else "/v1/completions"
        for stream in (False, True):
            status, data = _post(servers[1].service.port, path, dict(body, stream=stream))
            assert status == 400 and data["error"]["message"] == _message(joai, body), (body, data)


def test_accepted_and_mapped_as_jax():
    for body in (_chat_body(logprobs=True, top_logprobs=5), {"model": "m", "prompt": "hi", "logprobs": 3},
                 {"model": "m", "prompt": "hi", "logprobs": 0}, _chat_body(logit_bias={"122": 50, 7: -1.5}),
                 _chat_body(frequency_penalty=0.5, presence_penalty=-1, n=2, seed=7),
                 _chat_body(tools=TOOLS, tool_choice="none")):
        validate = toai.validate_chat_request if "messages" in body else toai.validate_completion_request
        assert validate(body) is body
        assert toai.sampling_from_request(body) == joai.sampling_from_request(body)
    tops = [[[7, -0.1], [9, -2.0]], [[4, -0.5]]]
    assert toai.chat_logprobs_content("a", [-0.1], tops[:1]) == joai.chat_logprobs_content("a", [-0.1], tops[:1])
    assert toai.completion_logprobs_block(["a", "b"], [-0.1, -0.5], tops) == joai.completion_logprobs_block(
        ["a", "b"], [-0.1, -0.5], tops)
    call = [{"id": "c", "type": "function", "function": {"name": "f", "arguments": "{}"}}]
    assert toai.chat_choice(1, "", "tool_calls", call, "why") == joai.chat_choice(1, "", "tool_calls", call, "why")
