"""Guided decoding (structured outputs) on the port's serving path, against
the JAX package.

1. Scheduler against scheduler: the port's scheduler on the megakernel path
   with 8-step decode windows (every guided row rides the fused window's
   guided epilogue: its plain version on the CPU) and the JAX scheduler on
   its gather path at one decode step per iteration (no Pallas interpret
   mode) replay one trace of guided and unguided greedy requests with the
   same converted weights: the same token streams and finish reasons, and
   the port's guided rows in fused windows. Guided rows also ride mixed
   prefill+decode steps (token for token with the JAX scheduler on the same
   configuration), a sampled guided row stays inside its grammar, a guided
   request beside a draft falls back from speculation to the fused guided
   window, and a guided request without an attached tokenizer is refused.
2. HTTP: the port's server refuses the same malformed structured-output
   bodies as the JAX validators and grammar build, with the same messages
   (a 400, streaming or not), answers ``tools`` without a forced choice as
   text and refuses ``tool_choice: "required"`` without tools with the JAX
   message, and answers a ``response_format`` request, JSON and SSE, with
   text that parses as JSON and satisfies the schema.
"""

import asyncio
import http.client
import json
import re
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.sampling import SamplingParams as JaxSampling
from dynamo_tpu.llm.guided.grammar import build_guided_spec as jax_build_guided_spec
from dynamo_tpu.llm.protocols import openai as joai
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.entrypoint import build_local_pipeline
from dynamo_tpu_torch.llm.guided import processor as tproc
from dynamo_tpu_torch.llm.guided.grammar import build_guided_spec, compile_regex, schema_to_regex
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.runtime.engine import Context

TCFG = get_config("tiny")
JCFG = jax_config("tiny")
EOS = 0
SCHEMA = {"type": "object", "properties": {"city": {"enum": ["SF", "NY"]}, "ok": {"type": "boolean"}}}
SCHED = dict(num_blocks=96, max_running=4, prefill_buckets=[16, 32, 64], decode_buckets=[1, 2, 4],
             enable_prefix_caching=False)


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, device="cpu", dtype=torch.float32)


def _jax_scheduler(jp, impl="gather", **kw):
    j = jsched.Scheduler(JCFG.replace(attention_impl=impl), jp,
                         jsched.SchedulerConfig(**{**SCHED, "guided_pool_rows": 256,
                                                   **kw}),
                         dtype=jnp.float32, eos_token_ids=[EOS])
    j.attach_guided(JaxByteTokenizer())
    return j


def _port_scheduler(tp, **kw):
    t = tsched.Scheduler(TCFG, tp, tsched.SchedulerConfig(**{**SCHED, **kw}), dtype=torch.float32, device="cpu",
                         eos_token_ids=[EOS])
    t.attach_guided(ByteTokenizer())
    return t


def _replay(sched, mod, sampling_cls, trace):
    """(arrival step, request id, prompt, max_tokens, guided spec or None,
    sampling options) → per request its tokens and finish reasons."""
    outs = {}
    for step in range(600):
        for at, rid, prompt, max_tokens, guided, opts in trace:
            if at == step:
                sched.add_request(rid, prompt, sampling_cls(**opts), mod.StopConditions(max_tokens=max_tokens),
                                  guided=guided)
        if step > trace[-1][0] and not sched.has_work():
            break
        for seq, out in sched.step():
            o = outs.setdefault(seq.request_id, {"tokens": [], "finish": []})
            if out.token_id >= 0:
                o["tokens"].append(out.token_id)
            if out.finished:
                o["finish"].append(out.finish_reason)
    assert not sched.has_work()
    return outs


GREEDY = {"temperature": 0.0}
SCHEMA_SPEC = {"kind": "regex", "pattern": schema_to_regex(SCHEMA)}
CHOICE_SPEC = {"kind": "choice", "choices": ["red", "green", "blue"]}
REGEX_SPEC = {"kind": "regex", "pattern": r"[a-c]{2}-\d{2,12}"}


def _trace():
    """Guided requests (a schema, a choice, a regex) arriving while an
    unguided request decodes, and one more unguided request after them."""
    rng = np.random.default_rng(5)
    p = lambda n: rng.integers(1, 255, size=n).tolist()  # noqa: E731
    return [
        (0, "u0", p(20), 30, None, GREEDY),
        (1, "schema", p(12), 64, SCHEMA_SPEC, GREEDY),
        (2, "choice", p(9), 16, CHOICE_SPEC, GREEDY),
        (5, "regex", p(30), 20, REGEX_SPEC, GREEDY),
        (9, "u1", p(14), 12, None, GREEDY),
    ]


def _text(tokens):
    return ByteTokenizer().decode(tokens)


def test_guided_window_scheduler_matches_jax(weights):
    jp, tp = weights
    want = _replay(_jax_scheduler(jp, num_scheduler_steps=1), jsched, JaxSampling, _trace())
    t = _port_scheduler(tp, num_scheduler_steps=8)
    assert t._fused_guided_ok()
    got = _replay(t, tsched, SamplingParams, _trace())
    assert got == want
    assert t.fused_guided_windows_total > 0 and t.multi_windows_total == 0
    assert t.fused_guided_windows_total <= t.fused_sampled_windows_total <= t.fused_windows_total
    assert got["schema"]["finish"] == ["stop"] and json.loads(_text(got["schema"]["tokens"]))
    assert _text(got["choice"]["tokens"]) in CHOICE_SPEC["choices"]
    assert re.fullmatch(REGEX_SPEC["pattern"], _text(got["regex"]["tokens"])) or got["regex"]["finish"] == ["length"]
    assert t.guided.stats()["guided_requests_total"] == 3


def test_guided_rides_mixed_steps_as_jax(weights):
    """A guided head-of-queue prompt rides mixed prefill+decode steps (one
    decode step per iteration, megakernel path on both sides)."""
    jp, tp = weights
    trace = [(0, "d", list(range(1, 17)), 60, None, GREEDY),
             (3, "g", list(range(2, 50)), 64, SCHEMA_SPEC, GREEDY)]
    kw = dict(num_scheduler_steps=1, enable_mixed_batching=True, mixed_prefill_budget=32)
    want = _replay(_jax_scheduler(jp, impl="megakernel", **kw), jsched, JaxSampling, trace)
    t = _port_scheduler(tp, **kw)
    got = _replay(t, tsched, SamplingParams, trace)
    assert got == want
    assert t.mixed_steps_total >= 1 and got["g"]["finish"] == ["stop"]
    assert re.fullmatch(SCHEMA_SPEC["pattern"], _text(got["g"]["tokens"]))


@pytest.mark.parametrize("steps", [1, 8])
def test_sampled_guided_rows_stay_in_their_grammar(weights, steps):
    """Seeded and unseeded sampled guided rows, on single steps and in
    fused windows: whatever is drawn, the text is one of the choices or a
    match of the schema."""
    _, tp = weights
    trace = [(0, "c", list(range(1, 17)), 16, CHOICE_SPEC, {"temperature": 1.0, "seed": 11}),
             (0, "s", list(range(3, 30)), 64, SCHEMA_SPEC, {"temperature": 0.9, "top_p": 0.95}),
             (1, "u", list(range(5, 25)), 20, None, {"temperature": 0.7})]
    t = _port_scheduler(tp, num_scheduler_steps=steps)
    got = _replay(t, tsched, SamplingParams, trace)
    assert _text(got["c"]["tokens"]) in CHOICE_SPEC["choices"] and got["c"]["finish"] == ["stop"]
    assert re.fullmatch(SCHEMA_SPEC["pattern"], _text(got["s"]["tokens"])) and got["s"]["finish"] == ["stop"]
    assert (t.fused_guided_windows_total > 0) == (steps > 1)


def test_guided_request_beside_a_draft_takes_the_fused_guided_window(weights):
    """With a draft attached, a batch holding a guided row does not
    speculate: it runs fused guided windows, with the answer of a scheduler
    without a draft; an unguided request alone speculates again."""
    _, tp = weights
    trace = [(0, "g", list(range(1, 17)), 64, SCHEMA_SPEC, GREEDY), (1, "u", list(range(4, 24)), 24, None, GREEDY)]
    plain = _replay(_port_scheduler(tp, num_scheduler_steps=8), tsched, SamplingParams, trace)
    t = _port_scheduler(tp, num_scheduler_steps=8)
    t.attach_draft(TCFG, tp, gamma=2)
    got = _replay(t, tsched, SamplingParams, trace)
    assert got == plain
    assert t.fused_guided_windows_total > 0
    rounds0 = t.spec_stats.num_rounds
    alone = _replay(t, tsched, SamplingParams, [(0, "v", list(range(6, 26)), 24, None, GREEDY)])
    assert t.spec_stats.num_rounds > rounds0 and alone["v"]["finish"] in (["length"], ["stop"])


def test_guided_requires_attached_tokenizer(weights):
    _, tp = weights
    t = tsched.Scheduler(TCFG, tp, tsched.SchedulerConfig(num_blocks=64), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="tokenizer"):
        t.add_request("g", [1, 2, 3], SamplingParams(), tsched.StopConditions(),
                      guided={"kind": "regex", "pattern": "ab"})


def _engine(tp, tok):
    """A port engine on the tiny model with 8-step windows and the byte
    tokenizer attached for guided decoding."""
    engine = TorchEngine.build(
        EngineArgs(model="tiny", dtype="float32", device="cpu", eos_token_ids=tok.eos_token_ids,
                   scheduler=tsched.SchedulerConfig(num_blocks=64, num_scheduler_steps=8, prefill_buckets=[32, 64],
                                                    decode_buckets=[1, 2, 4])),
        params=tp,
    )
    engine.attach_guided_tokenizer(tok)
    return engine


def _request(max_tokens, guided=None):
    return {"token_ids": [5, 6, 7, 8], "sampling_options": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": max_tokens}, **({"guided_decoding": guided} if guided else {})}


async def _collect(engine, req):
    """(token ids, finish reason) of one request through ``generate``."""
    toks, finish = [], None
    async for frame in engine.generate(req, Context()):
        toks += frame["token_ids"]
        finish = frame["finish_reason"] or finish
    return toks, finish


def test_engine_refuses_a_grammar_the_card_cannot_hold_and_serves_on(weights, monkeypatch):
    """A grammar whose rows would grow the pools past what the device can
    allocate fails its own request with an error; the request beside it,
    and a small grammar after it, are served by the same engine."""
    _, tp = weights
    tok = ByteTokenizer()
    zeros = torch.zeros

    def no_room(shape, **kw):  # the pools' first capacity fits, a doubling does not
        if kw.get("dtype") == torch.int32 and len(shape) == 2 and shape[0] > tproc.POOL_ROWS:
            raise torch.cuda.OutOfMemoryError("no room")
        return zeros(shape, **kw)

    async def run():
        engine = _engine(tp, tok)
        monkeypatch.setattr(tproc.torch, "zeros", no_room)
        try:
            big, beside = await asyncio.gather(
                _collect(engine, _request(8, build_guided_spec({"response_format": {"type": "json_object"}}))),
                _collect(engine, _request(12)), return_exceptions=True)
            after = await _collect(engine, _request(16, CHOICE_SPEC))
        finally:
            await engine.stop()
        return big, beside, after, engine.scheduler.guided.pool

    big, beside, after, pool = asyncio.run(run())
    assert isinstance(big, RuntimeError) and "no device memory" in str(big)
    assert not isinstance(beside, BaseException) and len(beside[0]) == 12 and beside[1] == "length"
    assert tok.decode(after[0]) in ("red", "green", "blue") and after[1] == "stop"
    assert pool.capacity == tproc.POOL_ROWS


def test_engine_compiles_grammars_off_the_step_loop(weights):
    """The engine compiles a request's grammar (``GuidedDecoder.prepare``)
    on a thread of its own before staging it, and steps on another: the
    step loop's ``add_request`` gets the compiled cursor and only
    registers its rows."""
    _, tp = weights
    tok = ByteTokenizer()
    seen = {"prepare": [], "add": [], "step": []}

    async def run():
        engine = _engine(tp, tok)
        dec, sched = engine.scheduler.guided, engine.scheduler
        prepare, add, step = dec.prepare, sched.add_request, sched.step

        def traced_prepare(spec):
            seen["prepare"].append(threading.current_thread().name)
            return prepare(spec)

        def traced_step():
            seen["step"].append(threading.current_thread().name)
            return step()

        def traced_add(*a, guided=None, **kw):
            seen["add"].append(guided)
            return add(*a, guided=guided, **kw)

        dec.prepare, sched.add_request, sched.step = traced_prepare, traced_add, traced_step
        try:
            toks, _ = await _collect(engine, _request(16, CHOICE_SPEC))
        finally:
            await engine.stop()
        return toks

    toks = asyncio.run(run())
    assert tok.decode(toks) in ("red", "green", "blue")
    assert seen["prepare"] and all(name.startswith("grammar-compile") for name in seen["prepare"])
    assert seen["step"] and all(name.startswith("engine-step") for name in seen["step"])
    assert len(seen["add"]) == 1 and isinstance(seen["add"][0], tproc.GuidedState)


def test_engine_serves_while_the_default_thread_pool_is_full(weights):
    """The engine steps and compiles on threads of its own: with every
    thread of the event loop's default pool held (as the serving IO around
    it may hold them), a guided request and an unguided one are served."""
    _, tp = weights
    tok = ByteTokenizer()

    async def run():
        loop = asyncio.get_running_loop()
        loop.set_default_executor(ThreadPoolExecutor(max_workers=1))
        release = threading.Event()
        held = loop.run_in_executor(None, release.wait, 120)
        engine = _engine(tp, tok)
        try:
            return await asyncio.wait_for(asyncio.gather(_collect(engine, _request(16, CHOICE_SPEC)),
                                                         _collect(engine, _request(6))), 60)
        finally:
            release.set()
            await held
            await engine.stop()

    (guided, g_finish), (plain, p_finish) = asyncio.run(run())
    assert tok.decode(guided) in ("red", "green", "blue") and g_finish == "stop"
    assert len(plain) == 6 and p_finish == "length"


# ---------------------------------------------------------------------------
# 2. HTTP
# ---------------------------------------------------------------------------


def _chat(**extra):
    return {"model": "tiny", "messages": [{"role": "user", "content": "x"}], "max_tokens": 8, **extra}


# Malformed constraints the JAX validators refuse (test_guided.py's; its
# tool-choice ones are test_torch_extras_serving.py's).
BAD_SHAPES = [
    _chat(response_format="json"),
    _chat(response_format={"type": "nope"}),
    _chat(response_format={"type": "json_schema"}),
    _chat(response_format={"type": "json_schema", "json_schema": {}}),
    _chat(response_format={"type": "json_schema", "json_schema": {"name": 3, "schema": SCHEMA}}),
    _chat(nvext={"guided_regex": ""}),
    _chat(nvext={"guided_choice": []}),
    _chat(nvext={"guided_json": "x"}),
    _chat(nvext={"guided_regex": "a", "guided_choice": ["b"]}),
]
# Well-formed bodies whose constraint does not compile: the JAX grammar
# build refuses them.
BAD_GRAMMARS = [
    _chat(response_format={"type": "json_schema", "json_schema": {"schema": {"$ref": "#/x"}}}),
    _chat(nvext={"guided_regex": "(?=a)b"}),
    _chat(nvext={"guided_json": {"type": "object", "properties": {"a": {"allOf": [{}]}}}}),
]
# A tools request without a forced choice (answered as text) and a forced
# choice without tools (refused).
TOOL_BODIES = [
    _chat(tools=[{"type": "function", "function": {"name": "a", "parameters": SCHEMA}}]),
    _chat(tool_choice="required"),
]


def _jax_message(body):
    try:
        joai.validate_chat_request(dict(body))
        jax_build_guided_spec(body)
    except joai.RequestError as e:
        return str(e)
    raise AssertionError(f"JAX accepted {body}")


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, raw


def _text_of(body, raw):
    if not body.get("stream"):
        return json.loads(raw)["choices"][0]["message"]["content"], json.loads(raw)["choices"][0]["finish_reason"]
    events = [ln[6:] for ln in raw.decode().split("\n\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    return "".join(c["choices"][0]["delta"].get("content") or "" for c in chunks), chunks[-1]["choices"][0][
        "finish_reason"]


async def _serve(tp, bodies):
    """The port's server on its defaults (8-step windows here, the fused
    window's plain version on the CPU) → each body's (status, raw), and the
    engine's stats and fused guided windows after them."""
    tok = ByteTokenizer()
    engine = TorchEngine.build(
        EngineArgs(model="tiny", dtype="float32", device="cpu", eos_token_ids=tok.eos_token_ids,
                   scheduler=tsched.SchedulerConfig(num_blocks=64, num_scheduler_steps=8, prefill_buckets=[32, 64],
                                                    decode_buckets=[1, 2, 4])),
        params=tp,
    )
    service = HttpService({"tiny": build_local_pipeline(tok, engine)}, host="127.0.0.1", port=0)
    await service.start()
    try:
        answers = [await asyncio.to_thread(_post, service.port, "/v1/chat/completions", b) for b in bodies]
    finally:
        await service.stop()
        await engine.stop()
    return answers, engine.stats(), engine.scheduler.fused_guided_windows_total


def test_http_refuses_what_jax_refuses_with_its_messages(weights):
    _, tp = weights
    bad = BAD_SHAPES + BAD_GRAMMARS
    bodies = bad + [{**b, "stream": True} for b in BAD_GRAMMARS] + TOOL_BODIES
    answers, _, _ = asyncio.run(_serve(tp, bodies))
    for body, (status, raw) in zip(bad + BAD_GRAMMARS, answers):
        assert status == 400, (body, raw)
        assert json.loads(raw)["error"]["message"] == _jax_message({k: v for k, v in body.items() if k != "stream"})
    (tools_status, tools_raw), (choice_status, choice_raw) = answers[-len(TOOL_BODIES):]
    assert tools_status == 200 and "tool_calls" not in json.loads(tools_raw)["choices"][0]["message"]
    assert choice_status == 400
    assert json.loads(choice_raw)["error"]["message"] == _jax_message(TOOL_BODIES[1])


def test_http_response_format_round_trip(weights):
    """A ``response_format: json_schema`` request (JSON and SSE) and an
    ``nvext.guided_choice`` one: answers that parse and match, served
    through fused guided windows; the engine's stats count them."""
    _, tp = weights
    rf = {"type": "json_schema", "json_schema": {"name": "place", "schema": SCHEMA}}
    bodies = [
        _chat(response_format=rf, max_tokens=64, temperature=0.0),
        {**_chat(response_format=rf, max_tokens=64, temperature=0.0), "stream": True},
        _chat(nvext={"guided_choice": ["yes", "no"]}, max_tokens=8, temperature=0.9, seed=3),
        _chat(response_format={"type": "text"}, max_tokens=5, temperature=0.0),
    ]
    answers, stats, guided_windows = asyncio.run(_serve(tp, bodies))
    assert all(status == 200 for status, _ in answers), answers
    texts = [_text_of(b, raw) for b, (_, raw) in zip(bodies, answers)]
    for text, finish in texts[:2]:
        assert finish == "stop"
        obj = json.loads(text)
        assert obj["city"] in ("SF", "NY") and isinstance(obj["ok"], bool) and list(obj) == ["city", "ok"]
        assert compile_regex(schema_to_regex(SCHEMA)).match(text)
    assert texts[0] == texts[1]  # greedy: the same answer streamed or not
    assert texts[2] == ("yes", "stop") or texts[2] == ("no", "stop")
    assert stats["guided_requests_total"] == 3 and stats["guided_grammar_compiles_total"] == 2
    assert guided_windows > 0
