"""The port's tool-call and reasoning parsers (``dynamo_tpu_torch.llm.parsers``)
against the JAX package's, on the inputs of ``tests/test_parsers.py``: the
same registries, the same parsed calls (ids aside, which are random), the
same content, reasoning splits and streamed jail output, and the same
Backend frames with ``parser_options`` on the request."""

import asyncio

import pytest

from dynamo_tpu.llm import parsers as jparsers
from dynamo_tpu.llm.backend import Backend as JaxBackend
from dynamo_tpu.llm.protocols.common import LLMEngineOutput as JaxOutput
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu.runtime.engine import Annotated as JaxAnnotated
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.llm import parsers as tparsers
from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.protocols.common import LLMEngineOutput
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.runtime.engine import Annotated, Context

# (text, parser) of test_parsers.py's tool-call cases.
TOOL_CASES = [
    ('sure!\n<tool_call>\n{"name": "get_weather", "arguments": {"city": "SF"}}\n</tool_call>', "hermes"),
    ('<tool_call>{"name": "a", "arguments": {}}</tool_call><tool_call>{"name": "b", "arguments": {"x": 1}}</tool_call>',
     "hermes"),
    ('{"name": "a", "arguments": {}}', "hermes"),
    ('[TOOL_CALLS] [{"name": "f", "arguments": {"a": 2}}, {"name": "g", "arguments": {}}]', "mistral"),
    ('<|python_tag|>{"name": "lookup", "parameters": {"q": "tpu"}}', "llama3_json"),
    ('thinking done <TOOLCALL>[{"name": "calc", "arguments": {"expr": "1+1"}}]</TOOLCALL>', "nemotron_deci"),
    ('[get_weather(city="SF", units="metric"), get_time(tz="PST")]', "pythonic"),
    ("[1, 2, 3]", "pythonic"),
    ("<|channel|>analysis<|message|>user wants weather<|end|>"
     '<|channel|>commentary to=functions.get_weather <|constrain|>json<|message|>{"city": "SF"}<|call|>', "harmony"),
    ('<function_calls><invoke name="search"><parameter name="query">tpu kernels</parameter>'
     '<parameter name="limit">5</parameter></invoke></function_calls>', "xml"),
    ('<function_call>```typescript\nfunctions.get_current_weather({"location": "Shanghai"})\n```', "typescript"),
    ('{"name": "get_weather", "arguments": {"city": "NY"}}', "default"),
    ("plain text, no call", "default"),
]
DETECT_CASES = [("<tool", "hermes"), ("<tool_call>{", "hermes"), ("hello", "hermes"), ("[TOOL", "mistral"),
                ('{"na', "default")]
# (parser, text) of the reasoning cases.
REASONING_CASES = [
    ("basic", "<think>step 1. step 2.</think>The answer is 4."),
    ("deepseek_r1", "chain of thought here</think>final answer"),
    ("basic", "<think>never closed reasoning"),
    ("kimi", "◁think▷hmm◁/think▷ok"),
    ("gpt_oss", "<|channel|>analysis<|message|>let me think<|end|><|channel|>final<|message|>answer<|return|>"),
]
# (tool parser, reasoning parser or None, deltas) of the streaming cases.
STREAM_CASES = [
    ("hermes", None, ["hello ", "world"]),
    ("hermes", None, ["<tool_call>", '{"name": "f",', ' "arguments": {"x": 1}}', "</tool_call>"]),
    ("hermes", None, ["<tool", "ing along>"]),
    ("hermes", "basic", ["<th", "ink>rea", "soning</th", "ink>con", "tent"]),
    ("default", None, ['{"name": "g", ', '"arguments": {"a": [1, 2]}}']),
]


def _calls(calls):
    return [(c.name, c.arguments) for c in calls]


def test_registries_match_jax():
    assert tparsers.get_available_tool_parsers() == jparsers.get_available_tool_parsers()
    assert tparsers.get_available_reasoning_parsers() == jparsers.get_available_reasoning_parsers()
    with pytest.raises(ValueError):
        tparsers.get_tool_parser("nope")


@pytest.mark.parametrize("text,name", TOOL_CASES)
def test_tool_call_parse_matches_jax(text, name):
    jc, jcontent = jparsers.try_tool_call_parse(text, jparsers.get_tool_parser(name))
    tc, tcontent = tparsers.try_tool_call_parse(text, tparsers.get_tool_parser(name))
    assert (_calls(tc), tcontent) == (_calls(jc), jcontent)
    for c in tc:
        d = c.to_openai()
        assert d["type"] == "function" and d["id"].startswith("call-")


@pytest.mark.parametrize("text,name", DETECT_CASES)
def test_detect_tool_call_start_matches_jax(text, name):
    assert tparsers.detect_tool_call_start(text, tparsers.get_tool_parser(name)) == \
        jparsers.detect_tool_call_start(text, jparsers.get_tool_parser(name))


@pytest.mark.parametrize("name,text", REASONING_CASES)
def test_reasoning_parse_matches_jax(name, text):
    j = jparsers.get_reasoning_parser(name).parse(text)
    t = tparsers.get_reasoning_parser(name).parse(text)
    assert (t.reasoning, t.content) == (j.reasoning, j.content)


def _stream(mod, tool, reasoning, deltas):
    jail = mod.StreamingToolCallJail(config=mod.get_tool_parser(tool),
                                     reasoning=mod.get_reasoning_parser(reasoning) if reasoning else None)
    fed = [jail.feed(d) for d in deltas]
    r_tail, c_tail, calls = jail.finish()
    return fed, r_tail, c_tail, _calls(calls)


@pytest.mark.parametrize("tool,reasoning,deltas", STREAM_CASES)
def test_streaming_jail_matches_jax(tool, reasoning, deltas):
    assert _stream(tparsers, tool, reasoning, deltas) == _stream(jparsers, tool, reasoning, deltas)


async def _backend_frames(backend, out_cls, annotated, ctx, frames, request):
    async def engine_stream():
        for f in frames:
            yield annotated(data=out_cls(**f).to_wire())

    got = []
    async for item in backend.transform_response(engine_stream(), request, ctx):
        if isinstance(item, annotated) and not item.is_annotation():
            d = dict(item.data)
            for tc in d.get("tool_calls") or []:
                tc.pop("id")
            got.append(d)
    return got


# (text, parser_options) of test_parsers.py's backend cases, and a forced
# tool call through the "default" parser with logprobs on its frames.
BACKEND_CASES = [
    ('<tool_call>{"name": "f", "arguments": {"x": 1}}</tool_call>', {"tool_call_parser": "hermes",
                                                                     "reasoning_parser": None}),
    ("<think>why</think>answer", {"tool_call_parser": None, "reasoning_parser": "basic"}),
    ('{"name": "get_weather", "arguments": {"city": "SF"}}', {"tool_call_parser": "default",
                                                              "reasoning_parser": None}),
    ("no parsers here", None),
]


@pytest.mark.parametrize("text,options", BACKEND_CASES)
def test_backend_parser_frames_match_jax(text, options):
    ids = ByteTokenizer().encode(text)
    frames = [{"token_ids": ids[:4], "logprobs": [-0.5] * 4, "top_logprobs": [[[1, -0.5]]] * 4},
              {"token_ids": ids[4:]}, {"finish_reason": "stop"}]
    request = {"stop_conditions": {}}
    if options:
        request["parser_options"] = options
    want = asyncio.run(_backend_frames(JaxBackend(JaxByteTokenizer()), JaxOutput, JaxAnnotated, JaxContext(),
                                       frames, request))
    got = asyncio.run(_backend_frames(Backend(ByteTokenizer()), LLMEngineOutput, Annotated, Context(), frames,
                                      request))
    assert got == want
    assert got[0]["logprobs"] == [-0.5] * 4
    if options and options["tool_call_parser"]:
        assert got[-1]["finish_reason"] == "tool_calls" and got[-1]["tool_calls"][0]["type"] == "function"
