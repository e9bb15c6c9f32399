"""The port's serving path as a whole, against the JAX package.

1. Scheduler: the port's ``Scheduler`` and the JAX ``Scheduler`` (one
   decode step per iteration, no overlapped decode) replay one request
   trace with the same converted weights: staggered arrivals, a prompt
   longer than ``mixed_prefill_budget`` (mixed steps), a shared prefix
   that hits the prefix cache, and a pool small enough to force a
   preemption. Greedy token streams, finish reasons and cached tokens
   must be identical.
2. HTTP: the port's server on port 0 (``tiny``, f32, CPU) answers chat
   (JSON and SSE) and completion requests with the text the JAX
   ``build_local_pipeline(ByteTokenizer(), TpuEngine)`` produces for the
   same body and weights.
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


def _replay(sched, mod, sampling_cls):
    trace = _trace()
    outs = {}
    for step in range(400):
        for at, rid, prompt, max_tokens in trace:
            if at == step:
                sched.add_request(rid, prompt, sampling_cls(temperature=0.0), mod.StopConditions(max_tokens=max_tokens))
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


def test_scheduler_trace_matches_jax(weights):
    jp, tp = weights
    common = dict(num_blocks=16, max_running=4, mixed_prefill_budget=32, **BUCKETS)
    j = jsched.Scheduler(
        JCFG, jp,
        jsched.SchedulerConfig(num_scheduler_steps=1, enable_overlap_decode=False, **common),
        dtype=jnp.float32, eos_token_ids=[0],
    )
    # The port has no wave admission (several short prompts prefilled in one
    # batched dispatch); hold the JAX scheduler to one prefill per admission.
    j._supports_chunk_admit = False
    t = tsched.Scheduler(TCFG, tp, tsched.SchedulerConfig(**common), dtype=torch.float32, device="cpu",
                         eos_token_ids=[0])
    want = _replay(j, jsched, JaxSampling)
    got = _replay(t, tsched, SamplingParams)
    assert got == want
    assert t.preempt_total == j.preempt_total >= 1
    assert t.mixed_steps_total == j.mixed_steps_total > 0
    assert t.cached_tokens_total == j.cached_tokens_total > 0
    assert got["C"]["cached"] == [32]


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
                      scheduler=jsched.SchedulerConfig(num_blocks=64, num_scheduler_steps=1,
                                                       enable_overlap_decode=False, **BUCKETS)),
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
                   scheduler=tsched.SchedulerConfig(num_blocks=64, **BUCKETS)),
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
            "unsupported_field": await asyncio.to_thread(_post, service.port, "/v1/chat/completions",
                                                         {"model": "tiny", "messages": [{"role": "user", "content": "x"}],
                                                          "logprobs": True}),
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
    assert misc["unsupported_field"][0] == 400 and b"logprobs" in misc["unsupported_field"][1]
    # A past-deadline request is evicted by the scheduler: 504 with partial usage.
    status, raw = misc["deadline"]
    assert status == 504 and json.loads(raw)["usage"]["completion_tokens"] < 50
    assert (misc["wrong_method"], misc["no_route"], misc["invalid_json"], misc["chunked"], misc["malformed"]) == (
        405, 404, 400, 411, 400)


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
