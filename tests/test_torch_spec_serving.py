"""Speculative decoding on the port's serving path, against the JAX package.

1. Scheduler against scheduler: the port's ``Scheduler.attach_draft`` and
   the JAX one (megakernel path, 8-step windows, so R = 2 rounds of γ = 2
   per fused spec window) replay the same traces with the same converted
   weights: self-speculation with a prefix-cache hit (every proposal
   accepted), a disagreeing draft, and greedy, unseeded sampled and seeded
   sampled requests (the seeded row sends its batches down the non-spec
   path, after which speculation resumes). Token streams, finish reasons,
   the ``spec_decode`` stats and the spec-window counters must be equal.
2. The per-round spec path: at one decode step an iteration (no fused
   window, so no fused spec window) both schedulers speculate one round an
   iteration through ``chunk_decode``, on the megakernel path, the
   ``"paged"`` path and with int8 KV and int8 weights (the draft's cache
   int8 too): the same tokens (greedy, unseeded sampled, and a seeded
   sampled row that sends its batches down the non-spec path), the same
   ``spec_decode`` stats and step counter; greedy output equals the
   non-spec scheduler's.
3. The port's spec greedy output equals its non-spec greedy output.
4. Refusals: mismatched drafts, γ < 1 and a draft checkpoint; where the
   fused spec gate refuses (one step an iteration, the per-piece path, γ
   past the kernel's 8) the draft attaches and speculates per round.
5. ``TorchEngine`` with ``draft_model`` serves a request through the HTTP
   service with the answer of an engine without a draft, on the fused
   spec window and, with int8 KV, per round.
"""

import asyncio
import http.client
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine import quant as jquant
from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.sampling import SamplingParams as JaxSampling
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.kv_cache import QuantKv
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.spec_decode import SpecDecodeStats
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.entrypoint import build_local_pipeline
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

TCFG = get_config("tiny")
JCFG = jax_config("tiny")
SCHED = dict(num_blocks=48, max_running=4, prefill_buckets=[32, 64], decode_buckets=[1, 2, 4],
             num_scheduler_steps=8)
GAMMA = 2


@pytest.fixture(scope="module")
def models():
    """(JAX params, port params) of ``tiny`` for seeds 0 (the target) and 42."""
    out = {}
    for seed in (0, 42):
        jp = jllama.init_params(JCFG, jax.random.PRNGKey(seed), dtype=jnp.float32)
        out[seed] = (jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, device="cpu",
                                           dtype=torch.float32))
    return out


def _schedulers(models, draft_seed):
    jt, tt = models[0]
    jd, td = models[draft_seed]
    j = jsched.Scheduler(JCFG.replace(attention_impl="megakernel"), jt,
                         jsched.SchedulerConfig(**SCHED), dtype=jnp.float32,
                         eos_token_ids=[0])
    j.attach_draft(JCFG, jd, gamma=GAMMA)
    t = tsched.Scheduler(TCFG, tt, tsched.SchedulerConfig(**SCHED), dtype=torch.float32, device="cpu",
                         eos_token_ids=[0])
    t.attach_draft(TCFG, td, gamma=GAMMA)
    return j, t


def _replay(sched, mod, sampling_cls, trace, samplings):
    """(arrival step, request id, prompt, max_tokens) → per request its
    tokens and finish reasons."""
    outs = {}
    for step in range(400):
        for at, rid, prompt, max_tokens in trace:
            if at == step:
                sched.add_request(rid, prompt, sampling_cls(**samplings.get(rid, {"temperature": 0.0})),
                                  mod.StopConditions(max_tokens=max_tokens))
        if step > trace[-1][0] and not sched.has_work():
            break
        for seq, out in sched.step():
            outs.setdefault(seq.request_id, []).append(out)
    assert not sched.has_work()
    return {rid: ([o.token_id for o in res if o.token_id >= 0], [o.finish_reason for o in res if o.finished])
            for rid, res in outs.items()}


def _traces():
    rng = np.random.default_rng(3)
    shared = rng.integers(1, 255, size=36).tolist()  # two full blocks and a bit
    return {
        # Self-speculation: B repeats A's prompt after A finished (a prefix hit).
        "self": (0, [(0, "A", shared, 20), (1, "C", rng.integers(1, 255, size=9).tolist(), 14),
                     (40, "B", shared, 12)], {}),
        "disagreeing": (42, [(0, "A", rng.integers(1, 255, size=20).tolist(), 24),
                             (1, "B", rng.integers(1, 255, size=13).tolist(), 17)], {}),
        # C is seeded and sampled: its batches fall back to non-spec windows
        # until it finishes, then A and B speculate again.
        "sampling": (42, [(0, "A", rng.integers(1, 255, size=20).tolist(), 40),
                          (0, "B", rng.integers(1, 255, size=9).tolist(), 30),
                          (2, "C", rng.integers(1, 255, size=14).tolist(), 8)],
                     {"B": {"temperature": 0.8, "top_p": 0.9},
                      "C": {"temperature": 1.1, "top_k": 20, "seed": 1234}}),
    }


@pytest.mark.parametrize("case", ["self", "disagreeing", "sampling"])
def test_spec_scheduler_matches_jax(models, case):
    draft_seed, trace, samplings = _traces()[case]
    j, t = _schedulers(models, draft_seed)
    assert j._use_fused_spec and t._spec_rounds == j._spec_rounds == 2
    want = _replay(j, jsched, JaxSampling, trace, samplings)
    got = _replay(t, tsched, SamplingParams, trace, samplings)
    assert got == want
    assert t.metrics().spec_decode == j.metrics().spec_decode
    assert t.spec_fused_windows_total == j.flight.spec_fused_windows_total > 0
    assert t.spec_fused_accepted_tokens_total == j.flight.spec_fused_accepted_tokens_total > 0
    assert t._step_counter == j._step_counter
    st = t.spec_stats
    if case == "self":
        assert st.acceptance_rate == 1.0 and st.accepted_per_round == GAMMA + 1
        assert t.cached_tokens_total == j.cached_tokens_total == 32
    if case == "sampling":
        assert t.fused_windows_total == j.flight.fused_windows_total > 0  # C's batches, without the draft
    assert set(t.metrics().to_wire()["spec_decode"]) == set(SpecDecodeStats().to_dict())


# Per-round cases: (attention_impl, int8 target and draft, trace, draft seed).
ROUND_CASES = {
    "megakernel-sampling": ("megakernel", False, "sampling"),
    "megakernel-self": ("megakernel", False, "self"),
    "paged-disagreeing": ("paged", False, "disagreeing"),
    "int8-sampling": ("megakernel", True, "sampling"),
}


def _quant(models, seed):
    """(JAX int8 tree, port params from it) of ``models[seed]``."""
    jq = jquant.quantize_params({**models[seed][0], "layers": dict(models[seed][0]["layers"])})
    return jq, params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), TCFG, device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_spec_rounds_match_jax(models, case):
    impl, int8, trace_name = ROUND_CASES[case]
    draft_seed, trace, samplings = _traces()[trace_name]
    q = dict(kv_cache_dtype="int8", weight_dtype="int8") if int8 else {}
    (jt, tt), (jd, td) = ((_quant(models, 0), _quant(models, draft_seed)) if int8
                          else (models[0], models[draft_seed]))
    sched = dict(SCHED, num_scheduler_steps=1)
    j = jsched.Scheduler(JCFG.replace(attention_impl=impl, **q), jt, jsched.SchedulerConfig(**sched),
                         dtype=jnp.float32, eos_token_ids=[0])
    j.attach_draft(JCFG.replace(**q), jd, gamma=GAMMA)
    t = tsched.Scheduler(TCFG.replace(attention_impl=impl, **q), tt, tsched.SchedulerConfig(**sched),
                         dtype=torch.float32, device="cpu", eos_token_ids=[0])
    t.attach_draft(TCFG.replace(**q), td, gamma=GAMMA)
    assert not j._use_fused_spec and not t._use_fused_spec
    assert isinstance(t.draft_cache.k, QuantKv) == int8
    want = _replay(j, jsched, JaxSampling, trace, samplings)
    got = _replay(t, tsched, SamplingParams, trace, samplings)
    assert got == want
    assert t.metrics().spec_decode == j.metrics().spec_decode
    assert t.spec_rounds_total == t.spec_stats.num_rounds > 0 and t.spec_fused_windows_total == 0
    assert t._step_counter == j._step_counter
    if trace_name == "self":
        assert t.spec_stats.acceptance_rate == 1.0
    if trace_name == "sampling":
        assert t.decode_steps_total > 0  # C's batches, without the draft


def test_spec_rounds_greedy_output_matches_non_spec(models):
    _, tt = models[0]
    _, td = models[42]
    trace = _traces()["disagreeing"][1]
    sched = tsched.SchedulerConfig(**dict(SCHED, num_scheduler_steps=1))
    plain = tsched.Scheduler(TCFG, tt, sched, dtype=torch.float32, device="cpu")
    spec = tsched.Scheduler(TCFG, tt, sched, dtype=torch.float32, device="cpu")
    spec.attach_draft(TCFG, td, gamma=3)
    free0 = spec.allocator.num_free
    assert _replay(spec, tsched, SamplingParams, trace, {}) == _replay(plain, tsched, SamplingParams, trace, {})
    assert spec.spec_rounds_total > 0 and spec.wave_steps_total == 0
    assert spec.allocator.num_free == free0


def test_spec_greedy_output_matches_non_spec(models):
    _, tt = models[0]
    _, td = models[42]
    trace = _traces()["disagreeing"][1]
    plain = tsched.Scheduler(TCFG, tt, tsched.SchedulerConfig(**SCHED), dtype=torch.float32, device="cpu")
    spec = tsched.Scheduler(TCFG, tt, tsched.SchedulerConfig(**SCHED), dtype=torch.float32, device="cpu")
    spec.attach_draft(TCFG, td, gamma=3)
    free0 = spec.allocator.num_free
    assert _replay(spec, tsched, SamplingParams, trace, {}) == _replay(plain, tsched, SamplingParams, trace, {})
    assert spec.spec_fused_windows_total > 0 and spec.fused_windows_total == 0
    assert spec.allocator.num_free == free0


def test_attach_draft_refusals(models):
    _, tt = models[0]

    def sched(**kw):
        return tsched.Scheduler(kw.pop("cfg", TCFG), tt, tsched.SchedulerConfig(**{**SCHED, **kw}),
                                dtype=torch.float32, device="cpu")

    with pytest.raises(ValueError, match="block_size"):
        sched().attach_draft(TCFG.replace(block_size=32), tt)
    with pytest.raises(ValueError, match="vocabulary"):
        sched().attach_draft(TCFG.replace(vocab_size=512), tt)
    with pytest.raises(ValueError, match="gamma"):
        sched().attach_draft(TCFG, tt, gamma=0)
    with pytest.raises(NotImplementedError, match="checkpoint"):
        EngineArgs(model="tiny", draft_model="tiny", draft_checkpoint_path="/nonexistent")
    # Where the fused spec window cannot run (one step an iteration, the
    # per-piece path, γ past the kernel's 8), the draft attaches and
    # speculates one round an iteration.
    for s, gamma in ((sched(num_scheduler_steps=1), GAMMA), (sched(cfg=TCFG.replace(attention_impl="paged")), GAMMA),
                     (sched(), 9)):
        s.attach_draft(TCFG, tt, gamma=gamma)
        assert s.draft_params is not None and not s._use_fused_spec and s._spec_rounds == 0
        s.add_request("r", list(range(1, 20)), SamplingParams(temperature=0.0),
                      tsched.StopConditions(max_tokens=2 * gamma + 3, ignore_eos=True))
        while s.has_work():
            s.step()
        assert s.spec_rounds_total > 0 and s.spec_stats.acceptance_rate == 1.0 and s.spec_fused_windows_total == 0


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    return resp.status, json.loads(raw)


async def _answer(tt, draft, **kw):
    tok = ByteTokenizer()
    args = EngineArgs(model="tiny", dtype="float32", device="cpu", eos_token_ids=tok.eos_token_ids,
                      scheduler=tsched.SchedulerConfig(**SCHED), draft_model="tiny" if draft else None,
                      spec_gamma=4, **kw)
    engine = TorchEngine.build(args, params=tt, draft_params=tt if draft else None)
    service = HttpService({"tiny": build_local_pipeline(tok, engine)}, host="127.0.0.1", port=0)
    await service.start()
    try:
        answer = await asyncio.to_thread(_post, service.port, {"model": "tiny", "prompt": "speculate on this",
                                                               "max_tokens": 20, "temperature": 0.0})
    finally:
        await service.stop()
        await engine.stop()
    return answer, engine.metrics().spec_decode


def test_engine_with_draft_serves_over_http(models):
    _, tt = models[0]
    (status, body), stats = asyncio.run(_answer(tt, draft=True))
    (status0, body0), stats0 = asyncio.run(_answer(tt, draft=False))
    assert status == status0 == 200
    assert body["choices"][0]["text"] == body0["choices"][0]["text"]
    assert stats0 is None and stats["num_rounds"] > 0 and stats["acceptance_rate"] == 1.0


def test_run_flags_attach_a_draft(models):
    from dynamo_tpu_torch import run

    _, tt = models[0]
    args = run.parse_args(["in=http", "out=tiny", "--device", "cpu", "--dtype", "float32", "--num-blocks", "16",
                           "--http-port", "0", "--draft-model", "tiny", "--spec-gamma", "3"])
    assert (args.draft_model, args.spec_gamma) == ("tiny", 3)
    _, engine = run.build_service(args, draft_params=tt)
    sched = engine.scheduler
    assert sched.draft_params is tt and sched.spec_gamma == 3 and sched._spec_rounds == 32 // 4
    # Without draft_params the draft gets seeded random weights at its preset's widths.
    _, engine = run.build_service(args)
    assert engine.scheduler.draft_params["embed"].shape == tt["embed"].shape
    assert not torch.equal(engine.scheduler.draft_params["embed"], engine.scheduler.params["embed"])


async def _serve_once(service, engine, body):
    await service.start()
    try:
        return await asyncio.to_thread(_post, service.port, body)
    finally:
        await service.stop()
        await engine.stop()


def test_run_int8_kv_with_draft_serves_over_http(models):
    """``run --kv-cache-dtype int8 --draft-model tiny --spec-gamma 3``: no
    fused window under int8, so the draft speculates per round, and the
    greedy answer is the one of the same flags without the draft."""
    from dynamo_tpu_torch import run

    _, tt = models[0]
    flags = ["in=http", "out=tiny", "--device", "cpu", "--dtype", "float32", "--num-blocks", "32", "--http-port", "0",
             "--kv-cache-dtype", "int8"]
    body = {"model": "tiny", "prompt": "speculate in int8", "max_tokens": 16, "temperature": 0.0}
    answers = []
    for extra in (["--draft-model", "tiny", "--spec-gamma", "3"], []):
        service, engine = run.build_service(run.parse_args(flags + extra), draft_params=tt if extra else None)
        sched = engine.scheduler
        answers.append(asyncio.run(_serve_once(service, engine, body)))
        if extra:
            assert not sched._use_fused_spec and sched.spec_rounds_total > 0
            assert sched.spec_stats.num_rounds == sched.spec_rounds_total
    (status, got), (status0, want) = answers
    assert status == status0 == 200 and got["choices"][0]["text"] == want["choices"][0]["text"]
