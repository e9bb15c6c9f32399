"""The port's per-request extras against the JAX package.

1. Functions: ``apply_penalties``, ``compute_logprobs``,
   ``compute_topk_logprobs`` (also at the full llama vocabulary with tied
   logits, where the top ids must be JAX's: the lower id first on a tie),
   the draws that return logprobs, plain and guided (the guided ones of
   the masked distribution), and the five stock logits processors and
   ``apply_chain``, on the same seeded numpy inputs.
2. Scheduler: the port's ``Scheduler`` and the JAX one on ``tiny`` (f32,
   wave admission on in both) replay one batch that mixes greedy and
   seeded sampled plain rows with a logprobs row, a ``top_logprobs`` row,
   a penalties row, a ``logit_bias`` row and a guided row with logprobs
   (logprobs of the masked distribution, the first token's of the
   unmasked logits, as in JAX): the same tokens, logprobs
   within the model's f32 tolerance, the same top ids. At one step an
   iteration, at 8-step windows on the megakernel path (the plain rows
   ride fused windows through the row-wise fallback while the extras rows
   single-step), on the per-piece path and over an int8 KV cache.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu import logits_processing as jlp
from dynamo_tpu.engine import sampling as jsampling
from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu_torch import logits_processing as tlp
from dynamo_tpu_torch.engine import prng
from dynamo_tpu_torch.engine import sampling as tsampling
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from tests.test_torch_sampling import _guided_batch, _rows

# The f32 model tolerance of the port against JAX (test_llama_model.py).
TOL = 2e-4


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


# ---------------------------------------------------------------------------
# 1. Functions
# ---------------------------------------------------------------------------


def _history(seed, B, V, H=32):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, V, size=(B, H)).astype(np.int32)
    hist[:, H // 2:] = hist[:, : H - H // 2]  # repeats, so counts reach 2 and more
    hist_len = rng.integers(0, H + 1, size=B).astype(np.int32)
    freq = rng.uniform(-2, 2, size=B).astype(np.float32)
    pres = rng.uniform(-2, 2, size=B).astype(np.float32)
    freq[0] = pres[0] = 0.0
    return hist, hist_len, freq, pres


@pytest.mark.parametrize("seed", range(3))
def test_apply_penalties_matches_jax(seed):
    logits = _rows(seed)[0]
    args = (logits, *_history(seed, *logits.shape))
    want = np.asarray(jsampling.apply_penalties(*_j(*args)))
    got = tsampling.apply_penalties(*_t(*args)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], logits[0])  # no penalty: unchanged


@pytest.mark.parametrize("seed", range(3))
def test_logprobs_match_jax(seed):
    logits = _rows(seed)[0]
    tokens = np.random.default_rng(seed).integers(0, logits.shape[1], size=len(logits)).astype(np.int32)
    want = np.asarray(jsampling.compute_logprobs(*_j(logits, tokens)))
    got = tsampling.compute_logprobs(*_t(logits, tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    w_chosen, w_ids, w_lps = (np.asarray(x) for x in jsampling.compute_topk_logprobs(*_j(logits, tokens)))
    g_chosen, g_ids, g_lps = (x.numpy() for x in tsampling.compute_topk_logprobs(*_t(logits, tokens)))
    np.testing.assert_array_equal(g_ids, w_ids)
    assert g_ids.dtype == np.int32 and g_ids.shape == (len(logits), tsampling.TOP_LOGPROBS_CAP)
    np.testing.assert_allclose(g_chosen, w_chosen, atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_lps, w_lps, atol=1e-5, rtol=0)


def test_topk_logprobs_break_ties_as_jax_at_full_vocabulary():
    """[4, 128256] logits on a coarse grid, so the best 20 hold many ties
    (and ties cross the 20th place): the top ids are JAX's, order and all.
    Row 3 is all one value."""
    V = 128256
    rng = np.random.default_rng(5)
    logits = (np.round(rng.standard_normal((4, V)) * 2) / 2).astype(np.float32)
    logits[1, rng.choice(V, size=50, replace=False)] = logits[1].max()
    logits[2, :40] = 9.0
    logits[3] = -1.5
    tokens = np.array([0, 7, 39, V - 1], np.int32)
    w_chosen, w_ids, w_lps = (np.asarray(x) for x in jsampling.compute_topk_logprobs(*_j(logits, tokens)))
    g_chosen, g_ids, g_lps = (x.numpy() for x in tsampling.compute_topk_logprobs(*_t(logits, tokens)))
    np.testing.assert_array_equal(g_ids, w_ids)
    np.testing.assert_array_equal(g_ids[2], np.arange(20))
    # A log-sum-exp over 128256 f32 terms, summed in another order: 1e-5
    # relative.
    np.testing.assert_allclose(g_lps, w_lps, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(g_chosen, w_chosen, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_logprob_draws_match_jax(seed):
    """``sample_batch_logprobs`` / ``sample_batch_top_logprobs`` draw JAX's
    tokens from the same key (one for the batch and per-row keys) and
    return its logprobs and alternatives."""
    logits, temps, top_ks, top_ps, _ = _rows(40 + seed)
    key = prng.fold_in(prng.PRNGKey(seed), 5)
    row_keys = tsampling.make_row_keys(key, np.arange(8, dtype=np.int32) * 3, np.arange(8, dtype=np.int32),
                                       np.arange(8) % 2 == 0)
    t = torch.from_numpy(logits)
    for rk in (None, row_keys):
        jrk = None if rk is None else jnp.asarray(rk)
        w_tok, w_lp = (np.asarray(x) for x in jsampling.sample_batch_logprobs(
            *_j(logits, temps, top_ks, top_ps), jnp.asarray(key), jrk))
        g_tok, g_lp = (x.numpy() for x in tsampling.sample_batch_logprobs(t, temps, top_ks, top_ps, key, rk))
        np.testing.assert_array_equal(g_tok, w_tok)
        np.testing.assert_allclose(g_lp, w_lp, atol=1e-5, rtol=0)
        want = [np.asarray(x) for x in jsampling.sample_batch_top_logprobs(
            *_j(logits, temps, top_ks, top_ps), jnp.asarray(key), jrk)]
        got = [x.numpy() for x in tsampling.sample_batch_top_logprobs(t, temps, top_ks, top_ps, key, rk)]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
        for g, w in ((got[1], want[1]), (got[3], want[3])):
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", range(2))
def test_guided_logprob_draws_match_jax(seed):
    """The guided draws' logprobs are of the masked distribution, as JAX's:
    every chosen logprob is finite, and a row allowing one token has
    logprob 0."""
    logits, pool, sets, rows, temps, top_ks, top_ps = _guided_batch(60 + seed)
    key = prng.fold_in(prng.PRNGKey(seed), 13)
    k_rows = np.stack([top_ks, rows])
    t, tpool = torch.from_numpy(logits), torch.from_numpy(pool.view(np.int32))
    jargs = (*_j(logits, pool, k_rows, temps, top_ps), jnp.asarray(key))
    w_tok, w_lp = (np.asarray(x) for x in jsampling.guided_sample_batch_logprobs(*jargs))
    g_tok, g_lp = (x.numpy() for x in tsampling.guided_sample_batch_logprobs(t, tpool, k_rows, temps, top_ps, key))
    np.testing.assert_array_equal(g_tok, w_tok)
    np.testing.assert_allclose(g_lp, w_lp, atol=1e-5, rtol=0)
    assert np.isfinite(g_lp).all() and abs(g_lp[1]) < 1e-6
    want = [np.asarray(x) for x in jsampling.guided_sample_batch_top_logprobs(*jargs)]
    got = [x.numpy() for x in tsampling.guided_sample_batch_top_logprobs(t, tpool, k_rows, temps, top_ps, key)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    for g, w in ((got[1], want[1]), (got[3], want[3])):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


PROCESSORS = {
    "temperature": lambda m: m.TemperatureProcessor(0.7),
    "repetition": lambda m: m.RepetitionPenaltyProcessor(1.3),
    "min_p": lambda m: m.MinPProcessor(0.2),
    # Out-of-range ids are clipped and their bias zeroed; string keys as
    # raw OpenAI JSON sends them.
    "logit_bias": lambda m: m.LogitBiasProcessor({"3": 100, 17: -100, 299: 2.5, 1000: 50, -4: 7}),
    "empty_bias": lambda m: m.LogitBiasProcessor({}),
    "allowed": lambda m: m.AllowedTokensProcessor([1, 5, 77, 299]),
}


@pytest.mark.parametrize("name", list(PROCESSORS))
def test_processor_matches_jax(name):
    logits = _rows(3)[0]
    history = [5, 9, 5, 299, 0, 42]
    for row in range(3):
        want = np.asarray(PROCESSORS[name](jlp)(history, jnp.asarray(logits[row])))
        got = PROCESSORS[name](tlp)(history, torch.from_numpy(logits[row])).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    # The repetition penalty with no history yet leaves the logits alone.
    if name == "repetition":
        np.testing.assert_array_equal(PROCESSORS[name](tlp)([], torch.from_numpy(logits[0])).numpy(), logits[0])


def test_apply_chain_matches_jax():
    logits = _rows(4)[0][2]
    history = [1, 2, 2, 3]
    chain = ("logit_bias", "repetition", "temperature", "min_p")
    want = np.asarray(jlp.apply_chain([PROCESSORS[n](jlp) for n in chain], history, jnp.asarray(logits)))
    got = tlp.apply_chain([PROCESSORS[n](tlp) for n in chain], history, torch.from_numpy(logits)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert isinstance(tlp.LogitBiasProcessor({1: 1}), tlp.BaseLogitsProcessor)


# ---------------------------------------------------------------------------
# 2. Scheduler against scheduler
# ---------------------------------------------------------------------------

TCFG = get_config("tiny")
JCFG = jax_config("tiny")
BUCKETS = dict(prefill_buckets=[32, 64], decode_buckets=[1, 2, 4, 8])


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_numpy(tree, TCFG, device="cpu", dtype=torch.float32)


# Request id → (sampling options, logit bias or None). G1/G2 greedy, S1 a
# seeded sampled row, S2 unseeded sampled; LP logprobs, TL top_logprobs
# (and sampled), PEN penalties, LB a logit bias steering a greedy row, GLP
# a seeded sampled guided row (GUIDED) with logprobs.
EXTRAS = {
    "G1": ({"temperature": 0.0}, None),
    "S1": ({"temperature": 0.9, "top_k": 40, "seed": 77}, None),
    "LP": ({"temperature": 0.0, "logprobs": True}, None),
    "G2": ({"temperature": 0.0}, None),
    "TL": ({"temperature": 0.8, "top_p": 0.9, "logprobs": True, "top_logprobs": 5}, None),
    "PEN": ({"temperature": 0.0, "frequency_penalty": 1.5, "presence_penalty": 0.5}, None),
    "S2": ({"temperature": 1.1}, None),
    "LB": ({"temperature": 0.0}, {"65": 4.0, 66: 3.0, 300: 9.0}),
    "GLP": ({"temperature": 0.7, "seed": 5, "logprobs": True}, None),
}
GUIDED = {"GLP": {"kind": "regex", "pattern": r"[a-c]{2}-\d{24}"}}


def _extras_trace():
    """(arrival step, request id, prompt, max_tokens): a burst of short
    prompts at step 0 (one wave for the rows it may admit), later rows
    that join while the burst decodes (mixed steps and first tokens off
    the wave), budgets off the 8-step grid; the guided row's budget holds
    its whole grammar, so it outlives the ``top_logprobs`` row and draws
    both with and without the alternatives."""
    rng = np.random.default_rng(12)
    ids = list(EXTRAS)
    trace = [(0, rid, rng.integers(1, 255, size=int(rng.integers(5, 30))).tolist(), int(rng.integers(18, 30)))
             for rid in ids[:6]]
    trace += [(5, rid, rng.integers(1, 255, size=40).tolist(), 40 if rid in GUIDED else 21) for rid in ids[6:]]
    return trace


def _replay_extras(sched, mod, sampling_cls, bias_cls):
    trace = _extras_trace()
    outs = {}
    for step in range(400):
        for at, rid, prompt, max_tokens in trace:
            if at == step:
                opts, bias = EXTRAS[rid]
                s = sampling_cls(**opts)
                if bias:
                    s.logits_processors = [bias_cls(bias)]
                sched.add_request(rid, prompt, s, mod.StopConditions(max_tokens=max_tokens), guided=GUIDED.get(rid))
        if step > trace[-1][0] and not sched.has_work():
            break
        for seq, out in sched.step():
            outs.setdefault(seq.request_id, []).append(out)
    assert not sched.has_work()
    return {rid: [o for o in res if o.token_id >= 0] for rid, res in outs.items()}


# name → (attention_impl, kv_cache_dtype, num_scheduler_steps)
CASES = {
    "1-step": ("megakernel", "auto", 1),
    "8-step": ("megakernel", "auto", 8),
    "paged": ("paged", "auto", 8),
    "int8-kv": ("megakernel", "int8", 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_extras_batch_matches_jax(weights, case):
    jp, tp = weights
    attn, kv, steps = CASES[case]
    common = dict(num_blocks=64, max_running=8, mixed_prefill_budget=32, num_scheduler_steps=steps, **BUCKETS)
    j = jsched.Scheduler(JCFG.replace(attention_impl=attn, kv_cache_dtype=kv), jp,
                         jsched.SchedulerConfig(**common), dtype=jnp.float32, eos_token_ids=[0])
    t = tsched.Scheduler(TCFG.replace(attention_impl=attn, kv_cache_dtype=kv), tp, tsched.SchedulerConfig(**common),
                         dtype=torch.float32, device="cpu", eos_token_ids=[0])
    assert j._supports_chunk_admit and t._supports_chunk_admit
    j.attach_guided(JaxByteTokenizer())
    t.attach_guided(ByteTokenizer())
    want = _replay_extras(j, jsched, jsampling.SamplingParams, jlp.LogitBiasProcessor)
    got = _replay_extras(t, tsched, tsampling.SamplingParams, tlp.LogitBiasProcessor)
    assert set(got) == set(want) == set(EXTRAS)
    for rid in EXTRAS:
        g, w = got[rid], want[rid]
        assert [o.token_id for o in g] == [o.token_id for o in w], rid
        assert [o.finish_reason for o in g] == [o.finish_reason for o in w], rid
        opts = EXTRAS[rid][0]
        if opts.get("logprobs"):
            assert all(o.logprob is not None for o in g)
            np.testing.assert_allclose([o.logprob for o in g], [o.logprob for o in w], rtol=TOL, atol=TOL)
        else:
            assert all(o.logprob is None for o in g), rid
        if opts.get("top_logprobs"):
            assert all(len(o.top_logprobs) == opts["top_logprobs"] for o in g)
            assert [[i for i, _ in o.top_logprobs] for o in g] == [[i for i, _ in o.top_logprobs] for o in w]
            np.testing.assert_allclose([[lp for _, lp in o.top_logprobs] for o in g],
                                       [[lp for _, lp in o.top_logprobs] for o in w], rtol=TOL, atol=TOL)
        else:
            assert all(o.top_logprobs is None for o in g), rid
    # The logit bias steered its greedy row to the biased ids; the guided
    # row kept to its grammar.
    assert set(o.token_id for o in got["LB"]) <= {65, 66}
    text = ByteTokenizer().decode([o.token_id for o in got["GLP"] if o.token_id != 0])
    assert re.fullmatch(GUIDED["GLP"]["pattern"], text), text
    assert t._step_counter == j._step_counter
    if case == "8-step":
        # The plain rows rode fused windows while the extras rows
        # single-stepped, in the same iterations.
        assert t.rowwise_windows_total >= 1 and t.fused_windows_total == j.flight.fused_windows_total
        assert t.multi_windows_total == 0
    else:
        assert t.rowwise_windows_total == 0
    assert t.wave_steps_total >= 1
