"""The port's overlapped decode and its graph-safe step functions, against
the JAX package.

1. Scheduler: the port's ``Scheduler`` and the JAX one, both with
   ``enable_overlap_decode=True`` at one decode step per iteration, replay
   the cases of ``tests/test_overlap_decode.py`` on ``tiny`` in f32 from the
   same weights (``params_from_numpy``): greedy streams of several
   requests (on the megakernel path, which runs the port's step graphs'
   code eagerly here, and on the gather path), a row that finishes while
   its next step is in flight (its KV slot rolled back; every block equal
   to JAX's), an admission that flushes the pipeline, and streams that run
   one step behind. Tokens, finish reasons, the per-iteration token counts
   and the ``overlap_steps_total`` / ``overlap_flushes_total`` counters are
   equal.
2. ``llama.decode_sample`` against the JAX one: sampled tokens and
   ``next_tpa`` exact, greedy and sampled from one key.
3. ``prefill`` and ``mixed_step`` with their scalars as 0-d tensors, as a
   CUDA graph feeds them, against JAX at the bound of
   ``tests/test_llama_model.py``; the written cache to 2e-5.
4. ``sample_batch_device`` (no host read: every row drawn, greedy rows
   selected on the device) against the host split that drew only the
   sampled rows (``_host_split_draw``) and against JAX's ``sample_batch``:
   bit-equal tokens; with no key, the argmax.
5. ``decode_multi`` (the window's steps as ``decode_multi_step``, keys
   from ``prng.split_many``) against JAX's on a sampled window.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.kv_cache import KvCacheArrays as JaxCache
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.sampling import SamplingParams as JaxSampling
from dynamo_tpu_torch.engine import prng
from dynamo_tpu_torch.engine import sampling as tsampling
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.graphs import StepGraphs
from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.weights import params_from_numpy

TCFG = get_config("tiny").replace(max_seq_len=4096)
JCFG = jax_config("tiny").replace(max_seq_len=4096)
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
KV_ATOL = 2e-5
SCHED = dict(num_blocks=256, max_running=8, prefill_buckets=[32, 64], decode_buckets=[1, 2, 4, 8],
             num_scheduler_steps=1, enable_prefix_caching=False)


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_numpy(tree, TCFG, device="cpu", dtype=torch.float32)


def _pair(weights, impl="megakernel", **kw):
    """A JAX and a port scheduler with the same knobs (overlap on by
    default in both) and weights."""
    jp, tp = weights
    j = jsched.Scheduler(JCFG.replace(attention_impl=impl), jp, jsched.SchedulerConfig(**SCHED, **kw),
                         dtype=jnp.float32)
    t = tsched.Scheduler(TCFG.replace(attention_impl=impl), tp, tsched.SchedulerConfig(**SCHED, **kw),
                         dtype=torch.float32, device="cpu")
    assert t.sc.enable_overlap_decode == j.sc.enable_overlap_decode == kw.get("enable_overlap_decode", True)
    return j, t


def _add(sched, mod, sampling_cls, rid, prompt, max_tokens, temperature=0.0):
    sched.add_request(rid, prompt, sampling_cls(temperature=temperature),
                      mod.StopConditions(max_tokens=max_tokens, ignore_eos=True))


def _drain(sched, hook=None):
    """Run to completion → ({request id: tokens}, tokens emitted per iteration)."""
    out, per_step = {}, []
    for _ in range(4000):
        if not sched.has_work():
            break
        n = 0
        for seq, o in sched.step():
            if o.token_id >= 0:
                out.setdefault(seq.request_id, []).append(o.token_id)
                n += 1
        per_step.append(n)
        if hook is not None:
            hook(sched)
    assert not sched.has_work(), "scheduler did not drain"
    return out, per_step


def _counters(s):
    return s.overlap_steps_total, s.overlap_flushes_total, s._step_counter


# ---------------------------------------------------------------------------
# 1. The overlapped pipeline against the JAX scheduler's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["megakernel", "gather"])
def test_overlap_greedy_multi_request_matches_jax(weights, impl):
    reqs = [(f"r{i}", list(range(3 + i, 23 + i)), 20 + 7 * i) for i in range(4)]
    j, t = _pair(weights, impl)
    for s, mod, cls in ((j, jsched, JaxSampling), (t, tsched, SamplingParams)):
        for rid, prompt, mt in reqs:
            _add(s, mod, cls, rid, prompt, mt)
    want, want_steps = _drain(j)
    got, got_steps = _drain(t)
    assert got == want
    assert all(len(got[rid]) == mt for rid, _, mt in reqs)
    assert got_steps == want_steps
    assert _counters(t) == _counters(j)
    assert t.overlap_steps_total > 0 and t.overlap_flushes_total > 0
    m = t.metrics()
    assert (m.overlap_steps_total, m.overlap_flushes_total) == (j.overlap_steps_total, j.overlap_flushes_total)
    # Every dispatch is a decode forward step of the port's accounting.
    assert t.prefill_steps_total + t.decode_steps_total + t.mixed_steps_total == t.forward_steps_total
    # The sync path gives the same greedy streams.
    _, s = _pair(weights, impl, enable_overlap_decode=False)
    for rid, prompt, mt in reqs:
        _add(s, tsched, SamplingParams, rid, prompt, mt)
    assert _drain(s)[0] == got and s.overlap_steps_total == 0


def test_finish_mid_pipeline_rolls_back_kv_slot_as_jax(weights):
    """"short" stops while "long" decodes: the in-flight step's token for
    it is discarded and the KV slot that step wrote is zeroed, in both
    packages; every block of the cache then agrees with JAX's."""
    bs = TCFG.block_size
    p = 20 + 6 - 1  # short's final token slot

    def run(s, mod, cls, as_np):
        _add(s, mod, cls, "short", list(range(5, 25)), 6)
        _add(s, mod, cls, "long", list(range(7, 27)), 40)
        blocks, slot = {}, [None]

        def snapshot(sched):
            for rid in ("short", "long"):
                seq = sched.by_id.get(rid)
                if seq is not None and seq.block_ids:
                    blocks[rid] = list(seq.block_ids)
            if slot[0] is None and "short" not in sched.by_id and "short" in blocks:
                blk = blocks["short"][p // bs]
                slot[0] = as_np(sched.cache.k)[:, blk, p % bs].copy()

        toks, _ = _drain(s, hook=snapshot)
        return toks, blocks, slot[0]

    j, t = _pair(weights)
    want, jblocks, jslot = run(j, jsched, JaxSampling, np.asarray)
    got, tblocks, tslot = run(t, tsched, SamplingParams, lambda k: k.numpy())
    assert got == want and len(got["short"]) == 6 and len(got["long"]) == 40
    assert tblocks == jblocks
    assert t.overlap_flushes_total == j.overlap_flushes_total >= 1
    np.testing.assert_array_equal(tslot, 0.0)
    np.testing.assert_array_equal(jslot, 0.0)
    # The whole cache but the scratch block: rolled-back slots, the long
    # row's final slot (zeroed at its own finish) and every row written.
    for tc, jc in ((t.cache.k, j.cache.k), (t.cache.v, j.cache.v)):
        np.testing.assert_allclose(tc.numpy()[:, 1:], np.asarray(jc)[:, 1:], atol=KV_ATOL)
    final = tblocks["long"][(20 + 40 - 1) // bs]
    np.testing.assert_array_equal(t.cache.k.numpy()[:, final, (20 + 40 - 1) % bs], 0.0)


def test_admission_flushes_the_pipeline_as_jax(weights):
    j, t = _pair(weights)
    results = []
    for s, mod, cls in ((j, jsched, JaxSampling), (t, tsched, SamplingParams)):
        for i in range(3):
            _add(s, mod, cls, f"r{i}", list(range(2 + i, 22 + i)), 30)
        state = {"added": False, "flushes": 0}

        def hook(sched, mod=mod, cls=cls, state=state):
            if not state["added"] and sched._pipe is not None:
                state["flushes"] = sched.overlap_flushes_total
                _add(sched, mod, cls, "late", list(range(40, 60)), 12)
                state["added"] = True

        toks, per_step = _drain(s, hook=hook)
        assert state["added"] and s.overlap_flushes_total > state["flushes"]
        results.append((toks, per_step, _counters(s)))
    assert results[1] == results[0]
    assert len(results[1][0]["late"]) == 12


def test_streams_run_one_step_behind_as_jax(weights):
    """The pipeline's first launch emits nothing; each later iteration
    retires one step, one token per row, in both packages."""
    j, t = _pair(weights)
    traces = []
    for s, mod, cls in ((j, jsched, JaxSampling), (t, tsched, SamplingParams)):
        _add(s, mod, cls, "r0", list(range(4, 24)), 50)
        while s.waiting:
            s.step()
        starts = []
        for _ in range(20):
            before = s._pipe
            outs = s.step()
            if before is None and s._pipe is not None:
                assert outs == []
                starts.append(len(outs))
                break
        outs = s.step()
        assert sum(1 for _, o in outs if o.token_id >= 0) == 1
        traces.append((starts, _drain(s)[1], _counters(s)))
    assert traces[1] == traces[0]


def test_sampled_rows_ride_the_pipeline_as_jax(weights):
    """Unseeded sampled rows beside greedy ones: each launch draws from the
    step counter's key on the device (``sample_batch_device``), the same
    tokens JAX's ``decode_sample`` draws."""
    j, t = _pair(weights)
    outs = []
    for s, mod, cls in ((j, jsched, JaxSampling), (t, tsched, SamplingParams)):
        _add(s, mod, cls, "g", list(range(9, 29)), 18)
        _add(s, mod, cls, "s", list(range(30, 41)), 22, temperature=0.9)
        outs.append((_drain(s), _counters(s)))
    assert outs[1] == outs[0]
    assert t.overlap_steps_total > 0


# ---------------------------------------------------------------------------
# 2-5. The graph-safe step functions
# ---------------------------------------------------------------------------


def _caches(blocks=32):
    jc = JaxCache.create(JCFG, blocks, dtype=jnp.float32)
    tc = KvCacheArrays.create(TCFG, blocks, dtype=torch.float32, device="cpu")
    return jc, tc


def _fill(weights, jc, tc, toks, table):
    """Prefill ``toks`` into both caches (ints, the eager paths' form)."""
    jp, tp = weights
    padded = np.zeros(32, np.int32)
    padded[: len(toks)] = toks
    _, jk, jv = jllama.prefill(jp, JCFG, jc.k, jc.v, jnp.asarray(padded), jnp.int32(len(toks)), jnp.int32(0),
                               jnp.asarray(table))
    tllama.prefill(tp, TCFG, tc.k, tc.v, torch.from_numpy(padded), len(toks), 0, torch.from_numpy(table))
    return jk, jv


@pytest.mark.parametrize("sampled", [False, True])
def test_decode_sample_matches_jax(weights, sampled):
    jp, tp = weights
    jc, tc = _caches()
    rng = np.random.default_rng(3)
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [0, 0, 0, 0]], np.int32)
    jk, jv = jc.k, jc.v
    for r in range(2):
        jk, jv = _fill(weights, JaxCache(jk, jv), tc, rng.integers(1, 255, size=18 + r), tables[r])
    tpa = np.array([[7, 9, 0], [18, 19, 0], [1, 1, 0]], np.int32)
    temps = np.array([0.9 if sampled else 0.0, 0.0, 0.0], np.float32)
    top_ks = np.array([0, 0, 0], np.int32)
    top_ps = np.array([0.95, 1.0, 1.0], np.float32)
    key = prng.fold_in(prng.PRNGKey(5), 11)
    js, jn, jk, jv = jllama.decode_sample(jp, JCFG, jk, jv, jnp.asarray(tpa), jnp.asarray(tables),
                                          jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps),
                                          jnp.asarray(key))
    ts, tn, _, _ = tllama.decode_sample(tp, TCFG, tc.k, tc.v, torch.from_numpy(tpa), torch.from_numpy(tables),
                                        torch.from_numpy(temps), torch.from_numpy(top_ks),
                                        torch.from_numpy(top_ps), torch.from_numpy(key.view(np.int32)))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert ts.dtype == tn.dtype == torch.int32
    np.testing.assert_allclose(tc.k.numpy()[:, 1:], np.asarray(jk)[:, 1:], atol=KV_ATOL)


def test_prefill_and_mixed_step_take_device_scalars(weights):
    """The megakernel path's ``prefill`` and ``mixed_step`` with
    ``valid_len``/``cache_len`` and ``p_valid``/``p_cache_len`` as 0-d
    int32 tensors (read by a graph from its static buffer) against JAX,
    the chunk's table and the decode tables at one width."""
    jp, tp = weights
    jc, tc = _caches()
    rng = np.random.default_rng(4)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32)  # noqa: E731
    table = np.array([1, 2, 3, 0], np.int32)
    toks = rng.integers(1, 255, size=20)
    padded = np.zeros(32, np.int32)
    padded[:20] = toks
    jl, jk, jv = jllama.prefill(jp, JCFG, jc.k, jc.v, jnp.asarray(padded), jnp.int32(20), jnp.int32(0),
                                jnp.asarray(table))
    tl, _, _ = tllama.prefill(tp, TCFG, tc.k, tc.v, torch.from_numpy(padded), i32(20), i32(0),
                              torch.from_numpy(table))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    # A continuation chunk of 9 over the 20 cached, beside two decode rows.
    jk2, jv2 = _fill(weights, JaxCache(jk, jv), tc, rng.integers(1, 255, size=12), np.array([5, 0, 0, 0], np.int32))
    chunk = np.zeros(32, np.int32)
    chunk[:9] = rng.integers(1, 255, size=9)
    dtoks, dpos = np.array([4, 0], np.int32), np.array([12, 0], np.int32)
    dtables = np.array([[5, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    active = np.array([True, False])
    jl, jk3, jv3 = jllama.mixed_step(jp, JCFG, jk2, jv2, jnp.asarray(chunk), jnp.int32(9), jnp.int32(20),
                                     jnp.asarray(table), jnp.asarray(dtoks), jnp.asarray(dpos), jnp.asarray(dtables),
                                     jnp.asarray(active))
    tl, _, _ = tllama.mixed_step(tp, TCFG, tc.k, tc.v, torch.from_numpy(chunk), i32(9), i32(20),
                                 torch.from_numpy(table), torch.from_numpy(dtoks), torch.from_numpy(dpos),
                                 torch.from_numpy(dtables), torch.from_numpy(active))
    # The chunk row and the live decode row (a dead lane's logits mean nothing).
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **LOGIT_TOL)
    np.testing.assert_allclose(tc.k.numpy()[:, 1:], np.asarray(jk3)[:, 1:], atol=KV_ATOL)
    np.testing.assert_allclose(tc.v.numpy()[:, 1:], np.asarray(jv3)[:, 1:], atol=KV_ATOL)


def test_step_graphs_run_the_eager_functions_on_the_cpu(weights):
    """On the CPU ``StepGraphs`` stages its packed inputs and runs the step
    functions eagerly: the same logits and tokens as direct calls, and no
    capture."""
    _, tp = weights
    tc = KvCacheArrays.create(TCFG, 32, dtype=torch.float32, device="cpu")
    tc2 = KvCacheArrays.create(TCFG, 32, dtype=torch.float32, device="cpu")
    g = StepGraphs("cpu")
    rng = np.random.default_rng(6)
    padded = np.zeros(32, np.int32)
    padded[:17] = rng.integers(1, 255, size=17)
    table = np.array([1, 2, 0, 0], np.int32)
    want, _, _ = tllama.prefill(tp, TCFG, tc2.k, tc2.v, torch.from_numpy(padded), 17, 0, torch.from_numpy(table))
    got = g.prefill("target", tp, TCFG, tc, padded, 17, 0, table)
    torch.testing.assert_close(got[0], want, rtol=0, atol=0)
    tpa = np.array([[5], [17], [1]], np.int32)
    tables = table[None]
    temps, top_ks, top_ps = np.array([0.8], np.float32), np.zeros(1, np.int32), np.ones(1, np.float32)
    key = prng.PRNGKey(9)
    sampled, next_tpa = g.decode_sample(tp, TCFG, tc, tpa, tables, temps, top_ks, top_ps, key)
    ws, wn, _, _ = tllama.decode_sample(tp, TCFG, tc2.k, tc2.v, torch.from_numpy(tpa), torch.from_numpy(tables),
                                        torch.from_numpy(temps), torch.from_numpy(top_ks), torch.from_numpy(top_ps),
                                        key)
    assert torch.equal(sampled, ws) and torch.equal(next_tpa, wn)
    torch.testing.assert_close(tc.k, tc2.k, rtol=0, atol=0)
    # An all-greedy batch (no key): the greedy graph, the argmax.
    tpa[1] += 1
    sampled, next_tpa = g.decode_sample(tp, TCFG, tc, tpa, tables, temps * 0, top_ks, top_ps, None)
    ws, wn, _, _ = tllama.decode_sample(tp, TCFG, tc2.k, tc2.v, torch.from_numpy(tpa), torch.from_numpy(tables),
                                        None, None, None, None)
    assert torch.equal(sampled, ws) and torch.equal(next_tpa, wn)
    logits = torch.from_numpy(rng.standard_normal((1, TCFG.vocab_size)).astype(np.float32))
    assert torch.equal(g.draw(logits, temps * 0, top_ks, top_ps, None), logits.argmax(-1).to(torch.int32))
    assert g.captures_total == 0 and len(g) == 4
    assert ("decode_sample", 1, 4, True) in g and ("draw", 1, "greedy") in g


def _host_split_draw(logits, temps, top_ks, top_ps, key, row_keys):
    """The eager draw before the step graphs: the sampled rows picked on
    the host, drawn alone, written over the argmax."""
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    rows = np.nonzero(temps > 0)[0]
    V = logits.shape[-1]
    idx = torch.from_numpy(rows)
    scaled = logits[idx] / torch.from_numpy(temps[rows])[:, None]
    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    thresh = tsampling._exact_thresholds(scaled, lse, torch.from_numpy(top_ks[rows]), torch.from_numpy(top_ps[rows]))
    masked = torch.where(scaled >= thresh[:, None], scaled, torch.full_like(scaled, -float("inf")))
    if row_keys is not None:
        noise = prng.gumbel(np.asarray(row_keys)[rows], (V,), "cpu")
    else:
        noise = prng.gumbel(key, tuple(logits.shape), "cpu")[idx]
    tokens[idx] = torch.argmax(masked + noise, dim=-1).to(torch.int32)
    return tokens.numpy()


def test_engine_stop_destroys_the_step_graphs(weights):
    """``TorchEngine.stop`` closes the scheduler: its step graphs go at
    once (on the card their executables and pool, which the garbage
    collector would otherwise free in the middle of a later engine's
    steps), and the counters stay readable."""
    import asyncio

    from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine

    _, tp = weights
    engine = TorchEngine.build(EngineArgs(model="tiny", dtype="float32", device="cpu",
                                          scheduler=tsched.SchedulerConfig(**SCHED)), params=tp)
    s = engine.scheduler
    n = s.warmup(64)
    assert n > 0 and len(s._graphs) == n
    asyncio.run(engine.stop())
    assert len(s._graphs) == 0 and s.graph_captures_after_warmup == 0


@pytest.mark.parametrize("seeded", [False, True])
def test_sample_batch_device_matches_the_host_split(seeded):
    from dynamo_tpu.engine import sampling as jsampling

    rng = np.random.default_rng(7)
    B, V = 6, 300
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32) * 3)
    temps = np.array([0.0, 0.7, 1.3, 0.0, 1.0, 0.5], np.float32)
    top_ks = np.array([0, 0, 20, 5, 0, 40], np.int32)
    top_ps = np.array([1.0, 0.9, 1.0, 1.0, 0.6, 0.95], np.float32)
    key = prng.fold_in(prng.PRNGKey(1), 3)
    row_keys = None
    if seeded:
        row_keys = tsampling.make_row_keys(key, np.array([11, 0, 12, 0, 13, 0], np.int32), np.arange(B),
                                           np.array([1, 0, 1, 0, 1, 0], bool))
    want = _host_split_draw(logits, temps, top_ks, top_ps, key, row_keys)
    jax_want = np.asarray(jsampling.sample_batch(
        jnp.asarray(logits.numpy()), jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps), jnp.asarray(key),
        None if row_keys is None else jnp.asarray(row_keys)))
    np.testing.assert_array_equal(want, jax_want)
    np.testing.assert_array_equal(
        tsampling.sample_batch_device(logits, temps, top_ks, top_ps, key, row_keys).cpu().numpy(), want)
    for k, rk in ((key, row_keys), (torch.from_numpy(key.view(np.int32)),
                                    None if row_keys is None else torch.from_numpy(row_keys.view(np.int32)))):
        got = tsampling.sample_batch_device(logits, torch.from_numpy(temps), torch.from_numpy(top_ks),
                                            torch.from_numpy(top_ps), k, rk)
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want[temps == 0] == logits.argmax(-1).numpy()[temps == 0]).all()
    greedy = tsampling.sample_batch_device(logits, torch.from_numpy(temps), torch.from_numpy(top_ks),
                                           torch.from_numpy(top_ps), None, None)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1).numpy())


def test_decode_multi_sampled_window_matches_jax(weights):
    """A 6-step sampled window: the port's steps (one ``decode_multi_step``
    each, keys from ``prng.split_many``, a per-step cache write) and JAX's
    ``decode_multi`` give the same tokens and the same cache."""
    jp, tp = weights
    jc, tc = _caches()
    rng = np.random.default_rng(8)
    tables = np.array([[1, 2, 0, 0], [3, 4, 0, 0]], np.int32)
    jk, jv = jc.k, jc.v
    for r in range(2):
        jk, jv = _fill(weights, JaxCache(jk, jv), tc, rng.integers(1, 255, size=14 + r), tables[r])
    toks, pos, active = np.array([8, 3], np.int32), np.array([14, 15], np.int32), np.array([True, True])
    temps, top_ks, top_ps = np.array([1.0, 0.0], np.float32), np.array([0, 0], np.int32), np.array([0.9, 1.0],
                                                                                                   np.float32)
    key = prng.PRNGKey(21)
    jout, jk, jv = jllama.decode_multi(jp, JCFG, jk, jv, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(tables),
                                       jnp.asarray(active), jnp.asarray(temps), jnp.asarray(top_ks),
                                       jnp.asarray(top_ps), jnp.asarray(key), 6)
    tout, _, _ = tllama.decode_multi(tp, TCFG, tc.k, tc.v, torch.from_numpy(toks), torch.from_numpy(pos),
                                     torch.from_numpy(tables), torch.from_numpy(active), temps, top_ks, top_ps,
                                     key, 6)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_allclose(tc.k.numpy()[:, 1:], np.asarray(jk)[:, 1:], atol=KV_ATOL)
    subs, k = [], key
    for _ in range(6):
        k, sub = prng.split(k)
        subs.append(sub)
    np.testing.assert_array_equal(prng.split_many(key, 6), np.stack(subs))
