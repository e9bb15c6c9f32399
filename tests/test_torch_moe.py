"""The port's MoE feed-forward (``models/llama.py``) against the JAX package's.

1. The router and the three dispatches on seeded numpy inputs, for the
   (E, K) pairs of ``tests/test_moe.py:106`` and with a ``valid`` mask of
   dead rows: ``_route``'s ids equal and weights to 1e-6; ``_moe_dense``,
   ``_moe_ragged`` and ``_moe_capacity`` to 2e-5; capacity's drop counts
   equal JAX's, also at a capacity factor that drops, and a dead row takes
   no slot.
2. ``tiny-moe`` (4 experts, top 2) in f32 from one set of JAX weights
   (``params_from_numpy``): ``prefill`` (fresh and over a cached prefix),
   ``decode``, ``decode_multi``, ``chunk_decode`` and ``mixed_step``
   logits at the bound of ``tests/test_llama_model.py:65`` (rtol = atol =
   2e-4), the port on its default ragged-kernel path (plain version on
   the CPU) and JAX on its gather; every dispatch's prefill, and capacity's
   ``moe_stats`` counters equal JAX's for each forward.
3. The schedulers: greedy tokens of a few requests (a wave, chunked
   prefill, mixed steps, decode windows) equal the JAX scheduler's for
   each dispatch, and ``moe_dropped_total`` / ``moe_assignments_total``
   under capacity dispatch equal JAX's. MoE gets no fused window and no
   step graphs.
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
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.config import get_config, resolve_moe_dispatch
from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays
from dynamo_tpu_torch.engine.models import get_module
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.weights import init_params, param_shapes, params_from_numpy

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
MOE_TOL = dict(rtol=2e-5, atol=2e-5)
NUM_BLOCKS = 32
TCFG = get_config("tiny-moe")
JCFG = jax_config("tiny-moe")
DISPATCHES = ["dense", "ragged", "capacity"]


def moe_inputs(E, K, T=16, D=32, F=48, seed=0):
    """One layer's router and experts and T rows, seeded numpy (f32)."""
    rng = np.random.default_rng(seed)
    lp = {
        "router": rng.standard_normal((D, E)).astype(np.float32) * 0.5,
        "w_gate": rng.standard_normal((E, D, F)).astype(np.float32) * D**-0.5,
        "w_up": rng.standard_normal((E, D, F)).astype(np.float32) * D**-0.5,
        "w_down": rng.standard_normal((E, F, D)).astype(np.float32) * F**-0.5,
    }
    x = rng.standard_normal((T, D)).astype(np.float32)
    valid = rng.random(T) < 0.6
    valid[0] = True
    over = dict(num_experts=E, num_experts_per_tok=K, hidden_size=D, intermediate_size=F)
    return JCFG.replace(**over), TCFG.replace(**over), lp, x, valid


def both(lp, x, valid=None):
    j = ({k: jnp.asarray(v) for k, v in lp.items()}, jnp.asarray(x), None if valid is None else jnp.asarray(valid))
    t = ({k: torch.from_numpy(v) for k, v in lp.items()}, torch.from_numpy(x),
         None if valid is None else torch.from_numpy(valid))
    return j, t


# ---------------------------------------------------------------------------
# 1. The dispatches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,K", [(4, 2), (8, 3)])
def test_route_matches_jax(E, K):
    jc, tc, lp, x, _ = moe_inputs(E, K)
    (jlp, jx, _), (tlp, tx, _) = both(lp, x)
    jw, ji = jllama._route(jx, jlp, K)
    tw, ti = tllama._route(tx, tlp, K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)


# Dense dispatch takes no valid mask (it computes every row), in both packages.
@pytest.mark.parametrize("dispatch,masked", [("dense", False), ("ragged", False), ("ragged", True),
                                             ("capacity", False), ("capacity", True)])
@pytest.mark.parametrize("E,K", [(4, 2), (8, 3)])
def test_dispatch_matches_jax(E, K, dispatch, masked):
    jc, tc, lp, x, valid = moe_inputs(E, K)
    (jlp, jx, jv), (tlp, tx, tv) = both(lp, x, valid if masked else None)
    if dispatch == "dense":
        want, got = jllama._moe_dense(jx, jlp, jc), tllama._moe_dense(tx, tlp, tc)
    elif dispatch == "ragged":
        want, got = jllama._moe_ragged(jx, jlp, jc, jv), tllama._moe_ragged(tx, tlp, tc, tv)
        if masked:  # dead rows add nothing
            np.testing.assert_array_equal(got.numpy()[~valid], 0.0)
    else:
        (want, jd), (got, td) = jllama._moe_capacity(jx, jlp, jc, jv), tllama._moe_capacity(tx, tlp, tc, tv)
        assert int(td) == int(jd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("factor", [0.5, 1.0])
def test_capacity_drop_counts_match_jax(factor, masked):
    jc, tc, lp, x, valid = moe_inputs(4, 2, T=32, seed=3)
    jc, tc = jc.replace(moe_capacity_factor=factor), tc.replace(moe_capacity_factor=factor)
    (jlp, jx, jv), (tlp, tx, tv) = both(lp, x, valid if masked else None)
    want, jd = jllama._moe_capacity(jx, jlp, jc, jv)
    got, td = tllama._moe_capacity(tx, tlp, tc, tv)
    assert int(td) == int(jd)
    assert int(jd) > 0 or (masked and factor == 1.0)  # few live rows fit at factor 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    # _mlp's stats form returns the same count; the exact dispatches drop none.
    _, d = tllama._mlp(tx, tlp, tc.replace(moe_dispatch="capacity"), tv, stats=True)
    assert int(d) == int(jd)
    for mode in ("ragged", "dense"):
        _, d = tllama._mlp(tx, tlp, tc.replace(moe_dispatch=mode), tv, stats=True)
        assert int(d) == 0


def test_dead_rows_take_no_capacity_slot():
    """JAX ``test_moe.py:250``: 15 identical dead lanes ahead of one live
    lane at capacity factor 1 would fill its experts' slots; masked, the
    live lane keeps them and the dead lanes add nothing."""
    jc, tc, lp, _, _ = moe_inputs(4, 2)
    tc = tc.replace(moe_capacity_factor=1.0)
    rng = np.random.default_rng(9)
    live = rng.standard_normal((1, 32)).astype(np.float32)
    x = np.concatenate([np.repeat(rng.standard_normal((1, 32)).astype(np.float32), 15, 0), live])
    valid = np.zeros(16, bool)
    valid[-1] = True
    (_, _, _), (tlp, tx, tv) = both(lp, x, valid)
    out, dropped = tllama._moe_capacity(tx, tlp, tc, tv)
    assert int(dropped) == 0
    ref, _ = tllama._moe_capacity(torch.from_numpy(live), tlp, tc.replace(moe_capacity_factor=2.0))
    np.testing.assert_allclose(out[-1].numpy(), ref[0].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[:-1].numpy(), 0.0, atol=1e-6)
    # Unmasked, the dead lanes do take the slots (the mask is what saves it).
    _, unmasked = tllama._moe_capacity(tx, tlp, tc)
    assert int(unmasked) > 0


def test_auto_resolves_to_ragged():
    assert resolve_moe_dispatch(TCFG, 1).moe_dispatch == "ragged"
    assert resolve_moe_dispatch(TCFG, 2).moe_dispatch == "capacity"
    assert resolve_moe_dispatch(get_config("tiny"), 2).moe_dispatch == "auto"
    assert get_module(TCFG) is tllama


def test_moe_configs_refuse_int8_weights_as_jax():
    for name in ("tiny-moe", "tiny-mla"):
        with pytest.raises(ValueError):
            get_config(name).replace(weight_dtype="int8")
        with pytest.raises(ValueError):
            jax_config(name).replace(weight_dtype="int8")
    with pytest.raises(ValueError, match="moe_dispatch"):
        TCFG.replace(moe_dispatch="sparse")


# ---------------------------------------------------------------------------
# 2. tiny-moe's forwards
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_numpy(tree, TCFG, device="cpu", dtype=torch.float32)


def test_params_layout_and_init(weights):
    jp, tp = weights
    assert param_shapes(TCFG)["layers"]["w_gate"] == (2, 4, 64, 64)
    assert param_shapes(TCFG)["layers"]["router"] == (2, 64, 4)
    for k, w in tp["layers"].items():
        assert tuple(w.shape) == tuple(jp["layers"][k].shape), k
    init = init_params(TCFG, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    assert {k: tuple(v.shape) for k, v in init["layers"].items()} == param_shapes(TCFG)["layers"]
    assert abs(float(init["layers"]["w_gate"].std()) - 64**-0.5) < 0.01


class Pair:
    """A JAX and a port cache fed the same calls: the port on its default
    path (the ragged kernel's plain version here), JAX on its CPU default
    (the gather)."""

    def __init__(self, weights, dispatch="ragged"):
        self.jp, self.tp = weights
        self.jcfg, self.tcfg = JCFG.replace(moe_dispatch=dispatch), TCFG.replace(moe_dispatch=dispatch)
        jc = JaxCache.create(self.jcfg, NUM_BLOCKS, dtype=jnp.float32)
        tc = KvCacheArrays.create(self.tcfg, NUM_BLOCKS, dtype=torch.float32, device="cpu")
        self.jk, self.jv, self.tk, self.tv = jc.k, jc.v, tc.k, tc.v
        self.stats = dispatch == "capacity"
        self.aux = []

    def call(self, name, jargs, targs, jkw=None, tkw=None):
        """Both packages' ``name`` on the same inputs → (JAX's first
        output, the port's), the caches carried; with capacity dispatch the
        counters of both are kept."""
        kw = {"moe_stats": True} if self.stats else {}
        jres = jax.jit(lambda p, k, v: getattr(jllama, name)(p, self.jcfg, k, v, *jargs, **(jkw or {}), **kw))(
            self.jp, self.jk, self.jv)
        tres = getattr(tllama, name)(self.tp, self.tcfg, self.tk, self.tv, *targs, **(tkw or {}), **kw)
        if self.stats:
            self.aux.append(({k: int(v) for k, v in jres[-1].items()}, {k: int(v) for k, v in tres[-1].items()}))
            jres, tres = jres[:-1], tres[:-1]
        self.jk, self.jv = jres[-2], jres[-1]
        return jres, tres

    def prefill(self, toks, bucket, cache_len, table):
        padded = np.zeros(bucket, np.int32)
        padded[: len(toks)] = toks
        j, t = self.call("prefill", (jnp.asarray(padded), jnp.int32(len(toks)), jnp.int32(cache_len), jnp.asarray(table)),
                         (torch.from_numpy(padded), len(toks), cache_len, torch.from_numpy(table)))
        return np.asarray(j[0]), t[0].numpy()

    def decode(self, toks, pos, tables, active):
        arrs = (toks, pos, tables, active)
        j, t = self.call("decode", tuple(map(jnp.asarray, arrs)), tuple(map(torch.from_numpy, arrs)))
        return np.asarray(j[0]), t[0].numpy()


def _table(blocks, width=8):
    t = np.zeros(width, np.int32)
    t[: len(blocks)] = blocks
    return t


def _decode_inputs():
    # Row 1's third block holds what its chunks write past position 31.
    tables = np.stack([_table([1, 2]), _table([3, 4, 7]), _table([5]), _table([])])
    pos = np.array([20, 31, 9, 0], np.int32)
    return tables, pos, np.array([True, True, True, False])


def _fill(pair, rng):
    """Prefill three sequences into blocks 1-2, 3-4 and 5."""
    for blocks, n in (([1, 2], 20), ([3, 4], 31), ([5], 9)):
        jl, tl = pair.prefill(rng.integers(0, 256, n), 32, 0, _table(blocks))
        np.testing.assert_allclose(tl, jl, **LOGIT_TOL)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_prefill_and_decode_match_jax(weights, dispatch):
    pair = Pair(weights, dispatch)
    rng = np.random.default_rng(1)
    _fill(pair, rng)
    # A continuation over the first sequence's cached prefix.
    jl, tl = pair.prefill(rng.integers(0, 256, 7), 16, 20, _table([1, 2]))
    np.testing.assert_allclose(tl, jl, **LOGIT_TOL)
    tables, pos, active = _decode_inputs()
    pos[0] = 27
    toks = rng.integers(0, 256, 4).astype(np.int32)
    jl, tl = pair.decode(toks, pos, tables, active)
    np.testing.assert_allclose(tl[active], jl[active], **LOGIT_TOL)
    if dispatch == "capacity":
        assert pair.aux and all(j == t for j, t in pair.aux), pair.aux


@pytest.mark.parametrize("dispatch", ["ragged", "capacity"])
def test_decode_multi_matches_jax(weights, dispatch):
    pair = Pair(weights, dispatch)
    rng = np.random.default_rng(2)
    _fill(pair, rng)
    tables, pos, active = _decode_inputs()
    toks = rng.integers(0, 256, 4).astype(np.int32)
    zeros = np.zeros(4, np.float32)
    samp = (zeros, np.zeros(4, np.int32), np.ones(4, np.float32))
    if dispatch == "capacity":
        # With counters: tokens and the window's counters (no logits: the
        # two cannot be combined, in either package).
        j, t = pair.call("decode_multi", (*map(jnp.asarray, (toks, pos, tables, active)), *map(jnp.asarray, samp),
                                          jax.random.PRNGKey(0), 6),
                         (*map(torch.from_numpy, (toks, pos, tables, active)), *samp, None, 6))
        np.testing.assert_array_equal(t[0].numpy()[:, active], np.asarray(j[0])[:, active])
        assert pair.aux[-1][0] == pair.aux[-1][1]
        return
    jkw = tkw = {"return_logits": True}
    j, t = pair.call("decode_multi", (*map(jnp.asarray, (toks, pos, tables, active)), *map(jnp.asarray, samp),
                                      jax.random.PRNGKey(0), 6),
                     (*map(torch.from_numpy, (toks, pos, tables, active)), *samp, None, 6), jkw, tkw)
    np.testing.assert_array_equal(t[0].numpy()[:, active], np.asarray(j[0])[:, active])
    np.testing.assert_allclose(t[1].numpy()[:, active], np.asarray(j[1])[:, active], **LOGIT_TOL)


@pytest.mark.parametrize("dispatch", ["ragged", "capacity"])
def test_chunk_decode_and_mixed_step_match_jax(weights, dispatch):
    pair = Pair(weights, dispatch)
    rng = np.random.default_rng(4)
    _fill(pair, rng)
    tables, pos, active = _decode_inputs()
    # chunk_decode: rows of 3, 5, 1 and 0 valid tokens past their prefixes.
    S = 5
    chunk = rng.integers(0, 256, (4, S)).astype(np.int32)
    valid = np.array([3, 5, 1, 0], np.int32)
    arrs = (chunk, pos, valid, tables)
    j, t = pair.call("chunk_decode", tuple(map(jnp.asarray, arrs)), tuple(map(torch.from_numpy, arrs)),
                     {"all_logits": True}, {"all_logits": True})
    live = np.arange(S)[None, :] < valid[:, None]
    np.testing.assert_allclose(t[0].numpy()[live], np.asarray(j[0])[live], **LOGIT_TOL)
    # mixed_step: a new sequence's chunk in block 6 beside the decode rows.
    p_toks = np.zeros(16, np.int32)
    p_toks[:11] = rng.integers(0, 256, 11)
    d_pos = pos + valid
    d_toks = rng.integers(0, 256, 4).astype(np.int32)
    j, t = pair.call(
        "mixed_step",
        (jnp.asarray(p_toks), jnp.int32(11), jnp.int32(0), jnp.asarray(_table([6])),
         *map(jnp.asarray, (d_toks, d_pos, tables, active))),
        (torch.from_numpy(p_toks), 11, 0, torch.from_numpy(_table([6])), *map(torch.from_numpy, (d_toks, d_pos, tables, active))))
    rows = np.concatenate([[True], active])
    np.testing.assert_allclose(t[0].numpy()[rows], np.asarray(j[0])[rows], **LOGIT_TOL)
    if dispatch == "capacity":
        assert all(jx == tx for jx, tx in pair.aux), pair.aux


def test_decode_sample_moe_stats(weights):
    """The overlapped pipeline's step carries the counters too."""
    pair = Pair(weights, "capacity")
    _fill(pair, np.random.default_rng(5))
    tables, pos, active = _decode_inputs()
    tpa = np.stack([np.array([1, 2, 3, 0], np.int32), pos, active.astype(np.int32)])
    samp = (np.zeros(4, np.float32), np.zeros(4, np.int32), np.ones(4, np.float32))
    res = tllama.decode_sample(pair.tp, pair.tcfg, pair.tk, pair.tv, torch.from_numpy(tpa), torch.from_numpy(tables),
                               *map(torch.from_numpy, samp), None, moe_stats=True)
    assert len(res) == 5 and int(res[-1]["moe_assignments"]) == 3 * 2 * 2


# ---------------------------------------------------------------------------
# 3. The schedulers
# ---------------------------------------------------------------------------

SCHED = dict(num_blocks=128, max_running=8, prefill_buckets=[16, 32, 64], decode_buckets=[1, 2, 4, 8],
             max_prefill_chunk=32)


def _run(sched, mod, sampling_cls, reqs):
    for rid, prompt, n in reqs:
        sched.add_request(rid, prompt, sampling_cls(temperature=0.0),
                          mod.StopConditions(max_tokens=n, ignore_eos=True))
    out = {}
    for _ in range(2000):
        if not sched.has_work():
            break
        for seq, o in sched.step():
            if o.token_id >= 0:
                out.setdefault(seq.request_id, []).append(o.token_id)
    assert not sched.has_work()
    return out


@pytest.mark.parametrize("steps", [1, 8])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_scheduler_greedy_tokens_match_jax(weights, dispatch, steps):
    jp, tp = weights
    rng = np.random.default_rng(7)
    # Two short prompts (a wave), a long one (chunked; later mixed beside
    # the decoding rows) and one that arrives when the others decode.
    reqs = [("a", list(rng.integers(0, 256, 12)), 10), ("b", list(rng.integers(0, 256, 9)), 12),
            ("c", list(rng.integers(0, 256, 70)), 9)]
    late = [("d", list(rng.integers(0, 256, 20)), 8)]
    kw = dict(SCHED, num_scheduler_steps=steps)
    j = jsched.Scheduler(JCFG.replace(moe_dispatch=dispatch), jp, jsched.SchedulerConfig(**kw), dtype=jnp.float32)
    t = tsched.Scheduler(TCFG.replace(moe_dispatch=dispatch), tp, tsched.SchedulerConfig(**kw),
                         dtype=torch.float32, device="cpu")
    assert not t._use_fused_window and t._graphs is None
    outs = []
    for s, mod, samp in ((j, jsched, JaxSampling), (t, tsched, SamplingParams)):
        first = _run(s, mod, samp, reqs)
        outs.append({**first, **_run(s, mod, samp, late)})
    assert outs[1] == outs[0]
    assert t.wave_steps_total > 0 and t.mixed_steps_total == j.mixed_steps_total
    jm, tm = j.metrics(), t.metrics()
    assert (tm.moe_dropped_total, tm.moe_assignments_total) == (jm.moe_dropped_total, jm.moe_assignments_total)
    if dispatch == "capacity":
        assert tm.moe_assignments_total > 0
    else:
        assert tm.moe_assignments_total == 0


def test_scheduler_capacity_drops_match_jax(weights):
    """A tight capacity factor drops assignments: the counters equal JAX's."""
    jp, tp = weights
    rng = np.random.default_rng(8)
    reqs = [(f"r{i}", list(rng.integers(0, 256, 10 + 3 * i)), 6) for i in range(5)]
    kw = dict(SCHED, num_scheduler_steps=1)
    cfg = dict(moe_dispatch="capacity", moe_capacity_factor=0.5)
    j = jsched.Scheduler(JCFG.replace(**cfg), jp, jsched.SchedulerConfig(**kw), dtype=jnp.float32)
    t = tsched.Scheduler(TCFG.replace(**cfg), tp, tsched.SchedulerConfig(**kw), dtype=torch.float32, device="cpu")
    assert _run(t, tsched, SamplingParams, reqs) == _run(j, jsched, JaxSampling, reqs)
    assert t.moe_dropped_total == j.moe_dropped_total > 0
    assert t.moe_assignments_total == j.moe_assignments_total
