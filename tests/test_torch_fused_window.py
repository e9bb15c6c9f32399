"""Multi-step decode windows and the fused decode window, against the JAX
package.

The same seeded inputs go through both packages' ``tiny`` model in f32
(parameters moved across with ``params_from_numpy``, caches filled by the
JAX prefill and copied): B = 4 rows at ragged contexts, one of them
crossing a block boundary inside the window, and one dead row.

(a) the port's ``fused_decode_window`` (its plain version on the CPU)
    against the JAX ``decode_multi_fused`` (Pallas in interpret mode), over
    1, 2 and 4 KV heads and a tied and an untied head;
(b) the port's greedy ``decode_multi`` against the JAX ``decode_multi`` on
    each attention path;
(c) the port's fused plain version against the port's ``decode_multi``;
(d) the ``fused_window_fits`` gate;
(f) the guided epilogue: the port's ``decode_multi_fused(guided=True)``
    against the JAX one (``sampled=True, guided=True``), over pools both
    packages' ``GuidedDecoder`` compile from the same grammars, guided and
    unguided rows, greedy and sampled; every guided token allowed by the
    host FSM and the rows after the window the host's replay;
(e) the sampled epilogue: the port's ``decode_multi_fused(sampled=True)``
    against the JAX one, and the port's ``decode_multi`` with a threefry
    key and with ``uniforms=`` against the JAX ``decode_multi``, with rows
    on the filter edges of the JAX fused-window sampling test (greedy,
    k = 1, p = 1, k > vocab, joint top-k/top-p) and the same uniforms
    (``make_window_uniforms``, bit-equal across the packages).

Tokens of live rows must be equal, and the written K/V (excluding scratch
block 0, which dead rows write) within the JAX fused-window test's 2e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.kv_cache import KvCacheArrays as JaxCache
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.sampling import make_window_uniforms as jax_window_uniforms
from dynamo_tpu.llm.guided.processor import GuidedDecoder as JaxGuidedDecoder
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu_torch.engine import prng
from dynamo_tpu_torch.engine import sampling as tsampling
from dynamo_tpu_torch.engine.attention import megakernel as tmk
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.guided.processor import GuidedDecoder
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

KV_ATOL = 2e-4
STEPS = 4
NUM_BLOCKS = 24
# (prompt length, block table) per row; the last row is dead. Row 1 starts
# at 14 and crosses into its second block inside the window.
ROWS = [(21, [1, 2, 3, 4]), (14, [5, 6, 7, 8]), (5, [9, 10, 11, 12]), (0, [0, 0, 0, 0])]
GREEDY = (np.zeros(4, np.float32), np.zeros(4, np.int32), np.ones(4, np.float32))


def _setup(kvh=2, tied=False, impl="megakernel"):
    """(JAX params, port params, JAX cfg, port cfg, JAX k, v, window inputs as numpy)."""
    kw = dict(num_kv_heads=kvh, tie_word_embeddings=tied, attention_impl=impl)
    jcfg = jax_config("tiny").replace(**kw)
    tcfg = get_config("tiny").replace(**kw)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(kvh + 10 * tied), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(kvh)
    c = JaxCache.create(jcfg, NUM_BLOCKS, dtype=jnp.float32)
    k, v = c.k, c.v
    for n, table in ROWS:
        if n:
            toks = np.zeros(32, np.int32)
            toks[:n] = rng.integers(1, 255, size=n)
            _, k, v = jax.jit(lambda p, k, v: jllama.prefill(
                p, jcfg, k, v, jnp.asarray(toks), jnp.int32(n), jnp.int32(0), jnp.asarray(table, jnp.int32)
            ))(jp, k, v)
    window = dict(
        tokens=rng.integers(1, 255, size=len(ROWS)).astype(np.int32),
        positions=np.array([n for n, _ in ROWS], np.int32),
        tables=np.array([t for _, t in ROWS], np.int32),
        active=np.array([n > 0 for n, _ in ROWS]),
    )
    return jp, tp, jcfg, tcfg, k, v, window


def _port_cache(k, v):
    return torch.from_numpy(np.array(k)), torch.from_numpy(np.array(v))


def _port_args(window):
    return [torch.from_numpy(window[n]) for n in ("tokens", "positions", "tables", "active")]


def _check(got_toks, got_k, got_v, want_toks, want_k, want_v):
    live = np.array([n > 0 for n, _ in ROWS])
    np.testing.assert_array_equal(np.asarray(got_toks)[:, live], np.asarray(want_toks)[:, live])
    np.testing.assert_allclose(np.asarray(got_k)[:, 1:], np.asarray(want_k)[:, 1:], atol=KV_ATOL)
    np.testing.assert_allclose(np.asarray(got_v)[:, 1:], np.asarray(want_v)[:, 1:], atol=KV_ATOL)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("kvh", [1, 2, 4])
def test_fused_window_matches_jax_fused_window(kvh, tied):
    jp, tp, jcfg, tcfg, k, v, w = _setup(kvh, tied)
    want_toks, want_k, want_v = llama_fused_jax(jp, jcfg, k, v, w)
    tk, tv = _port_cache(k, v)
    ref0, mk0 = tmk.WINDOW_REF_CALLS, tmk.REF_CALLS
    toks, tk, tv = tllama.decode_multi_fused(tp, tcfg, tk, tv, *_port_args(w), num_steps=STEPS)
    assert tmk.WINDOW_REF_CALLS == ref0 + 1 and tmk.REF_CALLS == mk0  # one window, no ragged call
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (STEPS, len(ROWS))
    _check(toks, tk, tv, want_toks, want_k, want_v)


def llama_fused_jax(jp, jcfg, k, v, w):
    return jllama.decode_multi_fused(
        jp, jcfg, k, v, jnp.asarray(w["tokens"]), jnp.asarray(w["positions"]), jnp.asarray(w["tables"]),
        jnp.asarray(w["active"]), num_steps=STEPS,
    )


@pytest.mark.parametrize("impl", ["megakernel", "paged", "gather"])
def test_decode_multi_matches_jax(impl):
    jp, tp, jcfg, tcfg, k, v, w = _setup(impl=impl)
    want_toks, want_k, want_v = jax.jit(lambda p, k, v: jllama.decode_multi(
        p, jcfg, k, v, jnp.asarray(w["tokens"]), jnp.asarray(w["positions"]), jnp.asarray(w["tables"]),
        jnp.asarray(w["active"]), *map(jnp.asarray, GREEDY), jax.random.PRNGKey(0), STEPS,
    ))(jp, k, v)
    tk, tv = _port_cache(k, v)
    toks, tk, tv = tllama.decode_multi(tp, tcfg, tk, tv, *_port_args(w), *GREEDY, None, STEPS)
    _check(toks, tk, tv, want_toks, want_k, want_v)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_fused_plain_version_matches_decode_multi(tied):
    _, tp, _, tcfg, k, v, w = _setup(tied=tied)
    fk, fv = _port_cache(k, v)
    dk, dv = _port_cache(k, v)
    toks_f, fk, fv = tllama.decode_multi_fused(tp, tcfg, fk, fv, *_port_args(w), num_steps=STEPS)
    toks_d, dk, dv = tllama.decode_multi(tp, tcfg, dk, dv, *_port_args(w), *GREEDY, None, STEPS)
    _check(toks_f, fk, fv, toks_d.numpy(), dk.numpy(), dv.numpy())


def test_unported_options_raise():
    _, tp, _, tcfg, k, v, w = _setup()
    tk, tv = _port_cache(k, v)
    with pytest.raises(ValueError, match="guided"):  # the guided epilogue needs its pools
        tllama.decode_multi_fused(tp, tcfg, tk, tv, *_port_args(w), num_steps=2, guided=True)
    with pytest.raises(NotImplementedError, match="moe_stats"):
        tllama.decode_multi(tp, tcfg, tk, tv, *_port_args(w), *GREEDY, None, 2, moe_stats=True)
    with pytest.raises(ValueError, match="temps"):
        tmk.fused_decode_window(*_window_weights(tp), tk, tv, *_port_args(w), uniforms=torch.zeros(2, len(ROWS)),
                                **_window_kw(tcfg, 2))


def _window_weights(tp):
    lp = tp["layers"]
    return [tp["embed"], tp.get("lm_head"), tp["final_norm"]] + [
        lp[n] for n in ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]


def _window_kw(tcfg, steps):
    return dict(num_steps=steps, num_heads=tcfg.num_heads, num_kv_heads=tcfg.num_kv_heads,
                head_dim=tcfg.head_dim, block_size=tcfg.block_size, rms_eps=tcfg.rms_norm_eps,
                theta=tcfg.rope_theta)


# (temperature, top_k, top_p) filter edges, as in the JAX fused-window
# sampling test: greedy, k = 1, p = 1 (top-p off), k > vocab, joint k/p.
EDGES = [(0.0, 0, 1.0), (0.9, 1, 1.0), (0.8, 0, 1.0), (0.7, 999, 0.95), (1.3, 20, 0.9)]


def _sampled_rows(shift, seed=11):
    """(temps, top_ks, top_ps) over the rows from edge ``shift`` on, and
    the window's uniforms from ``make_window_uniforms`` (row 0 seeded)."""
    rows = [EDGES[(shift + i) % len(EDGES)] for i in range(len(ROWS))]
    params = tuple(np.array([r[j] for r in rows], dt) for j, dt in enumerate((np.float32, np.int32, np.float32)))
    B = len(ROWS)
    seed_rows = (np.array([77] + [0] * (B - 1), np.int32), np.full(B, 5, np.int32), np.arange(B) == 0)
    base = prng.fold_in(prng.PRNGKey(seed), shift)
    uniforms = tsampling.make_window_uniforms(base, *seed_rows, STEPS)
    np.testing.assert_array_equal(
        uniforms.numpy(), np.asarray(jax_window_uniforms(jnp.asarray(base), *map(jnp.asarray, seed_rows), STEPS)))
    return params, uniforms


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_sampled_fused_window_matches_jax(tied, shift):
    """Tokens of live rows equal, written K/V within 2e-4, one window and
    no ragged call on the port's side."""
    jp, tp, jcfg, tcfg, k, v, w = _setup(tied=tied)
    (temps, top_ks, top_ps), uniforms = _sampled_rows(shift)
    want = jllama.decode_multi_fused(
        jp, jcfg, k, v, *(jnp.asarray(w[n]) for n in ("tokens", "positions", "tables", "active")),
        num_steps=STEPS, temps=jnp.asarray(temps), top_ks=jnp.asarray(top_ks), top_ps=jnp.asarray(top_ps),
        uniforms=jnp.asarray(uniforms.numpy()), sampled=True,
    )
    tk, tv = _port_cache(k, v)
    ref0, mk0 = tmk.WINDOW_REF_CALLS, tmk.REF_CALLS
    got = tllama.decode_multi_fused(tp, tcfg, tk, tv, *_port_args(w), num_steps=STEPS, temps=temps,
                                    top_ks=top_ks, top_ps=top_ps, uniforms=uniforms, sampled=True)
    assert tmk.WINDOW_REF_CALLS == ref0 + 1 and tmk.REF_CALLS == mk0
    _check(*got, *want)


@pytest.mark.parametrize("shift", [0, 3])
def test_sampled_decode_multi_matches_jax(shift):
    """``decode_multi`` with a threefry key (each step splits it and draws
    ``categorical``) and with ``uniforms=`` (each step picks through
    ``sample_from_uniforms``): tokens equal to the JAX ``decode_multi``'s,
    K/V within 2e-4; with the uniforms, equal to the port's fused plain
    version too."""
    jp, tp, jcfg, tcfg, k, v, w = _setup()
    (temps, top_ks, top_ps), uniforms = _sampled_rows(shift)
    key = prng.fold_in(prng.PRNGKey(5), shift)
    jw = [jnp.asarray(w[n]) for n in ("tokens", "positions", "tables", "active")]
    jrows = [jnp.asarray(x) for x in (temps, top_ks, top_ps)]
    for unif in (None, uniforms):
        want = jax.jit(lambda p, k, v: jllama.decode_multi(
            p, jcfg, k, v, *jw, *jrows, jnp.asarray(key), STEPS,
            uniforms=None if unif is None else jnp.asarray(unif.numpy()),
        ))(jp, k, v)
        tk, tv = _port_cache(k, v)
        got = tllama.decode_multi(tp, tcfg, tk, tv, *_port_args(w), temps, top_ks, top_ps, key, STEPS,
                                  uniforms=unif)
        _check(*got, *want)
    fk, fv = _port_cache(k, v)
    fused = tllama.decode_multi_fused(tp, tcfg, fk, fv, *_port_args(w), num_steps=STEPS, temps=temps,
                                      top_ks=top_ks, top_ps=top_ps, uniforms=uniforms, sampled=True)
    _check(*fused, got[0].numpy(), got[1].numpy(), got[2].numpy())


def test_fused_window_fits():
    tiny = get_config("tiny")
    f32 = dict(dtype=torch.float32, kv_dtype=torch.float32, device="cpu")
    assert tmk.fused_window_fits(tiny, batch=32, **f32)
    assert tmk.fused_window_fits(get_config("llama-3.2-1b"), batch=8, dtype=torch.bfloat16,
                                 kv_dtype=torch.bfloat16, device="cpu")
    # What the port's config cannot hold yet, the JAX package's can: MoE and int8.
    jtiny = jax_config("tiny")
    assert not tmk.fused_window_fits(jtiny.replace(num_experts=4, num_experts_per_tok=2), batch=4, **f32)
    assert not tmk.fused_window_fits(jtiny.replace(kv_cache_dtype="int8"), batch=4, **f32)
    assert not tmk.fused_window_fits(jtiny.replace(weight_dtype="int8"), batch=4, **f32)
    assert not tmk.fused_window_fits(tiny, batch=4, dtype=torch.float32, kv_dtype=torch.int8, device="cpu")
    assert not tmk.fused_window_fits(tiny, batch=4, dtype=torch.float16, kv_dtype=torch.float16, device="cpu")
    assert not tmk.fused_window_fits(tiny, batch=33, **f32)
    assert not tmk.fused_window_fits(tiny.replace(head_dim=48), batch=4, **f32)
    assert not tmk.fused_window_fits(tiny.replace(vocab_size=250), batch=4, **f32)


# Guided rows' grammars: a small JSON schema, a choice and a regex; None is
# an unguided row (pool row 0).
GRAMMARS = [
    {"kind": "regex", "pattern": r'\{"ok":(?:true|false),"n":[0-9]{1,3}\}'},
    {"kind": "choice", "choices": ["red", "green", "blue"]},
    {"kind": "regex", "pattern": r"[a-c]{2}-\d+"},
]


def _guided_rows(order):
    """Both packages' decoders over ByteTokenizer (V = 256) and each row's
    cursor (None: unguided) for the grammars in ``order``."""
    tdec = GuidedDecoder(ByteTokenizer(), eos_ids=[0], vocab_size=256, pool_rows=16)
    jdec = JaxGuidedDecoder(JaxByteTokenizer(), eos_ids=[0], vocab_size=256, pool_rows=16)
    states = [None if g is None else (tdec.open(GRAMMARS[g]), jdec.open(GRAMMARS[g])) for g in order]
    rows = np.array([0 if st is None else st[0].row_id for st in states], np.int32)
    assert list(rows) == [0 if st is None else st[1].row_id for st in states]
    return tdec, jdec, states, rows


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("order,shift", [((0, 1, None, None), 0), ((None, 2, 0, None), 3), ((1, 0, 2, 1), 1)],
                         ids=["guided-first", "unguided-first", "all-guided"])
def test_guided_fused_window_matches_jax(tied, order, shift):
    """Guided and unguided rows, greedy and sampled (``EDGES`` from
    ``shift``): tokens of live rows equal to the JAX kernel's in interpret
    mode and written K/V within 2e-4; each guided row's tokens allowed by
    its FSM step by step and its row after the window the host's replay
    through the next-row pool."""
    jp, tp, jcfg, tcfg, k, v, w = _setup(tied=tied)
    (temps, top_ks, top_ps), uniforms = _sampled_rows(shift)
    tdec, jdec, states, rows = _guided_rows(order)
    want = jllama.decode_multi_fused(
        jp, jcfg, k, v, *(jnp.asarray(w[n]) for n in ("tokens", "positions", "tables", "active")),
        num_steps=STEPS, temps=jnp.asarray(temps), top_ks=jnp.asarray(top_ks), top_ps=jnp.asarray(top_ps),
        uniforms=jnp.asarray(uniforms.numpy()), guided_rows=jnp.asarray(rows), mask_pool=jdec.pool.device(),
        next_pool=jdec.pool.next_device(), sampled=True, guided=True,
    )
    tk, tv = _port_cache(k, v)
    ref0, g0 = tmk.WINDOW_REF_CALLS, tmk.WINDOW_GUIDED_REF_CALLS
    got = tllama.decode_multi_fused(tp, tcfg, tk, tv, *_port_args(w), num_steps=STEPS, temps=temps,
                                    top_ks=top_ks, top_ps=top_ps, uniforms=uniforms, guided_rows=rows,
                                    mask_pool=tdec.pool.device(), next_pool=tdec.pool.next_device(),
                                    sampled=True, guided=True)
    assert tmk.WINDOW_REF_CALLS == ref0 + 1 and tmk.WINDOW_GUIDED_REF_CALLS == g0 + 1
    _check(*got, *want)
    # The host FSM allows every guided token; the device's rows after the
    # window are the host's replay.
    rows_out = torch.empty(len(ROWS), dtype=torch.int32)
    tk, tv = _port_cache(k, v)
    toks = tmk.fused_decode_window(*_window_weights(tp), tk, tv, *_port_args(w), torch.from_numpy(temps),
                                   torch.from_numpy(top_ks), torch.from_numpy(top_ps), uniforms,
                                   torch.from_numpy(rows), tdec.pool.device(), tdec.pool.next_device(),
                                   rows_out=rows_out, **_window_kw(tcfg, STEPS))
    np.testing.assert_array_equal(toks.numpy(), got[0].numpy())
    nxt = tdec.pool.next_device().numpy()
    for b, st in enumerate(states):
        if st is None or not w["active"][b]:
            continue
        cursor, row = st[0], int(rows[b])
        for tok in toks[:, b].tolist():
            assert cursor.fsm.allows(cursor.state, tok), (b, tok)
            cursor.advance(tok)
            row = int(nxt[row, tok])
        assert int(rows_out[b]) == row


# (g) The bf16 products' work plan (``megakernel.product_plan``; the kernel
# walks the items ``plan_items`` lists): at published widths and at
# ``tiny``, for a decode window's rows and the spec verify's B·(γ+1), on an
# H100's 264 lanes (132 blocks of two). Expected scratch: (partials'
# floats, counters) at 8 and 40 rows.
PLAN_SCRATCH = {
    "llama-3.2-1b": {8: (131072, 48), 40: (655360, 48)},
    "llama-3.2-3b": {8: (270336, 80), 40: (614400, 80)},
    "llama-3-8b": {8: (917504, 448), 40: (4587520, 448)},
    "tiny": {8: (0, 0), 40: (0, 0)},
}


def _plan_phases(name):
    c = get_config(name)
    return tmk.window_phases(c.hidden_size, c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim,
                            c.intermediate_size, c.vocab_size)


@pytest.mark.parametrize("rows", [1, 8, 32, 40, 80, 288])
@pytest.mark.parametrize("name", list(PLAN_SCRATCH))
def test_product_plan_covers_each_column_and_box_once(name, rows):
    """Every phase's items cover each (column, 128-row box of K) exactly
    once: per column group its tiles start at 0, 64, ... up to the width,
    and each tile's box runs are disjoint and together [0, ceil(K / 128));
    a split plan's runs are all non-empty and at most ``kbs`` boxes."""
    phases = _plan_phases(name)
    plan, part, cnt = tmk.window_plan(phases, rows, 264)
    assert len(plan) == 5
    for (K, widths), (splits, kbs) in zip(phases, plan):
        boxes = -(-K // tmk.TC_BOX_ROWS)
        assert splits >= 1 and kbs >= 1 and (splits - 1) * kbs < boxes <= splits * kbs
        runs = {}
        for g, c0, lo, hi in tmk.plan_items(K, widths, splits, kbs):
            assert 0 <= lo < hi <= boxes and hi - lo <= kbs
            runs.setdefault((g, c0), []).append((lo, hi))
        for g, w in enumerate(widths):
            starts = sorted(c0 for gg, c0 in runs if gg == g)
            assert starts == list(range(0, w, tmk.TC_TILE))
            for c0 in starts:
                edges = sorted(runs[(g, c0)])
                assert edges[0][0] == 0 and edges[-1][1] == boxes
                assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
        assert len(tmk.plan_items(K, widths, splits, kbs)) == sum(-(-w // tmk.TC_TILE) for w in widths) * splits
    if rows in PLAN_SCRATCH[name]:
        assert (part, cnt) == PLAN_SCRATCH[name][rows]
    # The partials stay a few MB (L2-sized), whatever the rows.
    assert part * 4 <= 40 * 2**20


def test_product_plan_splits_the_narrow_phases():
    """At llama-3.2-1b's widths and 8 rows the few-tile phases (QKV's 48
    tiles, wo's and down's 32) split K so their items cover the 264 lanes,
    and gate/up (256 tiles) and the head (2004) do not; a phase whose boxes
    the runs do not divide leaves a shorter last run (down at D = 768, F =
    3200: 25 boxes in runs of 2)."""
    plan, _, _ = tmk.window_plan(_plan_phases("llama-3.2-1b"), 8, 264)
    assert plan == [(4, 4), (8, 2), (1, 16), (8, 8), (1, 16)]
    plan, _, _ = tmk.window_plan(tmk.window_phases(768, 64, 32, 3200, 256), 8, 264)
    assert plan[3] == (13, 2)
