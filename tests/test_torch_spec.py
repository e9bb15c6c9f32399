"""Speculative decoding in the port against the JAX package: the module and
the fused spec window's plain version.

1. ``SpecDecodeStats``: the same ``record_round`` sequences give the same
   ``to_dict()`` (γ = 0, all rejected, and empty histories included).
2. ``spec_verify``: the same logits, proposals and threefry key give the
   same ``(accepted, next_token)``, for greedy rows, sampled rows and
   identical draft and target distributions.
3. ``SpecDecoder.generate``: the same greedy tokens and stats with a
   distinct draft and with a perfect one (the draft is the target).
4. ``fused_spec_window``'s plain version (through
   ``llama.decode_spec_fused`` on the CPU) against the JAX
   ``llama.decode_spec_fused`` (Pallas in interpret mode), R = 3, γ = 2,
   B = 2 plus a dead row: a perturbed draft (accepts and rejects both
   occur), sampled rows on fixed uniforms, sampled rows over a draft that
   is the target itself (every proposal accepted, so the bonus is drawn
   from the target's last distribution), and a draft narrower than the
   target. ``tokens_out`` and ``accepted`` of live rows are equal, both
   caches agree within 1e-5 (block 0, the dead row's sink, aside), and the
   target's confirmed K/V rows equal a clean prefill of the confirmed
   stream (rejections leave nothing stale).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine import spec_decode as jspec
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.kv_cache import KvCacheArrays as JaxCache
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu_torch.engine import prng, spec_decode as tspec
from dynamo_tpu_torch.engine.attention import megakernel as tmk
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.weights import params_from_numpy

KV_ATOL = 1e-5

# ---------------------------------------------------------------------------
# 1. SpecDecodeStats
# ---------------------------------------------------------------------------

ROUNDS = {
    "mixed": [(2, 4), (0, 4), (4, 4), (1, 4)],
    "gamma 0": [(0, 0), (0, 0)],
    "all rejected": [(0, 3)] * 5,
    "empty": [],
    "gamma grows": [(1, 2), (3, 5)],
}


@pytest.mark.parametrize("case", list(ROUNDS))
def test_spec_stats_match_jax(case):
    want, got = jspec.SpecDecodeStats(), tspec.SpecDecodeStats()
    for st in (want, got):
        for accepted, gamma in ROUNDS[case]:
            st.num_rounds += 1
            st.record_round(accepted, gamma)
    assert got.to_dict() == want.to_dict()
    assert (got.acceptance_rate, got.accepted_per_round) == (want.acceptance_rate, want.accepted_per_round)


# ---------------------------------------------------------------------------
# 2. spec_verify
# ---------------------------------------------------------------------------


def _verify_case(kind):
    """(draft logits, target logits, proposals, temps, top_ks, top_ps) as numpy."""
    rng = np.random.RandomState({"greedy": 0, "sampled": 4, "identical": 1}[kind])
    if kind == "greedy":
        B, G, V = 3, 3, 16
        d, t = rng.randn(B, G, V), rng.randn(B, G + 1, V)
        arg = t.argmax(-1)
        props = np.zeros((B, G), np.int64)
        props[0] = arg[0, :G]  # full agreement
        props[1] = arg[1, :G]
        props[1, 1] = (arg[1, 1] + 1) % V  # disagree at position 1
        props[2, 0] = (arg[2, 0] + 3) % V  # disagree at once
        rows = (np.zeros(B), np.zeros(B), np.ones(B))
    elif kind == "sampled":
        B, G, V = 4, 3, 64
        t = rng.randn(B, G + 1, V) * 2
        d = t[:, :G] + rng.randn(B, G, V)  # close but not equal: some accept, some reject
        props = np.stack([[rng.choice(V, p=np.exp(r) / np.exp(r).sum()) for r in row] for row in d / 0.9])
        rows = (np.array([0.9, 0.0, 1.2, 0.7]), np.array([0, 0, 10, 5]), np.array([1.0, 1.0, 0.9, 1.0]))
    else:
        B, G, V = 2, 4, 32
        t = rng.randn(B, G + 1, V)
        d = t[:, :G]
        props = np.random.RandomState(2).randint(0, V, (B, G))
        rows = (np.full(B, 0.8), np.zeros(B), np.ones(B))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(d), f32(t), props.astype(np.int32), f32(rows[0]), rows[1].astype(np.int32), f32(rows[2])


@pytest.mark.parametrize("kind", ["greedy", "sampled", "identical"])
@pytest.mark.parametrize("seed", [0, 3])
def test_spec_verify_matches_jax(kind, seed):
    case = _verify_case(kind)
    want_acc, want_tok = jspec.spec_verify(*map(jnp.asarray, case), jax.random.PRNGKey(seed))
    got_acc, got_tok = tspec.spec_verify(*map(torch.from_numpy, case), prng.PRNGKey(seed))
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    if kind == "greedy":
        assert got_acc.tolist() == [3, 1, 0]
    if kind == "identical":
        assert got_acc.tolist() == [4, 4]
    if kind == "sampled" and seed == 0:
        assert 0 < got_acc.sum() < 4 * 3  # both accepts and rejections


# ---------------------------------------------------------------------------
# 3. SpecDecoder
# ---------------------------------------------------------------------------


def _models(*seeds, cfg=None):
    """For each seed, (JAX params, port params) of ``tiny`` (or ``cfg``), f32 on the CPU."""
    jcfg = jax_config("tiny") if cfg is None else cfg
    tcfg = get_config("tiny").replace(**{f: getattr(jcfg, f) for f in _WIDTHS})
    out = []
    for s in seeds:
        jp = jllama.init_params(jcfg, jax.random.PRNGKey(s), dtype=jnp.float32)
        tree = jax.tree_util.tree_map(np.asarray, jp)
        out.append((jp, params_from_numpy(tree, tcfg, device="cpu", dtype=torch.float32)))
    return jcfg, tcfg, out


_WIDTHS = ("vocab_size", "hidden_size", "num_layers", "num_heads", "num_kv_heads", "head_dim", "intermediate_size",
           "tie_word_embeddings")


@pytest.mark.parametrize("draft_seed,gamma", [(7, 3), (0, 4)], ids=["distinct draft", "perfect draft"])
def test_spec_decoder_matches_jax(draft_seed, gamma):
    jcfg, tcfg, ((jt, tt), (jd, td)) = _models(0, draft_seed)
    prompt = list(range(40, 60))
    want_stats, got_stats = jspec.SpecDecodeStats(), tspec.SpecDecodeStats()
    want = jspec.SpecDecoder(jcfg, jt, jcfg, jd, gamma=gamma, dtype=jnp.float32).generate(
        prompt, 12, stats=want_stats)
    got = tspec.SpecDecoder(tcfg, tt, tcfg, td, gamma=gamma).generate(prompt, 12, stats=got_stats)
    assert got == want and len(got) == 12
    assert got_stats.to_dict() == want_stats.to_dict()
    if draft_seed == 0:
        assert got_stats.acceptance_rate == 1.0


def test_spec_decoder_refuses_mismatched_models():
    tiny = get_config("tiny")
    with pytest.raises(ValueError, match="block_size"):
        tspec.SpecDecoder(tiny, None, tiny.replace(block_size=32), None)
    with pytest.raises(ValueError, match="vocabulary"):
        tspec.SpecDecoder(tiny, None, tiny.replace(vocab_size=512), None)


# ---------------------------------------------------------------------------
# 4. The fused spec window's plain version against the JAX kernel
# ---------------------------------------------------------------------------

R, GAMMA, P = 3, 2, 12
# Row b's blocks; the last row is dead (its writes sink to block 0).
TABLES = np.array([[1, 2, 3], [4, 5, 6], [0, 0, 0]], np.int32)
LIVE = np.array([True, True, False])
NARROW = dict(hidden_size=32, num_layers=1, num_heads=2, num_kv_heads=1, head_dim=16, intermediate_size=64)


def _perturbed(jp, seed):
    """Target params + 0.002 × seeded noise: the draft mostly agrees."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.002 * rng.standard_normal(x.shape).astype(np.float32)), jp)


def _spec_case(kind):
    """Both packages' params, configs, caches filled by a prompt prefill on
    each model, and the window's inputs as numpy."""
    jcfg, tcfg, ((jt, tt),) = _models(0)
    if kind == "narrow draft":
        jdcfg, tdcfg, ((jd, td),) = _models(5, cfg=jax_config("tiny").replace(**NARROW))
    elif kind == "self sampled":
        jdcfg, tdcfg, jd, td = jcfg, tcfg, jt, tt
    else:
        jdcfg, tdcfg = jcfg, tcfg
        jd = _perturbed(jt, 42)
        td = params_from_numpy(jax.tree_util.tree_map(np.asarray, jd), tcfg, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 255, size=P) for _ in LIVE]
    caches = []
    for jp, cfg in ((jt, jcfg), (jd, jdcfg)):
        c = JaxCache.create(cfg, 8, dtype=jnp.float32)
        k, v = c.k, c.v
        for b in np.nonzero(LIVE)[0]:
            toks = np.zeros(32, np.int32)
            toks[:P] = prompts[b]
            _, k, v = jax.jit(lambda p, k, v: jllama.prefill(
                p, cfg, k, v, jnp.asarray(toks), jnp.int32(P), jnp.int32(0), jnp.asarray(TABLES[b])))(jp, k, v)
        caches += [k, v]
    B = len(LIVE)
    if kind.endswith("sampled"):
        rows = (np.array([0.9, 1.3, 0.0], np.float32), np.array([0, 20, 0], np.int32),
                np.array([0.95, 0.9, 1.0], np.float32))
        uniforms = np.random.default_rng(3).random((R, B, 2 * GAMMA + 1), dtype=np.float32)
    else:
        rows = (np.zeros(B, np.float32), np.zeros(B, np.int32), np.ones(B, np.float32))
        uniforms = np.full((R, B, 2 * GAMMA + 1), 0.25, np.float32)
    window = dict(tokens=rng.integers(1, 255, size=B).astype(np.int32),
                  xprev=np.array([p[-1] for p in prompts], np.int32), positions=np.full(B, P, np.int32),
                  tables=TABLES, active=LIVE, rows=rows, uniforms=uniforms)
    return (jt, jd, jcfg, jdcfg), (tt, td, tcfg, tdcfg), caches, window, prompts


def _cache_rows(cache, upto):
    """Each live row's cached K or V over positions [0, upto[b]) → [L, n, KVH, HD] each."""
    cache = np.asarray(cache)
    BS = cache.shape[2]
    return [np.stack([cache[:, TABLES[b, p // BS], p % BS] for p in range(upto[b])], axis=1)
            for b in np.nonzero(LIVE)[0]]


@pytest.mark.parametrize("kind", ["perturbed draft", "sampled", "self sampled", "narrow draft"])
def test_fused_spec_plain_version_matches_jax(kind):
    (jt, jd, jcfg, jdcfg), (tt, td, tcfg, tdcfg), caches, w, prompts = _spec_case(kind)
    inputs = [w["tokens"], w["xprev"], w["positions"], w["tables"], w["tables"], w["active"], *w["rows"],
              w["uniforms"]]
    want = jllama.decode_spec_fused(jt, jcfg, jd, jdcfg, *caches, *map(jnp.asarray, inputs), rounds=R, gamma=GAMMA)
    port_caches = [torch.from_numpy(np.array(c)) for c in caches]
    ref0, launches0 = tmk.SPEC_REF_CALLS, tmk.SPEC_KERNEL_LAUNCHES
    got = tllama.decode_spec_fused(tt, tcfg, td, tdcfg, *port_caches, *map(torch.from_numpy, inputs),
                                   rounds=R, gamma=GAMMA)
    assert tmk.SPEC_REF_CALLS == ref0 + 1 and tmk.SPEC_KERNEL_LAUNCHES == launches0
    toks, acc = got[0].numpy(), got[1].numpy()
    assert toks.shape == (R, len(LIVE), GAMMA + 1) and acc.shape == (R, len(LIVE))
    np.testing.assert_array_equal(toks[:, LIVE], np.asarray(want[0])[:, LIVE])
    np.testing.assert_array_equal(acc[:, LIVE], np.asarray(want[1])[:, LIVE])
    for g, c in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy()[:, 1:], np.asarray(c)[:, 1:], atol=KV_ATOL)
    live_acc = acc[:, LIVE]
    if kind == "perturbed draft":
        assert live_acc.max() > 0, "the perturbed draft should land some proposals"
        assert live_acc.min() < GAMMA, "and have some rejected"
    if kind == "self sampled":  # both live rows are sampled: the bonus draw ran
        assert (live_acc == GAMMA).any(), "the target itself as draft should have every proposal accepted"

    # The host replay: per round k accepted proposals, then the correction
    # or bonus. The confirmed stream's K/V (all but its last token, the next
    # input) equals a clean prefill of that stream.
    streams = []
    for i, b in enumerate(np.nonzero(LIVE)[0]):
        conf = list(prompts[b]) + [int(w["tokens"][b])]
        for r in range(R):
            k = int(acc[r, b])
            conf += [int(t) for t in toks[r, b, :k]] + [int(toks[r, b, GAMMA])]
        streams.append(conf)
    gold = JaxCache.create(jcfg, 8, dtype=jnp.float32)
    gk, gv = gold.k, gold.v
    for i, b in enumerate(np.nonzero(LIVE)[0]):
        toks_b = np.zeros(64, np.int32)
        toks_b[:len(streams[i]) - 1] = streams[i][:-1]
        _, gk, gv = jllama.prefill(jt, jcfg, gk, gv, jnp.asarray(toks_b), jnp.int32(len(streams[i]) - 1),
                                   jnp.int32(0), jnp.asarray(TABLES[b]))
    upto = {b: len(streams[i]) - 1 for i, b in enumerate(np.nonzero(LIVE)[0])}
    for got_c, gold_c in ((got[2], gk), (got[3], gv)):
        for a, e in zip(_cache_rows(got_c.numpy(), upto), _cache_rows(gold_c, upto)):
            np.testing.assert_allclose(a, e, atol=2e-4)


def test_fused_spec_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor a CUDA device is refused before any
    work (the kernel path itself runs on the card: ``test_torch_cuda.py``)."""
    _, tcfg, ((_, tt),) = _models(0)
    meta = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tllama.decode_spec_fused(tt, tcfg, tt, tcfg, *[None] * 4, meta, *[meta] * 8, torch.zeros((R, 3, 5)),
                                 rounds=R, gamma=GAMMA)


def test_fused_spec_fits():
    tiny, one = get_config("tiny"), get_config("llama-3.2-1b")
    f32 = dict(dtype=torch.float32, kv_dtype=torch.float32, device="cpu")
    assert tmk.fused_spec_fits(tiny, tiny.replace(**NARROW), batch=4, gamma=2, **f32)
    assert tmk.fused_spec_fits(get_config("llama-3.2-3b"), one, batch=8, gamma=4, dtype=torch.bfloat16,
                               kv_dtype=torch.bfloat16, device="cpu")
    assert not tmk.fused_spec_fits(tiny, tiny.replace(block_size=32), batch=4, gamma=2, **f32)
    assert not tmk.fused_spec_fits(tiny, tiny.replace(vocab_size=512), batch=4, gamma=2, **f32)
    assert not tmk.fused_spec_fits(tiny, tiny.replace(head_dim=48), batch=4, gamma=2, **f32)
    assert not tmk.fused_spec_fits(tiny, tiny, batch=4, gamma=0, **f32)
    assert not tmk.fused_spec_fits(tiny, tiny, batch=32, gamma=tmk.SPEC_MAX_GAMMA + 1, **f32)
    assert tmk.fused_spec_fits(tiny, tiny, batch=32, gamma=tmk.SPEC_MAX_GAMMA, **f32)
