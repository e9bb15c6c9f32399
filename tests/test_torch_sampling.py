"""The port's sampling against the JAX package's: the same logits and
uniforms give the same filtered distribution (within 1e-6) and the same
tokens (bit-equal); the same logits and threefry key give the same drawn
tokens as JAX ``sample_batch`` (bit-equal), with one key for the batch or
per-row keys; greedy rows take the argmax."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine import sampling as jsampling
from dynamo_tpu_torch.engine import prng
from dynamo_tpu_torch.engine import sampling as tsampling


def _rows(seed, B=8, V=300):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    logits[0, 17] = logits[0, 18] = logits[0].max() + 1  # a tie at the top
    temps = np.array([0.0, 1.0, 0.7, 1.3, 0.5, 1.0, 2.0, 0.9], np.float32)[:B]
    top_ks = np.array([0, 0, 5, 0, 40, 1, 0, 300], np.int32)[:B]
    top_ps = np.array([1.0, 0.9, 1.0, 0.5, 0.95, 1.0, 0.1, 0.99], np.float32)[:B]
    u = rng.random(B).astype(np.float32)
    return logits, temps, top_ks, top_ps, u


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("seed", range(4))
def test_filtered_probs_match_jax(seed):
    logits, temps, top_ks, top_ps, _ = _rows(seed)
    want = np.asarray(jsampling.filtered_probs_rows(*_j(logits, temps, top_ks, top_ps)))
    got = tsampling.filtered_probs_rows(*_t(logits, temps, top_ks, top_ps)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed", range(4))
def test_sample_from_uniforms_bit_equal(seed):
    logits, temps, top_ks, top_ps, u = _rows(seed)
    for trial in range(5):
        uu = np.random.default_rng(100 * seed + trial).random(len(u)).astype(np.float32)
        want = np.asarray(jsampling.sample_from_uniforms(*_j(logits, temps, top_ks, top_ps, uu)))
        got = tsampling.sample_from_uniforms(*_t(logits, temps, top_ks, top_ps, uu)).numpy()
        np.testing.assert_array_equal(got, want)


def test_pack_param_rows_matches_jax():
    ps = [tsampling.SamplingParams(0.0), tsampling.SamplingParams(0.8, 5, 0.9)]
    js = [jsampling.SamplingParams(0.0), jsampling.SamplingParams(0.8, 5, 0.9)]
    for a, b in zip(tsampling.pack_param_rows(ps, 4), jsampling.pack_param_rows(js, 4)):
        np.testing.assert_array_equal(a, b)


def _jax_sample(logits, temps, top_ks, top_ps, key, row_keys=None):
    rk = None if row_keys is None else jnp.asarray(row_keys)
    return np.asarray(jsampling.sample_batch(*_j(logits, temps, top_ks, top_ps), jnp.asarray(key), rk))


def _sample(logits, temps, top_ks, top_ps, key, row_keys=None):
    """The port's per-step draw brought to the host."""
    return tsampling.sample_batch_device(logits, temps, top_ks, top_ps, key, row_keys).cpu().numpy()


def test_sample_batch_greedy_rows_take_argmax():
    """Greedy rows take the argmax in a batch that also draws, and an
    all-greedy batch draws nothing; both as JAX ``sample_batch`` does."""
    logits, temps, top_ks, top_ps, _ = _rows(7)
    key = prng.PRNGKey(0)
    out = _sample(torch.from_numpy(logits), temps, top_ks, top_ps, key)
    greedy = temps == 0
    np.testing.assert_array_equal(out[greedy], logits[greedy].argmax(-1))
    assert out[0] == 17  # ties break to the first index, as jnp.argmax does
    assert out.dtype == np.int32 and out.shape == (len(temps),)
    np.testing.assert_array_equal(out, _jax_sample(logits, temps, top_ks, top_ps, key))
    zeros = np.zeros_like(temps)
    out = _sample(torch.from_numpy(logits), zeros, top_ks, top_ps, None)  # no key needed
    np.testing.assert_array_equal(out, logits.argmax(-1))


@pytest.mark.parametrize("seed", range(6))
def test_sample_batch_draws_from_the_generator(seed):
    """The draw is JAX ``sample_batch``'s, token for token, from the same
    threefry key (one key for the [B, V] draw) and from per-row keys (each
    row its own draw), and replays under the same key; every drawn token
    lies inside its row's top-k/top-p support."""
    logits, temps, top_ks, top_ps, _ = _rows(8 + seed)
    key = prng.fold_in(prng.PRNGKey(seed), 3)
    t = torch.from_numpy(logits)
    draws = [_sample(t, temps, top_ks, top_ps, key) for _ in range(2)]
    np.testing.assert_array_equal(draws[0], draws[1])
    np.testing.assert_array_equal(draws[0], _jax_sample(logits, temps, top_ks, top_ps, key))
    row_keys = tsampling.make_row_keys(key, np.arange(len(temps), dtype=np.int32) * 7,
                                       np.arange(len(temps), dtype=np.int32), np.arange(len(temps)) % 2 == 0)
    got = _sample(t, temps, top_ks, top_ps, key, row_keys)
    np.testing.assert_array_equal(got, _jax_sample(logits, temps, top_ks, top_ps, key, row_keys))
    probs = tsampling.filtered_probs_rows(*_t(logits, temps, top_ks, top_ps)).numpy()
    assert all(probs[i, tok] > 0 for d in (draws[0], got) for i, tok in enumerate(d))


def _window_rows(seed, B=8, V=4096):
    """A batch whose every sampled row has 1 ≤ top_k ≤ 64, so JAX
    ``sample_batch`` takes its thresholds from the 64 largest logits
    (its windowed path) instead of the full sort."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 4).astype(np.float32)
    temps = np.array([0.0, 1.0, 0.7, 1.3, 0.5, 1.0, 2.0, 0.9], np.float32)[:B]
    top_ks = np.array([0, 64, 5, 20, 40, 1, 64, 33], np.int32)[:B]
    top_ps = np.array([1.0, 1.0, 0.9, 1.0, 0.95, 1.0, 1.0, 0.9], np.float32)[:B]
    return logits, temps, top_ks, top_ps


@pytest.mark.parametrize("seed", range(4))
def test_sample_batch_matches_jax_windowed_path(seed):
    logits, temps, top_ks, top_ps = _window_rows(20 + seed)
    # JAX's own test for its window: every sampled row's k fits in 64, and
    # a row with top_p < 1 has at least top_p of its mass among the 64.
    scaled = logits / np.where(temps > 0, temps, 1)[:, None]
    p = np.exp(scaled - scaled.max(-1, keepdims=True))
    top64 = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1][:, :64].sum(-1)
    sampled = temps > 0
    assert np.all(~sampled | ((top_ks >= 1) & (top_ks <= 64) & ((top_ps >= 1) | (top64 >= top_ps))))
    key = prng.fold_in(prng.PRNGKey(seed), 9)
    t = torch.from_numpy(logits)
    got = _sample(t, temps, top_ks, top_ps, key)
    np.testing.assert_array_equal(got, _jax_sample(logits, temps, top_ks, top_ps, key))
    row_keys = tsampling.make_row_keys(key, np.arange(8, dtype=np.int32) * 3, np.arange(8, dtype=np.int32),
                                       np.arange(8) % 3 == 0)
    got = _sample(t, temps, top_ks, top_ps, key, row_keys)
    np.testing.assert_array_equal(got, _jax_sample(logits, temps, top_ks, top_ps, key, row_keys))


# ---------------------------------------------------------------------------
# Guided decoding: logits masked by a packed allow-bit pool
# ---------------------------------------------------------------------------

# Allowed tokens per batch row: row 0 of the pool allows everything; the
# others allow 1, 2, 3, 5, 17, 40 or 63 tokens (fewer than the 64 of JAX's
# windowed thresholds) or 100 (more).
ALLOWED = [None, 1, 2, 3, 5, 17, 40, 63, 100]


def _mask_pool(rng, V):
    """(pool [P, ceil(V/32)] uint32, allowed sets): pool row r + 1 allows a
    random set of ``ALLOWED[r + 1]`` tokens, row 0 everything."""
    W = (V + 31) // 32
    pool = np.zeros((len(ALLOWED), W), np.uint32)
    bits = np.zeros((len(ALLOWED), W * 32), bool)
    bits[0, :V] = True
    sets = [np.arange(V)]
    for r, n in enumerate(ALLOWED[1:], start=1):
        ids = np.sort(rng.choice(V, size=n, replace=False))
        bits[r, ids] = True
        sets.append(ids)
    pool[:] = (bits.reshape(len(ALLOWED), W, 32).astype(np.uint32) << np.arange(32, dtype=np.uint32)).sum(
        axis=2, dtype=np.uint32)
    return pool, sets


def _guided_batch(seed, V=300, exact=False):
    """A batch of 9 rows, one per pool row, greedy and sampled with top-k
    (also past the row's allowed count) and top-p. Without ``exact`` every
    sampled row keeps JAX ``sample_batch`` on its windowed thresholds (k ≤
    64, and top-p only where the row allows fewer than 64 tokens); with it
    a row asks for top_k = 200, which sends the batch to the full sort."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((len(ALLOWED), V)) * 3).astype(np.float32)
    pool, sets = _mask_pool(rng, V)
    rows = np.arange(len(ALLOWED), dtype=np.int32)
    temps = np.array([0.0, 0.8, 1.0, 0.0, 1.2, 0.7, 1.0, 0.9, 1.0], np.float32)
    top_ks = np.array([0, 0, 5, 0, 4, 64, 0, 50, 10 if not exact else 200], np.int32)
    top_ps = np.array([1.0, 0.9, 1.0, 1.0, 0.8, 0.95, 0.9, 0.99, 1.0], np.float32)
    return logits, pool, sets, rows, temps, top_ks, top_ps


def test_apply_token_masks_matches_jax():
    logits, pool, sets, rows, *_ = _guided_batch(0)
    want = np.asarray(jsampling.apply_token_masks(*_j(logits, pool, rows)))
    got = tsampling.apply_token_masks(torch.from_numpy(logits), torch.from_numpy(pool.view(np.int32)),
                                      torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, want)
    for r, ids in enumerate(sets):
        assert np.isfinite(got[r]).sum() == len(ids) and np.isfinite(got[r, ids]).all()


@pytest.mark.parametrize("exact", [False, True], ids=["windowed", "exact"])
@pytest.mark.parametrize("seed", range(3))
def test_guided_sample_batch_matches_jax(seed, exact):
    """Masked rows through the threefry draw, with one key and with per-row
    keys: ``sample_batch_device`` over ``apply_token_masks`` (the scheduler's
    guided draw) gives JAX ``guided_sample_batch``'s tokens, every one
    allowed, greedy rows the argmax of their allowed logits."""
    logits, pool, sets, rows, temps, top_ks, top_ps = _guided_batch(30 + seed, exact=exact)
    key = prng.fold_in(prng.PRNGKey(seed), 11)
    k_rows = np.stack([top_ks, rows])
    t, tpool = torch.from_numpy(logits), torch.from_numpy(pool.view(np.int32))
    row_keys = tsampling.make_row_keys(key, np.arange(9, dtype=np.int32) * 5, np.arange(9, dtype=np.int32),
                                       np.arange(9) % 2 == 1)
    for rk in (None, row_keys):
        want = np.asarray(jsampling.guided_sample_batch(
            *_j(logits, pool, k_rows, temps, top_ps), jnp.asarray(key), None if rk is None else jnp.asarray(rk)))
        got = _sample(tsampling.apply_token_masks(t, tpool, torch.from_numpy(rows)), temps, top_ks, top_ps, key, rk)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32 and all(tok in sets[r] for r, tok in enumerate(got))
        for r in np.nonzero(temps == 0)[0]:
            assert got[r] == sets[r][np.argmax(logits[r, sets[r]])]


@pytest.mark.parametrize("seed", range(3))
def test_masked_filter_thresholds_and_draws_match_jax(seed):
    """On masked rows (fewer allowed tokens than top_k, nuclei that end in
    the allowed set): ``_exact_thresholds`` equal, ``filtered_probs_rows``
    within 1e-6 and zero off the allowed set, and ``sample_from_uniforms``
    (the fused window's pick) bit-equal."""
    logits, pool, sets, rows, temps, top_ks, top_ps = _guided_batch(40 + seed)
    masked = np.array(jsampling.apply_token_masks(*_j(logits, pool, rows)))
    scaled = masked / np.where(temps > 0, temps, 1.0).astype(np.float32)[:, None]
    lse = torch.logsumexp(torch.from_numpy(scaled), dim=-1, keepdim=True).numpy()
    want = np.asarray(jsampling._exact_thresholds(*_j(scaled, lse, top_ks, top_ps)))
    got = tsampling._exact_thresholds(*_t(scaled, lse, top_ks, top_ps)).numpy()
    np.testing.assert_array_equal(got, want)
    want_p = np.asarray(jsampling.filtered_probs_rows(*_j(masked, temps, top_ks, top_ps)))
    got_p = tsampling.filtered_probs_rows(*_t(masked, temps, top_ks, top_ps)).numpy()
    np.testing.assert_allclose(got_p, want_p, atol=1e-6, rtol=0)
    assert np.isfinite(masked[got_p > 0]).all()  # mass only on allowed tokens
    for trial in range(5):
        u = np.random.default_rng(100 * seed + trial).random(len(temps)).astype(np.float32)
        want_t = np.asarray(jsampling.sample_from_uniforms(*_j(masked, temps, top_ks, top_ps, u)))
        got_t = tsampling.sample_from_uniforms(*_t(masked, temps, top_ks, top_ps, u)).numpy()
        np.testing.assert_array_equal(got_t, want_t)
        assert all(tok in sets[r] for r, tok in enumerate(got_t))
