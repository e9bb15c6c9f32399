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


def test_sample_batch_greedy_rows_take_argmax():
    """Greedy rows take the argmax in a batch that also draws, and an
    all-greedy batch draws nothing; both as JAX ``sample_batch`` does."""
    logits, temps, top_ks, top_ps, _ = _rows(7)
    key = prng.PRNGKey(0)
    out = tsampling.sample_batch(torch.from_numpy(logits), temps, top_ks, top_ps, key)
    greedy = temps == 0
    np.testing.assert_array_equal(out[greedy], logits[greedy].argmax(-1))
    assert out[0] == 17  # ties break to the first index, as jnp.argmax does
    assert out.dtype == np.int32 and out.shape == (len(temps),)
    np.testing.assert_array_equal(out, _jax_sample(logits, temps, top_ks, top_ps, key))
    zeros = np.zeros_like(temps)
    out = tsampling.sample_batch(torch.from_numpy(logits), zeros, top_ks, top_ps, None)  # no key needed
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
    draws = [tsampling.sample_batch(t, temps, top_ks, top_ps, key) for _ in range(2)]
    np.testing.assert_array_equal(draws[0], draws[1])
    np.testing.assert_array_equal(draws[0], _jax_sample(logits, temps, top_ks, top_ps, key))
    row_keys = tsampling.make_row_keys(key, np.arange(len(temps), dtype=np.int32) * 7,
                                       np.arange(len(temps), dtype=np.int32), np.arange(len(temps)) % 2 == 0)
    got = tsampling.sample_batch(t, temps, top_ks, top_ps, key, row_keys)
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
    got = tsampling.sample_batch(t, temps, top_ks, top_ps, key)
    np.testing.assert_array_equal(got, _jax_sample(logits, temps, top_ks, top_ps, key))
    row_keys = tsampling.make_row_keys(key, np.arange(8, dtype=np.int32) * 3, np.arange(8, dtype=np.int32),
                                       np.arange(8) % 3 == 0)
    got = tsampling.sample_batch(t, temps, top_ks, top_ps, key, row_keys)
    np.testing.assert_array_equal(got, _jax_sample(logits, temps, top_ks, top_ps, key, row_keys))
