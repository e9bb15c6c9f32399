"""The port's sampling against the JAX package's: the same logits and
uniforms give the same filtered distribution (within 1e-6) and the same
tokens (bit-equal), and greedy rows take the argmax."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine import sampling as jsampling
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


def test_sample_batch_greedy_rows_take_argmax():
    logits, temps, top_ks, top_ps, _ = _rows(7)
    gen = torch.Generator().manual_seed(0)
    out = tsampling.sample_batch(torch.from_numpy(logits), temps, top_ks, top_ps, gen)
    greedy = temps == 0
    np.testing.assert_array_equal(out[greedy], logits[greedy].argmax(-1))
    assert out[0] == 17  # ties break to the first index, as jnp.argmax does
    assert out.dtype == np.int32 and out.shape == (len(temps),)


def test_sample_batch_draws_from_the_generator():
    """Sampled rows replay under the same generator seed, and their tokens
    lie inside each row's top-k/top-p support."""
    logits, temps, top_ks, top_ps, _ = _rows(8)
    draws = [
        tsampling.sample_batch(torch.from_numpy(logits), temps, top_ks, top_ps, torch.Generator().manual_seed(3))
        for _ in range(2)
    ]
    np.testing.assert_array_equal(draws[0], draws[1])
    probs = tsampling.filtered_probs_rows(*_t(logits, temps, top_ks, top_ps)).numpy()
    assert all(probs[i, t] > 0 for i, t in enumerate(draws[0]))
