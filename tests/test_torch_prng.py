"""The port's threefry random functions (``engine/prng.py``) and the
sampling keys built on them, against ``jax.random`` and the JAX
``sampling`` module: every value bit-for-bit (uint32 keys and bits equal,
float32 values equal as bit patterns, tokens equal), over many seeds and
shapes, ``[1, V]`` and ``[B, V]`` among them."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine import sampling as jsampling
from dynamo_tpu_torch.engine import prng
from dynamo_tpu_torch.engine import sampling as tsampling

SEEDS = [0, 1, 42, 123456789, 2**31 - 1, -1, -2**31]
SHAPES = [(), (1,), (7,), (1, 300), (5, 257), (3, 4, 5)]


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split(seed):
    key = prng.PRNGKey(seed)
    jkey = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    for data in (0, 1, 17, 2**31 + 5, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(key, data), np.asarray(jax.random.fold_in(jkey, data)))
    for num in (2, 3, 8):
        np.testing.assert_array_equal(prng.split(key, num), np.asarray(jax.random.split(jkey, num)))
    # Batched keys fold each row as that key alone would.
    keys = prng.split(key, 4)
    got = prng.fold_in(keys, np.arange(4))
    want = np.stack([np.asarray(jax.random.fold_in(jnp.asarray(k), i)) for i, k in enumerate(keys)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bits_uniform_and_gumbel(seed, shape):
    key = prng.fold_in(prng.PRNGKey(seed), 9)
    jkey = jnp.asarray(key)
    _bits_equal(prng.random_bits(key, shape).numpy().astype(np.uint32),
                np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
    _bits_equal(prng.uniform(key, shape).numpy(), np.asarray(jax.random.uniform(jkey, shape)))
    _bits_equal(prng.uniform(key, shape, -2.5, 3.0).numpy(),
                np.asarray(jax.random.uniform(jkey, shape, minval=-2.5, maxval=3.0)))
    _bits_equal(prng.gumbel(key, shape).numpy(), np.asarray(jax.random.gumbel(jkey, shape)))


def test_xla_log_bit_equal():
    """The log under gumbel, over a million positive floats, the specials
    and subnormals (which XLA's CPU code reads as zero)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.random(1 << 20).astype(np.float32),
        (rng.random(1 << 12) * 1e6).astype(np.float32),
        np.array([0.0, -0.0, -1.0, np.nan, np.inf, -np.inf, 1e-40, -1e-40, 1.0, 2.0, 1e38], np.float32),
    ])
    got = prng.xla_log(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.log)(x))
    same = (got.view(np.uint32) == want.view(np.uint32)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), x[~same][:10]


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("B,V", [(1, 256), (6, 300), (4, 1000)])
def test_categorical(seed, B, V):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 4).astype(np.float32)
    logits[:, rng.integers(0, V, size=V // 3)] = -np.inf  # masked entries
    key = prng.fold_in(prng.PRNGKey(seed), B)
    got = prng.categorical(key, torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.random.categorical(jnp.asarray(key), logits, axis=-1)))
    # One key per row: vmap of the one-row draw.
    keys = prng.split(key, B)
    got = prng.categorical(keys, torch.from_numpy(logits)).numpy()
    want = jax.vmap(lambda k, row: jax.random.categorical(k, row))(jnp.asarray(keys), logits)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_make_row_keys_and_window_uniforms(seed):
    rng = np.random.default_rng(seed)
    B = 8
    seeds = rng.integers(-2**31, 2**31 - 1, size=B, dtype=np.int64).astype(np.int32)
    positions = rng.integers(0, 4000, size=B).astype(np.int32)
    has_seed = rng.random(B) < 0.5
    base = prng.fold_in(prng.PRNGKey(seed), 100 + seed)
    jargs = (jnp.asarray(base), jnp.asarray(seeds), jnp.asarray(positions), jnp.asarray(has_seed))
    np.testing.assert_array_equal(tsampling.make_row_keys(base, seeds, positions, has_seed),
                                  np.asarray(jsampling.make_row_keys(*jargs)))
    for steps in (1, 8):
        got = tsampling.make_window_uniforms(base, seeds, positions, has_seed, steps)
        assert got.dtype == torch.float32 and tuple(got.shape) == (steps, B)
        _bits_equal(got.numpy(), np.asarray(jsampling.make_window_uniforms(*jargs, steps)))
    # A seeded row's uniforms do not depend on its slot or its batchmates.
    u = tsampling.make_window_uniforms(base, seeds, positions, np.ones(B, bool), 4).numpy()
    u_moved = tsampling.make_window_uniforms(base ^ 1, seeds[::-1], positions[::-1], np.ones(B, bool), 4).numpy()
    np.testing.assert_array_equal(u, u_moved[:, ::-1])
