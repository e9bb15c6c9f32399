"""The port's block allocator and block hashing against the JAX package's.

Both allocators replay the same seeded random traces of allocate, release,
register and match; their KV event streams (``KvEvent.to_wire`` minus the
timestamp), eviction order and refcounts must be identical. The port's
pure-Python xxh3_64 must equal the ``xxhash`` wheel for every input
length from 0 to 240 bytes, and its chained block hashes the JAX
package's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import xxhash

from dynamo_tpu.engine.kv_cache import BlockAllocator as JaxAllocator
from dynamo_tpu.engine.kv_cache import OutOfBlocksError as JaxOutOfBlocks
from dynamo_tpu.engine.kv_cache import ragged_scatter_targets as jax_targets
from dynamo_tpu.llm import tokens as jax_tokens
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.kv_cache import BlockAllocator, KvCacheArrays, OutOfBlocksError, ragged_scatter_targets
from dynamo_tpu_torch.llm import tokens


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_xxh3_matches_xxhash_for_every_length(seed):
    rng = np.random.default_rng(seed)
    seeds = [0, 1, tokens.ROOT_SEED, int(rng.integers(0, 2**63)) * 2 + 1, 2**64 - 1]
    for n in range(tokens.MAX_HASH_BYTES + 1):
        data = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
        for s in seeds:
            assert tokens.xxh3_64(data, s) == xxhash.xxh3_64_intdigest(data, seed=s), (n, s)


def test_xxh3_refuses_longer_inputs():
    with pytest.raises(ValueError):
        tokens.xxh3_64(bytes(tokens.MAX_HASH_BYTES + 1))


@pytest.mark.parametrize("block_size", [1, 4, 16, 60])
def test_block_hashes_match_jax(block_size):
    rng = np.random.default_rng(block_size)
    toks = rng.integers(0, 200_000, size=7 * block_size + 3).tolist()
    assert tokens.compute_block_hashes(toks, block_size) == jax_tokens.compute_block_hashes(toks, block_size)
    half = tokens.compute_block_hashes(toks[: 3 * block_size], block_size)
    assert tokens.extend_block_hashes(half, toks, block_size) == jax_tokens.compute_block_hashes(toks, block_size)


def _wire(events):
    return [{k: v for k, v in e.to_wire().items() if k != "ts"} for e in events]


def _replay(alloc_cls, oob, seed, num_blocks=24, steps=400):
    """Drive one allocator through a seeded trace; returns everything
    observable: per-step results, refcounts, free/cached counts, events,
    evictions."""
    rng = np.random.default_rng(seed)
    events, evicted = [], []
    a = alloc_cls(num_blocks, on_event=events.append)
    a.on_evict = lambda bid, h: evicted.append((bid, h))
    held = []  # lists of block ids owned by live "sequences"
    chains = [rng.integers(0, 2**63, size=6).tolist() for _ in range(5)]
    log = []
    for _ in range(steps):
        op = rng.integers(0, 5)
        if op == 0:  # allocate
            n = int(rng.integers(1, 6))
            try:
                held.append(a.allocate(n))
                log.append(("alloc", tuple(held[-1])))
            except oob:
                log.append(("oob", n))
        elif op == 1 and held:  # release
            blocks = held.pop(int(rng.integers(0, len(held))))
            a.release(blocks)
            log.append(("release", tuple(blocks)))
        elif op == 2 and held:  # register a held run under a chain prefix
            blocks = held[int(rng.integers(0, len(held)))]
            chain = chains[int(rng.integers(0, len(chains)))]
            a.register_hashes(blocks, chain[: len(blocks)])
            log.append(("register", tuple(blocks)))
        elif op == 3:  # match a chain prefix
            chain = chains[int(rng.integers(0, len(chains)))]
            matched = a.match_prefix(chain[: int(rng.integers(1, len(chain) + 1))])
            if matched:
                held.append(matched)
            log.append(("match", tuple(matched)))
        elif op == 4:
            a.touch([b for run in held for b in run][:3])
            if rng.random() < 0.05:
                log.append(("clear", a.clear_cached()))
        log.append((a.num_free, a.num_cached, a.num_active, round(a.usage(), 9)))
    refs = {b: a.ref_count(b) for b in range(num_blocks)}
    return log, refs, _wire(events), evicted, (a.hit_blocks_total, a.miss_blocks_total, a.evicted_blocks_total)


@pytest.mark.parametrize("seed", range(6))
def test_allocator_trace_matches_jax(seed):
    mine = _replay(BlockAllocator, OutOfBlocksError, seed)
    theirs = _replay(JaxAllocator, JaxOutOfBlocks, seed)
    names = ["results", "refcounts", "events", "evictions", "totals"]
    for name, m, t in zip(names, mine, theirs):
        assert m == t, name
    assert any(e["kind"] == "removed" for e in mine[2]), "trace should evict"


def test_ragged_scatter_targets_match_jax():
    table = np.array([7, 3, 9, 0], np.int32)
    pos = np.arange(10, 30, dtype=np.int32)
    live = pos < 25
    jb, jo = jax_targets(jnp.asarray(table), jnp.asarray(pos), jnp.asarray(live), 16)
    tb, to = ragged_scatter_targets(torch.from_numpy(table), torch.from_numpy(pos), torch.from_numpy(live), 16)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_cache_arrays_layout():
    cfg = get_config("tiny")
    c = KvCacheArrays.create(cfg, 8, dtype=torch.float32, device="cpu")
    assert tuple(c.k.shape) == (cfg.num_layers, 8, cfg.block_size, cfg.num_kv_heads, cfg.head_dim)
    assert c.v.shape == c.k.shape and c.k.dtype == torch.float32
