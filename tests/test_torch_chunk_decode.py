"""The port's ``llama.chunk_decode`` and ``decode_multi(return_logits=True)``
against the JAX package's.

The same converted ``tiny`` weights and the same seeded inputs go through
both packages: a batch of chunk rows, one over a 30-token cached prefix,
one over a 16-token prefix with a partial chunk, a fresh row and an
inactive one, in the three return modes (argmax tokens, every position's
logits, each row's last valid logits), on the megakernel path (the ragged
kernel's plain version) and the gather path (the JAX function's own
two-piece attention). In f32 the logits agree to ``tests/test_llama_model.py``'s
bound, the tokens exactly and the written cache (scratch block 0 aside) to
2e-5; int8 KV and int8 weights as ``test_torch_int8.py`` holds them (codes
within one step at a rounding tie, scales within 2e-5); bf16 within a
bound of a few bf16 ulps of the logits' scale. On the megakernel path only
the valid positions are compared: its padding queries are dead, where the
JAX function's padding positions attend anyway.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine import quant as jquant
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.kv_cache import KvCacheArrays as JaxCache
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu_torch.engine.attention import megakernel as tmk
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays, QuantKv
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.weights import params_from_numpy

from test_torch_int8 import check_codes

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
KV_ATOL = 2e-5
# bf16 logits: both packages round every product to bf16, in other orders.
BF16_ATOL = 0.05
NUM_BLOCKS = 32
TCFG = get_config("tiny")
JCFG = jax_config("tiny")
# int8 modes: (kv_cache_dtype, weight_dtype).
MODES = {"f32": ("auto", "auto"), "kv": ("int8", "auto"), "weights": ("auto", "int8"), "both": ("int8", "int8")}
IMPLS = ("megakernel", "gather")
RETURNS = ("argmax", "all", "last")


@pytest.fixture(scope="module")
def weights():
    """(jax tree, port tree) by weight dtype: f32, int8 (both packages'
    quantization of the same f32 weights) and bf16."""
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    jq = jquant.quantize_params({**jp, "layers": dict(jp["layers"])})
    jb = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    return {
        "auto": (jp, params_from_numpy(tree, TCFG, device="cpu", dtype=torch.float32)),
        "int8": (jq, params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), TCFG, device="cpu",
                                       dtype=torch.float32)),
        "bf16": (jb, params_from_numpy(tree, TCFG, device="cpu", dtype=torch.bfloat16)),
    }


@functools.lru_cache(maxsize=None)
def _jax_prefill(jcfg):
    return jax.jit(lambda p, k, v, t, n, tb: jllama.prefill(p, jcfg, k, v, t, n, jnp.int32(0), tb))


@functools.lru_cache(maxsize=None)
def _jax_chunk(jcfg, ret):
    kw = {"all": dict(all_logits=True), "last": dict(last_logits=True), "argmax": {}}[ret]
    return jax.jit(lambda p, k, v, *a: jllama.chunk_decode(p, jcfg, k, v, *a, **kw))


class Pair:
    """A JAX cache and a port cache fed the same calls (the JAX functions
    jitted once per configuration)."""

    def __init__(self, weights, impl, mode="f32", bf16=False):
        kv, wd = MODES[mode]
        self.jp, self.tp = weights["bf16" if bf16 else wd]
        # The JAX function is the same on every attention path (its own
        # gather): one reference configuration, compiled once.
        self.jcfg = JCFG.replace(attention_impl="gather", kv_cache_dtype=kv, weight_dtype=wd)
        self.tcfg = TCFG.replace(attention_impl=impl, kv_cache_dtype=kv, weight_dtype=wd)
        jc = JaxCache.create(self.jcfg, NUM_BLOCKS, dtype=jnp.bfloat16 if bf16 else jnp.float32)
        tc = KvCacheArrays.create(self.tcfg, NUM_BLOCKS, dtype=torch.bfloat16 if bf16 else torch.float32,
                                  device="cpu")
        self.jk, self.jv, self.tk, self.tv = jc.k, jc.v, tc.k, tc.v
        self.bf16 = bf16

    def prefill(self, toks, table):
        padded = np.zeros(32, np.int32)
        padded[: len(toks)] = toks
        _, self.jk, self.jv = _jax_prefill(self.jcfg)(self.jp, self.jk, self.jv, jnp.asarray(padded),
                                                     jnp.int32(len(toks)), jnp.asarray(table))
        tllama.prefill(self.tp, self.tcfg, self.tk, self.tv, torch.from_numpy(padded), len(toks), 0,
                       torch.from_numpy(table))

    def chunk(self, toks, pos0, valid, tables, ret):
        kw = {"all": dict(all_logits=True), "last": dict(last_logits=True), "argmax": {}}[ret]
        jo, self.jk, self.jv = _jax_chunk(self.jcfg, ret)(self.jp, self.jk, self.jv,
                                                          *map(jnp.asarray, (toks, pos0, valid, tables)))
        to, self.tk, self.tv = tllama.chunk_decode(self.tp, self.tcfg, self.tk, self.tv,
                                                   *map(torch.from_numpy, (toks, pos0, valid, tables)), **kw)
        return np.asarray(jo.astype(jnp.float32) if jo.dtype == jnp.bfloat16 else jo), to.float().numpy() \
            if to.is_floating_point() else to.numpy()

    def check_cache(self):
        """Block 0 is the scratch sink padded rows write to; excluded."""
        for j, t in ((self.jk, self.tk), (self.jv, self.tv)):
            if isinstance(t, QuantKv):
                check_codes(t, j)
            elif self.bf16:
                np.testing.assert_allclose(t.float().numpy()[:, 1:], np.asarray(j.astype(jnp.float32))[:, 1:],
                                           atol=BF16_ATOL, rtol=0.02)
            else:
                np.testing.assert_allclose(t.numpy()[:, 1:], np.asarray(j)[:, 1:], atol=KV_ATOL)


def _batch(pair, rng):
    """Rows over a 30-token prefix (a full 8-token chunk), a 16-token one
    (5 of 8 valid), a fresh row (3 valid) and an inactive row."""
    tables = np.zeros((4, 4), np.int32)
    for i, n in enumerate((30, 16)):
        tables[i, :3] = np.arange(1 + 3 * i, 4 + 3 * i, dtype=np.int32)
        pair.prefill(rng.integers(1, 255, size=n), tables[i])
    tables[2, :2] = (7, 8)
    toks = rng.integers(1, 255, size=(4, 8)).astype(np.int32)
    return toks, np.array([30, 16, 0, 0], np.int32), np.array([8, 5, 3, 0], np.int32), tables


def _compare(impl, ret, want, got, valid, close):
    """The gather path at every position, the megakernel at the valid ones."""
    live = np.arange(8)[None, :] < valid[:, None]
    if ret == "last":
        rows = valid > 0
        close(got[rows], want[rows])
    elif impl == "gather":
        close(got, want)
    else:
        close(got[live], want[live])


@pytest.mark.parametrize("ret", RETURNS)
@pytest.mark.parametrize("impl", IMPLS)
def test_chunk_decode_matches_jax_f32(weights, impl, ret):
    pair = Pair(weights, impl)
    toks, pos0, valid, tables = _batch(pair, np.random.default_rng(0))
    mk0 = tmk.REF_CALLS
    want, got = pair.chunk(toks, pos0, valid, tables, ret)
    if ret == "argmax":
        _compare(impl, ret, want, got, valid, np.testing.assert_array_equal)
    else:
        _compare(impl, ret, want, got, valid, lambda a, b: np.testing.assert_allclose(a, b, **LOGIT_TOL))
    pair.check_cache()
    # One ragged launch a layer for the whole batch on the megakernel path.
    assert tmk.REF_CALLS - mk0 == (TCFG.num_layers if impl == "megakernel" else 0)
    # A second chunk over what the first wrote: the rows' next 8 positions.
    toks2 = np.random.default_rng(1).integers(1, 255, size=(4, 8)).astype(np.int32)
    tables2 = tables.copy()
    tables2[2, 2] = 9
    want, got = pair.chunk(toks2, pos0 + valid, np.array([4, 8, 2, 0], np.int32), tables2, ret)
    if ret != "argmax":
        _compare(impl, ret, want, got, np.array([4, 8, 2, 0]),
                 lambda a, b: np.testing.assert_allclose(a, b, **LOGIT_TOL))
    pair.check_cache()


@pytest.mark.parametrize("mode", ["kv", "weights", "both"])
@pytest.mark.parametrize("impl", IMPLS)
def test_chunk_decode_matches_jax_int8(weights, impl, mode):
    pair = Pair(weights, impl, mode)
    toks, pos0, valid, tables = _batch(pair, np.random.default_rng(2))
    mk0 = tmk.REF_CALLS_INT8
    for ret in RETURNS:
        want, got = pair.chunk(toks, pos0, valid, tables, ret)
        if ret != "argmax":
            _compare(impl, ret, want, got, valid, lambda a, b: np.testing.assert_allclose(a, b, **LOGIT_TOL))
        pair.check_cache()
    int8_kv = MODES[mode][0] == "int8"
    assert tmk.REF_CALLS_INT8 - mk0 == (3 * TCFG.num_layers if impl == "megakernel" and int8_kv else 0)


@pytest.mark.parametrize("impl", IMPLS)
def test_chunk_decode_matches_jax_bf16(weights, impl):
    pair = Pair(weights, impl, bf16=True)
    toks, pos0, valid, tables = _batch(pair, np.random.default_rng(3))
    want, got = pair.chunk(toks, pos0, valid, tables, "all")
    _compare(impl, "all", want, got, valid, lambda a, b: np.testing.assert_allclose(a, b, atol=BF16_ATOL, rtol=0))
    want, got = pair.chunk(toks, pos0 + valid, valid, tables, "last")
    _compare(impl, "last", want, got, valid, lambda a, b: np.testing.assert_allclose(a, b, atol=BF16_ATOL, rtol=0))
    pair.check_cache()


def test_chunk_decode_refuses_moe_stats(weights):
    """Since the MoE family was ported ``moe_stats`` is served, not refused:
    a dense model's pass returns the JAX aux (no drops; the live rows ×
    max(K, 1) × layers as assignments), beside the same argmax."""
    pair = Pair(weights, "megakernel")
    toks = np.array([[5, 6, 7, 0], [9, 0, 0, 0]], np.int32)
    pos0, valid = np.array([0, 0], np.int32), np.array([3, 1], np.int32)
    tables = np.array([[1, 0, 0, 0], [2, 0, 0, 0]], np.int32)
    arrs = (toks, pos0, valid, tables)
    jt, _, _, jaux = jllama.chunk_decode(pair.jp, pair.jcfg, pair.jk, pair.jv, *map(jnp.asarray, arrs), moe_stats=True)
    tt, _, _, taux = tllama.chunk_decode(pair.tp, pair.tcfg, pair.tk, pair.tv, *map(torch.from_numpy, arrs),
                                         moe_stats=True)
    assert {k: int(v) for k, v in taux.items()} == {k: int(v) for k, v in jaux.items()} == {
        "moe_dropped": 0, "moe_assignments": 4 * TCFG.num_layers}
    live = np.arange(4)[None, :] < valid[:, None]
    np.testing.assert_array_equal(tt.numpy()[live], np.asarray(jt)[live])


@pytest.mark.parametrize("impl", IMPLS + ("paged",))
def test_decode_multi_returns_jax_logits(weights, impl):
    """A 3-step sampled draft window (the per-round spec path's) with its
    per-step logits: equal tokens, logits within the f32 bound."""
    pair = Pair(weights, impl)
    rng = np.random.default_rng(4)
    tables = np.zeros((4, 4), np.int32)
    for i, n in enumerate((30, 16, 7)):
        tables[i, :3] = np.arange(1 + 3 * i, 4 + 3 * i, dtype=np.int32)
        pair.prefill(rng.integers(1, 255, size=n), tables[i])
    toks = rng.integers(1, 255, size=4).astype(np.int32)
    pos = np.array([30, 16, 7, 0], np.int32)
    active = np.array([True, True, True, False])
    samp = (np.array([0.0, 0.9, 1.2, 0.0], np.float32), np.array([0, 3, 0, 0], np.int32),
            np.array([1, 1, 0.9, 1], np.float32))
    key = jax.random.PRNGKey(7)
    jt, jl, pair.jk, pair.jv = jax.jit(lambda p, k, v: jllama.decode_multi(
        p, pair.jcfg, k, v, *map(jnp.asarray, (toks, pos, tables, active)), *map(jnp.asarray, samp), key, 3,
        return_logits=True))(pair.jp, pair.jk, pair.jv)
    tt, tl, pair.tk, pair.tv = tllama.decode_multi(pair.tp, pair.tcfg, pair.tk, pair.tv,
                                                   *map(torch.from_numpy, (toks, pos, tables, active)), *samp,
                                                   np.asarray(key, np.uint32), 3, return_logits=True)
    assert tuple(tl.shape) == (3, 4, TCFG.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_array_equal(tt.numpy()[:, :3], np.asarray(jt)[:, :3])
    np.testing.assert_allclose(tl.numpy()[:, :3], np.asarray(jl)[:, :3], **LOGIT_TOL)
    pair.check_cache()
    with pytest.raises(NotImplementedError, match="cannot be combined"):  # as JAX's
        tllama.decode_multi(pair.tp, pair.tcfg, pair.tk, pair.tv, *map(torch.from_numpy, (toks, pos, tables, active)),
                            *samp, None, 2, moe_stats=True, return_logits=True)
