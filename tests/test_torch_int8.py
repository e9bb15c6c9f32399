"""int8 KV cache and int8 weights in the port, against the JAX package.

1. Quantization: ``quantize_kv_rows``, ``dequantize_kv``,
   ``quantize_weight``, ``wt`` and ``quantize_params`` give the JAX
   package's codes and scales on the same f32 and bf16 inputs, and ``wt``
   multiplies in f32 before it casts (``test_int8_weights.py``'s bound).
2. Carrying across: a JAX ``QuantW`` tree becomes the port's params and a
   JAX ``QuantKv`` cache the port's, unchanged.
3. The int8 branch of the ragged plain version against the JAX kernel in
   interpret mode, over the same int8 pages (dead queries, zero-amax
   tokens), in f32 and bf16.
4. The llama forward on ``tiny`` (f32) with int8 KV, int8 weights and both:
   prefill, decode, a mixed step and 8-step ``decode_multi`` windows,
   greedy and uniforms-sampled, on the megakernel path and on the
   per-piece path (``paged`` + ``flash``, which degrades to the gather);
   logits within ``test_torch_llama.py``'s bound, the same tokens and the
   same int8 codes and scales in the cache. A window that wrote its rows
   into the int8 cache step by step would give other logits.
5. Degrades and refusals; the scheduler against the JAX scheduler at one
   step and at 8-step windows (chunked prefill, mixed steps, a prefix-cache
   hit that copies its last block); the engine over HTTP and ``run``'s
   flags.
"""

import asyncio
import json
import logging

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine import quant as jquant
from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.attention import megakernel as jmk
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.engine import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.kv_cache import KvCacheArrays as JaxCache
from dynamo_tpu.engine.kv_cache import QuantKv as JQuantKv
from dynamo_tpu.engine.kv_cache import dequantize_kv as jdequantize_kv
from dynamo_tpu.engine.kv_cache import quantize_kv_rows as jquantize_kv_rows
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.sampling import SamplingParams as JaxSampling
from dynamo_tpu.llm.entrypoint import build_local_pipeline as jax_pipeline
from dynamo_tpu.llm.tokenizer import ByteTokenizer as JaxByteTokenizer
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import quant as tquant
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.attention import megakernel as tmk
from dynamo_tpu_torch.engine.attention import prefill as tprefill
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays, QuantKv, dequantize_kv, quantize_kv_rows
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.entrypoint import build_local_pipeline
from dynamo_tpu_torch.llm.discovery import ModelManager
from dynamo_tpu_torch.llm.http.service import HttpService
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.runtime.engine import Context

# test_torch_llama.py's logit bound (test_llama_model.py's).
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
NUM_BLOCKS = 32
TCFG = get_config("tiny")
JCFG = jax_config("tiny")
# (kv_cache_dtype, weight_dtype) of each int8 mode.
MODES = {"kv": ("int8", "auto"), "weights": ("auto", "int8"), "both": ("int8", "int8")}
# (attention_impl, prefill_impl, use_flash): the megakernel, and the
# per-piece path, whose paged kernel has no int8 branch (the gather serves).
IMPLS = {"megakernel": ("megakernel", "auto", False), "paged+flash": ("paged", "flash", True)}


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# 1. Quantization
# ---------------------------------------------------------------------------


def _rows(dtype_name):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 16, 2, 16)) * rng.uniform(0.01, 4, (3, 5, 16, 2, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # zero-amax rows: scale 1, codes 0
    x[1, 2, 3, 1, :4] = [0.5, -0.5, 1.5, 127.0]  # ties on the code grid of amax 127
    j = jnp.asarray(x, dtype=jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(getattr(torch, dtype_name))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_quantize_and_dequantize_kv_rows_match_jax(dtype_name):
    """Equal codes and scales (no tie rounds apart: both divide in f32 and
    round half to even), and equal dequantized rows in f32 and bf16."""
    j, t = _rows(dtype_name)
    jq, tq = jquantize_kv_rows(j), quantize_kv_rows(t)
    assert tq.q.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    assert np.all(tq.scale.numpy()[0, 0, 0] == 1.0) and np.all(tq.q.numpy()[0, 0, 0] == 0)
    for out in ("float32", "bfloat16"):
        want = np.asarray(jdequantize_kv(jq, getattr(jnp, out)).astype(jnp.float32))
        got = dequantize_kv(tq, getattr(torch, out))
        assert got.dtype == getattr(torch, out)
        np.testing.assert_array_equal(_np(got), want)
    assert dequantize_kv(t) is t


def _weight(dtype_name, shape=(3, 32, 48), seed=1):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    w[0, :, 5] = 0.0  # a zero output column: scale 1
    j = jnp.asarray(w, dtype=jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(getattr(torch, dtype_name))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_quantize_weight_and_wt_match_jax(dtype_name):
    j, t = _weight(dtype_name)
    jq, tq = jquant.quantize_weight(j), tquant.quantize_weight(t)
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    for out in ("float32", "bfloat16"):
        np.testing.assert_array_equal(_np(tquant.wt(tq, getattr(torch, out))),
                                      np.asarray(jquant.wt(jq, getattr(jnp, out)).astype(jnp.float32)))
    assert tquant.wt(t) is t


def test_wt_multiplies_in_f32_then_casts():
    """``test_int8_weights.py``'s case: the bf16 dequant is the f32 product
    rounded once (≤ 2^-8 relative), where a bf16-rounded scale misses the
    bound."""
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (64, 96), jnp.float32) * 0.07)
    qw = tquant.quantize_weight(torch.from_numpy(w))
    exact = qw.q.double() * qw.scale.double()
    rel = lambda got: ((got.double() - exact).abs() / exact.abs().clamp_min(1e-9)).max().item()  # noqa: E731
    assert rel(tquant.wt(qw, torch.bfloat16)) <= 2.0**-8 * 1.001
    assert rel(qw.q.to(torch.bfloat16) * qw.scale.to(torch.bfloat16)) > 2.0**-8 * 1.001


def test_quantize_params_matches_jax_and_keeps_embed_and_head():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_numpy(tree, TCFG, device="cpu", dtype=torch.bfloat16)
    jq = jquant.quantize_params({**jp, "layers": dict(jp["layers"])})
    assert not tquant.params_quantized(tp)
    tq = tquant.quantize_params(tp)
    assert tq is tp and tquant.params_quantized(tq)
    for k, v in tq["layers"].items():
        if k in tquant.QUANT_KEYS:
            assert isinstance(v, tquant.QuantW)
            np.testing.assert_array_equal(v.q.numpy(), np.asarray(jq["layers"][k].q))
            np.testing.assert_array_equal(v.scale.numpy(), np.asarray(jq["layers"][k].scale))
        else:
            assert v.dtype == torch.bfloat16  # norms stay as they were
    assert tq["embed"].dtype == tq["lm_head"].dtype == torch.bfloat16
    # Quantizing again leaves the codes as they are.
    before = tq["layers"]["wq"].q.clone()
    assert torch.equal(tquant.quantize_params(tq)["layers"]["wq"].q, before)
    lp = tquant.dequant_layer({"wq": tq["layers"]["wq"], "n": tq["layers"]["attn_norm"]}, torch.bfloat16)
    assert lp["wq"].dtype == torch.bfloat16 and lp["n"] is tq["layers"]["attn_norm"]


# ---------------------------------------------------------------------------
# 2. Carrying weights and caches across
# ---------------------------------------------------------------------------


def _jax_quant_tree(jp):
    jq = jquant.quantize_params({**jp, "layers": dict(jp["layers"])})
    return jq, jax.tree_util.tree_map(np.asarray, jq)


def test_params_from_numpy_carries_a_jax_quantw_tree():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    jq, tree = _jax_quant_tree(jp)
    tp = params_from_numpy(tree, TCFG, device="cpu", dtype=torch.float32)
    assert tquant.params_quantized(tp)
    for k in tquant.QUANT_KEYS:
        w = tp["layers"][k]
        assert isinstance(w, tquant.QuantW) and w.q.dtype == torch.int8 and w.scale.dtype == torch.float32
        np.testing.assert_array_equal(w.q.numpy(), np.asarray(jq["layers"][k].q))
        np.testing.assert_array_equal(w.scale.numpy(), np.asarray(jq["layers"][k].scale))
    bad = jax.tree_util.tree_map(np.asarray, jq)
    bad["layers"]["wq"] = type(bad["layers"]["wq"])(bad["layers"]["wq"].q, bad["layers"]["wq"].scale[:, :, :-1])
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(bad, TCFG, device="cpu", dtype=torch.float32)
    bad["layers"]["wq"] = type(bad["layers"]["wq"])(jq["layers"]["wq"].q.astype(jnp.int16), jq["layers"]["wq"].scale)
    with pytest.raises(ValueError, match="int8 codes"):
        params_from_numpy(bad, TCFG, device="cpu", dtype=torch.float32)


def test_int8_cache_shapes_and_a_jax_cache_carry_across():
    jcfg, tcfg = JCFG.replace(kv_cache_dtype="int8"), TCFG.replace(kv_cache_dtype="int8")
    jc = JaxCache.create(jcfg, NUM_BLOCKS)
    tc = KvCacheArrays.create(tcfg, NUM_BLOCKS, dtype=torch.float32, device="cpu")
    for jx, tx in ((jc.k, tc.k), (jc.v, tc.v)):
        assert isinstance(jx, JQuantKv) and isinstance(tx, QuantKv)
        assert tuple(tx.q.shape) == jx.q.shape and tuple(tx.scale.shape) == jx.scale.shape
        assert tx.dtype == torch.int8 and tx.scale.dtype == torch.float32 and tx.shape == tx.q.shape
    # A JAX cache after a prefill carries across as its numpy codes and scales.
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    toks = np.arange(1, 33, dtype=np.int32)
    _, jk, jv = jllama.prefill(jp, jcfg, jc.k, jc.v, jnp.asarray(toks), 20, 0, jnp.arange(1, 5, dtype=jnp.int32))
    tk = QuantKv(torch.from_numpy(np.asarray(jk.q)), torch.from_numpy(np.asarray(jk.scale)))
    np.testing.assert_array_equal(_np(dequantize_kv(tk, torch.float32)), np.asarray(jdequantize_kv(jk, jnp.float32)))
    # The layer-flat view shares the cache's storage.
    flat = tc.k.reshape(tcfg.num_layers * NUM_BLOCKS, tcfg.block_size, tcfg.num_kv_heads, tcfg.head_dim)
    assert flat.q.data_ptr() == tc.k.q.data_ptr() and flat.scale.data_ptr() == tc.k.scale.data_ptr()
    assert tuple(flat.scale.shape) == (tcfg.num_layers * NUM_BLOCKS, tcfg.block_size, tcfg.num_kv_heads, 1)


# ---------------------------------------------------------------------------
# 3. The int8 ragged plain version against the JAX kernel
# ---------------------------------------------------------------------------


def _quant_pages(rng, NP, BS, KVH, HD):
    x = rng.standard_normal((NP, BS, KVH, HD)).astype(np.float32) * rng.uniform(0.1, 3, (NP, BS, KVH, 1))
    x[2, :5] = 0.0  # zero-amax tokens (scale 1) inside a live row's pages
    x[0] = 40.0  # scratch page 0: large, so a read past a row's length shows
    jq = jquantize_kv_rows(jnp.asarray(x))
    return jq, QuantKv(torch.from_numpy(np.asarray(jq.q)), torch.from_numpy(np.asarray(jq.scale)))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_int8_ragged_plain_version_matches_jax_kernel(dtype_name):
    """A chunk row of 6 queries over a 37-token int8 prefix (pages 1-3, page
    2 with zero-amax tokens), two decode rows (prefix 20 and 0) and two dead
    queries. f32: ``test_megakernel.py``'s 5e-4. bf16: both dequantize
    each page in bf16; the outputs differ by their own bf16 rounding and
    p's (2^-7 of the largest output)."""
    rng = np.random.default_rng(3)
    H, KVH, HD, BS = 4, 2, 16, 16
    jdt = jnp.bfloat16 if dtype_name == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype_name)
    jk, tk = _quant_pages(rng, 8, BS, KVH, HD)
    jv, tv = _quant_pages(rng, 8, BS, KVH, HD)
    NQ, CK = 10, 10
    q = rng.standard_normal((NQ, H, HD)).astype(np.float32)
    ke = rng.standard_normal((CK, KVH, HD)).astype(np.float32)
    ve = rng.standard_normal((CK, KVH, HD)).astype(np.float32)
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 0, 0, 0]], np.int32)
    meta = np.stack([
        np.array([0] * 6 + [1, 2, 0, 0]),
        np.array([37] * 6 + [20, 0, 37, 37]),
        np.array([0] * 6 + [6, 7, 0, 0]),
        np.array([1, 2, 3, 4, 5, 6, 7, 8, 3, 3]),
        np.array([1] * 8 + [0, 0]),
    ]).astype(np.int32)
    cast = lambda a: jnp.asarray(a).astype(jdt)  # noqa: E731
    want = jmk.ragged_paged_attention(cast(q), cast(ke), cast(ve), jk, jv, jnp.asarray(tables), jnp.asarray(meta),
                                      num_kv_heads=KVH, block_size=BS, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tt = lambda a: torch.from_numpy(np.asarray(jnp.asarray(a).astype(jdt).astype(jnp.float32))).to(tdt)  # noqa: E731
    counts0 = (tmk.REF_CALLS_INT8, tmk.REF_CALLS, tmk.KERNEL_LAUNCHES_INT8)
    got = tmk.ragged_paged_attention(tt(q), tt(ke), tt(ve), tk, tv, torch.from_numpy(tables),
                                     torch.from_numpy(meta), num_kv_heads=KVH, block_size=BS)
    # The int8 branch's plain version, on the CPU.
    assert (tmk.REF_CALLS_INT8, tmk.REF_CALLS, tmk.KERNEL_LAUNCHES_INT8) == (counts0[0] + 1, *counts0[1:])
    assert got.dtype == tdt and np.all(got[8:].float().numpy() == 0.0)
    tol = 5e-4 if dtype_name == "float32" else 2**-7 * np.abs(want).max()
    np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# 4. The llama forward, port against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    """JAX tiny f32 weights, full precision and int8 (both packages'), as
    (jax tree, port tree) per weight dtype."""
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    full = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, device="cpu", dtype=torch.float32)
    jq, tree = _jax_quant_tree(jp)
    return {"auto": (jp, full), "int8": (jq, params_from_numpy(tree, TCFG, device="cpu", dtype=torch.float32))}


class Pair:
    """A JAX cache and a port cache fed the same calls in one int8 mode and
    attention configuration."""

    def __init__(self, weights, mode, impl="megakernel"):
        kv, wd = MODES[mode]
        self.jp, self.tp = weights[wd]
        attn, pre, self.use_flash = IMPLS[impl]
        self.jcfg = JCFG.replace(attention_impl=attn, prefill_impl=pre, kv_cache_dtype=kv, weight_dtype=wd)
        self.tcfg = TCFG.replace(attention_impl=attn, prefill_impl=pre, kv_cache_dtype=kv, weight_dtype=wd)
        jc = JaxCache.create(self.jcfg, NUM_BLOCKS, dtype=jnp.float32)
        tc = KvCacheArrays.create(self.tcfg, NUM_BLOCKS, dtype=torch.float32, device="cpu")
        self.jk, self.jv, self.tk, self.tv = jc.k, jc.v, tc.k, tc.v

    def _flash(self, cache_len):
        return dict(use_flash=True, has_prefix=cache_len > 0) if self.use_flash else {}

    def prefill(self, toks, bucket, cache_len, table):
        padded = np.zeros(bucket, np.int32)
        padded[: len(toks)] = toks
        kw = self._flash(cache_len)
        jl, self.jk, self.jv = jax.jit(lambda p, k, v: jllama.prefill(
            p, self.jcfg, k, v, jnp.asarray(padded), jnp.int32(len(toks)), jnp.int32(cache_len),
            jnp.asarray(table), **kw))(self.jp, self.jk, self.jv)
        tl, self.tk, self.tv = tllama.prefill(self.tp, self.tcfg, self.tk, self.tv, torch.from_numpy(padded),
                                              len(toks), cache_len, torch.from_numpy(table), **kw)
        return np.asarray(jl), tl.numpy()

    def decode(self, toks, pos, tables, active):
        jl, self.jk, self.jv = jax.jit(lambda p, k, v: jllama.decode(
            p, self.jcfg, k, v, *map(jnp.asarray, (toks, pos, tables, active))))(self.jp, self.jk, self.jv)
        tl, self.tk, self.tv = tllama.decode(self.tp, self.tcfg, self.tk, self.tv,
                                             *map(torch.from_numpy, (toks, pos, tables, active)))
        return np.asarray(jl), tl.numpy()

    def mixed(self, chunk, p_valid, p_cache_len, p_table, dtoks, dpos, tables, active):
        kw = self._flash(p_cache_len)
        jl, self.jk, self.jv = jax.jit(lambda p, k, v: jllama.mixed_step(
            p, self.jcfg, k, v, jnp.asarray(chunk), jnp.int32(p_valid), jnp.int32(p_cache_len),
            jnp.asarray(p_table), *map(jnp.asarray, (dtoks, dpos, tables, active)), **kw))(self.jp, self.jk, self.jv)
        tl, self.tk, self.tv = tllama.mixed_step(
            self.tp, self.tcfg, self.tk, self.tv, torch.from_numpy(chunk), p_valid, p_cache_len,
            torch.from_numpy(p_table), *map(torch.from_numpy, (dtoks, dpos, tables, active)), **kw)
        return np.asarray(jl), tl.numpy()

    def window(self, toks, pos, tables, active, steps, uniforms=None, temps=None):
        B = len(toks)
        samp = (np.zeros(B, np.float32), np.zeros(B, np.int32), np.ones(B, np.float32))
        if temps is not None:
            samp = (temps, np.array([0, 3, 0, 0][:B], np.int32), np.array([1, 1, 0.9, 1][:B], np.float32))
        ju = None if uniforms is None else jnp.asarray(uniforms)
        jt, self.jk, self.jv = jax.jit(lambda p, k, v: jllama.decode_multi(
            p, self.jcfg, k, v, *map(jnp.asarray, (toks, pos, tables, active)), *map(jnp.asarray, samp),
            jax.random.PRNGKey(0), steps, uniforms=ju))(self.jp, self.jk, self.jv)
        tu = None if uniforms is None else torch.from_numpy(uniforms)
        tt, self.tk, self.tv = tllama.decode_multi(self.tp, self.tcfg, self.tk, self.tv,
                                                   *map(torch.from_numpy, (toks, pos, tables, active)), *samp,
                                                   None, steps, uniforms=tu)
        return np.asarray(jt), tt.numpy()

    def check_cache(self):
        """Block 0 is the scratch sink padded rows write to; excluded."""
        for j, t in ((self.jk, self.tk), (self.jv, self.tv)):
            if isinstance(t, QuantKv):
                check_codes(t, j)
            else:
                np.testing.assert_allclose(t.numpy()[:, 1:], np.asarray(j)[:, 1:], atol=2e-5)


# The two packages' f32 K/V rows differ by rounding (their matmuls sum in
# other orders), so a row's amax, and its scale, may differ in the last bit,
# and a value within that rounding of a half code step may round apart.
SCALE_RTOL = 2e-5  # test_torch_llama.py's KV bound, relative to a row's amax
CODE_FLIPS = 1e-3


def check_codes(t: QuantKv, j, first_block: int = 1):
    """Equal codes but for at most one code step at a rounding tie (at most
    ``CODE_FLIPS`` of them), scales within ``SCALE_RTOL``; blocks from
    ``first_block`` on."""
    tq, jq = t.q.numpy()[:, first_block:].astype(np.int32), np.asarray(j.q)[:, first_block:].astype(np.int32)
    diff = np.abs(tq - jq)
    assert diff.max(initial=0) <= 1 and (diff > 0).mean() <= CODE_FLIPS, (int((diff > 0).sum()), diff.size)
    np.testing.assert_allclose(t.scale.numpy()[:, first_block:], np.asarray(j.scale)[:, first_block:],
                               rtol=SCALE_RTOL, atol=0)


@pytest.fixture(params=list(MODES))
def mode(request):
    return request.param


@pytest.mark.parametrize("impl", list(IMPLS))
def test_prefill_decode_and_mixed_step_match_jax(weights, mode, impl):
    """A fresh 32-token prefill, a 19-token continuation, three decode steps
    (three live rows and a padded lane) and a mixed step (a 9-token chunk
    over a 21-token prefix beside the decode rows), checking the cache
    after each call."""
    rng = np.random.default_rng(2)
    pair = Pair(weights, mode, impl)
    table = np.arange(1, 9, dtype=np.int32)
    for toks, cache_len in ((rng.integers(1, 255, size=32), 0), (rng.integers(1, 255, size=19), 32)):
        jl, tl = pair.prefill(toks, 32, cache_len, table)
        np.testing.assert_allclose(tl, jl, **LOGIT_TOL)
        pair.check_cache()
    pair.prefill(rng.integers(1, 255, size=16), 32, 0, np.arange(9, 13, dtype=np.int32))
    pair.prefill(rng.integers(1, 255, size=21), 32, 0, np.arange(13, 17, dtype=np.int32))
    tables = np.zeros((4, 8), np.int32)
    tables[0], tables[1, :4] = table, np.arange(9, 13)
    active = np.array([True, True, False, False])
    pos = np.array([51, 16, 0, 0], np.int32)
    for step in range(3):
        jl, tl = pair.decode(rng.integers(1, 255, size=4).astype(np.int32), pos + step * active, tables, active)
        np.testing.assert_allclose(tl[:2], jl[:2], **LOGIT_TOL)
        pair.check_cache()
    chunk = np.zeros(16, np.int32)
    chunk[:9] = rng.integers(1, 255, size=9)
    jl, tl = pair.mixed(chunk, 9, 21, np.arange(13, 17, dtype=np.int32), rng.integers(1, 255, size=4).astype(np.int32),
                        pos + 3 * active, tables, active)
    np.testing.assert_allclose(tl[:3], jl[:3], **LOGIT_TOL)
    pair.check_cache()


def _window_setup(weights, mode, impl="megakernel"):
    """Three live rows (prefixes 30, 16 and 7 tokens) and a padded lane,
    tables covering an 8-step window."""
    rng = np.random.default_rng(5)
    pair = Pair(weights, mode, impl)
    tables = np.zeros((4, 4), np.int32)
    for i, n in enumerate((30, 16, 7)):
        tbl = np.arange(1 + 4 * i, 4 + 4 * i, dtype=np.int32)
        pair.prefill(rng.integers(1, 255, size=n), 32, 0, tbl)
        tables[i, :3] = tbl
    toks = rng.integers(1, 255, size=4).astype(np.int32)
    return pair, toks, np.array([30, 16, 7, 0], np.int32), tables, np.array([True, True, True, False])


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "uniforms"])
def test_decode_multi_window_matches_jax(weights, mode, impl, sampled):
    """An 8-step window, greedy or drawing from the same uniforms (a sampled
    row, a top-k row, a top-p row): equal tokens and, after the window's one
    write, the JAX cache's codes and scales."""
    pair, toks, pos, tables, active = _window_setup(weights, mode, impl)
    kw = {}
    if sampled:
        kw = dict(uniforms=np.random.default_rng(6).uniform(size=(8, 4)).astype(np.float32),
                  temps=np.array([0.0, 0.9, 1.2, 0.0], np.float32))
    jt, tt = pair.window(toks, pos, tables, active, 8, **kw)
    np.testing.assert_array_equal(tt[:, :3], jt[:, :3])
    pair.check_cache()


def test_window_needs_its_full_precision_carry(weights):
    """The window's later steps attend its earlier rows at full precision
    (JAX's carry). Teacher-forced with JAX's tokens, single decode steps that
    write each row into the int8 cache give JAX's logits at step 0 only."""
    pair, toks, pos, tables, active = _window_setup(weights, "kv")
    j_toks, j_logits, _, _ = jax.jit(lambda p, k, v: jllama.decode_multi(
        p, pair.jcfg, k, v, *map(jnp.asarray, (toks, pos, tables, active)), jnp.zeros(4), jnp.zeros(4, jnp.int32),
        jnp.ones(4), jax.random.PRNGKey(0), 8, return_logits=True))(pair.jp, pair.jk, pair.jv)
    j_toks, j_logits = np.asarray(j_toks), np.asarray(j_logits)
    feed = np.concatenate([toks[None], j_toks[:-1]])
    errs = []
    for i in range(8):
        _, tl = pair.decode(feed[i], pos + i * active, tables, active)
        errs.append(np.abs(tl[:3] - j_logits[i, :3]).max())
    assert errs[0] <= LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * np.abs(j_logits[0]).max()
    assert max(errs[1:]) > 10 * (LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * np.abs(j_logits).max()), errs


# ---------------------------------------------------------------------------
# 5. Degrades, refusals, the scheduler, the engine
# ---------------------------------------------------------------------------


def test_paged_degrades_to_gather_and_warns_once(weights, caplog):
    cfg = TCFG.replace(attention_impl="paged", prefill_impl="flash", kv_cache_dtype="int8")
    cache = KvCacheArrays.create(cfg, NUM_BLOCKS, dtype=torch.float32, device="cpu")
    assert tllama.resolve_attention_impl(cfg, cache.k) == "gather"
    assert tllama.resolve_attention_impl(TCFG.replace(attention_impl="paged")) == "paged"
    tllama._warned_paged_int8 = False
    with caplog.at_level(logging.WARNING, logger=tllama.__name__):
        for _ in range(2):
            s = tsched.Scheduler(cfg, weights["auto"][1], tsched.SchedulerConfig(num_blocks=NUM_BLOCKS),
                                 dtype=torch.float32, device="cpu")
    assert sum("no int8-KV path" in r.message for r in caplog.records) == 1
    assert s.config_snapshot()["model"]["attention_impl"] == "gather"
    # The flash chunk kernel's plain version still serves the chunk.
    flash0 = tprefill.REF_CALLS
    tllama.prefill(weights["auto"][1], cfg, cache.k, cache.v, torch.arange(1, 33, dtype=torch.int32), 30, 0,
                   torch.arange(1, 5, dtype=torch.int32), use_flash=True, has_prefix=False)
    assert tprefill.REF_CALLS == flash0 + cfg.num_layers


def test_fused_gates_refuse_int8_and_attach_draft_raises(weights):
    """No fused window under int8 (as in the JAX package); a draft still
    attaches, with no fused spec window, and speculates one round an
    iteration (its cache int8 where its config says so); a greedy request
    gets the answer of the same scheduler without the draft (over an int8
    KV cache, up to the KV quantization)."""

    def run(s):
        s.add_request("r", list(range(1, 21)), SamplingParams(temperature=0.0),
                      tsched.StopConditions(max_tokens=11, ignore_eos=True))
        out = []
        while s.has_work():
            out += [o.token_id for _, o in s.step() if o.token_id >= 0]
        return out

    cfg_params = []
    for kv, wd in MODES.values():
        cfg = TCFG.replace(kv_cache_dtype=kv, weight_dtype=wd)
        params = tquant.quantize_params(dict(weights["auto"][1], layers=dict(weights["auto"][1]["layers"]))) \
            if wd == "int8" else weights["auto"][1]
        cfg_params.append((cfg, params))
    sc = dict(num_blocks=NUM_BLOCKS, num_scheduler_steps=8)
    for cfg, params in cfg_params + [(TCFG, weights["auto"][1])]:
        s = tsched.Scheduler(cfg, params, tsched.SchedulerConfig(**sc), dtype=torch.float32, device="cpu")
        if cfg is TCFG:
            # An int8 draft beside a full-precision target: the target keeps
            # its fused window, the draft takes no fused spec window.
            assert s._use_fused_window
            draft_cfg = TCFG.replace(kv_cache_dtype="int8")
        else:
            assert not s._use_fused_window and not s._fused_guided_ok()
            assert s.config_snapshot()["model"]["kv_cache_dtype"] == cfg.kv_cache_dtype
            assert s.config_snapshot()["model"]["weight_dtype"] == cfg.weight_dtype
            draft_cfg = TCFG
        s.attach_draft(draft_cfg, weights["auto"][1])
        assert not s._use_fused_spec and isinstance(s.draft_cache.k, QuantKv) == (draft_cfg is not TCFG)
        got = run(s)
        assert s.spec_rounds_total > 0 and s.spec_fused_windows_total == 0
        want = run(tsched.Scheduler(cfg, params, tsched.SchedulerConfig(**sc), dtype=torch.float32, device="cpu"))
        if cfg.kv_cache_dtype == "int8":
            # A verify attends its own chunk's K/V at full precision where
            # single steps read them back from the int8 cache (as in the JAX
            # package), so greedy tokens agree only up to the KV
            # quantization: the prefill's token, and the length.
            assert got[0] == want[0] and len(got) == len(want)
        else:
            assert got == want


BUCKETS = dict(prefill_buckets=[32, 64], decode_buckets=[1, 2, 4])


def _trace():
    """(arrival step, request id, prompt, max_tokens, sampling options). B
    is longer than the mixed budget (chunks, mixed steps); C repeats A's
    32-token prompt while A still runs: a full-cover prefix hit whose last
    block A holds, so it is copied on write; D samples, E samples seeded."""
    rng = np.random.default_rng(0)
    a = rng.integers(1, 255, size=32).tolist()
    return [
        (0, "A", a, 30, {"temperature": 0.0}),
        (2, "B", rng.integers(1, 255, size=80).tolist(), 20, {"temperature": 0.0}),
        (4, "C", list(a), 12, {"temperature": 0.0}),
        (5, "D", rng.integers(1, 255, size=20).tolist(), 18, {"temperature": 0.8}),
        (6, "E", rng.integers(1, 255, size=12).tolist(), 15, {"temperature": 0.9, "top_k": 20, "seed": 77}),
    ]


def _replay(sched, mod, sampling_cls):
    outs = {}
    trace = _trace()
    for step in range(400):
        for at, rid, prompt, max_tokens, opts in trace:
            if at == step:
                sched.add_request(rid, prompt, sampling_cls(**opts), mod.StopConditions(max_tokens=max_tokens))
        if step > trace[-1][0] and not sched.has_work():
            break
        for seq, out in sched.step():
            outs.setdefault(seq.request_id, []).append(out)
    assert not sched.has_work()
    return {rid: {"tokens": [o.token_id for o in res if o.token_id >= 0],
                  "finish": [o.finish_reason for o in res if o.finished],
                  "cached": [o.cached_tokens for o in res if o.cached_tokens is not None]}
            for rid, res in outs.items()}


@pytest.mark.parametrize("steps", [1, 8])
def test_scheduler_matches_jax_int8(weights, steps):
    """int8 KV and int8 weights: the same token streams (greedy, sampled and
    seeded), the same allocator events, prefix-cache hits and copies, the
    same model snapshot and metric keys, and equal codes and scales in every
    block (the copied one among them) at the end. Windows run through
    ``decode_multi`` (no fused window under int8) beside the single steps
    the seeded row takes."""
    common = dict(num_blocks=24, max_running=4, mixed_prefill_budget=32, num_scheduler_steps=steps, **BUCKETS)
    jev, tev = [], []
    jq, tq = weights["int8"]
    j = jsched.Scheduler(JCFG.replace(attention_impl="megakernel", kv_cache_dtype="int8", weight_dtype="int8"), jq,
                         jsched.SchedulerConfig(**common), dtype=jnp.float32,
                         eos_token_ids=[0], on_kv_event=jev.append)
    t = tsched.Scheduler(TCFG.replace(kv_cache_dtype="int8", weight_dtype="int8"), tq, tsched.SchedulerConfig(**common),
                         dtype=torch.float32, device="cpu", eos_token_ids=[0], on_kv_event=tev.append)
    assert not j._use_fused_window and not t._use_fused_window
    want = _replay(j, jsched, JaxSampling)
    got = _replay(t, tsched, SamplingParams)
    assert got == want
    assert [(e.kind, e.block_hashes, e.parent_hash) for e in tev] == [(e.kind, e.block_hashes, e.parent_hash)
                                                                      for e in jev]
    assert got["C"]["cached"] == [31] and t.cow_blocks_total == j.cow_blocks_total == 1
    assert t.mixed_steps_total == j.mixed_steps_total > 0 and t.cached_tokens_total == j.cached_tokens_total
    assert t.config_snapshot()["model"] == j.config_snapshot()["model"]
    assert set(t.metrics().to_wire()) <= set(j.metrics().to_wire())
    if steps > 1:
        assert t.multi_windows_total > 0 and t.decode_steps_total > 0  # the seeded row single-steps
    for jc, tc in ((j.cache.k, t.cache.k), (j.cache.v, t.cache.v)):
        check_codes(tc, jc)


def _chat(port, body):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/chat/completions", json.dumps(body), {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    assert resp.status == 200, raw
    return json.loads(raw)["choices"][0]["message"]["content"]


BODY = {"model": "tiny", "messages": [{"role": "user", "content": "hello int8"}], "max_tokens": 12, "temperature": 0.0}


async def _jax_text(jp):
    engine = TpuEngine.build(
        JaxEngineArgs(model="tiny", dtype="float32", continuous_profiling=False, eos_token_ids=[0],
                      kv_cache_dtype="int8", weight_dtype="int8",
                      scheduler=jsched.SchedulerConfig(num_blocks=64, num_scheduler_steps=1, **BUCKETS)),
        params={**jp, "layers": dict(jp["layers"])},  # the engine quantizes the layers in place
    )
    pipeline = jax_pipeline(JaxByteTokenizer(), engine)
    parts = []
    try:
        async for item in pipeline.generate(dict(BODY), JaxContext()):
            data = getattr(item, "data", None)
            if data:
                parts.append(data.get("text") or "")
    finally:
        await engine.stop()
    return "".join(parts)


def test_engine_serves_int8_over_http_with_guided_and_seeded_requests(weights):
    """``EngineArgs(kv_cache_dtype="int8", weight_dtype="int8")`` quantizes
    the weights it is given and serves: a greedy chat gives the JAX int8
    engine's text for the same weights; a ``json_object`` request comes back
    in its grammar and a seeded sampled request twice the same, both
    through single decode steps (no fused window under int8)."""
    jp, tp = weights["auto"]
    tok = ByteTokenizer()

    async def serve():
        engine = TorchEngine.build(
            EngineArgs(model="tiny", dtype="float32", device="cpu", eos_token_ids=tok.eos_token_ids,
                       kv_cache_dtype="int8", weight_dtype="int8",
                       scheduler=tsched.SchedulerConfig(num_blocks=64, num_scheduler_steps=8, **BUCKETS)),
            params=dict(tp, layers=dict(tp["layers"])),
        )
        manager = ModelManager()
        manager.add_model("chat", "tiny", build_local_pipeline(tok, engine))
        service = HttpService(manager, host="127.0.0.1", port=0)
        await service.start()
        try:
            sched = engine.scheduler
            assert isinstance(sched.cache.k, QuantKv) and tquant.params_quantized(sched.params)
            greedy = await asyncio.to_thread(_chat, service.port, BODY)
            multi0, single0 = sched.multi_windows_total, sched.decode_steps_total
            obj = await asyncio.to_thread(_chat, service.port, {**BODY, "max_tokens": 24,
                                                                "response_format": {"type": "json_object"}})
            seeded = {**BODY, "temperature": 0.9, "seed": 1234}
            draws = [await asyncio.to_thread(_chat, service.port, seeded) for _ in range(2)]
            routes = (sched.multi_windows_total - multi0, sched.decode_steps_total - single0)
        finally:
            await service.stop()
            await engine.stop()
        return greedy, obj, draws, routes

    greedy, obj, draws, (multi, single) = asyncio.run(serve())
    assert greedy == asyncio.run(_jax_text(jp))
    assert obj.startswith("{") or obj == ""
    from dynamo_tpu_torch.llm.guided.grammar import build_guided_spec, compile_regex

    dfa = compile_regex(build_guided_spec({"response_format": {"type": "json_object"}})["pattern"])
    state = dfa.start
    for c in obj:
        state = dfa.step(state, c)
    assert state >= 0, obj  # a prefix of a JSON object, or a whole one
    assert draws[0] == draws[1]
    assert multi == 0 and single > 0


def test_run_flags_parse_and_build():
    from dynamo_tpu_torch import run

    args = run.parse_args(["in=http", "out=tiny", "--device", "cpu", "--dtype", "float32", "--num-blocks", "16",
                           "--kv-cache-dtype", "int8", "--weight-dtype", "int8"])
    assert (args.kv_cache_dtype, args.weight_dtype) == ("int8", "int8")
    assert run.parse_args(["in=http", "out=tiny"]).kv_cache_dtype == "auto"
    with pytest.raises(SystemExit):
        run.parse_args(["in=http", "out=tiny", "--kv-cache-dtype", "fp8"])
    service, engine = run.build_service(args)
    s = engine.scheduler
    assert s.mc.kv_cache_dtype == s.mc.weight_dtype == "int8"
    assert isinstance(s.cache.k, QuantKv) and s.cache.k.q.shape[1] == 16
    assert isinstance(s.params["layers"]["w_up"], tquant.QuantW) and s.params["embed"].dtype == torch.float32
    asyncio.run(engine.stop())
