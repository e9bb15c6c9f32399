"""The port's llama forward passes against the JAX package's.

One set of JAX weights (converted with ``params_from_numpy``) and the same
token inputs go through ``prefill`` (fresh, and a continuation over a
cached prefix), ``decode`` and ``mixed_step`` of both packages, on each
attention configuration both have: the megakernel path, the per-piece path
with the paged decode kernel and the flash chunk kernel (``paged`` +
``flash``), and the per-piece path in plain tensor code (``gather`` +
``xla``). The JAX side runs its Pallas kernels in interpreter mode. Logits
agree to the bound of ``tests/test_llama_model.py`` and the written KV
cache, excluding scratch block 0, to 2e-5. The model is ``tiny`` in f32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.kv_cache import KvCacheArrays as JaxCache
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu_torch.engine.attention import decode as tdecode
from dynamo_tpu_torch.engine.attention import megakernel as tmk
from dynamo_tpu_torch.engine.attention import prefill as tprefill
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays
from dynamo_tpu_torch.engine.models import llama as tllama
from dynamo_tpu_torch.engine.weights import init_params, param_shapes, params_from_numpy

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
KV_ATOL = 2e-5
NUM_BLOCKS = 32

# Attention configurations: (attention_impl, prefill_impl, use_flash).
IMPLS = {
    "megakernel": ("megakernel", "auto", False),
    "paged+flash": ("paged", "flash", True),
    "gather+xla": ("gather", "xla", False),
}
TCFG = get_config("tiny")


@pytest.fixture(scope="module")
def params():
    jcfg = jax_config("tiny")
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_numpy(tree, TCFG, device="cpu", dtype=torch.float32)


@pytest.fixture(params=list(IMPLS))
def impl(request):
    return request.param


class Pair:
    """A JAX cache and a port cache fed the same calls under one attention
    configuration. Prefill chunks and mixed steps pass ``use_flash`` and
    ``has_prefix = cache_len > 0`` to both sides, as the schedulers do."""

    def __init__(self, params, impl="megakernel"):
        self.jp, self.tp = params
        attn, pre, self.use_flash = IMPLS[impl]
        self.jcfg = jax_config("tiny").replace(attention_impl=attn, prefill_impl=pre)
        self.tcfg = TCFG.replace(attention_impl=attn, prefill_impl=pre)
        jc = JaxCache.create(self.jcfg, NUM_BLOCKS, dtype=jnp.float32)
        tc = KvCacheArrays.create(self.tcfg, NUM_BLOCKS, dtype=torch.float32, device="cpu")
        self.jk, self.jv, self.tk, self.tv = jc.k, jc.v, tc.k, tc.v

    def _flash(self, cache_len):
        return dict(use_flash=True, has_prefix=cache_len > 0) if self.use_flash else {}

    def prefill(self, toks, bucket, cache_len, table):
        padded = np.zeros(bucket, np.int32)
        padded[: len(toks)] = toks
        kw = self._flash(cache_len)
        jl, self.jk, self.jv = jax.jit(
            lambda p, k, v: jllama.prefill(
                p, self.jcfg, k, v, jnp.asarray(padded), jnp.int32(len(toks)), jnp.int32(cache_len),
                jnp.asarray(table), **kw,
            )
        )(self.jp, self.jk, self.jv)
        tl, self.tk, self.tv = tllama.prefill(
            self.tp, self.tcfg, self.tk, self.tv, torch.from_numpy(padded), len(toks), cache_len,
            torch.from_numpy(table), **kw,
        )
        return np.asarray(jl), tl.numpy()

    def decode(self, toks, pos, tables, active):
        jl, self.jk, self.jv = jax.jit(
            lambda p, k, v: jllama.decode(
                p, self.jcfg, k, v, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(tables),
                jnp.asarray(active)
            )
        )(self.jp, self.jk, self.jv)
        tl, self.tk, self.tv = tllama.decode(
            self.tp, self.tcfg, self.tk, self.tv, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(tables), torch.from_numpy(active),
        )
        return np.asarray(jl), tl.numpy()

    def mixed(self, chunk, p_valid, p_cache_len, p_table, dtoks, dpos, tables, active):
        kw = self._flash(p_cache_len)
        jl, self.jk, self.jv = jax.jit(
            lambda p, k, v: jllama.mixed_step(
                p, self.jcfg, k, v, jnp.asarray(chunk), jnp.int32(p_valid), jnp.int32(p_cache_len),
                jnp.asarray(p_table), jnp.asarray(dtoks), jnp.asarray(dpos), jnp.asarray(tables),
                jnp.asarray(active), **kw,
            )
        )(self.jp, self.jk, self.jv)
        tl, self.tk, self.tv = tllama.mixed_step(
            self.tp, self.tcfg, self.tk, self.tv, torch.from_numpy(chunk), p_valid, p_cache_len,
            torch.from_numpy(p_table), torch.from_numpy(dtoks), torch.from_numpy(dpos),
            torch.from_numpy(tables), torch.from_numpy(active), **kw,
        )
        return np.asarray(jl), tl.numpy()

    def check_kv(self):
        # Block 0 is the scratch sink padded rows write to; excluded.
        np.testing.assert_allclose(self.tk.numpy()[:, 1:], np.asarray(self.jk)[:, 1:], atol=KV_ATOL)
        np.testing.assert_allclose(self.tv.numpy()[:, 1:], np.asarray(self.jv)[:, 1:], atol=KV_ATOL)


def test_params_from_numpy_keeps_the_jax_layout(params):
    jp, tp = params
    for name, shape in param_shapes(TCFG)["layers"].items():
        assert tuple(tp["layers"][name].shape) == shape
        np.testing.assert_array_equal(tp["layers"][name].numpy(), np.asarray(jp["layers"][name]))
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["layers"]["wq"] = bad["layers"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="wq"):
        params_from_numpy(bad, TCFG, device="cpu", dtype=torch.float32)


def test_init_params_shapes_and_scales():
    cfg = TCFG.replace(vocab_size=512, hidden_size=128, intermediate_size=256)
    p = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    assert tuple(p["layers"]["w_down"].shape) == (cfg.num_layers, 256, 128)
    assert "lm_head" in p  # tiny is untied
    assert torch.all(p["layers"]["attn_norm"] == 1)
    # Matmul weights are N(0, 1)·in^-0.5, the embedding N(0, 1)·0.02.
    assert abs(p["layers"]["w_down"].std().item() - 256**-0.5) < 0.1 * 256**-0.5
    assert abs(p["embed"].std().item() - 0.02) < 0.002


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 4, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.array([0, 1, 7, 100, 3000], np.int32)
    np.testing.assert_allclose(
        tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)), rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        tllama.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jllama.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)), rtol=1e-5, atol=2e-5,
    )


def test_prefill_fresh_and_continuation(params, impl):
    """A fresh 32-token prefill (ends exactly on a page boundary), then a
    19-token continuation chunk over it."""
    rng = np.random.default_rng(2)
    table = np.arange(1, 9, dtype=np.int32)
    pair = Pair(params, impl)
    jl, tl = pair.prefill(rng.integers(1, 255, size=32), 32, 0, table)
    np.testing.assert_allclose(tl, jl, **LOGIT_TOL)
    jl, tl = pair.prefill(rng.integers(1, 255, size=19), 32, 32, table)
    np.testing.assert_allclose(tl, jl, **LOGIT_TOL)
    pair.check_kv()


def test_decode_steps(params, impl):
    """Three decode steps for a batch of 3 live rows and one padded lane."""
    rng = np.random.default_rng(3)
    pair = Pair(params, impl)
    prompts = [(rng.integers(1, 255, size=n), np.arange(1 + 4 * i, 5 + 4 * i, dtype=np.int32))
               for i, n in enumerate((30, 16, 7))]
    for toks, tbl in prompts:
        pair.prefill(toks, 32, 0, tbl)
    tables = np.zeros((4, 6), np.int32)
    for i, (_, tbl) in enumerate(prompts):
        tables[i, :4] = tbl
    active = np.array([True, True, True, False])
    pos = np.array([30, 16, 7, 0], np.int32)
    for step in range(3):
        toks = rng.integers(1, 255, size=4).astype(np.int32)
        jl, tl = pair.decode(toks, pos + step * active, tables, active)
        np.testing.assert_allclose(tl[:3], jl[:3], **LOGIT_TOL)
    pair.check_kv()


def test_mixed_step(params, impl):
    """A 9-token chunk (16-bucket) over a 21-token cached prefix plus three
    live decode rows, one at a page-exact position, and an inactive lane;
    then a fresh 12-token chunk (no cached prefix) with the same rows one
    step on."""
    rng = np.random.default_rng(4)
    pair = Pair(params, impl)
    seeds = [
        (rng.integers(1, 255, size=21), np.arange(5, 9)),
        (rng.integers(1, 255, size=30), np.arange(1, 5)),
        (rng.integers(1, 255, size=16), np.arange(9, 13)),
        (rng.integers(1, 255, size=7), np.arange(13, 17)),
    ]
    for toks, tbl in seeds:
        pair.prefill(toks, 32, 0, tbl.astype(np.int32))
    tables = np.stack([np.r_[1:5, 0, 0, 0, 0], np.r_[9:13, 0, 0, 0, 0], np.r_[13:17, 0, 0, 0, 0],
                       np.zeros(8)]).astype(np.int32)
    active = np.array([True, True, True, False])
    dpos = np.array([30, 16, 7, 0], np.int32)
    # (chunk tokens, cached prefix, block table) of the two chunk rows.
    chunks = [(9, 21, np.arange(5, 9, dtype=np.int32)), (12, 0, np.arange(17, 21, dtype=np.int32))]
    for step, (n, cache_len, p_table) in enumerate(chunks):
        chunk = np.zeros(16, np.int32)
        chunk[:n] = rng.integers(1, 255, size=n)
        dtoks = rng.integers(1, 255, size=4).astype(np.int32)
        jl, tl = pair.mixed(chunk, n, cache_len, p_table, dtoks, dpos + step * active, tables, active)
        # Rows: the chunk's last position, then the live decode lanes (the
        # inactive lane's logits are never read by the scheduler).
        np.testing.assert_allclose(tl[:4], jl[:4], **LOGIT_TOL)
    pair.check_kv()


# Kernel wrappers each configuration's forward passes reach on the CPU (as
# plain-version calls), per layer: (prefill fresh, prefill continuation,
# decode, mixed step with a fresh chunk).
WRAPPERS = {"megakernel": tmk, "flash": tprefill, "paged": tdecode}
EXPECTED_CALLS = {
    "megakernel": [{"megakernel": 1}] * 4,
    "paged+flash": [{"flash": 1}, {"flash": 1}, {"paged": 1}, {"flash": 1, "paged": 1}],
    "gather+xla": [{}] * 4,
}


def test_attention_launches_once_per_layer_per_step(params, impl):
    """Every forward pass goes through its path's kernel wrappers exactly
    once per layer each (the plain versions here, on CPU tensors), and
    through no other kernel's."""
    pair = Pair(params, impl)
    table = np.arange(1, 5, dtype=np.int32)
    steps = [
        lambda: pair.prefill(np.arange(1, 20), 32, 0, table),
        lambda: pair.prefill(np.arange(1, 9), 32, 19, table),
        lambda: pair.decode(np.array([5], np.int32), np.array([27], np.int32), table[None], np.array([True])),
        lambda: pair.mixed(np.arange(1, 17, dtype=np.int32), 16, 0, np.arange(5, 9, dtype=np.int32),
                           np.array([6], np.int32), np.array([28], np.int32), table[None], np.array([True])),
    ]
    for step, want in zip(steps, EXPECTED_CALLS[impl]):
        before = {name: mod.REF_CALLS for name, mod in WRAPPERS.items()}
        step()
        got = {name: mod.REF_CALLS - before[name] for name, mod in WRAPPERS.items()}
        assert got == {name: TCFG.num_layers * want.get(name, 0) for name in WRAPPERS}
