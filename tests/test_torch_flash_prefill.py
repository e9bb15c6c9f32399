"""The port's flash chunk attention, piece merge and ragged chunk attention
against the JAX package's.

The same seeded numpy inputs go through the JAX ``flash_chunk_attention``
(Pallas, interpreter mode) and the port's, which on CPU tensors runs its
plain version ``flash_chunk_attention_ref``: chunk lengths 16, 64 and 1024
(the JAX kernel walks more than one key block at 1024), padded chunks
(``valid_len < T``) and 1, 2 or 4 query heads per KV head. Then
``merge_attention_pieces`` and both branches of ``ragged_chunk_attention``
(flash and xla, a fresh chunk and one over a cached prefix). All in f32;
only the summation order differs. The CUDA kernel is held against the
plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine.attention import prefill as jprefill
from dynamo_tpu.engine.attention import ragged as jragged
from dynamo_tpu_torch.engine.attention import prefill as tprefill
from dynamo_tpu_torch.engine.attention import ragged as tragged

OUT_TOL = dict(rtol=2e-5, atol=2e-5)  # out and l
M_ATOL = 1e-5


def _chunk(seed, T, KVH, G, HD):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, KVH * G, HD)).astype(np.float32)
    k = rng.standard_normal((T, KVH, HD)).astype(np.float32)
    v = rng.standard_normal((T, KVH, HD)).astype(np.float32)
    return q, k, v


# (T, valid_len, KVH, G, HD)
CASES = [
    (16, 16, 2, 1, 16),
    (16, 9, 1, 4, 32),
    (64, 50, 2, 2, 16),
    (64, 64, 1, 4, 64),
    (1024, 1000, 2, 4, 32),
    (1024, 1024, 1, 2, 16),
    # The edges of the card kernel's 128-row tiles: one query past a tile,
    # a single valid key, 64 query heads per KV head.
    (129, 129, 2, 4, 16),
    (64, 1, 1, 4, 32),
    (40, 33, 1, 64, 16),
]


@pytest.mark.parametrize("T,valid,KVH,G,HD", CASES, ids=[f"T{c[0]}-v{c[1]}-kvh{c[2]}-g{c[3]}" for c in CASES])
def test_flash_chunk_attention_matches_jax(T, valid, KVH, G, HD):
    q, k, v = _chunk(T + valid + G, T, KVH, G, HD)
    jo, jm, jl = jprefill.flash_chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(valid), num_kv_heads=KVH, interpret=True
    )
    before = tprefill.REF_CALLS
    to, tm, tl = tprefill.flash_chunk_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), valid, num_kv_heads=KVH
    )
    assert tprefill.REF_CALLS == before + 1
    assert to.shape == (T, KVH * G, HD) and tm.shape == tl.shape == (T, KVH, G)
    assert tm.dtype == tl.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **OUT_TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=M_ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **OUT_TOL)
    # Padded queries attend every valid key: real numbers, not zeros.
    if valid < T:
        assert torch.all(tl[valid:] > 0) and torch.all(to[valid:].abs().sum(-1) > 0)


def test_merge_attention_pieces_matches_jax():
    rng = np.random.default_rng(7)
    T, KVH, G, HD = 12, 2, 3, 16
    out2 = rng.standard_normal((T, KVH * G, HD)).astype(np.float32)
    m2 = rng.standard_normal((T, KVH, G)).astype(np.float32)
    l2 = rng.uniform(0.5, 4, (T, KVH, G)).astype(np.float32)
    m1 = rng.standard_normal((KVH, T, G)).astype(np.float32)
    m1[0, :3] = -1e30  # rows whose prefix piece is empty
    l1 = rng.uniform(0.5, 4, (KVH, T, G)).astype(np.float32)
    acc1 = rng.standard_normal((KVH, T, G, HD)).astype(np.float32)
    want = jprefill.merge_attention_pieces(*(jnp.asarray(a) for a in (out2, m2, l2, m1, l1, acc1)))
    got = tprefill.merge_attention_pieces(*(torch.from_numpy(a) for a in (out2, m2, l2, m1, l1, acc1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)
    # An empty prefix piece leaves the chunk piece as it was.
    np.testing.assert_allclose(got.numpy()[:3, :G], out2[:3, :G], **OUT_TOL)


# (use_flash, has_prefix, cache_len): the flash branch fresh and over a
# prefix; the xla branch fresh (the prefix mask covers it) and over a prefix.
RAGGED = [(True, False, 0), (True, True, 37), (False, False, 0), (False, True, 37)]


@pytest.mark.parametrize("use_flash,has_prefix,cache_len", RAGGED,
                         ids=["flash-fresh", "flash-prefix", "xla-fresh", "xla-prefix"])
def test_ragged_chunk_attention_matches_jax(use_flash, has_prefix, cache_len):
    T, valid, KVH, G, HD, ctx = 32, 23, 2, 2, 16, 48
    q, k, v = _chunk(11, T, KVH, G, HD)
    rng = np.random.default_rng(12)
    k_ctx = rng.standard_normal((ctx, KVH, HD)).astype(np.float32)
    v_ctx = rng.standard_normal((ctx, KVH, HD)).astype(np.float32)
    k_ctx[cache_len:] = v_ctx[cache_len:] = 50.0  # past the prefix: must stay unread
    pieces = (k_ctx, v_ctx) if has_prefix or not use_flash else (None, None)
    kw = dict(num_kv_heads=KVH, use_flash=use_flash, has_prefix=has_prefix)
    want = jragged.ragged_chunk_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), *(None if a is None else jnp.asarray(a) for a in pieces),
        jnp.int32(valid), jnp.int32(cache_len), interpret=True, **kw,
    )
    got = tragged.ragged_chunk_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        *(None if a is None else torch.from_numpy(a) for a in pieces), valid, cache_len, **kw,
    )
    assert got.shape == (T, KVH * G, HD) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_wrapper_rules_off_the_card():
    """The wrapper runs the plain version on CPU tensors only, refuses other
    devices, and refuses a chunk with no valid key."""
    q, k, v = (torch.from_numpy(a) for a in _chunk(1, 8, 1, 2, 16))
    with pytest.raises(ValueError, match="valid_len"):
        tprefill.flash_chunk_attention(q, k, v, 0, num_kv_heads=1)
    with pytest.raises(ValueError, match="valid_len"):
        tprefill.flash_chunk_attention(q, k, v, 9, num_kv_heads=1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tprefill.flash_chunk_attention(q.to("meta"), k.to("meta"), v.to("meta"), 8, num_kv_heads=1)
