"""The port's paged flash-decode partials against the JAX package's.

The same seeded numpy inputs go through the JAX ``paged_decode_partials``
(Pallas, interpreter mode) and the port's, which on CPU tensors runs its
plain version ``paged_decode_partials_ref``: a length-0 row, partial last
pages, a table wider than the longest row, page sizes 8 and 16, and
scratch page 0 filled with 1e4, so that a read past a row's length shows.
All in f32; only the summation order differs. The CUDA kernel is held
against the plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine.attention import decode as jdecode
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu_torch.engine.attention import decode as tdecode
from dynamo_tpu_torch.engine.models import llama as tllama

M_ATOL = 1e-5
TOL = dict(rtol=2e-5, atol=2e-5)  # l and acc


def _case(seed, *, BS, KVH, G, HD, lengths, extra_width):
    """Rows of ``lengths`` tokens over pages drawn at random from a pool
    whose page 0 is scratch (1e4); tables are ``extra_width`` slots wider
    than the longest row needs, and unused slots point at page 0."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    n_pages = [(n + BS - 1) // BS for n in lengths]
    W = max(n_pages) + extra_width
    NP = sum(n_pages) + 1
    ids = rng.permutation(np.arange(1, NP)).astype(np.int32)
    tables = np.zeros((B, W), np.int32)
    o = 0
    for b, n in enumerate(n_pages):
        tables[b, :n] = ids[o:o + n]
        o += n
    k_pages = rng.standard_normal((NP, BS, KVH, HD)).astype(np.float32)
    v_pages = rng.standard_normal((NP, BS, KVH, HD)).astype(np.float32)
    k_pages[0] = v_pages[0] = 1e4
    q = rng.standard_normal((B, KVH * G, HD)).astype(np.float32)
    return q, k_pages, v_pages, tables, np.asarray(lengths, np.int32)


CASES = {
    # Empty row, partial last pages, one page exactly full, a wide table.
    "bs16-gqa": dict(BS=16, KVH=2, G=4, HD=32, lengths=[0, 1, 16, 17, 70], extra_width=3),
    "bs8-mha": dict(BS=8, KVH=4, G=1, HD=16, lengths=[33, 0, 8, 5], extra_width=2),
    "bs8-mqa": dict(BS=8, KVH=1, G=4, HD=64, lengths=[100, 7], extra_width=5),
}


@pytest.mark.parametrize("name", list(CASES))
def test_paged_decode_partials_match_jax(name):
    spec = CASES[name]
    q, kp, vp, tables, lengths = _case(len(name), **spec)
    kw = dict(num_kv_heads=spec["KVH"], block_size=spec["BS"])
    jm, jl, jacc = jdecode.paged_decode_partials(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lengths)), interpret=True, **kw
    )
    before = tdecode.REF_CALLS
    tm, tl, tacc = tdecode.paged_decode_partials(*(torch.from_numpy(a) for a in (q, kp, vp, tables, lengths)), **kw)
    assert tdecode.REF_CALLS == before + 1
    B, G, HD = len(lengths), spec["G"], spec["HD"]
    assert tm.shape == tl.shape == (B, spec["KVH"], G) and tacc.shape == (B, spec["KVH"], G, HD)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=M_ATOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tacc.numpy(), np.asarray(jacc), **TOL)
    # Empty rows are the empty piece: m = -1e30 (finite), l = 0, acc = 0.
    empty = lengths == 0
    assert torch.all(tm[empty] == -1e30) and torch.all(tl[empty] == 0) and torch.all(tacc[empty] == 0)


# Rows split at the kernel's KS keys (256 here): rows ending one key before,
# at and after a split's edge, rows shorter than the table (empty trailing
# splits) and an empty row (every split empty).
SPLITS = {
    "bs16-edges": dict(BS=16, KVH=2, G=4, HD=32, lengths=[255, 256, 257, 512, 600, 0], extra_width=3),
    "bs8-mqa": dict(BS=8, KVH=1, G=4, HD=16, lengths=[300, 8, 513], extra_width=2),
}


@pytest.mark.parametrize("name", list(SPLITS))
def test_split_merge_matches_jax(name):
    """The card kernel's algorithm on the CPU: each split's partials from
    the plain version over its own slice of the table, merged as the
    kernel's last block merges them, against the JAX kernel over the whole
    row. f32: m within 1e-5; l and acc within 1e-5 relative (to the
    largest value, as summation orders differ)."""
    spec = SPLITS[name]
    q, kp, vp, tables, lengths = _case(len(name) + 3, **spec)
    BS, KVH = spec["BS"], spec["KVH"]
    kw = dict(num_kv_heads=KVH, block_size=BS)
    jm, jl, jacc = (np.asarray(a) for a in jdecode.paged_decode_partials(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lengths)), interpret=True, **kw))
    KS = tdecode.split_keys(tables.shape[1], BS)
    S = tdecode.num_splits(tables.shape[1], BS)
    assert KS == 256 and S == -(-tables.shape[1] * BS // KS)
    per = KS // BS  # table slots per split
    parts = []
    for s_ in range(S):
        tab = torch.from_numpy(np.ascontiguousarray(tables[:, s_ * per:(s_ + 1) * per]))
        n = torch.from_numpy(np.clip(lengths - s_ * KS, 0, KS).astype(np.int32))
        parts.append(tdecode.paged_decode_partials_ref(torch.from_numpy(q), torch.from_numpy(kp),
                                                       torch.from_numpy(vp), tab, n, **kw))
    m_s, l_s, acc_s = (torch.stack(x) for x in zip(*parts))
    m = m_s.amax(dim=0)
    a = torch.exp(m_s - m)
    l = (l_s * a).sum(dim=0)
    acc = (acc_s * a[..., None]).sum(dim=0)
    np.testing.assert_allclose(m.numpy(), jm, atol=M_ATOL, rtol=0)
    np.testing.assert_allclose(l.numpy(), jl, rtol=1e-5, atol=1e-5 * np.abs(jl).max())
    np.testing.assert_allclose(acc.numpy(), jacc, rtol=1e-5, atol=1e-5 * np.abs(jacc).max())
    empty = lengths == 0
    assert torch.all(m[empty] == -1e30) and torch.all(l[empty] == 0) and torch.all(acc[empty] == 0)


def test_split_count_comes_from_the_table_width():
    """The kernel's grid: ``num_splits`` blocks of ``split_keys`` keys (whole
    pages) per (row, KV head), from the table's width and the page size
    alone, never from the lengths."""
    assert [tdecode.split_keys(4, bs) for bs in (1, 8, 16, 48, 256, 512)] == [256, 256, 256, 240, 256, 512]
    assert tdecode.num_splits(0, 16) == 1  # an empty table still takes one block per row
    assert tdecode.num_splits(1, 16) == 1
    assert tdecode.num_splits(16, 16) == 1  # 256 keys: one split
    assert tdecode.num_splits(17, 16) == 2
    assert tdecode.num_splits(260, 16) == 17  # chip_smoke's 8-row case: 4096 keys + 4 slots
    assert tdecode.num_splits(6, 48) == 2  # 288 keys over splits of 240
    # Past 64 splits of 256 keys the splits grow instead: 128K tokens at
    # BS = 16 take 64 splits of 2048 keys.
    assert tdecode.num_splits(1024, 16) == 64 and tdecode.split_keys(1024, 16) == 256
    assert tdecode.split_keys(8192, 16) == 2048 and tdecode.num_splits(8192, 16) == 64
    assert tdecode.num_splits(8193, 16) == 64 and tdecode.split_keys(8193, 16) == 2064


def test_empty_piece_drops_out_of_merge():
    """Merging an empty prefix piece with a one-token piece gives that token
    alone, as in the JAX package (``test_paged_decode_kernel.py``)."""
    B, BS, KVH, G, HD = 3, 16, 2, 2, 32
    rng = np.random.default_rng(2)
    kp = torch.from_numpy(rng.standard_normal((8, BS, KVH, HD)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((B, KVH * G, HD)).astype(np.float32))
    m1, l1, acc1 = tdecode.paged_decode_partials(
        q, kp, kp + 1, torch.zeros((B, 4), dtype=torch.int32), torch.zeros(B, dtype=torch.int32),
        num_kv_heads=KVH, block_size=BS,
    )
    k1 = rng.standard_normal((B, 1, KVH, HD)).astype(np.float32)
    v1 = k1 * 2
    qg = q.reshape(B, KVH, G, HD)
    m2, l2, acc2 = tllama._attend_piece(qg, torch.from_numpy(k1), torch.from_numpy(v1),
                                        torch.ones((B, 1), dtype=torch.bool), HD**-0.5)
    out = tllama._merge_pieces(m1, l1, acc1, m2, l2, acc2)
    want = np.broadcast_to(v1[:, 0, :, None, :], (B, KVH, G, HD))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
    # The same merge in the JAX package.
    jout = jllama._merge_pieces(*(jnp.asarray(t.numpy()) for t in (m1, l1, acc1, m2, l2, acc2)))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)


def test_attend_piece_matches_jax():
    """The in-register piece the decode rows merge with the paged partials."""
    rng = np.random.default_rng(5)
    B, S, KVH, G, HD = 3, 20, 2, 2, 16
    qg = rng.standard_normal((B, KVH, G, HD)).astype(np.float32)
    kp = rng.standard_normal((B, S, KVH, HD)).astype(np.float32)
    vp = rng.standard_normal((B, S, KVH, HD)).astype(np.float32)
    mask = np.arange(S)[None, :] < np.array([[0], [7], [20]])
    want = jllama._attend_piece(*(jnp.asarray(a) for a in (qg, kp, vp, mask)), HD**-0.5)
    got = tllama._attend_piece(*(torch.from_numpy(a) for a in (qg, kp, vp, mask)), HD**-0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_token_piece_is_a_one_key_attend_piece():
    """Each decode row's current token is a one-key piece; the closed form
    the port uses equals the JAX package's ``_attend_piece`` over it."""
    rng = np.random.default_rng(6)
    B, KVH, G, HD = 4, 2, 3, 16
    qg = rng.standard_normal((B, KVH, G, HD)).astype(np.float32)
    k = rng.standard_normal((B, KVH, HD)).astype(np.float32)
    v = rng.standard_normal((B, KVH, HD)).astype(np.float32)
    want = jllama._attend_piece(jnp.asarray(qg), jnp.asarray(k[:, None]), jnp.asarray(v[:, None]),
                                jnp.ones((B, 1), bool), HD**-0.5)
    got = tllama._token_piece(*(torch.from_numpy(a) for a in (qg, k, v)), HD**-0.5)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_wrapper_rules_off_the_card():
    q, kp, vp, tables, lengths = (torch.from_numpy(a) for a in _case(1, **CASES["bs8-mha"]))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tdecode.paged_decode_partials(*(t.to("meta") for t in (q, kp, vp, tables, lengths)),
                                      num_kv_heads=4, block_size=8)
