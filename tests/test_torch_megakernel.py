"""The port's ragged paged attention against the JAX megakernel.

The same seeded numpy inputs go through the JAX ``ragged_paged_attention``
(Pallas, interpreter mode) and the port's plain version
``ragged_paged_attention_ref``, in f32, over head layouts (GQA/MHA/MQA) and
the ragged edges the kernel must handle: a chunk row over a prefix ending
on a page boundary, chunk and decode rows in one step, dead queries, and a
short row in a wide table whose tail slots hold scratch page 0. The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine.attention import megakernel as jmk
from dynamo_tpu_torch.engine.attention import megakernel as tmk

BS = 16
ATOL, RTOL = 2e-5, 1e-5  # f32 on both sides; only the summation order differs


def _case(seed, *, H, KVH, HD, chunk, chunk_prefix, decode_ctx, dead=0, dead_lanes=0, tail_width=0, chunk2=None,
          fresh=None, over=0):
    """Inputs of one ragged step in ``mixed_step``'s layout: row 0 a chunk
    of ``chunk`` queries over a ``chunk_prefix``-token prefix (the last
    ``dead`` are padding; ``over`` tokens of prefix length past its table),
    ``chunk2 = (T, prefix)`` a second chunk row, then decode queries with
    ``decode_ctx`` tokens of context and ``fresh[d]`` fresh keys each
    (default 1; ``decode_multi``'s layout), then ``dead_lanes`` inactive
    decode lanes. Page 0 is scratch and holds large values, so reading it
    shows."""
    rng = np.random.default_rng(seed)
    B = len(decode_ctx) + dead_lanes
    fresh = [1] * B if fresh is None else list(fresh) + [1] * dead_lanes
    T2, prefix2 = chunk2 or (0, 0)
    c1 = 1 if chunk2 else 0
    prefix = [chunk_prefix] + [prefix2] * c1 + [c - 1 for c in decode_ctx] + [0] * dead_lanes
    n_pages = [(p + BS - 1) // BS for p in prefix]
    W = max(max(n_pages), 1) + tail_width
    NP = sum(n_pages) + 1
    ids = rng.permutation(np.arange(1, NP)).astype(np.int32)
    tables = np.zeros((len(prefix), W), np.int32)
    o = 0
    for r, n in enumerate(n_pages):
        tables[r, :n] = ids[o:o + n]
        o += n
    k_pages = rng.standard_normal((NP, BS, KVH, HD)).astype(np.float32)
    v_pages = rng.standard_normal((NP, BS, KVH, HD)).astype(np.float32)
    k_pages[0] = 50.0
    v_pages[0] = 50.0
    NQ = chunk + T2 + B
    CK = chunk + T2 + sum(fresh)
    q = rng.standard_normal((NQ, H, HD)).astype(np.float32)
    k_extra = rng.standard_normal((CK, KVH, HD)).astype(np.float32)
    v_extra = rng.standard_normal((CK, KVH, HD)).astype(np.float32)
    s_iq, s2_iq, d_iq = np.arange(chunk), np.arange(T2), np.arange(B)
    f_start = chunk + T2 + np.r_[0, np.cumsum(fresh)[:-1]][:B]
    live_d = np.r_[np.ones(len(decode_ctx)), np.zeros(dead_lanes)]
    meta = np.stack([
        np.r_[np.zeros(chunk), np.ones(T2), 1 + c1 + d_iq],
        np.r_[np.full(chunk, chunk_prefix + over), np.full(T2, prefix2), prefix[1 + c1:]],
        np.r_[np.zeros(chunk), np.full(T2, chunk), f_start],
        np.r_[s_iq + 1, chunk + s2_iq + 1, f_start + np.asarray(fresh)],
        np.r_[s_iq < chunk - dead, np.ones(T2), live_d],
    ]).astype(np.int32)
    return dict(q=q, k_extra=k_extra, v_extra=v_extra, k_pages=k_pages, v_pages=v_pages,
                tables=tables, meta=meta, KVH=KVH)


def _jax(c):
    out = jmk.ragged_paged_attention(
        *(jnp.asarray(c[k]) for k in ("q", "k_extra", "v_extra", "k_pages", "v_pages", "tables", "meta")),
        num_kv_heads=c["KVH"], block_size=BS, interpret=True,
    )
    return np.asarray(out)


def _torch_args(c, device="cpu", dtype=torch.float32):
    return tuple(
        torch.from_numpy(c[k]).to(device=device, dtype=dtype if c[k].dtype == np.float32 else torch.int32)
        for k in ("q", "k_extra", "v_extra", "k_pages", "v_pages", "tables", "meta")
    )


CASES = {
    "gqa": dict(H=4, KVH=2, HD=16, chunk=8, chunk_prefix=20, decode_ctx=[1, 9, 40]),
    "mha": dict(H=4, KVH=4, HD=16, chunk=8, chunk_prefix=20, decode_ctx=[1, 9, 40]),
    "mqa": dict(H=4, KVH=1, HD=16, chunk=8, chunk_prefix=20, decode_ctx=[1, 9, 40]),
    # A chunk row whose cached prefix ends exactly on a page boundary.
    "chunk_on_page_boundary": dict(H=4, KVH=2, HD=16, chunk=19, chunk_prefix=32, decode_ctx=[]),
    # Chunk and decode rows in one launch, with padded chunk queries, decode
    # contexts at page edges and an inactive decode lane.
    "mixed_chunk_and_decode": dict(H=4, KVH=2, HD=16, chunk=16, chunk_prefix=21,
                                   decode_ctx=[31, 17, 16, 8], dead=7, dead_lanes=1),
    # A short row in a wide table: tail slots hold page 0 and must not be read.
    "short_row_wide_table": dict(H=4, KVH=2, HD=16, chunk=4, chunk_prefix=5, decode_ctx=[3, 2],
                                 tail_width=6),
    # Two chunk rows in one step, the second's fresh keys after the first's.
    "two_chunk_rows": dict(H=4, KVH=2, HD=16, chunk=10, chunk_prefix=20, chunk2=(7, 37), decode_ctx=[5, 18]),
    # decode_multi: one query a row, each with its own run of 1-33 fresh keys.
    "decode_multi": dict(H=4, KVH=2, HD=16, chunk=0, chunk_prefix=0, decode_ctx=[30, 1, 17, 64],
                         fresh=[1, 33, 5, 17]),
    # A prefix length past the table: capped at W·BS.
    "prefix_past_table": dict(H=4, KVH=2, HD=16, chunk=6, chunk_prefix=32, over=20, decode_ctx=[9]),
    # A live query that sees no key (no prefix, an empty fresh range): zeros.
    "query_without_keys": dict(H=4, KVH=2, HD=16, chunk=5, chunk_prefix=3, decode_ctx=[1, 20, 1],
                               fresh=[1, 1, 0]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_ref_matches_jax_megakernel(name):
    c = _case(sum(map(ord, name)), **CASES[name])
    want = _jax(c)
    got = tmk.ragged_paged_attention_ref(*_torch_args(c), num_kv_heads=c["KVH"], block_size=BS)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    live = c["meta"][4] != 0
    assert np.all(got.numpy()[~live] == 0.0)


def test_query_without_keys_returns_exact_zeros():
    """A live query with no prefix and an empty fresh range returns exact
    zeros in both packages (l = 0)."""
    c = _case(5, **CASES["query_without_keys"])
    got = tmk.ragged_paged_attention_ref(*_torch_args(c), num_kv_heads=c["KVH"], block_size=BS).numpy()
    assert np.all(got[-1] == 0.0) and np.all(_jax(c)[-1] == 0.0)


def test_launch_plan_sizes_the_grid_from_shapes():
    """The bf16 kernel's grid: 128/G queries a chunk tile, splits from the
    table width (256 keys each, at most 64), split blocks capped by the
    SMs and by the work items R·KVH·splits."""
    # chip_smoke's mixed step: 512 + 32 queries, 33 rows, tables 4096 keys wide.
    assert tmk.launch_plan(544, 32, 8, 33, 256, BS, 132) == dict(
        queries_per_tile=32, tiles=17, splits=16, split_keys=256, split_blocks=132, blocks=17 * 8 + 132)
    # A decode step of 8 rows at 1024 tokens, and one of 2 rows on tiny.
    assert tmk.launch_plan(8, 32, 8, 8, 64, BS, 132)["split_blocks"] == 132
    assert tmk.launch_plan(2, 4, 2, 2, 2, BS, 132) == dict(
        queries_per_tile=64, tiles=1, splits=1, split_keys=256, split_blocks=4, blocks=2 + 4)
    # G = 64 takes two queries a tile, G = 3 42 (126 rows).
    assert tmk.launch_plan(100, 64, 1, 1, 8, BS, 132)["queries_per_tile"] == 2
    assert tmk.launch_plan(100, 3, 1, 1, 8, BS, 132)["queries_per_tile"] == 42
    # A table past 64 splits of 256 keys takes longer splits.
    plan = tmk.launch_plan(1, 32, 8, 1, 2048, BS, 132)
    assert (plan["splits"], plan["split_keys"]) == (64, 512)


@pytest.mark.parametrize("name, chunk_q", [
    # 16 chunk queries, the last 7 dead: query 8 is alone in its tile (split), as are the decode rows.
    ("mixed_chunk_and_decode", 8),
    ("chunk_on_page_boundary", 19),
    # Tile 1 = queries 8-15: row 0's last 2 (chunk), row 1's first 6 (split); tile 2 = row 1's last
    # query and the decode rows (split).
    ("two_chunk_rows", 10),
    ("decode_multi", 0),
    ("query_without_keys", 5),
], ids=lambda x: str(x))
def test_chunk_queries_partition_the_port_layouts(name, chunk_q):
    """The plain mirror of the device's rule, at 8 queries a tile (G = 16):
    a tile's chunk queries share the row and prefix of its first live query,
    two at least; the other live queries take the split path."""
    c = _case(1, **CASES[name])
    meta = torch.from_numpy(c["meta"])
    got = tmk.chunk_queries(meta, width=c["tables"].shape[1], block_size=BS, queries_per_tile=8)
    live = meta[4] != 0
    assert int(got.sum()) == chunk_q
    assert not bool((got & ~live).any())
    if name == "two_chunk_rows":
        assert got[:10].all() and not got[10:].any()


def test_dead_queries_return_exact_zeros():
    """Dead queries (meta active 0) return exact zeros in both packages,
    including one with neither prefix nor fresh keys."""
    rng = np.random.default_rng(4)
    kvh, hd, H = 2, 16, 4
    c = dict(
        q=rng.standard_normal((3, H, hd)).astype(np.float32),
        k_extra=rng.standard_normal((3, kvh, hd)).astype(np.float32),
        k_pages=rng.standard_normal((6, BS, kvh, hd)).astype(np.float32),
        v_pages=rng.standard_normal((6, BS, kvh, hd)).astype(np.float32),
        tables=np.array([[1, 2], [3, 4], [0, 0]], np.int32),
        meta=np.array([[0, 1, 2], [20, 20, 0], [0, 1, 2], [1, 2, 2], [1, 1, 0]], np.int32),
        KVH=kvh,
    )
    c["v_extra"] = c["k_extra"]
    want = _jax(c)
    before = tmk.REF_CALLS
    got = tmk.ragged_paged_attention(*_torch_args(c), num_kv_heads=kvh, block_size=BS).numpy()
    assert tmk.REF_CALLS == before + 1, "a CPU tensor goes through the plain version"
    assert np.all(got[2] == 0.0) and np.all(want[2] == 0.0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_build_meta_matches_jax():
    rng = np.random.default_rng(9)
    cols = [rng.integers(0, 50, size=7).astype(np.int32) for _ in range(4)] + [rng.integers(0, 2, size=7) > 0]
    want = np.asarray(jmk.build_meta(*(jnp.asarray(x) for x in cols)))
    got = tmk.build_meta(*(torch.from_numpy(np.asarray(x)) for x in cols))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "mutate, error",
    [
        (lambda a: (a[0].double(),) + a[1:], TypeError),  # f64 queries
        (lambda a: a[:5] + (a[5].long(),) + a[6:], TypeError),  # i64 tables
        (lambda a: (a[0].transpose(0, 1).contiguous().transpose(0, 1),) + a[1:], ValueError),  # strided q
        (lambda a: a[:1] + (a[1][:, :1].contiguous(),) + a[2:], ValueError),  # k_extra with the wrong KV heads
        (lambda a: a[:6] + (a[6][:, :-1].contiguous(),), ValueError),  # meta narrower than NQ
    ],
    ids=["dtype", "table_dtype", "contiguity", "kv_heads", "meta_shape"],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(mutate, error):
    """The checks the wrapper runs before launching on a CUDA tensor."""
    c = _case(1, **CASES["gqa"])
    args = mutate(_torch_args(c))
    with pytest.raises(error):
        tmk._check_args(*args, c["KVH"], BS)
