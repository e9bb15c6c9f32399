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


def _case(seed, *, H, KVH, HD, chunk, chunk_prefix, decode_ctx, dead=0, dead_lanes=0, tail_width=0):
    """Inputs of one ragged step in ``mixed_step``'s layout: row 0 a chunk
    of ``chunk`` queries over a ``chunk_prefix``-token prefix (the last
    ``dead`` are padding), rows 1.. decode queries with ``decode_ctx``
    tokens of context, then ``dead_lanes`` inactive decode lanes. Page 0
    is scratch and holds large values, so reading it shows."""
    rng = np.random.default_rng(seed)
    B = len(decode_ctx) + dead_lanes
    prefix = [chunk_prefix] + [c - 1 for c in decode_ctx] + [0] * dead_lanes
    n_pages = [(p + BS - 1) // BS for p in prefix]
    W = max(max(n_pages), 1) + tail_width
    NP = sum(n_pages) + 1
    ids = rng.permutation(np.arange(1, NP)).astype(np.int32)
    tables = np.zeros((1 + B, W), np.int32)
    o = 0
    for r, n in enumerate(n_pages):
        tables[r, :n] = ids[o:o + n]
        o += n
    k_pages = rng.standard_normal((NP, BS, KVH, HD)).astype(np.float32)
    v_pages = rng.standard_normal((NP, BS, KVH, HD)).astype(np.float32)
    k_pages[0] = 50.0
    v_pages[0] = 50.0
    NQ = chunk + B
    q = rng.standard_normal((NQ, H, HD)).astype(np.float32)
    k_extra = rng.standard_normal((NQ, KVH, HD)).astype(np.float32)
    v_extra = rng.standard_normal((NQ, KVH, HD)).astype(np.float32)
    s_iq, d_iq = np.arange(chunk), np.arange(B)
    live_d = np.r_[np.ones(len(decode_ctx)), np.zeros(dead_lanes)]
    meta = np.stack([
        np.r_[np.zeros(chunk), 1 + d_iq],
        np.r_[np.full(chunk, chunk_prefix), prefix[1:]],
        np.r_[np.zeros(chunk), chunk + d_iq],
        np.r_[s_iq + 1, chunk + d_iq + 1],
        np.r_[s_iq < chunk - dead, live_d],
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
}


@pytest.mark.parametrize("name", list(CASES))
def test_ref_matches_jax_megakernel(name):
    c = _case(sum(map(ord, name)), **CASES[name])
    want = _jax(c)
    got = tmk.ragged_paged_attention_ref(*_torch_args(c), num_kv_heads=c["KVH"], block_size=BS)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    live = c["meta"][4] != 0
    assert np.all(got.numpy()[~live] == 0.0)


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
