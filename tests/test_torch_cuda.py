"""The port on the card: the hand-written CUDA kernels against their plain
versions, and the model's kernel paths against the CPU paths.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
torch and the port only (no JAX), so it also runs on a machine without
JAX; there the repo's ``tests/conftest.py`` (which imports JAX) is left
out::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dynamo_tpu_torch import bench
from dynamo_tpu_torch.engine.attention import decode as pdk
from dynamo_tpu_torch.engine.attention import megakernel as mk
from dynamo_tpu_torch.engine.attention import prefill as fck
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays, QuantKv, dequantize_kv, quantize_kv_rows
from dynamo_tpu_torch.engine.models import llama
from dynamo_tpu_torch.engine.quant import quantize_params
from dynamo_tpu_torch.engine.weights import init_params

pytestmark = pytest.mark.cuda

BS = 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU or interpreter mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _step(seed, *, H, KVH, HD, chunk, prefix, decode_ctx, dead=0, tail=0, chunk2=None, fresh=None, over=0):
    """A ragged step in ``mixed_step``'s layout: a chunk row over a paged
    prefix, then decode rows; page 0 is scratch with large values.
    ``chunk2 = (T, prefix)`` adds a second chunk row after the first;
    ``fresh[d]`` gives decode row d that many fresh keys of its own
    (``decode_multi``'s layout; default 1, 0 = none); ``over`` tokens are
    added to the chunk's prefix length past its table (capped at W·BS)."""
    g = torch.Generator().manual_seed(seed)
    B = len(decode_ctx)
    fresh = [1] * B if fresh is None else fresh
    T2, prefix2 = chunk2 or (0, 0)
    prefixes = [prefix] + ([prefix2] if chunk2 else []) + [c - 1 for c in decode_ctx]
    n_pages = [(p + BS - 1) // BS for p in prefixes]
    W = max(max(n_pages), 1) + tail
    NP = sum(n_pages) + 1
    ids = (torch.randperm(NP - 1, generator=g) + 1).to(torch.int32)
    tables = torch.zeros((len(prefixes), W), dtype=torch.int32)
    o = 0
    for r, n in enumerate(n_pages):
        tables[r, :n] = ids[o:o + n]
        o += n
    pages = [torch.randn((NP, BS, KVH, HD), generator=g) for _ in range(2)]
    for p in pages:
        p[0] = 1e4
    NQ = chunk + T2 + B
    CK = chunk + T2 + sum(fresh)
    c1 = 1 if chunk2 else 0  # rows of chunks after the first
    s, s2 = torch.arange(chunk, dtype=torch.int32), torch.arange(T2, dtype=torch.int32)
    d = torch.arange(B, dtype=torch.int32)
    f_start = chunk + T2 + torch.tensor([0] + fresh[:-1], dtype=torch.int32).cumsum(0)[:B]
    meta = mk.build_meta(
        torch.cat([torch.zeros_like(s), torch.ones_like(s2), 1 + c1 + d]),
        torch.tensor([prefix + over] * chunk + [prefix2] * T2 + prefixes[1 + c1:], dtype=torch.int32),
        torch.cat([torch.zeros_like(s), torch.full_like(s2, chunk), f_start]),
        torch.cat([s + 1, chunk + s2 + 1, f_start + torch.tensor(fresh, dtype=torch.int32)]),
        torch.cat([s < chunk - dead, torch.ones(T2 + B, dtype=torch.bool)]),
    )
    q = torch.randn((NQ, H, HD), generator=g)
    ke, ve = torch.randn((CK, KVH, HD), generator=g), torch.randn((CK, KVH, HD), generator=g)
    return (q, ke, ve, pages[0], pages[1], tables, meta), KVH


STEPS = {
    "llama-3.2-1b": dict(H=32, KVH=8, HD=64, chunk=128, prefix=300, decode_ctx=[1, 16, 17, 33, 700]),
    "hd128": dict(H=32, KVH=8, HD=128, chunk=64, prefix=100, decode_ctx=[5, 64, 300]),
    "mqa": dict(H=8, KVH=1, HD=64, chunk=32, prefix=48, decode_ctx=[1, 2, 200]),
    "mha_edges": dict(H=4, KVH=4, HD=64, chunk=40, prefix=64, decode_ctx=[16, 17, 32], dead=9, tail=7),
    # The bf16 kernel's two paths and their edges (32 queries a chunk tile at
    # G = 4): a chunk's tail in one tile with decode rows; a fresh-only
    # prefill; two chunk rows, the second starting inside a tile; a
    # decode_multi step (1-33 fresh keys a row); a prefix length past the
    # table (capped at W·BS); a live query with no key; the widest grouping
    # and the narrow head dims.
    "tail_with_decode_rows": dict(H=32, KVH=8, HD=64, chunk=40, prefix=100, decode_ctx=[5, 300, 17]),
    "fresh_only_prefill": dict(H=32, KVH=8, HD=64, chunk=300, prefix=0, decode_ctx=[]),
    "two_chunk_rows": dict(H=32, KVH=8, HD=64, chunk=40, prefix=50, chunk2=(30, 70), decode_ctx=[20, 3]),
    "decode_multi": dict(H=32, KVH=8, HD=64, chunk=0, prefix=0, decode_ctx=[100, 1, 33, 700, 17],
                         fresh=[1, 33, 5, 17, 2]),
    "prefix_past_table": dict(H=32, KVH=8, HD=64, chunk=64, prefix=96, over=50, decode_ctx=[10]),
    "query_without_keys": dict(H=32, KVH=8, HD=64, chunk=16, prefix=20, decode_ctx=[1, 50, 1], fresh=[1, 1, 0]),
    "g64": dict(H=64, KVH=1, HD=64, chunk=20, prefix=40, decode_ctx=[3, 100]),
    "hd16": dict(H=8, KVH=2, HD=16, chunk=50, prefix=30, decode_ctx=[2, 40]),
    "hd32": dict(H=8, KVH=2, HD=32, chunk=33, prefix=17, decode_ctx=[9]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(STEPS))
def test_kernel_matches_plain_version(cuda, name, dtype):
    host, kvh = _step(sum(map(ord, name)), **STEPS[name])
    args = tuple(t.to(cuda, dtype=dtype if t.is_floating_point() else t.dtype) for t in host)
    before = mk.KERNEL_LAUNCHES
    out = mk.ragged_paged_attention(*args, num_kv_heads=kvh, block_size=BS)
    ref = mk.ragged_paged_attention_ref(*args, num_kv_heads=kvh, block_size=BS)
    torch.cuda.synchronize()
    assert mk.KERNEL_LAUNCHES == before + 1
    live = args[6][4] != 0
    assert torch.all(out[~live] == 0)
    # f32: the same math in another summation order. bf16: the plain version
    # rounds p to bf16 before the PV product (≤ 2^-9·max|v|, with
    # max|v| < 5 here) and each output rounds once more.
    tol = 5e-5 if dtype == torch.float32 else 2**-9 * 5.0 + 2**-8 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


def test_wrapper_refuses_unsupported_inputs(cuda):
    host, kvh = _step(1, **STEPS["mqa"])
    args = [t.to(cuda) for t in host]
    with pytest.raises(TypeError):
        mk.ragged_paged_attention(*(a.half() if a.is_floating_point() else a for a in args),
                                  num_kv_heads=kvh, block_size=BS)
    with pytest.raises(ValueError):
        mk.ragged_paged_attention(args[0], *args[1:3], args[3].cpu(), *args[4:], num_kv_heads=kvh, block_size=BS)


# chip_smoke's int8 cases: a 512-query chunk over a 1000-token prefix and 32
# decode rows at contexts 1..4096, 4 chunk queries dead, at llama-3.2-1b's
# and llama-3-8b's widths; and the ragged edges above.
_CTX_32 = [int(c) for c in np.linspace(1, 4096, 32).round()]
INT8_STEPS = {
    "chip_smoke 1b": dict(H=32, KVH=8, HD=64, chunk=512, prefix=1000, decode_ctx=_CTX_32, dead=4),
    "chip_smoke 8b": dict(H=32, KVH=8, HD=128, chunk=512, prefix=1000, decode_ctx=_CTX_32, dead=4),
    "mha_edges": STEPS["mha_edges"],
    "mqa": STEPS["mqa"],
    **{name: STEPS[name] for name in ("tail_with_decode_rows", "fresh_only_prefill", "two_chunk_rows", "decode_multi",
                                      "prefix_past_table", "query_without_keys", "g64", "hd16", "hd32")},
}


def _int8_step(name, dtype, dev):
    """``_step``'s inputs with the page pools quantized to int8 (a live
    page's first 5 tokens all zero: scale 1), q and the fresh keys in
    ``dtype``, all on ``dev``."""
    host, kvh = _step(sum(map(ord, name)) + 8, **INT8_STEPS[name])
    q, ke, ve, kp, vp, tables, meta = host
    for p in (kp, vp):
        p[int(tables[0, 0]), :5] = 0.0
    pools = [QuantKv(*(t.to(dev) for t in quantize_kv_rows(p))) for p in (kp, vp)]
    return (*(t.to(dev, dtype) for t in (q, ke, ve)), *pools, tables.to(dev), meta.to(dev)), kvh


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", [n for n in INT8_STEPS if n != "mqa"])
def test_int8_kernel_matches_plain_version(cuda, name, dtype):
    """The int8 branch over QuantKv pages against the plain version, which
    dequantizes the same pages as the TPU kernel does; the tolerance of the
    bf16/f32 case above (the dequantized values are the same in both)."""
    args, kvh = _int8_step(name, dtype, cuda)
    before = (mk.KERNEL_LAUNCHES_INT8, mk.KERNEL_LAUNCHES)
    out = mk.ragged_paged_attention(*args, num_kv_heads=kvh, block_size=BS)
    ref = mk.ragged_paged_attention_ref(*args, num_kv_heads=kvh, block_size=BS)
    torch.cuda.synchronize()
    assert (mk.KERNEL_LAUNCHES_INT8, mk.KERNEL_LAUNCHES) == (before[0] + 1, before[1])
    live = args[6][4] != 0
    assert torch.all(out[~live] == 0)
    pool = dequantize_kv(args[4], torch.float32)[1:]  # page 0 is scratch; a fresh-only prefill has no other
    v_max = max(args[2].abs().max().item(), pool.abs().max().item() if pool.numel() else 0.0)
    tol = 5e-5 if dtype == torch.float32 else 2**-9 * v_max + 2**-8 * ref.float().abs().max().item()
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_ragged_kernel_is_bit_equal_on_repeat(cuda, int8):
    """Back-to-back bf16 calls on chip_smoke's mixed step (chunk tiles and
    rows split up to 16 ways) agree bit for bit: the split counters reset
    themselves and the merge order is fixed."""
    if int8:
        args, kvh = _int8_step("chip_smoke 1b", torch.bfloat16, cuda)
    else:
        host, kvh = _step(7, **INT8_STEPS["chip_smoke 1b"])
        args = tuple(t.to(cuda, torch.bfloat16 if t.is_floating_point() else t.dtype) for t in host)
    first = mk.ragged_paged_attention(*args, num_kv_heads=kvh, block_size=BS)
    for _ in range(2):
        again = mk.ragged_paged_attention(*args, num_kv_heads=kvh, block_size=BS)
        assert torch.equal(first, again)


def test_int8_wrapper_refuses_unsupported_inputs(cuda):
    args, kvh = _int8_step("mqa", torch.bfloat16, cuda)
    q, ke, ve, k8, v8, tables, meta = args
    call = lambda kp, vp: mk.ragged_paged_attention(q, ke, ve, kp, vp, tables, meta,  # noqa: E731
                                                    num_kv_heads=kvh, block_size=BS)
    with pytest.raises(TypeError, match="float32"):  # scales in another dtype
        call(QuantKv(k8.q, k8.scale.bfloat16()), v8)
    with pytest.raises(ValueError, match="scale"):  # scales that do not match the codes
        call(QuantKv(k8.q, k8.scale[..., 0].contiguous()), v8)
    with pytest.raises(TypeError, match="int8"):  # codes not int8
        call(QuantKv(k8.q.to(torch.int16), k8.scale), v8)
    with pytest.raises(ValueError, match="cpu"):  # scales on another device
        call(QuantKv(k8.q, k8.scale.cpu()), v8)
    with pytest.raises(TypeError, match="both"):  # one pool int8, the other not
        call(k8, dequantize_kv(v8, torch.bfloat16))
    launches = mk.KERNEL_LAUNCHES_INT8
    call(k8, v8)
    assert mk.KERNEL_LAUNCHES_INT8 == launches + 1


def test_int8_layer_flat_view_and_model_path(cuda):
    """The layer-flat pool the kernel reads is a view of the int8 cache the
    model writes (same storage), and ``tiny`` with int8 KV and weights gives
    the CPU path's logits and codes through prefill, decode and an 8-step
    ``decode_multi`` window, every attention call on the int8 branch."""
    cfg = get_config("tiny").replace(kv_cache_dtype="int8", weight_dtype="int8")
    cache = KvCacheArrays.create(cfg, 8, dtype=torch.float32, device=cuda)
    flat = cache.k.reshape(cfg.num_layers * 8, BS, cfg.num_kv_heads, cfg.head_dim)
    assert flat.q.data_ptr() == cache.k.q.data_ptr() and flat.scale.data_ptr() == cache.k.scale.data_ptr()
    params = quantize_params(init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32))
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 255, size=40).astype(np.int32)
    table = np.arange(1, 5, dtype=np.int32)
    greedy = (np.zeros(1, np.float32), np.zeros(1, np.int32), np.ones(1, np.float32))

    def run(dev):
        p = {k: ({kk: vv.to(dev) if isinstance(vv, torch.Tensor) else type(vv)(*(x.to(dev) for x in vv))
                  for kk, vv in v.items()} if isinstance(v, dict) else v.to(dev)) for k, v in params.items()}
        c = KvCacheArrays.create(cfg, 8, dtype=torch.float32, device=dev)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        padded = np.zeros(32, np.int32)
        padded[:30] = toks[:30]
        out = [llama.prefill(p, cfg, c.k, c.v, t(padded), 30, 0, t(table))[0][None]]
        out.append(llama.decode(p, cfg, c.k, c.v, t(toks[30:31]), t(np.array([30], np.int32)), t(table[None]),
                                t(np.array([True])))[0])
        win, _, _ = llama.decode_multi(p, cfg, c.k, c.v, t(toks[31:32]), t(np.array([31], np.int32)), t(table[None]),
                                       t(np.array([True])), *greedy, None, 8)
        return torch.cat(out).cpu(), win.cpu(), c.k.q.cpu(), c.k.scale.cpu()

    before = (mk.KERNEL_LAUNCHES_INT8, mk.KERNEL_LAUNCHES)
    on_card = run(cuda)
    assert (mk.KERNEL_LAUNCHES_INT8 - before[0], mk.KERNEL_LAUNCHES - before[1]) == (10 * cfg.num_layers, 0)
    on_cpu = run("cpu")
    torch.testing.assert_close(on_card[0], on_cpu[0], rtol=2e-4, atol=2e-4)
    assert torch.equal(on_card[1], on_cpu[1])
    # Block 0 is the scratch sink the prefill's padded rows write to
    # (several rows at one slot, in no fixed order); excluded.
    assert (on_card[2][:, 1:].int() - on_cpu[2][:, 1:].int()).abs().max() <= 1
    torch.testing.assert_close(on_card[3][:, 1:], on_cpu[3][:, 1:], rtol=2e-5, atol=0)


# Flash chunk cases: (T, valid_len, H, KVH, HD). T need not be a power of two.
FLASH = {
    "llama-3.2-1b": (512, 512, 32, 8, 64),
    "ragged-T": (300, 271, 32, 8, 64),
    "hd128": (200, 200, 32, 8, 128),
    "mqa": (130, 97, 8, 1, 64),
    "mha": (64, 64, 4, 4, 32),
    # The tensor-core tiles' edges: many diagonal tiles, one query row past a
    # 128-row tile, a single valid key, the widest grouping (two queries per
    # block), the narrowest head dim (32-byte swizzle).
    "T2048": (2048, 2048, 32, 8, 64),
    "T129": (129, 129, 32, 8, 64),
    "valid1": (70, 1, 32, 8, 64),
    "g64": (100, 90, 64, 1, 64),
    "hd16": (77, 77, 8, 2, 16),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(FLASH))
def test_flash_chunk_kernel_matches_plain_version(cuda, name, dtype):
    T, valid, H, KVH, HD = FLASH[name]
    g = torch.Generator().manual_seed(sum(map(ord, name)))
    q, k, v = (torch.randn(shape, generator=g).to(cuda, dtype)
               for shape in ((T, H, HD), (T, KVH, HD), (T, KVH, HD)))
    before = fck.KERNEL_LAUNCHES
    out, m, l = fck.flash_chunk_attention(q, k, v, valid, num_kv_heads=KVH)
    ro, rm, rl = fck.flash_chunk_attention_ref(q, k, v, valid, num_kv_heads=KVH)
    torch.cuda.synchronize()
    assert fck.KERNEL_LAUNCHES == before + 1
    # m and l come from f32 scores of the same inputs on both sides. In bf16
    # each side rounds p (against its own running max) before the PV
    # product, ≤ 2^-9·p each, and each output rounds once (2^-9·|o|).
    tol = 5e-5 if dtype == torch.float32 else 2**-8 * v.float().abs().max().item() + 2**-8 * ro.float().abs().max().item()
    assert (out.float() - ro.float()).abs().max().item() <= tol
    assert (m - rm).abs().max().item() <= 5e-5
    assert ((l - rl).abs() / rl).max().item() <= 5e-5


def _paged_args(dev, dtype, lengths, H, KVH, HD, extra, over=0):
    """Rows of ``lengths`` tokens over pages drawn at random from a pool
    whose page 0 is scratch (1e4); tables ``extra`` slots wider than the
    longest row; each length passed ``over`` tokens past its table.
    Returns the arguments on ``dev`` and the f32 value pages."""
    g = torch.Generator().manual_seed(len(lengths) + HD)
    B = len(lengths)
    n_pages = [(n + BS - 1) // BS for n in lengths]
    W = max(n_pages) + extra
    NP = sum(n_pages) + 1
    ids = (torch.randperm(NP - 1, generator=g) + 1).to(torch.int32)
    tables = torch.zeros((B, W), dtype=torch.int32)
    o = 0
    for b, n in enumerate(n_pages):
        tables[b, :n] = ids[o:o + n]
        o += n
    kp, vp = (torch.randn((NP, BS, KVH, HD), generator=g) for _ in range(2))
    kp[0] = vp[0] = 1e4  # scratch page: a stray read shows
    q = torch.randn((B, H, HD), generator=g)
    return [t.to(dev, dtype) for t in (q, kp, vp)] + [
        tables.to(dev), torch.tensor([n + over for n in lengths], dtype=torch.int32).to(dev)], vp


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("lengths,H,KVH,HD,extra,over", [
    ([0, 1, 16, 17, 700, 33], 32, 8, 64, 3, 0),
    ([5, 64, 300], 32, 8, 128, 0, 0),
    ([200, 0, 2], 8, 1, 64, 6, 0),
    # Split-KV edges (256 keys a split at BS = 16): a row over 16 splits,
    # lengths at a split's edge, lengths past the table (clamped to W*BS),
    # a batch of empty rows only.
    ([4096, 5], 32, 8, 64, 0, 0),
    ([255, 256, 257, 511, 512, 513], 32, 8, 64, 1, 0),
    ([300, 290], 32, 8, 64, 0, 40),
    ([0, 0, 0], 32, 8, 64, 2, 0),
], ids=["llama-3.2-1b", "hd128", "mqa", "4096", "split-edges", "past-table", "all-empty"])
def test_paged_decode_kernel_matches_plain_version(cuda, lengths, H, KVH, HD, extra, over, dtype):
    args, vp = _paged_args(cuda, dtype, lengths, H, KVH, HD, extra, over)
    before = pdk.KERNEL_LAUNCHES
    m, l, acc = pdk.paged_decode_partials(*args, num_kv_heads=KVH, block_size=BS)
    rm, rl, racc = pdk.paged_decode_partials_ref(*args, num_kv_heads=KVH, block_size=BS)
    torch.cuda.synchronize()
    assert pdk.KERNEL_LAUNCHES == before + 1
    empty = args[4] == 0
    assert torch.all(m[empty] == -1e30) and torch.all(l[empty] == 0) and torch.all(acc[empty] == 0)
    assert (m - rm).abs().max().item() <= 5e-5
    assert ((l - rl).abs() / rl.clamp_min(1)).max().item() <= 5e-5
    # acc is unnormalized: a row's error scales with its l.
    # (A batch of empty rows only has no page past the scratch page.)
    base = 5e-5 if dtype == torch.float32 else 2**-8 * vp[1:].abs().max().item() if len(vp) > 1 else 0.0
    assert ((acc - racc).abs() / rl.clamp_min(1)[..., None]).max().item() <= base


def test_paged_decode_kernel_is_bit_equal_on_repeat(cuda):
    """Back-to-back calls on the same inputs agree bit for bit: the split
    counters reset themselves and the merge order is fixed."""
    args, _ = _paged_args(cuda, torch.bfloat16, [4096, 1000, 0, 300, 257], 32, 8, 64, 2)
    first = pdk.paged_decode_partials(*args, num_kv_heads=8, block_size=BS)
    for _ in range(2):
        again = pdk.paged_decode_partials(*args, num_kv_heads=8, block_size=BS)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_nop_and_dispatch_probe(cuda):
    x = torch.randn((8, 128), device=cuda)
    before = bench.KERNEL_LAUNCHES
    assert torch.equal(bench.nop(x), x)
    assert bench.KERNEL_LAUNCHES == before + 1
    ms = bench.dispatch_overhead_ms(n=8)
    assert 0 < ms < 100
    assert bench.KERNEL_LAUNCHES == before + 1 + 4 * 8


@pytest.mark.parametrize("attn,pre", [("megakernel", "auto"), ("paged", "flash")], ids=["megakernel", "paged+flash"])
def test_model_kernel_path_matches_cpu_path(cuda, attn, pre):
    """``tiny`` in f32: a prefill, a continuation chunk and two decode steps
    on the card (kernels) and on the CPU (plain versions) give the same
    logits."""
    cfg = get_config("tiny").replace(attention_impl=attn, prefill_impl=pre)
    flash = dict(use_flash=True) if pre == "flash" else {}
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 255, size=40).astype(np.int32)
    table = np.arange(1, 5, dtype=np.int32)

    def run(dev):
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dev))
             for k, v in params.items()}
        c = KvCacheArrays.create(cfg, 8, dtype=torch.float32, device=dev)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        padded = np.zeros(64, np.int32)
        padded[:30] = toks[:30]
        out = [llama.prefill(p, cfg, c.k, c.v, t(padded), 30, 0, t(table), has_prefix=False, **flash)[0][None]]
        padded[:6] = toks[30:36]
        out.append(llama.prefill(p, cfg, c.k, c.v, t(padded[:32]), 6, 30, t(table), **flash)[0][None])
        for i in range(2):
            out.append(llama.decode(p, cfg, c.k, c.v, t(toks[36 + i:37 + i]), t(np.array([36 + i], np.int32)),
                                    t(table[None]), t(np.array([True])))[0])
        return torch.cat(out).cpu()

    before = (mk.KERNEL_LAUNCHES, fck.KERNEL_LAUNCHES, pdk.KERNEL_LAUNCHES)
    on_card = run(cuda)
    launches = (mk.KERNEL_LAUNCHES - before[0], fck.KERNEL_LAUNCHES - before[1], pdk.KERNEL_LAUNCHES - before[2])
    L = cfg.num_layers
    assert launches == ((4 * L, 0, 0) if attn == "megakernel" else (0, 2 * L, 2 * L))
    torch.testing.assert_close(on_card, run("cpu"), rtol=2e-4, atol=2e-4)


# Fused window cases: (num_heads, num_kv_heads, head_dim, tied head, live
# rows' write positions). Each adds one dead row; a position near a block's
# end crosses into the next block inside the window.
WINDOW = {
    "tiny": (4, 2, 16, False, [0, 14, 37]),
    "mqa-tied": (4, 1, 32, True, [3, 15, 60]),
    "hd128": (8, 2, 128, False, [1, 31, 90]),
    "g1-tied": (4, 4, 64, True, [0, 17, 100]),
}
WINDOW_STEPS = 6


def _window(name, dtype, dev):
    """(config, params, k, v, tokens, positions, tables, active) of one
    window on ``dev``: seeded weights and caches (block 0 scratch, filled
    with large values) and pages drawn at random that cover the window."""
    H, KVH, HD, tied, positions = WINDOW[name]
    cfg = get_config("tiny").replace(num_heads=H, num_kv_heads=KVH, head_dim=HD, tie_word_embeddings=tied)
    g = torch.Generator().manual_seed(sum(map(ord, name)))
    params = init_params(cfg, g, device="cpu", dtype=torch.float32)
    need = [(p + WINDOW_STEPS - 1) // BS + 1 for p in positions]
    NB = sum(need) + 1
    ids = (torch.randperm(NB - 1, generator=g) + 1).to(torch.int32)
    tables = torch.zeros((len(positions) + 1, max(need) + 1), dtype=torch.int32)
    o = 0
    for b, n in enumerate(need):
        tables[b, :n] = ids[o:o + n]
        o += n
    k, v = (torch.randn((cfg.num_layers, NB, BS, KVH, HD), generator=g) for _ in range(2))
    k[:, 0] = v[:, 0] = 1e4
    tokens = torch.randint(1, cfg.vocab_size, (len(positions) + 1,), generator=g, dtype=torch.int32)
    ints = [tokens, torch.tensor(positions + [0], dtype=torch.int32), tables,
            torch.tensor([True] * len(positions) + [False])]
    params = {n: ({kk: vv.to(dev, dtype) for kk, vv in w.items()} if isinstance(w, dict) else w.to(dev, dtype))
              for n, w in params.items()}
    return cfg, params, k.to(dev, dtype), v.to(dev, dtype), *(t.to(dev) for t in ints)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(WINDOW))
def test_fused_window_kernel_matches_plain_version(cuda, name, dtype):
    cfg, p, k, v, tokens, positions, tables, active = _window(name, dtype, cuda)
    lp = p["layers"]
    weights = [p["embed"], p.get("lm_head"), p["final_norm"]] + [
        lp[n] for n in ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]
    kw = dict(num_steps=WINDOW_STEPS, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.head_dim, block_size=BS, rms_eps=cfg.rms_norm_eps, theta=cfg.rope_theta)
    kk, vk, kr, vr = k.clone(), v.clone(), k.clone(), v.clone()
    before = mk.WINDOW_KERNEL_LAUNCHES
    toks = mk.fused_decode_window(*weights, kk, vk, tokens, positions, tables, active, **kw)
    ref = mk.fused_decode_window_ref(*weights, kr, vr, tokens, positions, tables, active, **kw)
    torch.cuda.synchronize()
    assert mk.WINDOW_KERNEL_LAUNCHES == before + 1
    live = active.cpu()
    # The slots the window writes: every step's in f32; step 0's in bf16,
    # where later steps' rows follow tokens that may differ.
    steps = WINDOW_STEPS if dtype == torch.float32 else 1
    written = torch.zeros(k.shape[1:3], dtype=torch.bool)
    for b, pos in enumerate(positions.cpu().tolist()):
        if live[b]:
            for j in range(WINDOW_STEPS):
                written[int(tables[b, (pos + j) // BS]), (pos + j) % BS] = True
    first = torch.zeros_like(written)
    for b, pos in enumerate(positions.cpu().tolist()):
        if live[b]:
            first[int(tables[b, pos // BS]), pos % BS] = True
    sel = (written if steps > 1 else first).to(cuda)
    keep = ~written.to(cuda)
    keep[0] = False  # scratch: dead rows write there
    assert torch.equal(kk[:, keep], k[:, keep]) and torch.equal(vk[:, keep], v[:, keep])
    # f32: the same math in another summation order. bf16: each side rounds
    # every product to bf16 in its own order, and the kernel keeps p in f32.
    scale = max(kr[:, sel].float().abs().max().item(), vr[:, sel].float().abs().max().item())
    tol = 1e-3 if dtype == torch.float32 else 2**-5 * scale
    for got, want in ((kk, kr), (vk, vr)):
        assert (got[:, sel].float() - want[:, sel].float()).abs().max().item() <= tol
    assert torch.equal(toks[:steps, live].cpu(), ref[:steps, live].cpu())
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())


def test_fused_window_model_path_matches_decode_multi(cuda):
    """``tiny`` in f32 on the card: the fused window (one launch) and the
    non-fused ``decode_multi`` (one ragged launch per layer and step) give
    the same tokens and cache contents."""
    cfg, p, k, v, *ints = _window("tiny", torch.float32, cuda)
    greedy = (np.zeros(4, np.float32), np.zeros(4, np.int32), np.ones(4, np.float32))
    before = (mk.WINDOW_KERNEL_LAUNCHES, mk.KERNEL_LAUNCHES, mk.WINDOW_REF_CALLS, mk.REF_CALLS)
    fused, fk, fv = llama.decode_multi_fused(p, cfg, k.clone(), v.clone(), *ints, num_steps=WINDOW_STEPS)
    multi, dk, dv = llama.decode_multi(p, cfg, k.clone(), v.clone(), *ints, *greedy, None, WINDOW_STEPS)
    torch.cuda.synchronize()
    after = (mk.WINDOW_KERNEL_LAUNCHES, mk.KERNEL_LAUNCHES, mk.WINDOW_REF_CALLS, mk.REF_CALLS)
    assert [a - b for a, b in zip(after, before)] == [1, WINDOW_STEPS * cfg.num_layers, 0, 0]
    live = ints[3].cpu()
    assert torch.equal(fused[:, live].cpu(), multi[:, live].cpu())
    torch.testing.assert_close(fk[:, 1:], dk[:, 1:], rtol=0, atol=1e-4)
    torch.testing.assert_close(fv[:, 1:], dv[:, 1:], rtol=0, atol=1e-4)


def test_fused_window_gate_and_refusals(cuda):
    tiny = get_config("tiny")
    assert mk.fused_window_fits(tiny, batch=32, dtype=torch.bfloat16, kv_dtype=torch.bfloat16, device=cuda)
    blocks, sms = mk.fused_window_grid(torch.bfloat16, 32, 2, 16, cuda)
    assert blocks >= sms == torch.cuda.get_device_properties(cuda).multi_processor_count
    cfg, p, k, v, tokens, positions, tables, active = _window("tiny", torch.float32, cuda)
    with pytest.raises(ValueError, match="batch"):
        llama.decode_multi_fused(p, cfg, k, v, tokens[:3], positions[:3], tables[:3], active[:3], num_steps=2)
    with pytest.raises(TypeError):
        llama.decode_multi_fused(p, cfg, k.half(), v.half(), tokens, positions, tables, active, num_steps=2)


def test_fused_window_profile_stamps(cuda):
    cfg, p, k, v, *ints = _window("tiny", torch.float32, cuda)
    lp = p["layers"]
    prof = torch.zeros(mk.window_profile_len(WINDOW_STEPS, cfg.num_layers), dtype=torch.int64, device=cuda)
    mk.fused_decode_window(
        p["embed"], p.get("lm_head"), p["final_norm"],
        *(lp[n] for n in ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")),
        k, v, *ints, num_steps=WINDOW_STEPS, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, block_size=BS, rms_eps=cfg.rms_norm_eps, theta=cfg.rope_theta, profile=prof)
    t = prof.cpu()
    assert bool((t > 0).all()) and bool((t[1:] >= t[:-1]).all())
    with pytest.raises(ValueError, match="profile"):
        mk.fused_decode_window(
            p["embed"], p.get("lm_head"), p["final_norm"],
            *(lp[n] for n in ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")),
            k, v, *ints, num_steps=WINDOW_STEPS, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, block_size=BS, rms_eps=cfg.rms_norm_eps, theta=cfg.rope_theta,
            profile=prof[:-1])


# (temperature, top_k, top_p) rows of the sampled checks, in turn: greedy,
# k = 1, top-p off, k past the vocab, joint top-k/top-p, top-p alone, top-k
# alone, a narrow nucleus.
SAMPLE_MIX = [(0.0, 0, 1.0), (0.9, 1, 1.0), (0.8, 0, 1.0), (0.7, 1 << 20, 0.95), (1.3, 20, 0.9),
              (0.8, 0, 0.9), (1.0, 50, 1.0), (0.6, 0, 0.5)]


def _sample_rows(B, steps, dev, seed):
    """(temps, top_ks, top_ps, uniforms [steps, B]) on ``dev``, row b from
    ``SAMPLE_MIX[b % 8]``."""
    rows = [SAMPLE_MIX[b % len(SAMPLE_MIX)] for b in range(B)]
    u = np.random.default_rng(seed).random((steps, B), dtype=np.float32)
    temps = torch.tensor([r[0] for r in rows], device=dev)
    top_ks = torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev)
    top_ps = torch.tensor([r[2] for r in rows], device=dev)
    return temps, top_ks, top_ps, torch.from_numpy(u).to(dev)


def test_sample_epilogue_matches_plain_version(cuda):
    """The window's sampled epilogue alone (``megakernel.sample_epilogue``)
    against ``sampling.sample_from_uniforms`` on the same f32 logits [16,
    4096], rows in ``SAMPLE_MIX``'s turn, the top-k rows with six values
    tied at the k-th largest, 32 draws per row. Tokens are equal except
    where u lies within 1e-5 of an edge of the plain version's CDF (the
    two sum the probabilities in different orders, float32 rounding about
    1e-7 here)."""
    from dynamo_tpu_torch.engine.sampling import filtered_probs_rows, sample_from_uniforms

    B, V = 16, 4096
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((B, V)) * np.repeat([1.0, 4.0], 8)[:, None]).astype(np.float32)
    for b in range(B):
        k = SAMPLE_MIX[b % 8][1]
        if 1 < k < V:
            order = np.argsort(-logits[b], kind="stable")
            logits[b, order[k - 4:k + 2]] = logits[b, order[k - 1]]
    logits = torch.from_numpy(logits).to(cuda)
    temps, top_ks, top_ps, u = _sample_rows(B, 32, cuda, 6)
    before = mk.EPILOGUE_KERNEL_LAUNCHES
    for j in range(u.shape[0]):
        got = mk.sample_epilogue(logits, temps, top_ks, top_ps, u[j])
        want = sample_from_uniforms(logits, temps, top_ks, top_ps, u[j])
        torch.cuda.synchronize()
        assert bool(((got >= 0) & (got < V)).all())
        rows = torch.nonzero(got != want).flatten().tolist()
        if rows:
            cum = filtered_probs_rows(logits[rows], temps[rows], top_ks[rows], top_ps[rows]).double().cumsum(-1)
            for i, r in enumerate(rows):
                edge = cum[i, min(int(got[r]), int(want[r]))].item()
                assert abs(edge - u[j, r].item()) <= 1e-5, (j, r, int(got[r]), int(want[r]))
    assert mk.EPILOGUE_KERNEL_LAUNCHES == before + u.shape[0]


@pytest.mark.parametrize("name", list(WINDOW))
def test_sampled_fused_window_matches_plain_version(cuda, name):
    """The fused window with the sampled epilogue against its plain version
    in f32, rows in ``SAMPLE_MIX``'s turn and one dead row: tokens equal,
    written K/V within 1e-3 (another summation order), one launch counted
    as sampled."""
    cfg, p, k, v, tokens, positions, tables, active = _window(name, torch.float32, cuda)
    lp = p["layers"]
    weights = [p["embed"], p.get("lm_head"), p["final_norm"]] + [
        lp[n] for n in ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]
    kw = dict(num_steps=WINDOW_STEPS, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.head_dim, block_size=BS, rms_eps=cfg.rms_norm_eps, theta=cfg.rope_theta)
    samp = _sample_rows(len(tokens), WINDOW_STEPS, cuda, 7)
    kk, vk, kr, vr = k.clone(), v.clone(), k.clone(), v.clone()
    before = (mk.WINDOW_KERNEL_LAUNCHES, mk.WINDOW_SAMPLED_LAUNCHES)
    toks = mk.fused_decode_window(*weights, kk, vk, tokens, positions, tables, active, *samp, **kw)
    ref = mk.fused_decode_window_ref(*weights, kr, vr, tokens, positions, tables, active, *samp, **kw)
    torch.cuda.synchronize()
    assert (mk.WINDOW_KERNEL_LAUNCHES, mk.WINDOW_SAMPLED_LAUNCHES) == (before[0] + 1, before[1] + 1)
    live = active.cpu()
    assert torch.equal(toks[:, live].cpu(), ref[:, live].cpu())
    torch.testing.assert_close(kk[:, 1:], kr[:, 1:], rtol=0, atol=1e-3)
    torch.testing.assert_close(vk[:, 1:], vr[:, 1:], rtol=0, atol=1e-3)


# Guided rows of the guided window checks: a JSON schema, a choice, none
# (an unguided row at pool row 0) and a regex (the dead row).
GUIDED_SPECS = [{"kind": "regex", "pattern": r'\{"ok":(?:true|false),"n":[0-9]{1,3}\}'},
                {"kind": "choice", "choices": ["red", "green", "blue"]}, None,
                {"kind": "regex", "pattern": r"[a-c]{2}-\d+"}]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("name", list(WINDOW))
def test_guided_fused_window_matches_plain_version(cuda, name, sampled):
    """The fused window with the guided epilogue against its plain version
    in f32 over ``GuidedDecoder`` pools on the card (ByteTokenizer, V =
    256): tokens equal, every guided token allowed by the host FSM, the
    rows after the window equal and the host's replay, written K/V within
    1e-3, one launch counted as guided (and as sampled with uniforms)."""
    from dynamo_tpu_torch.llm.guided.processor import GuidedDecoder
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    cfg, p, k, v, tokens, positions, tables, active = _window(name, torch.float32, cuda)
    lp = p["layers"]
    weights = [p["embed"], p.get("lm_head"), p["final_norm"]] + [
        lp[n] for n in ("attn_norm", "mlp_norm", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")]
    kw = dict(num_steps=WINDOW_STEPS, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.head_dim, block_size=BS, rms_eps=cfg.rms_norm_eps, theta=cfg.rope_theta)
    dec = GuidedDecoder(ByteTokenizer(), eos_ids=[0], vocab_size=cfg.vocab_size, pool_rows=16, device=cuda)
    states = [None if s is None else dec.open(s) for s in GUIDED_SPECS]
    rows0 = torch.tensor([0 if st is None else st.row_id for st in states], dtype=torch.int32, device=cuda)
    guide = (rows0, dec.pool.device(), dec.pool.next_device())
    samp = _sample_rows(len(tokens), WINDOW_STEPS, cuda, 8) if sampled else (None,) * 4
    kk, vk, kr, vr = k.clone(), v.clone(), k.clone(), v.clone()
    rows_k, rows_r = (torch.empty(len(tokens), dtype=torch.int32, device=cuda) for _ in range(2))
    before = (mk.WINDOW_KERNEL_LAUNCHES, mk.WINDOW_SAMPLED_LAUNCHES, mk.WINDOW_GUIDED_LAUNCHES)
    toks = mk.fused_decode_window(*weights, kk, vk, tokens, positions, tables, active, *samp, *guide,
                                  rows_out=rows_k, **kw)
    ref = mk.fused_decode_window_ref(*weights, kr, vr, tokens, positions, tables, active, *samp, *guide,
                                     rows_out=rows_r, **kw)
    torch.cuda.synchronize()
    after = (mk.WINDOW_KERNEL_LAUNCHES, mk.WINDOW_SAMPLED_LAUNCHES, mk.WINDOW_GUIDED_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [1, int(sampled), 1]
    live = active.cpu()
    assert torch.equal(toks[:, live].cpu(), ref[:, live].cpu())
    assert torch.equal(rows_k[live].cpu(), rows_r[live].cpu())
    nxt = dec.pool.next_device().cpu()
    for b, st in enumerate(states):
        if st is None or not live[b]:
            continue
        row = int(rows0[b])
        for tok in toks[:, b].tolist():
            assert st.fsm.allows(st.state, tok), (b, tok)
            st.advance(tok)
            row = int(nxt[row, tok])
        assert int(rows_k[b]) == row
    torch.testing.assert_close(kk[:, 1:], kr[:, 1:], rtol=0, atol=1e-3)
    torch.testing.assert_close(vk[:, 1:], vr[:, 1:], rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="guided"):
        mk.fused_decode_window(*weights, kk, vk, tokens, positions, tables, active, *samp, rows0, None, guide[2],
                               **kw)


def test_sample_epilogue_on_masked_rows_matches_plain_version(cuda):
    """The sampled epilogue alone on rows masked to -inf (guided rows): 1,
    2, 3, 5, 17, 40 or 63 allowed tokens (fewer than top_k in some rows),
    clustered in one part of the row so whole 16-column tiles and 2048-wide
    scan tiles are -inf; greedy and sampled rows. Every token allowed, and
    equal to the plain version's except within 1e-5 of a CDF edge."""
    from dynamo_tpu_torch.engine.sampling import filtered_probs_rows, sample_from_uniforms

    B, V = 16, 4096
    rng = np.random.default_rng(9)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    allowed = [1, 2, 3, 5, 17, 40, 63, 1, 2, 5, 40, 63, 3, 17, 2, 1]
    masked = np.full_like(logits, -np.inf)
    sets = []
    for b, n in enumerate(allowed):
        lo = int(rng.integers(0, V - 512))
        ids = np.sort(rng.choice(np.arange(lo, lo + 512), size=n, replace=False))
        masked[b, ids] = logits[b, ids]
        sets.append(set(ids.tolist()))
    masked = torch.from_numpy(masked).to(cuda)
    temps, top_ks, top_ps, u = _sample_rows(B, 32, cuda, 10)
    for j in range(u.shape[0]):
        got = mk.sample_epilogue(masked, temps, top_ks, top_ps, u[j])
        want = sample_from_uniforms(masked, temps, top_ks, top_ps, u[j])
        torch.cuda.synchronize()
        assert all(int(t) in sets[b] for b, t in enumerate(got.cpu()))
        rows = torch.nonzero(got != want).flatten().tolist()
        if rows:
            cum = filtered_probs_rows(masked[rows], temps[rows], top_ks[rows], top_ps[rows]).double().cumsum(-1)
            for i, r in enumerate(rows):
                edge = cum[i, min(int(got[r]), int(want[r]))].item()
                assert abs(edge - u[j, r].item()) <= 1e-5, (j, r, int(got[r]), int(want[r]))


# The fused spec window: R rounds of γ = 2 over 4 rows at ragged positions,
# the last row dead.
SPEC_R, SPEC_G = 3, 2
SPEC_POS = [1, 15, 40]
NARROW = dict(hidden_size=32, num_layers=1, num_heads=2, num_kv_heads=1, head_dim=16, intermediate_size=64)


def _spec(kind, dev):
    """(target cfg, draft cfg, target weights, draft weights, caches, inputs)
    of one spec window on ``dev`` in f32: "perturbed" (the draft is the
    target plus 0.002 × seeded noise over a copy of the target's cache,
    greedy rows), "sampled" (the same draft, rows in ``SAMPLE_MIX``'s turn),
    "self sampled" (the draft is the target, rows in ``SAMPLE_MIX``'s
    turn: every proposal accepted, the bonus drawn) or "narrow" (a draft of
    other widths, greedy). Caches of random K/V,
    block 0 scratch filled with large values, pages drawn at random
    covering the window."""
    g = torch.Generator().manual_seed(sum(map(ord, kind)))
    tcfg = get_config("tiny")
    dcfg = tcfg.replace(**NARROW) if kind == "narrow" else tcfg
    tp = init_params(tcfg, g, device="cpu", dtype=torch.float32)
    if kind == "narrow":
        dp = init_params(dcfg, g, device="cpu", dtype=torch.float32)
    elif kind == "self sampled":
        dp = tp
    else:
        dp = {n: ({kk: vv + 0.002 * torch.randn(vv.shape, generator=g) for kk, vv in w.items()}
                  if isinstance(w, dict) else w + 0.002 * torch.randn(w.shape, generator=g)) for n, w in tp.items()}
    span = SPEC_R * (SPEC_G + 1)
    need = [(p + span) // BS + 1 for p in SPEC_POS]
    NB = sum(need) + 1
    ids = (torch.randperm(NB - 1, generator=g) + 1).to(torch.int32)
    B = len(SPEC_POS) + 1
    tables = torch.zeros((B, max(need) + 1), dtype=torch.int32)
    o = 0
    for b, n in enumerate(need):
        tables[b, :n] = ids[o:o + n]
        o += n
    caches = []
    for cfg in (tcfg, dcfg):
        for _ in range(2):
            c = torch.randn((cfg.num_layers, NB, BS, cfg.num_kv_heads, cfg.head_dim), generator=g)
            c[:, 0] = 1e4
            caches.append(c.to(dev))
    if kind != "narrow":  # the draft's history is the target's: it mostly agrees
        caches[2:] = [c.clone() for c in caches[:2]]
    samp = _sample_rows(B, 1, dev, 9)[:3] if kind.endswith("sampled") else (
        torch.zeros(B, device=dev), torch.zeros(B, dtype=torch.int32, device=dev), torch.ones(B, device=dev))
    u = torch.from_numpy(np.random.default_rng(3).random((SPEC_R, B, 2 * SPEC_G + 1), dtype=np.float32)).to(dev)
    ints = [torch.randint(1, tcfg.vocab_size, (B,), generator=g, dtype=torch.int32),
            torch.randint(1, tcfg.vocab_size, (B,), generator=g, dtype=torch.int32),
            torch.tensor(SPEC_POS + [0], dtype=torch.int32), tables, tables, torch.tensor([True] * (B - 1) + [False])]
    to = lambda p: {n: ({kk: vv.to(dev) for kk, vv in w.items()} if isinstance(w, dict) else w.to(dev))  # noqa: E731
                    for n, w in p.items()}
    return tcfg, dcfg, to(tp), to(dp), caches, [t.to(dev) for t in ints] + [*samp, u]


def _spec_kw(tcfg, dcfg):
    return dict(rounds=SPEC_R, gamma=SPEC_G, block_size=BS,
                t_num_heads=tcfg.num_heads, t_num_kv_heads=tcfg.num_kv_heads, t_head_dim=tcfg.head_dim,
                t_rms_eps=tcfg.rms_norm_eps, t_theta=tcfg.rope_theta, d_num_heads=dcfg.num_heads,
                d_num_kv_heads=dcfg.num_kv_heads, d_head_dim=dcfg.head_dim, d_rms_eps=dcfg.rms_norm_eps,
                d_theta=dcfg.rope_theta)


@pytest.mark.parametrize("kind", ["perturbed", "sampled", "self sampled", "narrow"])
def test_fused_spec_kernel_matches_plain_version(cuda, kind):
    """One launch of the spec kernel against its plain version from copies
    of the same caches: live rows' tokens and accept counts equal, both
    caches within 1e-3 everywhere but block 0 (the dead row's sink), and no
    plain call on CUDA tensors."""
    tcfg, dcfg, tp, dp, caches, inputs = _spec(kind, cuda)
    w = [*llama._window_weights(tp), *llama._window_weights(dp)]
    kern = [c.clone() for c in caches]
    before = (mk.SPEC_KERNEL_LAUNCHES, mk.SPEC_REF_CALLS)
    toks, acc = mk.fused_spec_window(*w, *kern, *inputs, **_spec_kw(tcfg, dcfg))
    assert (mk.SPEC_KERNEL_LAUNCHES, mk.SPEC_REF_CALLS) == (before[0] + 1, before[1])
    ref_toks, ref_acc = mk.fused_spec_window_ref(*w, *caches, *inputs, **_spec_kw(tcfg, dcfg))
    torch.cuda.synchronize()
    live = inputs[5].cpu()
    assert torch.equal(acc[:, live].cpu(), ref_acc[:, live].cpu())
    assert torch.equal(toks[:, live].cpu(), ref_toks[:, live].cpu())
    assert bool(((acc >= 0) & (acc <= SPEC_G)).all())
    for got, want in zip(kern, caches):
        torch.testing.assert_close(got[:, 1:], want[:, 1:], rtol=0, atol=1e-3)
    if kind == "perturbed":
        assert 0 < int(acc[:, live].sum()) < SPEC_G * SPEC_R * int(live.sum())  # accepts and rejections
    if kind == "self sampled":  # a sampled row accepted all γ: the kernel drew the bonus
        sampled = live & (inputs[6].cpu() > 0)
        assert bool((acc[:, sampled].cpu() == SPEC_G).any())


def test_fused_spec_profile_gate_and_refusals(cuda):
    tcfg, dcfg, tp, dp, caches, inputs = _spec("perturbed", cuda)
    w = [*llama._window_weights(tp), *llama._window_weights(dp)]
    kw = _spec_kw(tcfg, dcfg)
    prof = torch.zeros(mk.spec_profile_len(SPEC_R, SPEC_G), dtype=torch.int64, device=cuda)
    mk.fused_spec_window(*w, *[c.clone() for c in caches], *inputs, **kw, profile=prof)
    t = prof.cpu()
    assert bool((t > 0).all()) and bool((t[1:] >= t[:-1]).all())
    with pytest.raises(ValueError, match="profile"):
        mk.fused_spec_window(*w, *caches, *inputs, **kw, profile=prof[:-1])
    with pytest.raises(ValueError, match="batch"):
        mk.fused_spec_window(*w, *caches, *(x[:3] for x in inputs[:9]), inputs[9][:, :3], **kw)
    with pytest.raises(ValueError, match="gamma"):
        mk.fused_spec_window(*w, *caches, *inputs[:9], torch.zeros((SPEC_R, 4, 19), device=cuda),
                             **{**kw, "gamma": mk.SPEC_MAX_GAMMA + 1})
    with pytest.raises(ValueError, match="cuda or cpu"):
        mk.fused_spec_window(*w, *caches, inputs[0].to("meta"), *inputs[1:], **kw)
    # CPU tensors run the plain version.
    cpu = lambda x: x.cpu() if x is not None else None  # noqa: E731
    before = (mk.SPEC_KERNEL_LAUNCHES, mk.SPEC_REF_CALLS)
    mk.fused_spec_window(*map(cpu, w), *map(cpu, caches), *map(cpu, inputs), **kw)
    assert (mk.SPEC_KERNEL_LAUNCHES, mk.SPEC_REF_CALLS) == (before[0], before[1] + 1)
    one = get_config("llama-3.2-1b")
    assert mk.fused_spec_fits(get_config("llama-3.2-3b"), one, batch=32, gamma=4, dtype=torch.bfloat16,
                              kv_dtype=torch.bfloat16, device=cuda)
    blocks, sms = mk.fused_spec_grid(torch.bfloat16, 8, 3, 128, 4, 64, cuda)
    assert blocks >= sms == torch.cuda.get_device_properties(cuda).multi_processor_count


# The bf16 products on the tensor cores (``tc_product`` in
# csrc/fused_window_device.cuh): models whose widths reach the product's
# edges. "tiny": wk/wv 32 columns wide (half a 64-column tile); "narrow":
# D = 32 (a quarter of a 128-row box of depth), wk/wv 16 wide; "uneven":
# D = 768, F = 3200, where the plan on an H100's 264 lanes splits QKV and
# the head (V = 256: 4 tiles) 6 ways and cuts down's 25 boxes of depth into
# runs of 2 (a shorter last run).
TC_MODELS = {
    "tiny": {},
    "narrow": dict(NARROW, num_layers=2),
    "uneven": dict(hidden_size=768, intermediate_size=3200, num_layers=1),
}


def _tc_case(kind, B, dev, seed, *, steps=WINDOW_STEPS, dtype=torch.bfloat16):
    """(config, weights, k, v, ints) of a window of B rows (the last dead)
    at ragged positions over model ``kind`` of ``TC_MODELS``: seeded weights
    and caches, block 0 scratch with large values, pages at random."""
    cfg = get_config("tiny").replace(**TC_MODELS[kind])
    g = torch.Generator().manual_seed(seed)
    params = init_params(cfg, g, device="cpu", dtype=torch.float32)
    positions = [int(p) for p in torch.randint(0, 120, (B,), generator=g)]
    need = [(p + steps - 1) // BS + 1 for p in positions]
    NB = sum(need) + 1
    ids = (torch.randperm(NB - 1, generator=g) + 1).to(torch.int32)
    tables = torch.zeros((B, max(need) + 1), dtype=torch.int32)
    o = 0
    for b, n in enumerate(need):
        tables[b, :n] = ids[o:o + n]
        o += n
    k, v = (torch.randn((cfg.num_layers, NB, BS, cfg.num_kv_heads, cfg.head_dim), generator=g) for _ in range(2))
    k[:, 0] = v[:, 0] = 1e4
    tokens = torch.randint(1, cfg.vocab_size, (B,), generator=g, dtype=torch.int32)
    active = torch.tensor([True] * (B - 1) + [B == 1])
    ints = [tokens, torch.tensor(positions, dtype=torch.int32), tables, active]
    params = {n: ({kk: vv.to(dev, dtype) for kk, vv in w.items()} if isinstance(w, dict) else w.to(dev, dtype))
              for n, w in params.items()}
    return cfg, list(llama._window_weights(params)), k.to(dev, dtype), v.to(dev, dtype), [t.to(dev) for t in ints]


def _step0_held(cfg, weights, k, v, ints):
    """(live rows whose plain bf16 step-0 top-2 logit gap exceeds 4 × the
    row's bf16 logit noise, the plain argmax): the noise is the row's
    largest distance from the f32 forward of the same weights and cache.
    Where the gap exceeds it, rounding cannot flip the kernel's pick."""
    tokens, positions, tables, active = ints
    args = (tokens.long(), positions.long(), tables.long(), active.bool())
    fkw = dict(num_heads=cfg.num_heads, rms_eps=cfg.rms_norm_eps, theta=cfg.rope_theta)
    lg = mk._cache_forward(tuple(weights), k.clone(), v.clone(), *args, **fkw)
    w32 = tuple(w.float() if w is not None else None for w in weights)
    truth = mk._cache_forward(w32, k.float(), v.float(), *args, **fkw)
    noise = (lg - truth).abs().amax(dim=-1)
    top = lg.topk(2, dim=-1)
    return (top.values[:, 0] - top.values[:, 1] > 4 * noise) & active.bool(), top.indices[:, 0]


def _window_kw(cfg, steps=WINDOW_STEPS):
    return dict(num_steps=steps, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                block_size=BS, rms_eps=cfg.rms_norm_eps, theta=cfg.rope_theta)


@pytest.mark.parametrize("kind", list(TC_MODELS))
@pytest.mark.parametrize("B", [1, 8, 32])
def test_bf16_window_products_match_plain_version(cuda, B, kind):
    """The bf16 window on the tensor-core products at 1, 8 and 32 rows
    against its plain version from copies of one cache: step-0 K/V within
    2^-5 of their scale (each side rounds every product to bf16 in its own
    summation order), step-0 tokens equal wherever the plain top-2 gap
    exceeds the row's bf16 noise, every other slot (block 0 aside) as it
    was, one launch. "uneven"'s plan has a shorter last split."""
    cfg, w, k, v, ints = _tc_case(kind, B, cuda, 600 + B)
    kw = _window_kw(cfg)
    if kind == "uneven":
        blocks, sms = mk.fused_window_grid(torch.bfloat16, B, cfg.num_heads // cfg.num_kv_heads, cfg.head_dim, cuda)
        phases = mk.window_phases(cfg.hidden_size, cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim,
                                  cfg.intermediate_size, cfg.vocab_size)
        plan, _, _ = mk.window_plan(phases, B, mk.TC_LANES_PER_BLOCK * min(blocks, 2 * sms))
        assert any(s > 1 and -(-K // mk.TC_BOX_ROWS) % kbs for (K, _), (s, kbs) in zip(phases, plan))
    held, plain0 = _step0_held(cfg, w, k, v, ints)
    kk, vk, kr, vr = k.clone(), v.clone(), k.clone(), v.clone()
    before = mk.WINDOW_KERNEL_LAUNCHES
    toks = mk.fused_decode_window(*w, kk, vk, *ints, **kw)
    ref = mk.fused_decode_window_ref(*w, kr, vr, *ints, **kw)
    torch.cuda.synchronize()
    assert mk.WINDOW_KERNEL_LAUNCHES == before + 1
    tables, live = ints[2].cpu(), ints[3].cpu()
    first = torch.zeros(k.shape[1:3], dtype=torch.bool)
    written = torch.zeros_like(first)
    for b, pos in enumerate(ints[1].cpu().tolist()):
        if live[b]:
            first[int(tables[b, pos // BS]), pos % BS] = True
            for j in range(WINDOW_STEPS):
                written[int(tables[b, (pos + j) // BS]), (pos + j) % BS] = True
    first, keep = first.to(cuda), ~written.to(cuda)
    keep[0] = False
    assert torch.equal(kk[:, keep], k[:, keep]) and torch.equal(vk[:, keep], v[:, keep])
    scale = max(kr[:, first].float().abs().max().item(), vr[:, first].float().abs().max().item())
    for got, want in ((kk, kr), (vk, vr)):
        assert (got[:, first].float() - want[:, first].float()).abs().max().item() <= 2**-5 * scale
    assert torch.equal(toks[0][held].cpu(), ref[0][held].cpu())
    assert torch.equal(ref[0][held].cpu(), plain0[held].to(torch.int32).cpu())
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())


@pytest.mark.parametrize("epilogue", ["greedy", "sampled", "guided"])
def test_bf16_fused_window_is_bit_equal_on_repeat(cuda, epilogue):
    """Two calls of the bf16 window on the tensor-core products from copies
    of one cache ("uneven": split phases merged by their last split) give
    equal tokens, caches and, guided, FSM rows."""
    from dynamo_tpu_torch.llm.guided.processor import GuidedDecoder
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    cfg, w, k, v, ints = _tc_case("uneven", 4, cuda, 650)
    kw = _window_kw(cfg)
    extra, out = (), [{}, {}]
    if epilogue != "greedy":
        extra = _sample_rows(4, WINDOW_STEPS, cuda, 651)
    if epilogue == "guided":
        dec = GuidedDecoder(ByteTokenizer(), eos_ids=[0], vocab_size=cfg.vocab_size, pool_rows=16, device=cuda)
        states = [None if s is None else dec.open(s) for s in GUIDED_SPECS]
        rows0 = torch.tensor([0 if st is None else st.row_id for st in states], dtype=torch.int32, device=cuda)
        extra = (*extra, rows0, dec.pool.device(), dec.pool.next_device())
        out = [dict(rows_out=torch.empty(4, dtype=torch.int32, device=cuda)) for _ in range(2)]
    runs = []
    for i in range(2):
        kk, vk = k.clone(), v.clone()
        runs.append((mk.fused_decode_window(*w, kk, vk, *ints, *extra, **kw, **out[i]), kk, vk))
    torch.cuda.synchronize()
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    if epilogue == "guided":
        assert torch.equal(out[0]["rows_out"], out[1]["rows_out"])


def _tc_spec(B, gamma, draft, dev, seed, target="tiny"):
    """(target cfg, draft cfg, weights, caches, inputs) of a bf16 spec
    window over B rows (the last dead) at ragged positions: target
    ``TC_MODELS[target]``, draft the target itself ("self", copies of its
    cache) or "narrow" (``NARROW``'s widths, its own cache); greedy rows."""
    tcfg = get_config("tiny").replace(**TC_MODELS[target])
    dcfg = get_config("tiny").replace(**NARROW) if draft == "narrow" else tcfg
    g = torch.Generator().manual_seed(seed)
    tp = init_params(tcfg, g, device="cpu", dtype=torch.float32)
    dp = init_params(dcfg, g, device="cpu", dtype=torch.float32) if draft == "narrow" else tp
    positions = [int(p) for p in torch.randint(1, 100, (B,), generator=g)]
    span = SPEC_R * (gamma + 1)
    need = [(p + span) // BS + 1 for p in positions]
    NB = sum(need) + 1
    ids = (torch.randperm(NB - 1, generator=g) + 1).to(torch.int32)
    tables = torch.zeros((B, max(need) + 1), dtype=torch.int32)
    o = 0
    for b, n in enumerate(need):
        tables[b, :n] = ids[o:o + n]
        o += n
    caches = []
    for cfg in (tcfg, dcfg):
        for _ in range(2):
            c = torch.randn((cfg.num_layers, NB, BS, cfg.num_kv_heads, cfg.head_dim), generator=g)
            c[:, 0] = 1e4
            caches.append(c.to(dev, torch.bfloat16))
    if draft == "self":
        caches[2:] = [c.clone() for c in caches[:2]]
    u = torch.from_numpy(np.random.default_rng(seed).random((SPEC_R, B, 2 * gamma + 1), dtype=np.float32)).to(dev)
    inputs = [torch.randint(1, tcfg.vocab_size, (B,), generator=g, dtype=torch.int32).to(dev),
              torch.randint(1, tcfg.vocab_size, (B,), generator=g, dtype=torch.int32).to(dev),
              torch.tensor(positions, dtype=torch.int32, device=dev), tables.to(dev), tables.to(dev),
              torch.tensor([True] * (B - 1) + [False], device=dev), torch.zeros(B, device=dev),
              torch.zeros(B, dtype=torch.int32, device=dev), torch.ones(B, device=dev), u]
    to = lambda p: {n: ({kk: vv.to(dev, torch.bfloat16) for kk, vv in w.items()} if isinstance(w, dict)  # noqa: E731
                        else w.to(dev, torch.bfloat16)) for n, w in p.items()}
    w = [*llama._window_weights(to(tp)), *llama._window_weights(to(dp))]
    return tcfg, dcfg, w, caches, inputs


@pytest.mark.parametrize("B,gamma,draft,target", [(4, 2, "self", "tiny"), (4, 2, "narrow", "tiny"),
                                                  (16, 4, "self", "uneven"), (32, 8, "self", "uneven")],
                         ids=["12 rows", "12 rows narrow", "80 rows", "288 rows"])
def test_bf16_spec_window_verify_matches_plain_version(cuda, B, gamma, draft, target):
    """The bf16 spec window on the tensor-core products, its verify over B
    (γ + 1) rows: 12 (not a multiple of 8), 80 (past one 64-row tile: two
    passes) and 288 (five passes of 64 over each staged box), the last
    two over "uneven"'s split phases. Against
    the plain version from copies of the same caches: the draft's catch-up
    K/V and, for each live row whose round 0 agrees, its confirmed verify
    rows' target K/V within 2^-5 of their scale; tokens in range,
    accept counts in [0, γ], one launch; a repeat call bit-equal (block 0
    aside). Only
    round 0's confirmed slots (pos .. pos + k) are compared: later rounds
    rewrite the rejected ones, after the two sides' tokens may part."""
    tcfg, dcfg, w, caches, inputs = _tc_spec(B, gamma, draft, cuda, 700 + B + gamma, target)
    kw = {**_spec_kw(tcfg, dcfg), "gamma": gamma}
    runs = []
    before = mk.SPEC_KERNEL_LAUNCHES
    for _ in range(2):
        kern = [c.clone() for c in caches]
        runs.append((*mk.fused_spec_window(*w, *kern, *inputs, **kw), kern))
    plain = [c.clone() for c in caches]
    ref_toks, ref_acc = mk.fused_spec_window_ref(*w, *plain, *inputs, **kw)
    torch.cuda.synchronize()
    assert mk.SPEC_KERNEL_LAUNCHES == before + 2
    toks, acc, kern = runs[0]
    assert torch.equal(toks, runs[1][0]) and torch.equal(acc, runs[1][1])
    # Block 0 is the dead rows' sink: the dead row's γ + 1 verify rows race there.
    assert all(torch.equal(a[:, 1:], b[:, 1:]) for a, b in zip(kern, runs[1][2]))
    live = inputs[5].cpu()
    assert bool(((toks >= 0) & (toks < tcfg.vocab_size)).all()) and bool(((acc >= 0) & (acc <= gamma)).all())
    tables, positions = inputs[3].cpu(), inputs[2].cpu().tolist()
    catch = torch.zeros(caches[2].shape[1:3], dtype=torch.bool)
    verify = torch.zeros(caches[0].shape[1:3], dtype=torch.bool)
    same = 0
    for b, p in enumerate(positions):
        if not live[b]:
            continue
        catch[int(tables[b, (p - 1) // BS]), (p - 1) % BS] = True
        if torch.equal(toks[0, b].cpu(), ref_toks[0, b].cpu()) and int(acc[0, b]) == int(ref_acc[0, b]):
            same += 1
            for j in range(int(acc[0, b]) + 1):
                verify[int(tables[b, (p + j) // BS]), (p + j) % BS] = True
    assert same >= 1
    for sel, pair in ((catch, (2, 3)), (verify, (0, 1))):
        sel = sel.to(cuda)
        scale = max(plain[i][:, sel].float().abs().max().item() for i in pair)
        err = max((kern[i][:, sel].float() - plain[i][:, sel].float()).abs().max().item() for i in pair)
        assert err <= 2**-5 * scale, (err, scale)


# ---------------------------------------------------------------------------
# CUDA graphs of the scheduler's steps (engine/graphs.py)
# ---------------------------------------------------------------------------


def _graph_cases(cfg, params, cache, g, seed):
    """(kind → (eager call, graph call)) over one set of inputs: tables of
    width 8, four decode rows (one dead), sampled rows beside greedy ones;
    the draws also in their all-greedy form (no key: the greedy graphs)."""
    from dynamo_tpu_torch.engine import prng
    from dynamo_tpu_torch.engine.sampling import sample_batch_device

    rng = np.random.default_rng(seed)
    B, W, V = 4, 8, cfg.vocab_size
    ids = rng.permutation(np.arange(1, cache_blocks(cache))).astype(np.int32)
    tables, chunk_table = ids[:B * W].reshape(B, W).copy(), ids[B * W:(B + 1) * W].copy()
    tpa = np.stack([rng.integers(1, V, size=B), rng.integers(20, W * BS - 9, size=B), np.arange(B) < 3]).astype(np.int32)
    samp = (np.array([0.0, 0.9, 0.0, 1.1], np.float32), np.array([0, 5, 0, 0], np.int32),
            np.array([1.0, 1.0, 0.8, 1.0], np.float32))
    key, toks = prng.fold_in(prng.PRNGKey(seed), 3), rng.integers(1, V, size=32).astype(np.int32)
    logits = torch.randn((B, V), generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    d = t(tpa)
    dec = (d[0], d[1], t(tables), d[2].bool())
    k, v = cache.k, cache.v
    return {
        "prefill": (lambda: llama.prefill(params, cfg, k, v, t(toks), 21, 5, t(tables[0]))[0],
                    lambda: g.prefill("target", params, cfg, cache, toks, 21, 5, tables[0])[0]),
        "mixed": (lambda: llama.mixed_step(params, cfg, k, v, t(toks), 17, 3, t(chunk_table), *dec)[0],
                  lambda: torch.cat(g.mixed(params, cfg, cache, toks, 17, 3, chunk_table, tpa, tables))),
        "decode": (lambda: llama.decode(params, cfg, k, v, *dec)[0],
                   lambda: g.decode(params, cfg, cache, tpa, tables)),
        "decode_sample": (lambda: _rows(*llama.decode_sample(params, cfg, k, v, d, t(tables), *map(t, samp), key)[:2]),
                          lambda: _rows(*g.decode_sample(params, cfg, cache, tpa, tables, *samp, key))),
        "draw": (lambda: sample_batch_device(logits, *map(t, samp), key),
                 lambda: g.draw(logits, *samp, key)),
        "decode_multi": (lambda: llama.decode_multi(params, cfg, k, v, *dec, *samp, key, 8)[0],
                         lambda: g.decode_multi(params, cfg, cache, tpa, tables, *samp, prng.split_many(key, 8), 8)),
        "decode_sample greedy": (
            lambda: _rows(*llama.decode_sample(params, cfg, k, v, d, t(tables), None, None, None, None)[:2]),
            lambda: _rows(*g.decode_sample(params, cfg, cache, tpa, tables, *samp, None))),
        "draw greedy": (lambda: sample_batch_device(logits, None, None, None, None),
                        lambda: g.draw(logits, *samp, None)),
        "decode_multi greedy": (lambda: llama.decode_multi(params, cfg, k, v, *dec, *samp, None, 8)[0],
                                lambda: g.decode_multi(params, cfg, cache, tpa, tables, *samp, None, 8)),
    }


def _rows(sampled, next_tpa):
    """``decode_sample``'s two outputs as one ``[4, B]`` tensor."""
    return torch.cat([sampled[None], next_tpa])


def cache_blocks(cache) -> int:
    return (cache.k.q if isinstance(cache.k, QuantKv) else cache.k).shape[1]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_graph_replays_are_bit_equal_to_eager_calls(cuda, kv):
    """Each graphed kind on ``tiny`` in bf16 (and int8 KV and weights): the
    replay's outputs and every KV block but the scratch equal the eager
    call's on the same inputs, on the inputs it was captured with and on
    another set staged into the same static buffers; replays credit the
    ragged kernel's launches, the capture none."""
    from dynamo_tpu_torch.engine.graphs import StepGraphs

    cfg = get_config("tiny")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device=cuda, dtype=torch.bfloat16)
    if kv == "int8":
        cfg = cfg.replace(kv_cache_dtype="int8", weight_dtype="int8")
        params = quantize_params(params)
    cache = KvCacheArrays.create(cfg, 48, dtype=torch.bfloat16, device=cuda)
    parts = [x for c in (cache.k, cache.v) for x in ((c.q, c.scale) if isinstance(c, QuantKv) else (c,))]
    for c in (cache.k, cache.v):
        if isinstance(c, QuantKv):
            c.q.random_(-127, 128)
            c.scale.uniform_(0.005, 0.03)
        else:
            c.normal_()
    g = StepGraphs(cuda)
    counter = "KERNEL_LAUNCHES_INT8" if kv == "int8" else "KERNEL_LAUNCHES"
    for seed in (1, 2):
        for kind, (eager, graphed) in _graph_cases(cfg, params, cache, g, seed).items():
            saved = [x.clone() for x in parts]
            want = eager().clone()
            kv_want = [x[:, 1:].clone() for x in parts]
            for x, s0 in zip(parts, saved):
                x.copy_(s0)
            if seed == 2:
                before = getattr(mk, counter)
            got = graphed().clone()
            torch.cuda.synchronize()
            assert torch.equal(got, want), (kind, seed)
            assert all(torch.equal(a, b[:, 1:]) for a, b in zip(kv_want, parts)), (kind, seed)
            if seed == 2:
                steps = {"decode_multi": 8, "draw": 0}.get(kind.split()[0], 1)
                assert getattr(mk, counter) - before == steps * cfg.num_layers, kind
    assert g.captures_total == len(g) == 9


def test_split_counters_outlive_their_growth_after_a_capture(cuda):
    """The ragged kernel's split counters grow after a decode graph was
    captured (an eager launch or a new scheduler asking for more rows):
    the tensor the graph captured stays alive, and its replays still equal
    the eager call. Growing them under a capture raises."""
    from dynamo_tpu_torch.engine.graphs import StepGraphs

    cfg = get_config("tiny")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device=cuda, dtype=torch.bfloat16)
    cache = KvCacheArrays.create(cfg, 48, dtype=torch.bfloat16, device=cuda)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for c in (cache.k, cache.v):
        c.normal_(generator=gen)
    g = StepGraphs(cuda)
    eager, graphed = _graph_cases(cfg, params, cache, g, 3)["decode"]
    want = eager().clone()
    graphed()
    dev = torch.device("cuda", torch.cuda.current_device())
    old = mk._COUNTERS[dev]
    mk.reserve_counters(cuda, old.numel() * 4)
    assert mk._COUNTERS[dev].data_ptr() != old.data_ptr()
    assert any(t is old for t in pdk._SUPERSEDED)
    old_ptr = old.data_ptr()
    del old
    torch.cuda.empty_cache()
    # Allocations that would take the old counters' memory were it freed.
    filler = [torch.full((1 << 16,), 7, dtype=torch.int32, device=cuda) for _ in range(64)]
    assert all(not (f.data_ptr() <= old_ptr < f.data_ptr() + f.numel() * 4) for f in filler)
    for _ in range(3):
        assert torch.equal(graphed().clone(), want)
    grow = lambda x: (mk.reserve_counters(cuda, mk._COUNTERS[dev].numel() + 1), x["a"] + 1)[1:]  # noqa: E731
    with pytest.raises(RuntimeError, match="grow under a CUDA graph capture"):
        g.graph(("grow",), [("a", (1,), np.int32)], grow)

# Last in the module: a capture that a host read invalidated ends without
# PyTorch's epilogue, which leaves the default CUDA generator in capture
# mode for the rest of the process (its next draw raises).
def test_no_capture_after_warmup_and_a_failed_capture_raises(cuda):
    """``Scheduler.warmup`` captures every key the traffic inside its
    context reaches: serving requests afterwards captures nothing, and the
    overlapped pipeline runs. A step body that reads the device back under
    capture raises; it never falls back to eager."""
    from dynamo_tpu_torch.engine.graphs import StepGraphs
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import Scheduler, SchedulerConfig, StopConditions

    cfg = get_config("tiny")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device=cuda, dtype=torch.bfloat16)
    sc = SchedulerConfig(num_blocks=128, max_running=4, prefill_buckets=[32, 64, 128], decode_buckets=[1, 2, 4],
                         num_scheduler_steps=1, mixed_prefill_budget=32)
    s = Scheduler(cfg, params, sc, dtype=torch.bfloat16, device="cuda")
    assert s.warmup(cfg.max_seq_len) > 0 and s.graph_captures_after_warmup == 0
    rng = np.random.default_rng(0)
    for i in range(5):
        s.add_request(f"r{i}", rng.integers(1, 255, size=int(rng.integers(5, 120))).tolist(),
                      SamplingParams(temperature=0.7 if i == 2 else 0.0), StopConditions(max_tokens=40))
    while s.has_work():
        s.step()
    assert s.graph_captures_after_warmup == 0
    assert s.overlap_steps_total > 0
    g = StepGraphs(cuda)
    x = torch.zeros(4, device=cuda)
    with pytest.raises(RuntimeError):
        g.graph(("bad",), [("a", (4,), np.int32)], lambda inp: (x + inp["a"].sum().item(),))
    assert ("bad",) not in g and g.captures_total == 0

