"""The port's KVBM (``dynamo_tpu_torch/llm/block_manager``) against the JAX
package's, on ``tiny`` (CPU):

1. ``transfer.py``: one-block gathers, device stacks and their scatters give
   the JAX functions' bytes on the same seeded cache (f32 and bf16 exact);
   over an int8 cache the dequantized rows are equal and a requantized
   scatter is within one code step of JAX's (scales to ``SCALE_RTOL``).
2. The block payload: ``storage.block_npz_bytes`` is ``np.savez``'s bytes
   for the same block (f32, and bf16 through ``ml_dtypes``); a ``DiskPool``
   of either package writes the same file; a bf16 block a JAX ``DiskPool``
   spilled onboards in the port's KVBM (the JAX package's own onboard of it
   raises, as it reads a void array back).
3. The cascade cases of ``tests/test_kvbm.py`` on the port: offload on
   eviction and onboard, G2 → G3 spill, restart recovery, host LRU, the G4
   remote pool across two workers over the port's runtime, and its
   loop-thread guard; and a G2 hit that the onboard's own allocation
   spills, which the port keeps and the JAX package loses.
4. The scheduler with a KVBM (``attach_kvbm``), one step an iteration and in
   8-step windows, against the JAX scheduler's on churning traffic: equal
   tokens, allocator event sequences, ``KvbmMetrics`` and onboard counts;
   and the engine's determinism across offload cycles
   (``tests/test_kvbm_determinism.py``) with ``prefix_onboard_total`` in its
   stats.
"""

import asyncio
import io
import os
import tempfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.kv_cache import BlockAllocator as JaxAllocator
from dynamo_tpu.engine.kv_cache import KvCacheArrays as JaxCache
from dynamo_tpu.engine.kv_cache import QuantKv as JaxQuantKv
from dynamo_tpu.engine.kv_cache import quantize_kv_rows as jax_quantize
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.sampling import SamplingParams as JaxSampling
from dynamo_tpu.llm import block_manager as jkvbm
from dynamo_tpu.llm.block_manager import storage as jstorage
from dynamo_tpu.llm.block_manager import transfer as jtransfer
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.kv_cache import BlockAllocator, KvCacheArrays, QuantKv, quantize_kv_rows
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.block_manager import CacheLevel, KvBlockManager
from dynamo_tpu_torch.llm.block_manager import storage, transfer
from dynamo_tpu_torch.llm.block_manager.storage import DiskPool, HostPool, RemotePool
from dynamo_tpu_torch.llm.tokens import compute_block_hashes
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context

TCFG = get_config("tiny")
JCFG = jax_config("tiny")
SCALE_RTOL = 2e-5
KV_ATOL = 2e-5  # f32 KV written by the two packages' forwards (test_torch_overlap.py)
DTYPES = {"float32": (torch.float32, jnp.float32, np.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16,
                                                                             ml_dtypes.bfloat16)}


def np_of(t: torch.Tensor) -> np.ndarray:
    """A port tensor as numpy in the JAX package's dtype (bf16 as ml_dtypes)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def torch_of(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def seeded_caches(dtype: str, num_blocks: int = 12, seed: int = 0):
    """The same random cache as a JAX and a port ``KvCacheArrays``."""
    tdt, jdt, ndt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    shape = (TCFG.num_layers, num_blocks, TCFG.block_size, TCFG.num_kv_heads, TCFG.head_dim)
    k = rng.standard_normal(shape).astype(np.float32).astype(ndt)
    v = rng.standard_normal(shape).astype(np.float32).astype(ndt)
    jc = JaxCache(k=jnp.asarray(k), v=jnp.asarray(v))
    tc = KvCacheArrays(k=torch_of(k), v=torch_of(v))
    return jc, tc


# ---------------------------------------------------------------------------
# 1. transfer.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_gather_and_scatter_bytes_equal_jax(dtype):
    jc, tc = seeded_caches(dtype)
    for bid in (1, 5, 11):
        jk, jv = jtransfer.gather_blocks(jc, bid)
        tk, tv = transfer.gather_blocks(tc, bid)
        assert np_of(tk).tobytes() == np.asarray(jk).tobytes() and np_of(tv).tobytes() == np.asarray(jv).tobytes()
    host = transfer.gather_blocks_host(tc, [3, 7, 2])
    for (tk, tv), bid in zip(host, (3, 7, 2)):
        jk, jv = jtransfer.gather_blocks(jc, bid)
        assert np_of(tk).tobytes() == np.asarray(jk).tobytes() and np_of(tv).tobytes() == np.asarray(jv).tobytes()
    jks, jvs = jtransfer.gather_blocks_device(jc, [3, 7, 2])
    tks, tvs = transfer.gather_blocks_device(tc, [3, 7, 2])
    assert np_of(tks).tobytes() == np.asarray(jks).tobytes() and np_of(tvs).tobytes() == np.asarray(jvs).tobytes()
    # Scatter a stack and one host block into both; the whole caches agree
    # and the port's tensors are the ones it started with (written in place).
    k_ptr = tc.k.data_ptr()
    jtransfer.scatter_blocks_device(jc, [9, 4, 1], jks, jvs)
    transfer.scatter_blocks_device(tc, [9, 4, 1], tks, tvs)
    jk, jv = jtransfer.gather_blocks(jc, 6)
    jtransfer.scatter_blocks(jc, 10, jk, jv)
    transfer.scatter_blocks(tc, 10, *transfer.gather_blocks(tc, 6))
    assert tc.k.data_ptr() == k_ptr
    assert np_of(tc.k).tobytes() == np.asarray(jc.k).tobytes()
    assert np_of(tc.v).tobytes() == np.asarray(jc.v).tobytes()
    # Cache to cache.
    jdst, tdst = seeded_caches(dtype, num_blocks=6, seed=3)
    jtransfer.copy_blocks_between(jc, [2, 8], jdst, [5, 1])
    transfer.copy_blocks_between(tc, [2, 8], tdst, [5, 1])
    assert np_of(tdst.k).tobytes() == np.asarray(jdst.k).tobytes()


def _int8_caches(seed: int = 1):
    rng = np.random.default_rng(seed)
    shape = (TCFG.num_layers, 10, TCFG.block_size, TCFG.num_kv_heads, TCFG.head_dim)
    rows = [rng.standard_normal(shape).astype(np.float32) * 3 for _ in range(2)]
    j = [jax_quantize(jnp.asarray(r)) for r in rows]
    t = [QuantKv(torch.from_numpy(np.array(q.q)), torch.from_numpy(np.array(q.scale))) for q in j]
    return JaxCache(k=j[0], v=j[1]), KvCacheArrays(k=t[0], v=t[1])


def _check_codes(t: QuantKv, j: JaxQuantKv):
    tq, jq = t.q.numpy().astype(np.int32), np.asarray(j.q).astype(np.int32)
    assert np.abs(tq - jq).max() <= 1
    np.testing.assert_allclose(t.scale.numpy(), np.asarray(j.scale), rtol=SCALE_RTOL, atol=0)


def test_int8_cache_crosses_as_real_rows_within_one_code_step():
    jc, tc = _int8_caches()
    jk, jv = jtransfer.gather_blocks(jc, 4)
    tk, tv = transfer.gather_blocks(tc, 4)
    assert tk.dtype == torch.float32
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jks, jvs = jtransfer.gather_blocks_device(jc, [1, 6])
    tks, tvs = transfer.gather_blocks_device(tc, [1, 6])
    assert tks.dtype == torch.bfloat16 and np_of(tks).tobytes() == np.asarray(jks).tobytes()
    # Requantizing scatters: a host block (f32) and a device stack (bf16).
    jtransfer.scatter_blocks(jc, 8, jk, jv)
    transfer.scatter_blocks(tc, 8, tk, tv)
    jtransfer.scatter_blocks_device(jc, [2, 3], jks, jvs)
    transfer.scatter_blocks_device(tc, [2, 3], tks, tvs)
    _check_codes(tc.k, jc.k)
    _check_codes(tc.v, jc.v)
    # A dequantized block requantizes to within one code step of itself.
    before = tc.k.q[:, 4].clone()
    transfer.scatter_blocks(tc, 4, tk, tv)
    assert (tc.k.q[:, 4].int() - before.int()).abs().max() <= 1


# ---------------------------------------------------------------------------
# 2. The block payload
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_npz_bytes_equal_numpy_savez(dtype, tmp_path):
    jc, tc = seeded_caches(dtype)
    jk, jv = (np.asarray(a) for a in jtransfer.gather_blocks(jc, 3))
    tk, tv = transfer.gather_blocks(tc, 3)
    buf = io.BytesIO()
    np.savez(buf, k=jk, v=jv)
    assert storage.block_npz_bytes(tk, tv) == buf.getvalue()
    back = storage.read_block_npz(buf.getvalue())
    assert back[0].dtype == tk.dtype and torch.equal(back[0], tk) and torch.equal(back[1], tv)
    # The two DiskPools write the same file for the same block.
    jpool = jstorage.DiskPool(str(tmp_path / "jax"), capacity=4)
    tpool = DiskPool(str(tmp_path / "port"), capacity=4)
    jpool.put(0xBEEF, jk, jv)
    tpool.put(0xBEEF, tk, tv)
    name = f"{0xBEEF:016x}.npz"
    assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_jax_spilled_bf16_block_onboards_in_the_port(tmp_path):
    """A bf16 block a JAX worker spilled to disk (G3) onboards in the port's
    KVBM with its bytes. The JAX package's own onboard of it raises: numpy
    reads its ``'<V2'`` member back as a void array."""
    jc, tc = seeded_caches("bfloat16")
    hashes = compute_block_hashes(list(range(32)), TCFG.block_size)
    jpool = jstorage.DiskPool(str(tmp_path), capacity=4)
    want = []
    for h, bid in zip(hashes, (2, 9)):
        jk, jv = jtransfer.gather_blocks(jc, bid)
        jpool.put(h, jk, jv)
        want.append((np.asarray(jk).tobytes(), np.asarray(jv).tobytes()))
    got_k, _ = jpool.get(hashes[0])
    assert got_k.dtype == np.dtype("V2")
    jdst = JaxCache.create(JCFG, 8, dtype=jnp.bfloat16)
    with pytest.raises(TypeError):
        jtransfer.scatter_blocks(jdst, 1, *jpool.get(hashes[0]))

    _, dst = seeded_caches("bfloat16", num_blocks=8, seed=5)
    alloc = BlockAllocator(8)
    alloc._free.remove(0)
    kvbm = KvBlockManager(dst, alloc, host_blocks=4, disk_dir=str(tmp_path), disk_blocks=4)
    match = kvbm.match_prefix(hashes)
    assert [t for _, t in match.onboardable] == [CacheLevel.G3, CacheLevel.G3]
    blocks = kvbm.onboard(match, hashes)
    assert kvbm.metrics.onboards_g3 == 2
    for bid, (wk, wv) in zip(blocks, want):
        tk, tv = transfer.gather_blocks(dst, bid)
        assert np_of(tk).tobytes() == wk and np_of(tv).tobytes() == wv


# ---------------------------------------------------------------------------
# 3. The cascade (tests/test_kvbm.py's cases)
# ---------------------------------------------------------------------------


def make_kvbm(num_device=8, host=4, disk=0, tmp=None):
    cache = KvCacheArrays.create(TCFG, num_device, dtype=torch.float32, device="cpu")
    alloc = BlockAllocator(num_device)
    alloc._free.remove(0)
    kvbm = KvBlockManager(cache, alloc, host_blocks=host, disk_dir=str(tmp) if disk else None, disk_blocks=disk)
    return kvbm, cache, alloc


def fill_block(cache, bid, value):
    k = torch.full((TCFG.num_layers, TCFG.block_size, TCFG.num_kv_heads, TCFG.head_dim), value)
    transfer.scatter_blocks(cache, bid, k, -k)
    return k


def test_offload_on_eviction_then_onboard():
    kvbm, cache, alloc = make_kvbm(num_device=5, host=4)
    hashes = compute_block_hashes(list(range(64)), 16)
    blocks = alloc.allocate(4)
    contents = {h: fill_block(cache, b, float(i + 1)) for i, (b, h) in enumerate(zip(blocks, hashes))}
    alloc.register_hashes(blocks, hashes)
    alloc.release(blocks)
    got = alloc.allocate(4)  # every cached block evicts: four snapshots queue
    assert len(kvbm._pending) == 4
    assert kvbm.flush_pending() == 4
    assert kvbm.metrics.offloads_g2 == 4 and len(kvbm.host) == 4
    alloc.release(got)
    match = kvbm.match_prefix(hashes)
    assert match.g1_blocks == [] and [t for _, t in match.onboardable] == [CacheLevel.G2] * 4
    device_blocks = kvbm.onboard(match, hashes)
    assert len(device_blocks) == 4 and kvbm.metrics.onboards_g2 == 4
    for bid, h in zip(device_blocks, hashes):
        k, v = transfer.gather_blocks(cache, bid)
        assert torch.equal(k, contents[h]) and torch.equal(v, -contents[h])
    alloc.release(device_blocks)
    match2 = kvbm.match_prefix(hashes)
    assert len(match2.g1_blocks) == 4 and not match2.onboardable
    assert kvbm.usage()["g2"] == 1.0


def test_cascade_to_disk_and_reset(tmp_path):
    kvbm, cache, alloc = make_kvbm(num_device=5, host=2, disk=8, tmp=tmp_path)
    hashes = compute_block_hashes(list(range(64)), 16)
    blocks = alloc.allocate(4)
    for i, b in enumerate(blocks):
        fill_block(cache, b, float(i + 1))
    alloc.register_hashes(blocks, hashes)
    alloc.release(blocks)
    alloc.allocate(4)
    kvbm.flush_pending()
    assert (kvbm.metrics.offloads_g2, kvbm.metrics.offloads_g3) == (4, 2)
    assert len(kvbm.host) == 2 and len(kvbm.disk) == 2
    assert {t for _, t in kvbm.match_prefix(hashes).onboardable} == {CacheLevel.G2, CacheLevel.G3}
    assert kvbm.reset_tier(CacheLevel.G3) == 2 and not os.listdir(tmp_path)
    assert kvbm.reset_tier(CacheLevel.G2) == 2


def test_disk_pool_restart_recovery(tmp_path):
    pool = DiskPool(str(tmp_path), capacity=4)
    k = torch.ones((2, 16, 2, 16))
    pool.put(0xABC, k, k * 2)
    pool2 = DiskPool(str(tmp_path), capacity=4)
    assert pool2.has(0xABC)
    got = pool2.get(0xABC)
    assert torch.equal(got[0], k) and torch.equal(got[1], k * 2)


def test_host_pool_lru_spill():
    pool = HostPool(capacity=2)
    a = torch.zeros((1,))
    assert pool.put(1, a, a) is None and pool.put(2, a, a) is None
    assert pool.put(3, a, a)[0] == 1
    pool.get(2)
    assert pool.put(4, a, a)[0] == 3


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_onboard_keeps_a_g2_hit_its_own_allocation_spills(pkg):
    """A chain in G2 whose onboard allocation evicts G1 blocks, whose drain
    spills that very chain out of G2: the port reads the blocks before it
    allocates and onboards the whole chain; the JAX package allocates first
    and loses the hit (the chain stops at its first block)."""
    hashes = compute_block_hashes(list(range(64)), 16)
    churn = compute_block_hashes(list(range(500, 628)), 16)
    if pkg == "port":
        kvbm, cache, alloc = make_kvbm(num_device=9, host=4)
        put = lambda h, val: kvbm.host.put(h, *(torch.full(  # noqa: E731
            (TCFG.num_layers, TCFG.block_size, TCFG.num_kv_heads, TCFG.head_dim), float(s)) for s in (val, -val)))
    else:
        cache = JaxCache.create(JCFG, 9, dtype=jnp.float32)
        alloc = JaxAllocator(9)
        alloc._free.remove(0)
        kvbm = jkvbm.KvBlockManager(cache, alloc, host_blocks=4)
        put = lambda h, val: kvbm.host.put(h, *(np.full(  # noqa: E731
            (JCFG.num_layers, JCFG.block_size, JCFG.num_kv_heads, JCFG.head_dim), s, np.float32) for s in (val, -val)))
    kvbm._pending_cap = 1  # every eviction drains at once
    for i, h in enumerate(hashes):
        put(h, float(i + 1))
    blocks = alloc.allocate(8)  # G1 full of another chain's cached blocks
    alloc.register_hashes(blocks, churn)
    alloc.release(blocks)
    match = kvbm.match_prefix(hashes)
    assert [t for _, t in match.onboardable] == [jkvbm.CacheLevel.G2 if pkg == "jax" else CacheLevel.G2] * 4
    got = kvbm.onboard(match, hashes)
    if pkg == "jax":
        assert got == [] and kvbm.metrics.onboards_g2 == 1
        return
    assert len(got) == 4 and kvbm.metrics.onboards_g2 == 4
    for i, bid in enumerate(got):
        k, v = transfer.gather_blocks(cache, bid)
        assert torch.equal(k, torch.full_like(k, float(i + 1))) and torch.equal(v, -k)
    assert alloc.match_prefix(hashes) == got


async def test_g4_remote_tier_cross_worker():
    """Worker A evicts through G2, G3 and G4; worker B (its own KVBM, the
    same object store) onboards the chain's head from G4, bit-equal."""
    drt = await DistributedRuntime.detached()
    loop = asyncio.get_running_loop()
    try:
        def make_worker(tmp=None, disk=0):
            kvbm, cache, alloc = make_kvbm(num_device=5, host=1, disk=disk, tmp=tmp)
            kvbm.attach_remote(RemotePool(drt, loop, refresh_s=0.0))
            return kvbm, cache, alloc

        with tempfile.TemporaryDirectory() as tmp_a:
            kvbm_a, cache_a, alloc_a = make_worker(tmp=tmp_a + "/a", disk=1)
            hashes = compute_block_hashes(list(range(64)), 16)

            def worker_a_evicts():
                blocks = alloc_a.allocate(4)
                contents = {h: fill_block(cache_a, b, float(i + 1)) for i, (b, h) in enumerate(zip(blocks, hashes))}
                alloc_a.register_hashes(blocks, hashes)
                alloc_a.release(blocks)
                got = alloc_a.allocate(4)
                kvbm_a.flush_pending()
                alloc_a.release(got)
                churn = compute_block_hashes(list(range(5000, 5032)), 16)
                cblocks = alloc_a.allocate(2)
                alloc_a.register_hashes(cblocks, churn)
                alloc_a.release(cblocks)
                alloc_a.allocate(4)
                kvbm_a.flush_pending()
                return contents

            contents = await asyncio.to_thread(worker_a_evicts)
            m = kvbm_a.metrics
            assert m.offloads_g2 == 6 and m.offloads_g3 >= 1 and m.offloads_g4 >= 1
            await asyncio.sleep(0.05)  # the fire-and-forget puts land

            kvbm_b, cache_b, _ = make_worker()

            def worker_b_onboards():
                match = kvbm_b.match_prefix(hashes)
                assert CacheLevel.G4 in [t for _, t in match.onboardable]
                return kvbm_b.onboard(match, hashes)

            device_blocks = await asyncio.to_thread(worker_b_onboards)
            assert kvbm_b.metrics.onboards_g4 >= 1
            for bid, h in zip(device_blocks, hashes):
                k, v = transfer.gather_blocks(cache_b, bid)
                assert torch.equal(k, contents[h]) and torch.equal(v, -contents[h])
            assert kvbm_b.usage()["g4_known_blocks"] >= 1
    finally:
        await drt.shutdown()


async def test_g4_loop_thread_guard():
    drt = await DistributedRuntime.detached()
    try:
        pool = RemotePool(drt, asyncio.get_running_loop(), refresh_s=0.0)
        with pytest.raises(RuntimeError, match="worker thread"):
            pool.get(123)
    finally:
        await drt.shutdown()


# ---------------------------------------------------------------------------
# 4. The scheduler and the engine with a KVBM
# ---------------------------------------------------------------------------

SCHED = dict(num_blocks=14, max_running=4, prefill_buckets=[16, 32, 64], decode_buckets=[1, 2, 4])


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, device="cpu", dtype=torch.float32)


def _wire(ev):
    d = ev.to_wire()
    d.pop("ts")
    return d


def _run(sched, mod, sampling_cls, prompts):
    """Each prompt to completion in turn (greedy, 6 tokens) → tokens."""
    outs = []
    for i, p in enumerate(prompts):
        sched.add_request(f"r{i}", p, sampling_cls(temperature=0.0),
                          mod.StopConditions(max_tokens=6, ignore_eos=True))
        toks = []
        for _ in range(500):
            if not sched.has_work():
                break
            toks += [o.token_id for _, o in sched.step() if o.token_id >= 0]
        assert not sched.has_work()
        outs.append(toks)
    return outs


@pytest.mark.parametrize("steps", [1, 8])
def test_scheduler_with_kvbm_matches_jax(weights, steps, tmp_path):
    """Ten 36-token prompts want 20 cached blocks of a 14-block pool: three
    rounds evict and onboard each other's prefixes through G2 and G3. The
    port and JAX give the same tokens, the same allocator events, the same
    KVBM metrics and onboard counts."""
    jp, tp = weights
    jev, tev = [], []
    j = jsched.Scheduler(JCFG, jp, jsched.SchedulerConfig(**SCHED, num_scheduler_steps=steps), dtype=jnp.float32,
                         on_kv_event=lambda e: jev.append(_wire(e)))
    t = tsched.Scheduler(TCFG, tp, tsched.SchedulerConfig(**SCHED, num_scheduler_steps=steps), dtype=torch.float32,
                         device="cpu", on_kv_event=lambda e: tev.append(_wire(e)))
    j.attach_kvbm(jkvbm.KvBlockManager(j.cache, j.allocator, host_blocks=6, disk_dir=str(tmp_path / "j"),
                                       disk_blocks=64))
    t.attach_kvbm(KvBlockManager(t.cache, t.allocator, host_blocks=6, disk_dir=str(tmp_path / "t"),
                                 disk_blocks=64))
    prompts = [list(range(10 + 3 * i, 46 + 3 * i)) for i in range(10)] * 3
    want = _run(j, jsched, JaxSampling, prompts)
    got = _run(t, tsched, SamplingParams, prompts)
    assert got == want
    assert all(got[i] == got[i + 10] == got[i + 20] for i in range(10))
    assert tev == jev
    assert vars(t.kvbm.metrics) == vars(j.kvbm.metrics)
    m = t.kvbm.metrics
    assert m.offloads_g2 > 0 and m.offloads_g3 > 0 and m.onboards_g2 > 0 and m.onboards_g3 > 0
    assert t.prefix_onboard_total == j.prefix_onboard_total > 0
    assert t.metrics().prefix_onboard_total == t.prefix_onboard_total
    tm, jm = t.metrics(), j.metrics()
    assert (tm.prefix_hit_blocks_total, tm.prefix_miss_blocks_total) == (jm.prefix_hit_blocks_total,
                                                                          jm.prefix_miss_blocks_total)
    # The same blocks in both G3 directories; their KV to the forwards'
    # rounding (the payload's bytes are held in test_block_npz_bytes_*).
    names = sorted(os.listdir(tmp_path / "t"))
    assert names and names == sorted(os.listdir(tmp_path / "j"))
    for n in names:
        with np.load(tmp_path / "t" / n) as a, np.load(tmp_path / "j" / n) as b:
            for key in ("k", "v"):
                np.testing.assert_allclose(a[key], b[key], rtol=0, atol=KV_ATOL)


async def _gen(engine, tokens, mt=12):
    out = []
    req = {"token_ids": tokens, "sampling_options": {"temperature": 0.0}, "stop_conditions": {"max_tokens": mt}}
    async for fr in engine.generate(req, Context()):
        out.extend(fr["token_ids"])
    return out


async def test_engine_offload_onboard_cycle_is_token_deterministic(weights, tmp_path):
    """``tests/test_kvbm_determinism.py``: a probe answered from a G2/G3
    onboarded prefix gives the G1 answer; the engine's stats report the
    onboards and its G3 directory survives its stop."""
    _, tp = weights
    engine = TorchEngine.build(
        EngineArgs(model="tiny", dtype="float32", device="cpu", kvbm_host_blocks=2,
                   kvbm_disk_dir=str(tmp_path), kvbm_disk_blocks=64,
                   scheduler=tsched.SchedulerConfig(num_blocks=24, max_running=4, prefill_buckets=[16, 32, 64],
                                                    decode_buckets=[1, 2, 4], num_scheduler_steps=1)),
        params=tp)
    try:
        kvbm = engine.kvbm
        probe = list(range(40, 72))
        out_fresh = await _gen(engine, probe)
        assert await _gen(engine, probe) == out_fresh
        for i in range(12):
            await _gen(engine, [200 + i] + list(range(i * 7 + 1, i * 7 + 29)), mt=4)
        kvbm.flush_pending()
        assert kvbm.metrics.offloads_g2 > 0 and kvbm.metrics.offloads_g3 > 0
        assert await _gen(engine, probe) == out_fresh
        assert kvbm.metrics.onboards_g2 + kvbm.metrics.onboards_g3 > 0
        stats = engine.stats_handler()
        assert stats["prefix_onboard_total"] == engine.scheduler.prefix_onboard_total > 0
    finally:
        await engine.stop()
    assert not kvbm._pending and sorted(os.listdir(tmp_path))
