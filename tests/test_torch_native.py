"""The port's host library (``dynamo_tpu_torch/csrc/native.cc``, built here
by the host compiler at first use) against the JAX package and the
``xxhash`` wheel on seeded and hypothesis inputs:

- the chained block hashes equal ``xxhash``'s xxh3_64, the JAX package's
  ``compute_block_hashes`` and the port's pure-Python path (``DYN_NATIVE=0``)
  for every block size the pure-Python xxh3 covers (1..60 tokens);
- ``NativeRadixTree`` gives the JAX ``RadixTree``'s scores (with and
  without ``early_exit``), sizes, workers and snapshot bytes over seeded
  event sequences, and either tree restores the other's snapshot;
- events published through the C ABI (``load_c_abi``) come out of the
  port's ``NativeKvEventSource`` as the JAX one yields them from its
  extension;
- a failed build raises, stamps the failure and raises again without a
  second compile; ``DYN_NATIVE=0`` is the pure-Python path.
"""

import asyncio
import ctypes
import os
import struct

import numpy as np
import pytest
import xxhash
from hypothesis import given, settings, strategies as st

import dynamo_tpu.llm.c_api as j_capi
import dynamo_tpu.llm.kv_router.indexer as j_indexer
from dynamo_tpu.llm.tokens import compute_block_hashes as j_hashes
from dynamo_tpu_torch import _build, native
from dynamo_tpu_torch.llm import c_api as p_capi
from dynamo_tpu_torch.llm import tokens as p_tokens
from dynamo_tpu_torch.llm.kv_router import indexer as p_indexer

ROOT = p_tokens.ROOT_SEED


def xxhash_chain(tokens, block_size):
    out, seed = [], ROOT
    for i in range(len(tokens) // block_size):
        seed = xxhash.xxh3_64_intdigest(struct.pack(f"<{block_size}I", *tokens[i * block_size:(i + 1) * block_size]),
                                        seed=seed)
        out.append(seed)
    return out


def pure_python(monkeypatch, fn, *args):
    with monkeypatch.context() as m:
        m.setenv("DYN_NATIVE", "0")
        return fn(*args)


def test_library_builds_with_the_host_compiler():
    lib = native.get_native()
    path = _build.library_path("native")
    assert lib is not None and lib.path == str(path) and path.exists()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libnative-") and path.suffix == ".so"
    assert path.with_suffix(".stamp").read_text() == "ok"
    assert _build.build_host("native")["seconds"] == 0.0  # built once, then reused


@pytest.mark.parametrize("n", list(range(61)))
def test_hash_tokens_every_length(n):
    rng = np.random.default_rng(n)
    toks = rng.integers(0, 2**32, size=n, dtype=np.uint64).tolist()
    seed = int(rng.integers(0, 2**63)) * 2 + 1
    want = xxhash.xxh3_64_intdigest(struct.pack(f"<{n}I", *toks), seed=seed)
    assert native.get_native().hash_tokens(toks, seed) == want == p_tokens.xxh3_64(struct.pack(f"<{n}I", *toks), seed)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 2**32 - 1), max_size=400), st.integers(1, 60), st.integers(0, 40))
def test_block_hashes_match_xxhash_jax_and_pure_python(tokens, block_size, keep):
    got = p_tokens.compute_block_hashes(tokens, block_size)
    assert got == xxhash_chain(tokens, block_size) == j_hashes(tokens, block_size)
    prev = got[:keep]
    assert p_tokens.extend_block_hashes(prev, tokens, block_size) == got
    with pytest.MonkeyPatch.context() as m:
        m.setenv("DYN_NATIVE", "0")
        assert p_tokens.compute_block_hashes(tokens, block_size) == got
        assert p_tokens.extend_block_hashes(prev, tokens, block_size) == got


def test_blocks_past_240_bytes_are_refused(monkeypatch):
    with pytest.raises(ValueError):
        p_tokens.compute_block_hashes(list(range(61)), 61)
    with pytest.raises(ValueError):
        pure_python(monkeypatch, p_tokens.compute_block_hashes, list(range(61)), 61)
    with pytest.raises(ValueError):
        native.get_native().hash_tokens(list(range(61)), ROOT)


def events(seed: int, n: int = 400, workers=(5, 7, 2**40 + 3), bs: int = 4):
    """Seeded (worker, kind, hashes, parent) events: chains branching off
    shared roots, removals of held blocks, orphans, whole-worker removals."""
    rng = np.random.default_rng(seed)
    roots = [rng.integers(1, 100, size=bs * 6).tolist() for _ in range(3)]
    held = {w: [] for w in workers}
    out = []
    for _ in range(n):
        w = int(rng.choice(workers))
        r = rng.random()
        if r < 0.6 or not held[w]:
            root = roots[int(rng.integers(len(roots)))]
            toks = root[: bs * int(rng.integers(0, 7))] + rng.integers(1, 40, size=bs * int(rng.integers(1, 4))).tolist()
            hashes = j_hashes(toks, bs)
            start = int(rng.integers(0, len(hashes)))
            parent = hashes[start - 1] if start else (int(rng.integers(1, 2**63)) if rng.random() < 0.05 else None)
            out.append((w, "stored", hashes[start:], parent))
            held[w] += hashes[start:]
        elif r < 0.95:
            k = int(rng.integers(1, min(4, len(held[w])) + 1))
            out.append((w, "removed", [held[w][int(i)] for i in rng.choice(len(held[w]), size=k, replace=False)],
                        None))
        else:
            out.append((w, "worker", [], None))
            held[w] = []
    queries = [j_hashes(root[: bs * int(rng.integers(1, 7))] + [1, 2, 3, 4], bs) for root in roots]
    return out, queries


def apply(tree, ev):
    w, kind, hashes, parent = ev
    if kind == "stored":
        tree.apply_stored(w, hashes, parent)
    elif kind == "removed":
        tree.apply_removed(w, hashes)
    else:
        tree.remove_worker(w)


@pytest.mark.parametrize("seed", range(6))
def test_native_tree_matches_jax_radix_tree(seed):
    evs, queries = events(seed)
    mine, ref = p_indexer.NativeRadixTree(), j_indexer.RadixTree()
    for i, ev in enumerate(evs):
        apply(mine, ev)
        apply(ref, ev)
        if i % 20 == 0 or i == len(evs) - 1:
            for q in queries:
                for early in (False, True):
                    assert mine.find_matches(q, early).scores == ref.find_matches(q, early).scores
            assert mine.size() == ref.size() and mine.workers() == ref.workers()
            assert mine.dump() == ref.dump()
    # Either tree restores the other's snapshot as the JAX tree restores its
    # own (a node no worker holds is not in the records, so its children
    # come back rooted, in both packages).
    back, there = p_indexer.NativeRadixTree.load(ref.dump()), j_indexer.RadixTree.load(mine.dump())
    own = j_indexer.RadixTree.load(ref.dump())
    for q in queries:
        assert back.find_matches(q).scores == there.find_matches(q).scores == own.find_matches(q).scores
    assert back.dump() == own.dump()
    mine._impl.clear()
    assert mine.size() == 0 and mine.find_matches(queries[0]).scores == {}


def test_indexers_sit_on_the_native_tree_unless_asked(monkeypatch):
    assert isinstance(p_indexer.KvIndexer().tree, p_indexer.NativeRadixTree)
    assert isinstance(p_indexer.make_radix_tree(), p_indexer.NativeRadixTree)
    monkeypatch.setenv("DYN_NATIVE", "0")
    assert native.get_native() is None and not native.available()
    assert isinstance(p_indexer.KvIndexer().tree, p_indexer.RadixTree)
    idx = p_indexer.KvIndexer()
    idx.apply_event(3, {"kind": "stored", "block_hashes": [11, 12], "parent_hash": None})
    monkeypatch.delenv("DYN_NATIVE")
    restored = p_indexer.KvIndexer()
    restored.load_snapshot(idx.dump())
    assert isinstance(restored.tree, p_indexer.NativeRadixTree)
    assert restored.find_matches([11, 12]).scores == {3: 2} and restored.dump() == idx.dump()


class _Sink:
    def __init__(self):
        self.events = []

    def publish(self, ev):
        self.events.append((ev.kind, list(ev.block_hashes), ev.parent_hash))


PUBLISHES = [(9, "stored", [1, 2, 3], None), (9, "stored", [4], 3), (2**63 + 1, "removed", [2, 3], None),
             (4, "stored", [], None), (9, "removed", [2**64 - 1], None), (5, "stored", [2**64 - 2, 8], 2**64 - 1)]


def _publish(lib, evs):
    assert lib.dynamo_tpu_llm_init() == 0
    for wid, kind, hashes, parent in evs:
        arr = (ctypes.c_uint64 * max(1, len(hashes)))(*hashes)
        if kind == "stored":
            rc = lib.dynamo_tpu_kv_event_publish_stored(wid, arr, len(hashes), parent or 0, int(parent is not None))
        else:
            rc = lib.dynamo_tpu_kv_event_publish_removed(wid, arr, len(hashes))
        assert rc == 0


async def _pump(capi_mod, evs):
    sink = capi_mod.NativeKvEventSource(_Sink(), poll_interval_s=0.01)
    lib = capi_mod.load_c_abi()
    _publish(lib, evs)
    sink.start()
    for _ in range(200):
        if sink.events_pumped >= len(evs):
            break
        await asyncio.sleep(0.01)
    await sink.stop()
    assert lib.dynamo_tpu_llm_shutdown() == 0
    return sink.publisher.events, sink.events_pumped


def test_c_abi_events_come_out_as_the_jax_source_yields_them():
    mine, n = asyncio.run(_pump(p_capi, PUBLISHES))
    ref, m = asyncio.run(_pump(j_capi, PUBLISHES))
    assert mine == ref and n == m == len(PUBLISHES)
    assert mine[1] == ("stored", [4], 3) and mine[5] == ("stored", [2**64 - 2, 8], 2**64 - 1)


def test_c_abi_refuses_before_init_and_drains_in_order():
    lib, nat = p_capi.load_c_abi(), native.get_native()
    lib.dynamo_tpu_llm_shutdown()
    one = (ctypes.c_uint64 * 1)(7)
    assert lib.dynamo_tpu_kv_event_publish_stored(1, one, 1, 0, 0) == -1
    assert lib.dynamo_tpu_llm_init() == 0 and lib.dynamo_tpu_llm_init() == 0  # idempotent
    for i in range(50):
        assert lib.dynamo_tpu_kv_event_publish_stored(i, (ctypes.c_uint64 * 3)(i, i + 1, i + 2), 3, i, 1) == 0
    drained = nat.drain_kv_events()
    assert [e["worker_id"] for e in drained] == list(range(50)) and nat.drain_kv_events() == []
    assert drained[7] == {"worker_id": 7, "kind": "stored", "block_hashes": [7, 8, 9], "parent_hash": 7}
    assert nat.kv_events_dropped() == 0
    lib.dynamo_tpu_llm_shutdown()


def test_a_failed_build_raises_once_stamped(monkeypatch, tmp_path):
    calls = []

    def broken(name):
        calls.append(name)
        raise RuntimeError("c++ failed for native (exit 1):\nsyntax error")

    monkeypatch.setattr(native._build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native._build, "library_path", lambda name: tmp_path / "libnative-0000.so")
    monkeypatch.setattr(native._build, "build_host", broken)
    monkeypatch.setattr(native, "_native", None)
    with pytest.raises(RuntimeError, match="syntax error"):
        native.get_native()
    assert (tmp_path / "libnative-0000.stamp").read_text() == "fail"
    assert "syntax error" in (tmp_path / "libnative-0000.log").read_text()
    with pytest.raises(RuntimeError, match="failed to build"):
        native.get_native()
    assert calls == ["native"]  # tried once for this digest
    monkeypatch.setenv("DYN_NATIVE", "0")
    assert native.get_native() is None  # the explicit pure-Python request


def test_pure_python_path_needs_no_library(monkeypatch):
    monkeypatch.setenv("DYN_NATIVE", "0")
    toks = list(range(1, 100))
    assert p_tokens.compute_block_hashes(toks, 16) == xxhash_chain(toks, 16)
    with pytest.raises(RuntimeError, match="DYN_NATIVE=0"):
        p_capi.load_c_abi()
    assert os.environ["DYN_NATIVE"] == "0"
