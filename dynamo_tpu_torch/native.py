"""The port's host library (``csrc/native.cc``) through ``ctypes``: chained
xxh3 block hashing, the router's radix tree and the KV-event queue of the C
ABI (``llm/c_api.py``).

The library builds with the host compiler at first use (``_build.build_host``:
``c++ -O3 -std=c++17 -shared -fPIC`` into ``build/dynamo_tpu_torch/``, keyed
by the source's digest). A file lock serializes processes building it at once (a
frontend and its workers starting together), and a stamp beside the library
records the outcome for that digest, so a failed build is tried once per
source change: it raises, naming the compiler's log, in the process that
tried and in every later one. Nothing falls back silently. ``DYN_NATIVE=0``
is an explicit request for the pure-Python path (``llm/tokens.py``'s
hashing, ``RadixTree``): ``get_native()`` then returns None.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dynamo_tpu_torch import _build

NAME = "native"

_native: Optional["Native"] = None
_mutex = threading.Lock()

_P = ctypes.c_void_p
_U64 = ctypes.c_uint64
_SIZE = ctypes.c_size_t


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _u64(values: Sequence[int]) -> np.ndarray:
    return np.ascontiguousarray(values, dtype=np.uint64)


class Tree:
    """One radix tree in the library (``RadixTree``'s operations)."""

    def __init__(self, native: "Native"):
        self._lib = native.lib
        self._h = self._lib.dtn_tree_new()
        if not self._h:
            raise MemoryError("dtn_tree_new failed")

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.dtn_tree_free(h)

    def apply_stored(self, worker: int, block_hashes: Sequence[int], parent_hash: Optional[int]) -> None:
        a = _u64(block_hashes)
        self._lib.dtn_tree_apply_stored(self._h, worker, _ptr(a), len(a), parent_hash or 0,
                                        int(parent_hash is not None))

    def apply_removed(self, worker: int, block_hashes: Sequence[int]) -> None:
        a = _u64(block_hashes)
        self._lib.dtn_tree_apply_removed(self._h, worker, _ptr(a), len(a))

    def remove_worker(self, worker: int) -> None:
        self._lib.dtn_tree_remove_worker(self._h, worker)

    def find_matches(self, block_hashes: Sequence[int], early_exit: bool = False) -> Dict[int, int]:
        a = _u64(block_hashes)
        cap = max(1, self._lib.dtn_tree_worker_count(self._h))
        ws, sc = np.empty(cap, np.uint64), np.empty(cap, np.int64)
        k = self._lib.dtn_tree_find_matches(self._h, _ptr(a), len(a), int(early_exit), _ptr(ws), _ptr(sc), cap)
        return dict(zip(ws[:k].tolist(), sc[:k].tolist()))

    def size(self) -> int:
        return self._lib.dtn_tree_size(self._h)

    def workers(self) -> List[int]:
        cap = self._lib.dtn_tree_worker_count(self._h)
        out = np.empty(max(1, cap), np.uint64)
        k = self._lib.dtn_tree_workers(self._h, _ptr(out), cap)
        return out[:k].tolist()

    def dump_records(self) -> List[Tuple[int, Optional[int], List[int]]]:
        """(hash, parent hash or None, sorted workers), parents before children."""
        n, m = _SIZE(), _SIZE()
        self._lib.dtn_tree_dump_sizes(self._h, ctypes.byref(n), ctypes.byref(m))
        n, m = n.value, m.value
        hashes, parents = np.empty(max(1, n), np.uint64), np.empty(max(1, n), np.uint64)
        has_parent, counts = np.empty(max(1, n), np.int32), np.empty(max(1, n), np.uint32)
        workers = np.empty(max(1, m), np.uint64)
        self._lib.dtn_tree_dump(self._h, _ptr(hashes), _ptr(parents), _ptr(has_parent), _ptr(counts), _ptr(workers))
        ends = np.cumsum(counts[:n]).tolist()
        ws = workers[:m].tolist()
        return [(h, p if hp else None, ws[e - c:e])
                for h, p, hp, c, e in zip(hashes[:n].tolist(), parents[:n].tolist(), has_parent[:n].tolist(),
                                          counts[:n].tolist(), ends)]

    def clear(self) -> None:
        self._lib.dtn_tree_clear(self._h)


class Native:
    """The loaded library: hashing, ``Tree`` and the KV-event queue."""

    def __init__(self, lib: ctypes.CDLL, path: str):
        self.lib, self.path = lib, path
        sig = {
            "dtn_hash_tokens": (ctypes.c_int, [_P, _SIZE, _U64, _P]),
            "dtn_hash_token_blocks": (ctypes.c_long, [_P, _SIZE, _SIZE, _U64, _P]),
            "dtn_tree_new": (_P, []),
            "dtn_tree_free": (None, [_P]),
            "dtn_tree_clear": (None, [_P]),
            "dtn_tree_apply_stored": (None, [_P, _U64, _P, _SIZE, _U64, ctypes.c_int]),
            "dtn_tree_apply_removed": (None, [_P, _U64, _P, _SIZE]),
            "dtn_tree_remove_worker": (None, [_P, _U64]),
            "dtn_tree_size": (_SIZE, [_P]),
            "dtn_tree_worker_count": (_SIZE, [_P]),
            "dtn_tree_find_matches": (_SIZE, [_P, _P, _SIZE, ctypes.c_int, _P, _P, _SIZE]),
            "dtn_tree_workers": (_SIZE, [_P, _P, _SIZE]),
            "dtn_tree_dump_sizes": (None, [_P, _P, _P]),
            "dtn_tree_dump": (None, [_P, _P, _P, _P, _P, _P]),
            "dtn_kv_events_pending": (None, [_P, _P]),
            "dtn_kv_events_drain": (_SIZE, [_P, _P, _P, _P, _P, _P, _SIZE, _SIZE]),
            "dtn_kv_events_dropped": (_U64, []),
        }
        for name, (res, args) in sig.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args

    def hash_tokens(self, tokens: Sequence[int], seed: int) -> int:
        """xxh3_64 over the little-endian u32 ids (at most 60 of them)."""
        a = np.ascontiguousarray(tokens, dtype=np.uint32)
        out = _U64()
        if self.lib.dtn_hash_tokens(_ptr(a), len(a), seed, ctypes.byref(out)) != 0:
            raise ValueError(f"xxh3_64 here covers inputs up to 240 bytes, got {4 * len(a)}")
        return out.value

    def hash_token_blocks(self, tokens: Sequence[int], block_size: int, seed: int) -> List[int]:
        """Chained hashes of every complete block, the first seeded with ``seed``."""
        a = np.ascontiguousarray(tokens, dtype=np.uint32)
        out = np.empty(max(1, len(a) // max(1, block_size)), np.uint64)
        n = self.lib.dtn_hash_token_blocks(_ptr(a), len(a), block_size, seed, _ptr(out))
        if n < 0:
            raise ValueError(f"xxh3_64 here covers inputs up to 240 bytes, got blocks of {4 * block_size}")
        return out[:n].tolist()

    def RadixTree(self) -> Tree:  # noqa: N802 (the JAX package's extension names its type so)
        return Tree(self)

    def drain_kv_events(self) -> List[dict]:
        """Pop every event queued through the C ABI, in order, as the JAX
        extension's dicts: worker_id, kind, block_hashes, parent_hash."""
        out: List[dict] = []
        while True:
            ne, nh = _SIZE(), _SIZE()
            self.lib.dtn_kv_events_pending(ctypes.byref(ne), ctypes.byref(nh))
            if not ne.value:
                return out
            e, h = ne.value, max(1, nh.value)
            wid, parent, counts = np.empty(e, np.uint64), np.empty(e, np.uint64), np.empty(e, np.uint64)
            kinds, has_parent, hashes = np.empty(e, np.int32), np.empty(e, np.int32), np.empty(h, np.uint64)
            k = self.lib.dtn_kv_events_drain(_ptr(wid), _ptr(kinds), _ptr(parent), _ptr(has_parent), _ptr(counts),
                                             _ptr(hashes), e, h)
            ends = np.cumsum(counts[:k]).tolist()
            flat = hashes.tolist()
            for i in range(k):
                c = int(counts[i])
                out.append({"worker_id": int(wid[i]), "kind": "stored" if kinds[i] == 0 else "removed",
                            "block_hashes": flat[ends[i] - c:ends[i]],
                            "parent_hash": int(parent[i]) if has_parent[i] else None})
            if not k:
                return out

    def kv_events_dropped(self) -> int:
        return self.lib.dtn_kv_events_dropped()


@contextlib.contextmanager
def _build_lock():
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd = os.open(_build.BUILD_DIR / f"{NAME}.lock", os.O_CREAT | os.O_RDWR)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def _load() -> Native:
    path = _build.library_path(NAME)
    stamp, log = path.with_suffix(".stamp"), path.with_suffix(".log")
    with _build_lock():  # another process may be building this digest
        if stamp.exists() and stamp.read_text() == "fail":
            raise RuntimeError(f"the port's host library failed to build from csrc/{NAME}.cc; see {log}")
        if not path.exists():
            try:
                res = _build.build_host(NAME)
            except RuntimeError as e:
                log.write_text(str(e))
                stamp.write_text("fail")
                raise
            log.write_text(res["log"])
            stamp.write_text("ok")
    return Native(_build.load(NAME), str(path))


def get_native() -> Optional[Native]:
    """The host library, built and loaded at the first call; None when
    ``DYN_NATIVE=0`` asks for the pure-Python path. Raises if it cannot be
    built."""
    global _native
    if os.environ.get("DYN_NATIVE", "1") == "0":
        return None
    with _mutex:
        if _native is None:
            _native = _load()
        return _native


def available() -> bool:
    return get_native() is not None
