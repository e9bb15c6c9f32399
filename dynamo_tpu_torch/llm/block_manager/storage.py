"""KVBM tier storage: host pool (G2), disk pool (G3), remote pool (G4).

The counterpart of the JAX package's ``llm/block_manager/storage.py``, with
its LRU and spill rules. Host blocks are CPU tensors. A block on disk or in
the object store is the ``.npz`` the JAX package writes (``np.savez(f, k=k,
v=v)``): the bytes are the same for the same block, so a block one package
spilled onboards in the other.

The card's machine has no ``ml_dtypes``, so bfloat16 is written and read
by hand: its ``.npy`` members carry the descr ``'<V2'`` (what numpy writes
for ``ml_dtypes.bfloat16``) over the raw bf16 bits, and on the way back a
2-byte void array (``'<V2'`` reads back as ``'|V2'``) is taken as bf16
bits, ``'<f4'`` as float32. The JAX package cannot onboard a bf16 block from
G3 or G4 (``np.load`` gives it a void array JAX refuses); this one can.
"""

from __future__ import annotations

import asyncio
import io
import os
import time
import zipfile
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

Block = Tuple[torch.Tensor, torch.Tensor]

# The descr numpy writes for a plain 2-byte void array, and for ml_dtypes'
# bfloat16: the same length, so the header's padding does not change.
_VOID_DESCR = b"'descr': '|V2'"
_BF16_DESCR = b"'descr': '<V2'"


def _npy_bytes(t: torch.Tensor) -> bytes:
    """One ``.npy`` member, byte-equal to ``np.lib.format.write_array`` of
    the same array under numpy (with ``ml_dtypes`` for bfloat16)."""
    t = t.detach().cpu().contiguous()
    buf = io.BytesIO()
    if t.dtype == torch.bfloat16:
        arr = t.view(torch.int16).numpy().view(np.dtype("V2"))
        np.lib.format.write_array(buf, arr, allow_pickle=False)
        raw = buf.getvalue()
        head = raw.index(b"\n") + 1
        if _VOID_DESCR not in raw[:head]:
            raise ValueError("unexpected .npy header for a 2-byte void array")
        return raw[:head].replace(_VOID_DESCR, _BF16_DESCR, 1) + raw[head:]
    np.lib.format.write_array(buf, t.numpy(), allow_pickle=False)
    return buf.getvalue()


def block_npz_bytes(k: torch.Tensor, v: torch.Tensor) -> bytes:
    """``np.savez(f, k=k, v=v)``'s bytes for a block: zip members stored
    uncompressed, each opened with zip64 forced, as numpy writes them."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, mode="w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, t in (("k", k), ("v", v)):
            with zf.open(name + ".npy", "w", force_zip64=True) as fid:
                fid.write(_npy_bytes(t))
    return buf.getvalue()


def _tensor_of(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy()).view(torch.bfloat16)
    if arr.dtype == np.float32:
        return torch.from_numpy(np.ascontiguousarray(arr).copy())
    raise ValueError(f"unsupported KV block dtype {arr.dtype!r}")


def read_block_npz(src) -> Block:
    """A block ``.npz`` (a path, a file or bytes) → ``(k, v)`` CPU tensors
    (bfloat16 for ``'<V2'`` / ``'|V2'`` members, float32 for ``'<f4'``)."""
    if isinstance(src, (bytes, bytearray)):
        src = io.BytesIO(src)
    with np.load(src, allow_pickle=False) as z:
        return _tensor_of(z["k"]), _tensor_of(z["v"])


class HostPool:
    """LRU pool of KV block pairs in host memory. ``put`` may spill the LRU
    entry: it is returned to the caller for the cascade to the next tier."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._data: "OrderedDict[int, Block]" = OrderedDict()

    def has(self, block_hash: int) -> bool:
        return block_hash in self._data

    def put(self, block_hash: int, k: torch.Tensor, v: torch.Tensor) -> Optional[Tuple[int, torch.Tensor, torch.Tensor]]:
        spilled = None
        if block_hash in self._data:
            self._data.move_to_end(block_hash)
            return None
        if len(self._data) >= self.capacity:
            h, (sk, sv) = self._data.popitem(last=False)
            spilled = (h, sk, sv)
        self._data[block_hash] = (k, v)
        return spilled

    def get(self, block_hash: int) -> Optional[Block]:
        entry = self._data.get(block_hash)
        if entry is not None:
            self._data.move_to_end(block_hash)
        return entry

    def usage(self) -> float:
        return len(self._data) / max(self.capacity, 1)

    def clear(self) -> int:
        n = len(self._data)
        self._data.clear()
        return n

    def __len__(self) -> int:
        return len(self._data)


class DiskPool:
    """File-per-block spill tier: one ``{hash:016x}.npz`` a block, LRU in
    memory. A new pool over an existing directory recovers its blocks (a
    restart resumes with them)."""

    def __init__(self, directory: str, capacity: int):
        self.directory = directory
        self.capacity = capacity
        os.makedirs(directory, exist_ok=True)
        self._index: "OrderedDict[int, str]" = OrderedDict()
        for fname in sorted(os.listdir(directory)):
            if fname.endswith(".npz"):
                try:
                    self._index[int(fname[:-4], 16)] = os.path.join(directory, fname)
                except ValueError:
                    continue

    def _path(self, block_hash: int) -> str:
        return os.path.join(self.directory, f"{block_hash & 0xFFFFFFFFFFFFFFFF:016x}.npz")

    def has(self, block_hash: int) -> bool:
        return block_hash in self._index

    def put(self, block_hash: int, k: torch.Tensor, v: torch.Tensor) -> Optional[Tuple[int, torch.Tensor, torch.Tensor]]:
        """Store a block; returns the LRU entry evicted to make room (for the
        cascade to the next tier), or None."""
        if block_hash in self._index:
            return None
        spilled = None
        while len(self._index) >= self.capacity:
            h, path = self._index.popitem(last=False)
            try:
                if spilled is None:
                    spilled = (h, *read_block_npz(path))
            except (OSError, KeyError, ValueError):
                pass  # an unreadable block: nothing to cascade
            finally:
                try:
                    os.remove(path)  # the file goes, readable or not
                except OSError:
                    pass
        path = self._path(block_hash)
        with open(path, "wb") as f:
            f.write(block_npz_bytes(k, v))
        self._index[block_hash] = path
        return spilled

    def get(self, block_hash: int) -> Optional[Block]:
        path = self._index.get(block_hash)
        if path is None:
            return None
        try:
            block = read_block_npz(path)
        except (OSError, KeyError, ValueError):
            self._index.pop(block_hash, None)
            return None
        self._index.move_to_end(block_hash)
        return block

    def usage(self) -> float:
        return len(self._index) / max(self.capacity, 1)

    def clear(self) -> int:
        n = len(self._index)
        for path in self._index.values():
            try:
                os.remove(path)
            except OSError:
                pass
        self._index.clear()
        return n

    def __len__(self) -> int:
        return len(self._index)


class RemotePool:
    """G4: blocks under hash-addressed names in a bucket of the control
    plane's object store, so a block one worker spilled onboards in any
    other.

    The pool is called from the engine's step thread while the store client
    lives on the event loop, so every store call goes through
    ``run_coroutine_threadsafe``: ``put`` does not wait (the eviction hook
    must not stall on a round trip); ``has`` answers from a listing
    refreshed at most every ``refresh_s``, and backs off for as long after a
    failed listing (a prefix walk probes many hashes); ``get`` waits up to
    ``timeout_s``. A call from the loop's own thread would deadlock, and
    raises instead."""

    def __init__(self, drt, loop: asyncio.AbstractEventLoop, *, bucket: str = "kvbm-g4",
                 timeout_s: float = 5.0, refresh_s: float = 1.0):
        self.drt = drt
        self.loop = loop
        self.bucket_name = bucket
        self.timeout_s = timeout_s
        self.refresh_s = refresh_s
        self._known: set = set()
        self._listed_at = 0.0

    def _assert_worker_thread(self) -> None:
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is self.loop:
            raise RuntimeError("RemotePool must be called from a worker thread, not the event loop")

    def _call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(self.timeout_s)

    async def _bucket(self):
        return await self.drt.bus.object_store(self.bucket_name)

    @staticmethod
    def _name(block_hash: int) -> str:
        return f"{block_hash & 0xFFFFFFFFFFFFFFFF:016x}"

    def has(self, block_hash: int) -> bool:
        if block_hash in self._known:
            return True
        self._assert_worker_thread()
        now = time.monotonic()
        if now - self._listed_at >= self.refresh_s:
            async def _list():
                return await (await self._bucket()).list()

            try:
                names = self._call(_list())
            except Exception:  # noqa: BLE001 — a flaky store must not fail matching
                self._listed_at = now
                return False
            self._known = set()
            for n in names:
                try:
                    self._known.add(int(n, 16))
                except ValueError:
                    continue
            self._listed_at = now
        return block_hash in self._known

    def put(self, block_hash: int, k: torch.Tensor, v: torch.Tensor) -> None:
        data = block_npz_bytes(k, v)

        async def _put():
            await (await self._bucket()).put(self._name(block_hash), data)

        asyncio.run_coroutine_threadsafe(_put(), self.loop)
        self._known.add(block_hash)

    def get(self, block_hash: int) -> Optional[Block]:
        self._assert_worker_thread()

        async def _get():
            return await (await self._bucket()).get(self._name(block_hash))

        try:
            data = self._call(_get())
        except Exception:  # noqa: BLE001
            return None
        if data is None:
            self._known.discard(block_hash)
            return None
        return read_block_npz(data)

    def __len__(self) -> int:
        return len(self._known)
