"""C ABI bridge: KV events published by a native runtime.

A copy of the JAX package's ``llm/c_api.py`` over the port's host library
(``csrc/native.cc``, loaded with ``ctypes`` by ``native.py``; the JAX
package's is a CPython extension). A C++ component (a custom data loader,
a native engine runtime) calls the library's ``extern "C"`` functions

    int dynamo_tpu_llm_init(void);
    int dynamo_tpu_llm_shutdown(void);
    int dynamo_tpu_kv_event_publish_stored(uint64_t worker_id,
        const uint64_t* hashes, size_t n, uint64_t parent, int has_parent);
    int dynamo_tpu_kv_event_publish_removed(uint64_t worker_id,
        const uint64_t* hashes, size_t n);

without holding the GIL; the events wait in a mutex-guarded queue inside
the library, and :class:`NativeKvEventSource` pumps them into the port's
``KvEventPublisher`` and on to the router.

``load_c_abi()`` returns a ``ctypes`` handle to those functions (what an
out-of-process C client would ``dlopen``).
"""

from __future__ import annotations

import asyncio
import ctypes
from typing import Optional

from dynamo_tpu_torch.engine.kv_cache import KvEvent
from dynamo_tpu_torch.native import get_native
from dynamo_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)


def _native():
    native = get_native()
    if native is None:
        raise RuntimeError("the port's host library is off (DYN_NATIVE=0): the C ABI lives in it")
    return native


def load_c_abi() -> ctypes.CDLL:
    """``ctypes`` handle to the library's C ABI (built at first use)."""
    lib = ctypes.CDLL(_native().path)
    lib.dynamo_tpu_llm_init.restype = ctypes.c_int
    lib.dynamo_tpu_llm_shutdown.restype = ctypes.c_int
    lib.dynamo_tpu_kv_event_publish_stored.restype = ctypes.c_int
    lib.dynamo_tpu_kv_event_publish_stored.argtypes = [
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
        ctypes.c_uint64, ctypes.c_int,
    ]
    lib.dynamo_tpu_kv_event_publish_removed.restype = ctypes.c_int
    lib.dynamo_tpu_kv_event_publish_removed.argtypes = [
        ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64), ctypes.c_size_t,
    ]
    return lib


class NativeKvEventSource:
    """Pump C-ABI-queued KV events into a KvEventPublisher."""

    def __init__(self, publisher, poll_interval_s: float = 0.05):
        self.publisher = publisher
        self.poll_interval_s = poll_interval_s
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()
        self.events_pumped = 0

    def start(self) -> None:
        self._native = _native()
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def _loop(self) -> None:
        while not self._stop.is_set():
            for ev in self._native.drain_kv_events():
                self.publisher.publish(
                    KvEvent(
                        kind=ev["kind"],
                        block_hashes=ev["block_hashes"],
                        parent_hash=ev["parent_hash"],
                    )
                )
                self.events_pumped += 1
            try:
                await asyncio.wait_for(self._stop.wait(), timeout=self.poll_interval_s)
            except asyncio.TimeoutError:
                pass

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            await self._task
            self._task = None
