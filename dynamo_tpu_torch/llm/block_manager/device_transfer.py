"""Device-to-device KV transfer between processes: the NIXL role on a card.

The counterpart of the JAX package's ``llm/block_manager/device_transfer.py``,
which rides ``jax.experimental.transfer``. Here the producer shares the
export's stacked tensors through CUDA IPC (PyTorch's own: a memory handle,
the storage's offset, a reference counter and an event the consumer waits
on), and the consumer opens the handle, copies the blocks into a tensor of
its own, waits for the copy and drops the handle. The rendezvous metadata
(``offer``'s return: the handles, shapes, strides and dtypes) travels
out of band on the control plane's TCP frames, like ``RdmaMetadata``.
The same model holds on the CPU with shared-memory files in place of CUDA
handles, so the protocol runs between two CPU processes too.

The producer keeps each offered tensor alive until the consumer acks its
pull (``release_offer``) or a TTL passes: PyTorch's caching allocator
must not hand its memory to another tensor while a consumer may read it.
Both processes must see the same card. The metadata differs from the JAX
package's (no JAX worker could open a CUDA handle anyway), so device mode
is port to port; a process cannot open its own handle, and two engines of
one process hand the stack over directly (``llm/disagg._LOCAL_EXPORTERS``).
Nothing here falls back to a host copy: a handle that cannot be made or
opened raises.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Dict, List

import torch

from dynamo_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)

_DTYPES = {str(d): d for d in (torch.bfloat16, torch.float32, torch.float16, torch.int8)}


def _uuid_of(request_id: str) -> int:
    return int.from_bytes(hashlib.blake2s(request_id.encode(), digest_size=8).digest(), "big") >> 1


def _share(t: torch.Tensor) -> dict:
    """A tensor's IPC description (msgpack-able: ints, str and bytes)."""
    t = t.detach()
    if not t.is_contiguous():
        raise ValueError("only contiguous tensors are offered")
    desc = {"shape": list(t.shape), "stride": list(t.stride()), "offset": t.storage_offset(),
            "dtype": str(t.dtype)}
    storage = t.untyped_storage()
    if t.is_cuda:
        try:
            (device, handle, size_bytes, offset_bytes, rc_handle, rc_offset, ev_handle,
             ev_sync) = storage._share_cuda_()
        except RuntimeError as e:
            raise RuntimeError(
                f"CUDA IPC cannot share the export ({e}); the caching allocator's settings "
                f"(PYTORCH_CUDA_ALLOC_CONF={os.environ.get('PYTORCH_CUDA_ALLOC_CONF', '')!r}) "
                "must allow cudaIpcGetMemHandle") from e
        desc["cuda"] = {"device": int(device), "handle": bytes(handle), "size_bytes": int(size_bytes),
                        "offset_bytes": int(offset_bytes), "rc_handle": bytes(rc_handle),
                        "rc_offset": int(rc_offset), "event_handle": bytes(ev_handle or b""),
                        "event_sync": bool(ev_sync)}
    else:
        manager, filename, size = storage._share_filename_cpu_()
        desc["cpu"] = {"manager": bytes(manager), "filename": bytes(filename), "size": int(size)}
    return desc


def _open(desc: dict, device: torch.device) -> torch.Tensor:
    """The offered tensor, mapped in this process (no copy yet)."""
    if "cuda" in desc:
        c = desc["cuda"]
        torch.cuda._lazy_init()
        storage = torch.UntypedStorage._new_shared_cuda(
            c["device"], c["handle"], c["size_bytes"], c["offset_bytes"], c["rc_handle"], c["rc_offset"],
            c["event_handle"] or None, c["event_sync"])
    else:
        c = desc["cpu"]
        storage = torch.UntypedStorage._new_shared_filename_cpu(c["manager"], c["filename"], c["size"])
    t = torch.empty((0,), dtype=_DTYPES[desc["dtype"]], device=storage.device)
    return t.set_(storage, desc["offset"], desc["shape"], desc["stride"])


class DeviceTransferPlane:
    """One a process: the producer's offers and the consumer's pulls."""

    def __init__(self):
        self._offers: Dict[int, List[torch.Tensor]] = {}  # uuid → tensors, kept alive until acked
        self._lock = threading.Lock()

    # --- producer side ------------------------------------------------------
    def offer(self, request_id: str, tensors: List[torch.Tensor]) -> dict:
        """Share ``tensors`` for a one-sided pull; returns the rendezvous
        metadata for the consumer."""
        uuid = _uuid_of(request_id)
        tensors = [t.contiguous() for t in tensors]
        descs = [_share(t) for t in tensors]
        with self._lock:
            self._offers[uuid] = tensors
        return {"pid": os.getpid(), "uuid": uuid, "tensors": descs}

    def release_offer(self, request_id: str) -> None:
        with self._lock:
            self._offers.pop(_uuid_of(request_id), None)

    @property
    def offers(self) -> int:
        return len(self._offers)

    # --- consumer side ------------------------------------------------------
    def pull(self, meta: dict, device: torch.device) -> List[torch.Tensor]:
        """Copy the offered tensors onto ``device``; returns once the copies
        are complete (the producer may free its tensors after the ack)."""
        if meta["pid"] == os.getpid():
            raise RuntimeError("a process cannot open its own IPC handles: hand the stack over in process")
        out = []
        for desc in meta["tensors"]:
            src = _open(desc, device)
            out.append(src.to(device, copy=True))
            del src
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        return out


_plane = None


def get_plane() -> DeviceTransferPlane:
    """The process-wide plane."""
    global _plane
    if _plane is None:
        _plane = DeviceTransferPlane()
    return _plane
