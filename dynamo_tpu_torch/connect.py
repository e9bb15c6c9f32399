"""Pythonic device-to-device transfer API — the ``dynamo.nixl_connect`` role.

The counterpart of the JAX package's ``connect.py``, on the same wire: the
operations, the ``RdmaMetadata`` JSON and the frames (a header with
``seq``, ``total``, ``shape`` and ``dtype``, the buffer's bytes) are the
JAX module's, so either package reads what the other offers. A
``Descriptor`` wraps a numpy array or a torch tensor on any device.

Ref: lib/bindings/python src/dynamo/nixl_connect/__init__.py — ``Connector``
(:501) with create_readable/create_writable, ``ReadOperation`` (:1273) /
``WriteOperation``, ``Readable/WritableOperation``, ``Descriptor`` (:723,
tensor-aware), ``RdmaMetadata`` (:1417). The reference rides NIXL
(RDMA/NVLink); on TPU hosts the data plane is the runtime's TCP call-home
stream server (the same wire as response streams and disagg KV pulls), with
ICI/DCN device transfer as the intra-slice fast path above it.

Rendezvous model (mirrors nixl_connect):
- One side creates an operation over local buffers and serializes its
  :class:`RdmaMetadata`, which travels to the peer out-of-band (HTTP body,
  pubsub message, store key — anything).
- ``create_readable`` → peer calls ``begin_read(metadata, local_descs)``
  to pull the buffers. ``create_writable`` → peer calls
  ``begin_write(local_descs, metadata)`` to push into them.
- Both sides ``await op.wait_for_completion()``.

``Descriptor`` wraps a numpy array or a CPU tensor (used in place:
received bytes land in it) or a tensor on a card (its bytes cross through
the host: copied out on export, copied back in on receive);
``to_torch(device)`` returns the buffer as a tensor on ``device``.
"""

from __future__ import annotations

import asyncio
import json
import uuid
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.transports.tcp import ConnectionInfo, TcpCallHome

logger = get_logger(__name__)

_SUBJECT_PREFIX = "connect.read."


class TransferError(Exception):
    pass


class Descriptor:
    """A transferable buffer (ref: nixl_connect Descriptor :723).

    A numpy array or a CPU tensor is used in place: received bytes land in
    it. A tensor on a card is copied to the host on export, and received
    bytes are copied back into it. bfloat16 crosses as its bits, named
    ``"bfloat16"`` on the wire (numpy's name for ``ml_dtypes.bfloat16``)."""

    def __init__(self, array):
        if isinstance(array, torch.Tensor):
            self.device = array.device.type
            self._tensor, self._np = array, None
        elif isinstance(array, np.ndarray):
            self.device = "cpu"
            self._tensor, self._np = None, array
        else:
            raise TypeError(f"Descriptor wants a numpy array or a torch tensor, got {type(array)}")

    @property
    def array(self) -> np.ndarray:
        """The buffer as host numpy (bfloat16 as its 16-bit patterns)."""
        if self._np is not None:
            return self._np
        t = self._tensor.detach().cpu()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()

    @property
    def shape(self):
        return tuple(self._np.shape if self._np is not None else self._tensor.shape)

    @property
    def dtype(self) -> str:
        if self._np is not None:
            return str(self._np.dtype)
        return "bfloat16" if self._tensor.dtype == torch.bfloat16 else str(self._tensor.dtype).removeprefix("torch.")

    @property
    def nbytes(self) -> int:
        return self._np.nbytes if self._np is not None else self._tensor.numel() * self._tensor.element_size()

    def meta(self) -> dict:
        return {"shape": list(self.shape), "dtype": self.dtype}

    def tobytes(self) -> bytes:
        return self.array.tobytes()

    def to_torch(self, device="cpu") -> torch.Tensor:
        """The buffer as a tensor on ``device`` (a copy unless it is
        already there)."""
        t = self._tensor if self._np is None else torch.from_numpy(self._np)
        return t.to(device)

    def _fill(self, raw: bytes, header: dict) -> None:
        shape, dtype = tuple(header["shape"]), header["dtype"]
        if shape != self.shape or dtype != self.dtype:
            raise TransferError(f"descriptor mismatch: got {shape}/{dtype}, want {self.shape}/{self.dtype}")
        if self._np is not None:
            np.copyto(self._np, np.frombuffer(raw, dtype=self._np.dtype).reshape(shape))
            return
        if raw:
            incoming = torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(self._tensor.dtype)
            self._tensor.copy_(incoming.reshape(shape))


class RdmaMetadata:
    """Serializable rendezvous token (ref: nixl_connect RdmaMetadata :1417)."""

    def __init__(self, kind: str, nonce: str, descriptors: List[dict],
                 subject: Optional[str] = None, conn: Optional[dict] = None):
        self.kind = kind  # "readable" | "writable"
        self.nonce = nonce
        self.descriptors = descriptors
        self.subject = subject
        self.conn = conn

    def to_json(self) -> str:
        return json.dumps({
            "kind": self.kind, "nonce": self.nonce, "descriptors": self.descriptors,
            "subject": self.subject, "conn": self.conn,
        })

    @classmethod
    def from_json(cls, raw: Union[str, bytes]) -> "RdmaMetadata":
        d = json.loads(raw)
        return cls(d["kind"], d["nonce"], d["descriptors"], d.get("subject"), d.get("conn"))


class _Completable:
    def __init__(self):
        self._done = asyncio.Event()
        self._error: Optional[str] = None

    def _complete(self, error: Optional[str] = None) -> None:
        self._error = error
        self._done.set()

    async def wait_for_completion(self, timeout: Optional[float] = None) -> None:
        if timeout is None:
            await self._done.wait()
        else:
            await asyncio.wait_for(self._done.wait(), timeout)
        if self._error:
            raise TransferError(self._error)


class ReadableOperation(_Completable):
    """Local buffers a remote may pull (ref: nixl_connect ReadableOperation).
    Completes after ``remaining_reads`` pulls have been served."""

    def __init__(self, connector: "Connector", descriptors: Sequence[Descriptor], remaining_reads: int):
        super().__init__()
        self.connector = connector
        self.descriptors = list(descriptors)
        self.nonce = uuid.uuid4().hex
        self.subject = _SUBJECT_PREFIX + self.nonce
        self.remaining_reads = remaining_reads
        self._sub = None
        self._task: Optional[asyncio.Task] = None

    async def _start(self) -> None:
        self._sub = await self.connector.drt.bus.subscribe(self.subject)
        self._task = asyncio.get_running_loop().create_task(self._serve())

    async def _serve(self) -> None:
        served = 0
        try:
            async for msg in self._sub:
                try:
                    req = json.loads(msg.data)
                    call_home = TcpCallHome(ConnectionInfo.from_dict(req["conn"]))
                    if not await call_home.connect():
                        continue
                    try:
                        try:
                            for i, d in enumerate(self.descriptors):
                                await call_home.send(
                                    {"seq": i, "total": len(self.descriptors), **d.meta()},
                                    d.tobytes(),
                                )
                            await call_home.complete()
                        except Exception as e:
                            # Tell the reader why before closing — otherwise it
                            # hangs until its own wait_for_completion timeout.
                            try:
                                await call_home.error(f"serve failed: {e}")
                            except (ConnectionError, OSError):
                                pass
                            raise
                    finally:
                        await call_home.close()
                    served += 1
                    if served >= self.remaining_reads:
                        self._complete()
                        return
                except (ConnectionError, OSError, ValueError, KeyError) as e:
                    logger.warning("readable %s: serve failed: %s", self.nonce, e)
        except asyncio.CancelledError:
            pass
        finally:
            # Drop the broker subscription whether we completed, were
            # cancelled, or the subscription closed — a long-lived worker
            # creates one op per transfer and must not leak subscribers.
            if self._sub is not None:
                await self._sub.unsubscribe()
                self._sub = None

    def metadata(self) -> RdmaMetadata:
        return RdmaMetadata(
            "readable", self.nonce, [d.meta() for d in self.descriptors], subject=self.subject
        )

    async def cancel(self) -> None:
        if self._task is not None:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)
        if self._sub is not None:
            await self._sub.unsubscribe()
            self._sub = None
        if not self._done.is_set():
            self._complete("cancelled")


class WritableOperation(_Completable):
    """Local buffers a remote will push into (ref: WritableOperation)."""

    def __init__(self, connector: "Connector", descriptors: Sequence[Descriptor]):
        super().__init__()
        self.connector = connector
        self.descriptors = list(descriptors)
        self.nonce = uuid.uuid4().hex
        self.conn_info, self._pending = connector.drt.tcp_server_handle().register()
        self._task: Optional[asyncio.Task] = None

    async def _start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._receive())

    async def _receive(self) -> None:
        filled = set()
        try:
            async for frame in self._pending.frames():
                if frame.kind == "data":
                    seq = int(frame.header["seq"])
                    if not 0 <= seq < len(self.descriptors):
                        self._complete(f"bad descriptor index {seq}")
                        return
                    self.descriptors[seq]._fill(frame.body, frame.header)
                    filled.add(seq)
                elif frame.kind == "error":
                    self._complete(frame.header.get("message", "write failed"))
                    return
            # Stream ended cleanly: only complete if every descriptor landed —
            # a short write (peer stopped early, count mismatch) must surface,
            # not yield silently stale buffers.
            if len(filled) < len(self.descriptors):
                self._complete(f"short write: {len(filled)}/{len(self.descriptors)} descriptors filled")
            else:
                self._complete()
        except (TransferError, ValueError, KeyError, TypeError) as e:
            # Malformed frame or unwritable destination: the op must still
            # complete (with the error) or waiters hang forever.
            self._complete(str(e))
        finally:
            self.connector.drt.tcp_server_handle().unregister(self.conn_info.stream_id)

    def metadata(self) -> RdmaMetadata:
        return RdmaMetadata(
            "writable", self.nonce, [d.meta() for d in self.descriptors],
            conn=self.conn_info.to_dict(),
        )


class ReadOperation(_Completable):
    """Pull a remote readable's buffers into local descriptors."""

    def __init__(self, connector: "Connector", metadata: RdmaMetadata, descriptors: Sequence[Descriptor]):
        super().__init__()
        if metadata.kind != "readable":
            raise ValueError("begin_read needs metadata from a ReadableOperation")
        self.connector = connector
        self.metadata_ = metadata
        self.descriptors = list(descriptors)
        self._task: Optional[asyncio.Task] = None

    async def _start(self) -> None:
        conn_info, pending = self.connector.drt.tcp_server_handle().register()
        await self.connector.drt.bus.publish(
            self.metadata_.subject, json.dumps({"conn": conn_info.to_dict()}).encode()
        )

        async def receive():
            filled = set()
            try:
                async for frame in pending.frames():
                    if frame.kind == "data":
                        seq = int(frame.header["seq"])
                        if not 0 <= seq < len(self.descriptors):
                            self._complete(f"bad descriptor index {seq}")
                            return
                        self.descriptors[seq]._fill(frame.body, frame.header)
                        filled.add(seq)
                    elif frame.kind == "error":
                        self._complete(frame.header.get("message", "read failed"))
                        return
                # A serve that stopped early must fail the read, not succeed
                # with stale/zero local buffers.
                if len(filled) < len(self.descriptors):
                    self._complete(f"short read: {len(filled)}/{len(self.descriptors)} descriptors filled")
                else:
                    self._complete()
            except (TransferError, ValueError, KeyError, TypeError) as e:
                self._complete(str(e))
            finally:
                self.connector.drt.tcp_server_handle().unregister(conn_info.stream_id)

        self._task = asyncio.get_running_loop().create_task(receive())


class WriteOperation(_Completable):
    """Push local descriptors into a remote writable."""

    def __init__(self, connector: "Connector", descriptors: Sequence[Descriptor], metadata: RdmaMetadata):
        super().__init__()
        if metadata.kind != "writable":
            raise ValueError("begin_write needs metadata from a WritableOperation")
        self.connector = connector
        self.metadata_ = metadata
        self.descriptors = list(descriptors)
        self._task: Optional[asyncio.Task] = None

    async def _start(self) -> None:
        async def push():
            call_home = TcpCallHome(ConnectionInfo.from_dict(self.metadata_.conn))
            try:
                if not await call_home.connect():
                    self._complete("remote writable rejected connection")
                    return
                for i, d in enumerate(self.descriptors):
                    await call_home.send(
                        {"seq": i, "total": len(self.descriptors), **d.meta()}, d.tobytes()
                    )
                await call_home.complete()
                self._complete()
            except (ConnectionError, OSError) as e:
                self._complete(f"write failed: {e}")
            finally:
                await call_home.close()

        self._task = asyncio.get_running_loop().create_task(push())


class Connector:
    """Factory bound to a DistributedRuntime (ref: nixl_connect Connector)."""

    def __init__(self, drt):
        self.drt = drt

    async def create_readable(
        self, *descriptors: Descriptor, remaining_reads: int = 1
    ) -> ReadableOperation:
        op = ReadableOperation(self, descriptors, remaining_reads)
        await op._start()
        return op

    async def create_writable(self, *descriptors: Descriptor) -> WritableOperation:
        op = WritableOperation(self, descriptors)
        await op._start()
        return op

    async def begin_read(
        self, metadata: Union[RdmaMetadata, str, bytes], *descriptors: Descriptor
    ) -> ReadOperation:
        if not isinstance(metadata, RdmaMetadata):
            metadata = RdmaMetadata.from_json(metadata)
        op = ReadOperation(self, metadata, descriptors)
        await op._start()
        return op

    async def begin_write(
        self, metadata: Union[RdmaMetadata, str, bytes], *descriptors: Descriptor
    ) -> WriteOperation:
        if not isinstance(metadata, RdmaMetadata):
            metadata = RdmaMetadata.from_json(metadata)
        op = WriteOperation(self, descriptors, metadata)
        await op._start()
        return op
