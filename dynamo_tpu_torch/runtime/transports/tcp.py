"""TCP response plane: call-home response streaming.

A copy of the JAX package's ``runtime/transports/tcp.py``, on the same wire:
1. The caller (frontend or router) holds a lazily started
   :class:`TcpStreamServer` and registers a pending stream id before it
   pushes a request over pub/sub; the request carries
   ``ConnectionInfo{address, stream_id}``.
2. The worker handling the request connects back ("call home"), sends a
   prologue frame naming the stream, then response frames, then a
   ``complete`` frame.
3. The caller's registered queue receives the decoded frames as they come.

Frames: ``[u32 header_len][u32 body_len][header][body]`` (big-endian
lengths). The header is a msgpack map (``runtime/msgpack_codec.py``, the
bytes the ``msgpack`` package writes), the body a payload of raw bytes.
"""

from __future__ import annotations

import asyncio
import struct
import uuid
from dataclasses import dataclass
from typing import AsyncIterator, Dict, Optional, Tuple

from dynamo_tpu_torch.runtime import msgpack_codec as msgpack

_LEN = struct.Struct(">II")
MAX_FRAME = 256 * 1024 * 1024  # KV blocks can be large


class CodecError(Exception):
    pass


def encode_frame(header: dict, body: bytes = b"") -> bytes:
    h = msgpack.packb(header)
    return _LEN.pack(len(h), len(body)) + h + body


async def read_frame(reader: asyncio.StreamReader) -> Tuple[dict, bytes]:
    raw = await reader.readexactly(_LEN.size)
    hlen, blen = _LEN.unpack(raw)
    if hlen > MAX_FRAME or blen > MAX_FRAME:
        raise CodecError(f"frame too large: header={hlen} body={blen}")
    h = await reader.readexactly(hlen) if hlen else b""
    b = await reader.readexactly(blen) if blen else b""
    header = msgpack.unpackb(h) if h else {}
    return header, b


@dataclass
class ConnectionInfo:
    """Where the worker should call home (rides inside the pushed request)."""

    address: str  # "host:port"
    stream_id: str

    def to_dict(self) -> dict:
        return {"address": self.address, "stream_id": self.stream_id}

    @classmethod
    def from_dict(cls, d: dict) -> "ConnectionInfo":
        return cls(address=d["address"], stream_id=d["stream_id"])


@dataclass
class Frame:
    """A decoded response frame."""

    kind: str  # "prologue" | "data" | "complete" | "error"
    header: dict
    body: bytes = b""


class PendingStream:
    """Caller-side handle: an async iterator over incoming frames."""

    def __init__(self, stream_id: str):
        self.stream_id = stream_id
        self.queue: "asyncio.Queue[Optional[Frame]]" = asyncio.Queue()
        self.connected = asyncio.Event()

    async def frames(self) -> AsyncIterator[Frame]:
        while True:
            frame = await self.queue.get()
            if frame is None:
                return
            yield frame
            if frame.kind in ("complete", "error"):
                return


class TcpStreamServer:
    """Lazily-started response-plane listener.

    One per process; all in-flight requests multiplex onto it via stream ids.
    """

    def __init__(self, host: str = "0.0.0.0", port: int = 0, advertise_host: Optional[str] = None):
        self._host = host
        self._port = port
        self._advertise_host = advertise_host or "127.0.0.1"
        self._server: Optional[asyncio.AbstractServer] = None
        self._pending: Dict[str, PendingStream] = {}
        self._lock = asyncio.Lock()

    async def start(self) -> None:
        async with self._lock:
            if self._server is not None:
                return
            self._server = await asyncio.start_server(self._handle_conn, self._host, self._port)
            self._port = self._server.sockets[0].getsockname()[1]

    @property
    def address(self) -> str:
        assert self._server is not None, "server not started"
        return f"{self._advertise_host}:{self._port}"

    def register(self) -> Tuple[ConnectionInfo, PendingStream]:
        stream_id = uuid.uuid4().hex
        pending = PendingStream(stream_id)
        self._pending[stream_id] = pending
        return ConnectionInfo(address=self.address, stream_id=stream_id), pending

    def unregister(self, stream_id: str) -> None:
        pending = self._pending.pop(stream_id, None)
        if pending is not None:
            pending.queue.put_nowait(None)

    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        pending: Optional[PendingStream] = None
        try:
            # The first frame must be the prologue.
            header, body = await read_frame(reader)
            if header.get("kind") != "prologue":
                writer.close()
                return
            stream_id = header.get("stream_id", "")
            pending = self._pending.get(stream_id)
            if pending is None:
                # Stale stream (caller gone / timed out) — tell worker to stop.
                writer.write(encode_frame({"kind": "nack"}))
                await writer.drain()
                writer.close()
                return
            writer.write(encode_frame({"kind": "ack"}))
            await writer.drain()
            pending.connected.set()
            pending.queue.put_nowait(Frame(kind="prologue", header=header, body=body))
            while True:
                header, body = await read_frame(reader)
                kind = header.get("kind", "data")
                pending.queue.put_nowait(Frame(kind=kind, header=header, body=body))
                if kind in ("complete", "error"):
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            if pending is not None:
                # Abrupt disconnect mid-stream: surface as an error frame so the
                # Migration operator can react.
                pending.queue.put_nowait(
                    Frame(kind="error", header={"kind": "error", "message": "connection reset", "disconnect": True})
                )
        finally:
            if pending is not None:
                self._pending.pop(pending.stream_id, None)
                pending.queue.put_nowait(None)
            try:
                writer.close()
            except Exception:
                pass

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        for sid in list(self._pending):
            self.unregister(sid)


class TcpCallHome:
    """Worker-side client: connect to the caller and stream responses."""

    def __init__(self, info: ConnectionInfo):
        self.info = info
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    async def connect(self, prologue_extra: Optional[dict] = None) -> bool:
        host, port = self.info.address.rsplit(":", 1)
        self._reader, self._writer = await asyncio.open_connection(host, int(port))
        header = {"kind": "prologue", "stream_id": self.info.stream_id}
        if prologue_extra:
            header.update(prologue_extra)
        self._writer.write(encode_frame(header))
        await self._writer.drain()
        ack, _ = await read_frame(self._reader)
        return ack.get("kind") == "ack"

    async def send(self, payload: dict, body: bytes = b"") -> None:
        assert self._writer is not None
        header = {"kind": "data", **payload}
        self._writer.write(encode_frame(header, body))
        await self._writer.drain()

    async def complete(self) -> None:
        assert self._writer is not None
        self._writer.write(encode_frame({"kind": "complete"}))
        await self._writer.drain()

    async def error(self, message: str, *, disconnect: bool = False) -> None:
        """``disconnect=True`` marks the error as a stream-level disconnect
        (worker draining, engine death): the caller raises StreamDisconnect
        and its Migration operator may replay, instead of a terminal
        RuntimeError."""
        assert self._writer is not None
        header = {"kind": "error", "message": message}
        if disconnect:
            header["disconnect"] = True
        self._writer.write(encode_frame(header))
        await self._writer.drain()

    async def close(self) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except Exception:
                pass
            self._writer = None
