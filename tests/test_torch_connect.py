"""The port's descriptor transfer API (``dynamo_tpu_torch/connect.py``) over
the port's TCP data plane, in ``tests/test_connect.py``'s cases (readable
then read, writable then write, a mismatched shape is an error, the
metadata's JSON, a readable serving two reads), with torch descriptors (a
CPU tensor filled in place, bfloat16 across, ``to_torch``), and the frames
a readable serves byte-equal to the JAX ``Connector``'s for the same
arrays.
"""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.connect import Connector as JaxConnector
from dynamo_tpu.connect import Descriptor as JaxDescriptor
from dynamo_tpu.runtime.distributed import DistributedRuntime as JaxDrt
from dynamo_tpu_torch.connect import Connector, Descriptor, RdmaMetadata, TransferError
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime


async def test_readable_then_read_roundtrip():
    drt = await DistributedRuntime.detached()
    try:
        conn = Connector(drt)
        src_a = np.arange(24, dtype=np.float32).reshape(4, 6)
        src_b = np.arange(10, dtype=np.int32)
        readable = await conn.create_readable(Descriptor(src_a), Descriptor(src_b))
        meta = readable.metadata().to_json()
        dst_a, dst_b = np.zeros((4, 6), dtype=np.float32), np.zeros(10, dtype=np.int32)
        read = await conn.begin_read(meta, Descriptor(dst_a), Descriptor(dst_b))
        await read.wait_for_completion(timeout=5)
        await readable.wait_for_completion(timeout=5)
        np.testing.assert_array_equal(dst_a, src_a)
        np.testing.assert_array_equal(dst_b, src_b)
    finally:
        await drt.shutdown()


async def test_writable_then_write_roundtrip():
    drt = await DistributedRuntime.detached()
    try:
        conn = Connector(drt)
        dst = np.zeros(16, dtype=np.float64)
        writable = await conn.create_writable(Descriptor(dst))
        write = await conn.begin_write(writable.metadata().to_json(), Descriptor(np.linspace(0, 1, 16)))
        await write.wait_for_completion(timeout=5)
        await writable.wait_for_completion(timeout=5)
        np.testing.assert_array_equal(dst, np.linspace(0, 1, 16))
    finally:
        await drt.shutdown()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
async def test_torch_descriptor_roundtrip(dtype):
    """A tensor read into a CPU tensor in place, and back as ``to_torch``."""
    drt = await DistributedRuntime.detached()
    try:
        conn = Connector(drt)
        src = (torch.arange(32, dtype=torch.float32).reshape(8, 4) * 0.5).to(dtype)
        readable = await conn.create_readable(Descriptor(src))
        assert readable.metadata().descriptors == [{"shape": [8, 4], "dtype": str(dtype).removeprefix("torch.")}]
        dst = torch.zeros((8, 4), dtype=dtype)
        d = Descriptor(dst)
        read = await conn.begin_read(readable.metadata(), d)
        await read.wait_for_completion(timeout=5)
        assert torch.equal(dst, src) and torch.equal(d.to_torch("cpu"), src)
    finally:
        await drt.shutdown()


async def test_shape_mismatch_is_error():
    drt = await DistributedRuntime.detached()
    try:
        conn = Connector(drt)
        readable = await conn.create_readable(Descriptor(np.zeros(8, dtype=np.float32)))
        read = await conn.begin_read(readable.metadata(), Descriptor(np.zeros(9, dtype=np.float32)))
        with pytest.raises(TransferError):
            await read.wait_for_completion(timeout=5)
        await readable.cancel()
    finally:
        await drt.shutdown()


async def test_metadata_json_roundtrip():
    m = RdmaMetadata("writable", "abc", [{"shape": [2], "dtype": "float32"}], conn={"host": "h"})
    m2 = RdmaMetadata.from_json(m.to_json())
    assert m2.kind == "writable" and m2.nonce == "abc" and m2.conn == {"host": "h"}
    assert json.loads(m.to_json()) == json.loads(m2.to_json())


async def test_readable_serves_multiple_reads():
    drt = await DistributedRuntime.detached()
    try:
        conn = Connector(drt)
        src = np.arange(6, dtype=np.int64)
        readable = await conn.create_readable(Descriptor(src), remaining_reads=2)
        outs = [np.zeros(6, dtype=np.int64) for _ in range(2)]
        for o in outs:
            r = await conn.begin_read(readable.metadata(), Descriptor(o))
            await r.wait_for_completion(timeout=5)
        await readable.wait_for_completion(timeout=5)
        for o in outs:
            np.testing.assert_array_equal(o, src)
    finally:
        await drt.shutdown()


async def _served_frames(drt, subject):
    conn_info, pending = drt.tcp_server_handle().register()
    await drt.bus.publish(subject, json.dumps({"conn": conn_info.to_dict()}).encode())
    frames = []
    try:
        async for frame in pending.frames():
            if frame.kind != "prologue":
                frames.append((frame.kind, dict(frame.header), bytes(frame.body)))
    finally:
        drt.tcp_server_handle().unregister(conn_info.stream_id)
    return frames


async def test_readable_frames_byte_equal_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32).astype(ml_dtypes.bfloat16)
    tb = torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16)
    jdrt, pdrt = await JaxDrt.detached(), await DistributedRuntime.detached()
    try:
        jr = await JaxConnector(jdrt).create_readable(JaxDescriptor(a), JaxDescriptor(b))
        pr = await Connector(pdrt).create_readable(Descriptor(a), Descriptor(tb))
        assert pr.metadata().descriptors == jr.metadata().descriptors
        got = await _served_frames(pdrt, pr.subject)
        want = await _served_frames(jdrt, jr.subject)
        assert [f[0] for f in got] == ["data", "data", "complete"] and got == want
    finally:
        await jdrt.shutdown()
        await pdrt.shutdown()
