"""The port's msgpack codec (``runtime/msgpack_codec.py``) against the
``msgpack`` package the JAX package's wire uses: ``packb`` byte-equal to
``msgpack.packb(obj, use_bin_type=True)`` and ``unpackb`` equal to
``msgpack.unpackb(data, raw=False)`` on hypothesis-built nested values and
at every width edge; truncated, trailing and unknown input raising
``ValueError``; and the frames of the TCP response plane and of the
control plane byte-equal to the JAX package's on the same header and body.
Only this test imports ``msgpack``: the port does not."""

import asyncio

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.runtime.transports import tcp as jtcp
from dynamo_tpu.runtime.transports import tcp_control as jctl
from dynamo_tpu_torch.runtime import msgpack_codec as codec
from dynamo_tpu_torch.runtime.transports import tcp as ptcp
from dynamo_tpu_torch.runtime.transports import tcp_control as pctl


def ref_pack(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def ref_unpack(data: bytes):
    return msgpack.unpackb(data, raw=False)


def check(obj) -> None:
    want = ref_pack(obj)
    assert codec.packb(obj) == want
    assert codec.unpackb(want) == ref_unpack(want)


scalars = (st.none() | st.booleans() | st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
           | st.floats(allow_nan=False) | st.text(max_size=300) | st.binary(max_size=300))
values = st.recursive(
    scalars,
    lambda inner: st.lists(inner, max_size=20) | st.tuples(inner, inner)
    | st.dictionaries(st.text(max_size=20) | st.binary(max_size=8), inner, max_size=20),
    max_leaves=60,
)


@settings(max_examples=300, deadline=None)
@given(values)
def test_nested_values_match_msgpack(obj):
    check(obj)


# Each integer width's edges, both signs.
INT_EDGES = sorted({s * (e + d) for e in (1 << 5, 1 << 7, 1 << 8, 1 << 15, 1 << 16, 1 << 31, 1 << 32, 1 << 63)
                    for d in (-1, 0, 1) for s in (1, -1)
                    if -(1 << 63) <= s * (e + d) <= (1 << 64) - 1} | {0, (1 << 64) - 1, (1 << 64) - 2})


@pytest.mark.parametrize("n", INT_EDGES)
def test_int_width_edges(n):
    check(n)


@pytest.mark.parametrize("n", [31, 32, 255, 256, 65535, 65536])
@pytest.mark.parametrize("kind", ["ascii", "non_ascii", "bytes"])
def test_str_and_bin_length_edges(n, kind):
    if kind == "bytes":
        obj = bytes(range(256)) * (n // 256) + bytes(range(n % 256))
    elif kind == "ascii":
        obj = "x" * n
    else:
        # n encoded bytes: two-byte "é"s, then an ASCII pad for odd n.
        obj = "é" * (n // 2) + "z" * (n % 2)
        assert len(obj.encode()) == n
    check(obj)


@pytest.mark.parametrize("n", [15, 16, 65535, 65536])
def test_array_and_map_length_edges(n):
    check(list(range(n)))
    check({str(i): i for i in range(n)})


def test_floats_ints_and_bools_keep_their_types():
    for obj in (1.0, -0.0, float("inf"), 1e308, True, False, 1, None, [True, 1, 1.0]):
        check(obj)
        back = codec.unpackb(codec.packb(obj))
        assert type(back) is type(ref_unpack(ref_pack(obj)))


def test_float32_is_read():
    data = b"\xca" + b"\x3f\xc0\x00\x00"  # 1.5 as float32 (the port never writes one)
    assert codec.unpackb(data) == ref_unpack(data) == 1.5


def test_truncated_input_raises():
    sample = ref_pack({"kind": "data", "data": {"token_ids": [1, 70000, -5], "text": "héllo", "b": b"\x00" * 300},
                       "x": [1.5, None, True, (1 << 40)]})
    for end in range(len(sample)):
        with pytest.raises(ValueError):
            codec.unpackb(sample[:end])
        with pytest.raises(ValueError):
            ref_unpack(sample[:end])


@pytest.mark.parametrize("data", [b"\xc1", b"\xd4\x01\x02", b"\xc7\x01\x05\x00", b"\x01\x02", b"\x81\x01\x02",
                                  b"\x81\xc0\x01"])
def test_unknown_trailing_and_bad_keys_raise(data):
    """A never-used code, extension types (unknown here), trailing bytes,
    and map keys that are neither str nor bytes."""
    with pytest.raises(ValueError):
        codec.unpackb(data)


def test_unpackable_types_raise():
    for obj in (object(), {1, 2}, 1 << 64, -(1 << 63) - 1):
        with pytest.raises((TypeError, OverflowError)):
            codec.packb(obj)
        with pytest.raises((TypeError, OverflowError)):
            ref_pack(obj)


FRAME_HEADERS = [
    {"kind": "prologue", "stream_id": "a" * 32},
    {"kind": "data", "data": {"token_ids": [17], "finish_reason": None, "index": 0, "cached_tokens": 48}},
    {"kind": "error", "message": "connection reset", "disconnect": True},
    {"kind": "complete"},
    {},
]


@pytest.mark.parametrize("header", FRAME_HEADERS)
def test_response_plane_frames_match_jax(header):
    for body in (b"", b"\x00\x01payload" * 40):
        assert ptcp.encode_frame(header, body) == jtcp.encode_frame(header, body)


async def _read(module, data: bytes):
    reader = asyncio.StreamReader()
    reader.feed_data(data)
    reader.feed_eof()
    return await module.read_frame(reader)


@pytest.mark.parametrize("header", FRAME_HEADERS)
def test_response_plane_frames_cross_decode(header):
    body = b"kv" * 10
    assert asyncio.run(_read(ptcp, jtcp.encode_frame(header, body))) == (header, body)
    assert asyncio.run(_read(jtcp, ptcp.encode_frame(header, body))) == (header, body)


def test_control_plane_messages_match_jax():
    msgs = [{"op": "put", "id": 3, "key": "instances/dynamo/backend/generate:1f", "value": b"{}", "lease_id": 31,
             "create_only": False},
            {"op": "s_fetch", "id": 9, "stream": "kv_events.dynamo.backend", "from_seq": 1, "wait": True,
             "timeout": 5.0},
            {"push": "watch_event", "watch_id": 2, "type": "delete", "key": "models/x", "value": None,
             "revision": 12}]
    for m in msgs:
        assert pctl._pack(m) == jctl._pack(m)
