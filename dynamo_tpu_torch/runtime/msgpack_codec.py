"""The MessagePack subset the runtime's wire speaks, in plain Python.

The JAX package frames its control plane, its request publish, its stats
scrape and its TCP response plane with the third-party ``msgpack`` package;
the card's machine has no wheel of it. This module stands in its place and
writes the same bytes: ``packb(obj)`` equals ``msgpack.packb(obj,
use_bin_type=True)`` and ``unpackb(data)`` equals ``msgpack.unpackb(data,
raw=False)`` on the types the wire carries: nil, bool, int (-2**63 ..
2**64 - 1), float (as float64), str, bytes, list/tuple (as arrays) and dict
(as maps, whose keys must be str or bytes when read, as msgpack's default
``strict_map_key`` requires). Truncated, trailing or unknown input raises
``ValueError``; an extension type is unknown input here.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

_U8, _U16, _U32, _U64 = (struct.Struct(f">{c}") for c in "BHIQ")
_I8, _I16, _I32, _I64 = (struct.Struct(f">{c}") for c in "bhiq")
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _header(out: bytearray, n: int, fix: int, fix_max: int, c8: int, c16: int, c32: int) -> None:
    """A str/bin/array/map header: the fix form up to ``fix_max`` (-1: none),
    then the 8-bit (``c8`` 0: none), 16- and 32-bit length forms."""
    if n <= fix_max:
        out.append(fix | n)
    elif c8 and n < 0x100:
        out += bytes((c8, n))
    elif n < 0x10000:
        out.append(c16)
        out += _U16.pack(n)
    elif n < 0x100000000:
        out.append(c32)
        out += _U32.pack(n)
    else:
        raise ValueError(f"length {n} does not fit a msgpack header")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _F64.pack(obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 31, 0xD9, 0xDA, 0xDB)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _header(out, len(data), 0, -1, 0xC4, 0xC5, 0xC6)
        out += data
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 15, 0, 0xDC, 0xDD)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 15, 0, 0xDE, 0xDF)
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, st, limit in ((0xCC, _U8, 1 << 8), (0xCD, _U16, 1 << 16), (0xCE, _U32, 1 << 32),
                                (0xCF, _U64, 1 << 64)):
            if n < limit:
                out.append(code)
                out += st.pack(n)
                return
        raise OverflowError("Integer value out of range")
    else:
        for code, st, limit in ((0xD0, _I8, 1 << 7), (0xD1, _I16, 1 << 15), (0xD2, _I32, 1 << 31),
                                (0xD3, _I64, 1 << 63)):
            if n >= -limit:
                out.append(code)
                out += st.pack(n)
                return
        raise OverflowError("Integer value out of range")


def unpackb(data) -> Any:
    buf = bytes(data)
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"extra data: {len(buf) - pos} bytes after the object")
    return obj


def _take(buf: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    end = pos + n
    if end > len(buf):
        raise ValueError("incomplete input")
    return buf[pos:end], end


def _num(buf: bytes, pos: int, st: struct.Struct) -> Tuple[Any, int]:
    raw, pos = _take(buf, pos, st.size)
    return st.unpack(raw)[0], pos


# Fixed-width scalars: code → struct. Lengths: code → (struct, kind).
_SCALARS = {0xCA: _F32, 0xCB: _F64, 0xCC: _U8, 0xCD: _U16, 0xCE: _U32, 0xCF: _U64,
            0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64}
_SIZED = {0xC4: (_U8, "bin"), 0xC5: (_U16, "bin"), 0xC6: (_U32, "bin"),
          0xD9: (_U8, "str"), 0xDA: (_U16, "str"), 0xDB: (_U32, "str"),
          0xDC: (_U16, "array"), 0xDD: (_U32, "array"), 0xDE: (_U16, "map"), 0xDF: (_U32, "map")}


def _unpack(buf: bytes, pos: int) -> Tuple[Any, int]:
    if pos >= len(buf):
        raise ValueError("incomplete input")
    code = buf[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _SCALARS:
        return _num(buf, pos, _SCALARS[code])
    if 0xA0 <= code < 0xC0:
        kind, n = "str", code & 0x1F
    elif 0x90 <= code < 0xA0:
        kind, n = "array", code & 0x0F
    elif 0x80 <= code < 0x90:
        kind, n = "map", code & 0x0F
    elif code in _SIZED:
        st, kind = _SIZED[code]
        n, pos = _num(buf, pos, st)
    else:
        raise ValueError(f"unknown msgpack type code 0x{code:02x}")
    if kind == "bin":
        return _take(buf, pos, n)
    if kind == "str":
        raw, pos = _take(buf, pos, n)
        return raw.decode("utf-8"), pos
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = _unpack(buf, pos)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos)
        if not isinstance(key, (str, bytes)):
            raise ValueError(f"{type(key).__name__} is not allowed for map key")
        out[key], pos = _unpack(buf, pos)
    return out, pos
