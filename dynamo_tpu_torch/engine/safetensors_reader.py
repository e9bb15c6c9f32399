"""A reader of the safetensors format that needs no wheel beyond torch.

Format: an 8-byte little-endian header length ``n``, ``n`` bytes of JSON
(``{name: {"dtype": "BF16", "shape": [..], "data_offsets": [begin, end]},
"__metadata__": {..}}``, offsets relative to the end of the header), then
the tensors' raw little-endian bytes. The file is mapped copy-on-write;
``get`` returns a tensor over the mapped bytes in the file's own dtype
(``BF16`` straight into ``torch.bfloat16``, with no numpy dtype between),
so a caller copies it where it is needed and may ``release`` its pages
afterwards. Every inconsistency of the header raises ``ValueError`` naming
the file and the tensor.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Dict, List, Optional, Tuple

import torch

DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "F64": torch.float64,
    "I8": torch.int8,
    "U8": torch.uint8,
    "I16": torch.int16,
    "I32": torch.int32,
    "I64": torch.int64,
    "BOOL": torch.bool,
}


class SafetensorsFile:
    """One ``.safetensors`` file: its header checked, its data mapped.
    Use as a context manager, or call ``close``."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) < 8:
                raise ValueError(f"{path}: {size} bytes, shorter than the 8-byte header length")
            (n,) = struct.unpack("<Q", head)
            if n > size - 8:
                raise ValueError(f"{path}: a header of {n} bytes overruns the file of {size} bytes")
            try:
                header = json.loads(f.read(n))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ValueError(f"{path}: the header is not JSON ({e})") from None
            if not isinstance(header, dict):
                raise ValueError(f"{path}: the header is not a JSON object")
            self.metadata: Optional[dict] = header.pop("__metadata__", None)
            self._start = 8 + n
            data_len = size - self._start
            self._entries: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int, int]] = {}
            for name, info in header.items():
                self._entries[name] = self._check(name, info, data_len)
            spans = sorted((b, e, name) for name, (_, _, b, e) in self._entries.items() if e > b)
            for (_, e0, a), (b1, _, b) in zip(spans, spans[1:]):
                if b1 < e0:
                    raise ValueError(f"{path}: tensors {a!r} and {b!r} overlap")
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else None

    def _check(self, name: str, info, data_len: int):
        if not isinstance(info, dict):
            raise ValueError(f"{self.path}: tensor {name!r}: entry is not an object")
        dt = info.get("dtype")
        if dt not in DTYPES:
            raise ValueError(f"{self.path}: tensor {name!r}: unknown dtype {dt!r} (known: {sorted(DTYPES)})")
        shape, offs = info.get("shape"), info.get("data_offsets")
        if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0 for d in shape)):
            raise ValueError(f"{self.path}: tensor {name!r}: bad shape {shape!r}")
        if not (isinstance(offs, list) and len(offs) == 2 and all(isinstance(o, int) for o in offs)):
            raise ValueError(f"{self.path}: tensor {name!r}: bad data_offsets {offs!r}")
        begin, end = offs
        if not 0 <= begin <= end <= data_len:
            raise ValueError(f"{self.path}: tensor {name!r}: data_offsets {offs} outside the {data_len} data bytes")
        dtype = DTYPES[dt]
        nbytes = math.prod(shape) * dtype.itemsize
        if end - begin != nbytes:
            raise ValueError(f"{self.path}: tensor {name!r}: data_offsets {offs} span {end - begin} bytes, "
                             f"its {dt} shape {shape} needs {nbytes}")
        return dtype, tuple(shape), begin, end

    def keys(self) -> List[str]:
        return list(self._entries)

    def get(self, name: str) -> torch.Tensor:
        """The tensor over the mapped bytes (a view: copy it before
        ``release`` or ``close``)."""
        dtype, shape, begin, end = self._entries[name]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        return torch.frombuffer(self._mm, dtype=dtype, count=(end - begin) // dtype.itemsize,
                                offset=self._start + begin).view(shape)

    def release(self, name: str) -> None:
        """Drop the mapped pages of ``name`` from this process (the next read
        faults them in again from the file)."""
        _, _, begin, end = self._entries[name]
        page = mmap.PAGESIZE
        lo = (self._start + begin) // page * page
        if end > begin:
            self._mm.madvise(mmap.MADV_DONTNEED, lo, self._start + end - lo)

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # A tensor still views the mapping: it is closed when that goes.
                pass
            self._mm = None

    def __enter__(self) -> "SafetensorsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
