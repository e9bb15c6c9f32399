"""GGUF files: metadata parsing and tensor reads (pure Python and numpy).

A copy of the JAX package's ``llm/gguf.py``: the header, the metadata KV
table and the tensor directory, and ``read_tensor`` / ``load_tensors``,
which dequantize f32, f16, bf16, q8_0, q4_k, q5_k and q6_k tensors to f32
numpy. ``engine/weights.py`` loads llama-family checkpoints through it.

Format (gguf v2/v3, little-endian):
  magic "GGUF" | version u32 | tensor_count u64 | metadata_kv_count u64
  kv: key(string) type(u32) value          string: len u64 + utf8 bytes
  tensor: name(string) n_dims(u32) dims(u64 × n) ggml_type(u32) offset(u64)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Dict, List, Optional

GGUF_MAGIC = b"GGUF"

# Metadata value types.
T_UINT8, T_INT8, T_UINT16, T_INT16, T_UINT32, T_INT32 = 0, 1, 2, 3, 4, 5
T_FLOAT32, T_BOOL, T_STRING, T_ARRAY, T_UINT64, T_INT64, T_FLOAT64 = 6, 7, 8, 9, 10, 11, 12

_SCALAR_FMT = {
    T_UINT8: "<B", T_INT8: "<b", T_UINT16: "<H", T_INT16: "<h",
    T_UINT32: "<I", T_INT32: "<i", T_FLOAT32: "<f",
    T_UINT64: "<Q", T_INT64: "<q", T_FLOAT64: "<d",
}

# ggml tensor dtypes we care to name (subset; unknown ids stay numeric).
GGML_TYPE_NAMES = {
    0: "f32", 1: "f16", 2: "q4_0", 3: "q4_1", 6: "q5_0", 7: "q5_1",
    8: "q8_0", 9: "q8_1", 10: "q2_k", 11: "q3_k", 12: "q4_k", 13: "q5_k",
    14: "q6_k", 15: "q8_k", 16: "iq2_xxs", 17: "iq2_xs", 18: "iq3_xxs",
    24: "i8", 25: "i16", 26: "i32", 27: "i64", 28: "f64", 30: "bf16",
}


class GgufError(ValueError):
    pass


@dataclass
class GgufTensorInfo:
    name: str
    shape: List[int]
    ggml_type: int
    offset: int

    @property
    def dtype_name(self) -> str:
        return GGML_TYPE_NAMES.get(self.ggml_type, f"ggml_{self.ggml_type}")


@dataclass
class GgufMetadata:
    version: int
    metadata: Dict[str, Any] = field(default_factory=dict)
    tensors: List[GgufTensorInfo] = field(default_factory=list)
    # Absolute file offset of the (aligned) tensor-data section; tensor
    # offsets are relative to this.
    data_start: int = 0

    # --- convenience accessors the MDC builder uses -------------------------
    @property
    def architecture(self) -> Optional[str]:
        return self.metadata.get("general.architecture")

    @property
    def model_name(self) -> Optional[str]:
        return self.metadata.get("general.name")

    def arch_field(self, suffix: str) -> Any:
        """Read ``{arch}.{suffix}`` (e.g. context_length, block_count)."""
        arch = self.architecture
        return self.metadata.get(f"{arch}.{suffix}") if arch else None

    @property
    def context_length(self) -> Optional[int]:
        return self.arch_field("context_length")

    @property
    def num_layers(self) -> Optional[int]:
        return self.arch_field("block_count")

    @property
    def tokenizer_model(self) -> Optional[str]:
        return self.metadata.get("tokenizer.ggml.model")

    @property
    def tokens(self) -> Optional[list]:
        return self.metadata.get("tokenizer.ggml.tokens")

    @property
    def chat_template(self) -> Optional[str]:
        return self.metadata.get("tokenizer.chat_template")


def _read(f: BinaryIO, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise GgufError(f"truncated GGUF file: wanted {n} bytes, got {len(data)}")
    return data


def _read_scalar(f: BinaryIO, fmt: str):
    return struct.unpack(fmt, _read(f, struct.calcsize(fmt)))[0]


def _read_string(f: BinaryIO) -> str:
    n = _read_scalar(f, "<Q")
    if n > 1 << 32:
        raise GgufError(f"implausible string length {n}")
    return _read(f, n).decode("utf-8", errors="replace")


def _read_value(f: BinaryIO, vtype: int, *, max_array: int):
    if vtype in _SCALAR_FMT:
        return _read_scalar(f, _SCALAR_FMT[vtype])
    if vtype == T_BOOL:
        return _read_scalar(f, "<B") != 0
    if vtype == T_STRING:
        return _read_string(f)
    if vtype == T_ARRAY:
        etype = _read_scalar(f, "<I")
        count = _read_scalar(f, "<Q")
        if count > max_array:
            raise GgufError(f"array too large ({count} > {max_array})")
        return [_read_value(f, etype, max_array=max_array) for _ in range(count)]
    raise GgufError(f"unknown GGUF value type {vtype}")


def parse_gguf(path: str, *, max_array: int = 1 << 24) -> GgufMetadata:
    """Parse header + metadata + tensor directory (no tensor data reads)."""
    with open(path, "rb") as f:
        if _read(f, 4) != GGUF_MAGIC:
            raise GgufError(f"{path}: not a GGUF file")
        version = _read_scalar(f, "<I")
        if version not in (2, 3):
            raise GgufError(f"unsupported GGUF version {version}")
        tensor_count = _read_scalar(f, "<Q")
        kv_count = _read_scalar(f, "<Q")
        meta = GgufMetadata(version=version)
        for _ in range(kv_count):
            key = _read_string(f)
            vtype = _read_scalar(f, "<I")
            meta.metadata[key] = _read_value(f, vtype, max_array=max_array)
        for _ in range(tensor_count):
            name = _read_string(f)
            n_dims = _read_scalar(f, "<I")
            if n_dims > 8:
                raise GgufError(f"implausible tensor rank {n_dims}")
            shape = [_read_scalar(f, "<Q") for _ in range(n_dims)]
            ggml_type = _read_scalar(f, "<I")
            offset = _read_scalar(f, "<Q")
            meta.tensors.append(GgufTensorInfo(name=name, shape=shape, ggml_type=ggml_type, offset=offset))
        align = int(meta.metadata.get("general.alignment", 32) or 32)
        pos = f.tell()
        meta.data_start = (pos + align - 1) // align * align
        return meta


# --- tensor data loading ----------------------------------------------------
# Real-valued + q8_0 + k-quant coverage (q4_k/q5_k/q6_k are what most
# published GGUF checkpoints ship as). The remaining quants (iq*, q2/q3_k)
# raise: convert them externally.

GGML_F32, GGML_F16, GGML_Q8_0, GGML_BF16 = 0, 1, 8, 30
GGML_Q4_K, GGML_Q5_K, GGML_Q6_K = 12, 13, 14
QK_K = 256  # k-quant super-block size

# Bytes per QK_K super-block: q4_k = d,dmin(2×f16) + scales(12) + qs(128);
# q5_k adds qh(32); q6_k = ql(128) + qh(64) + scales(16×i8) + d(f16).
_KQUANT_BLOCK_BYTES = {GGML_Q4_K: 144, GGML_Q5_K: 176, GGML_Q6_K: 210}


def _tensor_nbytes(info: GgufTensorInfo) -> int:
    import math

    n = math.prod(info.shape) if info.shape else 1
    if info.ggml_type in (GGML_F16, GGML_BF16):
        return n * 2
    if info.ggml_type == GGML_F32:
        return n * 4
    if info.ggml_type == GGML_Q8_0:
        if n % 32:
            raise GgufError(f"{info.name}: q8_0 needs multiple-of-32 elements")
        return (n // 32) * 34  # f16 scale + 32 int8 codes per block
    if info.ggml_type in _KQUANT_BLOCK_BYTES:
        if n % QK_K:
            raise GgufError(f"{info.name}: k-quants need multiple-of-{QK_K} elements")
        return (n // QK_K) * _KQUANT_BLOCK_BYTES[info.ggml_type]
    raise GgufError(
        f"{info.name}: unsupported tensor dtype {info.dtype_name} "
        "(supported: f32, f16, bf16, q8_0, q4_k, q5_k, q6_k)"
    )


def _scale_min_k4(scales):
    """Unpack q4_k/q5_k packed 6-bit (scale, min) pairs: [nb, 12] uint8 →
    two [nb, 8] float32 arrays (llama.cpp get_scale_min_k4 layout)."""
    import numpy as np

    s = scales.astype(np.uint8)
    sc = np.empty(s.shape[:-1] + (8,), np.float32)
    mn = np.empty_like(sc)
    sc[..., :4] = (s[..., 0:4] & 63).astype(np.float32)
    mn[..., :4] = (s[..., 4:8] & 63).astype(np.float32)
    sc[..., 4:] = ((s[..., 8:12] & 0xF) | ((s[..., 0:4] >> 6) << 4)).astype(np.float32)
    mn[..., 4:] = ((s[..., 8:12] >> 4) | ((s[..., 4:8] >> 6) << 4)).astype(np.float32)
    return sc, mn


def _dequant_q4_k(raw):
    import numpy as np

    b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 144)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)  # [nb, 1]
    dmin = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _scale_min_k4(b[:, 4:16])  # [nb, 8]
    qs = b[:, 16:144]  # [nb, 128] — nibbles for 8 sub-blocks of 32
    lo = (qs & 0xF).astype(np.float32).reshape(-1, 4, 32)  # sub-blocks 0,2,4,6
    hi = (qs >> 4).astype(np.float32).reshape(-1, 4, 32)  # sub-blocks 1,3,5,7
    out = np.empty((b.shape[0], 8, 32), np.float32)
    out[:, 0::2] = d[:, :, None] * sc[:, 0::2, None] * lo - dmin[:, :, None] * mn[:, 0::2, None]
    out[:, 1::2] = d[:, :, None] * sc[:, 1::2, None] * hi - dmin[:, :, None] * mn[:, 1::2, None]
    return out.reshape(-1)


def _dequant_q5_k(raw):
    import numpy as np

    b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 176)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)
    dmin = b[:, 2:4].copy().view(np.float16).astype(np.float32)
    sc, mn = _scale_min_k4(b[:, 4:16])
    qh = b[:, 16:48]  # [nb, 32] — one high bit per element per 32-lane
    qs = b[:, 48:176]  # [nb, 128]
    lo = (qs & 0xF).astype(np.uint8).reshape(-1, 4, 32)
    hi = (qs >> 4).astype(np.uint8).reshape(-1, 4, 32)
    out = np.empty((b.shape[0], 8, 32), np.float32)
    for j in range(4):  # 64-element chunks; qh bit pairs (2j, 2j+1)
        h1 = ((qh >> (2 * j)) & 1).astype(np.uint8)  # [nb, 32]
        h2 = ((qh >> (2 * j + 1)) & 1).astype(np.uint8)
        q1 = (lo[:, j] | (h1 << 4)).astype(np.float32)
        q2 = (hi[:, j] | (h2 << 4)).astype(np.float32)
        out[:, 2 * j] = d * sc[:, 2 * j : 2 * j + 1] * q1 - dmin * mn[:, 2 * j : 2 * j + 1]
        out[:, 2 * j + 1] = d * sc[:, 2 * j + 1 : 2 * j + 2] * q2 - dmin * mn[:, 2 * j + 1 : 2 * j + 2]
    return out.reshape(-1)


def _dequant_q6_k(raw):
    import numpy as np

    b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 210)
    ql = b[:, 0:128].reshape(-1, 2, 64)  # two 128-element halves
    qh = b[:, 128:192].reshape(-1, 2, 32)
    sc = b[:, 192:208].copy().view(np.int8).astype(np.float32).reshape(-1, 2, 8)
    d = b[:, 208:210].copy().view(np.float16).astype(np.float32)  # [nb, 1]
    out = np.empty((b.shape[0], 2, 4, 32), np.float32)
    for half in range(2):
        l_lo = (ql[:, half, :32] & 0xF).astype(np.int16)
        l2_lo = (ql[:, half, 32:] & 0xF).astype(np.int16)
        l_hi = (ql[:, half, :32] >> 4).astype(np.int16)
        l2_hi = (ql[:, half, 32:] >> 4).astype(np.int16)
        h = qh[:, half].astype(np.int16)
        q1 = (l_lo | ((h & 3) << 4)) - 32
        q2 = (l2_lo | (((h >> 2) & 3) << 4)) - 32
        q3 = (l_hi | (((h >> 4) & 3) << 4)) - 32
        q4 = (l2_hi | (((h >> 6) & 3) << 4)) - 32
        # scale index: l//16 + {0,2,4,6} over the 8 per-half scales
        s = sc[:, half]  # [nb, 8]
        for qi, (q, off) in enumerate(((q1, 0), (q2, 2), (q3, 4), (q4, 6))):
            scale = np.repeat(s[:, off : off + 2], 16, axis=1)  # [nb, 32]
            out[:, half, qi] = d * scale * q.astype(np.float32)
    return out.reshape(-1)


def read_tensor(f: BinaryIO, meta: GgufMetadata, info: GgufTensorInfo):
    """Read one tensor as float32 numpy, shaped with ggml's ne reversed
    (ne[0] is the contiguous dim), i.e. matrices come out HF-style
    ``[out, in]``."""
    import numpy as np

    f.seek(meta.data_start + info.offset)
    raw = _read(f, _tensor_nbytes(info))
    shape = tuple(reversed(info.shape)) if info.shape else ()
    if info.ggml_type == GGML_F32:
        arr = np.frombuffer(raw, dtype=np.float32)
    elif info.ggml_type == GGML_F16:
        arr = np.frombuffer(raw, dtype=np.float16).astype(np.float32)
    elif info.ggml_type == GGML_BF16:
        u = np.frombuffer(raw, dtype=np.uint16).astype(np.uint32) << 16
        arr = u.view(np.float32)
    elif info.ggml_type == GGML_Q4_K:
        arr = _dequant_q4_k(raw)
    elif info.ggml_type == GGML_Q5_K:
        arr = _dequant_q5_k(raw)
    elif info.ggml_type == GGML_Q6_K:
        arr = _dequant_q6_k(raw)
    else:  # q8_0
        blocks = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 34)
        scales = blocks[:, :2].copy().view(np.float16).astype(np.float32)  # [nb, 1]
        codes = blocks[:, 2:].copy().view(np.int8).astype(np.float32)  # [nb, 32]
        arr = (codes * scales).reshape(-1)
    return arr.reshape(shape)


def load_tensors(path: str, names: Optional[List[str]] = None) -> Dict[str, Any]:
    """Load (a subset of) a GGUF file's tensors as f32 numpy arrays."""
    meta = parse_gguf(path)
    want = set(names) if names is not None else None
    out: Dict[str, Any] = {}
    with open(path, "rb") as f:
        for info in meta.tensors:
            if want is not None and info.name not in want:
                continue
            out[info.name] = read_tensor(f, meta, info)
    return out
