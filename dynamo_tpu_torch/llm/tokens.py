"""Token sequences, block partitioning, and chained block hashing.

A block's hash is ``xxh3_64`` over its little-endian u32 token ids, seeded
with the hash of the block before it, so one hash identifies the whole
prefix ending at that block. Router overlap matching and engine prefix
caching both key on these, so they must be bit-identical to the JAX
package's (``xxhash.xxh3_64_intdigest``). The ``xxhash`` wheel is not
assumed to be installed, so ``xxh3_64`` is written out here in pure
Python for every input of at most 240 bytes (60 tokens) — the short and
mid-size paths of XXH3, which cover a block of up to 60 tokens.

``compute_block_hashes`` and ``extend_block_hashes`` run on the port's host
library (``native.py``, ``csrc/native.cc``: the same XXH3, in C++), built
at first use; with ``DYN_NATIVE=0`` they run the pure-Python ``xxh3_64``
below, which stays as the plain version.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

from dynamo_tpu_torch.native import get_native

# Seed for the first block in a sequence (no parent); the JAX package's.
ROOT_SEED = 0x6462_6C6B  # "dblk"

BlockHash = int

_M64 = (1 << 64) - 1

_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P_MX1 = 0x165667919E3779F9
_P_MX2 = 0x9FB21C651E98DF25

# XXH3's default 192-byte secret (kSecret).
_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)

MAX_HASH_BYTES = 240


def _r64(b: bytes, off: int) -> int:
    return int.from_bytes(b[off : off + 8], "little")


def _r32(b: bytes, off: int) -> int:
    return int.from_bytes(b[off : off + 4], "little")


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _swap32(x: int) -> int:
    return int.from_bytes(x.to_bytes(4, "little"), "big")


def _swap64(x: int) -> int:
    return int.from_bytes(x.to_bytes(8, "little"), "big")


def _fold64(a: int, b: int) -> int:
    p = a * b
    return (p & _M64) ^ (p >> 64)


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    return h ^ (h >> 32)


def _xxh3_avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _P_MX1) & _M64
    return h ^ (h >> 32)


def _rrmxmx(h: int, n: int) -> int:
    h ^= _rotl64(h, 49) ^ _rotl64(h, 24)
    h = (h * _P_MX2) & _M64
    h ^= (h >> 35) + n
    h = (h * _P_MX2) & _M64
    return h ^ (h >> 28)


def _mix16(data: bytes, off: int, soff: int, seed: int) -> int:
    lo = _r64(data, off) ^ ((_r64(_SECRET, soff) + seed) & _M64)
    hi = _r64(data, off + 8) ^ ((_r64(_SECRET, soff + 8) - seed) & _M64)
    return _fold64(lo, hi)


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """XXH3 64-bit hash with seed, bit-identical to
    ``xxhash.xxh3_64_intdigest(data, seed=seed)`` for inputs of at most
    240 bytes. Longer inputs raise ``ValueError``."""
    n = len(data)
    seed &= _M64
    if n > MAX_HASH_BYTES:
        raise ValueError(f"xxh3_64 here covers inputs up to {MAX_HASH_BYTES} bytes, got {n}")
    if n == 0:
        return _xxh64_avalanche(seed ^ _r64(_SECRET, 56) ^ _r64(_SECRET, 64))
    if n <= 3:
        combined = (data[0] << 16) | (data[n >> 1] << 24) | data[n - 1] | (n << 8)
        bitflip = ((_r32(_SECRET, 0) ^ _r32(_SECRET, 4)) + seed) & _M64
        return _xxh64_avalanche(combined ^ bitflip)
    if n <= 8:
        seed ^= _swap32(seed & 0xFFFFFFFF) << 32
        bitflip = ((_r64(_SECRET, 8) ^ _r64(_SECRET, 16)) - seed) & _M64
        keyed = (_r32(data, n - 4) + (_r32(data, 0) << 32)) ^ bitflip
        return _rrmxmx(keyed, n)
    if n <= 16:
        lo = _r64(data, 0) ^ (((_r64(_SECRET, 24) ^ _r64(_SECRET, 32)) + seed) & _M64)
        hi = _r64(data, n - 8) ^ (((_r64(_SECRET, 40) ^ _r64(_SECRET, 48)) - seed) & _M64)
        acc = (n + _swap64(lo) + hi + _fold64(lo, hi)) & _M64
        return _xxh3_avalanche(acc)
    acc = (n * _P64_1) & _M64
    if n <= 128:
        if n > 32:
            if n > 64:
                if n > 96:
                    acc += _mix16(data, 48, 96, seed) + _mix16(data, n - 64, 112, seed)
                acc += _mix16(data, 32, 64, seed) + _mix16(data, n - 48, 80, seed)
            acc += _mix16(data, 16, 32, seed) + _mix16(data, n - 32, 48, seed)
        acc += _mix16(data, 0, 0, seed) + _mix16(data, n - 16, 16, seed)
        return _xxh3_avalanche(acc & _M64)
    for i in range(8):
        acc += _mix16(data, 16 * i, 16 * i, seed)
    acc = _xxh3_avalanche(acc & _M64)
    for i in range(8, n // 16):
        acc += _mix16(data, 16 * i, 16 * (i - 8) + 3, seed)
    acc += _mix16(data, n - 16, 136 - 17, seed)
    return _xxh3_avalanche(acc & _M64)


def hash_tokens(tokens: Sequence[int], seed: int = ROOT_SEED) -> int:
    """xxh3_64 over little-endian u32 token ids, seeded."""
    return xxh3_64(struct.pack(f"<{len(tokens)}I", *tokens), seed)


def compute_block_hashes(tokens: Sequence[int], block_size: int) -> List[BlockHash]:
    """Chained hashes for each *complete* block of the token sequence.

    block_hash[i] = xxh3(tokens[i*bs:(i+1)*bs], seed=block_hash[i-1])
    Partial trailing blocks get no hash (they are not reusable).
    """
    return extend_block_hashes([], tokens, block_size)


def extend_block_hashes(
    prev_hashes: List[BlockHash], tokens: Sequence[int], block_size: int
) -> List[BlockHash]:
    """Incrementally extend: hash only blocks beyond len(prev_hashes)."""
    n_full = len(tokens) // block_size
    hashes = list(prev_hashes)
    seed = hashes[-1] if hashes else ROOT_SEED
    native = get_native()
    if native is not None:
        if n_full > len(hashes):
            hashes += native.hash_token_blocks(tokens[len(hashes) * block_size:n_full * block_size], block_size, seed)
        return hashes
    for i in range(len(hashes), n_full):
        h = hash_tokens(tokens[i * block_size : (i + 1) * block_size], seed)
        hashes.append(h)
        seed = h
    return hashes
