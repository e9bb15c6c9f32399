"""The port's own copy of the ``jax.random`` functions the scheduler draws
with: threefry2x32 keys, ``fold_in``, ``split``, and the partitionable
random bits (``jax_threefry_partitionable=True``, JAX's default) under
``uniform``, ``gumbel`` and ``categorical``. Bit-for-bit the values
``jax.random`` gives for the same key (``tests/test_torch_prng.py``), so a
seeded request draws the same tokens in both packages.

Keys are numpy ``uint32`` arrays of shape ``[..., 2]`` (JAX's raw key
data). Key arithmetic runs in numpy (``split_many`` gives a window's
successive subkeys at once, for one upload); draws of a shape (``[B, V]``
for a sampling step) run as torch ``int64`` tensor ops on the given
device, with every add, shift and rotate masked back to 32 bits. A draw
also takes its keys as a tensor ``[*K, 2]`` already on the device (int32
or int64 holding the uint32 bits), so a CUDA graph reads them from its
static input buffer; constants are Python scalars, never uploaded, so a
draw is safe under stream capture. A draw for a batch of keys ``[*K, 2]``
is ``vmap`` of the single-key draw: each key's values are what that key
alone gives.

Read from ``jax/_src/prng.py`` and ``jax/_src/random.py``:
- ``threefry2x32``: 20 rounds of Threefry-2x32 with JAX's rotations and
  key schedule;
- a draw of ``shape`` hashes the 64-bit flat index ``n`` of each element as
  the counter pair ``(n >> 32, n & 0xFFFFFFFF)`` and keeps ``y0 ^ y1``;
  ``split(key, n)[i]`` and ``fold_in(key, i)`` are the pair ``(y0, y1)`` of
  the counter ``(0, i)``;
- ``uniform``: ``bits >> 9 | 0x3F800000`` read as a float in [1, 2), minus
  1, scaled to ``[minval, maxval)`` by one fused multiply-add;
- ``gumbel``: ``-log(-log(u))``, u uniform in ``[tiny, 1)``, with ``log``
  written out as XLA's CPU ``log`` (the Cephes polynomial it emits), so
  the values agree to the bit, not to an ulp;
- ``categorical``: ``argmax(logits + gumbel)`` along the last axis.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)

Device = Optional[Union[str, torch.device]]


def _threefry(k0, k1, x0, x1):
    """Threefry-2x32 of the counters ``(x0, x1)`` under the key
    ``(k0, k1)``: numpy uint64 or torch int64 values below 2**32,
    broadcast together. Returns ``(y0, y1)`` of the same kind."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M
    x1 = (x1 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = ((x1 << r) & _M) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: ``[0, seed mod
    2**32]``."""
    return np.array([0, int(seed) & _M], dtype=np.uint32)


def threefry2x32(key: np.ndarray, x0, x1):
    """``(y0, y1)`` uint32 of the counters ``(x0, x1)`` under ``key [2]``."""
    key = np.asarray(key, dtype=np.uint64)
    y0, y1 = _threefry(key[..., 0], key[..., 1], np.asarray(x0, np.uint64), np.asarray(x1, np.uint64))
    return y0.astype(np.uint32), y1.astype(np.uint32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """``jax.random.fold_in``: keys ``[..., 2]`` and ``data`` (int or
    array, broadcast against the keys' leading shape) → keys ``[..., 2]``."""
    key = np.asarray(key, dtype=np.uint64)
    d = np.asarray(data, dtype=np.int64).astype(np.uint64) & _M
    y0, y1 = _threefry(key[..., 0], key[..., 1], np.zeros_like(d), d)
    return np.stack([y0, y1], axis=-1).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` → ``[num, 2]``."""
    return fold_in(np.asarray(key)[None], np.arange(num))


def split_many(key: np.ndarray, n: int) -> np.ndarray:
    """The subkeys ``n`` successive ``key, sub = split(key)`` give → ``[n,
    2]`` uint32: a window's per-step keys, made on the host in one go."""
    subs = np.empty((n, 2), dtype=np.uint32)
    for i in range(n):
        key, subs[i] = split(key)
    return subs


def _key_words(key, device: Device) -> torch.Tensor:
    """Keys ``[*K, 2]`` as int64 values below 2**32 on ``device``: a numpy
    key is uploaded, a tensor (int32 bits or int64) stays where it is."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device, dtype=torch.int64) & _M
    return torch.from_numpy(key.astype(np.int64)).to(device)


def random_bits(key, shape: Sequence[int], device: Device = "cpu") -> torch.Tensor:
    """32 random bits per element of ``shape`` for each key of ``key
    [*K, 2]`` (numpy, or a tensor on ``device``) → int64 tensor ``[*K,
    *shape]`` on ``device`` (values below 2**32)."""
    if not isinstance(key, torch.Tensor):
        key = np.asarray(key, dtype=np.uint32)
    lead, shape = tuple(key.shape[:-1]), tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    k = _key_words(key, device)
    k0 = k[..., 0].reshape(lead + (1,) * len(shape))
    k1 = k[..., 1].reshape(lead + (1,) * len(shape))
    y0, y1 = _threefry(k0, k1, idx >> 32, idx & _M)
    return (y0 ^ y1).expand(lead + shape)


def _float01(bits: torch.Tensor) -> torch.Tensor:
    """Uniform float32 in [0, 1) from 32 random bits (the top 23 as the
    mantissa of a float in [1, 2), minus 1)."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key, shape: Sequence[int] = (), minval: float = 0.0, maxval: float = 1.0,
            device: Device = "cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for each
    key of ``key [*K, 2]`` → float32 ``[*K, *shape]``."""
    lo = _f32(minval)
    span = float(np.float32(maxval) - np.float32(minval))  # float32 arithmetic, as XLA's
    f = _float01(random_bits(key, shape, device))
    return torch.clamp(_fma(f, span, lo), min=lo)  # XLA fuses it


def _f32(c: float) -> float:
    """``c`` rounded to float32, as a Python scalar (exact in a float32 op)."""
    return float(np.float32(c))


# XLA's CPU log for float32: Cephes' logf polynomial in the order XLA emits
# it, with the multiply-adds the x86 backend fuses (one rounding each) and
# the other products and sums rounded to float32 one by one.
_SQRTHF = _f32(0.707106769084930419921875)
_LOG_P = tuple(_f32(c) for c in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
                                 1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
                                 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_MIN_NORMAL = 1.1754943508222875e-38


def _double(x):
    return x.double() if isinstance(x, torch.Tensor) else float(x)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add (``b``
    and ``c`` tensors or float32-exact scalars). The product is exact in
    float64; the float64 sum rounds once more, which misleads the final
    rounding only when it lands exactly halfway between two float32 values
    with a nonzero residual: then step it one float64 ulp toward the exact
    sum first."""
    p = a.double() * _double(b)
    c = _double(c)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)  # s + err == p + c exactly (TwoSum)
    halfway = (s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000
    s = torch.where(halfway & (err != 0), torch.nextafter(s, s + err), s)
    return s.float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of a float32 tensor, bit-equal to XLA's CPU ``log`` on
    x86 with FMA (the code the tests' JAX runs)."""
    p = _LOG_P
    xc = torch.where(x <= _MIN_NORMAL, _MIN_NORMAL, x)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    mant = ((bits & -2139095041) | 1056964608).view(torch.float32)  # mantissa in [0.5, 1)
    small = mant < _SQRTHF
    e = e - small.to(torch.float32)
    m = (mant - 1.0) + torch.where(small, mant, 0.0)
    m2 = m * m
    m3 = m2 * m
    y = _fma(m, _fma(m, p[0], p[1]), p[2])
    y1 = _fma(m, _fma(m, p[3], p[4]), p[5])
    y2 = _fma(m, _fma(m, p[6], p[7]), p[8])
    y = _fma(m3, y, y1)
    y = _fma(m3, y, y2)
    y = _fma(m3, y, e * _LOG_Q1)
    r = y + _fma(m2, -0.5, m)
    r = _fma(e, _LOG_Q2, r)
    # Special values; subnormal inputs count as zero (XLA's CPU code runs
    # with denormals-are-zero).
    r = torch.where(x > 0, r, float("nan"))
    r = torch.where(x.abs() < _MIN_NORMAL, -float("inf"), r)
    return torch.where(x == float("inf"), x, r)


def gumbel(key, shape: Sequence[int], device: Device = "cpu") -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (float32, mode "low") for each key
    of ``key [*K, 2]`` → ``[*K, *shape]``."""
    u = uniform(key, shape, _TINY, 1.0, device)
    return -xla_log(-xla_log(u))


def categorical(key: np.ndarray, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: ``argmax(logits +
    gumbel)`` over the last axis, the first index among equal maxima →
    int64 ``logits.shape[:-1]``. With keys ``[*K, 2]`` and logits ``[*K,
    V]``, each row draws from its own key (``vmap`` of the one-key draw)."""
    key = np.asarray(key)
    shape = tuple(logits.shape) if key.ndim == 1 else (logits.shape[-1],)
    return torch.argmax(logits + gumbel(key, shape, logits.device), dim=-1)
