"""Paged flash-decode partials: one query per row over its cached prefix.

Same arguments and results as the JAX package's ``attention/decode.py``:
``paged_decode_partials`` walks each row's block table up to the row's
true length and returns the UNnormalized online-softmax partials
``(m, l, acc)`` in ``models/llama._attend_piece``'s layout, so the decode
step merges them with the current token's in-register piece through
``llama._merge_pieces``. A row of length 0 returns the empty piece
``(m = -1e30, l = 0, acc = 0)``, which drops out of the merge.

On a CUDA tensor it launches the hand-written Hopper kernel
(``csrc/paged_decode_partials.cu``) or raises; on a CPU tensor it runs the
plain PyTorch version, ``paged_decode_partials_ref``. The kernel splits
each row's keys over ``num_splits(W, block_size)`` blocks of
``split_keys(W, block_size)`` keys and merges them inside the same
launch; the split count comes from the table's width, so the wrapper
never reads ``lengths`` back to the host.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from dynamo_tpu_torch import _build

NEG_INF = -1e30

KERNEL_LAUNCHES = 0
REF_CALLS = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_SMEM = 232448
# Keys one block of the kernel takes from a row (rounded to whole pages),
# and the most blocks a row is split over (the kernel's merge keeps one
# weight per split and head in its [G, 64] score tile).
_SPLIT_KEYS = 256
_MAX_SPLITS = 64
# Per device: the kernel's per-(row, KV head) arrival counters. Zero
# between launches (the last block of each row resets its own), so they
# are zeroed once, when allocated; the scheduler sizes them up front
# (``reserve_counters``), so they never move once a step has run.
_COUNTERS: Dict[torch.device, torch.Tensor] = {}
# Counters that a growth replaced (either table's): a CUDA graph captured
# before the growth holds their address and goes on using them.
_SUPERSEDED: List[torch.Tensor] = []


def split_keys(width: int, block_size: int) -> int:
    """Keys per split of a table ``width`` pages wide: ``_SPLIT_KEYS``
    rounded down to whole pages (at least one), or more pages where the
    table would take more than ``_MAX_SPLITS`` splits."""
    return block_size * max(1, _SPLIT_KEYS // block_size, -(-width // _MAX_SPLITS))


def num_splits(width: int, block_size: int) -> int:
    """Blocks per (row, KV head): enough splits for a row as long as the
    table, at least one."""
    return max(1, -(-width * block_size // split_keys(width, block_size)))


def grow_counters(device: torch.device, n: int, table: Dict[torch.device, torch.Tensor]) -> torch.Tensor:
    """``table``'s counters on ``device`` with room for ``n``, allocated or
    grown (zeroed) outside a stream capture only. The tensor a growth
    replaces is kept alive (``_SUPERSEDED``): a graph captured earlier holds
    its address and goes on writing it on every replay."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    counters = table.get(device)
    if counters is None or counters.numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"split counters for {n} (query, KV head) slots grow under a CUDA graph capture; "
                               "reserve_counters must size them before the first capture")
        if counters is not None:
            _SUPERSEDED.append(counters)
        counters = table[device] = torch.zeros(max(n, 1), dtype=torch.int32, device=device)
    return counters


def reserve_counters(device, n: int) -> None:
    """Size the arrival counters on ``device`` for ``n`` = the largest
    rows · KV heads a launch will have, before any capture."""
    grow_counters(torch.device(device), n, _COUNTERS)


def paged_decode_partials_ref(
    q, k_pages, v_pages, tables, lengths, *, num_kv_heads: int, block_size: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: gather every row's pages dense, mask keys at
    or past the row's length, and take the partials in f32. Probabilities
    are cast to v's dtype before the PV product, as in the TPU kernel."""
    B, H, HD = q.shape
    KVH = num_kv_heads
    G = H // KVH
    W = tables.shape[1]
    ctx = W * block_size
    idx = tables.long()
    k = k_pages[idx].reshape(B, ctx, KVH, HD).float()
    v = v_pages[idx].reshape(B, ctx, KVH, HD)
    mask = (torch.arange(ctx, device=q.device)[None, :] < lengths.long()[:, None])[:, None, None, :]
    s = torch.einsum("bkgd,bskd->bkgs", q.float().reshape(B, KVH, G, HD), k) * HD**-0.5
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)  # [B, KVH, G]; NEG_INF for an empty row
    p = torch.exp(s - m[..., None]) * mask
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype).float(), v.float())
    return m, l, acc


def _kernel():
    lib = _build.load("paged_decode_partials")
    launch, smem = lib.dtt_paged_decode_partials, lib.dtt_paged_decode_partials_smem
    if launch.argtypes is None:
        launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_size_t
    return launch, smem


def _check_args(q, k_pages, v_pages, tables, lengths, num_kv_heads, block_size):
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages, "tables": tables, "lengths": lengths}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (bfloat16 or float32)")
    for name in ("k_pages", "v_pages"):
        if tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} dtype {tensors[name].dtype} != q dtype {q.dtype}")
    for name in ("tables", "lengths"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    if q.dim() != 3:
        raise ValueError(f"q must be [B, H, HD], got {tuple(q.shape)}")
    B, H, HD = q.shape
    if H % num_kv_heads:
        raise ValueError(f"{H} query heads do not group over {num_kv_heads} KV heads")
    if HD not in _HEAD_DIMS:
        raise ValueError(f"head_dim {HD} not supported by the kernel (one of {_HEAD_DIMS})")
    for name in ("k_pages", "v_pages"):
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel loads 16-byte vectors)")
    if k_pages.dim() != 4 or tuple(k_pages.shape[1:]) != (block_size, num_kv_heads, HD):
        raise ValueError(f"k_pages must be [NP, {block_size}, {num_kv_heads}, {HD}], got {tuple(k_pages.shape)}")
    if v_pages.shape != k_pages.shape:
        raise ValueError("v_pages and k_pages shapes differ")
    if tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"tables must be [{B}, W], got {tuple(tables.shape)}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be [{B}], got {tuple(lengths.shape)}")


def paged_decode_partials(
    q: torch.Tensor,  # [B, H, HD] post-rope current-token queries
    k_pages: torch.Tensor,  # [NP, BS, KVH, HD] layer-flat page pool
    v_pages: torch.Tensor,
    tables: torch.Tensor,  # [B, W] i32 page ids (layer-offset); slots past a row's length → 0
    lengths: torch.Tensor,  # [B] i32 true prefix length (0 = empty row)
    *,
    num_kv_heads: int,
    block_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefix-piece decode attention over the paged cache. Returns
    ``(m [B, KVH, G], l [B, KVH, G], acc [B, KVH, G, HD])`` in f32,
    unnormalized. CUDA tensors launch the Hopper kernel (or raise); CPU
    tensors run ``paged_decode_partials_ref``."""
    global KERNEL_LAUNCHES, REF_CALLS
    if q.device.type == "cpu":
        REF_CALLS += 1
        return paged_decode_partials_ref(
            q, k_pages, v_pages, tables, lengths, num_kv_heads=num_kv_heads, block_size=block_size
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_partials runs on cuda or cpu tensors, got {q.device}")
    _check_args(q, k_pages, v_pages, tables, lengths, num_kv_heads, block_size)
    B, H, HD = q.shape
    G = H // num_kv_heads
    launch, smem_fn = _kernel()
    smem = smem_fn(_DTYPE_CODE[q.dtype], G, HD)
    if smem > _MAX_SMEM:
        raise ValueError(f"G={G}, HD={HD} needs {smem} bytes of shared memory per block, over {_MAX_SMEM}")
    m = torch.empty((B, num_kv_heads, G), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((B, num_kv_heads, G, HD), dtype=torch.float32, device=q.device)
    if B == 0:
        return m, l, acc
    W = tables.shape[1]
    splits = num_splits(W, block_size)
    # Each split's (m, l, acc) when a row has more than one; never zeroed.
    scratch = torch.empty(B * num_kv_heads * G * (HD + 2) * splits if splits > 1 else 0,
                          dtype=torch.float32, device=q.device)
    counters = grow_counters(q.device, B * num_kv_heads, _COUNTERS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            tables.data_ptr(), lengths.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            scratch.data_ptr(), counters.data_ptr(),
            B, H, num_kv_heads, HD, W, block_size, split_keys(W, block_size), splits, stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_decode_partials kernel launch failed: cudaError {rc}")
    KERNEL_LAUNCHES += 1
    return m, l, acc
