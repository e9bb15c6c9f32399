"""Device↔host KV block movement: the ``block_copy.cu`` role.

The counterpart of the JAX package's ``llm/block_manager/transfer.py``. The
JAX module jits XLA gathers and scatters; here they are PyTorch indexing
(``index_select``, ``index_copy_``, ``copy_``) on the cache's device. Every
write lands in the cache's existing tensors: the step graphs
(``engine/graphs.py``) captured their addresses, so a scatter never
rebinds ``cache.k`` / ``cache.v``.

Layouts: a block is ``[L, BS, KVH, HD]``; a stack of n blocks is
``[L, n, BS, KVH, HD]``, the cache's own layout, so a stack moves in one
gather and one scatter. Host blocks are CPU tensors.

int8 caches cross as real-valued rows, as in JAX: a single block gathers
to float32 and a device stack to bfloat16 (code × scale in float32, then
cast); a scatter requantizes (``quantize_kv_rows``). Requantizing a
dequantized row recomputes its scale to float rounding, so a round trip is
stable within one int8 code step, and payloads interoperate between
workers with different ``kv_cache_dtype``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays, QuantKv, quantize_kv_rows


def _has_v(cache: KvCacheArrays) -> bool:
    """An MLA cache carries everything in ``k``; its ``v`` is a placeholder
    of another shape that must not be block-indexed."""
    return tuple(cache.v.shape[1:]) == tuple(cache.k.shape[1:])


def _ids(block_ids, device) -> torch.Tensor:
    return torch.as_tensor(list(block_ids), dtype=torch.long, device=device)


def _device_of(cache: KvCacheArrays) -> torch.device:
    k = cache.k.q if isinstance(cache.k, QuantKv) else cache.k
    return k.device


def _dequant(qkv: QuantKv, ids: torch.Tensor) -> torch.Tensor:
    """float32 rows of the blocks ``ids``: ``[L, n, BS, KVH, HD]``."""
    return qkv.q.index_select(1, ids).float() * qkv.scale.index_select(1, ids)


def _write(t, ids: torch.Tensor, rows: torch.Tensor) -> None:
    """Blocks ``ids`` of one cache member ← ``rows`` (``[L, n, ...]``), in
    place; an int8 member takes the rows' codes and scales."""
    if isinstance(t, QuantKv):
        qk = quantize_kv_rows(rows.to(t.q.device))
        t.q.index_copy_(1, ids, qk.q)
        t.scale.index_copy_(1, ids, qk.scale)
    else:
        t.index_copy_(1, ids, rows.to(device=t.device, dtype=t.dtype))


# --- one block (KVBM offload / onboard, the host wire) ----------------------


def gather_blocks_async(cache: KvCacheArrays, block_id: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A device copy of one block, with no host sync. It is queued on the
    current stream before any later write to the block, so it stays a
    consistent snapshot although the caller reuses the block at once; the
    host copy happens when the offload queue drains
    (``KvBlockManager.flush_pending``)."""
    ids = _ids([block_id], _device_of(cache))
    if isinstance(cache.k, QuantKv):
        return _dequant(cache.k, ids)[:, 0], _dequant(cache.v, ids)[:, 0] if _has_v(cache) else None
    if not _has_v(cache):
        return cache.k.index_select(1, ids)[:, 0], None
    return cache.k.index_select(1, ids)[:, 0], cache.v.index_select(1, ids)[:, 0]


def gather_blocks(cache: KvCacheArrays, block_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device block → host tensors ``(k, v)``, each ``[L, BS, KVH, HD]``
    (an empty ``v`` for an MLA cache)."""
    return gather_blocks_host(cache, [block_id])[0]


def scatter_blocks(cache: KvCacheArrays, block_id: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """Host block → device block ``block_id``, in place."""
    ids = _ids([block_id], _device_of(cache))
    _write(cache.k, ids, k.unsqueeze(1))
    if _has_v(cache) and v.numel():
        _write(cache.v, ids, v.unsqueeze(1))


def gather_blocks_host(cache: KvCacheArrays, block_ids) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``[gather_blocks(cache, b) for b in block_ids]`` in one device → host
    copy."""
    ids = _ids(block_ids, _device_of(cache))
    if isinstance(cache.k, QuantKv):
        k, v = _dequant(cache.k, ids), _dequant(cache.v, ids) if _has_v(cache) else None
    else:
        k = cache.k.index_select(1, ids)
        v = cache.v.index_select(1, ids) if _has_v(cache) else None
    host = (torch.stack([k, v]) if v is not None else k[None]).cpu()
    empty = torch.zeros((0,), dtype=host.dtype)
    return [(host[0, :, i].contiguous(), host[1, :, i].contiguous() if v is not None else empty)
            for i in range(len(ids))]


# --- stacks (the device-native disagg path, KVBM's batched onboard) ----------


def gather_blocks_device(cache: KvCacheArrays, block_ids) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Stack blocks into fresh device tensors ``[L, n, BS, KVH, HD]`` (no
    host round trip). The stack is independent of the cache, so the source
    blocks may be released at once while the stack awaits a pull."""
    ids = _ids(block_ids, _device_of(cache))
    if isinstance(cache.k, QuantKv):
        # An int8 MLA cache's v is a plain placeholder: no blocks to take.
        v = _dequant(cache.v, ids).to(torch.bfloat16) if _has_v(cache) else None
        return _dequant(cache.k, ids).to(torch.bfloat16), v
    k = cache.k.index_select(1, ids)
    v = cache.v.index_select(1, ids) if _has_v(cache) else None
    return k, v


def scatter_blocks_device(cache: KvCacheArrays, block_ids, k_stack: torch.Tensor,
                          v_stack: Optional[torch.Tensor]) -> None:
    """Write stacked blocks into the cache's blocks ``block_ids``, in place
    (one ``index_copy_`` a member; a stack on another device is copied over
    first)."""
    ids = _ids(block_ids, _device_of(cache))
    _write(cache.k, ids, k_stack)
    if v_stack is not None and _has_v(cache):
        _write(cache.v, ids, v_stack)


def copy_blocks_between(src: KvCacheArrays, src_ids: Sequence[int], dst: KvCacheArrays,
                        dst_ids: Sequence[int]) -> None:
    """Cache → cache block copy on the device, for two engines in one
    process. int8 → int8 moves codes and scales as they are; a mixed pair
    crosses through a stack."""
    s = _ids(src_ids, _device_of(src))
    d = _ids(dst_ids, _device_of(dst))
    if isinstance(src.k, QuantKv) and isinstance(dst.k, QuantKv):
        for a, b in ((src.k, dst.k), (src.v, dst.v))[: 2 if _has_v(src) else 1]:
            b.q.index_copy_(1, d, a.q.index_select(1, s).to(b.q.device))
            b.scale.index_copy_(1, d, a.scale.index_select(1, s).to(b.scale.device))
        return
    k_stack, v_stack = gather_blocks_device(src, list(src_ids))
    scatter_blocks_device(dst, list(dst_ids), k_stack, v_stack)
