"""Ragged paged attention: one kernel launch per layer serves every row of a
step — prefill chunks as wide rows, decode entries as length-1 rows — over
``[paged prefix ; fresh keys]`` under one online softmax.

Same arguments and layouts as the JAX package's
``megakernel.ragged_paged_attention``. On a CUDA tensor it launches the
hand-written Hopper kernel (``csrc/ragged_paged_attention.cu``) or raises;
on a CPU tensor it runs the plain PyTorch version,
``ragged_paged_attention_ref``, which the tests hold against the JAX
function and ``chip_smoke.py`` holds the kernel against on the card.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch import _build

NEG_INF = -1e30

# Launch counters: the kernel's (incremented once per successful launch on
# a CUDA tensor) and the plain version's (once per CPU call). A run that
# resets both and drives the main path shows which one it went through.
KERNEL_LAUNCHES = 0
REF_CALLS = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory one block may use on Hopper (227 KB opt-in).
_MAX_SMEM = 232448


def build_meta(
    row_of: torch.Tensor,  # [NQ] — block-table row of each query
    prefix_len: torch.Tensor,  # [NQ] — cached-prefix length each query attends
    extra_start: torch.Tensor,  # [NQ] — first fresh-key column (incl.)
    extra_end: torch.Tensor,  # [NQ] — fresh-key causal frontier (excl.)
    active: torch.Tensor,  # [NQ] bool/int — dead queries skip pages AND compute
) -> torch.Tensor:
    """Pack per-query ragged metadata into the kernel's [5, NQ] i32 table."""
    return torch.stack(
        [x.to(torch.int32) for x in (row_of, prefix_len, extra_start, extra_end, active)]
    )


def ragged_paged_attention_ref(
    q, k_extra, v_extra, k_pages, v_pages, tables, meta, *, num_kv_heads: int, block_size: int
) -> torch.Tensor:
    """Plain PyTorch version: per block-table row, gather the row's pages
    into a dense prefix, append the fresh keys, mask each query to its
    prefix length and fresh range, and take one softmax in f32. As in the
    TPU kernel, probabilities are cast to v's dtype before the PV product
    and accumulated in f32; queries that see no key, and dead queries,
    return zeros."""
    NQ, H, HD = q.shape
    KVH = num_kv_heads
    G = H // KVH
    W = tables.shape[1]
    CK = k_extra.shape[0]
    dev = q.device
    row_of, prefix_len, e_start, e_end, live = meta.long()
    out = torch.zeros_like(q)
    kpos = torch.arange(W * block_size, device=dev)
    cpos = torch.arange(CK, device=dev)
    for r in torch.unique(row_of[live != 0]).tolist():
        idx = torch.nonzero((row_of == r) & (live != 0)).squeeze(1)
        pages = tables[r].long()
        k = torch.cat([k_pages[pages].reshape(W * block_size, KVH, HD), k_extra]).float()
        v = torch.cat([v_pages[pages].reshape(W * block_size, KVH, HD), v_extra])
        mask = torch.cat(
            [
                kpos[None, :] < prefix_len[idx, None],
                (cpos[None, :] >= e_start[idx, None]) & (cpos[None, :] < e_end[idx, None]),
            ],
            dim=1,
        )[:, None, None, :]  # [n, 1, 1, S]
        qg = q[idx].float().reshape(-1, KVH, G, HD)
        s = torch.einsum("nkgd,skd->nkgs", qg, k) * HD**-0.5
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("nkgs,skd->nkgd", p.to(v.dtype).float(), v.float())
        out[idx] = (o / l.clamp_min(1e-30)).reshape(-1, H, HD).to(q.dtype)
    return out


def _kernel():
    """(launch, smem-bytes) C functions of the built library, typed once."""
    lib = _build.load("ragged_paged_attention")
    launch, smem = lib.dtt_ragged_paged_attention, lib.dtt_ragged_paged_attention_smem
    if launch.argtypes is None:
        launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        launch.restype = ctypes.c_int
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_size_t
    return launch, smem


def _check_args(q, k_extra, v_extra, k_pages, v_pages, tables, meta, num_kv_heads, block_size):
    tensors = {
        "q": q, "k_extra": k_extra, "v_extra": v_extra, "k_pages": k_pages,
        "v_pages": v_pages, "tables": tables, "meta": meta,
    }
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (bfloat16 or float32)")
    for name in ("k_extra", "v_extra", "k_pages", "v_pages"):
        if tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} dtype {tensors[name].dtype} != q dtype {q.dtype}")
    for name in ("tables", "meta"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    if q.dim() != 3:
        raise ValueError(f"q must be [NQ, H, HD], got {tuple(q.shape)}")
    NQ, H, HD = q.shape
    if H % num_kv_heads:
        raise ValueError(f"{H} query heads do not group over {num_kv_heads} KV heads")
    CK = k_extra.shape[0]
    for name in ("k_extra", "v_extra"):
        if tuple(tensors[name].shape) != (CK, num_kv_heads, HD):
            raise ValueError(f"{name} must be [CK, KVH, HD] = {(CK, num_kv_heads, HD)}, got {tuple(tensors[name].shape)}")
    if k_pages.dim() != 4 or tuple(k_pages.shape[1:]) != (block_size, num_kv_heads, HD):
        raise ValueError(f"k_pages must be [NP, {block_size}, {num_kv_heads}, {HD}], got {tuple(k_pages.shape)}")
    if v_pages.shape != k_pages.shape:
        raise ValueError("v_pages and k_pages shapes differ")
    if tables.dim() != 2:
        raise ValueError(f"tables must be [R, W], got {tuple(tables.shape)}")
    if tuple(meta.shape) != (5, NQ):
        raise ValueError(f"meta must be [5, {NQ}], got {tuple(meta.shape)}")


def ragged_paged_attention(
    q: torch.Tensor,  # [NQ, H, HD] post-rope queries
    k_extra: torch.Tensor,  # [CK, KVH, HD] in-flight (not yet cached) keys
    v_extra: torch.Tensor,
    k_pages: torch.Tensor,  # [NP, BS, KVH, HD] layer-flat page pool
    v_pages: torch.Tensor,
    tables: torch.Tensor,  # [R, W] i32 — per-row page ids (layer-offset)
    meta: torch.Tensor,  # [5, NQ] i32 — build_meta
    *,
    num_kv_heads: int,
    block_size: int,
) -> torch.Tensor:
    """Attention for a whole ragged batch over [paged prefix ; fresh keys].
    Returns normalized ``[NQ, H, HD]`` in q's dtype; dead queries return
    zeros. CUDA tensors launch the Hopper kernel (or raise); CPU tensors
    run ``ragged_paged_attention_ref``."""
    global KERNEL_LAUNCHES, REF_CALLS
    if q.device.type == "cpu":
        REF_CALLS += 1
        return ragged_paged_attention_ref(
            q, k_extra, v_extra, k_pages, v_pages, tables, meta,
            num_kv_heads=num_kv_heads, block_size=block_size,
        )
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu tensors, got {q.device}")
    _check_args(q, k_extra, v_extra, k_pages, v_pages, tables, meta, num_kv_heads, block_size)
    NQ, H, HD = q.shape
    launch, smem_fn = _kernel()
    smem = smem_fn(H // num_kv_heads, HD, block_size)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"G={H // num_kv_heads}, HD={HD}, BS={block_size} needs {smem} bytes of shared "
            f"memory per block, over the card's {_MAX_SMEM}"
        )
    out = torch.empty_like(q)
    if NQ == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(
            _DTYPE_CODE[q.dtype],
            q.data_ptr(), k_extra.data_ptr(), v_extra.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(), meta.data_ptr(),
            out.data_ptr(),
            NQ, H, num_kv_heads, HD, k_extra.shape[0], tables.shape[1], block_size,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: cudaError {rc}")
    KERNEL_LAUNCHES += 1
    return out
