"""Flash chunk attention: causal self-attention inside one prefill chunk.

Same arguments, layouts and results as the JAX package's
``attention/prefill.py``: ``flash_chunk_attention`` returns the normalized
output and the online-softmax state ``(m, l)`` of every query row, so a
cached-prefix piece computed outside the kernel merges with it through
``merge_attention_pieces``. On a CUDA tensor it launches the hand-written
Hopper kernel (``csrc/flash_chunk_attention.cu``: bf16 on the tensor cores
through wgmma, its K/V tiles brought in by TMA; f32 on CUDA cores) or
raises; on a CPU tensor it runs the plain PyTorch version,
``flash_chunk_attention_ref``, which the tests hold against the JAX
function and ``chip_smoke.py`` holds the kernel against on the card.

Masking: query ``t`` sees key ``j`` iff ``j <= t`` and ``j < valid_len``.
Padded queries (``t >= valid_len``) therefore attend all ``valid_len``
keys and return real numbers, as in the TPU kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dynamo_tpu_torch import _build

NEG_INF = -1e30

# Launch counters: the kernel's (once per launch on a CUDA tensor) and the
# plain version's (once per CPU call).
KERNEL_LAUNCHES = 0
REF_CALLS = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
# Query rows (query, grouped head) one block owns; G above it cannot tile.
_ROWS = 64
_MAX_SMEM = 232448


def flash_chunk_attention_ref(
    q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor, valid_len: int, *, num_kv_heads: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: one masked softmax over the chunk in f32.
    As in the TPU kernel, probabilities are cast to v's dtype before the PV
    product, which accumulates in f32, while ``l`` sums them uncast."""
    T, H, HD = q.shape
    KVH = num_kv_heads
    G = H // KVH
    qg = q.float().reshape(T, KVH, G, HD)
    s = torch.einsum("tkgd,skd->tkgs", qg, k_new.float()) * HD**-0.5
    pos = torch.arange(T, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] < valid_len)  # [T(query), T(key)]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)  # [T, KVH, G]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("tkgs,skd->tkgd", p.to(v_new.dtype).float(), v_new.float())
    out = (acc / l.clamp_min(1e-30)[..., None]).reshape(T, H, HD).to(q.dtype)
    return out, m, l


def merge_attention_pieces(
    out2: torch.Tensor,  # [T, H, HD] normalized chunk piece (the kernel's output)
    m2: torch.Tensor,  # [T, KVH, G]
    l2: torch.Tensor,
    m1: torch.Tensor,  # [KVH, T, G] cached-prefix piece (ragged.py layout)
    l1: torch.Tensor,
    acc1: torch.Tensor,  # [KVH, T, G, HD] f32, unnormalized
) -> torch.Tensor:
    """Close the online softmax across the [cached prefix ; chunk] pieces."""
    T, H, HD = out2.shape
    KVH = m1.shape[0]
    G = H // KVH
    m2t = m2.transpose(0, 1)  # [KVH, T, G]
    l2t = l2.transpose(0, 1)
    acc2 = out2.reshape(T, KVH, G, HD).transpose(0, 1).float() * l2t[..., None]
    m_t = torch.maximum(m1, m2t)
    a1 = torch.exp(m1 - m_t)
    a2 = torch.exp(m2t - m_t)
    l_t = l1 * a1 + l2t * a2
    acc = acc1 * a1[..., None] + acc2 * a2[..., None]
    out = acc / l_t.clamp_min(1e-30)[..., None]  # [KVH, T, G, HD]
    return out.transpose(0, 1).reshape(T, H, HD).to(out2.dtype)


def _kernel():
    lib = _build.load("flash_chunk_attention")
    launch, smem = lib.dtt_flash_chunk_attention, lib.dtt_flash_chunk_attention_smem
    if launch.argtypes is None:
        launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
        smem.argtypes = [ctypes.c_int] * 2
        smem.restype = ctypes.c_size_t
    return launch, smem


def _check_args(q, k_new, v_new, valid_len, num_kv_heads):
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (bfloat16 or float32)")
    if q.dim() != 3:
        raise ValueError(f"q must be [T, H, HD], got {tuple(q.shape)}")
    T, H, HD = q.shape
    if H % num_kv_heads:
        raise ValueError(f"{H} query heads do not group over {num_kv_heads} KV heads")
    if H // num_kv_heads > _ROWS:
        raise ValueError(f"G={H // num_kv_heads} query heads per KV head; the kernel tiles at most {_ROWS}")
    if HD not in _HEAD_DIMS:
        raise ValueError(f"head_dim {HD} not supported by the kernel (one of {_HEAD_DIMS})")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel loads 16-byte vectors or TMA boxes)")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (T, num_kv_heads, HD):
            raise ValueError(f"{name} must be [T, KVH, HD] = {(T, num_kv_heads, HD)}, got {tuple(t.shape)}")


def flash_chunk_attention(
    q: torch.Tensor,  # [T, H, HD] post-rope
    k_new: torch.Tensor,  # [T, KVH, HD] post-rope
    v_new: torch.Tensor,  # [T, KVH, HD]
    valid_len: int,  # keys (and real queries) of the chunk; the rest is padding
    *,
    num_kv_heads: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal chunk self-attention with online softmax. Returns
    ``(out [T, H, HD] in q's dtype, m [T, KVH, G] f32, l [T, KVH, G] f32)``.
    CUDA tensors launch the Hopper kernel (or raise); CPU tensors run
    ``flash_chunk_attention_ref``."""
    global KERNEL_LAUNCHES, REF_CALLS
    valid_len = int(valid_len)
    if not 1 <= valid_len <= q.shape[0]:
        raise ValueError(f"valid_len {valid_len} outside [1, {q.shape[0]}]")
    if q.device.type == "cpu":
        REF_CALLS += 1
        return flash_chunk_attention_ref(q, k_new, v_new, valid_len, num_kv_heads=num_kv_heads)
    if q.device.type != "cuda":
        raise ValueError(f"flash_chunk_attention runs on cuda or cpu tensors, got {q.device}")
    _check_args(q, k_new, v_new, valid_len, num_kv_heads)
    T, H, HD = q.shape
    G = H // num_kv_heads
    launch, smem_fn = _kernel()
    smem = smem_fn(_DTYPE_CODE[q.dtype], HD)
    if smem > _MAX_SMEM:
        raise ValueError(f"HD={HD} needs {smem} bytes of shared memory per block, over {_MAX_SMEM}")
    out = torch.empty_like(q)
    m = torch.empty((T, num_kv_heads, G), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            out.data_ptr(), m.data_ptr(), l.data_ptr(),
            T, H, num_kv_heads, HD, valid_len, stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_chunk_attention kernel launch failed: cudaError {rc}")
    KERNEL_LAUNCHES += 1
    return out, m, l
