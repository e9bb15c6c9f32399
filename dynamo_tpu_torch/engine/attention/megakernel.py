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
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dynamo_tpu_torch import _build
from dynamo_tpu_torch.engine.sampling import sample_from_uniforms

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


# ---------------------------------------------------------------------------
# Fused multi-step decode window (one launch per window)
# ---------------------------------------------------------------------------

# The fused window's own counters, kept apart from the ragged kernel's; the
# windows with the sampled epilogue are also counted apart.
WINDOW_KERNEL_LAUNCHES = 0
WINDOW_REF_CALLS = 0
WINDOW_SAMPLED_LAUNCHES = 0
WINDOW_SAMPLED_REF_CALLS = 0

# The kernel is instantiated for these batch sizes (the decode buckets) and
# these head dims; GEMV tiles are 16 columns wide, so the model's widths must
# be multiples of 16.
WINDOW_BATCHES = (1, 2, 4, 8, 16, 32)
WINDOW_HEAD_DIMS = (16, 32, 64, 128)
_WINDOW_TILE = 16
# Blocks per SM the cooperative grid uses at most (fewer if occupancy says so).
_WINDOW_BLOCKS_PER_SM = 2
# At most this many key splits per (row, KV head) in the window's attention.
_WINDOW_MAX_SPLITS = 16
_window_grid_cache: dict = {}


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (n * w.float()).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-halves rotary embedding (``llama.apply_rope``'s math) of
    ``x [B, heads, HD]`` at ``positions [B]``, in f32, cast back."""
    hd = x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    angles = positions[:, None].float() * (1.0 / theta**exps)
    cos, sin = torch.cos(angles)[:, None, :], torch.sin(angles)[:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def fused_decode_window_ref(
    embed, head, final_norm, attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up, w_down,
    k_cache, v_cache, tokens, positions, tables, active, temps=None, top_ks=None, top_ps=None, uniforms=None,
    *, num_steps: int, num_heads: int, num_kv_heads: int, head_dim: int, block_size: int,
    rms_eps: float, theta: float,
) -> torch.Tensor:
    """Plain PyTorch version of the fused window: ``num_steps`` decode
    steps over every layer, the JAX ``_fused_window_kernel``'s math and cast
    points. Per step: embed (step 0 from ``tokens``, later steps from the
    previous pick); per layer RMS norm, QKV, rope at ``positions + i``, the
    row's K/V written into the cache first (dead rows to block 0, offset
    0), attention over the row's pages masked to ``kpos <= pos``, ``wo``
    and the residual, RMS norm, SwiGLU and the residual; then final norm,
    head and the pick: argmax (first index among equal maxima) or, with
    ``uniforms [num_steps, B]``, ``sampling.sample_from_uniforms(logits,
    temps, top_ks, top_ps, uniforms[i])``. Every product accumulates in f32
    and is cast to the weight dtype, the residual stays in that dtype, and
    p is cast to it before PV. Dead rows attend nothing (zeros), as in the
    kernel; their tokens are unspecified. ``head`` is ``[D, V]``, or None
    for tied embeddings. Writes the caches in place; returns ``tokens
    [num_steps, B]`` int32."""
    L, N, BS, KVH, HD = k_cache.shape
    B, W = tokens.shape[0], tables.shape[1]
    H, G = num_heads, num_heads // num_kv_heads
    V = embed.shape[0]
    dev = tokens.device
    out = torch.empty((num_steps, B), dtype=torch.int32, device=dev)
    toks = tokens.long().clamp(0, V - 1)
    live = active.bool()
    tabs = tables.long()
    rows = torch.arange(B, device=dev)
    kpos = torch.arange(W * BS, device=dev)
    head_w = head if head is not None else embed.T
    for i in range(num_steps):
        pos = positions.long() + i
        slot = torch.where(live, pos, torch.zeros_like(pos))
        blk = torch.where(live, tabs[rows, (slot // BS).clamp(max=W - 1)], torch.zeros_like(slot))
        off = slot % BS
        mask = (kpos[None, :] <= pos[:, None])[:, None, None, :]  # [B, 1, 1, W*BS]
        h = embed[toks]
        for l in range(L):
            x = _rms(h, attn_norm[l], rms_eps)
            q = _rope((x @ wq[l]).view(B, H, HD), pos, theta)
            k = _rope((x @ wk[l]).view(B, KVH, HD), pos, theta)
            v = (x @ wv[l]).view(B, KVH, HD)
            k_cache[l, blk, off] = k.to(k_cache.dtype)
            v_cache[l, blk, off] = v.to(v_cache.dtype)
            kb = k_cache[l][tabs].reshape(B, W * BS, KVH, HD).to(x.dtype)
            vb = v_cache[l][tabs].reshape(B, W * BS, KVH, HD).to(x.dtype)
            s = torch.einsum("bkgd,bskd->bkgs", q.view(B, KVH, G, HD), kb).float() * HD**-0.5
            s = s.masked_fill(~mask, NEG_INF)
            p = torch.softmax(s, dim=-1).to(x.dtype)
            attn = torch.einsum("bkgs,bskd->bkgd", p, vb).reshape(B, H * HD)
            attn = torch.where(live[:, None], attn, torch.zeros_like(attn))
            h = h + attn @ wo[l]
            x = _rms(h, mlp_norm[l], rms_eps)
            h = h + (F.silu(x @ w_gate[l]) * (x @ w_up[l])) @ w_down[l]
        logits = (_rms(h, final_norm, rms_eps) @ head_w).float()
        if uniforms is None:
            toks = torch.argmax(logits, dim=-1)
        else:
            toks = sample_from_uniforms(logits, temps, top_ks, top_ps, uniforms[i]).long()
        out[i] = toks.to(torch.int32)
    return out


def _window_kernel():
    """(blocks query, launch) C functions of the built library, typed once."""
    lib = _build.load("fused_decode_window")
    blocks, launch = lib.dtt_fused_decode_window_blocks, lib.dtt_fused_decode_window
    if launch.argtypes is None:
        blocks.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        blocks.restype = ctypes.c_int
        launch.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 35 + [ctypes.c_int] * 12
            + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        )
        launch.restype = ctypes.c_int
    return blocks, launch


def window_profile_len(num_steps: int, num_layers: int) -> int:
    """Timer stamps of one profiled window: 1 + steps × (5 per layer + 2)."""
    return 1 + num_steps * (5 * num_layers + 2)


def fused_window_grid(dtype: torch.dtype, batch: int, group: int, head_dim: int, device) -> Tuple[int, int]:
    """(co-resident blocks = occupancy × SMs, SM count) of the fused window
    kernel on ``device`` at this dtype, batch, query heads per KV head and
    head dim, from the kernel's own occupancy query."""
    device = torch.device(device)
    key = (dtype, batch, group, head_dim, device.index)
    if key not in _window_grid_cache:
        blocks_fn, _ = _window_kernel()
        sms = ctypes.c_int(0)
        with torch.cuda.device(device):
            n = blocks_fn(_DTYPE_CODE[dtype], batch, group, head_dim, ctypes.byref(sms))
        if n < 0:
            raise RuntimeError(f"fused_decode_window occupancy query failed: cudaError {-n}")
        _window_grid_cache[key] = (n, sms.value)
    return _window_grid_cache[key]


def fused_window_fits(config, *, batch: int, dtype: torch.dtype, kv_dtype: torch.dtype, device) -> bool:
    """The port's gate for the fused window. The JAX gate is a VMEM budget,
    because the TPU kernel holds the weights and the whole cache on the
    chip; the Hopper kernel streams both from HBM, so this checks only what
    it needs: a dense llama with bf16 or f32 weights and KV of one dtype,
    head dim in ``WINDOW_HEAD_DIMS``, ``batch`` (the largest decode bucket)
    at most 32, widths in multiples of 16, and on the card a cooperative
    grid of at least one block per SM (the kernel's occupancy query)."""
    c = config
    if (c.architecture != "llama" or c.num_experts or c.weight_dtype == "int8"
            or c.kv_cache_dtype == "int8"):
        return False
    if dtype not in _DTYPE_CODE or kv_dtype != dtype:
        return False
    if c.head_dim not in WINDOW_HEAD_DIMS or c.num_heads % c.num_kv_heads:
        return False
    if not 1 <= batch <= WINDOW_BATCHES[-1]:
        return False
    if any(n % _WINDOW_TILE for n in (c.hidden_size, c.intermediate_size, c.vocab_size)):
        return False
    device = torch.device(device)
    if device.type != "cuda":
        return device.type == "cpu"
    bucket = next(b for b in WINDOW_BATCHES if b >= batch)
    blocks, sms = fused_window_grid(dtype, bucket, c.num_heads // c.num_kv_heads, c.head_dim, device)
    return blocks >= sms


def fused_decode_window(
    embed: torch.Tensor,  # [V, D]
    head: Optional[torch.Tensor],  # [D, V], or None: tied, embed read row by row
    final_norm: torch.Tensor,  # [D]
    attn_norm: torch.Tensor,  # [L, D]
    mlp_norm: torch.Tensor,
    wq: torch.Tensor,  # [L, D, HQ]
    wk: torch.Tensor,  # [L, D, HKV]
    wv: torch.Tensor,
    wo: torch.Tensor,  # [L, HQ, D]
    w_gate: torch.Tensor,  # [L, D, F]
    w_up: torch.Tensor,
    w_down: torch.Tensor,  # [L, F, D]
    k_cache: torch.Tensor,  # [L, N, BS, KVH, HD] — written in place
    v_cache: torch.Tensor,
    tokens: torch.Tensor,  # [B] step-0 input tokens
    positions: torch.Tensor,  # [B] write slot of the step-0 token
    tables: torch.Tensor,  # [B, W] block ids — must cover positions + num_steps
    active: torch.Tensor,  # [B] bool
    temps: Optional[torch.Tensor] = None,  # [B] f32 (0 = greedy), with uniforms
    top_ks: Optional[torch.Tensor] = None,  # [B] i32 (0 = off)
    top_ps: Optional[torch.Tensor] = None,  # [B] f32 (1 = off)
    uniforms: Optional[torch.Tensor] = None,  # [num_steps, B] f32: the sampled epilogue's draws
    *,
    num_steps: int,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    block_size: int,
    rms_eps: float,
    theta: float,
    profile: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``num_steps`` decode steps × every layer in ONE launch. Returns
    ``tokens [num_steps, B]`` int32; the window's K/V rows land in the
    caches in place. Greedy, or with ``uniforms`` the sampled epilogue:
    each row with a temperature > 0 draws its token from ``uniforms[i]`` as
    ``sampling.sample_from_uniforms`` does. CUDA tensors launch the
    persistent cooperative kernel (``csrc/fused_decode_window.cu``) or
    raise; CPU tensors run ``fused_decode_window_ref``. ``profile``, an
    int64 CUDA tensor of ``window_profile_len(num_steps, L)``, gets the
    kernel's global-timer stamps (ns): one after the step-0 embedding, then
    per step one after each of the 5 phases of each layer, one after the
    head and one after the pick and next embedding (the plain version
    stamps nothing)."""
    global WINDOW_KERNEL_LAUNCHES, WINDOW_REF_CALLS, WINDOW_SAMPLED_LAUNCHES, WINDOW_SAMPLED_REF_CALLS
    weights = [embed, final_norm, attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up, w_down]
    weights += [head] if head is not None else []
    kw = dict(num_steps=num_steps, num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
              block_size=block_size, rms_eps=rms_eps, theta=theta)
    sampled = uniforms is not None
    if sampled and (temps is None or top_ks is None or top_ps is None):
        raise ValueError("the sampled epilogue needs temps, top_ks and top_ps with uniforms")
    if tokens.device.type == "cpu":
        WINDOW_REF_CALLS += 1
        WINDOW_SAMPLED_REF_CALLS += sampled
        return fused_decode_window_ref(
            embed, head, final_norm, attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up, w_down,
            k_cache, v_cache, tokens, positions, tables, active, temps, top_ks, top_ps, uniforms, **kw,
        )
    if tokens.device.type != "cuda":
        raise ValueError(f"fused_decode_window runs on cuda or cpu tensors, got {tokens.device}")
    dev = tokens.device
    dtype = embed.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"weight dtype {dtype} not supported (bfloat16 or float32)")
    for t in weights + [k_cache, v_cache]:
        if t.device != dev:
            raise ValueError(f"a weight or cache is on {t.device}, tokens on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"weights and caches must share one dtype, got {t.dtype} and {dtype}")
        if not t.is_contiguous():
            raise ValueError("weights and caches must be contiguous")
    L, N, BS, KVH, HD = k_cache.shape
    V, D = embed.shape
    F_ = w_gate.shape[2]
    B, W = tokens.shape[0], tables.shape[1]
    H = num_heads
    if v_cache.shape != k_cache.shape or (BS, KVH, HD) != (block_size, num_kv_heads, head_dim):
        raise ValueError(f"cache shape {tuple(k_cache.shape)} does not match the model's")
    if HD not in WINDOW_HEAD_DIMS or H % KVH:
        raise ValueError(f"head dim {HD} or {H} heads over {KVH} KV heads not supported")
    if B not in WINDOW_BATCHES:
        raise ValueError(f"batch {B} is not one of {WINDOW_BATCHES}")
    if any(n % _WINDOW_TILE for n in (D, F_, V)):
        raise ValueError(f"widths D={D}, F={F_}, V={V} must be multiples of {_WINDOW_TILE}")
    expect = {"wq": (L, D, H * HD), "wk": (L, D, KVH * HD), "wv": (L, D, KVH * HD), "wo": (L, H * HD, D),
              "w_gate": (L, D, F_), "w_up": (L, D, F_), "w_down": (L, F_, D), "attn_norm": (L, D),
              "mlp_norm": (L, D), "final_norm": (D,)}
    for name, t in zip(expect, (wq, wk, wv, wo, w_gate, w_up, w_down, attn_norm, mlp_norm, final_norm)):
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"{name} must be {expect[name]}, got {tuple(t.shape)}")
    if head is not None and tuple(head.shape) != (D, V):
        raise ValueError(f"head must be [D, V] = {(D, V)}, got {tuple(head.shape)}")
    if tables.dim() != 2 or tables.shape[0] != B:
        raise ValueError(f"tables must be [B, W], got {tuple(tables.shape)}")
    ints = [x.to(device=dev, dtype=torch.int32).contiguous() for x in (tokens, positions, tables, active)]
    samp = [None] * 5
    if sampled:
        samp = [temps.to(device=dev, dtype=torch.float32).contiguous(),
                top_ks.to(device=dev, dtype=torch.int32).contiguous(),
                top_ps.to(device=dev, dtype=torch.float32).contiguous(),
                uniforms.to(device=dev, dtype=torch.float32).contiguous(),
                torch.empty((B, V), dtype=torch.float32, device=dev)]
        for name, t, shape in zip(("temps", "top_ks", "top_ps", "uniforms"), samp, ((B,), (B,), (B,), (num_steps, B))):
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")
    blocks, sms = fused_window_grid(dtype, B, H // KVH, HD, dev)
    if blocks < sms:
        raise RuntimeError(f"fused_decode_window: {blocks} co-resident blocks on {sms} SMs; "
                           "the scheduler's fused_window_fits gate refuses this shape")
    grid = min(blocks, _WINDOW_BLOCKS_PER_SM * sms)
    out = torch.empty((num_steps, B), dtype=torch.int32, device=dev)
    if num_steps == 0:
        return out
    # Attention key splits: enough (row, KV head, split) items to cover the grid.
    S = max(1, min(_WINDOW_MAX_SPLITS, grid // (B * KVH)))
    h = torch.empty((B, D), dtype=dtype, device=dev)
    qkv = torch.empty((B, (H + 2 * KVH) * HD), dtype=dtype, device=dev)
    part_acc = torch.empty((B * KVH * S, H // KVH, HD), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B * KVH * S, H // KVH, 2), dtype=torch.float32, device=dev)
    attn = torch.empty((B, H * HD), dtype=dtype, device=dev)
    split_cnt = torch.zeros((B * KVH,), dtype=torch.int32, device=dev)
    gu = torch.empty((B, 2 * F_), dtype=dtype, device=dev)
    tok = torch.empty((B,), dtype=torch.int32, device=dev)
    part_val = torch.empty((grid, B), dtype=torch.float32, device=dev)
    part_idx = torch.empty((grid, B), dtype=torch.int32, device=dev)
    if profile is not None and (profile.device != dev or profile.dtype != torch.int64
                                or profile.numel() != window_profile_len(num_steps, L)):
        raise ValueError(f"profile must be int64 [{window_profile_len(num_steps, L)}] on {dev}")
    _, launch = _window_kernel()
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            _DTYPE_CODE[dtype], B, grid,
            *(ptr(t) for t in (embed, head, final_norm, attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up,
                               w_down, k_cache, v_cache, *ints, out, h, qkv, part_acc, gu, tok, part_val,
                               part_idx, profile, part_ml, attn, split_cnt, *samp)),
            num_steps, L, N, BS, H, KVH, HD, W, D, F_, V, S, rms_eps, theta, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_decode_window kernel launch failed: cudaError {rc}")
    WINDOW_KERNEL_LAUNCHES += 1
    WINDOW_SAMPLED_LAUNCHES += sampled
    return out


# ---------------------------------------------------------------------------
# The fused window's sampled epilogue alone (a check, not on the serving path)
# ---------------------------------------------------------------------------

EPILOGUE_KERNEL_LAUNCHES = 0
EPILOGUE_REF_CALLS = 0


def sample_epilogue(
    logits: torch.Tensor,  # [B, V] f32
    temps: torch.Tensor,  # [B] f32 (0 = greedy)
    top_ks: torch.Tensor,  # [B] i32 (0 = off)
    top_ps: torch.Tensor,  # [B] f32 (1 = off)
    u: torch.Tensor,  # [B] f32 uniforms in [0, 1)
) -> torch.Tensor:
    """One pick per row of ``logits``, by the device code the fused window
    runs after its head (``sample_row``, one block per row): the argmax for
    a greedy row, the draw from ``u`` for a sampled one → ``[B]`` int32.
    CUDA tensors launch ``dtt_sample_from_uniforms`` or raise; CPU tensors
    run its plain version, ``sampling.sample_from_uniforms``. It lets the
    draw be held against the plain version on identical logits."""
    global EPILOGUE_KERNEL_LAUNCHES, EPILOGUE_REF_CALLS
    if logits.device.type == "cpu":
        EPILOGUE_REF_CALLS += 1
        return sample_from_uniforms(logits, temps, top_ks, top_ps, u)
    if logits.device.type != "cuda":
        raise ValueError(f"sample_epilogue runs on cuda or cpu tensors, got {logits.device}")
    if logits.dtype != torch.float32 or logits.dim() != 2 or not logits.is_contiguous():
        raise ValueError("logits must be a contiguous [B, V] float32 tensor")
    B, V = logits.shape
    if V % 4 or logits.data_ptr() % 16:
        raise ValueError(f"the epilogue reads 16 bytes at a time: V = {V} must be a multiple of 4, logits aligned")
    dev = logits.device
    rows = [temps.to(dev, torch.float32).contiguous(), top_ks.to(dev, torch.int32).contiguous(),
            top_ps.to(dev, torch.float32).contiguous(), u.to(dev, torch.float32).contiguous()]
    if any(tuple(t.shape) != (B,) for t in rows):
        raise ValueError(f"temps, top_ks, top_ps and u must be [{B}]")
    out = torch.empty((B,), dtype=torch.int32, device=dev)
    scaled = torch.empty_like(logits)  # the sampled rows / their temperature, as the window's head stores them
    lib = _build.load("fused_decode_window")
    fn = lib.dtt_sample_from_uniforms
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        rc = fn(logits.data_ptr(), scaled.data_ptr(), *(t.data_ptr() for t in rows), out.data_ptr(), B, V,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sample_epilogue kernel launch failed: cudaError {rc}")
    EPILOGUE_KERNEL_LAUNCHES += 1
    return out
