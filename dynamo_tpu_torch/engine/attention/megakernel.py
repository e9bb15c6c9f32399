"""Ragged paged attention: one kernel launch per layer serves every row of a
step — prefill chunks as wide rows, decode entries as length-1 rows — over
``[paged prefix ; fresh keys]`` under one online softmax.

Same arguments and layouts as the JAX package's
``megakernel.ragged_paged_attention``, the pages a bf16/f32 pool or an
int8 ``QuantKv`` one (codes and a scale per token and KV head, dequantized
per page inside the kernel). On a CUDA tensor it launches the hand-written
Hopper kernel (``csrc/ragged_paged_attention.cu``, its int8 branch for a
``QuantKv`` pool) or raises; on a CPU tensor it runs the plain PyTorch
version, ``ragged_paged_attention_ref``, which the tests hold against the
JAX function and ``chip_smoke.py`` holds the kernel against on the card.

With bf16 queries one launch takes two paths, chosen on the device from
``meta`` (the host never reads it; ``chunk_queries`` is the rule in plain
PyTorch): tiles of a chunk's queries on tensor cores, every other live
query split over its keys and merged in the same launch. ``launch_plan``
sizes that grid from the shapes alone.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from dynamo_tpu_torch import _build
from dynamo_tpu_torch.engine.attention.decode import grow_counters, num_splits, split_keys
from dynamo_tpu_torch.engine.kv_cache import QuantKv
from dynamo_tpu_torch.engine.sampling import (
    apply_token_masks, filtered_probs_rows, pick_from_probs, sample_from_uniforms,
)

NEG_INF = -1e30

# Launch counters: the kernel's (incremented once per successful launch on
# a CUDA tensor) and the plain version's (once per CPU call), the int8
# branch's (a QuantKv pool) apart. A run that resets them and drives the
# main path shows which one it went through.
KERNEL_LAUNCHES = 0
REF_CALLS = 0
KERNEL_LAUNCHES_INT8 = 0
REF_CALLS_INT8 = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# Shared memory one block may use on Hopper (227 KB opt-in).
_MAX_SMEM = 232448
# The bf16 kernel: head dims it is built for, the (query, head) rows of one
# chunk tile (two wgmma warpgroups of 64), and the most query heads a KV
# head may have (a split query's heads are the rows of one 64-row tile).
_HEAD_DIMS = (16, 32, 64, 128)
_TILE_ROWS = 128
_MAX_GROUP = 64
# Per device: the split path's per-(query slot, KV head) arrival counters,
# apart from paged_decode_partials'. Zero between launches (the merging
# block resets its own), so they are zeroed once, when allocated. A CUDA
# graph keeps the address it captured, so the scheduler sizes them up front
# (``reserve_counters``) and they never move under a capture.
_COUNTERS: Dict[torch.device, torch.Tensor] = {}
_SMS: Dict[torch.device, int] = {}
# The wrapper's per-shape host work, done once: shared-memory bytes by
# (dtype, int8, G, HD, BS), and the bf16 grid by launch_plan's arguments.
_SMEM: Dict[tuple, int] = {}
_GRIDS: Dict[tuple, tuple] = {}


def reserve_counters(device, n: int) -> None:
    """Size the split path's arrival counters on ``device`` for ``n`` =
    the largest rows · KV heads a launch will have, before any capture."""
    grow_counters(torch.device(device), n, _COUNTERS)


def queries_per_tile(num_heads: int, num_kv_heads: int) -> int:
    """BQ: the consecutive queries of one bf16 chunk tile (128 (query,
    head) rows over the G = H / KVH heads of a KV head)."""
    return max(1, _TILE_ROWS // (num_heads // num_kv_heads))


def launch_plan(num_queries: int, num_heads: int, num_kv_heads: int, rows: int, width: int, block_size: int,
                num_sms: int) -> Dict[str, int]:
    """The bf16 kernel's grid, from shapes the host has: ``queries_per_tile``
    (BQ = 128 / G), ``tiles`` chunk tiles of BQ queries
    (``num_kv_heads`` blocks each), the split path's ``splits`` of
    ``split_keys`` keys a (query, KV head) (``decode.num_splits`` /
    ``split_keys`` of the table width) and its ``split_blocks`` persistent
    blocks (one per SM, fewer when ``rows``·KVH·splits work items are
    fewer), ``blocks`` in all."""
    bq = queries_per_tile(num_heads, num_kv_heads)
    tiles = -(-num_queries // bq)
    splits = num_splits(width, block_size)
    nb = max(1, min(num_sms, rows * num_kv_heads * splits))
    return {"queries_per_tile": bq, "tiles": tiles, "splits": splits, "split_keys": split_keys(width, block_size),
            "split_blocks": nb, "blocks": tiles * num_kv_heads + nb}


def chunk_queries(meta: torch.Tensor, *, width: int, block_size: int, queries_per_tile: int) -> torch.Tensor:
    """[NQ] bool: the queries the bf16 kernel takes on its chunk path (the
    other live ones take the split path), by the rule the device applies:
    in each tile of ``queries_per_tile`` consecutive queries, the live
    queries sharing the row and the prefix length (capped at W·BS) of the
    tile's first live query, when there are at least two."""
    row, plen, _, _, live = meta.long().cpu()
    plen = plen.clamp(0, width * block_size)
    live = live != 0
    out = torch.zeros(meta.shape[1], dtype=torch.bool)
    for q0 in range(0, meta.shape[1], queries_per_tile):
        t = slice(q0, q0 + queries_per_tile)
        idx = torch.nonzero(live[t])
        if len(idx) == 0:
            continue
        f = q0 + int(idx[0])
        mine = live[t] & (row[t] == row[f]) & (plen[t] == plen[f])
        if int(mine.sum()) >= 2:
            out[t] = mine
    return out


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
    return zeros. A ``QuantKv`` pool's gathered pages are dequantized as
    the TPU kernel does: code and scale each cast to q's dtype, their
    product in q's dtype."""
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
        kp, vp = (_dequant_pages(p, pages, q.dtype).reshape(W * block_size, KVH, HD) for p in (k_pages, v_pages))
        k = torch.cat([kp, k_extra]).float()
        v = torch.cat([vp, v_extra])
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


def _dequant_pages(pool, pages: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``pool[pages]``; a ``QuantKv`` pool's codes times its scales, each
    cast to ``dtype`` and multiplied in ``dtype`` (the TPU kernel's
    ``k_ref.astype(q.dtype) * scale.astype(q.dtype)``)."""
    if isinstance(pool, QuantKv):
        return pool.q[pages].to(dtype) * pool.scale[pages].to(dtype)
    return pool[pages]


def _kernel():
    """(launch, int8 launch, smem-bytes) C functions of the built library,
    typed once."""
    lib = _build.load("ragged_paged_attention")
    launch, launch8 = lib.dtt_ragged_paged_attention, lib.dtt_ragged_paged_attention_int8
    smem = lib.dtt_ragged_paged_attention_smem
    if launch.argtypes is None:
        launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
        launch8.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        launch8.restype = ctypes.c_int
        smem.argtypes = [ctypes.c_int] * 5
        smem.restype = ctypes.c_size_t
    return launch, launch8, smem


def _check_args(q, k_extra, v_extra, k_pages, v_pages, tables, meta, num_kv_heads, block_size):
    quant = isinstance(k_pages, QuantKv)
    if quant != isinstance(v_pages, QuantKv):
        raise TypeError("k_pages and v_pages must both be QuantKv or both be tensors")
    tensors = {"q": q, "k_extra": k_extra, "v_extra": v_extra, "tables": tables, "meta": meta}
    if quant:
        tensors.update({"k_pages.q": k_pages.q, "v_pages.q": v_pages.q,
                        "k_pages.scale": k_pages.scale, "v_pages.scale": v_pages.scale})
    else:
        tensors.update({"k_pages": k_pages, "v_pages": v_pages})
    dev = q.get_device()  # an int: cheaper to compare than torch.device objects
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.get_device() != dev or t.is_cuda != q.is_cuda:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (bfloat16 or float32)")
    for name in ("k_extra", "v_extra") if quant else ("k_extra", "v_extra", "k_pages", "v_pages"):
        if tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} dtype {tensors[name].dtype} != q dtype {q.dtype}")
    if quant:
        for name in ("k_pages", "v_pages"):
            codes, scale = tensors[f"{name}.q"], tensors[f"{name}.scale"]
            if codes.dtype != torch.int8:
                raise TypeError(f"{name}.q must be int8, got {codes.dtype}")
            if scale.dtype != torch.float32:
                raise TypeError(f"{name}.scale must be float32, got {scale.dtype}")
            if tuple(scale.shape) != (*codes.shape[:-1], 1):
                raise ValueError(f"{name}.scale must be {(*codes.shape[:-1], 1)} for codes {tuple(codes.shape)}, "
                                 f"got {tuple(scale.shape)}")
            # The kernel reads a token's codes with 16-byte loads.
            if codes.shape[-1] % 16 or codes.data_ptr() % 16:
                raise ValueError(f"{name}.q: head dim {codes.shape[-1]} must be a multiple of 16 and its "
                                 "storage 16-byte aligned")
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
    if len(k_pages.shape) != 4 or tuple(k_pages.shape[1:]) != (block_size, num_kv_heads, HD):
        raise ValueError(f"k_pages must be [NP, {block_size}, {num_kv_heads}, {HD}], got {tuple(k_pages.shape)}")
    if v_pages.shape != k_pages.shape:
        raise ValueError("v_pages and k_pages shapes differ")
    if tables.dim() != 2:
        raise ValueError(f"tables must be [R, W], got {tuple(tables.shape)}")
    if tuple(meta.shape) != (5, NQ):
        raise ValueError(f"meta must be [5, {NQ}], got {tuple(meta.shape)}")
    if q.dtype == torch.bfloat16:
        if HD not in _HEAD_DIMS:
            raise ValueError(f"head_dim {HD} not supported by the bf16 kernel (one of {_HEAD_DIMS})")
        if H // num_kv_heads > _MAX_GROUP:
            raise ValueError(f"{H // num_kv_heads} query heads per KV head, over the bf16 kernel's {_MAX_GROUP}")
        # The bf16 kernel copies 16-byte units (cp.async).
        for name in ("q", "k_extra", "v_extra") + (("k_pages.q", "v_pages.q") if quant else ("k_pages", "v_pages")):
            if tensors[name].data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary")


def ragged_paged_attention(
    q: torch.Tensor,  # [NQ, H, HD] post-rope queries
    k_extra: torch.Tensor,  # [CK, KVH, HD] in-flight (not yet cached) keys
    v_extra: torch.Tensor,
    k_pages,  # [NP, BS, KVH, HD] layer-flat page pool (tensor, or QuantKv: int8 codes, f32 scales [.., 1])
    v_pages,
    tables: torch.Tensor,  # [R, W] i32 — per-row page ids (layer-offset)
    meta: torch.Tensor,  # [5, NQ] i32 — build_meta
    *,
    num_kv_heads: int,
    block_size: int,
) -> torch.Tensor:
    """Attention for a whole ragged batch over [paged prefix ; fresh keys].
    Returns normalized ``[NQ, H, HD]`` in q's dtype; dead queries return
    zeros. CUDA tensors launch the Hopper kernel (a ``QuantKv`` pool its
    int8 branch, which reads the codes and scales in place) or raise; CPU
    tensors run ``ragged_paged_attention_ref``."""
    global KERNEL_LAUNCHES, KERNEL_LAUNCHES_INT8, REF_CALLS, REF_CALLS_INT8
    quant = isinstance(k_pages, QuantKv)
    if q.device.type == "cpu":
        if quant:
            REF_CALLS_INT8 += 1
        else:
            REF_CALLS += 1
        return ragged_paged_attention_ref(
            q, k_extra, v_extra, k_pages, v_pages, tables, meta,
            num_kv_heads=num_kv_heads, block_size=block_size,
        )
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu tensors, got {q.device}")
    _check_args(q, k_extra, v_extra, k_pages, v_pages, tables, meta, num_kv_heads, block_size)
    NQ, H, HD = q.shape
    KVH, G = num_kv_heads, H // num_kv_heads
    launch, launch8, smem_fn = _kernel()
    key = (_DTYPE_CODE[q.dtype], int(quant), G, HD, block_size)
    smem = _SMEM.get(key)
    if smem is None:
        smem = _SMEM[key] = smem_fn(*key)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"G={G}, HD={HD}, BS={block_size} needs {smem} bytes of shared "
            f"memory per block, over the card's {_MAX_SMEM}"
        )
    out = torch.empty_like(q)
    if NQ == 0:
        return out
    R, W = tables.shape
    scratch = counters = None
    grid = (0, 0, 0, 0, 0)
    dev = q.device
    if q.dtype == torch.bfloat16:
        sms = _SMS.get(dev)
        if sms is None:
            sms = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        gkey = (NQ, H, KVH, R, W, block_size, sms)
        grid = _GRIDS.get(gkey)
        if grid is None:
            plan = launch_plan(*gkey)
            grid = _GRIDS[gkey] = (plan["queries_per_tile"], plan["tiles"], plan["split_blocks"], plan["splits"],
                                   plan["split_keys"])
        # Each split's (m, l, acc) for the split path's first R queries; never zeroed.
        splits = grid[3]
        scratch = torch.empty(R * KVH * splits * G * (HD + 2) if splits > 1 else 0,
                              dtype=torch.float32, device=q.device)
        counters = grow_counters(q.device, R * KVH, _COUNTERS)
    extra = (
        scratch.data_ptr() if scratch is not None else None, counters.data_ptr() if counters is not None else None,
        NQ, H, KVH, HD, k_extra.shape[0], W, block_size, R, *grid,
    )
    # The launch goes to q's device (switched to only when it is not current).
    on_dev = contextlib.nullcontext() if dev.index == torch.cuda.current_device() else torch.cuda.device(dev)
    with on_dev:
        stream = torch.cuda.current_stream(dev).cuda_stream
        if quant:
            rc = launch8(
                _DTYPE_CODE[q.dtype],
                q.data_ptr(), k_extra.data_ptr(), v_extra.data_ptr(),
                k_pages.q.data_ptr(), v_pages.q.data_ptr(), k_pages.scale.data_ptr(), v_pages.scale.data_ptr(),
                tables.data_ptr(), meta.data_ptr(), out.data_ptr(), *extra, stream,
            )
        else:
            rc = launch(
                _DTYPE_CODE[q.dtype],
                q.data_ptr(), k_extra.data_ptr(), v_extra.data_ptr(),
                k_pages.data_ptr(), v_pages.data_ptr(), tables.data_ptr(), meta.data_ptr(),
                out.data_ptr(), *extra, stream,
            )
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed: cudaError {rc}")
    if quant:
        KERNEL_LAUNCHES_INT8 += 1
    else:
        KERNEL_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# Fused multi-step decode window (one launch per window)
# ---------------------------------------------------------------------------

# The fused window's own counters, kept apart from the ragged kernel's; the
# windows with the sampled epilogue, and those with the guided epilogue,
# are also counted apart.
WINDOW_KERNEL_LAUNCHES = 0
WINDOW_REF_CALLS = 0
WINDOW_SAMPLED_LAUNCHES = 0
WINDOW_SAMPLED_REF_CALLS = 0
WINDOW_GUIDED_LAUNCHES = 0
WINDOW_GUIDED_REF_CALLS = 0

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

# The bf16 products of both fused kernels (csrc/fused_window_device.cuh,
# `tc_product`): column tiles of 64, weight boxes of 128 rows, rows in
# passes of 64, two lanes (warpgroups) a block walking the items.
TC_TILE = 64
TC_BOX_ROWS = 128
TC_LANES_PER_BLOCK = 2


def window_phases(hidden: int, q_width: int, kv_width: int, ffn: int, vocab: int) -> list:
    """(K, column groups' widths) of the five bf16 product phases in the
    kernel's order: QKV (wq | wk | wv), wo, gate | up, down, head."""
    return [(hidden, (q_width, kv_width, kv_width)), (q_width, (hidden,)), (hidden, (ffn, ffn)), (ffn, (hidden,)),
            (hidden, (vocab,))]


def product_plan(K: int, widths, rows: int, lanes: int) -> Tuple[int, int]:
    """(splits, boxes per split) of one bf16 product phase. Its work items
    are (column tile, run of boxes): ceil(w / 64) tiles per column group,
    ceil(K / 128) boxes of depth cut into `splits` runs of `boxes per split`
    (the last may be shorter). Each of the grid's ``lanes`` (two a block)
    walks items lane-stride, so the phase takes about ceil(items / lanes)
    items' boxes, plus a quarter of a box's time per item for its
    epilogue; a split item
    also writes its f32 partial (rows × 64 floats, rows / 64 boxes' worth,
    to L2, taken at a third of a box's cost) and the last split of a tile
    reads them all back. The plan minimises that cost; more splits must
    win by 3 %: few-tile phases (QKV, wo, down) split K, wide ones
    (gate/up, the head) do not."""
    tiles = sum(-(-w // TC_TILE) for w in widths)
    boxes = -(-K // TC_BOX_ROWS)
    part = rows / 192
    best = None
    for splits in range(1, boxes + 1):
        kbs = -(-boxes // splits)
        if -(-boxes // kbs) != splits:
            continue  # the same runs as a smaller split count
        items = tiles * splits
        extra = part if splits > 1 else 0.0
        cost = -(-items // lanes) * (kbs + extra + 0.25) + splits * extra
        if best is None or cost < 0.97 * best[0]:
            best = (cost, splits, kbs)
    return best[1], best[2]


def plan_items(K: int, widths, splits: int, kbs: int) -> list:
    """The work items of a planned phase as the kernel numbers them (item =
    tile · splits + split): (column group, first column in the group,
    first box, end box) each."""
    boxes = -(-K // TC_BOX_ROWS)
    items = []
    for g, w in enumerate(widths):
        for t in range(-(-w // TC_TILE)):
            for s in range(splits):
                items.append((g, t * TC_TILE, s * kbs, min(boxes, s * kbs + kbs)))
    return items


def window_plan(phases, rows: int, lanes: int) -> Tuple[list, int, int]:
    """The five phases' (splits, boxes per split) at ``rows`` rows on
    ``lanes`` lanes (two a block), with the split partials' floats and the
    per-tile counters they need (0 when no phase splits)."""
    plan = [product_plan(K, widths, rows, lanes) for K, widths in phases]
    part = cnt = 0
    for (K, widths), (splits, _) in zip(phases, plan):
        if splits > 1:
            tiles = sum(-(-w // TC_TILE) for w in widths)
            part = max(part, tiles * splits * rows * TC_TILE)
            cnt = max(cnt, tiles)
    return plan, part, cnt


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


def _cache_forward(
    weights, k_cache, v_cache, toks, pos, tabs, live, *, num_heads: int, rms_eps: float, theta: float,
    head: bool = True,
) -> Optional[torch.Tensor]:
    """N rows, each one token at its own position over its own block-table
    row, through every layer of one model over its paged cache: per layer
    RMS norm, QKV, rope, every row's K/V written into the cache first (dead
    rows to block 0, offset 0), then each row attends its pages masked to
    ``kpos <= pos`` (dead rows attend nothing), ``wo`` and the residual, RMS
    norm, SwiGLU and the residual; then the final norm and the head →
    f32 logits ``[N, V]`` (None without ``head``). The JAX fused kernels'
    math and cast points: every product accumulates in f32 and is cast to
    the weight dtype (the head's f32 logits are not), the residual stays in
    that dtype, p is cast to it before PV. ``weights`` is the kernels' 12
    in their order, the head ``[D, V]`` or None when tied; ``pos``,
    ``tabs`` long, ``live`` bool."""
    embed, head_w, final_norm, attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up, w_down = weights
    L, _, BS, KVH, HD = k_cache.shape
    N, W = toks.shape[0], tabs.shape[1]
    H, G = num_heads, num_heads // KVH
    rows = torch.arange(N, device=toks.device)
    kpos = torch.arange(W * BS, device=toks.device)
    slot = torch.where(live, pos.clamp(min=0), torch.zeros_like(pos))
    blk = torch.where(live, tabs[rows, (slot // BS).clamp(max=W - 1)], torch.zeros_like(slot))
    off = slot % BS
    mask = (kpos[None, :] <= pos[:, None])[:, None, None, :]  # [N, 1, 1, W*BS]
    h = embed[toks.long().clamp(0, embed.shape[0] - 1)]
    for l in range(L):
        x = _rms(h, attn_norm[l], rms_eps)
        q = _rope((x @ wq[l]).view(N, H, HD), pos, theta)
        k = _rope((x @ wk[l]).view(N, KVH, HD), pos, theta)
        v = (x @ wv[l]).view(N, KVH, HD)
        k_cache[l, blk, off] = k.to(k_cache.dtype)
        v_cache[l, blk, off] = v.to(v_cache.dtype)
        kb = k_cache[l][tabs].reshape(N, W * BS, KVH, HD).to(x.dtype)
        vb = v_cache[l][tabs].reshape(N, W * BS, KVH, HD).to(x.dtype)
        s = torch.einsum("bkgd,bskd->bkgs", q.view(N, KVH, G, HD), kb).float() * HD**-0.5
        s = s.masked_fill(~mask, NEG_INF)
        p = torch.softmax(s, dim=-1).to(x.dtype)
        attn = torch.einsum("bkgs,bskd->bkgd", p, vb).reshape(N, H * HD)
        attn = torch.where(live[:, None], attn, torch.zeros_like(attn))
        h = h + attn @ wo[l]
        x = _rms(h, mlp_norm[l], rms_eps)
        h = h + (F.silu(x @ w_gate[l]) * (x @ w_up[l])) @ w_down[l]
    if not head:
        return None
    # The head's products accumulate into f32 logits, unrounded (the JAX
    # kernels' preferred_element_type=f32): in bf16, logits rounded to the
    # weight dtype would tie tokens the kernels tell apart.
    return _rms(h, final_norm, rms_eps).float() @ (head_w if head_w is not None else embed.T).float()


def fused_decode_window_ref(
    embed, head, final_norm, attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up, w_down,
    k_cache, v_cache, tokens, positions, tables, active, temps=None, top_ks=None, top_ps=None, uniforms=None,
    guided_rows=None, mask_pool=None, next_pool=None,
    *, num_steps: int, num_heads: int, num_kv_heads: int, head_dim: int, block_size: int,
    rms_eps: float, theta: float, rows_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the fused window: ``num_steps`` decode
    steps, the JAX ``_fused_window_kernel``'s math and cast points. Step i
    embeds its tokens (step 0 ``tokens``, later steps the previous pick),
    runs every layer at ``positions + i`` (``_cache_forward``), masks each
    row's logits by its FSM row with ``mask_pool`` (``sampling.
    apply_token_masks``, the rows starting at ``guided_rows``), then picks:
    argmax (first index among equal maxima) or, with ``uniforms
    [num_steps, B]``, ``sampling.sample_from_uniforms(logits, temps,
    top_ks, top_ps, uniforms[i])``; a guided row then moves to
    ``next_pool[row, token]``. Dead rows' tokens are unspecified. ``head``
    is ``[D, V]``, or None for tied embeddings. Writes the caches in place
    (and the rows after the window into ``rows_out``); returns ``tokens
    [num_steps, B]`` int32."""
    weights = (embed, head, final_norm, attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up, w_down)
    B = tokens.shape[0]
    out = torch.empty((num_steps, B), dtype=torch.int32, device=tokens.device)
    toks = tokens.long()
    live, tabs = active.bool(), tables.long()
    rows = guided_rows.long() if mask_pool is not None else None
    for i in range(num_steps):
        logits = _cache_forward(weights, k_cache, v_cache, toks, positions.long() + i, tabs, live,
                                num_heads=num_heads, rms_eps=rms_eps, theta=theta)
        if rows is not None:
            logits = apply_token_masks(logits, mask_pool, rows)
        if uniforms is None:
            toks = torch.argmax(logits, dim=-1)
        else:
            toks = sample_from_uniforms(logits, temps, top_ks, top_ps, uniforms[i]).long()
        if rows is not None:
            rows = next_pool[rows, toks].long()
        out[i] = toks.to(torch.int32)
    if rows_out is not None and rows is not None:
        rows_out.copy_(rows)
    return out


def _window_kernel():
    """(blocks query, launch) C functions of the built library, typed once."""
    lib = _build.load("fused_decode_window")
    blocks, launch = lib.dtt_fused_decode_window_blocks, lib.dtt_fused_decode_window
    if launch.argtypes is None:
        blocks.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        blocks.restype = ctypes.c_int
        launch.argtypes = (
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 42 + [ctypes.c_int] * 13
            + [ctypes.c_float] * 2 + [ctypes.c_void_p]
        )
        launch.restype = ctypes.c_int
    return blocks, launch


def window_profile_len(num_steps: int, num_layers: int) -> int:
    """Timer stamps of one profiled window: 1 + steps × (5 per layer + 2)."""
    return 1 + num_steps * (5 * num_layers + 2)


def _tc_plan(models, rows, grid: int, dtype: torch.dtype, dev) -> Tuple[ctypes.Array, list]:
    """The kernel's plan array (each model's five (splits, boxes per split)
    at its rows, in order) and, in bf16, the split partials and the
    zeroed per-tile counters the models share (None where no phase
    splits; f32 runs no bf16 product)."""
    part = cnt = 0
    flat = []
    for phases, n in zip(models, rows):
        plan, p, c = window_plan(phases, n, TC_LANES_PER_BLOCK * grid)
        flat += [x for pc in plan for x in pc]
        part, cnt = max(part, p), max(cnt, c)
    arr = (ctypes.c_int * len(flat))(*flat)
    if dtype != torch.bfloat16 or part == 0:
        return arr, [None, None]
    return arr, [torch.empty((part,), dtype=torch.float32, device=dev), torch.zeros((cnt,), dtype=torch.int32, device=dev)]


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


def _check_model(name, weights, k_cache, v_cache, num_heads, num_kv_heads, head_dim, block_size, dtype, dev):
    """Shape checks of one model's weights and cache for the fused kernels;
    returns (L, N, W-independent dims) as a dict."""
    embed, head, fnorm, anorm, mnorm, wq, wk, wv, wo, wg, wu, wd = weights
    for t in [w for w in weights if w is not None] + [k_cache, v_cache]:
        if t.device != dev:
            raise ValueError(f"a {name} weight or cache is on {t.device}, tokens on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"weights and caches must share one dtype, got {t.dtype} and {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} weights and caches must be contiguous")
    L, N, BS, KVH, HD = k_cache.shape
    V, D = embed.shape
    F_ = wg.shape[2]
    H = num_heads
    if v_cache.shape != k_cache.shape or (BS, KVH, HD) != (block_size, num_kv_heads, head_dim):
        raise ValueError(f"{name} cache shape {tuple(k_cache.shape)} does not match the model's")
    if HD not in WINDOW_HEAD_DIMS or H % KVH:
        raise ValueError(f"{name}: head dim {HD} or {H} heads over {KVH} KV heads not supported")
    if any(n % _WINDOW_TILE for n in (D, F_, V)):
        raise ValueError(f"{name}: widths D={D}, F={F_}, V={V} must be multiples of {_WINDOW_TILE}")
    expect = {"wq": (L, D, H * HD), "wk": (L, D, KVH * HD), "wv": (L, D, KVH * HD), "wo": (L, H * HD, D),
              "w_gate": (L, D, F_), "w_up": (L, D, F_), "w_down": (L, F_, D), "attn_norm": (L, D),
              "mlp_norm": (L, D), "final_norm": (D,)}
    for key, t in zip(expect, (wq, wk, wv, wo, wg, wu, wd, anorm, mnorm, fnorm)):
        if tuple(t.shape) != expect[key]:
            raise ValueError(f"{name} {key} must be {expect[key]}, got {tuple(t.shape)}")
    if head is not None and tuple(head.shape) != (D, V):
        raise ValueError(f"{name} head must be [D, V] = {(D, V)}, got {tuple(head.shape)}")
    return dict(L=L, N=N, H=H, KVH=KVH, HD=HD, D=D, F=F_, V=V)


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
    guided_rows: Optional[torch.Tensor] = None,  # [B] i32 mask-pool rows at window start (0 = allow-all)
    mask_pool: Optional[torch.Tensor] = None,  # [P, ceil(V/32)] int32: packed allow bits (uint32)
    next_pool: Optional[torch.Tensor] = None,  # [P, V] i32: the row after each token
    *,
    num_steps: int,
    num_heads: int,
    num_kv_heads: int,
    head_dim: int,
    block_size: int,
    rms_eps: float,
    theta: float,
    profile: Optional[torch.Tensor] = None,
    rows_out: Optional[torch.Tensor] = None,
    scratch: Optional[dict] = None,
) -> torch.Tensor:
    """``num_steps`` decode steps × every layer in ONE launch. Returns
    ``tokens [num_steps, B]`` int32; the window's K/V rows land in the
    caches in place. Greedy, or with ``uniforms`` the sampled epilogue:
    each row with a temperature > 0 draws its token from ``uniforms[i]`` as
    ``sampling.sample_from_uniforms`` does. With ``guided_rows``,
    ``mask_pool`` and ``next_pool`` (llm/guided's pools) the guided
    epilogue: each row picks among the tokens its FSM row allows, then
    moves to ``next_pool[row, token]`` on the device; ``rows_out`` ([B]
    int32, optional) gets the rows after the window. CUDA tensors launch
    the persistent cooperative kernel (``csrc/fused_decode_window.cu``) or
    raise; CPU tensors run ``fused_decode_window_ref``. ``profile``, an
    int64 CUDA tensor of ``window_profile_len(num_steps, L)``, gets the
    kernel's global-timer stamps (ns): one after the step-0 embedding, then
    per step one after each of the 5 phases of each layer, one after the
    head and one after the pick and next embedding (the plain version
    stamps nothing). ``scratch``, a dict, gets the kernel's sampled
    epilogue's [B, V] f32 logits scratch as "logits" (the last step's
    scaled logits; a check of repeat calls reads it)."""
    global WINDOW_KERNEL_LAUNCHES, WINDOW_REF_CALLS, WINDOW_SAMPLED_LAUNCHES, WINDOW_SAMPLED_REF_CALLS
    global WINDOW_GUIDED_LAUNCHES, WINDOW_GUIDED_REF_CALLS
    weights = [embed, head, final_norm, attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up, w_down]
    kw = dict(num_steps=num_steps, num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
              block_size=block_size, rms_eps=rms_eps, theta=theta)
    sampled = uniforms is not None
    if sampled and (temps is None or top_ks is None or top_ps is None):
        raise ValueError("the sampled epilogue needs temps, top_ks and top_ps with uniforms")
    guided_ops = (guided_rows, mask_pool, next_pool)
    guided = mask_pool is not None
    if any(t is not None for t in guided_ops) and not all(t is not None for t in guided_ops):
        raise ValueError("the guided epilogue needs guided_rows, mask_pool and next_pool together")
    if tokens.device.type == "cpu":
        WINDOW_REF_CALLS += 1
        WINDOW_SAMPLED_REF_CALLS += sampled
        WINDOW_GUIDED_REF_CALLS += guided
        return fused_decode_window_ref(
            embed, head, final_norm, attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up, w_down,
            k_cache, v_cache, tokens, positions, tables, active, temps, top_ks, top_ps, uniforms,
            guided_rows, mask_pool, next_pool, rows_out=rows_out, **kw,
        )
    if tokens.device.type != "cuda":
        raise ValueError(f"fused_decode_window runs on cuda or cpu tensors, got {tokens.device}")
    dev = tokens.device
    dtype = embed.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"weight dtype {dtype} not supported (bfloat16 or float32)")
    m = _check_model("window", weights, k_cache, v_cache, num_heads, num_kv_heads, head_dim, block_size, dtype, dev)
    L, N, H, KVH, HD, D, F_, V = (m[k] for k in ("L", "N", "H", "KVH", "HD", "D", "F", "V"))
    BS = block_size
    B, W = tokens.shape[0], tables.shape[1]
    if B not in WINDOW_BATCHES:
        raise ValueError(f"batch {B} is not one of {WINDOW_BATCHES}")
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
    guide = [None] * 4
    P = 0
    if guided:
        P = mask_pool.shape[0]
        if rows_out is None:
            rows_out = torch.empty((B,), dtype=torch.int32, device=dev)
        guide = [guided_rows.to(device=dev, dtype=torch.int32).contiguous(), rows_out, mask_pool, next_pool]
        for name, t, shape in zip(("guided_rows", "rows_out", "mask_pool", "next_pool"), guide,
                                  ((B,), (B,), (P, (V + 31) // 32), (P, V))):
            if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != shape:
                raise ValueError(f"{name} must be a contiguous int32 {list(shape)} tensor on {dev}")
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
    # bf16 products: each phase's split plan, its partials and counters.
    plan, tc_bufs = _tc_plan([window_phases(D, H * HD, KVH * HD, F_, V)], [B], grid, dtype, dev)
    _, launch = _window_kernel()
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = launch(
            _DTYPE_CODE[dtype], B, grid,
            *(ptr(t) for t in (embed, head, final_norm, attn_norm, mlp_norm, wq, wk, wv, wo, w_gate, w_up,
                               w_down, k_cache, v_cache, *ints, out, h, qkv, part_acc, gu, tok, part_val,
                               part_idx, profile, part_ml, attn, split_cnt, *samp, *guide, *tc_bufs)),
            ctypes.cast(plan, ctypes.c_void_p),
            num_steps, L, N, BS, H, KVH, HD, W, D, F_, V, S, P, rms_eps, theta, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_decode_window kernel launch failed: cudaError {rc}")
    if scratch is not None and sampled:
        scratch["logits"] = samp[4]
    WINDOW_KERNEL_LAUNCHES += 1
    WINDOW_SAMPLED_LAUNCHES += sampled
    WINDOW_GUIDED_LAUNCHES += guided
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


# ---------------------------------------------------------------------------
# Fused speculative window: draft bursts, target verify and rejection
# sampling for R rounds in one launch
# ---------------------------------------------------------------------------

SPEC_KERNEL_LAUNCHES = 0
SPEC_REF_CALLS = 0
# The kernel keeps one inverse RMS norm per verify row in shared memory and
# picks draft proposals with γ up to this.
SPEC_MAX_GAMMA = 8
SPEC_MAX_VERIFY_ROWS = WINDOW_BATCHES[-1] * (SPEC_MAX_GAMMA + 1)
_spec_grid_cache: dict = {}


def _spec_rows_ok(batch: int, gamma: int) -> bool:
    """1 ≤ γ ≤ ``SPEC_MAX_GAMMA`` and the verify's batch·(γ+1) rows at
    most ``SPEC_MAX_VERIFY_ROWS``."""
    return 1 <= gamma <= SPEC_MAX_GAMMA and batch * (gamma + 1) <= SPEC_MAX_VERIFY_ROWS


def fused_spec_window_ref(
    t_embed, t_head, t_fnorm, t_anorm, t_mnorm, t_wq, t_wk, t_wv, t_wo, t_wg, t_wu, t_wd,
    d_embed, d_head, d_fnorm, d_anorm, d_mnorm, d_wq, d_wk, d_wv, d_wo, d_wg, d_wu, d_wd,
    k_t, v_t, k_d, v_d, tokens, xprev, positions, tables_t, tables_d, active, temps, top_ks, top_ps, uniforms,
    *, rounds: int, gamma: int, block_size: int,
    t_num_heads: int, t_num_kv_heads: int, t_head_dim: int, t_rms_eps: float, t_theta: float,
    d_num_heads: int, d_num_kv_heads: int, d_head_dim: int, d_rms_eps: float, d_theta: float,
    margins: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused spec window, the JAX
    ``_fused_spec_kernel`` step for step. Per round, with the cursors
    (pos, tok, xprev) starting at (positions, tokens, xprev):
    1. the draft re-feeds xprev at pos − 1 (its logits unused);
    2. γ draft forwards from tok at pos, each drawing x_g from its
       ``filtered_probs_rows`` distribution by ``pick_from_probs`` on
       ``uniforms[r, :, g]``;
    3. the target runs the chunk [tok, x_1..x_γ] at pos..pos+γ, every chunk
       row's K/V written before any is attended;
    4. x_g is accepted while ``uniforms[r, :, γ+g] < min(1, p_t/p_d)``
       (p_d clamped at 1e-20); at the first rejection k the correction is
       drawn from max(p_t − p_d, 0) renormalized (p_t where that sums to
       ≤ 1e-20), with all γ accepted the bonus from the target's γ+1-th
       distribution, both on ``uniforms[r, :, 2γ]``;
    5. pos += k + 1, tok = y, xprev = x_k (tok when k = 0).
    Greedy rows' one-hot distributions reduce this to argmax agreement.
    Writes both caches in place (rejected rows are not rewound: the next
    round overwrites them before attending). Returns ``(tokens_out [R, B,
    γ+1] int32, accepted [R, B] int32)``: row b proposed ``tokens_out[r, b,
    :γ]``, accepted ``accepted[r, b]`` of them and appended ``tokens_out[r,
    b, γ]``. Dead rows' outputs are unspecified. With ``margins`` (a
    dict), it also fills, per round and row, how far each decision lay from
    flipping, so a kernel that decides otherwise can be told apart from a
    fault: "draw" [R, B], the least distance of a sampled row's uniform from
    an edge of the picked token's CDF interval over its draws; "accept",
    the least |u − min(1, p_t/p_d)| over its accept tests; "argmax", the
    least top-2 logit gap of a greedy row's draft and verify picks (inf
    where a kind does not apply)."""
    G = gamma
    w_t = (t_embed, t_head, t_fnorm, t_anorm, t_mnorm, t_wq, t_wk, t_wv, t_wo, t_wg, t_wu, t_wd)
    w_d = (d_embed, d_head, d_fnorm, d_anorm, d_mnorm, d_wq, d_wk, d_wv, d_wo, d_wg, d_wu, d_wd)
    t_kw = dict(num_heads=t_num_heads, rms_eps=t_rms_eps, theta=t_theta)
    d_kw = dict(num_heads=d_num_heads, rms_eps=d_rms_eps, theta=d_theta)
    B = tokens.shape[0]
    dev = tokens.device
    live = active.bool()
    tabs_t, tabs_d = tables_t.long(), tables_d.long()
    # The verify's B·(γ+1) rows: row s·B + b is row b's chunk position s.
    v_tabs, v_live = tabs_t.repeat(G + 1, 1), live.repeat(G + 1)
    steps = torch.arange(G + 1, device=dev).repeat_interleave(B)
    pos, tok, xp = positions.long(), tokens.long(), xprev.long()
    toks_out = torch.empty((rounds, B, G + 1), dtype=torch.int32, device=dev)
    accepted = torch.empty((rounds, B), dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)
    greedy = temps <= 0
    inf = torch.full((B,), float("inf"), device=dev)
    if margins is not None:
        for name in ("draw", "accept", "argmax"):
            margins[name] = torch.full((rounds, B), float("inf"), device=dev)

    def note(name, r, gap, where):
        if margins is not None:
            margins[name][r] = torch.minimum(margins[name][r], torch.where(where, gap.float(), inf))

    def pick_gap(probs, uu, x):  # distance of u from the picked token's CDF interval edges
        hi = probs.double().cumsum(-1)[rows, x]
        return torch.minimum((hi - uu).abs(), (hi - probs[rows, x].double() - uu).abs())

    def top2_gap(logits):
        t = logits.topk(2, dim=-1).values
        return t[:, 0] - t[:, 1]

    for r in range(rounds):
        u = uniforms[r]
        _cache_forward(w_d, k_d, v_d, xp, pos - 1, tabs_d, live, head=False, **d_kw)
        props, pds = [], []
        cur = tok
        for g in range(G):
            logits = _cache_forward(w_d, k_d, v_d, cur, pos + g, tabs_d, live, **d_kw)
            dist = filtered_probs_rows(logits, temps, top_ks, top_ps)
            cur = pick_from_probs(dist, u[:, g]).long()
            note("draw", r, pick_gap(dist, u[:, g], cur), ~greedy)
            note("argmax", r, top2_gap(logits), greedy)
            props.append(cur)
            pds.append(dist)
        chunk = torch.cat([tok] + props)  # [(γ+1)·B], position-major
        logits = _cache_forward(w_t, k_t, v_t, chunk, pos.repeat(G + 1) + steps, v_tabs, v_live, **t_kw)
        pts = [filtered_probs_rows(logits[s * B:(s + 1) * B], temps, top_ks, top_ps) for s in range(G + 1)]
        prop = torch.stack(props, dim=1)  # [B, γ]
        accept = torch.stack([
            u[:, G + g] < torch.clamp(pts[g][rows, props[g]] / pds[g][rows, props[g]].clamp_min(1e-20), max=1.0)
            for g in range(G)], dim=1)
        rejected = ~accept
        k = torch.where(rejected.any(dim=1), torch.argmax(rejected.to(torch.int32), dim=1),
                        torch.full((B,), G, device=dev))
        kc = k.clamp(max=G - 1)
        pt_k = torch.stack(pts[:G], dim=1)[rows, kc]
        pd_k = torch.stack(pds, dim=1)[rows, kc]
        resid = (pt_k - pd_k).clamp_min(0.0)
        rs = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(rs > 1e-20, resid / rs.clamp_min(1e-20), pt_k)
        corr = pick_from_probs(resid, u[:, 2 * G])
        bonus = pick_from_probs(pts[G], u[:, 2 * G])
        y = torch.where(k == G, bonus, corr).long()
        if margins is not None:
            for g in range(G):
                tested = g <= k
                ratio = pts[g][rows, props[g]] / pds[g][rows, props[g]].clamp_min(1e-20)
                note("accept", r, (u[:, G + g] - ratio.clamp(max=1.0)).abs(), ~greedy & tested)
            for s_ in range(G + 1):
                note("argmax", r, top2_gap(logits[s_ * B:(s_ + 1) * B]), greedy & (s_ <= k))
            note("draw", r, torch.where(k == G, pick_gap(pts[G], u[:, 2 * G], y), pick_gap(resid, u[:, 2 * G], y)),
                 ~greedy)
        toks_out[r] = torch.cat([prop, y[:, None]], dim=1).to(torch.int32)
        accepted[r] = k.to(torch.int32)
        xp = torch.where(k >= 1, prop[rows, (k - 1).clamp(min=0)], tok)
        pos = pos + k + 1
        tok = y
    return toks_out, accepted


def _spec_kernel():
    """(blocks query, launch) C functions of the spec window's library, typed once."""
    lib = _build.load("fused_spec_window")
    blocks, launch = lib.dtt_fused_spec_window_blocks, lib.dtt_fused_spec_window
    if launch.argtypes is None:
        blocks.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        blocks.restype = ctypes.c_int
        launch.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
        launch.restype = ctypes.c_int
    return blocks, launch


def spec_profile_len(rounds: int, gamma: int) -> int:
    """Timer stamps of one profiled spec window: 1 + rounds × (γ + 3)."""
    return 1 + rounds * (gamma + 3)


def fused_spec_grid(dtype: torch.dtype, batch: int, t_group: int, t_head_dim: int, d_group: int, d_head_dim: int,
                    device) -> Tuple[int, int]:
    """(co-resident blocks = occupancy × SMs, SM count) of the fused spec
    kernel on ``device``, from the kernel's own occupancy query."""
    device = torch.device(device)
    key = (dtype, batch, t_group, t_head_dim, d_group, d_head_dim, device.index)
    if key not in _spec_grid_cache:
        blocks_fn, _ = _spec_kernel()
        sms = ctypes.c_int(0)
        with torch.cuda.device(device):
            n = blocks_fn(_DTYPE_CODE[dtype], batch, t_group, t_head_dim, d_group, d_head_dim, ctypes.byref(sms))
        if n < 0:
            raise RuntimeError(f"fused_spec_window occupancy query failed: cudaError {-n}")
        _spec_grid_cache[key] = (n, sms.value)
    return _spec_grid_cache[key]


def fused_spec_fits(target_cfg, draft_cfg, *, batch: int, gamma: int, dtype: torch.dtype, kv_dtype: torch.dtype,
                    device) -> bool:
    """The port's gate for the fused spec window (the JAX gate is one VMEM
    budget over both models; the Hopper kernel streams both from HBM):
    each model passes ``fused_window_fits``; the two share ``block_size``
    and the vocabulary; 1 ≤ γ ≤ ``SPEC_MAX_GAMMA`` and the verify's
    ``batch``·(γ+1) rows at most ``SPEC_MAX_VERIFY_ROWS``; and on the card
    the spec kernel's occupancy gives a cooperative grid of at least one
    block per SM."""
    kw = dict(batch=batch, dtype=dtype, kv_dtype=kv_dtype, device=device)
    if not (fused_window_fits(target_cfg, **kw) and fused_window_fits(draft_cfg, **kw)):
        return False
    if target_cfg.block_size != draft_cfg.block_size or target_cfg.vocab_size != draft_cfg.vocab_size:
        return False
    if not _spec_rows_ok(batch, gamma):
        return False
    device = torch.device(device)
    if device.type != "cuda":
        return True
    bucket = next(b for b in WINDOW_BATCHES if b >= batch)
    t, d = target_cfg, draft_cfg
    blocks, sms = fused_spec_grid(dtype, bucket, t.num_heads // t.num_kv_heads, t.head_dim,
                                  d.num_heads // d.num_kv_heads, d.head_dim, device)
    return blocks >= sms


def fused_spec_window(
    t_embed, t_head, t_fnorm, t_anorm, t_mnorm, t_wq, t_wk, t_wv, t_wo, t_wg, t_wu, t_wd,  # target, kernel order
    d_embed, d_head, d_fnorm, d_anorm, d_mnorm, d_wq, d_wk, d_wv, d_wo, d_wg, d_wu, d_wd,  # draft
    k_t: torch.Tensor,  # [Lt, N, BS, KVHt, HDt] target cache, written in place
    v_t: torch.Tensor,
    k_d: torch.Tensor,  # [Ld, N, BS, KVHd, HDd] draft cache, written in place
    v_d: torch.Tensor,
    tokens: torch.Tensor,  # [B] last confirmed token
    xprev: torch.Tensor,  # [B] token at positions - 1 (the draft's catch-up)
    positions: torch.Tensor,  # [B] position of the last confirmed token (≥ 1 for live rows)
    tables_t: torch.Tensor,  # [B, Wt] target block ids, covering positions + rounds·(γ+1)
    tables_d: torch.Tensor,  # [B, Wd] draft block ids
    active: torch.Tensor,  # [B] bool
    temps: torch.Tensor,  # [B] f32 (0 = greedy)
    top_ks: torch.Tensor,  # [B] i32 (0 = off)
    top_ps: torch.Tensor,  # [B] f32 (1 = off)
    uniforms: torch.Tensor,  # [rounds, B, 2γ+1] f32
    *,
    rounds: int,
    gamma: int,
    block_size: int,
    t_num_heads: int,
    t_num_kv_heads: int,
    t_head_dim: int,
    t_rms_eps: float,
    t_theta: float,
    d_num_heads: int,
    d_num_kv_heads: int,
    d_head_dim: int,
    d_rms_eps: float,
    d_theta: float,
    profile: Optional[torch.Tensor] = None,
    scratch: Optional[dict] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rounds`` speculative rounds in ONE launch: per round the draft's
    catch-up and γ proposals, the target's γ+1-token verify and rejection
    sampling, the cursors advancing on the device. Returns ``(tokens_out
    [rounds, B, γ+1] int32, accepted [rounds, B] int32)`` as
    ``fused_spec_window_ref`` defines them; both caches are written in
    place. CUDA tensors launch the persistent cooperative kernel
    (``csrc/fused_spec_window.cu``) or raise; CPU tensors run
    ``fused_spec_window_ref``. ``profile``, an int64 CUDA tensor of
    ``spec_profile_len(rounds, gamma)``, gets the kernel's global-timer
    stamps (ns): one at the start, then per round one after the catch-up,
    one after each proposal, one after the verify and one after the
    rejection sampling (the plain version stamps nothing). ``scratch``, a
    dict, gets the kernel's scaled logits scratch, "draft_logits" [γ, B, V]
    and "target_logits" [B·(γ+1), V] f32 (the last round's)."""
    global SPEC_KERNEL_LAUNCHES, SPEC_REF_CALLS
    w_t = [t_embed, t_head, t_fnorm, t_anorm, t_mnorm, t_wq, t_wk, t_wv, t_wo, t_wg, t_wu, t_wd]
    w_d = [d_embed, d_head, d_fnorm, d_anorm, d_mnorm, d_wq, d_wk, d_wv, d_wo, d_wg, d_wu, d_wd]
    kw = dict(rounds=rounds, gamma=gamma, block_size=block_size,
              t_num_heads=t_num_heads, t_num_kv_heads=t_num_kv_heads, t_head_dim=t_head_dim,
              t_rms_eps=t_rms_eps, t_theta=t_theta, d_num_heads=d_num_heads, d_num_kv_heads=d_num_kv_heads,
              d_head_dim=d_head_dim, d_rms_eps=d_rms_eps, d_theta=d_theta)
    if tokens.device.type == "cpu":
        SPEC_REF_CALLS += 1
        return fused_spec_window_ref(*w_t, *w_d, k_t, v_t, k_d, v_d, tokens, xprev, positions, tables_t, tables_d,
                                     active, temps, top_ks, top_ps, uniforms, **kw)
    if tokens.device.type != "cuda":
        raise ValueError(f"fused_spec_window runs on cuda or cpu tensors, got {tokens.device}")
    dev = tokens.device
    dtype = t_embed.dtype
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"weight dtype {dtype} not supported (bfloat16 or float32)")
    t = _check_model("target", w_t, k_t, v_t, t_num_heads, t_num_kv_heads, t_head_dim, block_size, dtype, dev)
    d = _check_model("draft", w_d, k_d, v_d, d_num_heads, d_num_kv_heads, d_head_dim, block_size, dtype, dev)
    B, G, V = tokens.shape[0], gamma, t["V"]
    Bv = B * (G + 1)
    if d["V"] != V:
        raise ValueError(f"target and draft vocabularies differ: {V} and {d['V']}")
    if B not in WINDOW_BATCHES:
        raise ValueError(f"batch {B} is not one of {WINDOW_BATCHES}")
    if not _spec_rows_ok(B, G):
        raise ValueError(f"gamma {G} must be in [1, {SPEC_MAX_GAMMA}] with B·(γ+1) ≤ {SPEC_MAX_VERIFY_ROWS}")
    for name, tab in (("tables_t", tables_t), ("tables_d", tables_d)):
        if tab.dim() != 2 or tab.shape[0] != B:
            raise ValueError(f"{name} must be [B, W], got {tuple(tab.shape)}")
    ints = [x.to(device=dev, dtype=torch.int32).contiguous()
            for x in (tokens, xprev, positions, tables_t, tables_d, active, top_ks)]
    floats = [x.to(device=dev, dtype=torch.float32).contiguous() for x in (temps, top_ps, uniforms)]
    for name, x, shape in (("temps", floats[0], (B,)), ("top_ks", ints[6], (B,)), ("top_ps", floats[1], (B,)),
                           ("uniforms", floats[2], (rounds, B, 2 * G + 1)), ("xprev", ints[1], (B,)),
                           ("positions", ints[2], (B,)), ("active", ints[5], (B,))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(x.shape)}")
    if profile is not None and (profile.device != dev or profile.dtype != torch.int64
                                or profile.numel() != spec_profile_len(rounds, G)):
        raise ValueError(f"profile must be int64 [{spec_profile_len(rounds, G)}] on {dev}")
    blocks, sms = fused_spec_grid(dtype, B, t["H"] // t["KVH"], t["HD"], d["H"] // d["KVH"], d["HD"], dev)
    if blocks < sms:
        raise RuntimeError(f"fused_spec_window: {blocks} co-resident blocks on {sms} SMs; "
                           "the scheduler's fused_spec_fits gate refuses this shape")
    grid = min(blocks, _WINDOW_BLOCKS_PER_SM * sms)
    toks_out = torch.empty((rounds, B, G + 1), dtype=torch.int32, device=dev)
    accepted = torch.empty((rounds, B), dtype=torch.int32, device=dev)
    if rounds == 0:
        return toks_out, accepted
    # Attention key splits of each model: enough (row, KV head, split) items to cover the grid.
    S_d = max(1, min(_WINDOW_MAX_SPLITS, grid // (B * d["KVH"])))
    S_t = max(1, min(_WINDOW_MAX_SPLITS, grid // (Bv * t["KVH"])))
    f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
    tw = dict(dtype=dtype, device=dev)

    def model_scratch(m, n, S):
        """One model's forward scratch over n rows: h, qkv, attention
        partials (acc, (m, l)), attention rows, split counters (zero), gate|up."""
        g = m["H"] // m["KVH"]
        return [torch.empty((n, m["D"]), **tw), torch.empty((n, (m["H"] + 2 * m["KVH"]) * m["HD"]), **tw),
                torch.empty((n * m["KVH"] * S, g, m["HD"]), **f32), torch.empty((n * m["KVH"] * S, g, 2), **f32),
                torch.empty((n, m["H"] * m["HD"]), **tw), torch.zeros((n * m["KVH"],), **i32),
                torch.empty((n, 2 * m["F"]), **tw)]

    plan, tc_bufs = _tc_plan([window_phases(m["D"], m["H"] * m["HD"], m["KVH"] * m["HD"], m["F"], V) for m in (t, d)],
                             [Bv, B], grid, dtype, dev)
    dlog, tlog = torch.empty((G, B, V), **f32), torch.empty((Bv, V), **f32)  # scaled draft and target logits
    bufs = [
        k_t, v_t, k_d, v_d, *ints[:6], ints[6], *floats, toks_out, accepted,
        torch.empty((3, B), **i32),  # cursors: pos, tok, xprev
        torch.empty((G, B), **i32),  # proposals
        *model_scratch(d, B, S_d), *model_scratch(t, Bv, S_t),
        torch.empty((grid, B), **f32), torch.empty((grid, B), **i32),  # draft argmax partials
        ints[3].repeat(G + 1, 1), ints[5].repeat(G + 1), torch.empty((Bv,), **i32),  # verify tables, active, positions
        dlog, tlog,
        torch.empty((G, B, 3), **f32), torch.empty((Bv, 3), **f32), torch.empty((Bv,), **i32),  # filters, modes
        profile, *tc_bufs,
    ]
    ptrs = (ctypes.c_void_p * len(bufs))(*(b.data_ptr() if b is not None else None for b in bufs))
    wptrs = (ctypes.c_void_p * 24)(*(w.data_ptr() if w is not None else None for w in w_t + w_d))
    dims = (ctypes.c_int * 44)(
        B, grid, G, rounds, V, block_size,
        t["L"], t["N"], t["H"], t["KVH"], t["HD"], tables_t.shape[1], t["D"], t["F"], S_t,
        d["L"], d["N"], d["H"], d["KVH"], d["HD"], tables_d.shape[1], d["D"], d["F"], S_d, *plan)
    fdims = (ctypes.c_float * 4)(t_rms_eps, t_theta, d_rms_eps, d_theta)
    _, launch = _spec_kernel()
    with torch.cuda.device(dev):
        rc = launch(_DTYPE_CODE[dtype], len(bufs), wptrs, ptrs, dims, fdims,
                    torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_spec_window kernel launch failed: cudaError {rc}")
    if scratch is not None:
        scratch.update(draft_logits=dlog, target_logits=tlog)
    SPEC_KERNEL_LAUNCHES += 1
    return toks_out, accepted
