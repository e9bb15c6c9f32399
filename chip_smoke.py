"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``dynamo_tpu_torch/csrc`` with nvcc, holds each kernel against its plain
PyTorch version at the shapes the serving path gives it (and times the
launch-overhead probe), among them the ragged kernel on each of its two
paths alone (a fresh-only prefill beside SDPA and the flash kernel, a
decode step beside SDPA), its grid's fixed cost and repeat calls, which
must be bit-equal, ``chunk_decode``'s wave and spec verify (each row
padded to whole chunk tiles; the verify also packed), and its int8
branch over
int8 pages (llama-3.2-1b's and llama-3-8b's widths), the fused decode window's sampled
epilogue, alone on given logits (also on rows masked to -inf, as guided
rows reach it) and inside the window, its guided epilogue (greedy and
sampled rows constrained by a regex, a JSON schema and a choice over the
port's grammar pools at the full vocabulary: no token outside a grammar,
the FSM rows the host's replay), and the fused spec window (llama-3.2-1b over a perturbed copy of itself and llama-3.2-3b over
a llama-3.2-1b draft in f32, both pairs timed in bf16); runs the
full-width llama-3.2-1b model on the kernel paths against the plain
paths, the fused window, greedy and sampled, against ``decode_multi``,
and the spec window speculating with the target's own weights against
the fused window's greedy stream, and llama-3.2-1b with int8 KV and int8
weights (resident bytes; bf16 steps against the plain path and f32; an
f32 ``decode_multi`` window's tokens and written codes), ``chunk_decode``
(a wave and a spec verify, bf16 and int8, against the plain path and f32)
and an int8-weight scheduler speculating one round an iteration against
the same scheduler without the draft, and the per-request extras' device
ops (penalties, top-logprobs with their tie order, ``logit_bias``)
against the CPU at [8, 128256]; replays each
CUDA graph the scheduler captures (``engine/graphs.py``: prefill, mixed,
decode, ``decode_sample``, the draw at B = 1 and 8, a ``decode_multi``
window; bf16 and int8) on the inputs of an eager call and holds logits,
tokens and KV blocks bit-equal, then again after refilling its static
buffers; times a decode
step and a mixed step (bf16, and int8; eager and as graphs), the
per-step threefry draw and a 32-step decode window, greedy, sampled and
guided, a spec window, a wave's forward (eager and graphed), a
per-round spec round and an extras draw (penalties, then the draw with
top logprobs); then serves ``dynamo_tpu_torch.run in=http
out=llama-3.2-1b`` seven times: on the megakernel path and on the
per-piece path (``attention_impl="paged", prefill_impl="flash"``), both
at one decode step per iteration, with the defaults (32-step decode
windows, every window fused, sampled rows drawn in the kernel), and with
a llama-3.2-1b draft of the target's weights (``--draft-model``: every
batch speculates in fused spec windows), the same draft at one decode
step per iteration (``spec-rounds``: one spec round an iteration through
``chunk_decode``), and with ``--kv-cache-dtype int8 --weight-dtype int8`` (every step through the ragged kernel's int8
branch, a copy-on-write prefix hit on the int8 cache), and ``extras``:
the defaults with a burst that mixes plain requests with logprobs and
``top_logprobs``, penalties, a ``logit_bias``, ``n = 3`` and a forced
``tool_choice`` (the plain rows ride fused windows through the row-wise
fallback while the extras rows single-step; every logprob, the biased
answer, the three choices and the tool call are checked); the megakernel
passes start with ``--warmup-ctx 2048`` (the step graphs captured before
traffic: its seconds, graphs and pool bytes, and no capture after it) and
the 1-step pass must run the overlapped decode pipeline and admit a
wave; sending each concurrent
requests and counting every kernel's launches; the windows and spec
passes also send one seeded sampled request at two batch slots and hold
its two answers equal, and structured-output requests
(``response_format: json_schema`` and ``json_object``, ``nvext.
guided_choice``) whose answers must hold their grammars, reporting each
grammar's compile and pool-write seconds, the pools' bytes and the
unguided requests' TTFT, and whose windows must take the guided
epilogue; then runs the distributed main path as an operator does
(``distributed``): the control plane, two workers and the frontend with
the KV router as separate processes, two families of long shared prefixes
sent through the frontend, each repeat served from the prefix cache of
the worker that holds it, each worker's kernel launches read from its
log, and the probes' text held against the in-process path; then, on the
same deployment, ``python -m dynamo_tpu_torch.run`` in its ``in=batch``
and ``in=text`` modes against ``out=dyn://dynamo.backend.generate``, three
KV router configurations in this process (4 indexer shards, two routers
gossiping their pending prefills, approximate mode without KV events),
the capacity dial's ``set_dial`` op with a burst after each setting, the
port's host library (``csrc/native.cc``: hashing and the radix tree)
against its pure-Python path, image prompts through an encode worker
(``--role encode --vision-model vit-l-14``) behind the frontend's
``--encode-component`` (a photo, two images in one message, a grey and a
palette PNG, written with zlib; their texts against an in-process
replay), ``/v1/responses`` against chat and five requests on one
kept-alive connection, the vision tower's bf16 error on the card, and
``/v1/embeddings`` against the f32 embed, and last a worker SIGKILLed
mid-stream behind a frontend with ``migration_limit=1``, each held
against its in-process reference.
Before that, ``checkpoint`` serves the model from files it writes (HF
safetensors shards, a q8_0 GGUF, a Llama-3-layout ``tokenizer.json`` with
a chat template) through ``--checkpoint``/``--tokenizer``: the loaded
weights bit-equal to the written ones, the token ids those of the same
service given the weights as ``params=``, the self-speculating draft's and
the GGUF's likewise, int8 codes equal to ``quantize_weight``'s, and the
loads' and the tokenizer's host costs.
Every phase prints JSON lines; any failure raises and
exits non-zero. The last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device it exits 2 and prints no result.

Then ``kvbm`` serves long prompts through an engine whose G1 is too small
to keep them, with host (G2) and disk (G3) tiers: evicted blocks offload,
repeats onboard them, bit-equal, and answer as a G1 that kept them does;
and ``disagg`` runs a ``--role prefill`` and a ``--role decode`` worker
(the KV handed over on the card through CUDA IPC) behind the frontend,
their answers held against an aggregated engine in process, and the host
wire's bytes against a device pull's.

Then ``families`` serves the MoE and MLA model families through ``run``
(``phase_families``): mixtral-8x7b at full width cut to 8 layers, its
ragged kernel launches exact and one MoE layer's ragged dispatch held
against the dense one; DeepSeek-V2-Lite whole, MLA over the paged latent
cache with 64-expert MoE layers, a prefix hit, decode against prefill and
the int8 latent cache against f32. It runs first, on the card, while nvcc
still builds the kernels it does not use; ``distributed``, ``kvbm`` and
``disagg`` (the ragged kernel and the fused window) run next, while nvcc
still builds the fused spec window.

``--phases`` runs a subset of families,kernel,model,breakdown,serve,checkpoint,
distributed,kvbm,disagg (env and build always run) for iteration; the full run is the default. ``grammar``,
outside the default, times a ``json_object`` grammar's token FSM over the
checkpoint phase's 128,256-id vocabulary (minutes of host time).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import gc
import http.client
import json
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 CUDA-core
# The Pallas kernel body each CUDA kernel replaces (its pallas_call line).
TPU_KERNEL = {
    "ragged_paged_attention": "dynamo_tpu/engine/attention/megakernel.py:123",  # :296
    "ragged_paged_attention_int8": "dynamo_tpu/engine/attention/megakernel.py:160",  # quant=True, :137-175
    "flash_chunk_attention": "dynamo_tpu/engine/attention/prefill.py:46",  # :168
    "paged_decode_partials": "dynamo_tpu/engine/attention/decode.py:65",  # :173
    "fused_decode_window": "dynamo_tpu/engine/attention/megakernel.py:358",  # :619
    "fused_decode_window_sampled": "dynamo_tpu/engine/attention/megakernel.py:509",  # the sampled branch
    "fused_decode_window_guided": "dynamo_tpu/engine/attention/megakernel.py:503",  # the guided branch, :518
    "fused_spec_window": "dynamo_tpu/engine/attention/megakernel.py:807",  # :1034
    "nop": "bench.py:142",  # :145
}
PRESET = "llama-3.2-1b"
PER_PIECE = dict(attention_impl="paged", prefill_impl="flash")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_counters():
    """name → (module, launch-count attribute, plain-call attribute) of every
    kernel wrapper."""
    from dynamo_tpu_torch import bench
    from dynamo_tpu_torch.engine.attention import decode, megakernel, prefill

    return {"ragged_paged_attention": (megakernel, "KERNEL_LAUNCHES", "REF_CALLS"),
            "ragged_paged_attention_int8": (megakernel, "KERNEL_LAUNCHES_INT8", "REF_CALLS_INT8"),
            "flash_chunk_attention": (prefill, "KERNEL_LAUNCHES", "REF_CALLS"),
            "paged_decode_partials": (decode, "KERNEL_LAUNCHES", "REF_CALLS"),
            "fused_decode_window": (megakernel, "WINDOW_KERNEL_LAUNCHES", "WINDOW_REF_CALLS"),
            "fused_decode_window_sampled": (megakernel, "WINDOW_SAMPLED_LAUNCHES", "WINDOW_SAMPLED_REF_CALLS"),
            "fused_decode_window_guided": (megakernel, "WINDOW_GUIDED_LAUNCHES", "WINDOW_GUIDED_REF_CALLS"),
            "sample_epilogue": (megakernel, "EPILOGUE_KERNEL_LAUNCHES", "EPILOGUE_REF_CALLS"),
            "fused_spec_window": (megakernel, "SPEC_KERNEL_LAUNCHES", "SPEC_REF_CALLS"),
            "nop": (bench, "KERNEL_LAUNCHES", "REF_CALLS")}


def reset_counts() -> None:
    for mod, launches, plain in kernel_counters().values():
        setattr(mod, launches, 0)
        setattr(mod, plain, 0)


def read_counts() -> dict:
    return {name: {"launches": getattr(mod, launches), "plain_calls": getattr(mod, plain)}
            for name, (mod, launches, plain) in kernel_counters().items()}


def tensor_core_ops(library: str) -> dict:
    """Tensor-core instructions in a built library's machine code
    (``cuobjdump --dump-sass``): HGMMA (wgmma) and HMMA (mma.sync)."""
    from pathlib import Path

    from dynamo_tpu_torch import _build

    sass = subprocess.run([str(Path(_build.nvcc()).parent / "cuobjdump"), "--dump-sass", library],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    return {op: sass.count(op + ".") for op in ("HGMMA", "HMMA")}


def bound(nbytes: int, flops: int, dtype) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def cuda_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the card over ``iters`` runs, each
    bracketed by CUDA events, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# Phase 3: the attention kernel against its plain version
# ---------------------------------------------------------------------------


def attention_case(name, *, H, KVH, HD, chunk, chunk_prefix, decode_ctx, dtype, dev, seed,
                   tail_width=0, dead=0):
    """One ragged step's inputs in the layout ``llama.mixed_step`` builds:
    row 0 a chunk of ``chunk`` queries over a ``chunk_prefix``-token paged
    prefix (fresh keys [0, i+1)), rows 1.. one decode query each with
    ``decode_ctx[d]`` tokens of context (prefix ctx-1, its own fresh key).
    Pages are drawn at random from a pool whose page 0 is scratch filled
    with large values, so a read past a row's length shows. ``dead`` chunk
    queries at the end of the chunk are padding (meta active 0)."""
    from dynamo_tpu_torch.engine.attention import megakernel as mk

    BS = 16
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = len(decode_ctx)
    prefix_lens = [chunk_prefix] + [c - 1 for c in decode_ctx]
    pages_per_row = [(p + BS - 1) // BS for p in prefix_lens]
    W = max(max(pages_per_row), 1) + tail_width
    total = sum(pages_per_row)
    NP = total + 1
    perm = (torch.randperm(NP - 1, generator=g) + 1)[:total]
    tables = torch.zeros((1 + B, W), dtype=torch.int32)
    o = 0
    for r, n in enumerate(pages_per_row):
        tables[r, :n] = perm[o:o + n].to(torch.int32)
        o += n
    NQ, CK = chunk + B, chunk + B
    k_pages = torch.randn((NP, BS, KVH, HD), generator=g)
    v_pages = torch.randn((NP, BS, KVH, HD), generator=g)
    k_pages[0] = 1e4
    v_pages[0] = 1e4
    q = torch.randn((NQ, H, HD), generator=g)
    k_extra = torch.randn((CK, KVH, HD), generator=g)
    v_extra = torch.randn((CK, KVH, HD), generator=g)
    s_iq = torch.arange(chunk, dtype=torch.int32)
    d_iq = torch.arange(B, dtype=torch.int32)
    meta = mk.build_meta(
        torch.cat([torch.zeros_like(s_iq), 1 + d_iq]),
        torch.tensor(prefix_lens[:1] * chunk + prefix_lens[1:], dtype=torch.int32),
        torch.cat([torch.zeros_like(s_iq), chunk + d_iq]),
        torch.cat([s_iq + 1, chunk + d_iq + 1]),
        torch.cat([s_iq < chunk - dead, torch.ones(B, dtype=torch.bool)]),
    )
    to = lambda t: t.to(device=dev, dtype=dtype if t.is_floating_point() else t.dtype).contiguous()  # noqa: E731
    args = tuple(to(t) for t in (q, k_extra, v_extra, k_pages, v_pages, tables, meta))
    return {"name": name, "args": args, "KVH": KVH, "BS": BS, "dtype": dtype, "dead": dead}


def attention_work(case):
    """(bytes, flops) the step needs: each input read once (only the pages
    live rows reach, within their prefix), the output written once; QK and
    PV products over every key a live query sees."""
    from dynamo_tpu_torch.engine.kv_cache import QuantKv

    q, k_extra, v_extra, k_pages, v_pages, tables, meta = case["args"]
    BS = case["BS"]
    NQ, H, HD = q.shape
    esz = q.element_size()
    row_of, prefix, e_start, e_end, live = meta.long().cpu()
    live = live != 0
    pages = set()
    for r in torch.unique(row_of[live]).tolist():
        n = (int(prefix[row_of == r].max()) + BS - 1) // BS
        pages.update(tables[r, :n].tolist())
    if isinstance(k_pages, QuantKv):  # a page's int8 codes and its f32 scales
        page_bytes = k_pages.q[0].numel() + k_pages.scale[0].numel() * 4
    else:
        page_bytes = k_pages[0].numel() * esz
    nbytes = (
        2 * len(pages) * page_bytes
        + (q.numel() + k_extra.numel() + v_extra.numel() + q.numel()) * esz
        + tables.numel() * 4 + meta.numel() * 4
    )
    keys = (prefix.clamp(max=tables.shape[1] * BS) + (e_end - e_start).clamp(min=0))[live]
    flops = 4 * H * HD * int(keys.sum())
    return nbytes, flops


def sdpa_yardstick(case):
    """``scaled_dot_product_attention`` on the same step with the K/V
    gathered dense per row (GQA heads expanded) and a boolean mask: one
    PyTorch call computing the same function, a yardstick only. Returns the
    call; an int8 case returns ``(dequant + SDPA, SDPA alone)``: the pages'
    codes and scales gathered per row beforehand, then one PyTorch
    expression dequantizing them to dense K/V in q's dtype before the same
    call."""
    from dynamo_tpu_torch.engine.kv_cache import QuantKv

    q, k_extra, v_extra, k_pages, v_pages, tables, meta = case["args"]
    BS, KVH = case["BS"], case["KVH"]
    NQ, H, HD = q.shape
    row_of, prefix, e_start, e_end, live = meta.long()
    R, W = tables.shape
    counts = torch.bincount(row_of, minlength=R).tolist()
    QM = max(counts)
    S = W * BS + k_extra.shape[0]
    quant = isinstance(k_pages, QuantKv)

    def dense(pages, extra):
        if quant:  # pages: (codes, scales) gathered per row
            pages = pages[0].to(q.dtype) * pages[1].to(q.dtype)
        d = torch.cat([pages.reshape(R, W * BS, KVH, HD), extra[None].expand(R, -1, -1, -1)], 1)
        return d.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()  # [R, H, S, HD]

    gathered = [(p.q[tables.long()], p.scale[tables.long()]) if quant else p[tables.long()]
                for p in (k_pages, v_pages)]
    kd, vd = dense(gathered[0], k_extra), dense(gathered[1], v_extra)
    qd = torch.zeros((R, QM, H, HD), dtype=q.dtype, device=q.device)
    mask = torch.zeros((R, 1, QM, S), dtype=torch.bool, device=q.device)
    pos = torch.arange(S, device=q.device)
    slot = torch.zeros(NQ, dtype=torch.long, device=q.device)
    for r in range(R):
        idx = torch.nonzero(row_of == r).squeeze(1)
        slot[idx] = torch.arange(len(idx), device=q.device)
    qd[row_of, slot] = q
    pm = pos[None, :] < prefix[:, None]
    fm = (pos[None, :] >= W * BS + e_start[:, None]) & (pos[None, :] < W * BS + e_end[:, None])
    mask[row_of, 0, slot] = (pm | fm) & (live[:, None] != 0)
    mask[..., 0] |= ~mask.any(-1)  # keep fully-masked padding rows finite
    qd = qd.transpose(1, 2).contiguous()
    fn = lambda: torch.nn.functional.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)  # noqa: E731
    if not quant:
        return fn
    with_dequant = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qd, dense(gathered[0], k_extra), dense(gathered[1], v_extra), attn_mask=mask)
    return with_dequant, fn


def sdpa_causal(q, k, v):
    """``scaled_dot_product_attention(is_causal=True)`` over one chunk of
    ``q [T, H, HD]``, K/V ``[T, KVH, HD]`` expanded over the G heads: the
    yardstick call of a fresh-only prefill."""
    G = q.shape[1] // k.shape[1]
    qd = q.transpose(0, 1)[None].contiguous()
    kd = k.repeat_interleave(G, dim=1).transpose(0, 1)[None].contiguous()
    vd = v.repeat_interleave(G, dim=1).transpose(0, 1)[None].contiguous()
    return lambda: torch.nn.functional.scaled_dot_product_attention(qd, kd, vd, is_causal=True)


def int8_attention_case(name, *, dtype, dev, seed, **spec):
    """``attention_case``'s step over an int8 page pool: the pages quantized
    per (token, KV head) (``kv_cache.quantize_kv_rows``, as the cache holds
    them), with the first 5 tokens of the chunk row's first page all zero
    (scale 1, codes 0); q and the fresh keys in ``dtype``."""
    from dynamo_tpu_torch.engine.kv_cache import QuantKv, quantize_kv_rows

    case = attention_case(name, dtype=torch.float32, dev="cpu", seed=seed, **spec)
    q, k_extra, v_extra, k_pages, v_pages, tables, meta = case["args"]
    pools = []
    for p in (k_pages, v_pages):
        p[int(tables[0, 0]), :5] = 0.0
        pools.append(QuantKv(*(t.to(dev) for t in quantize_kv_rows(p))))
    case["args"] = (*(t.to(dev, dtype) for t in (q, k_extra, v_extra)), *pools, tables.to(dev), meta.to(dev))
    case["dtype"] = dtype
    return case


def check_attention(case, *, time_it: bool):
    from dynamo_tpu_torch.engine.attention import megakernel as mk
    from dynamo_tpu_torch.engine.kv_cache import QuantKv, dequantize_kv

    args, KVH, BS, dtype = case["args"], case["KVH"], case["BS"], case["dtype"]
    quant = isinstance(args[3], QuantKv)
    kw = dict(num_kv_heads=KVH, block_size=BS)
    out = mk.ragged_paged_attention(*args, **kw)
    ref = mk.ragged_paged_attention_ref(*args, **kw)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:
        # Same math in f32; only the summation order differs.
        tol = 5e-5
    else:
        # The plain version rounds p to bf16 before the PV product (as the
        # TPU kernel does); the kernel keeps p in f32. With normalized p,
        # that differs by at most 2^-9·max|v|, plus each output's own bf16
        # rounding (2^-9·|o| each). An int8 pool's v is its dequantized
        # values, which kernel and plain version round alike.
        v_pool = (dequantize_kv(args[4], torch.float32) if quant else args[4])[1:]  # page 0 is scratch
        v_max = max(args[2].abs().max().item(), v_pool.abs().max().item() if v_pool.numel() else 0.0)
        tol = 2**-9 * v_max + 2 * 2**-9 * ref.float().abs().max().item() + 1e-6
    dead_nonzero = 0
    if case["dead"]:
        live = args[6][4] != 0
        dead_nonzero = int((out[~live] != 0).sum().item())
    ok = err <= tol and dead_nonzero == 0 and bool(torch.isfinite(out).all())
    res = {"kernel": "ragged_paged_attention_int8" if quant else "ragged_paged_attention", "case": case["name"],
           "dtype": str(dtype).replace("torch.", ""),
           "shape": {"NQ": args[0].shape[0], "H": args[0].shape[1], "KVH": KVH, "HD": args[0].shape[2],
                     "W": args[5].shape[1]},
           "max_abs_err": err, "tol": tol, "dead_nonzero": dead_nonzero, "ok": ok}
    if time_it:
        nbytes, flops = attention_work(case)
        kernel = lambda: mk.ragged_paged_attention(*args, **kw)  # noqa: E731
        res["kernel_ms"] = cuda_ms(kernel)
        res["ref_ms"] = cuda_ms(lambda: mk.ragged_paged_attention_ref(*args, **kw), iters=20)
        res.update(bound(nbytes, flops, dtype))
        if case.get("causal"):  # a fresh-only prefill: SDPA causal over the chunk
            library = sdpa_causal(args[0], args[1], args[2])
            res["library"] = "scaled_dot_product_attention(is_causal=True), K/V expanded over G"
        elif quant:
            library, alone = sdpa_yardstick(case)
            res["sdpa_alone_ms"] = cuda_ms(alone)
            res["sdpa_alone_device_ms"] = graph_ms(alone)
            res["library"] = "gathered codes dequantized to dense K/V, then scaled_dot_product_attention"
        else:
            library = sdpa_yardstick(case)
            res["library"] = "scaled_dot_product_attention over K/V gathered dense per row, boolean mask"
        res["library_ms"] = cuda_ms(library)
        if dtype == torch.bfloat16:
            per_piece_device_times(res, kernel, library)
    emit("kernel", **res)
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {res}")
    return res


def graph_ms(fn, calls: int = 20) -> float:
    """The card's own milliseconds per call of ``fn``: ``calls`` calls
    captured in one CUDA graph, replayed between CUDA events, so the host's
    time to queue each call is not in the reading."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, iters=10, warmup=1) / calls


def per_piece_device_times(res: dict, kernel, library) -> None:
    """Beside an attention kernel's event times (which hold the wrapper's
    host time when the card waits on it): the card's own
    time per call of the kernel and of the library call, and the rate
    each achieves on the case's operations and bytes."""
    res["device_ms"] = graph_ms(kernel)
    res["library_device_ms"] = graph_ms(library)
    for key in ("kernel_ms", "device_ms"):
        res["achieved_" + key.removesuffix("_ms")] = {"tflop_s": res["flops"] / res[key] / 1e9,
                                                      "tb_s": res["bytes"] / res[key] / 1e9}


def flash_case(dev, dtype, seed, *, T, valid, H, KVH, HD):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(dev, dtype)
                 for shape in ((T, H, HD), (T, KVH, HD), (T, KVH, HD))), valid, KVH


def check_flash(name, case, *, time_it: bool):
    """``flash_chunk_attention`` against its plain version on the card."""
    from dynamo_tpu_torch.engine.attention import prefill as fck

    (q, k, v), valid, KVH = case
    T, H, HD = q.shape
    dtype = q.dtype
    out, m, l = fck.flash_chunk_attention(q, k, v, valid, num_kv_heads=KVH)
    ro, rm, rl = fck.flash_chunk_attention_ref(q, k, v, valid, num_kv_heads=KVH)
    torch.cuda.synchronize()
    err = (out.float() - ro.float()).abs().max().item()
    m_err = (m - rm).abs().max().item()
    l_rel = ((l - rl).abs() / rl).max().item()
    if dtype == torch.float32:
        tol = 5e-5  # the same math in f32; only the summation order differs
    else:
        # Both sides round p to bf16 before the PV product, each against its
        # own max (the kernel's running one), ≤ 2^-9·p each; each output
        # rounds once more (2^-9·|o|).
        tol = 2**-8 * v.float().abs().max().item() + 2**-8 * ro.float().abs().max().item()
    # m and l come from f32 scores of the same inputs on both sides.
    ok = (err <= tol and m_err <= 5e-5 and l_rel <= 5e-5 and bool(torch.isfinite(out).all())
          and bool(torch.all(l > 0)))
    res = {"kernel": "flash_chunk_attention", "case": name, "dtype": str(dtype).replace("torch.", ""),
           "shape": {"T": T, "valid_len": valid, "H": H, "KVH": KVH, "HD": HD},
           "max_abs_err": err, "tol": tol, "m_max_abs_err": m_err, "l_max_rel_err": l_rel, "ok": ok}
    if time_it:
        esz = q.element_size()
        keys = int(torch.clamp(torch.arange(1, T + 1), max=valid).sum())
        res.update(bound(2 * (q.numel() + k.numel()) * esz + 2 * m.numel() * 4, 4 * H * HD * keys, dtype))
        res["kernel_ms"] = cuda_ms(lambda: fck.flash_chunk_attention(q, k, v, valid, num_kv_heads=KVH))
        res["ref_ms"] = cuda_ms(lambda: fck.flash_chunk_attention_ref(q, k, v, valid, num_kv_heads=KVH), iters=10)
        # Yardstick: SDPA causal over the chunk, K/V expanded over the G heads.
        G = H // KVH
        qd = q.transpose(0, 1)[None].contiguous()
        kd = k.repeat_interleave(G, dim=1).transpose(0, 1)[None].contiguous()
        vd = v.repeat_interleave(G, dim=1).transpose(0, 1)[None].contiguous()
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qd, kd, vd, is_causal=True)  # noqa: E731
        res["library_ms"] = cuda_ms(sdpa)
        res["library"] = "scaled_dot_product_attention(is_causal=True), K/V expanded over G"
        per_piece_device_times(res, lambda: fck.flash_chunk_attention(q, k, v, valid, num_kv_heads=KVH), sdpa)
    emit("kernel", **res)
    if not ok:
        raise AssertionError(f"flash_chunk_attention disagrees with its plain version: {res}")
    return res


def paged_case(dev, dtype, seed, *, lengths, H, KVH, HD, extra_width=0, over=0):
    """Decode rows of ``lengths`` tokens over pages drawn at random from a
    pool whose page 0 is scratch with large values; tables ``extra_width``
    slots wider than the longest row, unused slots on page 0; each length
    passed ``over`` tokens past its table."""
    BS = 16
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = len(lengths)
    n_pages = [(n + BS - 1) // BS for n in lengths]
    W = max(n_pages) + extra_width
    NP = sum(n_pages) + 1
    ids = (torch.randperm(NP - 1, generator=g) + 1).to(torch.int32)
    tables = torch.zeros((B, W), dtype=torch.int32)
    o = 0
    for b, n in enumerate(n_pages):
        tables[b, :n] = ids[o:o + n]
        o += n
    kp, vp = (torch.randn((NP, BS, KVH, HD), generator=g) for _ in range(2))
    kp[0] = vp[0] = 1e4
    q = torch.randn((B, H, HD), generator=g)
    args = tuple(t.to(dev, dtype) for t in (q, kp, vp)) + (
        tables.to(dev), torch.tensor([n + over for n in lengths], dtype=torch.int32, device=dev))
    return args, KVH, BS


def check_paged(name, case, *, time_it: bool):
    """``paged_decode_partials`` against its plain version on the card."""
    from dynamo_tpu_torch.engine.attention import decode as pdk

    args, KVH, BS = case
    q, kp, vp, tables, lengths = args
    B, H, HD = q.shape
    dtype = q.dtype
    kw = dict(num_kv_heads=KVH, block_size=BS)
    m, l, acc = pdk.paged_decode_partials(*args, **kw)
    rm, rl, racc = pdk.paged_decode_partials_ref(*args, **kw)
    torch.cuda.synchronize()
    empty = lengths == 0
    empty_ok = bool(torch.all(m[empty] == -1e30) and torch.all(l[empty] == 0) and torch.all(acc[empty] == 0))
    m_err = (m - rm).abs().max().item()
    l_rel = ((l - rl).abs() / rl.clamp_min(1)).max().item()
    err = (acc - racc).abs().max().item()
    # acc is unnormalized: a row's error scales with its l. bf16: both sides
    # round p before the PV product (≤ 2^-9·p each).
    # (A batch of empty rows only has no page past the scratch page.)
    vmax = vp[1:].float().abs().max().item() if len(vp) > 1 else 0.0
    base = 5e-5 if dtype == torch.float32 else 2**-8 * vmax
    tol = base * max(1.0, rl.max().item())
    acc_scaled = ((acc - racc).abs() / rl.clamp_min(1)[..., None]).max().item()
    ok = (empty_ok and acc_scaled <= base and m_err <= 5e-5 and l_rel <= 5e-5
          and bool(torch.isfinite(acc).all()))
    res = {"kernel": "paged_decode_partials", "case": name, "dtype": str(dtype).replace("torch.", ""),
           "shape": {"B": B, "H": H, "KVH": KVH, "HD": HD, "W": tables.shape[1], "BS": BS,
                     "lengths": lengths.tolist()},
           "max_abs_err": err, "tol": tol, "acc_err_over_l": acc_scaled, "acc_tol_over_l": base,
           "m_max_abs_err": m_err, "l_max_rel_err": l_rel, "empty_rows_ok": empty_ok, "ok": ok}
    if time_it:
        esz = q.element_size()
        tokens = int(lengths.clamp(max=tables.shape[1] * BS).sum())
        nbytes = ((2 * tokens * KVH * HD + q.numel()) * esz + (tables.numel() + B) * 4
                  + (m.numel() + l.numel() + acc.numel()) * 4)
        res.update(bound(nbytes, 4 * H * HD * tokens, dtype))
        res["kernel_ms"] = cuda_ms(lambda: pdk.paged_decode_partials(*args, **kw))
        res["ref_ms"] = cuda_ms(lambda: pdk.paged_decode_partials_ref(*args, **kw), iters=10)
        # Yardstick: SDPA over each row's pages gathered dense, K/V expanded
        # over the G heads, keys past the row's length masked.
        G, W = H // KVH, tables.shape[1]
        kd = kp[tables.long()].reshape(B, W * BS, KVH, HD).repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        vd = vp[tables.long()].reshape(B, W * BS, KVH, HD).repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        mask = (torch.arange(W * BS, device=q.device)[None, :] < lengths[:, None].long())[:, None, None, :]
        mask[..., 0] |= ~mask.any(-1)  # keep empty rows finite
        qd = q[:, :, None, :]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)  # noqa: E731
        res["library_ms"] = cuda_ms(sdpa)
        res["library"] = "scaled_dot_product_attention over the gathered pages, K/V expanded over G"
        per_piece_device_times(res, lambda: pdk.paged_decode_partials(*args, **kw), sdpa)
    emit("kernel", **res)
    if not ok:
        raise AssertionError(f"paged_decode_partials disagrees with its plain version: {res}")
    return res


def check_nop(dev):
    """The no-op kernel against its plain version, its time, and the
    launch-overhead probe (``dynamo_tpu_torch.bench``). The probe's
    launches are counted from 0 just before it runs."""
    from dynamo_tpu_torch import bench

    x = torch.randn((8, 128), device=dev)
    y = torch.empty_like(x)
    err = (bench.nop(x) - bench.nop_ref(x)).abs().max().item()
    torch.cuda.synchronize()
    res = {"kernel": "nop", "case": "[8, 128] f32 copy", "max_abs_err": err, "tol": 0.0, "ok": err == 0.0}
    res.update(bound(2 * x.numel() * 4, 0, torch.float32))
    res["kernel_ms"] = cuda_ms(lambda: bench.nop(x))
    res["ref_ms"] = cuda_ms(lambda: bench.nop_ref(x))
    res["library_ms"] = cuda_ms(lambda: y.copy_(x))
    res["library"] = "Tensor.copy_ into a preallocated tensor"
    reset_counts()
    res["dispatch_overhead_ms"] = bench.dispatch_overhead_ms(n=32)
    res["probe_launches"] = bench.KERNEL_LAUNCHES
    emit("kernel", **res)
    if not res["ok"] or res["probe_launches"] != 4 * 32:
        raise AssertionError(f"nop kernel or probe failed: {res}")
    return res


# The scheduler's window counters: fused windows (one launch each), those
# with a sampled row, those with a guided row, non-fused windows
# (decode_multi) and the forward steps inside those.
WINDOW_COUNTERS = ("fused_windows_total", "fused_sampled_windows_total", "fused_guided_windows_total",
                   "multi_windows_total", "window_steps_total")
# (temperature, top_k, top_p) of the sampled checks' rows, in turn: greedy,
# top_k = 1, top-p off, top_k past the vocab, joint top-k/top-p, top-p
# alone, top-k alone, a narrow nucleus.
SAMPLE_MIX = [(0.0, 0, 1.0), (0.9, 1, 1.0), (0.8, 0, 1.0), (0.7, 1 << 20, 0.95), (1.3, 20, 0.9),
              (0.8, 0, 0.9), (1.0, 50, 1.0), (0.6, 0, 0.5)]
# The sampled window checks scale the random model's final norm by this:
# logits spread about 7 (not 0.9) give each row a few dominant tokens, as a
# trained model's do. At the random init a row draws among 128,256
# near-equal tokens, where one rounding apart in the logits moves a CDF
# boundary past u; the epilogue's own check covers such flat rows.
LOGIT_SPREAD = 8.0
WINDOW_WEIGHTS = ("embed", "lm_head", "final_norm", "attn_norm", "mlp_norm", "wq", "wk", "wv", "wo",
                  "w_gate", "w_up", "w_down")


def window_case(name, dev, dtype, seed, *, cfg, positions, dead, steps, spread=1.0):
    """One fused window's inputs: seeded random weights at ``cfg``'s widths
    (the final norm times ``spread``), a cache of random K/V whose block 0
    is scratch filled with 1e4 (a stray read shows), rows whose current
    token writes slot ``positions[b]``, over pages drawn at random that
    cover the window, and ``dead`` padding rows (active 0) at the end."""
    from dynamo_tpu_torch.engine.weights import init_params

    BS, L, KVH, HD = cfg.block_size, cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = len(positions) + dead
    need = [(p + steps - 1) // BS + 1 for p in positions]
    W = max(need) + 2
    NB = sum(need) + 1
    ids = (torch.randperm(NB - 1, generator=g) + 1).to(torch.int32)
    tables = torch.zeros((B, W), dtype=torch.int32)
    o = 0
    for b, n in enumerate(need):
        tables[b, :n] = ids[o:o + n]
        o += n
    gd = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cfg, gd, device=dev, dtype=dtype)
    params["final_norm"].mul_(spread)
    k, v = (torch.randn((L, NB, BS, KVH, HD), generator=gd, device=dev).to(dtype) for _ in range(2))
    k[:, 0] = 1e4
    v[:, 0] = 1e4
    lp = params["layers"]
    weights = [params["embed"], params.get("lm_head"), params["final_norm"]] + [
        lp[n] for n in WINDOW_WEIGHTS[3:]]
    ints = (torch.randint(1, cfg.vocab_size, (B,), generator=g, dtype=torch.int32),
            torch.tensor(list(positions) + [0] * dead, dtype=torch.int32), tables,
            torch.tensor([True] * len(positions) + [False] * dead))
    kw = dict(num_steps=steps, num_heads=cfg.num_heads, num_kv_heads=KVH, head_dim=HD, block_size=BS,
              rms_eps=cfg.rms_norm_eps, theta=cfg.rope_theta)
    return {"name": name, "cfg": cfg, "params": params, "weights": weights, "k": k, "v": v,
            "ints": tuple(t.to(dev) for t in ints), "kw": kw, "dtype": dtype, "positions": list(positions),
            "spread": spread}


def sample_rows(B, steps, dev, seed):
    """The sampled epilogue's operands for ``B`` rows: row b takes
    ``SAMPLE_MIX[b % 8]``; uniforms ``[steps, B]`` from seeded numpy →
    (temps, top_ks, top_ps, uniforms) on ``dev``."""
    rows = [SAMPLE_MIX[b % len(SAMPLE_MIX)] for b in range(B)]
    rng = np.random.default_rng(seed)
    return (torch.tensor([r[0] for r in rows], dtype=torch.float32, device=dev),
            torch.tensor([r[1] for r in rows], dtype=torch.int32, device=dev),
            torch.tensor([r[2] for r in rows], dtype=torch.float32, device=dev),
            torch.from_numpy(rng.random((steps, B), dtype=np.float32)).to(dev))


# The guided checks' grammars (llm/guided specs, over the byte tokenizer at
# the model's vocabulary): a regex, a small JSON schema and a choice.
GUIDED_SCHEMA = {"type": "object", "properties": {"city": {"enum": ["SF", "NY", "LA"]},
                                                  "temp": {"type": "integer"}, "ok": {"type": "boolean"}}}
# The guided window's 8 rows: (grammar, (temperature, top_k, top_p))), a
# grammar of None being an unguided row: three greedy guided rows, three
# sampled guided rows from SAMPLE_MIX, one unguided greedy and one unguided
# sampled row.
GUIDED_ROWS = [(0, SAMPLE_MIX[0]), (1, SAMPLE_MIX[0]), (2, SAMPLE_MIX[0]), (0, SAMPLE_MIX[3]), (1, SAMPLE_MIX[4]),
               (2, SAMPLE_MIX[5]), (None, SAMPLE_MIX[0]), (None, SAMPLE_MIX[7])]
_GUIDED_DECODERS: dict = {}


def guided_specs() -> list:
    from dynamo_tpu_torch.llm.guided.grammar import schema_to_regex

    return [{"kind": "regex", "pattern": r"[a-c]{2}-\d{2,12}"},
            {"kind": "regex", "pattern": schema_to_regex(GUIDED_SCHEMA)},
            {"kind": "choice", "choices": ["red", "green", "blue"]}]


def guided_decoder(dev, V: int):
    """The port's ``GuidedDecoder`` over the byte tokenizer at vocabulary
    ``V``, its pools on ``dev`` at the scheduler's default capacity (1024
    rows), one per (device, V)."""
    from dynamo_tpu_torch.llm.guided.processor import GuidedDecoder
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    key = (str(dev), V)
    if key not in _GUIDED_DECODERS:
        _GUIDED_DECODERS[key] = GuidedDecoder(ByteTokenizer(), eos_ids=[0], vocab_size=V, pool_rows=1024, device=dev)
    return _GUIDED_DECODERS[key]


def guided_rows(dev, V: int, steps: int, seed: int) -> tuple:
    """The guided window's operands for ``GUIDED_ROWS``: (each row's token
    FSM or None, (temps, top_ks, top_ps, uniforms [steps, 8]), (rows0,
    mask_pool, next_pool))."""
    dec, specs = guided_decoder(dev, V), guided_specs()
    states = [None if g is None else dec.open(specs[g]) for g, _ in GUIDED_ROWS]
    rng = np.random.default_rng(seed)
    samp = (torch.tensor([r[0] for _, r in GUIDED_ROWS], dtype=torch.float32, device=dev),
            torch.tensor([r[1] for _, r in GUIDED_ROWS], dtype=torch.int32, device=dev),
            torch.tensor([r[2] for _, r in GUIDED_ROWS], dtype=torch.float32, device=dev),
            torch.from_numpy(rng.random((steps, len(GUIDED_ROWS)), dtype=np.float32)).to(dev))
    rows0 = torch.tensor([0 if st is None else st.row_id for st in states], dtype=torch.int32, device=dev)
    return [None if st is None else st.fsm for st in states], samp, (rows0, dec.pool.device(), dec.pool.next_device())


def guided_replay(fsms, rows0, next_pool, toks) -> dict:
    """The host's replay of a guided window's tokens ``[steps, B]``: per
    guided row the tokens its FSM does not allow where they fall (the walk
    follows ``next_state``; EOS in an accepting state stays there), and its
    mask-pool row after the window through ``next_pool``; the distinct mask
    rows and (row, token) transitions the window read."""
    nxt = next_pool.cpu()
    toks = toks.cpu()
    outside, final, rows_read, moves = {}, {}, set(), set()
    for b, fsm in enumerate(fsms):
        if fsm is None:
            continue
        state, row, bad = 0, int(rows0[b]), []
        for i, tok in enumerate(toks[:, b].tolist()):
            rows_read.add(row)
            moves.add((row, tok))
            if not bad:  # the first token outside the grammar ends the walk
                if fsm.allows(state, tok):
                    state = int(fsm.next_state[state, tok])
                else:
                    bad.append((i, tok))
            row = int(nxt[row, tok])
        outside[b], final[b] = bad, row
    return {"outside": outside, "final_rows": final, "rows_read": len(rows_read), "moves": len(moves)}


def window_work(case):
    """(bytes, streamed bytes, flops) of one window. Bytes: every input
    read once and every output written once: the weights (the tied
    embedding once, as the head; an untied head once, plus the embedding
    rows the steps gather), each live row's cached keys and values before
    the window, the K/V rows the window writes, tables, tokens and the
    tokens out. Streamed bytes: the weights read once per step and each
    live row's K/V up to its position read per step and layer, as a kernel
    must whose weights do not stay on the card's chip (2.47 GB of bf16
    weights against a 50 MB L2). Flops: two per weight and live row per
    step, four per attended key, head and dim."""
    cfg, steps = case["cfg"], case["kw"]["num_steps"]
    esz = case["k"].element_size()
    L, H, KVH, HD = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    embed, head = case["weights"][0], case["weights"][1]
    rest = case["weights"][2:]  # norms and layer matrices
    head_elems = (head if head is not None else embed).numel()
    matmul = sum(w.numel() for w in rest if w.dim() == 3) + head_elems
    rows = len(case["positions"])
    keys = sum(p + j + 1 for p in case["positions"] for j in range(steps))
    B = len(case["ints"][0])
    row_bytes = 2 * L * KVH * HD * esz  # one token's K and V over every layer
    small = case["ints"][2].numel() * 4 + 16 * B + steps * B * 4
    small += 12 * B + steps * B * 4 if case.get("samp") else 0  # temps, top_ks, top_ps, uniforms
    if case.get("guide"):  # rows0, the mask rows and next-row entries the window read, the rows out
        small += 8 * B + case["guided_reads"]["rows_read"] * case["guide"][1].shape[1] * 4 \
            + case["guided_reads"]["moves"] * 4
    gathered = 0 if head is None else steps * rows * embed.shape[1]
    nbytes = ((sum(w.numel() for w in rest) + head_elems + gathered) * esz
              + row_bytes * (sum(case["positions"]) + rows * steps) + small)
    streamed = (steps * (sum(w.numel() for w in rest) + head_elems + rows * embed.shape[1]) * esz
                + row_bytes * (keys + rows * steps) + small)
    flops = 2 * steps * rows * matmul + 4 * H * HD * L * keys
    return nbytes, streamed, flops


def window_bf16_noise(case, sel, k_kern, v_kern, k_plain, v_plain) -> dict:
    """How far the step-0 K/V rows (``sel``) lie from the f32 truth (one
    forward of the rows' step-0 tokens over f32 copies of the weights and
    cache, ``megakernel._cache_forward``), for the kernel and for the plain
    bf16 version."""
    from dynamo_tpu_torch.engine.attention import megakernel as mk

    tokens, positions, tables, active = case["ints"]
    k, v = case["k"].float(), case["v"].float()
    w32 = tuple(x.float() if x is not None else None for x in case["weights"])
    kw = case["kw"]
    mk._cache_forward(w32, k, v, tokens.long(), positions.long(), tables.long(), active.bool(),
                      num_heads=kw["num_heads"], rms_eps=kw["rms_eps"], theta=kw["theta"], head=False)

    def dist(a, b):
        return max((a[:, sel].float() - k[:, sel]).abs().max().item(), (b[:, sel].float() - v[:, sel]).abs().max().item())

    return {"kernel_vs_f32": dist(k_kern, v_kern), "plain_vs_f32": dist(k_plain, v_plain)}


def check_window(case, *, time_it: bool, hold_tokens: bool = True, kv_gate: str = "plain"):
    """``fused_decode_window`` against its plain version on the card, greedy
    or, where the case holds ``samp``, with the sampled epilogue, and where
    it holds ``guide`` (rows0, mask_pool, next_pool) and ``fsms`` (each
    row's token FSM or None), with the guided epilogue. Both start from
    copies of one cache. f32: every live row's tokens equal and the written
    K/V rows within 1e-3; bf16: the step-0 tokens equal (unless
    ``hold_tokens`` is false) and the step-0 K/V rows within 2^-5 of their
    scale (each side rounds every product to bf16, in its own summation
    order, through 16 layers of a bf16 residual, and the kernel keeps p in
    f32 where the plain version rounds it), the window's token agreement
    printed. In both, every other cache slot (block 0 aside) is left as it
    was; guided, in both dtypes, no token of either side outside its row's
    grammar (the host FSM's replay) and each row's FSM row after the
    window the host's replay of the kernel's tokens. Timed sampled: also
    the greedy window on the same inputs, and both windows' phases from
    the kernel's stamps; timed guided: also the sampled window on the same
    inputs, and the guided window's phases. With ``kv_gate="noise"`` (a
    deeper model, whose plain bf16 rows drift further than 2^-5 of their
    scale from any other rounding of the same math) the bf16 step-0 K/V
    are held as the spec check holds its rows: no further from the f32
    truth than ``SPEC_BF16_NOISE_RATIO`` times the plain bf16 version."""
    from dynamo_tpu_torch.engine.attention import megakernel as mk

    w, ints, kw, dtype = case["weights"], case["ints"], case["kw"], case["dtype"]
    samp = case.get("samp") or ()
    guide = case.get("guide") or ()
    extra = (*(samp or (None,) * 4), *guide) if guide else samp
    k0, v0 = case["k"], case["v"]
    kk, vk, kr, vr = k0.clone(), v0.clone(), k0.clone(), v0.clone()
    B = len(ints[0])
    rows_k, rows_r = (torch.empty(B, dtype=torch.int32, device=k0.device) for _ in range(2))
    out = dict(rows_out=rows_k) if guide else {}
    toks = mk.fused_decode_window(*w, kk, vk, *ints, *extra, **kw, **out)
    ref = mk.fused_decode_window_ref(*w, kr, vr, *ints, *extra, **kw, **(dict(rows_out=rows_r) if guide else {}))
    torch.cuda.synchronize()
    steps, BS = kw["num_steps"], kw["block_size"]
    live = ints[3].cpu()
    tables = ints[2].cpu()
    written = torch.zeros(k0.shape[1:3], dtype=torch.bool)  # [blocks, BS]
    first = torch.zeros_like(written)
    for b, p in enumerate(case["positions"]):
        for j in range(steps):
            blk, off = int(tables[b, (p + j) // BS]), (p + j) % BS
            written[blk, off] = True
            first[blk, off] |= j == 0
    written, first = written.to(k0.device), first.to(k0.device)
    keep = ~written
    keep[0] = False
    untouched = bool(torch.equal(kk[:, keep], k0[:, keep]) and torch.equal(vk[:, keep], v0[:, keep]))
    tl, rl = toks[:, live].cpu(), ref[:, live].cpu()
    agree = (tl == rl).float().mean().item()
    sel = written if dtype == torch.float32 else first
    kv_err = max((kk[:, sel].float() - kr[:, sel].float()).abs().max().item(),
                 (vk[:, sel].float() - vr[:, sel].float()).abs().max().item())
    scale = max(kr[:, sel].float().abs().max().item(), vr[:, sel].float().abs().max().item())
    step0_equal = bool(torch.equal(tl[0], rl[0]))
    step0_gaps = step0_gap_check(case, k0, v0) if dtype != torch.float32 and not samp else None
    if dtype == torch.float32:
        tol = 1e-3
        ok = bool(torch.equal(tl, rl)) and kv_err <= tol
    elif kv_gate == "noise":
        noise = window_bf16_noise(case, sel, kk, vk, kr, vr)
        tol = (1 + SPEC_BF16_NOISE_RATIO) * noise["plain_vs_f32"]  # what that allows kernel vs plain
        ok = (step0_equal or not hold_tokens) and noise["kernel_vs_f32"] <= SPEC_BF16_NOISE_RATIO * noise["plain_vs_f32"]
    else:
        tol = 2**-5 * scale
        ok = (step0_equal or not hold_tokens) and kv_err <= tol
        if step0_gaps is not None:  # step 0 held wherever the plain top-2 gap exceeds rounding
            ok = ok and step0_gaps["ok"]
    ok = ok and untouched
    guided = None
    if guide:
        live_fsms = [f if live[b] else None for b, f in enumerate(case["fsms"])]
        kern, plain = (guided_replay(live_fsms, guide[0].cpu(), guide[2], t) for t in (toks, ref))
        case["guided_reads"] = kern
        outside = sum(len(v) for v in kern["outside"].values()) + sum(len(v) for v in plain["outside"].values())
        rows_match = all(int(rows_k[b]) == r for b, r in kern["final_rows"].items())
        guided = {"rows": [[g, list(r)] for g, r in GUIDED_ROWS], "tokens_outside_grammar": outside,
                  "outside": {"kernel": kern["outside"], "plain": plain["outside"]},
                  "final_rows": [int(r) for r in rows_k.cpu()], "final_rows_plain": [int(r) for r in rows_r.cpu()],
                  "final_rows_host": kern["final_rows"], "final_rows_match_host": rows_match,
                  "texts": {b: mk_text(toks[:, b]) for b in kern["final_rows"]}}
        ok = ok and outside == 0 and rows_match
    cfg = case["cfg"]
    res = {"kernel": "fused_decode_window", "case": case["name"], "dtype": str(dtype).replace("torch.", ""),
           "epilogue": "guided" if guide else "sampled" if samp else "greedy",
           "shape": {"B": len(live), "live": int(live.sum()), "steps": steps, "L": cfg.num_layers,
                     "D": cfg.hidden_size, "H": cfg.num_heads, "KVH": cfg.num_kv_heads, "HD": cfg.head_dim,
                     "F": cfg.intermediate_size, "V": cfg.vocab_size, "tied": w[1] is None,
                     "positions": case["positions"], "W": tables.shape[1]},
           "token_agreement": agree, "step0_tokens_equal": step0_equal, "max_abs_err": kv_err,
           "kv_scale": scale, "tol": tol, "kv_compared": "written rows" if dtype == torch.float32 else "step-0 rows",
           "other_slots_unchanged": untouched, "ok": ok}
    if step0_gaps is not None:
        res["step0_gaps"] = step0_gaps
    if kv_gate == "noise" and dtype != torch.float32:
        res["bf16_noise"] = {**noise, "ratio": SPEC_BF16_NOISE_RATIO}
    if guided is not None:
        res["guided"] = guided
    if samp:
        res["rows"] = [r for _, r in GUIDED_ROWS] if guide else [SAMPLE_MIX[b % len(SAMPLE_MIX)] for b in range(len(live))]
        res["logit_spread"] = case["spread"]
        if not ok or agree < 1:
            res["tokens"], res["plain_tokens"] = tl.tolist(), rl.tolist()
    if dtype == torch.bfloat16:
        res["repeats"] = window_repeats(case)
        ok = ok and res["repeats"]["bit_equal"]
        res["ok"] = ok
    if time_it:
        nbytes, streamed, flops = window_work(case)
        res.update(bound(nbytes, flops, dtype))
        res["streamed_bytes"] = streamed
        res["streamed_bound_ms_per_step"] = bound(streamed, flops, dtype)["bound_ms"] / steps
        res["kernel_ms"] = cuda_ms(lambda: mk.fused_decode_window(*w, kk, vk, *ints, *extra, **kw), iters=5, warmup=1)
        res["kernel_ms_per_step"] = res["kernel_ms"] / steps
        res["ref_ms"] = cuda_ms(lambda: mk.fused_decode_window_ref(*w, kr, vr, *ints, *extra, **kw), iters=3, warmup=1)
        res["library_ms"] = None  # no single PyTorch call computes a decode window
        if guide:
            res["sampled_kernel_ms"] = cuda_ms(lambda: mk.fused_decode_window(*w, kk, vk, *ints, *samp, **kw),
                                               iters=5, warmup=1)
            res["sampled_kernel_ms_per_step"] = res["sampled_kernel_ms"] / steps
            res["phases_ms_per_step"] = stamp_phases(w, kk, vk, ints, extra, kw, cfg.num_layers)
        elif samp:
            res["greedy_kernel_ms"] = cuda_ms(lambda: mk.fused_decode_window(*w, kk, vk, *ints, **kw), iters=5, warmup=1)
            res["greedy_kernel_ms_per_step"] = res["greedy_kernel_ms"] / steps
            res["phases_ms_per_step"] = stamp_phases(w, kk, vk, ints, samp, kw, cfg.num_layers)
            res["greedy_phases_ms_per_step"] = stamp_phases(w, kk, vk, ints, (), kw, cfg.num_layers)
        else:
            res["phases_ms_per_step"] = stamp_phases(w, kk, vk, ints, (), kw, cfg.num_layers)
        if dtype == torch.bfloat16:  # the product phases beside one cuBLAS forward of the same rows
            res["products_per_step"] = products_summary(res["phases_ms_per_step"], matrix_bytes(w),
                                                        cublas_products(w, B))
    emit("kernel", **res)
    if not ok:
        raise AssertionError(f"fused_decode_window disagrees with its plain version: {res}")
    return res


def window_repeats(case) -> dict:
    """Two calls of the window from copies of one cache, the sampled
    epilogue's [B, V] logits scratch kept (``scratch=``): tokens, every
    cache slot (block 0, the dead rows' sink, aside), the last step's
    scaled logits and, guided, the rows after
    the window must be bit-equal (split phases merge in split order behind
    self-resetting counters)."""
    from dynamo_tpu_torch.engine.attention import megakernel as mk

    w, ints, kw = case["weights"], case["ints"], case["kw"]
    samp = case.get("samp") or ()
    guide = case.get("guide") or ()
    extra = (*(samp or (None,) * 4), *guide) if guide else samp
    runs = []
    for _ in range(2):
        k, v, scratch = case["k"].clone(), case["v"].clone(), {}
        rows = dict(rows_out=torch.empty(len(ints[0]), dtype=torch.int32, device=k.device)) if guide else {}
        toks = mk.fused_decode_window(*w, k, v, *ints, *extra, **kw, **rows, scratch=scratch)
        runs.append([toks, k[:, 1:], v[:, 1:], *scratch.values(), *rows.values()])
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(*runs))
    return {"compared": ["tokens", "k", "v"] + (["logits"] if samp else []) + (["rows_out"] if guide else []),
            "bit_equal": equal}


# A bf16 greedy window's step-0 argmax may differ from the plain version's
# only where the plain version's top-2 logits lie within this many times the
# row's bf16 logit noise: the largest distance of the plain bf16 logits from
# the f32 truth (the same forward over f32 copies of the weights and cache).
# Each side moves each of the two logits by at most its noise, the kernel's
# taken as no larger than the plain version's (the spec check measures that
# for the shared device code), so a flip needs a gap of at most 4 noises.
STEP0_GAP_NOISES = 4


def mk_text(tokens) -> str:
    """A row's tokens as the byte tokenizer's text."""
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    return ByteTokenizer().decode(tokens.cpu().tolist())


def step0_gap_check(case, k0, v0) -> dict:
    """Where the kernel's step-0 tokens may differ: the plain version's
    step-0 logits (``megakernel._cache_forward`` on a copy of the cache
    before the window) in bf16 and over f32 copies of the same weights and
    cache, each live row's top-2 gap, its bf16 noise (the largest |bf16 −
    f32| logit) and its bound, ``STEP0_GAP_NOISES`` noises. Every row whose
    gap exceeds its bound must pick the same token on both sides."""
    from dynamo_tpu_torch.engine.attention import megakernel as mk

    w, ints, kw = case["weights"], case["ints"], case["kw"]
    tokens, positions, tables, active = ints
    k_, v_ = k0.clone(), v0.clone()
    toks = mk.fused_decode_window(*w, k_, v_, *ints, **{**kw, "num_steps": 1})
    args = (tokens.long(), positions.long(), tables.long(), active.bool())
    fkw = dict(num_heads=kw["num_heads"], rms_eps=kw["rms_eps"], theta=kw["theta"])
    logits = mk._cache_forward(tuple(w), k0.clone(), v0.clone(), *args, **fkw)
    w32 = tuple(x.float() if x is not None else None for x in w)
    truth = mk._cache_forward(w32, k0.float(), v0.float(), *args, **fkw)
    noise = (logits - truth).abs().amax(dim=-1).cpu()
    del w32, truth
    top = logits.topk(2, dim=-1)
    gap = (top.values[:, 0] - top.values[:, 1]).cpu()
    bound_ = STEP0_GAP_NOISES * noise
    plain, kern = top.indices[:, 0].cpu(), toks[0].long().cpu()
    rows = torch.nonzero(active.cpu()).flatten().tolist()
    held = [b for b in rows if gap[b] > bound_[b]]
    differ = [{"row": b, "kernel": int(kern[b]), "plain": int(plain[b]), "top2_gap": float(gap[b]),
               "bound": float(bound_[b]), "within_rounding": bool(gap[b] <= bound_[b])}
              for b in rows if kern[b] != plain[b]]
    return {"noises": STEP0_GAP_NOISES, "bf16_logit_noise": [float(noise[b]) for b in rows], "rows_held": held,
            "differ": differ, "gaps": [float(gap[b]) for b in rows], "ok": all(d["within_rounding"] for d in differ)}


# The fused kernels' product phases among the stamps' phases.
PRODUCT_PHASES = ("qkv", "wo", "gate_up", "down", "head")


def cublas_products(weights, rows: int) -> dict:
    """The library yardstick of the fused kernels' bf16 product phases:
    ``torch.matmul`` (cuBLAS) of [rows, in] × [in, out] at each phase's
    shapes over every layer (QKV as wq, wk and wv; gate/up as two), plus
    the head (``embed.T`` when tied), each phase one CUDA graph of its
    calls replayed between events: ms per forward of each phase, and the
    sum. Inputs are seeded random rows; nothing of the port runs it."""
    embed, head, _, _, _, wq, wk, wv, wo, wg, wu, wd = weights
    L, D = wq.shape[:2]
    dev, dt = wq.device, wq.dtype
    g = torch.Generator(device=dev).manual_seed(0)
    xd, xq, xf = (torch.randn((rows, n), generator=g, device=dev).to(dt) for n in (D, wo.shape[1], wd.shape[1]))
    hw = head if head is not None else embed.t()
    phases = {"qkv": [(xd, w[l]) for l in range(L) for w in (wq, wk, wv)], "wo": [(xq, wo[l]) for l in range(L)],
              "gate_up": [(xd, w[l]) for l in range(L) for w in (wg, wu)], "down": [(xf, wd[l]) for l in range(L)],
              "head": [(xd, hw)]}
    out = {}
    for name, pairs in phases.items():
        ys = [torch.empty((rows, w.shape[1]), device=dev, dtype=dt) for _, w in pairs]

        def run():
            for (a, w), y in zip(pairs, ys):
                torch.matmul(a, w, out=y)

        run()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
        out[name] = cuda_ms(graph.replay, iters=10, warmup=2)
        del graph, ys
    out["total"] = sum(out[n] for n in PRODUCT_PHASES)
    return out


def products_summary(phases: dict, weight_bytes: int, cublas: dict) -> dict:
    """The stamps' product phases of one step beside the cuBLAS yardstick:
    their ms, the weights' rate over them and each phase's ratio."""
    ms = sum(phases[n] for n in PRODUCT_PHASES)
    return {"products_ms": ms, "products_TB_s": weight_bytes / ms / 1e9, "cublas_products_ms": cublas["total"],
            "cublas": cublas, "over_cublas": {n: phases[n] / cublas[n] for n in PRODUCT_PHASES}}


def matrix_bytes(weights) -> int:
    """Bytes of a model's product weights: the layers' matrices and the
    head (the embedding when tied)."""
    head = weights[1] if weights[1] is not None else weights[0]
    return sum(w.numel() * w.element_size() for w in weights[5:]) + head.numel() * head.element_size()


def stamp_phases(weights, k, v, ints, samp, kw, L) -> dict:
    """One fused window with the kernel's timer stamps → ms per step of
    each phase (summed over layers; each phase's slowest block plus its
    grid barrier): qkv, attention, wo, gate/up, down, head (with the
    sampled epilogue, also the logits' store), and the pick with the next
    embedding (with the sampled epilogue, the draw), and the stamped ms per
    step."""
    from dynamo_tpu_torch.engine.attention import megakernel as mk

    steps = kw["num_steps"]
    prof = torch.zeros(mk.window_profile_len(steps, L), dtype=torch.int64, device=k.device)
    mk.fused_decode_window(*weights, k, v, *ints, *samp, **kw, profile=prof)
    t = prof.cpu().numpy().astype(np.float64)
    d = np.diff(t).reshape(steps, 5 * L + 2) / 1e6  # ms between successive stamps
    layer = d[:, :5 * L].reshape(steps, L, 5).sum(axis=1).mean(axis=0)
    names = ("qkv", "attention", "wo", "gate_up", "down")
    return {**{n: float(x) for n, x in zip(names, layer)}, "head": float(d[:, 5 * L].mean()),
            "pick_embed": float(d[:, 5 * L + 1].mean()), "stamped_ms_per_step": float((t[-1] - t[0]) / 1e6 / steps)}


def phase_window_kernel(dev):
    """The fused window at llama-3.2-1b's full width (f32: 8 rows at ragged
    positions 0-1023, one crossing a block boundary inside the window, one
    dead row, 8 steps; bf16: the same rows, 32 steps; f32: the timed shape,
    8 rows at 1024 tokens of context, 8 steps), two small widths at head
    dim 128 and at G = 1 (untied heads), then the timed case: bf16, 8 rows
    at 1024 tokens of context, 32 steps. There the 8 rows attend 1024
    random keys each and the random model's logits lie close together, so
    one rounding apart flips a bf16 argmax: its tokens are printed, not
    held (the f32 case above holds them at this shape)."""
    from dynamo_tpu_torch.engine.config import get_config

    base = get_config(PRESET)
    ragged = [0, 13, 100, 255, 511, 700, 1023]
    small = dict(vocab_size=1024, hidden_size=256, intermediate_size=512, num_layers=2, tie_word_embeddings=False)
    specs = [
        ("llama-3.2-1b ragged", base, torch.float32, ragged, 1, 8),
        ("llama-3.2-1b ragged", base, torch.bfloat16, ragged, 1, 32),
        ("llama-3.2-1b 8 x 1024", base, torch.float32, [1024] * 8, 0, 8),
        ("small HD=128", base.replace(num_heads=8, num_kv_heads=2, head_dim=128, **small), torch.float32,
         [3, 40, 77], 1, 8),
        ("small G=1", base.replace(num_heads=4, num_kv_heads=4, head_dim=64, **small), torch.float32,
         [0, 15, 200], 1, 8),
    ]
    for i, (name, cfg, dtype, positions, dead, steps) in enumerate(specs):
        check_window(window_case(name, dev, dtype, 400 + i, cfg=cfg, positions=positions, dead=dead, steps=steps),
                     time_it=False)
        torch.cuda.empty_cache()
    case = window_case("llama-3.2-1b 8 x 1024", dev, torch.bfloat16, 410, cfg=base, positions=[1024] * 8, dead=0,
                       steps=32)
    res = check_window(case, time_it=True, hold_tokens=False)
    del case
    torch.cuda.empty_cache()
    # llama-3.2-3b's greedy window at the same rows: the yardstick of 3B/1B
    # speculation's ms per confirmed token.
    case = window_case("llama-3.2-3b 8 x 1024", dev, torch.bfloat16, 412, cfg=get_config(TARGET_3B),
                       positions=[1024] * 8, dead=0, steps=32)
    r3 = check_window(case, time_it=True, hold_tokens=False, kv_gate="noise")
    res["3b"] = {k: r3[k] for k in ("case", "kernel_ms", "kernel_ms_per_step", "ref_ms", "bound_ms",
                                    "streamed_bound_ms_per_step", "phases_ms_per_step", "products_per_step",
                                    "step0_gaps", "max_abs_err", "tol", "bf16_noise", "repeats")}
    del case
    torch.cuda.empty_cache()
    return res


def phase_window_sampled(dev):
    """The fused window with the sampled epilogue at llama-3.2-1b's full
    width, rows in ``SAMPLE_MIX``'s turn, final norm times
    ``LOGIT_SPREAD``: f32, 8 rows at ragged positions 0-1023 (one dead), 8
    steps, tokens held; then the timed case, bf16, 8 rows at 1024 tokens
    of context, 32 steps, beside the greedy window on the same inputs, its
    step-0 tokens printed with the window's agreement."""
    from dynamo_tpu_torch.engine.config import get_config

    base = get_config(PRESET)
    case = window_case("llama-3.2-1b ragged", dev, torch.float32, 430, cfg=base,
                       positions=[0, 13, 100, 255, 511, 700, 1023], dead=1, steps=8, spread=LOGIT_SPREAD)
    case["samp"] = sample_rows(8, 8, dev, 430)
    check_window(case, time_it=False)
    del case
    torch.cuda.empty_cache()
    case = window_case("llama-3.2-1b 8 x 1024", dev, torch.bfloat16, 410, cfg=base, positions=[1024] * 8, dead=0,
                       steps=32, spread=LOGIT_SPREAD)
    case["samp"] = sample_rows(8, 32, dev, 431)
    res = check_window(case, time_it=True, hold_tokens=False)
    del case
    torch.cuda.empty_cache()
    return res


def phase_window_guided(dev):
    """The fused window with the guided epilogue at llama-3.2-1b's full
    width: ``GUIDED_ROWS`` (greedy and sampled rows guided by a regex, a
    JSON schema and a choice, an unguided greedy and an unguided sampled
    row) over the port's ``GuidedDecoder`` pools at V = 128256 (1024 rows,
    the scheduler's default), final norm times ``LOGIT_SPREAD``, 8 rows at
    1024 tokens of context, 32 steps: f32 with its tokens held, then the
    timed case in bf16 beside the sampled window on the same inputs. A
    state that allows one character keeps its ~500 byte-tokenizer ids, one
    in every 16 vocab tiles, so whole blocks' tiles are masked for it."""
    from dynamo_tpu_torch.engine.config import get_config

    base = get_config(PRESET)
    res = None
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        case = window_case("llama-3.2-1b 8 x 1024 guided", dev, dtype, 450 + i, cfg=base, positions=[1024] * 8,
                           dead=0, steps=32, spread=LOGIT_SPREAD)
        case["fsms"], case["samp"], case["guide"] = guided_rows(dev, base.vocab_size, 32, 450 + i)
        res = check_window(case, time_it=dtype == torch.bfloat16, hold_tokens=dtype == torch.float32)
        del case
        torch.cuda.empty_cache()
    return res


def epilogue_case(dev, seed, *, B=32, V=128256, draws=64):
    """The epilogue's inputs at the window's widest shape: f32 logits [B, V]
    whose rows take ``SAMPLE_MIX`` in turn and, by groups of 8, a spread of
    0.9 (the random model's flat rows), 2, 4 and 8; each group's top-k rows
    (k = 20, 50) hold six values tied at the k-th largest, and its greedy
    row a tied maximum at a lower index. ``draws`` uniforms per row."""
    rng = np.random.default_rng(seed)
    spreads = np.repeat([0.9, 2.0, 4.0, 8.0], 8)[:B]
    logits = (rng.standard_normal((B, V)) * spreads[:, None]).astype(np.float32)
    for b in range(B):
        t, k, _ = SAMPLE_MIX[b % len(SAMPLE_MIX)]
        order = np.argsort(-logits[b], kind="stable")
        if t > 0 and 1 < k < V:
            logits[b, order[k - 4:k + 2]] = logits[b, order[k - 1]]
        elif t == 0:
            top = order[0]
            logits[b, 0 if top else 1] = logits[b, top]
    temps, top_ks, top_ps, _ = sample_rows(B, 1, dev, seed)
    u = torch.from_numpy(rng.random((draws, B), dtype=np.float32)).to(dev)
    return torch.from_numpy(logits).to(dev), temps, top_ks, top_ps, u


def draw_gaps(logits, temps, top_ks, top_ps, u, got, want) -> list:
    """Each row where the kernel's token differs from the plain version's:
    both tokens, the distance of u from the nearest edge of either token's
    interval of the plain version's CDF, and for a top-p row the distance of
    top_p from the probability mass above either token (where the nucleus
    ends). A difference within rounding has one of them at the level of a
    float32 sum's rounding."""
    from dynamo_tpu_torch.engine.sampling import filtered_probs_rows

    rows = torch.nonzero(got != want).flatten().tolist()
    if not rows:
        return []
    probs = filtered_probs_rows(logits[rows], temps[rows], top_ks[rows], top_ps[rows]).double()
    cum = probs.cumsum(-1)
    scaled = logits[rows].double() / temps[rows].double().clamp_min(1e-30)[:, None]
    full = torch.softmax(scaled, -1)
    out = []
    for j, r in enumerate(rows):
        toks, uu = (int(got[r]), int(want[r])), float(u[r])
        edges = [abs(float(cum[j, t]) - uu) for t in toks] + [abs(float(cum[j, t] - probs[j, t]) - uu) for t in toks]
        p_gap = None
        if float(top_ps[r]) < 1:
            p_gap = min(abs(float(full[j][scaled[j] > scaled[j, t]].sum()) - float(top_ps[r])) for t in toks)
        out.append({"row": r, "kernel": toks[0], "plain": toks[1], "u": uu, "cdf_gap": min(edges),
                    "top_p_gap": p_gap, "params": list(SAMPLE_MIX[r % len(SAMPLE_MIX)])})
    return out


def draw_passes(temps, top_ks, top_ps, toks, V) -> float:
    """Passes over a row's logits the epilogue makes, summed over rows,
    counted from ``sample_row``: a greedy row 1 (its argmax); a sampled row
    3 (max, log-sum-exp, kept mass), 4 for a top-k threshold (k > 1), 4 for
    a top-p threshold, and the scan up to the 2048-wide tile of its token."""
    tiles = -(-V // 2048)
    total = 0.0
    for t, k, p, tok in zip(temps.tolist(), top_ks.tolist(), top_ps.tolist(), toks.tolist()):
        if t <= 0:
            total += 1
            continue
        total += 3 + 4 * (min(k, V) > 1) + 4 * (p < 1) + (tok // 2048 + 1) / tiles
    return total


# A difference between the kernel's draw and the plain version's counts as
# rounding when u (or top_p) lies this close to the plain version's CDF
# edge (or nucleus end): far above the float32 rounding of either side's
# sums of 128,256 probabilities (about 1e-7), far below a kept token's mass.
DRAW_GAP_TOL = 1e-5


def check_epilogue(dev):
    """The sampled epilogue alone (``megakernel.sample_epilogue``, the
    window's device code after its head) against ``sample_from_uniforms``
    on identical logits, 64 draws per row of [32, 128256]; every token that
    differs printed with its distances; then timed."""
    from dynamo_tpu_torch.engine.attention import megakernel as mk
    from dynamo_tpu_torch.engine.sampling import sample_from_uniforms

    logits, temps, top_ks, top_ps, u = epilogue_case(dev, 440)
    B, V = logits.shape
    diffs, passes = [], 0.0
    for j in range(u.shape[0]):
        got = mk.sample_epilogue(logits, temps, top_ks, top_ps, u[j])
        want = sample_from_uniforms(logits, temps, top_ks, top_ps, u[j])
        torch.cuda.synchronize()
        passes += draw_passes(temps, top_ks, top_ps, got, V)
        for d in draw_gaps(logits, temps, top_ks, top_ps, u[j], got, want):
            diffs.append({"draw": j, **d})
    gaps = [min(d["cdf_gap"], d["top_p_gap"] if d["top_p_gap"] is not None else 1.0) for d in diffs]
    ok = all(g <= DRAW_GAP_TOL for g in gaps)
    draws = u.numel()
    res = {"kernel": "sample_epilogue", "case": f"[{B}, {V}] f32, {u.shape[0]} draws per row", "draws": draws,
           "rows": [list(SAMPLE_MIX[b % len(SAMPLE_MIX)]) for b in range(B)], "differ": len(diffs),
           "max_gap": max(gaps) if gaps else None, "gap_tol": DRAW_GAP_TOL, "diffs": diffs,
           "row_passes_per_draw": passes / draws}
    nbytes = logits.numel() * 4 + 4 * B * 4 + B * 4  # logits, 4 row operands, tokens: once each
    res.update(bound(nbytes, 4 * logits.numel(), torch.float32))  # a divide, subtract, exp and add per logit
    res["passes_bound_ms"] = passes / draws * V * 4 * B / PEAK_BYTES_PER_S * 1e3  # the passes, at HBM's rate
    res["kernel_ms"] = cuda_ms(lambda: mk.sample_epilogue(logits, temps, top_ks, top_ps, u[0]))
    res["ref_ms"] = cuda_ms(lambda: sample_from_uniforms(logits, temps, top_ks, top_ps, u[0]), iters=10)
    res["library_ms"] = None  # no single PyTorch call computes this draw
    # Where the time goes: every row of one kind (the slowest row sets a call's time).
    res["ms_by_row_kind"] = {}
    for kind, (t, k, p) in {"greedy": (0.0, 0, 1.0), "temperature": (0.8, 0, 1.0), "top-k 20": (1.0, 20, 1.0),
                            "top-p 0.9": (0.8, 0, 0.9), "top-k 20, top-p 0.9": (1.3, 20, 0.9)}.items():
        rows = (torch.full((B,), t, device=dev), torch.full((B,), k, dtype=torch.int32, device=dev),
                torch.full((B,), p, device=dev))
        res["ms_by_row_kind"][kind] = cuda_ms(lambda: mk.sample_epilogue(logits, *rows, u[0]), iters=10)
    res["masked"] = masked = check_epilogue_masked(logits, temps, top_ks, top_ps, u)
    ok = ok and masked["ok"]
    res["ok"] = ok
    emit("kernel", **res)
    if not ok:
        raise AssertionError(f"the sampled epilogue disagrees with sample_from_uniforms beyond rounding: {diffs}, "
                             f"masked rows: {masked}")
    return res


def check_epilogue_masked(logits, temps, top_ks, top_ps, u) -> dict:
    """The epilogue on rows masked to -inf, as guided rows reach it: row b
    of ``logits`` keeps, by b % 4, the tokens one FSM row of the guided
    grammars allows (``sampling.apply_token_masks`` over the decoder's
    pool: a one-character state keeps its ~500 byte-tokenizer ids, 256
    apart), 1 token, 2 tokens, or 40 tokens within 512 ids (fewer than
    top_k = 50, and whole 2048-wide scan tiles -inf); the greedy rows must
    take the argmax of the allowed logits. Every token allowed, and equal
    to the plain version's except within ``DRAW_GAP_TOL`` of a CDF edge."""
    from dynamo_tpu_torch.engine.attention import megakernel as mk
    from dynamo_tpu_torch.engine.sampling import apply_token_masks, sample_from_uniforms

    B, V = logits.shape
    dev = logits.device
    dec = guided_decoder(dev, V)
    states = [dec.open(spec) for spec in guided_specs()]
    rng = np.random.default_rng(441)
    pool_rows = torch.zeros(B, dtype=torch.int64)
    keep = torch.zeros((B, V), dtype=torch.bool)
    for b in range(B):
        kind = b % 4
        if kind == 0:
            st = states[(b // 4) % len(states)]
            pool_rows[b] = st.pool_base + int(rng.integers(0, st.fsm.num_states))
        else:
            n, span = (1, 2, 40)[kind - 1], min(512, V // 2)
            lo = int(rng.integers(0, V - span))
            keep[b, torch.from_numpy(rng.choice(np.arange(lo, lo + span), size=n, replace=False))] = True
    masked = apply_token_masks(logits, dec.pool.device(), pool_rows.to(dev))
    fsm_rows = (torch.arange(B) % 4 == 0).to(dev)
    masked = torch.where(fsm_rows[:, None] | keep.to(dev), masked, torch.full_like(masked, -float("inf")))
    allowed = torch.isfinite(masked)
    diffs, outside = [], 0
    for j in range(u.shape[0]):
        got = mk.sample_epilogue(masked, temps, top_ks, top_ps, u[j])
        want = sample_from_uniforms(masked, temps, top_ks, top_ps, u[j])
        torch.cuda.synchronize()
        outside += int((~allowed.gather(1, got.long()[:, None])).sum())
        for d in draw_gaps(masked, temps, top_ks, top_ps, u[j], got, want):
            diffs.append({"draw": j, **d})
    gaps = [min(d["cdf_gap"], d["top_p_gap"] if d["top_p_gap"] is not None else 1.0) for d in diffs]
    return {"allowed_per_row": allowed.sum(1).tolist(), "draws": u.numel(), "tokens_outside_mask": outside,
            "differ": len(diffs), "max_gap": max(gaps) if gaps else None, "diffs": diffs,
            "ok": outside == 0 and all(g <= DRAW_GAP_TOL for g in gaps)}


# ---------------------------------------------------------------------------
# The fused spec window against its plain version
# ---------------------------------------------------------------------------

SPEC_ROUNDS, SPEC_GAMMA = 6, 4
TARGET_3B = "llama-3.2-3b"
# Positions of the spec checks' live rows (the last confirmed token; the
# draft's catch-up re-feeds the one before, so each is at least 1).
SPEC_RAGGED = [1, 13, 100, 255, 511, 700, 1023]
# A kernel decision that differs from the plain version's counts as rounding
# when the plain version's own margin is this small: a uniform within
# DRAW_GAP_TOL of a CDF edge or of min(1, p_t/p_d), or a greedy pick whose
# top-2 logits lie within this (f32 logits of the full-width model at
# LOGIT_SPREAD agree to ~1e-4 between the card's and the plain version's
# summation orders).
SPEC_ARGMAX_GAP_TOL = 2e-3
# A bf16 spec window's K/V check: the kernel's first verify rows may lie at
# most this many times as far from the f32 truth (one target forward over
# f32 copies of the same weights and caches) as the plain bf16 version's
# do; a fault must read beyond it. Readings in PERF.md §6.
SPEC_BF16_NOISE_RATIO = 2.0


def spec_case(name, dev, dtype, seed, *, tcfg, dcfg, positions, dead, draft, sampled, spread=LOGIT_SPREAD):
    """One spec window's inputs: seeded random target weights (final norm
    times ``spread``) and a draft that is the target itself (``draft`` =
    "same": self-speculation), the target plus 0.002 × seeded noise
    ("perturbed"; some proposals accepted, some not) or its own seeded
    weights at ``dcfg``'s widths ("own"). The draft's cache is a copy of the
    target's when the widths agree (the draft sees the same history), else
    random K/V of its own; block 0 of each is scratch filled with 1e4.
    Rows at ``positions`` over pages drawn at random that cover the
    window, ``dead`` padding rows, greedy or in ``SAMPLE_MIX``'s turn."""
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.engine.weights import init_params

    R, G = SPEC_ROUNDS, SPEC_GAMMA
    BS = tcfg.block_size
    g = torch.Generator(device="cpu").manual_seed(seed)
    gd = torch.Generator(device=dev).manual_seed(seed)
    B = len(positions) + dead
    need = [(p + R * (G + 1) + 1) // BS + 1 for p in positions]
    W = max(need) + 2
    NB = sum(need) + 1
    ids = (torch.randperm(NB - 1, generator=g) + 1).to(torch.int32)
    tables = torch.zeros((B, W), dtype=torch.int32)
    o = 0
    for b, n in enumerate(need):
        tables[b, :n] = ids[o:o + n]
        o += n
    tp = init_params(tcfg, gd, device=dev, dtype=dtype)
    tp["final_norm"].mul_(spread)
    if draft == "same":
        dp = tp
    elif draft == "perturbed":
        dp = {n: ({k: v + (0.002 * torch.randn(v.shape, generator=gd, device=dev)).to(dtype) for k, v in w.items()}
                  if isinstance(w, dict) else w + (0.002 * torch.randn(w.shape, generator=gd, device=dev)).to(dtype))
              for n, w in tp.items()}
    else:
        dp = init_params(dcfg, gd, device=dev, dtype=dtype)
        dp["final_norm"].mul_(spread)

    def cache(cfg):
        c = [torch.randn((cfg.num_layers, NB, BS, cfg.num_kv_heads, cfg.head_dim), generator=gd,
                         device=dev).to(dtype) for _ in range(2)]
        for x in c:
            x[:, 0] = 1e4
        return c

    caches = cache(tcfg)
    ints = [torch.randint(1, tcfg.vocab_size, (B,), generator=g, dtype=torch.int32),
            torch.randint(1, tcfg.vocab_size, (B,), generator=g, dtype=torch.int32),
            torch.tensor(list(positions) + [1] * dead, dtype=torch.int32), tables, tables,
            torch.tensor([True] * len(positions) + [False] * dead)]
    ints = [t.to(dev) for t in ints]
    if draft != "own":
        # The draft shares the target's history: the slot at pos - 1 holds
        # xprev's K/V (as serving leaves it), so the catch-up rewrites it
        # with the same values, and the draft's cache is a copy.
        from dynamo_tpu_torch.engine.attention import megakernel as mk

        mk._cache_forward(llama._window_weights(tp), *caches, ints[1].long(), ints[2].long() - 1, ints[3].long(),
                          ints[5].bool(), num_heads=tcfg.num_heads, rms_eps=tcfg.rms_norm_eps, theta=tcfg.rope_theta,
                          head=False)
        caches += [c.clone() for c in caches]
    else:
        caches += cache(dcfg)
    samp = sample_rows(B, 1, dev, seed)[:3] if sampled else (
        torch.zeros(B, device=dev), torch.zeros(B, dtype=torch.int32, device=dev), torch.ones(B, device=dev))
    u = torch.from_numpy(np.random.default_rng(seed).random((R, B, 2 * G + 1), dtype=np.float32)).to(dev)
    inputs = ints + [*samp, u]
    kw = dict(rounds=R, gamma=G, block_size=BS, t_num_heads=tcfg.num_heads, t_num_kv_heads=tcfg.num_kv_heads,
              t_head_dim=tcfg.head_dim, t_rms_eps=tcfg.rms_norm_eps, t_theta=tcfg.rope_theta,
              d_num_heads=dcfg.num_heads, d_num_kv_heads=dcfg.num_kv_heads, d_head_dim=dcfg.head_dim,
              d_rms_eps=dcfg.rms_norm_eps, d_theta=dcfg.rope_theta)
    return {"name": name, "tcfg": tcfg, "dcfg": dcfg, "weights": [*llama._window_weights(tp), *llama._window_weights(dp)],
            "caches": caches, "inputs": inputs, "kw": kw, "dtype": dtype, "positions": list(positions),
            "draft": draft, "sampled": sampled, "spread": spread, "tparams": tp}


def spec_written(case, acc):
    """[blocks, BS] masks of the slots the window wrote in the target cache
    and in the draft's, from the kernel's accept counts [R, B]: round r
    writes the target at pos_r .. pos_r + γ and the draft at pos_r - 1 ..
    pos_r + γ - 1; pos advances by k + 1."""
    G, BS = SPEC_GAMMA, case["tcfg"].block_size
    tables = case["inputs"][3].cpu()
    shape = case["caches"][0].shape[1:3]
    t_w, d_w = torch.zeros(shape, dtype=torch.bool), torch.zeros(shape, dtype=torch.bool)
    for b, p in enumerate(case["positions"]):
        for r in range(acc.shape[0]):
            for j in range(G + 1):
                t_w[int(tables[b, (p + j) // BS]), (p + j) % BS] = True
                d_w[int(tables[b, (p + j - 1) // BS]), (p + j - 1) % BS] = True
            p += int(acc[r, b]) + 1
    return t_w, d_w


def spec_work(case, confirmed_per_row):
    """(bytes, streamed bytes, flops) of one spec window. Bytes: every input
    read once and every output written once (both models' weights, a tensor
    the two share counted once, each live row's K/V before the window in
    both caches, the rows the window writes, tables, rows, uniforms, tokens
    out). Streamed: per round the
    draft's weights γ+1 times less its head once (the catch-up skips it),
    the target's once, and the pages each forward reads (the draft's γ+1
    forwards, the target's chunk once). Flops: two per weight and live row
    of each forward (the verify's B·(γ+1) rows), four per attended key, head
    and dim."""
    R, G = SPEC_ROUNDS, SPEC_GAMMA
    tc, dc = case["tcfg"], case["dcfg"]
    esz = case["caches"][0].element_size()
    w_t, w_d = case["weights"][:12], case["weights"][12:]

    def sizes(w):
        head = (w[1] if w[1] is not None else w[0]).numel()
        body = sum(x.numel() for x in w[2:])
        return body + head, head, sum(x.numel() for x in w[2:] if x.dim() == 3) + head

    t_all, _, t_mm = sizes(w_t)
    d_all, d_head, d_mm = sizes(w_d)
    distinct = {x.data_ptr(): x.numel() for x in w_t + w_d if x is not None}  # self-speculation shares them
    rows = len(case["positions"])
    row_t = 2 * tc.num_layers * tc.num_kv_heads * tc.head_dim * esz
    row_d = 2 * dc.num_layers * dc.num_kv_heads * dc.head_dim * esz
    ctx = sum(case["positions"])
    written = rows * R * (G + 1)
    B = len(case["inputs"][0])
    small = case["inputs"][3].numel() * 4 * 2 + B * 4 * 9 + case["inputs"][9].numel() * 4 + R * B * (G + 2) * 4
    nbytes = sum(distinct.values()) * esz + (row_t + row_d) * (ctx + written) + small
    per_round_ctx = ctx + rows * (R * (G + 1)) / 2  # the rows' mean context over the window
    streamed = R * (((G + 1) * d_all - d_head + t_all) * esz + (G + 1) * per_round_ctx * (row_d + row_t)) + small
    keys_t = R * (G + 1) * per_round_ctx
    keys_d = R * (G + 1) * per_round_ctx
    flops = (2 * R * rows * ((G + 1) * d_mm - d_head + (G + 1) * t_mm)
             + 4 * (tc.num_heads * tc.head_dim * tc.num_layers * keys_t + dc.num_heads * dc.head_dim * dc.num_layers * keys_d))
    return nbytes, streamed, flops


def spec_bf16_noise(case, sel, kern, plain) -> dict:
    """How far the target K/V of round 0's first verify rows (``sel``) lie
    from the f32 truth, one target forward of each row's last token over
    f32 copies of the bf16 weights and caches (``megakernel._cache_forward``):
    for the kernel, for the plain bf16 version, and for a faulty bf16
    forward whose target weights carry 0.002 × seeded noise (about a tenth
    of each weight: what a kernel that misreads its weights would give)."""
    from dynamo_tpu_torch.engine.attention import megakernel as mk

    tc, w = case["tcfg"], case["weights"][:12]
    tokens, _, positions, tables, _, active = case["inputs"][:6]
    args = (tokens.long(), positions.long(), tables.long(), active.bool())
    fkw = dict(num_heads=tc.num_heads, rms_eps=tc.rms_norm_eps, theta=tc.rope_theta, head=False)

    def first_rows(weights, dtype):
        k, v = (c.to(dtype=dtype, copy=True) for c in case["caches"][:2])
        mk._cache_forward(tuple(weights), k, v, *args, **fkw)
        return k[:, sel].float(), v[:, sel].float()

    truth = first_rows([x.float() if x is not None else None for x in w], torch.float32)

    def dist(kv):
        return max((a - b).abs().max().item() for a, b in zip(kv, truth))

    g = torch.Generator(device=w[0].device).manual_seed(470)
    faulty = [x + (0.002 * torch.randn(x.shape, generator=g, device=x.device)).to(x.dtype) if x is not None else None
              for x in w]
    return {"kernel_vs_f32": dist((kern[0][:, sel].float(), kern[1][:, sel].float())),
            "plain_vs_f32": dist((plain[0][:, sel].float(), plain[1][:, sel].float())),
            "fault_vs_f32": dist(first_rows(faulty, case["dtype"]))}


def check_spec(case, *, time_it: bool, hold_tokens: bool = True, bonus: bool = False):
    """``fused_spec_window`` against its plain version on the card from
    copies of the same caches. Each live row's rounds are compared until
    the first round that differs; a difference is rounding when the plain
    version's margin at that round is within tolerance (``margins``:
    a draw or accept test within DRAW_GAP_TOL of its edge, a greedy pick's
    top-2 logits within SPEC_ARGMAX_GAP_TOL), each printed. f32: the
    target's confirmed K/V rows (through the last round that agrees) within
    1e-3; bf16: round 0's first verify row (the row's own last token, the
    same input on both sides) no further from the f32 truth than
    ``SPEC_BF16_NOISE_RATIO`` times the plain bf16 version's distance, and
    a faulty forward beyond that (``spec_bf16_noise``), tokens printed, not
    held. In both, every slot outside the window's writes (block 0 aside)
    is left as it was in both caches. With ``bonus``, some live sampled
    row accepted all γ proposals in a round that agrees with the plain
    version (its token drawn from the target's last distribution).
    Timed: ms per window and round, the
    phases per round from the kernel's stamps, tokens confirmed per row,
    ms per confirmed token beside the fused decode window's ms per step at
    the same target and rows, the bound read once and streamed."""
    from dynamo_tpu_torch.engine.attention import megakernel as mk

    w, caches, inputs, kw, dtype = case["weights"], case["caches"], case["inputs"], case["kw"], case["dtype"]
    R, G = SPEC_ROUNDS, SPEC_GAMMA
    kern = [c.clone() for c in caches]
    plain = [c.clone() for c in caches]
    toks, acc = mk.fused_spec_window(*w, *kern, *inputs, **kw)
    margins = {}
    rtoks, racc = mk.fused_spec_window_ref(*w, *plain, *inputs, **kw, margins=margins)
    torch.cuda.synchronize()
    toks, acc, rtoks, racc = (x.cpu() for x in (toks, acc, rtoks, racc))
    m = {k: v.cpu() for k, v in margins.items()}
    live = inputs[5].cpu()
    diffs, agree, n_cmp = [], 0, 0
    upto, bonus_rounds = {}, []
    temps = inputs[6].cpu()
    for b in range(len(case["positions"])):
        r_div = R
        for r in range(R):
            same = int(acc[r, b]) == int(racc[r, b]) and torch.equal(toks[r, b], rtoks[r, b])
            n_cmp += 1
            agree += same
            if not same:
                r_div = r
                edge = {k: float(m[k][r, b]) for k in m}
                within = (min(edge["draw"], edge["accept"]) <= DRAW_GAP_TOL or edge["argmax"] <= SPEC_ARGMAX_GAP_TOL)
                diffs.append({"row": b, "round": r, "kernel": [int(acc[r, b])] + toks[r, b].tolist(),
                              "plain": [int(racc[r, b])] + rtoks[r, b].tolist(), "margins": edge,
                              "within_rounding": within})
                break
        upto[b] = sum(int(acc[r, b]) + 1 for r in range(r_div))
        if temps[b] > 0:
            bonus_rounds += [[b, r] for r in range(r_div) if int(acc[r, b]) == G]
    tokens_ok = all(d["within_rounding"] for d in diffs)
    # Confirmed target K/V (f32) or round 0's first verify row (bf16).
    BS = case["tcfg"].block_size
    tables = inputs[3].cpu()
    sel = torch.zeros(caches[0].shape[1:3], dtype=torch.bool)
    for b, p in enumerate(case["positions"]):
        for j in range(upto[b] if dtype == torch.float32 else 1):
            sel[int(tables[b, (p + j) // BS]), (p + j) % BS] = True
    sel = sel.to(caches[0].device)
    kv_err = max((kern[i][:, sel].float() - plain[i][:, sel].float()).abs().max().item() for i in (0, 1))
    scale = max(plain[i][:, sel].float().abs().max().item() for i in (0, 1))
    noise = None
    if dtype == torch.float32:
        tol, noise_ok = 1e-3, True
    else:
        noise = spec_bf16_noise(case, sel, kern, plain)
        limit = SPEC_BF16_NOISE_RATIO * noise["plain_vs_f32"]
        noise_ok = noise["kernel_vs_f32"] <= limit < noise["fault_vs_f32"]
        tol = (1 + SPEC_BF16_NOISE_RATIO) * noise["plain_vs_f32"]  # what that allows kernel vs plain
    t_w, d_w = spec_written(case, acc)
    untouched = True
    for i, written in ((0, t_w), (1, t_w), (2, d_w), (3, d_w)):
        keep = ~written.to(caches[i].device)
        keep[0] = False
        untouched &= bool(torch.equal(kern[i][:, keep], caches[i][:, keep]))
    ok = kv_err <= tol and noise_ok and untouched and (tokens_ok or not hold_tokens) and (bool(bonus_rounds) or not bonus)
    repeats = spec_repeats(case) if dtype == torch.bfloat16 else None
    ok = ok and (repeats is None or repeats["bit_equal"])
    confirmed = (acc[:, live] + 1).sum(0).float()  # tokens confirmed per live row in the window
    tc, dc = case["tcfg"], case["dcfg"]
    res = {"kernel": "fused_spec_window", "case": case["name"], "dtype": str(dtype).replace("torch.", ""),
           "target": tc.name, "draft": f"{dc.name} ({case['draft']})",
           "rows": "SAMPLE_MIX" if case["sampled"] else "greedy", "logit_spread": case["spread"],
           "shape": {"B": len(live), "live": int(live.sum()), "rounds": R, "gamma": G, "positions": case["positions"],
                     "W": tables.shape[1], "target": [tc.num_layers, tc.hidden_size, tc.num_heads, tc.num_kv_heads,
                                                       tc.head_dim, tc.intermediate_size],
                     "draft": [dc.num_layers, dc.hidden_size, dc.num_heads, dc.num_kv_heads, dc.head_dim,
                               dc.intermediate_size], "V": tc.vocab_size},
           "accepted_per_round": float(confirmed.mean() / R), "accepted_kernel": acc[:, live].tolist(),
           "round_agreement": agree / max(n_cmp, 1), "differ": diffs, "tokens_ok": tokens_ok,
           "max_abs_err": kv_err, "kv_scale": scale, "tol": tol,
           "kv_compared": "confirmed target rows" if dtype == torch.float32 else "round 0's first verify row",
           "other_slots_unchanged": untouched, "ok": ok}
    if noise is not None:
        res["bf16_noise"] = {**noise, "ratio": SPEC_BF16_NOISE_RATIO}
    if repeats is not None:
        res["repeats"] = repeats
    if bonus:
        res["bonus_rounds"] = bonus_rounds
    if time_it:
        nbytes, streamed, flops = spec_work(case, confirmed)
        res.update(bound(nbytes, flops, dtype))
        res["streamed_bytes"] = streamed
        res["streamed_bound_ms"] = bound(streamed, flops, dtype)["bound_ms"]
        res["bound_ms_at_0.79_TB_s"] = streamed / 0.79e12 * 1e3
        res["kernel_ms"] = cuda_ms(lambda: mk.fused_spec_window(*w, *kern, *inputs, **kw), iters=5, warmup=1)
        res["kernel_ms_per_round"] = res["kernel_ms"] / R
        res["ref_ms"] = cuda_ms(lambda: mk.fused_spec_window_ref(*w, *plain, *inputs, **kw), iters=2, warmup=1)
        res["library_ms"] = None  # no PyTorch call computes a speculative round
        res["confirmed_tokens_per_row"] = float(confirmed.mean())
        res["ms_per_confirmed_token"] = res["kernel_ms"] / float(confirmed.mean())
        prof = torch.zeros(mk.spec_profile_len(R, G), dtype=torch.int64, device=caches[0].device)
        mk.fused_spec_window(*w, *kern, *inputs, **kw, profile=prof)
        d = np.diff(prof.cpu().numpy().astype(np.float64)).reshape(R, G + 3).mean(axis=0) / 1e6
        res["phases_ms_per_round"] = {"catchup": float(d[0]), "proposals": [float(x) for x in d[1:1 + G]],
                                      "verify": float(d[1 + G]), "rejection": float(d[2 + G])}
        # The fused decode window at the same target and rows: one target
        # one-token forward per step, the verify's yardstick.
        wkw = dict(num_steps=32, num_heads=tc.num_heads, num_kv_heads=tc.num_kv_heads, head_dim=tc.head_dim,
                   block_size=BS, rms_eps=tc.rms_norm_eps, theta=tc.rope_theta)
        win = (inputs[0], inputs[2], inputs[3], inputs[5])
        res["window_ms_per_step"] = cuda_ms(lambda: mk.fused_decode_window(*w[:12], kern[0], kern[1], *win, **wkw),
                                            iters=3, warmup=1) / 32
        res["verify_over_window_step"] = res["phases_ms_per_round"]["verify"] / res["window_ms_per_step"]
        # The verify's products beside one cuBLAS forward of its B (γ + 1)
        # rows through the target (the verify also writes the chunk's K/V
        # and attends: its stamp covers more than the products).
        cub = cublas_products(w[:12], len(live) * (G + 1))
        res["verify_products"] = {"rows": len(live) * (G + 1), "verify_ms": res["phases_ms_per_round"]["verify"],
                                  "cublas_products_ms": cub["total"], "cublas": cub,
                                  "target_weight_bytes": matrix_bytes(w[:12])}
    emit("kernel", **res)
    if not ok:
        raise AssertionError(f"fused_spec_window disagrees with its plain version: {res}")
    return res


def spec_repeats(case) -> dict:
    """Two calls of the spec window from copies of the same caches, its
    scaled logits scratch kept (``scratch=``): tokens, accept counts, all
    four caches (block 0, the dead rows' sink, aside) and both models'
    logits must be bit-equal."""
    from dynamo_tpu_torch.engine.attention import megakernel as mk

    runs = []
    for _ in range(2):
        caches, scratch = [c.clone() for c in case["caches"]], {}
        toks, acc = mk.fused_spec_window(*case["weights"], *caches, *case["inputs"], **case["kw"], scratch=scratch)
        runs.append([toks, acc, *(c[:, 1:] for c in caches), *scratch.values()])
    torch.cuda.synchronize()
    return {"compared": ["tokens", "accepted", "k_t", "v_t", "k_d", "v_d", "draft_logits", "target_logits"],
            "bit_equal": all(torch.equal(a, b) for a, b in zip(*runs))}


def phase_spec_kernel(dev):
    """The fused spec window, R = 6 rounds of γ = 4: f32 at full widths,
    llama-3.2-1b over a perturbed copy of itself, over itself (every
    proposal accepted: sampled rows draw the bonus) and llama-3.2-3b over a
    llama-3.2-1b draft, 8 rows at ragged positions (one dead) in
    ``SAMPLE_MIX``'s turn at ``LOGIT_SPREAD``; then timed in bf16, 8 greedy
    rows at 1024 tokens of context: llama-3.2-1b speculating with its own
    weights, and llama-3.2-3b over a llama-3.2-1b draft."""
    from dynamo_tpu_torch.engine.config import get_config

    one, three = get_config(PRESET), get_config(TARGET_3B)
    specs = [("1b/1b perturbed", one, one, "perturbed"), ("3b/1b", three, one, "own"),
             ("1b/1b self", one, one, "same")]
    for i, (name, tcfg, dcfg, draft) in enumerate(specs):
        res = check_spec(spec_case(name, dev, torch.float32, 450 + i, tcfg=tcfg, dcfg=dcfg, positions=SPEC_RAGGED,
                                   dead=1, draft=draft, sampled=True), time_it=False, bonus=draft == "same")
        if i == 0:
            f32 = res
        torch.cuda.empty_cache()
    timed = {}
    for i, (name, tcfg, draft) in enumerate((("1b/1b self", one, "same"), ("3b/1b", three, "own"))):
        case = spec_case(name, dev, torch.bfloat16, 460 + i, tcfg=tcfg, dcfg=one, positions=[1024] * 8, dead=0,
                         draft=draft, sampled=False, spread=1.0)
        timed[name] = check_spec(case, time_it=True, hold_tokens=False)
        del case
        torch.cuda.empty_cache()
    res = dict(timed["1b/1b self"])
    res["max_abs_err"] = f32["max_abs_err"]  # the f32 check's; bf16's is against its own scale
    res["f32_check"] = {k: f32[k] for k in ("case", "max_abs_err", "tol", "differ", "accepted_per_round")}
    res["3b_1b"] = {k: timed["3b/1b"][k] for k in (
        "kernel_ms", "kernel_ms_per_round", "ref_ms", "bound_ms", "streamed_bound_ms", "confirmed_tokens_per_row",
        "ms_per_confirmed_token", "window_ms_per_step", "phases_ms_per_round", "verify_over_window_step",
        "verify_products", "repeats")}
    return res


def ragged_paths(dev, timed: dict, mixed_spec: dict, int8_spec: dict, *, prefill_len: int, decode_ctx: list) -> None:
    """The bf16 ragged kernel's two paths alone, timed: a fresh-only
    prefill of ``prefill_len`` tokens (every query a chunk query;
    yardsticks SDPA causal and the flash kernel's card time at that shape)
    and a decode step at ``decode_ctx`` (every query split; SDPA over
    gathered pages). Then the grid's fixed cost (the mixed step with every
    query dead: each block only reads meta, classifies and exits), the
    mixed step's partition into the two paths, and three calls each on the
    mixed step's bf16 and int8 inputs, which must be bit-equal (the split
    counters reset themselves, the merge order is fixed)."""
    from dynamo_tpu_torch.engine.attention import megakernel as mk
    from dynamo_tpu_torch.engine.attention import prefill as fck

    H, KVH, HD = mixed_spec["H"], mixed_spec["KVH"], mixed_spec["HD"]
    pre = attention_case(f"prefill T={prefill_len}, no prefix", dtype=torch.bfloat16, dev=dev, seed=110, H=H, KVH=KVH,
                         HD=HD, chunk=prefill_len, chunk_prefix=0, decode_ctx=[])
    pre["causal"] = True
    res = check_attention(pre, time_it=True)
    q, k, v = pre["args"][:3]
    res["flash_device_ms"] = graph_ms(lambda: fck.flash_chunk_attention(q, k, v, prefill_len, num_kv_heads=KVH))
    timed["ragged_paged_attention prefill"] = res
    dec = attention_case(f"decode {len(decode_ctx)} rows at {decode_ctx[0]}", dtype=torch.bfloat16, dev=dev, seed=111,
                         H=H, KVH=KVH, HD=HD, chunk=0, chunk_prefix=0, decode_ctx=decode_ctx)
    timed["ragged_paged_attention decode"] = check_attention(dec, time_it=True)
    del pre, dec
    mixed = attention_case("mixed, every query dead", dtype=torch.bfloat16, dev=dev, seed=100, **mixed_spec)
    args = list(mixed["args"])
    meta = args[6]
    kw = dict(num_kv_heads=KVH, block_size=mixed["BS"])
    dead = args[:6] + [meta.clone()]
    dead[6][4] = 0
    empty_ms = graph_ms(lambda: mk.ragged_paged_attention(*dead, **kw))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = mk.launch_plan(meta.shape[1], H, KVH, args[5].shape[0], args[5].shape[1], mixed["BS"], sms)
    chunk_q = mk.chunk_queries(meta, width=args[5].shape[1], block_size=mixed["BS"],
                               queries_per_tile=plan["queries_per_tile"])
    int8_mixed = int8_attention_case("mixed, int8 KV", dtype=torch.bfloat16, dev=dev, seed=150, **int8_spec)
    repeat = {}
    for label, c in (("bf16", mixed), ("int8", int8_mixed)):
        runs = [mk.ragged_paged_attention(*c["args"], **kw) for _ in range(3)]
        repeat[label] = all(torch.equal(runs[0], r) for r in runs[1:])
    emit("kernel", kernel="ragged_paged_attention", case="repeat calls, empty grid, paths", bit_equal=repeat,
         empty_grid_device_ms=empty_ms, plan=plan, chunk_queries=int(chunk_q.sum()),
         split_queries=int(((meta[4] != 0).cpu() & ~chunk_q).sum()))
    timed["ragged_paged_attention"]["empty_grid_device_ms"] = empty_ms
    if not all(repeat.values()):
        raise AssertionError(f"ragged_paged_attention differs between calls on the same inputs: {repeat}")


# chunk_decode's batches (waves and spec verifies) at llama-3.2-1b's heads:
# (cached prefix, valid queries) a row. The wave: 8 prompts of 32-200 tokens
# in S = 256 rows, two of them over a 1024-token prefix; the verify: 8 rows
# of γ + 1 = 5 queries over about 1024 cached tokens.
WAVE_ROWS = [(1024, 200), (1024, 37), (0, 32), (0, 64), (0, 120), (0, 150), (0, 180), (0, 96)]
WAVE_S = 256
VERIFY_ROWS = [(1024 + 3 * i, 5) for i in range(8)]
VERIFY_S = 5


def chunk_rows_case(name, *, rows, S, dtype, dev, seed, H=32, KVH=8, HD=64, stride=0, int8=False):
    """``llama.chunk_decode``'s ragged batch: row b's S query slots at
    b·stride (stride S by default; a larger stride pads each row to a
    tile of the chunk path, the slots past S dead), its first ``valid``
    live, each over the row's ``prefix`` paged tokens and its own chunk
    causally (fresh keys [b·stride, b·stride + s + 1)). Pages as in
    ``attention_case`` (scratch page 0 large); with ``int8`` the pages are
    quantized as the cache holds them."""
    from dynamo_tpu_torch.engine.attention import megakernel as mk
    from dynamo_tpu_torch.engine.kv_cache import QuantKv, quantize_kv_rows

    BS = 16
    stride = stride or S
    g = torch.Generator(device="cpu").manual_seed(seed)
    B = len(rows)
    pages_per_row = [(p + BS - 1) // BS for p, _ in rows]
    W = max(max(pages_per_row), 1)
    total = sum(pages_per_row)
    perm = (torch.randperm(total, generator=g) + 1).to(torch.int32)
    tables = torch.zeros((B, W), dtype=torch.int32)
    o = 0
    for r, n in enumerate(pages_per_row):
        tables[r, :n] = perm[o:o + n]
        o += n
    NQ = B * stride
    k_pages = torch.randn((total + 1, BS, KVH, HD), generator=g)
    v_pages = torch.randn((total + 1, BS, KVH, HD), generator=g)
    k_pages[0] = 1e4
    v_pages[0] = 1e4
    q = torch.randn((NQ, H, HD), generator=g)
    k_extra = torch.randn((NQ, KVH, HD), generator=g)
    v_extra = torch.randn((NQ, KVH, HD), generator=g)
    b = torch.arange(B, dtype=torch.int32)[:, None].expand(B, stride)
    s = torch.arange(stride, dtype=torch.int32)[None, :].expand(B, stride)
    prefix = torch.tensor([p for p, _ in rows], dtype=torch.int32)[:, None].expand(B, stride)
    valid = torch.tensor([v for _, v in rows], dtype=torch.int32)[:, None]
    meta = mk.build_meta(b, prefix, b * stride, b * stride + s + 1, (s < valid) & (s < S)).reshape(5, NQ)
    if int8:
        k_pages, v_pages = (QuantKv(*(t.to(dev) for t in quantize_kv_rows(p))) for p in (k_pages, v_pages))
    to = lambda t: t.to(device=dev, dtype=dtype if t.is_floating_point() else t.dtype).contiguous()  # noqa: E731
    pools = (k_pages, v_pages) if int8 else (to(k_pages), to(v_pages))
    args = (to(q), to(k_extra), to(v_extra), *pools, to(tables), to(meta))
    return {"name": name, "args": args, "KVH": KVH, "BS": BS, "dtype": dtype, "dead": 1, "rows": rows, "S": S,
            "stride": stride}


def chunk_row_paths(dev, timed: dict) -> None:
    """The ragged kernel at ``chunk_decode``'s shapes, each against its
    plain version and timed (events, the card's own time, bound, SDPA over
    the rows' gathered pages): the wave (beside a batched causal SDPA over
    the chunks alone) and the verify, bf16 and over int8 pages, in the
    layout ``chunk_decode`` gives them (each row padded to whole chunk
    tiles of ``queries_per_tile`` queries: the verify's 5-query rows to
    32), and the verify packed (rows back to back, tiles straddling rows:
    the layout it replaced), with how many queries each sends down each
    path."""
    from dynamo_tpu_torch.engine.attention import megakernel as mk

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bq = mk.queries_per_tile(32, 8)
    cases = [("wave", WAVE_ROWS, WAVE_S, 0), ("verify", VERIFY_ROWS, VERIFY_S, bq),
             ("verify packed", VERIFY_ROWS, VERIFY_S, VERIFY_S)]
    for label, rows, S, stride in cases:
        for int8 in (False, True):
            if int8 and label == "verify packed":
                continue
            name = f"{label}: {len(rows)} rows x {S}" + (f" in {stride}-query tiles" if stride > S else "")
            case = chunk_rows_case(name, rows=rows, S=S, dtype=torch.bfloat16, dev=dev, seed=120 + len(label),
                                   stride=stride, int8=int8)
            res = check_attention(case, time_it=True)
            meta, tables = case["args"][6], case["args"][5]
            plan = mk.launch_plan(meta.shape[1], 32, 8, tables.shape[0], tables.shape[1], case["BS"], sms)
            chunk_q = mk.chunk_queries(meta, width=tables.shape[1], block_size=case["BS"],
                                       queries_per_tile=plan["queries_per_tile"])
            res["chunk_queries"] = int(chunk_q.sum())
            res["split_queries"] = int(((meta[4] != 0).cpu() & ~chunk_q).sum())
            if label == "wave" and not int8:
                q, k, v = (case["args"][i].reshape(len(rows), S, -1, 64) for i in range(3))
                G = q.shape[2] // k.shape[2]
                qd, kd, vd = (x.repeat_interleave(G if x is not q else 1, dim=2).transpose(1, 2).contiguous()
                              for x in (q, k, v))
                causal = lambda: torch.nn.functional.scaled_dot_product_attention(qd, kd, vd, is_causal=True)  # noqa: E731
                res["sdpa_causal_chunks_ms"] = cuda_ms(causal)
                res["sdpa_causal_chunks_device_ms"] = graph_ms(causal)
            kernel = "ragged_paged_attention" + ("_int8" if int8 else "")
            timed[f"{kernel} {label}"] = res
            emit("kernel", kernel=kernel, case=name, chunk_queries=res["chunk_queries"],
                 split_queries=res["split_queries"], device_ms=res.get("device_ms"))
            del case
    torch.cuda.empty_cache()


def phase_kernel(dev):
    """Every kernel at the shapes the serving paths give it, and at the
    ragged edges, in bf16 and f32; the probe. Returns, per kernel, the
    timed case."""
    ctx_1b = [int(c) for c in np.linspace(1, 4096, 32).round()]
    specs = [
        # A mixed step of llama-3.2-1b: a 512-query chunk over a 1000-token
        # prefix plus 32 decode rows with contexts from 1 to 4096.
        ("llama-3.2-1b mixed", dict(H=32, KVH=8, HD=64, chunk=512, chunk_prefix=1000, decode_ctx=ctx_1b)),
        ("llama-3-8b heads (HD=128)", dict(H=32, KVH=8, HD=128, chunk=128, chunk_prefix=300,
                                           decode_ctx=[int(c) for c in np.linspace(1, 2048, 16).round()])),
        ("mqa", dict(H=8, KVH=1, HD=64, chunk=64, chunk_prefix=100, decode_ctx=[1, 17, 33, 500])),
        # Prefix ending exactly on a page boundary, decode contexts at and
        # around page edges, padded chunk queries, and a wide table whose
        # tail slots hold scratch page 0.
        ("ragged edges", dict(H=32, KVH=8, HD=64, chunk=48, chunk_prefix=64, decode_ctx=[1, 16, 17, 32, 33],
                              dead=8, tail_width=10)),
    ]
    timed = {}
    for i, (name, spec) in enumerate(specs):
        for dtype in (torch.bfloat16, torch.float32):
            case = attention_case(name, dtype=dtype, dev=dev, seed=100 + i, **spec)
            res = check_attention(case, time_it=(i == 0 and dtype == torch.bfloat16))
            if "kernel_ms" in res:
                timed["ragged_paged_attention"] = res
            del case
    ragged_paths(dev, timed, specs[0][1], dict(H=32, KVH=8, HD=64, chunk=512, chunk_prefix=1000,
                                               decode_ctx=ctx_1b, dead=4), prefill_len=2048, decode_ctx=[1024] * 8)
    torch.cuda.empty_cache()
    chunk_row_paths(dev, timed)

    # The int8 branch over int8 pages: the same mixed step at llama-3.2-1b's
    # widths and at llama-3-8b's (HD = 128), each with 4 dead chunk queries
    # and zero-amax tokens, in bf16 and f32; both bf16 cases timed.
    int8_specs = [("llama-3.2-1b mixed, int8 KV", dict(H=32, KVH=8, HD=64)),
                  ("llama-3-8b widths mixed, int8 KV", dict(H=32, KVH=8, HD=128))]
    for i, (name, heads) in enumerate(int8_specs):
        for dtype in (torch.bfloat16, torch.float32):
            case = int8_attention_case(name, dtype=dtype, dev=dev, seed=150 + i, chunk=512, chunk_prefix=1000,
                                       decode_ctx=ctx_1b, dead=4, **heads)
            res = check_attention(case, time_it=dtype == torch.bfloat16)
            if "kernel_ms" in res:
                timed["ragged_paged_attention_int8" + ("" if i == 0 else " 8b")] = res
            del case
    torch.cuda.empty_cache()

    # flash_chunk_attention: the prefill buckets the serving path runs
    # (512 in mixed steps, 2048 for long prompts), a padded chunk, a chunk
    # length that is no power of two, HD=128 and MQA heads.
    flash_specs = [
        ("llama-3.2-1b T=2048", dict(T=2048, valid=2048, H=32, KVH=8, HD=64)),
        ("llama-3.2-1b T=512", dict(T=512, valid=512, H=32, KVH=8, HD=64)),
        ("llama-3.2-1b T=2048 valid 1500", dict(T=2048, valid=1500, H=32, KVH=8, HD=64)),
        ("llama-3.2-1b T=300 valid 271", dict(T=300, valid=271, H=32, KVH=8, HD=64)),
        ("llama-3-8b heads (HD=128)", dict(T=512, valid=400, H=32, KVH=8, HD=128)),
        ("mqa", dict(T=256, valid=200, H=8, KVH=1, HD=64)),
        # The tensor-core tiles' edges: a query past a 128-row tile, one
        # valid key, 64 heads per KV head, the narrowest head dim.
        ("T=129", dict(T=129, valid=129, H=32, KVH=8, HD=64)),
        ("valid_len 1", dict(T=70, valid=1, H=32, KVH=8, HD=64)),
        ("G=64", dict(T=100, valid=90, H=64, KVH=1, HD=64)),
        ("HD=16", dict(T=77, valid=77, H=8, KVH=2, HD=16)),
        ("llama-3-8b widths T=2048 (HD=128)", dict(T=2048, valid=2048, H=32, KVH=8, HD=128)),
    ]
    flash_timed = {0: "flash_chunk_attention", 1: "flash_chunk_attention T=512",
                   len(flash_specs) - 1: "flash_chunk_attention 8b"}
    for i, (name, spec) in enumerate(flash_specs):
        for dtype in (torch.bfloat16, torch.float32):
            time_it = dtype == torch.bfloat16 and i in flash_timed
            res = check_flash(name, flash_case(dev, dtype, 200 + i, **spec), time_it=time_it)
            if time_it:
                timed[flash_timed[i]] = res
    torch.cuda.empty_cache()

    # paged_decode_partials: 8 decode rows with contexts 1..4096 (one row
    # empty), as in the breakdown's and the serving path's decode steps.
    ctx_8 = [0] + [int(c) for c in np.linspace(1, 4096, 7).round()]
    paged_specs = [
        ("llama-3.2-1b 8 rows", dict(lengths=ctx_8, H=32, KVH=8, HD=64, extra_width=4)),
        ("llama-3-8b heads (HD=128)", dict(lengths=[5, 64, 300, 1000], H=32, KVH=8, HD=128)),
        ("mqa", dict(lengths=[200, 0, 2, 17], H=8, KVH=1, HD=64, extra_width=6)),
        # Split-KV edges (256 keys a split): lengths at a split's edge, past
        # the table (clamped to W*BS), and a batch of empty rows only.
        ("split edges", dict(lengths=[255, 256, 257, 511, 512, 513], H=32, KVH=8, HD=64, extra_width=1)),
        ("past the table", dict(lengths=[300, 290], H=32, KVH=8, HD=64, over=40)),
        ("empty rows only", dict(lengths=[0, 0, 0], H=32, KVH=8, HD=64, extra_width=2)),
        ("llama-3-8b widths 8 rows (HD=128)", dict(lengths=ctx_8, H=32, KVH=8, HD=128, extra_width=4)),
    ]
    paged_timed = {0: "paged_decode_partials", len(paged_specs) - 1: "paged_decode_partials 8b"}
    for i, (name, spec) in enumerate(paged_specs):
        for dtype in (torch.bfloat16, torch.float32):
            time_it = dtype == torch.bfloat16 and i in paged_timed
            res = check_paged(name, paged_case(dev, dtype, 300 + i, **spec), time_it=time_it)
            if time_it:
                timed[paged_timed[i]] = res
    # Each call twice more on the first case's inputs: bit-equal (the split
    # counters reset themselves, the merge order is fixed).
    from dynamo_tpu_torch.engine.attention import decode as pdk

    args, KVH, BS = paged_case(dev, torch.bfloat16, 300, **paged_specs[0][1])
    runs = [pdk.paged_decode_partials(*args, num_kv_heads=KVH, block_size=BS) for _ in range(3)]
    repeat_equal = all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run))
    emit("kernel", kernel="paged_decode_partials", case="repeat calls", bit_equal=repeat_equal)
    if not repeat_equal:
        raise AssertionError("paged_decode_partials differs between calls on the same inputs")
    # The attention kernels beside their last accepted readings on this card
    # (PERF.md: the ragged kernel's first design 3.432 ms, its int8 branch
    # 2.687 and 4.715 at the 8B widths; the per-piece kernels' 0.1319,
    # 0.0778 and 0.0701 ms).
    emit("kernel", kernel="attention kernels vs PERF.md", ratios={
        "ragged_paged_attention": timed["ragged_paged_attention"]["kernel_ms"] / 3.432,
        "ragged_paged_attention_int8": timed["ragged_paged_attention_int8"]["kernel_ms"] / 2.687,
        "ragged_paged_attention_int8 8b": timed["ragged_paged_attention_int8 8b"]["kernel_ms"] / 4.715,
        "flash_chunk_attention T=2048": timed["flash_chunk_attention"]["kernel_ms"] / 0.1319,
        "flash_chunk_attention T=512": timed["flash_chunk_attention T=512"]["kernel_ms"] / 0.0778,
        "paged_decode_partials": timed["paged_decode_partials"]["kernel_ms"] / 0.0701},
        vs_sdpa={name: timed[name]["kernel_ms"] / timed[name]["library_ms"]
                 for name in ("ragged_paged_attention", "ragged_paged_attention prefill",
                              "ragged_paged_attention decode", "ragged_paged_attention_int8",
                              "ragged_paged_attention_int8 8b", "flash_chunk_attention",
                              "flash_chunk_attention T=512", "flash_chunk_attention 8b",
                              "paged_decode_partials", "paged_decode_partials 8b")},
        device_vs_sdpa_device={name: timed[name]["device_ms"] / timed[name]["library_device_ms"]
                               for name in ("ragged_paged_attention", "ragged_paged_attention prefill",
                                            "ragged_paged_attention decode", "ragged_paged_attention_int8")},
        ragged_prefill_device_vs_flash_device=timed["ragged_paged_attention prefill"]["device_ms"]
        / timed["ragged_paged_attention prefill"]["flash_device_ms"])
    torch.cuda.empty_cache()

    timed["nop"] = check_nop(dev)
    timed["fused_decode_window"] = phase_window_kernel(dev)
    timed["sample_epilogue"] = check_epilogue(dev)
    timed["fused_decode_window_sampled"] = phase_window_sampled(dev)
    timed["fused_decode_window_guided"] = phase_window_guided(dev)
    timed["fused_spec_window"] = phase_spec_kernel(dev)
    # The fused windows beside the last accepted readings on this card
    # (PERF.md: the greedy and sampled windows' ms per step, the spec
    # window's ms): printed, for the record of the shared device code.
    emit("kernel", kernel="windows vs PERF.md", ratios={
        "fused_decode_window": timed["fused_decode_window"]["kernel_ms_per_step"] / 4.007,
        "fused_decode_window_sampled": timed["fused_decode_window_sampled"]["kernel_ms_per_step"] / 4.478,
        "fused_decode_window_guided_vs_sampled": timed["fused_decode_window_guided"]["kernel_ms_per_step"]
        / timed["fused_decode_window_guided"]["sampled_kernel_ms_per_step"],
        "fused_spec_window": timed["fused_spec_window"]["kernel_ms"] / 252.55})
    return timed


# ---------------------------------------------------------------------------
# Phase 4: the full-width model, kernel path against plain path
# ---------------------------------------------------------------------------


def phase_model(dev):
    """llama-3.2-1b at full width in f32, teacher-forced on the card (kernels)
    and on the CPU (plain versions), on each attention path. Megakernel: a
    300-token prefill, 16 decode steps (batch 2, one padded lane) and a
    mixed step. Per-piece (paged + flash): the same, plus a continuation
    chunk over the 300 cached tokens before the decodes."""
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.engine.weights import init_params

    base = get_config(PRESET)
    passes = [("megakernel", base, 0), ("paged+flash", base.replace(**PER_PIECE), 18)]
    gen = torch.Generator(device=dev).manual_seed(0)
    params_dev = init_params(base, gen, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(7)
    seq_a = rng.integers(1, base.vocab_size, size=340).astype(np.int32)
    seq_b = rng.integers(1, base.vocab_size, size=80).astype(np.int32)
    nb = 48
    table_a = np.zeros(24, np.int32)
    table_a[:22] = np.arange(1, 23)
    table_b = np.zeros(16, np.int32)
    table_b[:6] = np.arange(23, 29)

    def run(params, device, cfg, cont):
        """Logits of every step; ``cont`` continuation tokens after the
        300-token prefill (0: none)."""
        flash = dict(use_flash=True) if cfg.prefill_impl == "flash" else {}
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        cache = KvCacheArrays.create(cfg, nb, dtype=torch.float32, device=device)
        k, v = cache.k, cache.v
        logits = []
        toks = np.zeros(512, np.int32)
        toks[:300] = seq_a[:300]
        lg, k, v = llama.prefill(params, cfg, k, v, t(toks), 300, 0, t(table_a), has_prefix=False, **flash)
        logits.append(lg[None])
        if cont:
            toks = np.zeros(32, np.int32)
            toks[:cont] = seq_a[300:300 + cont]
            lg, k, v = llama.prefill(params, cfg, k, v, t(toks), cont, 300, t(table_a), has_prefix=True, **flash)
            logits.append(lg[None])
        d_tables = np.stack([table_a, np.zeros_like(table_a)])
        p0 = 300 + cont
        for i in range(16):
            pos = p0 + i
            lg, k, v = llama.decode(
                params, cfg, k, v, t(np.array([seq_a[pos], 0], np.int32)), t(np.array([pos, 0], np.int32)),
                t(d_tables), t(np.array([True, False])),
            )
            logits.append(lg[:1])
        p_tok = np.zeros(128, np.int32)
        p_tok[:80] = seq_b
        lg, k, v = llama.mixed_step(
            params, cfg, k, v, t(p_tok), 80, 0, t(table_b),
            t(seq_a[p0 + 16:p0 + 17]), t(np.array([p0 + 16], np.int32)), t(table_a[None]), t(np.array([True])),
            has_prefix=False, **flash,
        )
        logits.append(lg)
        return [x.float().cpu() for x in logits]

    L = base.num_layers
    card = {}
    for label, cfg, cont in passes:
        reset_counts()
        t0 = time.perf_counter()
        card[label] = run(params_dev, dev, cfg, cont)
        torch.cuda.synchronize()
        card[label + " s"] = time.perf_counter() - t0
        card[label + " counts"] = read_counts()
    params_cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
                  for k, v in params_dev.items()}
    del params_dev
    torch.cuda.empty_cache()
    failed = []
    for label, cfg, cont in passes:
        reset_counts()
        t0 = time.perf_counter()
        plain = run(params_cpu, "cpu", cfg, cont)
        plain_s = time.perf_counter() - t0
        plain_counts = read_counts()
        kern, counts = card[label], card[label + " counts"]
        errs = [(a - b).abs().max().item() for a, b in zip(kern, plain)]
        scale = max(b.abs().max().item() for b in plain)
        # f32 on both sides; the card's and the CPU's matmuls sum in different
        # orders through 16 layers, so allow 1e-3 of the logits' scale.
        tol = 1e-3 * max(1.0, scale)
        ok = max(errs) <= tol and all(bool(torch.isfinite(x).all()) for x in kern)
        prefills, decodes, mixed = 1 + (cont > 0), 16, 1
        if label == "megakernel":
            expected = {"ragged_paged_attention": L * (prefills + decodes + mixed)}
        else:
            expected = {"flash_chunk_attention": L * (prefills + mixed),
                        "paged_decode_partials": L * (decodes + mixed)}
        launches = {name: c["launches"] for name, c in counts.items()}
        want = {name: expected.get(name, 0) for name in launches}
        card_plain = sum(c["plain_calls"] for c in counts.values())
        res = {"preset": PRESET, "path": label, "dtype": "float32", "steps": prefills + decodes + mixed,
               "max_abs_err": max(errs), "per_step_err": errs, "logit_scale": scale, "tol": tol,
               "kernel_launches": launches, "expected_launches": want, "plain_calls_on_card": card_plain,
               "plain_calls_on_cpu": {name: c["plain_calls"] for name, c in plain_counts.items()},
               "card_s": card[label + " s"], "cpu_s": plain_s, "ok": ok}
        emit("model", **res)
        if not ok or launches != want or card_plain:
            failed.append(res)
    if failed:
        raise AssertionError(f"model phase failed: {failed}")
    del params_cpu
    torch.cuda.empty_cache()
    phase_model_window(dev)
    phase_model_int8(dev)
    phase_model_chunk(dev)
    phase_model_spec_rounds(dev)
    phase_model_graphs(dev)
    phase_model_extras(dev)


EXTRAS_ROWS = 8
EXTRAS_LP_TOL = 1e-5  # f32 log-softmax over 128,256 logits, card against CPU


def extras_inputs(dev, V: int, seed: int) -> tuple:
    """An extras draw's inputs at ``EXTRAS_ROWS`` rows of the full vocabulary:
    logits (a few rows with tied values at the top, as the processors and
    penalties leave them), a generated-token history of 64 per row with
    repeats, and per-row frequency/presence penalties (row 0 none)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = EXTRAS_ROWS
    logits = torch.randn((B, V), generator=g, device=dev) * 2
    logits[1, :30] = logits[1].max() + 1  # ties across the 20 alternatives
    logits[2, 5::1000] = 3.5
    hist = torch.randint(0, V, (B, 64), generator=g, device=dev, dtype=torch.int32)
    hist[:, 32:] = hist[:, :32]
    hist_len = torch.arange(B, device=dev, dtype=torch.int32) * 9
    freq = torch.linspace(0.0, 2.0, B, device=dev)
    pres = torch.linspace(0.0, -1.0, B, device=dev)
    return logits, hist, hist_len, freq, pres


def phase_model_extras(dev):
    """The per-request extras' device ops (``sampling.apply_penalties``,
    ``sampling.compute_topk_logprobs`` and ``LogitBiasProcessor``) on the
    card against the same functions on the CPU at [8, 128256]: equal
    penalised and biased logits, equal top ids (ties broken toward the
    lower id), logprobs within ``EXTRAS_LP_TOL``."""
    from dynamo_tpu_torch.engine import sampling
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.logits_processing import LogitBiasProcessor

    V = get_config(PRESET).vocab_size
    args = extras_inputs(dev, V, 21)
    cpu = [a.cpu() for a in args]
    pen_card, pen_cpu = sampling.apply_penalties(*args), sampling.apply_penalties(*cpu)
    tokens = torch.argmax(pen_card, dim=-1)
    chosen, ids, lps = sampling.compute_topk_logprobs(pen_card, tokens)
    chosen_c, ids_c, lps_c = sampling.compute_topk_logprobs(pen_card.cpu(), tokens.cpu())
    bias = {7: 100.0, 128255: -50.0, 200000: 3.0, 42: 2.5}
    biased = torch.stack([LogitBiasProcessor(bias)([], row) for row in args[0]])
    biased_c = torch.stack([LogitBiasProcessor(bias)([], row) for row in cpu[0]])
    res = {
        "shape": list(args[0].shape),
        "penalties_max_abs_err": (pen_card.cpu() - pen_cpu).abs().max().item(),
        "penalised_rows_changed": int((pen_card != args[0]).any(dim=-1).sum().item()),
        "top_ids_equal": bool(torch.equal(ids.cpu(), ids_c)),
        "top_ids_row1": ids[1, :6].tolist(),
        "chosen_is_top1": bool(torch.equal(ids[:, 0].long(), tokens)),
        "logprobs_max_abs_err": max((chosen.cpu() - chosen_c).abs().max().item(),
                                    (lps.cpu() - lps_c).abs().max().item()),
        "logit_bias_max_abs_err": (biased.cpu() - biased_c).abs().max().item(),
        "tol": EXTRAS_LP_TOL,
    }
    res["ok"] = (res["penalties_max_abs_err"] == 0 and res["logit_bias_max_abs_err"] == 0 and res["top_ids_equal"]
                 and res["chosen_is_top1"] and res["logprobs_max_abs_err"] <= EXTRAS_LP_TOL
                 and res["penalised_rows_changed"] == EXTRAS_ROWS - 1 and res["top_ids_row1"] == list(range(6)))
    emit("model_extras", **res)
    if not res["ok"]:
        raise AssertionError(f"the extras' device ops disagree with the CPU: {res}")


def phase_model_chunk(dev):
    """``llama.chunk_decode`` of llama-3.2-1b at full width on the card, bf16
    and int8 (KV and weights), on the kernel path, the plain path (the
    ragged kernel's plain version on the card) and the plain path over f32
    copies of the weights (the truth): over 8 cached 1024-token prefixes,
    a wave of ``WAVE_ROWS`` (S = 256, each row's last logits, every
    position's, the argmax), then a verify of 8 rows of 5 queries over
    the prefixes (every position's logits, the argmax). As the int8 model
    check holds them: at each call the kernel's distance from the truth
    stays within ``SPEC_BF16_NOISE_RATIO`` of the plain version's (its
    bf16 noise), over the valid positions, and its tokens equal the plain
    version's where the plain top-2 gap exceeds ``STEP0_GAP_NOISES`` of
    the row's noise; the argmax mode's tokens are the all-logits call's
    argmax. One ragged launch a layer a call."""
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.engine.quant import QuantW, quantize_params
    from dynamo_tpu_torch.engine.weights import init_params

    base = get_config(PRESET)
    L, BS, V = base.num_layers, base.block_size, base.vocab_size
    rng = np.random.default_rng(12)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    B = len(WAVE_ROWS)
    # Block ids: 8 prefixes of 1024 tokens with room for the wave and the
    # verify behind them, then the wave's fresh rows.
    per_prefix = (1024 + WAVE_S + VERIFY_S) // BS + 2
    per_fresh = WAVE_S // BS + 1
    NB = 1 + B * per_prefix + B * per_fresh
    ids = (rng.permutation(NB - 1) + 1).astype(np.int32)
    prefix_tables = ids[:B * per_prefix].reshape(B, per_prefix)
    fresh_tables = ids[B * per_prefix:].reshape(B, per_fresh)
    prefix_toks = rng.integers(1, V, size=(B, 1024)).astype(np.int32)
    W = per_prefix
    wave_tables = np.zeros((B, W), np.int32)
    wave_pos0 = np.zeros(B, np.int32)
    wave_valid = np.array([v for _, v in WAVE_ROWS], np.int32)
    for i, (p, _) in enumerate(WAVE_ROWS):
        if p:
            wave_tables[i], wave_pos0[i] = prefix_tables[i], p
        else:
            wave_tables[i, :per_fresh] = fresh_tables[i]
    wave_toks = rng.integers(1, V, size=(B, WAVE_S)).astype(np.int32)
    ver_pos0 = np.array([1024 + (wave_valid[i] if WAVE_ROWS[i][0] else 0) for i in range(B)], np.int32)
    ver_toks = rng.integers(1, V, size=(B, VERIFY_S)).astype(np.int32)
    ver_valid = np.full(B, VERIFY_S, np.int32)
    calls = [("wave last", wave_toks, wave_pos0, wave_valid, wave_tables, "last"),
             ("wave all", wave_toks, wave_pos0, wave_valid, wave_tables, "all"),
             ("wave argmax", wave_toks, wave_pos0, wave_valid, wave_tables, "argmax"),
             ("verify all", ver_toks, ver_pos0, ver_valid, prefix_tables, "all"),
             ("verify argmax", ver_toks, ver_pos0, ver_valid, prefix_tables, "argmax")]

    failed = []
    for mode in ("bf16", "int8"):
        cfg = base if mode == "bf16" else base.replace(kv_cache_dtype="int8", weight_dtype="int8")
        params = init_params(base, torch.Generator(device=dev).manual_seed(13), device=dev, dtype=torch.bfloat16)
        if mode == "int8":
            params = quantize_params(params)
        params32 = {k: ({kk: vv if isinstance(vv, QuantW) else vv.float() for kk, vv in v.items()}
                        if isinstance(v, dict) else v.float()) for k, v in params.items()}
        variants = {"kernel": (params, torch.bfloat16), "plain": (params, torch.bfloat16),
                    "truth": (params32, torch.float32)}
        caches = {n: KvCacheArrays.create(cfg, NB, dtype=dt, device=dev) for n, (_, dt) in variants.items()}

        def run(name, fn):
            with PlainAttention() if name != "kernel" else contextlib.nullcontext() as pa:
                out = fn(*variants[name], caches[name])
            return out, getattr(pa, "calls", 0)

        pad = np.zeros(1024, np.int32)
        for name in variants:
            for i in range(B):
                pad[:] = prefix_toks[i]
                run(name, lambda p, dt, c: llama.prefill(p, cfg, c.k, c.v, t(pad), 1024, 0, t(prefix_tables[i])))
        reset_counts()
        plain_calls, rows, all_logits = 0, [], None
        for label, toks, pos0, valid, tables, ret in calls:
            kw = {"last": dict(last_logits=True), "all": dict(all_logits=True), "argmax": {}}[ret]
            outs = {}
            for name in variants:
                outs[name], n = run(name, lambda p, dt, c: llama.chunk_decode(
                    p, cfg, c.k, c.v, t(toks), t(pos0), t(valid), t(tables), **kw)[0])
                plain_calls += n
            live = t(np.arange(toks.shape[1])[None, :] < valid[:, None])
            if ret == "argmax":
                # The argmax mode is the all-logits call's argmax.
                same = bool(torch.equal(outs["kernel"][live], all_logits.argmax(-1).to(torch.int32)[live]))
                rows.append({"call": label, "tokens_equal_all_logits_argmax": same, "ok": same})
                continue
            kl, pl_, tl = (outs[n].float() for n in ("kernel", "plain", "truth"))
            if ret == "all":
                kl, pl_, tl = kl[live], pl_[live], tl[live]
                all_logits = outs["kernel"]
            noise = (pl_ - tl).abs().amax(dim=-1)
            top = pl_.topk(2, dim=-1)
            held = (top.values[:, 0] - top.values[:, 1]) > STEP0_GAP_NOISES * noise
            same = bool(torch.equal(kl.argmax(-1)[held], top.indices[held, 0]))
            row = {"call": label, "positions": len(kl), "kernel_vs_plain": (kl - pl_).abs().max().item(),
                   "plain_vs_f32": noise.max().item(), "kernel_vs_f32": (kl - tl).abs().max().item(),
                   "limit": SPEC_BF16_NOISE_RATIO * noise.max().item(), "rows_held": int(held.sum()),
                   "tokens_equal_where_held": same, "finite": bool(torch.isfinite(kl).all())}
            row["ok"] = row["finite"] and same and row["kernel_vs_f32"] <= row["limit"]
            rows.append(row)
            del kl, pl_, tl
        counts = {n: c["launches"] for n, c in read_counts().items() if c["launches"]}
        kernel = "ragged_paged_attention" + ("_int8" if mode == "int8" else "")
        ok = all(r["ok"] for r in rows) and counts == {kernel: L * len(calls)} \
            and plain_calls == 2 * L * len(calls)
        res = {"preset": PRESET, "path": f"chunk_decode {mode}, kernel vs plain (bf16, f32 truth)",
               "wave_rows": WAVE_ROWS, "wave_S": WAVE_S, "verify_rows": VERIFY_ROWS, "calls": rows,
               "kernel_launches": counts, "plain_calls": plain_calls, "noise_ratio": SPEC_BF16_NOISE_RATIO,
               "gap_noises": STEP0_GAP_NOISES, "ok": ok}
        emit("model", **res)
        if not ok:
            failed.append(res)
        del params, params32, caches, all_logits
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"chunk_decode's kernel path disagrees with its plain path: {failed}")


def phase_model_spec_rounds(dev):
    """An in-process scheduler of llama-3.2-1b in f32 with int8 weights, its
    KV cache f32 and then int8 (no fused window under int8, so no fused
    spec window), with a self-draft of the same weights and cache dtype (γ =
    ``SPEC_GAMMA``, one decode step an iteration). 4 greedy requests must
    speculate per round (``spec_rounds_total`` > 0, no fused spec window),
    every draft and target pass launching the ragged kernel once a layer
    (its int8 branch over the int8 cache) and no plain version. Over the
    f32 cache their tokens must be those of the same scheduler without the
    draft; over the int8 cache a verify attends its own chunk's K/V at full
    precision where single steps read them back quantized (as in the JAX
    package), so there the first tokens must be equal and the agreement is
    reported."""
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.quant import quantize_params
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import Scheduler, SchedulerConfig, StopConditions
    from dynamo_tpu_torch.engine.weights import init_params

    base = get_config(PRESET)
    params = quantize_params(init_params(base, torch.Generator(device=dev).manual_seed(14), device=dev,
                                         dtype=torch.float32))
    rng = np.random.default_rng(14)
    # A first set warms the graphs (a kind's first capture runs its body
    # eagerly too); the second is counted.
    warm, prompts = ([rng.integers(1, base.vocab_size, size=n).tolist() for n in (40, 300, 17, 120)]
                     for _ in range(2))
    keys = ("forward_steps_total", "draft_prefill_steps_total", "spec_rounds_total", "spec_fused_windows_total")
    L = base.num_layers
    failed = []
    for kv in ("auto", "int8"):
        cfg = base.replace(kv_cache_dtype=kv, weight_dtype="int8")

        def serve(draft: bool, sets):
            s = Scheduler(cfg, params, SchedulerConfig(num_blocks=256, num_scheduler_steps=1), dtype=torch.float32,
                          device=str(dev))
            if draft:
                s.attach_draft(cfg, params, gamma=SPEC_GAMMA)
            for n, batch in enumerate(sets):
                out = {}
                before = {k: getattr(s, k) for k in keys}
                reset_counts()
                t0 = time.perf_counter()
                for i, p in enumerate(batch):
                    s.add_request(f"{n}.{i}", p, SamplingParams(temperature=0.0),
                                  StopConditions(max_tokens=24, ignore_eos=True))
                while s.has_work():
                    for seq, o in s.step():
                        if o.token_id >= 0:
                            out.setdefault(seq.request_id.split(".")[1], []).append(o.token_id)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = read_counts()
            delta = {k: getattr(s, k) - before[k] for k in keys}
            s.close()
            return s, out, wall, counts, delta

        spec, got, spec_s, counts, d = serve(True, (warm, prompts))
        _, want, plain_s, _, _ = serve(False, (prompts,))
        launches = {n: c["launches"] for n, c in counts.items() if c["launches"]}
        passes = d["forward_steps_total"] + d["draft_prefill_steps_total"] + d["spec_rounds_total"] * (SPEC_GAMMA + 1)
        kernel = "ragged_paged_attention" + ("_int8" if kv == "int8" else "")
        agree = [sum(a == b for a, b in zip(got[r], want[r])) / len(want[r]) for r in sorted(want)]
        first_apart = [next((i for i, (a, b) in enumerate(zip(got[r], want[r])) if a != b), None) for r in sorted(want)]
        tokens_ok = got == want if kv == "auto" else all(got[r][0] == want[r][0] for r in want)
        ok = (tokens_ok and d["spec_rounds_total"] > 0 and d["spec_fused_windows_total"] == 0
              and not spec._use_fused_spec and launches == {kernel: L * passes}
              and sum(c["plain_calls"] for c in counts.values()) == 0)
        res = {"preset": PRESET, "path": f"scheduler f32, int8 weights, {'int8' if kv == 'int8' else 'f32'} KV: "
                                         "self-draft per round vs no draft",
               "gamma": SPEC_GAMMA, "tokens_equal": got == want, "token_agreement": agree,
               "first_token_apart": first_apart, "counted": d, "spec_decode": spec.spec_stats.to_dict(),
               "kernel_launches": launches, "expected": {kernel: L * passes}, "spec_wall_s": spec_s,
               "plain_wall_s": plain_s, "ok": ok}
        emit("model", **res)
        if not ok:
            failed.append(res)
        del spec
    del params
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"the int8 scheduler's per-round spec path failed: {failed}")


def graph_diff(what: str, want: torch.Tensor, got: torch.Tensor, dims: tuple) -> Optional[dict]:
    """None when ``got`` (a graph replay's) is bit-equal to ``want`` (the
    eager call's), else the largest difference, how many elements differ
    and the first of them by ``dims``, and what that points at."""
    if want.shape != got.shape or want.dtype != got.dtype:
        return {"what": what, "cause": f"shape or dtype {tuple(want.shape)} {want.dtype} != "
                                       f"{tuple(got.shape)} {got.dtype}"}
    if torch.equal(want, got):
        return None
    bad = want != got
    first = [int(i) for i in torch.nonzero(bad)[0].tolist()]
    at = dict(zip(dims, first))
    if what.startswith("kv"):
        cause = (f"the replay's KV rows first differ in layer {at.get('layer')}: that layer's forward ran "
                 f"differently under the graph (a kernel's launch, or a cuBLAS algorithm chosen on the capture "
                 f"stream)")
    elif what == "tokens":
        cause = "the draw differs: its logits, its keys or its static inputs were not the eager call's"
    else:
        cause = "the logits differ while the inputs were the same: a step op ran differently under capture"
    return {"what": what, "max_abs_diff": (want.float() - got.float()).abs().max().item(),
            "differing": int(bad.sum()), "first_at": at, "cause": cause}


def phase_model_graphs(dev):
    """Each graphed step of ``engine/graphs.py`` against the eager call on
    the same inputs, llama-3.2-1b at full width in bf16 and in int8 (KV and
    weights): a 512-bucket prefill chunk, a mixed step (128-token chunk,
    8 decode rows), a decode step, ``decode_sample`` (sampled rows among
    greedy ones), the draw at B = 1 and 8 (one key) and at B = 8 (per-row
    keys), and an 8-step ``decode_multi`` window, all at table width 32;
    ``decode_sample``, the draw at B = 8 and the window also all-greedy (no
    key: the greedy graphs).
    The cache is restored between the eager call and the replay; logits,
    tokens and every KV block but the scratch must be bit-equal. Each kind
    runs twice, on two sets of inputs: the first call captures, the second
    replays after its static buffers were refilled, so a capture that froze
    an input cannot pass."""
    from dynamo_tpu_torch.engine import prng
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.graphs import StepGraphs
    from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays, QuantKv
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.engine.quant import quantize_params
    from dynamo_tpu_torch.engine.sampling import sample_batch_device
    from dynamo_tpu_torch.engine.weights import init_params

    base = get_config(PRESET)
    V, NB, W, B, steps = base.vocab_size, 320, 32, 8, 8
    params = init_params(base, torch.Generator(device=dev).manual_seed(4), device=dev, dtype=torch.bfloat16)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    failed, rows = [], []
    for label in ("bf16", "int8"):
        cfg = base if label == "bf16" else base.replace(kv_cache_dtype="int8", weight_dtype="int8")
        p = params if label == "bf16" else quantize_params(dict(params, layers=dict(params["layers"])))
        cache = KvCacheArrays.create(cfg, NB, dtype=torch.bfloat16, device=dev)
        parts = [x for c in (cache.k, cache.v) for x in ((c.q, c.scale) if isinstance(c, QuantKv) else (c,))]
        for c in (cache.k, cache.v):
            if isinstance(c, QuantKv):
                c.q.random_(-127, 128)
                c.scale.uniform_(0.005, 0.03)
            else:
                c.normal_()
        g = StepGraphs(dev)

        def inputs(seed):
            rng = np.random.default_rng(seed)
            ids = rng.permutation(np.arange(1, NB)).astype(np.int32)
            tables = ids[:B * W].reshape(B, W).copy()
            chunk_table = ids[B * W:(B + 1) * W].copy()  # the mixed step's chunk: blocks of its own
            n = B - seed % 3  # some dead lanes
            tpa = np.stack([rng.integers(1, V, size=B), rng.integers(100, W * base.block_size - steps - 1, size=B),
                            (np.arange(B) < n)]).astype(np.int32)
            temps = np.where(rng.random(B) < 0.4, rng.uniform(0.6, 1.2, size=B), 0.0).astype(np.float32)
            top_ks = np.where(rng.random(B) < 0.5, rng.integers(1, 60, size=B), 0).astype(np.int32)
            top_ps = np.where(rng.random(B) < 0.5, rng.uniform(0.5, 1.0, size=B), 1.0).astype(np.float32)
            return dict(rng=rng, tables=tables, chunk_table=chunk_table, tpa=tpa, samp=(temps, top_ks, top_ps),
                        key=prng.fold_in(prng.PRNGKey(seed), 7),
                        row_keys=prng.split(prng.PRNGKey(seed + 100), B),
                        logits=torch.randn((B, V), generator=torch.Generator(device=dev).manual_seed(seed),
                                           device=dev) * 3,
                        tokens=rng.integers(1, V, size=512).astype(np.int32), valid=int(rng.integers(150, 400)),
                        cache_len=int(rng.integers(0, 100)), p_valid=int(rng.integers(40, 128)))

        def dev_tpa(x):
            d = t(x["tpa"])
            return d[0], d[1], t(x["tables"]), d[2].bool()

        kinds = {
            "prefill": (
                lambda x: {"logits": llama.prefill(p, cfg, cache.k, cache.v, t(x["tokens"]), x["valid"], x["cache_len"],
                                                   t(x["tables"][0]))[0]},
                lambda x: {"logits": g.prefill("target", p, cfg, cache, x["tokens"], x["valid"], x["cache_len"],
                                               x["tables"][0])[0]}),
            "mixed": (
                lambda x: {"logits": llama.mixed_step(p, cfg, cache.k, cache.v, t(x["tokens"][:128]), x["p_valid"],
                                                      x["cache_len"], t(x["chunk_table"]), *dev_tpa(x))[0]},
                lambda x: {"logits": torch.cat(g.mixed(p, cfg, cache, x["tokens"][:128], x["p_valid"], x["cache_len"],
                                                       x["chunk_table"], x["tpa"], x["tables"]))}),
            "decode": (
                lambda x: {"logits": llama.decode(p, cfg, cache.k, cache.v, *dev_tpa(x))[0]},
                lambda x: {"logits": g.decode(p, cfg, cache, x["tpa"], x["tables"])}),
            "decode_sample": (
                lambda x: dict(zip(("tokens", "next_tpa"), llama.decode_sample(
                    p, cfg, cache.k, cache.v, t(x["tpa"]), t(x["tables"]), *map(t, x["samp"]), x["key"])[:2])),
                lambda x: dict(zip(("tokens", "next_tpa"), g.decode_sample(
                    p, cfg, cache, x["tpa"], x["tables"], *x["samp"], x["key"])))),
            "draw B=1": (
                lambda x: {"tokens": sample_batch_device(x["logits"][:1], *(t(a[:1]) for a in x["samp"]), x["key"])},
                lambda x: {"tokens": g.draw(x["logits"][:1], *(a[:1] for a in x["samp"]), x["key"])}),
            "draw B=8": (
                lambda x: {"tokens": sample_batch_device(x["logits"], *map(t, x["samp"]), x["key"])},
                lambda x: {"tokens": g.draw(x["logits"], *x["samp"], x["key"])}),
            "draw B=8 seeded": (
                lambda x: {"tokens": sample_batch_device(x["logits"], *map(t, x["samp"]), None, x["row_keys"])},
                lambda x: {"tokens": g.draw(x["logits"], *x["samp"], x["key"], x["row_keys"])}),
            "decode_multi": (
                lambda x: {"tokens": llama.decode_multi(p, cfg, cache.k, cache.v, *dev_tpa(x), *x["samp"], x["key"],
                                                        steps)[0]},
                lambda x: {"tokens": g.decode_multi(p, cfg, cache, x["tpa"], x["tables"], *x["samp"],
                                                    prng.split_many(x["key"], steps), steps)}),
            # An all-greedy batch: no key, the greedy graphs (the argmax, no draw).
            "decode_sample greedy": (
                lambda x: dict(zip(("tokens", "next_tpa"), llama.decode_sample(
                    p, cfg, cache.k, cache.v, t(x["tpa"]), t(x["tables"]), None, None, None, None)[:2])),
                lambda x: dict(zip(("tokens", "next_tpa"), g.decode_sample(
                    p, cfg, cache, x["tpa"], x["tables"], *x["samp"], None)))),
            "draw B=8 greedy": (
                lambda x: {"tokens": sample_batch_device(x["logits"], None, None, None, None)},
                lambda x: {"tokens": g.draw(x["logits"], *x["samp"], None)}),
            "decode_multi greedy": (
                lambda x: {"tokens": llama.decode_multi(p, cfg, cache.k, cache.v, *dev_tpa(x), *x["samp"], None,
                                                        steps)[0]},
                lambda x: {"tokens": g.decode_multi(p, cfg, cache, x["tpa"], x["tables"], *x["samp"], None, steps)}),
        }
        for kind, (eager, graphed) in kinds.items():
            for turn, seed in enumerate((11, 12)):
                x = inputs(seed)
                saved = [c.clone() for c in parts]
                want = {k: v.clone() for k, v in eager(x).items()}
                kv_want = [c[:, 1:].clone() for c in parts]
                for c, s0 in zip(parts, saved):
                    c.copy_(s0)
                t0 = time.perf_counter()
                got = {k: v.clone() for k, v in graphed(x).items()}
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                diffs = [graph_diff(k, want[k], got[k], ("row", "col")) for k in want]
                diffs += [graph_diff(f"kv part {i}", a, b[:, 1:], ("layer", "block", "slot", "head", "dim"))
                          for i, (a, b) in enumerate(zip(kv_want, parts))]
                diffs = [d for d in diffs if d]
                row = {"model": label, "kind": kind, "inputs": "captured" if turn == 0 else "refilled",
                       "bit_equal": not diffs, "graph_call_s": secs, "diffs": diffs}
                rows.append(row)
                if diffs:
                    failed.append(row)
                    print(f"chip_smoke: graph replay of {kind} ({label}, {row['inputs']}) is not bit-equal to the "
                          f"eager call: {json.dumps(diffs)}", file=sys.stderr, flush=True)
        res = {"graphs": len(g), "captures": g.captures_total, "capture_s": g.capture_s_total}
        emit("model", preset=PRESET, path=f"graphs {label}", **res,
             checks=[{k: r[k] for k in ("kind", "inputs", "bit_equal", "graph_call_s")} for r in rows
                     if r["model"] == label])
        del g, cache, parts
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"graph replays differ from the eager calls: {failed}")


def phase_model_window(dev):
    """llama-3.2-1b at full width in f32 on the card: one 8-step window of 8
    rows at ragged positions (one dead) through the fused window (one
    launch) and through ``decode_multi`` over the ragged kernel (one launch
    per layer and step), from copies of one cache: greedy, then with the
    rows in ``SAMPLE_MIX``'s turn (final norm times ``LOGIT_SPREAD``),
    ``decode_multi_fused(sampled=True)`` against ``decode_multi(uniforms=)``
    on the same uniforms. The live rows' tokens must be equal and the
    written K/V within 1e-3."""
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.models import llama

    base = get_config(PRESET)
    steps = 8
    case = window_case("llama-3.2-1b window", dev, torch.float32, 420, cfg=base,
                       positions=[0, 13, 100, 255, 511, 700, 1023], dead=1, steps=steps)
    params, ints, k0, v0 = case["params"], case["ints"], case["k"], case["v"]
    B = len(ints[0])
    live = ints[3].cpu()
    tables = ints[2].cpu()
    written = torch.zeros(k0.shape[1:3], dtype=torch.bool)
    for b, p in enumerate(case["positions"]):
        for j in range(steps):
            written[int(tables[b, (p + j) // base.block_size]), (p + j) % base.block_size] = True
    sel = written.to(dev)
    greedy = (np.zeros(B, np.float32), np.zeros(B, np.int32), np.ones(B, np.float32))
    failed = []
    for mode in ("greedy", "sampled"):
        if mode == "sampled":
            params["final_norm"].mul_(LOGIT_SPREAD)
            temps, top_ks, top_ps, u = sample_rows(B, steps, dev, 421)
            fused_kw = dict(temps=temps, top_ks=top_ks, top_ps=top_ps, uniforms=u, sampled=True)
            multi_args = (temps.cpu().numpy(), top_ks.cpu().numpy(), top_ps.cpu().numpy(), None, steps)
            multi_kw = dict(uniforms=u)
        else:
            fused_kw, multi_args, multi_kw = {}, (*greedy, None, steps), {}
        fk, fv, dk, dv = k0.clone(), v0.clone(), k0.clone(), v0.clone()
        reset_counts()
        fused, _, _ = llama.decode_multi_fused(params, base, fk, fv, *ints, num_steps=steps, **fused_kw)
        fused_counts = read_counts()
        reset_counts()
        multi, _, _ = llama.decode_multi(params, base, dk, dv, *ints, *multi_args, **multi_kw)
        multi_counts = read_counts()
        torch.cuda.synchronize()
        kv_err = max((fk[:, sel] - dk[:, sel]).abs().max().item(), (fv[:, sel] - dv[:, sel]).abs().max().item())
        same = bool(torch.equal(fused[:, live].cpu(), multi[:, live].cpu()))
        launches = ({n: c["launches"] for n, c in fused_counts.items() if c["launches"]},
                    {n: c["launches"] for n, c in multi_counts.items() if c["launches"]})
        want = ({"fused_decode_window": 1} | ({"fused_decode_window_sampled": 1} if mode == "sampled" else {}),
                {"ragged_paged_attention": steps * base.num_layers})
        plain = sum(c["plain_calls"] for counts in (fused_counts, multi_counts) for c in counts.values())
        ok = same and kv_err <= 1e-3 and launches == want and not plain
        res = dict(preset=PRESET, path=f"fused window vs decode_multi, {mode}", dtype="float32", rows=B,
                   live=int(live.sum()), steps=steps, tokens_equal=same,
                   token_agreement=(fused[:, live] == multi[:, live]).float().mean().item(), kv_max_abs_err=kv_err,
                   tol=1e-3, kernel_launches=launches, expected_launches=want, plain_calls_on_card=plain, ok=ok)
        if mode == "sampled":
            res.update(rows_params=[SAMPLE_MIX[b % len(SAMPLE_MIX)] for b in range(B)], logit_spread=LOGIT_SPREAD)
            if not same:
                res.update(tokens=fused[:, live].tolist(), decode_multi_tokens=multi[:, live].tolist())
        emit("model", **res)
        if not ok:
            failed.append(mode)
        del fk, fv, dk, dv
    if failed:
        raise AssertionError(f"the fused window disagrees with decode_multi over the ragged kernel: {failed}")
    del case, params
    torch.cuda.empty_cache()
    phase_model_spec(dev)


def phase_model_spec(dev):
    """llama-3.2-1b at full width in f32 on the card, speculating with its
    own weights (``llama.decode_spec_fused``, R = 6 rounds of γ = 4, one
    launch) from copies of one cache (the draft's a copy of the target's):
    every live row's confirmed stream must equal the greedy stream of
    ``decode_multi_fused`` from the same cache over the same span; at a
    position where they differ the plain version's top-2 logit gap of that
    round is printed."""
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.engine.attention import megakernel as mk

    base = get_config(PRESET)
    R, G = SPEC_ROUNDS, SPEC_GAMMA
    case = spec_case("llama-3.2-1b self", dev, torch.float32, 470, tcfg=base, dcfg=base, positions=SPEC_RAGGED,
                     dead=1, draft="same", sampled=False, spread=1.0)
    params, caches, inputs = case["tparams"], case["caches"], case["inputs"]
    tokens, xprev, positions, tables, _, active, temps, top_ks, top_ps, u = inputs
    live = active.cpu()
    sc = [c.clone() for c in caches]
    reset_counts()
    toks, acc, *_ = llama.decode_spec_fused(params, base, params, base, *sc, tokens, xprev, positions, tables, tables,
                                            active, temps, top_ks, top_ps, u, rounds=R, gamma=G)
    spec_counts = read_counts()
    fk, fv = caches[0].clone(), caches[1].clone()
    window, _, _ = llama.decode_multi_fused(params, base, fk, fv, tokens, positions, tables, active,
                                            num_steps=R * (G + 1))
    margins = {}
    mk.fused_spec_window_ref(*case["weights"], *[c.clone() for c in caches], *inputs, **case["kw"], margins=margins)
    torch.cuda.synchronize()
    toks, acc, window = toks.cpu(), acc.cpu(), window.cpu()
    differ, equal = [], True
    for b in range(len(case["positions"])):
        stream, rounds_of = [], []
        for r in range(R):
            k = int(acc[r, b])
            stream += toks[r, b, :k].tolist() + [int(toks[r, b, G])]
            rounds_of += [r] * (k + 1)
        want = window[:len(stream), b].tolist()
        for j, (x, y) in enumerate(zip(stream, want)):
            if x != y:
                equal = False
                differ.append({"row": b, "position": j, "spec": x, "window": y, "round": rounds_of[j],
                               "plain_top2_gap": float(margins["argmax"][rounds_of[j], b])})
                break
    launches = {n: c["launches"] for n, c in spec_counts.items() if c["launches"]}
    plain = sum(c["plain_calls"] for c in spec_counts.values())
    accepted = acc[:, live]
    ok = equal and launches == {"fused_spec_window": 1} and not plain
    res = dict(preset=PRESET, path="decode_spec_fused (self-speculation) vs decode_multi_fused", dtype="float32",
               rows=len(live), live=int(live.sum()), rounds=R, gamma=G, streams_equal=equal, differ=differ,
               accepted_per_round=float((accepted + 1).float().mean()), accepted=accepted.tolist(),
               kernel_launches=launches, plain_calls_on_card=plain, ok=ok)
    emit("model", **res)
    if not ok:
        raise AssertionError(f"the fused spec window's stream differs from the fused window's: {res}")
    del case, params, caches, sc
    torch.cuda.empty_cache()


class PlainAttention:
    """Inside the ``with`` block the model's ragged attention calls run the
    plain version on the card (the wrapper's module attribute, which
    ``llama`` looks up at call time, points at ``ragged_paged_attention_ref``);
    ``calls`` counts them."""

    def __enter__(self):
        from dynamo_tpu_torch.engine.attention import megakernel as mk

        self.mk, self.orig, self.calls = mk, mk.ragged_paged_attention, 0

        def plain(*args, **kw):
            self.calls += 1
            return mk.ragged_paged_attention_ref(*args, **kw)

        mk.ragged_paged_attention = plain
        return self

    def __exit__(self, *exc):
        self.mk.ragged_paged_attention = self.orig


def tree_bytes(params) -> int:
    """Bytes a param tree holds on the card, from its tensors (an int8
    weight's codes and scales)."""
    leaves = []
    for v in params.values():
        for w in (v.values() if isinstance(v, dict) else [v]):
            leaves += list(w) if isinstance(w, tuple) else [w]
    return sum(t.numel() * t.element_size() for t in leaves)


# The int8 model check's window rows (one dead row beside them) and steps.
INT8_WINDOW_POSITIONS = [0, 13, 100, 255, 511, 700, 1023]
INT8_WINDOW_STEPS = 32


def phase_model_int8(dev):
    """llama-3.2-1b at full width with int8 KV and int8 weights, on the card:
    1. resident bytes of the weights and of one 16-token KV block (all
       layers, K and V), int8 against bf16, from the tensors, and the blocks
       that fit beside the weights in the memory free at the phase's start;
    2. bf16, teacher-forced: a 300-token prefill (every position's logits),
       a decode step (batch 2, one padded lane) and a mixed step (an
       80-token chunk beside the decode row) on the kernel path and on the
       plain path (the ragged kernel's
       plain version on the card), and on the plain path over f32 copies of
       the weights (the same int8 codes, embedding and norms in f32). Each
       step's bf16 noise is the plain bf16 logits' largest distance from the
       f32 ones; the kernel's distance from the f32 logits must stay within
       ``SPEC_BF16_NOISE_RATIO`` of the plain version's, and the greedy
       tokens must be equal where the plain top-2 gap exceeds
       ``STEP0_GAP_NOISES`` of the row's noise;
    3. f32: a 32-step ``decode_multi`` window of 8 rows (one dead) over a
       random int8 cache on both paths from copies of one cache: the same
       tokens, and the same codes and scales written at the window's end
       (but for a code step at a rounding tie)."""
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays, QuantKv, quantize_kv_rows
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.engine.quant import QuantW, quantize_params
    from dynamo_tpu_torch.engine.weights import init_params

    base = get_config(PRESET)
    cfg = base.replace(kv_cache_dtype="int8", weight_dtype="int8")
    L, BS = base.num_layers, base.block_size
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info(dev)[0]
    params = init_params(base, torch.Generator(device=dev).manual_seed(3), device=dev, dtype=torch.bfloat16)
    weights_bf16 = tree_bytes(params)
    params = quantize_params(params)
    weights_int8 = tree_bytes(params)
    block = {name: sum(t.numel() * t.element_size() for c in (kv.k, kv.v) for t in (c if isinstance(c, QuantKv) else [c]))
             for name, kv in (("bf16", KvCacheArrays.create(base, 1, dtype=torch.bfloat16, device=dev)),
                              ("int8", KvCacheArrays.create(cfg, 1, dtype=torch.bfloat16, device=dev)))}
    resident = {"free_at_start_bytes": free0, "weights_bf16_bytes": weights_bf16, "weights_int8_bytes": weights_int8,
                "kv_block_bf16_bytes": block["bf16"], "kv_block_int8_bytes": block["int8"],
                "blocks_fit_bf16": (free0 - weights_bf16) // block["bf16"],
                "blocks_fit_int8": (free0 - weights_int8) // block["int8"]}
    emit("model", preset=PRESET, path="int8 resident bytes", **resident)

    # 2. bf16 teacher-forced steps, kernel vs plain, each against f32.
    rng = np.random.default_rng(8)
    seq_a = rng.integers(1, base.vocab_size, size=320).astype(np.int32)
    seq_b = rng.integers(1, base.vocab_size, size=80).astype(np.int32)
    table_a = np.zeros(24, np.int32)
    table_a[:22] = np.arange(1, 23)
    table_b = np.zeros(16, np.int32)
    table_b[:6] = np.arange(23, 29)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    params32 = {k: ({kk: vv if isinstance(vv, QuantW) else vv.float() for kk, vv in v.items()}
                    if isinstance(v, dict) else v.float()) for k, v in params.items()}

    def steps(p):
        cache = KvCacheArrays.create(cfg, 48, device=dev)
        k, v = cache.k, cache.v
        toks = np.zeros(512, np.int32)
        toks[:300] = seq_a[:300]
        out = [llama.prefill(p, cfg, k, v, t(toks), 300, 0, t(table_a), all_logits=True)[0][:300]]
        out.append(llama.decode(p, cfg, k, v, t(np.array([seq_a[300], 0], np.int32)), t(np.array([300, 0], np.int32)),
                                t(np.stack([table_a, np.zeros_like(table_a)])), t(np.array([True, False])))[0][:1])
        p_tok = np.zeros(128, np.int32)
        p_tok[:80] = seq_b
        out.append(llama.mixed_step(p, cfg, k, v, t(p_tok), 80, 0, t(table_b), t(seq_a[301:302]),
                                    t(np.array([301], np.int32)), t(table_a[None]), t(np.array([True])))[0])
        return [x.float() for x in out]

    reset_counts()
    kern = steps(params)
    kern_counts = read_counts()
    with PlainAttention() as pa:
        plain = steps(params)
        truth = steps(params32)
    launches = {n: c["launches"] for n, c in kern_counts.items() if c["launches"]}
    rows = []
    ok = launches == {"ragged_paged_attention_int8": 3 * L} and pa.calls == 6 * L
    for name, kl, pl_, tl in zip(("prefill", "decode", "mixed"), kern, plain, truth):
        noise = (pl_ - tl).abs().amax(dim=-1)
        kern_dist = (kl - tl).abs().max().item()
        top = pl_.topk(2, dim=-1)
        gap = top.values[:, 0] - top.values[:, 1]
        held = gap > STEP0_GAP_NOISES * noise
        same = bool(torch.equal(kl.argmax(-1)[held], top.indices[held, 0]))
        row = {"step": name, "kernel_vs_plain": (kl - pl_).abs().max().item(), "plain_vs_f32": noise.max().item(),
               "kernel_vs_f32": kern_dist, "limit": SPEC_BF16_NOISE_RATIO * noise.max().item(),
               "rows_held": int(held.sum()), "rows": len(held), "tokens_equal_where_held": same,
               "finite": bool(torch.isfinite(kl).all())}
        row["ok"] = row["finite"] and same and kern_dist <= row["limit"]
        ok = ok and row["ok"]
        rows.append(row)
    res = {"preset": PRESET, "path": "int8 KV + int8 weights, kernel vs plain (bf16, f32 truth)",
           "steps": rows, "kernel_launches": launches, "plain_calls": pa.calls,
           "noise_ratio": SPEC_BF16_NOISE_RATIO, "gap_noises": STEP0_GAP_NOISES, "ok": ok}
    emit("model", **res)
    if not ok:
        raise AssertionError(f"the int8 model's kernel path disagrees with its plain path: {res}")
    del params, kern, plain, truth

    # 3. f32 decode_multi window, kernel vs plain, from copies of one cache.
    B, W = len(INT8_WINDOW_POSITIONS) + 1, INT8_WINDOW_STEPS
    need = [(p + W) // BS + 1 for p in INT8_WINDOW_POSITIONS]
    NB = sum(need) + 1
    g = torch.Generator(device="cpu").manual_seed(9)
    ids = (torch.randperm(NB - 1, generator=g) + 1).to(torch.int32)
    tables = torch.zeros((B, max(need)), dtype=torch.int32)
    o = 0
    for b, n in enumerate(need):
        tables[b, :n] = ids[o:o + n]
        o += n
    shape = (L, NB, BS, base.num_kv_heads, base.head_dim)
    k0, v0 = (quantize_kv_rows(torch.randn(shape, generator=g)) for _ in range(2))
    k0, v0 = (QuantKv(c.q.to(dev), c.scale.to(dev)) for c in (k0, v0))
    positions = torch.tensor(INT8_WINDOW_POSITIONS + [0], dtype=torch.int32)
    ints = [t(rng.integers(1, base.vocab_size, size=B).astype(np.int32)), positions.to(dev), tables.to(dev),
            torch.tensor([True] * (B - 1) + [False], device=dev)]
    greedy = (np.zeros(B, np.float32), np.zeros(B, np.int32), np.ones(B, np.float32))
    written = torch.zeros((NB, BS), dtype=torch.bool)
    for b, p in enumerate(INT8_WINDOW_POSITIONS):
        for j in range(W):
            written[int(tables[b, (p + j) // BS]), (p + j) % BS] = True
    copy = lambda c: QuantKv(c.q.clone(), c.scale.clone())  # noqa: E731
    out = {}
    for name in ("kernel", "plain"):
        k, v = copy(k0), copy(v0)
        reset_counts()
        with PlainAttention() if name == "plain" else contextlib.nullcontext() as pa:
            toks, _, _ = llama.decode_multi(params32, cfg, k, v, *ints, *greedy, None, W)
            torch.cuda.synchronize()
        counts = read_counts()
        out[name] = (toks[:, :B - 1].cpu(), k, v, {n: c["launches"] for n, c in counts.items() if c["launches"]},
                     getattr(pa, "calls", 0))
    (kt, kk, kv, k_launch, _), (pt, pk, pv, p_launch, p_calls) = out["kernel"], out["plain"]
    # Rows within f32 rounding: a code may differ by one step at a tie, and a
    # scale in its last bits (as tests/test_torch_int8.py allows).
    sel = written.to(dev)
    code_diff, codes_apart, scale_err = 0, 0, 0.0
    for a, b in ((kk, pk), (kv, pv)):
        d = (a.q[:, sel].int() - b.q[:, sel].int()).abs()
        code_diff, codes_apart = max(code_diff, int(d.max())), codes_apart + int((d > 0).sum())
        scale_err = max(scale_err, ((a.scale[:, sel] - b.scale[:, sel]).abs() / b.scale[:, sel]).max().item())
    codes_ok = code_diff <= 1 and codes_apart <= 1e-3 * 2 * kk.q[:, sel].numel()
    same = bool(torch.equal(kt, pt))
    ok = (same and codes_ok and scale_err <= 2e-5 and k_launch == {"ragged_paged_attention_int8": W * L}
          and not p_launch and p_calls == W * L)
    res = {"preset": PRESET, "path": "int8 decode_multi window, kernel vs plain", "dtype": "float32", "rows": B,
           "live": B - 1, "steps": W, "tokens_equal": same, "token_agreement": (kt == pt).float().mean().item(),
           "codes_apart": codes_apart, "code_max_diff": code_diff, "scale_max_rel_err": scale_err, "kernel_launches": k_launch,
           "plain_launches": p_launch, "plain_calls": p_calls, "ok": ok}
    emit("model", **res)
    if not ok:
        raise AssertionError(f"the int8 decode_multi window's kernel path disagrees with its plain path: {res}")
    del params32, out, k0, v0
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 4b: where a forward step's device time goes
# ---------------------------------------------------------------------------


class LaunchTimer:
    """Brackets every call of the named functions made inside the ``with``
    block with CUDA events; ``ms(name)`` is a function's summed device time
    and ``count(name)`` its calls. Targets are ``(module, attribute)``
    pairs, looked up by their callers at call time."""

    def __init__(self, targets):
        self.targets = targets  # name -> (module, attribute)
        self.pairs = {name: [] for name in targets}

    def __enter__(self):
        self.orig = {name: getattr(mod, attr) for name, (mod, attr) in self.targets.items()}
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self._timed(name, self.orig[name]))
        return self

    def _timed(self, name, fn):
        def timed(*args, **kw):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
            self.pairs[name].append((a, b))
            return out

        return timed

    def __exit__(self, *exc):
        for name, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.orig[name])

    def ms(self, name) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs[name])

    def count(self, name) -> int:
        return len(self.pairs[name])


def host_enqueue_ms(fn, iters: int = 20) -> float:
    """Median host wall milliseconds to queue ``fn``'s work on the card (no
    synchronise inside; the card drains between runs). When it is close to
    the step's event time, the host, not the card, sets the step's pace."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_busy_ms(fn, runs: int = 3) -> tuple:
    """(device-busy milliseconds per run, device operations per run) of
    ``fn``, from ``torch.profiler``: the summed time of every kernel and
    copy it ran on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dynamo_tpu_torch.runtime.profiling import profiler_lock

    fn()
    torch.cuda.synchronize()
    # One profiler session a process: an engine's sampler waits its turn.
    with profiler_lock(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    busy_us, launches = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:  # the card's own events; CPU ops only attribute them
            busy_us += getattr(evt, "self_device_time_total", None) or evt.self_cuda_time_total
            launches += evt.count
    return busy_us / 1e3 / runs, launches / runs


def window_breakdown(params, cfg, cache, d_args, steps):
    """One decode window of ``steps`` steps over the breakdown's 8 rows: the
    fused window, greedy, with the rows in ``SAMPLE_MIX``'s turn, and with
    ``GUIDED_ROWS`` (one launch each), and the non-fused greedy
    ``decode_multi`` (one forward per step over the ragged kernel). Per window: event ms, host ms to
    queue it, profiler device-busy ms and device operations; and the event
    ms per step. For the fused windows, also the ms per step of each of
    their phases, from the kernel's own timer stamps."""
    from dynamo_tpu_torch.engine.models import llama

    B = len(d_args[0])
    greedy = (np.zeros(B, np.float32), np.zeros(B, np.int32), np.ones(B, np.float32))
    temps, top_ks, top_ps, u = sample_rows(B, steps, cache.k.device, 7)
    samp = dict(temps=temps, top_ks=top_ks, top_ps=top_ps, uniforms=u, sampled=True)
    _, g_samp, guide = guided_rows(cache.k.device, cfg.vocab_size, steps, 7)
    guided = dict(zip(("temps", "top_ks", "top_ps", "uniforms"), g_samp), sampled=True, guided=True,
                  **dict(zip(("guided_rows", "mask_pool", "next_pool"), guide)))
    fns = {
        "fused_window": lambda: llama.decode_multi_fused(params, cfg, cache.k, cache.v, *d_args, num_steps=steps),
        "fused_window_sampled": lambda: llama.decode_multi_fused(params, cfg, cache.k, cache.v, *d_args,
                                                                 num_steps=steps, **samp),
        "fused_window_guided": lambda: llama.decode_multi_fused(params, cfg, cache.k, cache.v, *d_args,
                                                                num_steps=steps, **guided),
        "decode_multi": lambda: llama.decode_multi(params, cfg, cache.k, cache.v, *d_args, *greedy, None, steps),
    }
    rows = {}
    for name, fn in fns.items():
        window_ms = cuda_ms(fn, iters=5, warmup=1)
        busy, n_ops = device_busy_ms(fn, runs=1)
        rows[name] = {"steps": steps, "window_ms": window_ms, "ms_per_step": window_ms / steps,
                      "host_enqueue_ms": host_enqueue_ms(fn, iters=3), "device_busy_ms": busy,
                      "device_idle_share": 1 - busy / window_ms, "device_ops": n_ops}
    lp = params["layers"]
    weights = [params["embed"], params.get("lm_head"), params["final_norm"]] + [lp[n] for n in WINDOW_WEIGHTS[3:]]
    kw = dict(num_steps=steps, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
              block_size=cfg.block_size, rms_eps=cfg.rms_norm_eps, theta=cfg.rope_theta)
    for name, sa in (("fused_window", ()), ("fused_window_sampled", (temps, top_ks, top_ps, u)),
                     ("fused_window_guided", (*g_samp, *guide))):
        phases = stamp_phases(weights, cache.k, cache.v, d_args, sa, kw, cfg.num_layers)
        rows[name]["profiled_ms_per_step"] = phases.pop("stamped_ms_per_step")
        rows[name]["phases_ms_per_step"] = phases
    # The spec window over the same rows: the model speculating with its own
    # weights (greedy), the draft's cache a copy of the target's after the
    # slot at pos - 1 holds xprev's K/V, as serving leaves it.
    from dynamo_tpu_torch.engine.attention import megakernel as mk

    R, G = SPEC_ROUNDS, SPEC_GAMMA
    tokens, positions, tables, active = d_args
    mk._cache_forward(tuple(weights), cache.k, cache.v, tokens.long(), positions.long() - 1, tables.long(),
                      active.bool(), num_heads=cfg.num_heads, rms_eps=cfg.rms_norm_eps, theta=cfg.rope_theta,
                      head=False)
    dk, dv = cache.k.clone(), cache.v.clone()
    unif = torch.full((R, B, 2 * G + 1), 0.5, device=cache.k.device)
    fn = lambda: llama.decode_spec_fused(params, cfg, params, cfg, cache.k, cache.v, dk, dv, tokens, tokens,  # noqa: E731
                                         positions, tables, tables, active, *greedy, unif, rounds=R, gamma=G)
    window_ms = cuda_ms(fn, iters=5, warmup=1)
    busy, n_ops = device_busy_ms(fn, runs=1)
    toks, acc, *_ = fn()
    confirmed = float((acc + 1).sum(0).float().mean())
    rows["spec_window"] = {"rounds": R, "gamma": G, "window_ms": window_ms, "ms_per_round": window_ms / R,
                           "confirmed_tokens_per_row": confirmed, "ms_per_confirmed_token": window_ms / confirmed,
                           "host_enqueue_ms": host_enqueue_ms(fn, iters=3), "device_busy_ms": busy,
                           "device_idle_share": 1 - busy / window_ms, "device_ops": n_ops}
    del dk, dv
    return rows


def graphed_rows(params, cfg, cache, d_args, p_tok, chunk, ctx, p_table) -> dict:
    """The breakdown's decode and mixed steps replayed as CUDA graphs
    (``engine/graphs.py``, as the scheduler runs them): step ms (events),
    host ms to stage and replay, device-busy ms and device operations
    (profiler), idle share, and the step's ratio to its device-busy ms;
    the host ms of the graph's launch alone beside the staging and launch."""
    from dynamo_tpu_torch.engine.graphs import StepGraphs

    g = StepGraphs(d_args[0].device)
    tokens, positions, tables, _ = (x.cpu().numpy() for x in d_args)
    tpa = np.stack([tokens, positions, np.ones_like(tokens)]).astype(np.int32)
    W = max(tables.shape[1], len(p_table))
    tables_m = np.pad(tables, ((0, 0), (0, W - tables.shape[1])))
    p_table_m = np.pad(p_table, (0, W - len(p_table)))
    p_tok_h = p_tok.cpu().numpy()
    fns = {"graphed decode": lambda: g.decode(params, cfg, cache, tpa, tables),
           "graphed mixed": lambda: g.mixed(params, cfg, cache, p_tok_h, chunk, ctx, p_table_m, tpa, tables_m)}
    rows = {}
    for name, fn in fns.items():
        fn()  # the capture
        graph = list(g._graphs.values())[-1].graph
        step_ms = cuda_ms(fn, iters=20)
        busy, n_ops = device_busy_ms(fn)
        rows[name] = {"step_ms": step_ms, "host_replay_ms": host_enqueue_ms(fn),
                      # The CUDA graph's launch alone, without the staging.
                      "host_graph_launch_ms": host_enqueue_ms(graph.replay), "device_busy_ms": busy,
                      "device_idle_share": 1 - busy / step_ms if busy else None, "device_ops": n_ops,
                      "step_over_busy": step_ms / busy if busy else None}
    return rows


def wave_breakdown(params, cfg, cache, rng) -> dict:
    """A wave admission's forward (``chunk_decode`` with each row's last
    logits) over ``WAVE_ROWS`` in S = 256 rows (two over a 1024-token cached
    prefix of the breakdown's random cache), eager and as the scheduler's
    wave graph: step ms (events), host ms to queue (or stage and replay)
    it, device-busy ms and operations (profiler), idle share."""
    from dynamo_tpu_torch.engine.graphs import StepGraphs
    from dynamo_tpu_torch.engine.models import llama

    dev = cache.k.device
    B, BS = len(WAVE_ROWS), cfg.block_size
    per_row = (1024 + WAVE_S) // BS + 1
    ids = (rng.permutation(cache.k.shape[1] - 1)[:B * per_row] + 1).astype(np.int32).reshape(B, per_row)
    tables = np.zeros((B, 96), np.int32)
    tables[:, :per_row] = ids
    toks = rng.integers(1, 255, size=(B, WAVE_S)).astype(np.int32)
    pos0 = np.array([p for p, _ in WAVE_ROWS], np.int32)
    valid = np.array([v for _, v in WAVE_ROWS], np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    args = tuple(t(a) for a in (toks, pos0, valid, tables))
    g = StepGraphs(dev)
    fns = {"wave eager": lambda: llama.chunk_decode(params, cfg, cache.k, cache.v, *args, last_logits=True),
           "wave graphed": lambda: g.wave(params, cfg, cache, toks, pos0, valid, tables)}
    rows = {}
    for name, fn in fns.items():
        fn()
        step_ms = cuda_ms(fn, iters=10)
        busy, n_ops = device_busy_ms(fn)
        rows[name] = {"rows": B, "S": WAVE_S, "tokens": int(valid.sum()), "step_ms": step_ms,
                      "host_enqueue_ms": host_enqueue_ms(fn, iters=5), "device_busy_ms": busy,
                      "device_idle_share": 1 - busy / step_ms if busy else None, "device_ops": n_ops}
    g.close()
    return rows


def spec_round_breakdown(params, cfg, dev) -> dict:
    """One per-round spec round of the serving scheduler (``_decode_spec``):
    llama-3.2-1b speculating with its own weights (γ = ``SPEC_GAMMA``, one
    decode step an iteration, so no fused spec window), 8 greedy rows at
    about 1024 tokens. After the rows are admitted and two rounds have
    captured the round's graphs, each of 5 ``step()`` calls is one round:
    ms (host clock around the step and a sync), tokens confirmed per row,
    ms per confirmed token (the fused spec window's: 6.10 at PR 12 F), and
    the device-busy ms of one more round."""
    from dynamo_tpu_torch.engine.sampling import SamplingParams
    from dynamo_tpu_torch.engine.scheduler import Scheduler, SchedulerConfig, StopConditions

    s = Scheduler(cfg, params, SchedulerConfig(num_blocks=1024, num_scheduler_steps=1), dtype=torch.bfloat16,
                  device=str(dev))
    s.attach_draft(cfg, params, gamma=SPEC_GAMMA)
    rng = np.random.default_rng(15)
    for i in range(8):
        s.add_request(str(i), rng.integers(1, cfg.vocab_size, size=1000 + 3 * i).tolist(),
                      SamplingParams(temperature=0.0), StopConditions(max_tokens=200, ignore_eos=True))
    while s.waiting or s.spec_rounds_total < 2:
        s.step()
    times, confirmed = [], []
    for _ in range(5):
        n0 = sum(len(q.output_ids) for q in s.running)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r0 = s.spec_rounds_total
        s.step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if s.spec_rounds_total != r0 + 1:
            raise AssertionError("a timed breakdown step was not one spec round")
        confirmed.append((sum(len(q.output_ids) for q in s.running) - n0) / len(s.running))
    busy, n_ops = device_busy_ms(s.step, runs=1)
    ms = statistics.median(times)
    per_row = statistics.mean(confirmed)
    res = {"rows": len(s.running), "gamma": SPEC_GAMMA, "round_ms": ms, "round_ms_runs": times,
           "confirmed_tokens_per_row": per_row, "ms_per_confirmed_token": ms / per_row,
           "fused_spec_ms_per_confirmed_token_pr12": 6.10, "device_busy_ms": busy,
           "device_idle_share": 1 - busy / ms, "device_ops": n_ops,
           "acceptance_rate": s.spec_stats.acceptance_rate}
    s.close()
    return res


def draw_breakdown(dev, V):
    """The per-step paths' draw (``sampling.sample_batch_device``, threefry
    gumbel noise over [B, V] plus the exact top-k/top-p thresholds): a first
    token (B = 1, T = 0.8, top-p 0.9) and a mixed step's 8 rows in
    ``SAMPLE_MIX``'s turn, eager and as the scheduler's draw graph (the 8
    rows also all-greedy, through the greedy graph). Event
    ms, host ms to queue it, device-busy ms, idle share and device
    operations per draw."""
    from dynamo_tpu_torch.engine import prng
    from dynamo_tpu_torch.engine.graphs import StepGraphs
    from dynamo_tpu_torch.engine.sampling import sample_batch_device

    logits = torch.randn((8, V), generator=torch.Generator(device=dev).manual_seed(9), device=dev)
    temps, top_ks, top_ps = (x.cpu().numpy() for x in sample_rows(8, 1, dev, 9)[:3])
    key = prng.PRNGKey(9)
    cases = {"first_token": (logits[:1], np.array([0.8], np.float32), np.zeros(1, np.int32),
                             np.array([0.9], np.float32)),
             "8_rows": (logits, temps, top_ks, top_ps)}
    rows = {}
    g = StepGraphs(dev)
    for name, (lg, t, k, p) in cases.items():
        runs = [("", lambda: sample_batch_device(lg, t, k, p, key)), ("graphed ", lambda: g.draw(lg, t, k, p, key))]
        if name == "8_rows":
            # An all-greedy batch: the greedy graph (no key), the argmax alone.
            runs.append(("graphed greedy ", lambda: g.draw(lg, t * 0, k, p, None)))
        for kind, fn in runs:
            ms = cuda_ms(fn, iters=10)
            busy, n_ops = device_busy_ms(fn, runs=1)
            rows[kind + name] = {"rows": lg.shape[0], "ms": ms, "host_enqueue_ms": host_enqueue_ms(fn, iters=5),
                                 "device_busy_ms": busy, "device_idle_share": 1 - busy / ms if busy else None,
                                 "device_ops": n_ops}
    return rows


def extras_draw_breakdown(dev, V):
    """An extras batch's post-forward work at ``EXTRAS_ROWS`` rows: the
    frequency/presence penalties over a 64-token history, then the draw with
    the chosen logprobs and the top alternatives
    (``sample_batch_top_logprobs``), eager as the scheduler runs it; the
    plain draw of the same rows beside it. Event ms, host ms to queue it,
    device-busy ms and device operations."""
    from dynamo_tpu_torch.engine import prng
    from dynamo_tpu_torch.engine.sampling import apply_penalties, sample_batch_device, sample_batch_top_logprobs

    logits, hist, hist_len, freq, pres = extras_inputs(dev, V, 23)
    temps, top_ks, top_ps = (x.cpu().numpy() for x in sample_rows(EXTRAS_ROWS, 1, dev, 23)[:3])
    key = prng.PRNGKey(23)
    runs = {
        "penalties+top_logprobs": lambda: sample_batch_top_logprobs(
            apply_penalties(logits, hist, hist_len, freq, pres), temps, top_ks, top_ps, key),
        "plain draw": lambda: sample_batch_device(logits, temps, top_ks, top_ps, key),
    }
    rows = {}
    for name, fn in runs.items():
        ms = cuda_ms(fn, iters=10)
        busy, n_ops = device_busy_ms(fn, runs=1)
        rows[name] = {"rows": EXTRAS_ROWS, "ms": ms, "host_enqueue_ms": host_enqueue_ms(fn, iters=5),
                      "device_busy_ms": busy, "device_idle_share": 1 - busy / ms if busy else None,
                      "device_ops": n_ops}
    return rows


def phase_breakdown(dev):
    """Time of one decode step and one mixed step of llama-3.2-1b in bf16
    (CUDA events, median of 20) on each attention path, the host time to
    queue it, and the share of it attention takes. On the per-piece path
    attention is split into the flash kernel, the paged kernel and the
    PyTorch glue around them (prefix gathers, the prefix partial, the
    in-register piece, merges). Event times include any wait for the
    host; ``device_busy_ms`` (torch.profiler) is the card's own work, and
    the rest of the step is the card waiting for the host. The same two
    steps of the int8 deployment (int8 KV and int8 weights, the megakernel
    path: its int8 branch, and each layer's weights dequantized), and on
    the megakernel paths both steps again as the scheduler's CUDA graphs
    (``graphed decode``/``graphed mixed``: host ms to stage and replay, and
    the step over its device-busy ms). Then one
    32-step window over the same 8 decode rows: fused greedy, fused
    sampled, fused guided, and the non-fused greedy ``decode_multi``; and
    the per-step paths' threefry draw, and an extras batch's penalties and
    top-logprobs draw."""
    from dynamo_tpu_torch.engine.attention import decode as pdk
    from dynamo_tpu_torch.engine.attention import megakernel as mk
    from dynamo_tpu_torch.engine.attention import prefill as fck
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.engine.quant import quantize_params
    from dynamo_tpu_torch.engine.scheduler import width_bucket
    from dynamo_tpu_torch.engine.weights import init_params

    base = get_config(PRESET)
    params = init_params(base, torch.Generator(device=dev).manual_seed(1), device=dev, dtype=torch.bfloat16)
    cache = KvCacheArrays.create(base, 2048, dtype=torch.bfloat16, device=dev)
    cache.k.normal_()
    cache.v.normal_()
    rng = np.random.default_rng(5)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    B, ctx, chunk, BS, steps = 8, 1024, 512, base.block_size, 32
    per_row = (ctx + steps) // BS + 1  # covers a window's writes
    ids = rng.permutation(np.arange(1, 2048)).astype(np.int32)
    W = width_bucket(per_row, 1 << 20)
    tables = np.zeros((B, W), np.int32)
    for i in range(B):
        tables[i, :per_row] = ids[i * per_row:(i + 1) * per_row]
    p_blocks = (ctx + chunk) // BS + 1
    p_table = np.zeros(width_bucket(p_blocks, 1 << 20), np.int32)
    p_table[:p_blocks] = ids[B * per_row:B * per_row + p_blocks]
    d_args = (t(rng.integers(1, 255, size=B).astype(np.int32)), t(np.full(B, ctx, np.int32)), t(tables),
              t(np.ones(B, bool)))
    p_tok = t(rng.integers(1, 255, size=chunk).astype(np.int32))
    p_tab = t(p_table)

    # The int8 deployment: the same weights quantized (a copy of the layer
    # dict, so ``params`` stays bf16), a random int8 cache of as many blocks.
    cfg8 = base.replace(kv_cache_dtype="int8", weight_dtype="int8")
    params8 = quantize_params(dict(params, layers=dict(params["layers"])))
    cache8 = KvCacheArrays.create(cfg8, 2048, device=dev)
    for c in (cache8.k, cache8.v):
        c.q.random_(-127, 128)
        c.scale.uniform_(0.005, 0.03)
    res = {"preset": PRESET, "dtype": "bfloat16", "decode_rows": B, "context": ctx, "chunk": chunk}
    for path, cfg, p_, c_ in (("megakernel", base, params, cache), ("paged+flash", base.replace(**PER_PIECE), params, cache),
                              ("int8 megakernel", cfg8, params8, cache8)):
        flash = dict(use_flash=True, has_prefix=True) if path == "paged+flash" else {}
        if path != "paged+flash":
            targets = {"attention": (mk, "ragged_paged_attention")}
        else:
            targets = {"chunk": (llama, "_chunk_attention"), "decode_rows": (llama, "_decode_rows_attention"),
                       "flash": (fck, "flash_chunk_attention"), "paged": (pdk, "paged_decode_partials")}

        def decode():
            llama.decode(p_, cfg, c_.k, c_.v, *d_args)

        def mixed():
            llama.mixed_step(p_, cfg, c_.k, c_.v, p_tok, chunk, ctx, p_tab, *d_args, **flash)

        rows = {}
        for name, fn in (("decode", decode), ("mixed", mixed)):
            step_ms = cuda_ms(fn, iters=20)
            runs = []
            for _ in range(5):
                with LaunchTimer(targets) as timer:
                    fn()
                runs.append({n: timer.ms(n) for n in targets})
            med = {n: statistics.median(r[n] for r in runs) for n in targets}
            busy, n_launch = device_busy_ms(fn)
            row = {"step_ms": step_ms, "host_enqueue_ms": host_enqueue_ms(fn), "device_busy_ms": busy,
                   "device_idle_share": 1 - busy / step_ms, "device_launches": n_launch}
            if path != "paged+flash":
                row.update(attention_ms=med["attention"], attention_launches=timer.count("attention"))
            else:
                attn = med["chunk"] + med["decode_rows"]
                row.update(attention_ms=attn, flash_ms=med["flash"], paged_ms=med["paged"],
                           glue_ms=attn - med["flash"] - med["paged"],
                           flash_launches=timer.count("flash"), paged_launches=timer.count("paged"))
            row["attention_share"] = row["attention_ms"] / step_ms
            rows[name] = row
        if path != "paged+flash":
            rows.update(graphed_rows(p_, cfg, c_, d_args, p_tok, chunk, ctx, p_table))
        res[path] = rows
    res["int8 resident"] = {"weights_bytes": tree_bytes(params8), "kv_cache_bytes": sum(
        t.numel() * t.element_size() for c in (cache8.k, cache8.v) for t in c)}
    del params8, cache8
    res["windows"] = window_breakdown(params, base, cache, d_args, steps)
    res["draw"] = draw_breakdown(dev, base.vocab_size)
    res["extras_draw"] = extras_draw_breakdown(dev, base.vocab_size)
    res["wave"] = wave_breakdown(params, base, cache, rng)
    res["spec_round"] = spec_round_breakdown(params, base, dev)
    emit("breakdown", **res)
    del params, cache
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 5: serving through the HTTP entry point
# ---------------------------------------------------------------------------


def _request(port: int, path: str, body: dict, on_first=None, timeout: float = 600, headers: Optional[dict] = None):
    """POST one request; returns (status, parsed body or SSE chunk list,
    seconds to the first content chunk or None, total seconds). A streamed
    request calls ``on_first()`` when its first content chunk arrives."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json", **(headers or {})})
    resp = conn.getresponse()
    if not body.get("stream"):
        data = json.loads(resp.read())
        conn.close()
        return resp.status, data, None, time.perf_counter() - t0
    chunks, first = [], None
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        payload = line[6:]
        if payload == b"[DONE]":
            chunks.append("[DONE]")
            break
        chunk = json.loads(payload)
        choice = (chunk.get("choices") or [{}])[0]
        if first is None and (choice.get("text") or (choice.get("delta") or {}).get("content")):
            first = time.perf_counter() - t0
            if on_first is not None:
                on_first()
        chunks.append(chunk)
    conn.close()
    return resp.status, chunks, first, time.perf_counter() - t0


def _answer_text(data, stream: bool, chat: bool) -> str:
    """The text of one answer (its SSE deltas joined when streamed)."""
    if not stream:
        choice = data["choices"][0]
        return choice["message"]["content"] if chat else choice["text"]
    parts = []
    for chunk in data[:-1]:
        choice = chunk["choices"][0]
        parts.append((choice.get("delta") or {}).get("content") or "" if chat else choice.get("text") or "")
    return "".join(parts)


def grammar_holds(body: dict, text: str, finish: str) -> bool:
    """A guided answer is in its grammar: the whole text matches it when
    the answer stopped, and is a prefix some match continues when it ran
    out of tokens (the port's own grammar compiler, as the server built
    the constraint)."""
    from dynamo_tpu_torch.llm.guided.grammar import build_guided_spec, compile_regex

    dfa = compile_regex(build_guided_spec(body)["pattern"])
    if finish == "stop":
        return dfa.match(text)
    state = dfa.start
    for c in text:
        state = dfa.step(state, c)
    return finish == "length" and state >= 0


def structured(body: dict) -> bool:
    """A request whose text a grammar constrains (``response_format`` or an
    ``nvext.guided_*`` constraint)."""
    return "response_format" in body or any(k.startswith("guided_") for k in body.get("nvext") or {})


def _summarize(status, data, stream):
    """(completion_tokens, finish_reason, cached_tokens) of one answer."""
    if status != 200:
        raise AssertionError(f"HTTP {status}: {data}")
    if stream:
        if data[-1] != "[DONE]":
            raise AssertionError("stream did not end in [DONE]")
        final = data[-2]
        usage = final["usage"]
        finish = final["choices"][0]["finish_reason"]
    else:
        usage = data["usage"]
        finish = data["choices"][0]["finish_reason"]
    cached = (usage.get("prompt_tokens_details") or {}).get("cached_tokens")
    return usage["completion_tokens"], finish, cached


SERVE_PASSES = ("megakernel", "paged+flash", "megakernel+windows", "spec", "int8", "spec-rounds", "extras")
# The spec passes' scheduler counters: fused spec windows, the tokens they
# emitted, per-round spec rounds, and the draft's prefill chunks; and the
# waves admitted (in forward and prefill steps too).
SPEC_COUNTERS = ("spec_fused_windows_total", "spec_fused_accepted_tokens_total", "spec_rounds_total",
                 "draft_prefill_steps_total", "wave_steps_total")
OVERLAP_COUNTERS = ("overlap_steps_total", "overlap_flushes_total")
# The context the megakernel passes' warmup captures the step graphs for
# (every prompt of the serve phase fits).
WARMUP_CTX = 2048
# The windows pass's seeded request: its prompt is shorter than one KV block.
SEEDED = {"prompt": "seeded draw", "max_tokens": 24, "temperature": 0.8, "seed": 4242}
# Structured outputs: a streamed greedy JSON-schema chat request and a
# greedy json_object one (the windows pass; json_object is the largest
# grammar served, 1734 FSM states, so its compile and its rows' upload are
# measured beside its neighbours' TTFT) and a sampled guided_choice
# completion (the windows and spec passes).
GUIDED_JSON = {"stream": True, "temperature": 0.0,
               "response_format": {"type": "json_schema", "json_schema": {"name": "weather", "schema": GUIDED_SCHEMA}}}
GUIDED_OBJECT = {"stream": True, "temperature": 0.0, "response_format": {"type": "json_object"}}
GUIDED_CHOICE = {"temperature": 0.9, "nvext": {"guided_choice": ["red", "green", "blue"]}}
# The extras pass: the byte its logit_bias forces, and the one tool its
# forced tool_choice calls (a finite grammar: the call always completes).
BIASED_BYTE = ord("q")
EXTRAS_TOOL = {"type": "function", "function": {"name": "get_city", "parameters": {
    "type": "object", "properties": {"city": {"enum": ["SF", "NY", "LA"]}, "ok": {"type": "boolean"}},
    "required": ["city", "ok"]}}}


def extras_requests(text) -> list:
    """The extras pass's burst, (kind, url, body): 2 greedy and 2 sampled
    plain requests (the first greedy one shares the penalised request's
    prompt), one greedy with ``logprobs`` and ``top_logprobs: 5``, one with
    frequency and presence penalties, one with a +100 ``logit_bias`` on one
    byte, one seeded sampled ``n: 3`` and one forced ``tool_choice``."""
    shared = text(90)
    return [
        ("plain", "/v1/completions", {"prompt": text(200)}),
        ("twin", "/v1/chat/completions", {"messages": [{"role": "user", "content": shared}], "stream": True}),
        ("plain", "/v1/chat/completions", {"messages": [{"role": "user", "content": text(60)}], "stream": True,
                                           "temperature": 0.8, "top_p": 0.9}),
        ("plain", "/v1/completions", {"prompt": text(120), "temperature": 1.0, "top_k": 50}),
        ("logprobs", "/v1/chat/completions", {"messages": [{"role": "user", "content": text(70)}], "logprobs": True,
                                              "top_logprobs": 5}),
        ("penalties", "/v1/chat/completions", {"messages": [{"role": "user", "content": shared}],
                                               "frequency_penalty": 1.0, "presence_penalty": 0.5}),
        ("bias", "/v1/completions", {"prompt": text(40), "logit_bias": {str(BIASED_BYTE): 100}}),
        ("n", "/v1/completions", {"prompt": text(50), "n": 3, "seed": 99, "temperature": 0.9,
                                  "nvext": {"ignore_eos": True}}),
        ("tool", "/v1/chat/completions", {"messages": [{"role": "user", "content": text(30)}],
                                          "tools": [EXTRAS_TOOL], "tool_choice": {
                                              "type": "function", "function": {"name": "get_city"}}}),
    ]


class RowRecorder:
    """Inside the ``with`` block, every token the scheduler appends for a row
    that asks for logprobs or penalties, or shares a penalised row's prompt:
    request id → {"prompt", "penalties", "tokens", "logprobs", "top"}."""

    def __init__(self, sched):
        self.sched, self.rows = sched, {}

    def __enter__(self):
        orig, rows = self.sched._append_token, self.rows
        self.orig = orig

        def append(seq, token, outputs, logprob=None, top_logprobs=None):
            if logprob is None:
                logprob, top = seq._pending_logprob, seq._pending_top_logprobs
            else:
                top = top_logprobs
            s = seq.sampling
            if s.logprobs or s.has_penalties or (s.temperature == 0 and not s.logits_processors and not seq.guided):
                r = rows.setdefault(seq.request_id, {"prompt": tuple(seq.prompt), "penalties": s.has_penalties,
                                                     "logprobs_row": bool(s.top_logprobs),
                                                     "tokens": [], "logprobs": [], "top": []})
                r["tokens"].append(token)
                r["logprobs"].append(logprob)
                r["top"].append(top)
            return orig(seq, token, outputs, logprob, top_logprobs)

        self.sched._append_token = append
        return self

    def __exit__(self, *exc):
        self.sched._append_token = self.orig


def extras_checks(reqs, results, rows) -> dict:
    """The extras pass's answers against its gates: every logprob finite and
    ≤ 0, each ``top_logprobs`` list 5 long and sorted, the greedy logprobs
    row's token its top-1 id and its logprob the top-1 logprob; the biased
    answer the biased byte repeated; three ``n`` choices of the requested
    length, not all equal; the tool call parsed into an OpenAI
    ``tool_calls`` entry whose arguments hold the tool's schema, finish
    reason ``tool_calls``. Also (no gate) the penalised row's distinct
    tokens beside its greedy twin's. Raises on a failed gate."""
    out, bad = {}, []
    for (kind, url, body), (status, data, _, _) in zip(reqs, results):
        if status != 200:
            raise AssertionError(f"extras {kind}: HTTP {status}: {data}")
        if kind == "bias":
            text, finish = data["choices"][0]["text"], data["choices"][0]["finish_reason"]
            out["bias"] = {"text": text[:16], "completion_tokens": data["usage"]["completion_tokens"]}
            if text != chr(BIASED_BYTE) * data["usage"]["completion_tokens"] or finish != "length":
                bad.append(("bias", text[:80], finish))
        elif kind == "n":
            texts = [c["text"] for c in data["choices"]]
            finishes = [c["finish_reason"] for c in data["choices"]]
            out["n"] = {"choices": len(texts), "finish": finishes, "completion_tokens": data["usage"]["completion_tokens"],
                        "distinct_texts": len(set(texts))}
            if (len(texts) != 3 or finishes != ["length"] * 3 or data["usage"]["completion_tokens"] != 3 * 64
                    or len(set(texts)) < 2 or [c["index"] for c in data["choices"]] != [0, 1, 2]):
                bad.append(("n", out["n"]))
        elif kind == "tool":
            choice = data["choices"][0]
            calls = choice["message"].get("tool_calls") or []
            out["tool"] = {"finish_reason": choice["finish_reason"], "tool_calls": calls}
            try:
                args = json.loads(calls[0]["function"]["arguments"])
                ok = (choice["finish_reason"] == "tool_calls" and calls[0]["type"] == "function"
                      and calls[0]["function"]["name"] == "get_city" and args["city"] in ("SF", "NY", "LA")
                      and isinstance(args["ok"], bool) and set(args) == {"city", "ok"})
            except (IndexError, KeyError, TypeError, ValueError):
                ok = False
            if not ok:
                bad.append(("tool", out["tool"]))
        elif kind == "logprobs":
            content = data["choices"][0]["logprobs"]["content"]
            if len(content) != data["usage"]["completion_tokens"]:
                bad.append(("logprobs entries", len(content), data["usage"]["completion_tokens"]))
    lp_rows = [r for r in rows.values() if r["logprobs_row"]]
    if len(lp_rows) != 1:
        raise AssertionError(f"expected one logprobs row among {len(rows)} recorded")
    r = lp_rows[0]
    lps = r["logprobs"]
    sorted_ok = all(len(t) == 5 and all(a[1] >= b[1] for a, b in zip(t, t[1:])) for t in r["top"])
    top1 = all(tok == t[0][0] and abs(lp - t[0][1]) <= 1e-6 for tok, lp, t in zip(r["tokens"], lps, r["top"]))
    out["logprobs"] = {"tokens": len(lps), "min": min(lps), "max": max(lps), "top_sorted_5": sorted_ok,
                       "chosen_is_top1": top1}
    if not (all(np.isfinite(x) and x <= 0 for x in lps) and sorted_ok and top1 and len(lps) > 0):
        bad.append(("logprobs", out["logprobs"]))
    pen = [r for r in rows.values() if r["penalties"]]
    twin = [r for r in rows.values() if not r["penalties"] and not r["logprobs_row"] and pen
            and r["prompt"] == pen[0]["prompt"]]
    out["penalties"] = {"distinct_tokens": len(set(pen[0]["tokens"])) if pen else None,
                        "twin_distinct_tokens": len(set(twin[0]["tokens"])) if twin else None,
                        "tokens": len(pen[0]["tokens"]) if pen else None,
                        "twin_tokens": len(twin[0]["tokens"]) if twin else None}
    if bad:
        raise AssertionError(f"the extras pass failed its gates: {bad}")
    return out


class PoolGrowth:
    """Inside the ``with`` block (the engine's build and warmup), the bytes
    the card's allocator reserved while each step graph was captured:
    ``summary()`` gives them summed by graph kind and the keys that grew
    the pool most."""

    def __enter__(self):
        from dynamo_tpu_torch.engine.graphs import StepGraphs

        self.cls, self.orig, self.growth = StepGraphs, StepGraphs.graph, {}
        growth, orig = self.growth, self.orig

        def graph(g, key, fields, body):
            if key in g or not g.on_card:
                return orig(g, key, fields, body)
            r0 = torch.cuda.memory_reserved(g.device)
            out = orig(g, key, fields, body)
            growth[key] = torch.cuda.memory_reserved(g.device) - r0
            return out

        StepGraphs.graph = graph
        return self

    def __exit__(self, *exc):
        self.cls.graph = self.orig

    def summary(self) -> dict:
        by_kind = {}
        for key, n in self.growth.items():
            by_kind[key[0]] = by_kind.get(key[0], 0) + n
        top = sorted(self.growth.items(), key=lambda kv: -kv[1])[:6]
        return {"by_kind_bytes": by_kind, "largest": [[list(map(str, k)), n] for k, n in top if n > 0]}


def phase_serve(card: str, path: str):
    """Serve ``PRESET`` through ``run.build_service`` on one path
    ("megakernel": the preset as it is; "paged+flash": the per-piece path;
    both pinned to one decode step per iteration; "megakernel+windows": the
    defaults, 32-step decode windows with the waiting cap at 8) and send it
    8 concurrent requests (the windows pass also a streamed greedy
    ``response_format: json_schema`` request, a greedy ``json_object`` one
    and a sampled ``nvext.guided_choice`` one, the spec pass the latter;
    the grammars compile while the others are served; each answer must
    hold its grammar: a full match when it stopped, a prefix of one when it
    ran out of tokens), then a repeat of the first. Every kernel's
    counts go to 0 just before the requests and are read just after: the
    path's kernels must have launched once per layer for each forward step
    that reaches them (the windows pass: the ragged kernel also once per
    layer for each step inside a non-fused window, and the fused window
    once per fused window, the sampled branch once per window with a
    sampled or guided row and the guided branch once per window with a
    guided row), no other kernel and no plain version at all. In the
    windows pass every window must be fused, the sampled and the guided
    requests' among them; then one seeded T = 0.8 request is sent twice, at batch slots 5
    and 6 behind greedy neighbours, and its two answers must be equal.
    "spec" is the windows pass with a llama-3.2-1b draft of the target's
    own weights (``--draft-model``, γ = 4, ``build_service(draft_params=)``):
    every batch speculates through the fused spec window (one launch per
    spec window; the draft's prefill chunks launch the ragged kernel too),
    except the seeded request's and the guided one's, which fall back to
    fused windows. "spec-rounds" is the spec pass at one decode step per
    iteration (no fused window, so no fused spec window): every batch
    without a seeded sampled or guided row speculates one round an
    iteration (``_decode_spec``: a draft ``chunk_decode`` pass, γ-1 draft
    ``decode_multi`` steps, a target ``chunk_decode`` verify, each
    launching the ragged kernel once a layer), the seeded request's and
    the guided one's batches single-step without the draft. "int8" serves
    with ``--kv-cache-dtype int8 --weight-dtype int8`` on the defaults: no fused window, so every step,
    the 32-step windows' too (``decode_multi``), launches the ragged
    kernel's int8 branch once per layer and nothing else; after the burst
    and the repeat, a 64-token prompt is sent while a request with the same
    prompt decodes, a full-cover prefix hit whose last block is copied on
    write (``_copy_block`` over the int8 codes and scales). Every pass but
    the per-piece one starts with ``--warmup-ctx 2048``: its step graphs
    are captured before traffic (the warmup's seconds, graphs and the
    bytes the allocator reserved for them are reported) and none may be
    captured after; replays credit their launches to the kernels' counts.
    Overlapped decode is on (the default): the 1-step megakernel pass must
    run the pipeline (``overlap_steps_total`` > 0); its steps count as
    decode forward steps. Without a draft, a burst of short prompts is
    admitted in waves (one ``chunk_decode`` pass, counted as a forward and
    prefill step; on the per-piece path it attends through the gather, as
    in JAX, and launches no kernel): the 1-step megakernel pass must admit
    at least one. "extras" serves the defaults (32-step windows, warmed up)
    with ``extras_requests``'s burst in place of the 8 requests: 2 greedy
    and 2 sampled plain ones, one with ``logprobs`` and ``top_logprobs``,
    one with penalties, one with a ``logit_bias``, one ``n = 3`` and one
    forced ``tool_choice``. Its window-eligible rows run fused windows
    while the extras rows single-step in the same iterations
    (``rowwise_windows_total`` ≥ 1, at most one per fused window), with
    the windows pass's launch gates, and ``extras_checks`` holds its
    answers."""
    from dynamo_tpu_torch import run
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.engine.spec_decode import SpecDecodeStats
    from dynamo_tpu_torch.engine.weights import init_params

    model_config = get_config(PRESET).replace(**PER_PIECE) if path == "paged+flash" else None
    rounds = path == "spec-rounds"
    spec, int8, extras = path in ("spec", "spec-rounds"), path == "int8", path == "extras"
    windows = path in ("megakernel+windows", "spec")
    scheduler_config = None if windows or int8 or extras else SchedulerConfig(num_scheduler_steps=1)
    extra = ["--draft-model", PRESET, "--spec-gamma", str(SPEC_GAMMA)] if spec else []
    if int8:
        extra = ["--kv-cache-dtype", "int8", "--weight-dtype", "int8"]
    if path != "paged+flash":
        # The megakernel path's steps are CUDA graphs: capture them before traffic.
        extra += ["--warmup-ctx", str(WARMUP_CTX)]
    args = run.parse_args(["in=http", f"out={PRESET}", "--http-host", "127.0.0.1", "--http-port", "0", *extra])
    # Self-speculation: the draft gets the weights the engine makes for the
    # target from the same seed.
    draft_params = init_params(get_config(PRESET), torch.Generator(device=args.device).manual_seed(args.seed),
                               device=torch.device(args.device), dtype=getattr(torch, args.dtype)) if spec else None
    rng = np.random.default_rng(11)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    text = lambda n: "".join(rng.choice(letters, size=n))  # noqa: E731
    long_a, long_b = text(1500), text(1480)
    reqs = [
        ("/v1/completions", {"prompt": long_a}),
        ("/v1/chat/completions", {"messages": [{"role": "user", "content": long_b}], "stream": True}),
        ("/v1/chat/completions", {"messages": [{"role": "user", "content": text(120)}], "stream": True}),
        ("/v1/chat/completions", {"messages": [{"role": "user", "content": text(60)}],
                                  "temperature": 0.8, "top_p": 0.9}),
        ("/v1/completions", {"prompt": text(32)}),
        ("/v1/completions", {"prompt": text(200)}),
        ("/v1/chat/completions", {"messages": [{"role": "system", "content": text(40)},
                                               {"role": "user", "content": text(90)}]}),
        ("/v1/completions", {"prompt": text(150)}),
    ]
    guided = []
    if windows or rounds:
        guided = [("/v1/completions", {"prompt": text(50), **GUIDED_CHOICE})]
        if not spec:
            guided[:0] = [("/v1/chat/completions", {"messages": [{"role": "user", "content": text(70)}], **GUIDED_JSON}),
                          ("/v1/chat/completions", {"messages": [{"role": "user", "content": text(30)}],
                                                    **GUIDED_OBJECT})]
    reqs += guided
    if extras:
        extras_kinds = extras_requests(text)
        reqs = [(url, body) for _, url, body in extras_kinds]
    for _, body in reqs:
        body.setdefault("temperature", 0.0)
        body.update(model=PRESET, max_tokens=64)

    async def serve():
        # An earlier pass's freed graph pool leaves the allocator's cache, so
        # this pass's warmup reads its own reserved bytes.
        gc.collect()
        torch.cuda.empty_cache()
        with PoolGrowth() as pool_growth:
            service, engine = run.build_service(args, model_config=model_config, scheduler_config=scheduler_config,
                                                draft_params=draft_params)
        sched = engine.scheduler
        if spec and not torch.equal(sched.draft_params["embed"], sched.params["embed"]):
            raise AssertionError("the spec pass's draft does not hold the target's weights")
        await service.start()
        try:
            kinds = ("forward", "prefill", "decode", "mixed")
            counters = WINDOW_COUNTERS + SPEC_COUNTERS + OVERLAP_COUNTERS + ("cow_blocks_total",
                                                                             "rowwise_windows_total")
            steps0 = {k: getattr(sched, f"{k}_steps_total") for k in kinds}
            steps0.update({k: getattr(sched, k) for k in counters})
            reset_counts()  # counts from zero, just before the main path runs
            t0 = time.perf_counter()
            # Only the extras pass records its rows: the other passes time
            # the path they timed before it, with no hook on each token.
            recorder = RowRecorder(sched) if extras else None
            with recorder if extras else contextlib.nullcontext():
                results = await asyncio.gather(
                    *[asyncio.to_thread(_request, service.port, path, body) for path, body in reqs]
                )
            wall = time.perf_counter() - t0
            repeat = await asyncio.to_thread(_request, service.port, *reqs[0])
            burst_forward = sched.forward_steps_total - steps0["forward"]
            fused0 = sched.fused_windows_total
            seeded = [await seeded_round(service.port, sched, n) for n in (5, 6)] if windows or rounds else []
            seeded_windows = sched.fused_windows_total - fused0
            cow = await cow_round(service.port, sched) if int8 else None
            counts = read_counts()
            steps = {k: getattr(sched, f"{k}_steps_total") - steps0[k] for k in kinds}
            steps.update({k: getattr(sched, k) - steps0[k] for k in counters})
            metrics = {**engine.stats(), "spec_decode": engine.metrics().spec_decode}
            impl = sched.config_snapshot()["model"]["attention_impl"]
            if sched.guided is not None and sched.guided.requests_total:
                pool = sched.guided.pool
                metrics["guided_pool"] = {
                    "capacity_rows": pool.capacity, "rows_in_use": pool.rows_in_use(),
                    "bytes": pool.device().numel() * 4 + pool.next_device().numel() * 4,
                    # Each grammar the server compiled: its FSM states and compile seconds.
                    "grammars": [{"pattern": fsm.pattern[:48], "states": fsm.num_states,
                                  "compile_s": fsm.compile_s, "register_s": register_seconds(fsm, pool)}
                                 for fsm in sched.guided.cache._d.values()]}
        finally:
            await service.stop()
            await engine.stop()
        graphs = {"warmup": sched.warmup_stats, "pool_growth": pool_growth.summary(),
                  "captures_total": sched.graph_captures_total,
                  "captures_after_warmup": sched.graph_captures_after_warmup,
                  "replays_total": sched._graphs.replays_total if sched._graphs is not None else 0}
        return (results, wall, repeat, seeded, burst_forward, counts, steps, metrics, sched.mc, impl,
                sched.sc.num_scheduler_steps, seeded_windows, cow, graphs, recorder.rows if extras else {})

    def register_seconds(fsm, pool):
        """Seconds the step loop spends writing ``fsm``'s rows into a fresh
        pool like the server's (the part of a new grammar's admission left
        on the step loop)."""
        from dynamo_tpu_torch.llm.guided.processor import GuidedMaskPool

        fresh = GuidedMaskPool(pool.vocab_size, min_rows=pool.capacity, device=pool.dev)
        fresh.device()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.register(fsm)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    async def seeded_round(port, sched, n):
        """``n`` greedy neighbours decoding (no EOS stop, longer than the
        seeded request), then ``SEEDED``, which joins at batch slot ``n``:
        its prefill rides a mixed step beside the neighbours' decode rows
        and its windows a batch of n + 1 rows; 5 and 6 neighbours give the
        same buckets (8 rows), so its per-row arithmetic is the same at
        either slot. Its prompt fills no KV block, so the second send does
        not hit the prefix cache. → (slot, answer)."""
        neighbour = {"model": PRESET, "max_tokens": 160, "temperature": 0.0, "nvext": {"ignore_eos": True}}
        futs = [asyncio.ensure_future(asyncio.to_thread(
            _request, port, "/v1/completions", {**neighbour, "prompt": text(40)})) for _ in range(n)]
        while sum(1 for seq in list(sched.running) if seq.output_ids) < n:
            await asyncio.sleep(0.002)
        slot = len(sched.running)
        answer = await asyncio.to_thread(_request, port, "/v1/completions", {**SEEDED, "model": PRESET})
        for status, data, _, _ in [answer, *await asyncio.gather(*futs)]:
            _summarize(status, data, False)
        return slot, answer

    async def cow_round(port, sched):
        """A request with a 64-token prompt (4 full blocks) decoding, then
        the same prompt again: every block matches, the last one is held
        by the first request, so the scheduler copies it before the second
        recomputes the last token. → (cached tokens of the second answer,
        blocks copied)."""
        cow0 = sched.cow_blocks_total
        prompt = text(64)
        first = asyncio.ensure_future(asyncio.to_thread(
            _request, port, "/v1/completions",
            {"model": PRESET, "prompt": prompt, "max_tokens": 96, "temperature": 0.0, "nvext": {"ignore_eos": True}}))
        while not any(seq.output_ids for seq in list(sched.running)):
            await asyncio.sleep(0.002)
        second = await asyncio.to_thread(_request, port, "/v1/completions",
                                         {"model": PRESET, "prompt": prompt, "max_tokens": 8, "temperature": 0.0})
        for status, data, _, _ in (second, await first):
            _summarize(status, data, False)
        return _summarize(*second[:2], False)[2], sched.cow_blocks_total - cow0

    (results, wall, repeat, seeded, burst_forward, counts, steps, metrics, mc, impl, sched_steps,
     seeded_windows, cow, graphs, rows) = asyncio.run(serve())
    answers, guided_answers = [], []
    for i, ((url, body), (status, data, first, total)) in enumerate(zip(reqs, results)):
        n, finish, cached = _summarize(status, data, body.get("stream", False))
        # The extras pass checks its own n, biased and tool answers.
        plain = not extras or extras_kinds[i][0] in ("plain", "twin", "logprobs", "penalties")
        if plain and n != 64 and finish != "stop":
            raise AssertionError(f"{url} gave {n} tokens with finish_reason {finish!r}")
        answers.append({"path": url, "stream": bool(body.get("stream")), "completion_tokens": n,
                        "finish_reason": finish, "ttft_s": first, "latency_s": total})
        if structured(body):
            said = _answer_text(data, bool(body.get("stream")), "chat" in url)
            guided_answers.append({"path": url, "stream": bool(body.get("stream")), "text": said,
                                   "finish_reason": finish, "in_grammar": grammar_holds(body, said, finish)})
    n_rep, finish_rep, cached_rep = _summarize(repeat[0], repeat[1], False)
    ttfts = [a["ttft_s"] for a in answers if a["ttft_s"] is not None]
    completion = sum(a["completion_tokens"] for a in answers)
    L = mc.num_layers
    if path == "megakernel":
        expected = {"ragged_paged_attention": L * steps["forward"]}
    elif int8:
        # No fused window: the 32-step windows run decode_multi, one launch
        # per layer and step, all on the int8 branch.
        expected = {"ragged_paged_attention_int8": L * (steps["forward"] + steps["window_steps_total"])}
    elif rounds:
        # Each round: the draft's chunk pass, its γ-1 window steps and the
        # target's verify; the draft (the same layer count) also prefills.
        expected = {"ragged_paged_attention": L * (steps["forward"] + steps["draft_prefill_steps_total"]
                                                   + (SPEC_GAMMA + 1) * steps["spec_rounds_total"])}
    elif windows or extras:
        # The draft (llama-3.2-1b: the same layer count) prefills through the ragged kernel too.
        expected = {"ragged_paged_attention": L * (steps["forward"] + steps["window_steps_total"]
                                                   + steps["draft_prefill_steps_total"]),
                    "fused_decode_window": steps["fused_windows_total"],
                    "fused_decode_window_sampled": steps["fused_sampled_windows_total"],
                    "fused_decode_window_guided": steps["fused_guided_windows_total"]}
        if spec:
            expected["fused_spec_window"] = steps["spec_fused_windows_total"]
    else:
        # A wave is a prefill step that, as in JAX, attends through the
        # gather on the per-piece path: no kernel.
        expected = {"flash_chunk_attention": L * (steps["prefill"] - steps["wave_steps_total"] + steps["mixed"]),
                    "paged_decode_partials": L * (steps["decode"] + steps["mixed"])}
    launches = {name: c["launches"] for name, c in counts.items()}
    want = {name: expected.get(name, 0) for name in launches}
    plain = sum(c["plain_calls"] for c in counts.values())
    res = {
        "card": card, "preset": PRESET, "path": path, "attention_impl": impl,
        "prefill_impl": mc.prefill_impl, "dtype": args.dtype, "num_blocks": args.num_blocks,
        "requests": len(answers) + 1, "answers": answers,
        "repeat": {"completion_tokens": n_rep, "finish_reason": finish_rep, "cached_tokens": cached_rep},
        "ttft_p50_s": statistics.median(ttfts), "ttft_n": len(ttfts),
        "decode_tok_per_s": completion / wall, "wall_s": wall, "wall_ms_per_token": 1e3 * wall / completion,
        "wall_ms_per_forward_step": 1e3 * wall / burst_forward, "steps": steps,
        "num_scheduler_steps": sched_steps,
        "kernel_launches": launches, "expected_launches": want, "plain_calls": plain,
        "mixed_steps_total": metrics["mixed_steps_total"], "cached_tokens_total": metrics["cached_tokens_total"],
        "overlap": {k: steps[k] for k in OVERLAP_COUNTERS}, "graphs": graphs,
    }
    if guided_answers:
        res["guided"] = guided_answers
        # Host seconds the server spent compiling the requests' grammars
        # (character DFA and token FSM over the 128,256-id vocabulary, in a
        # worker thread beside the step loop), the pools' size after them,
        # and the TTFT of the unguided requests served meanwhile.
        res["guided_stats"] = {k: metrics[k] for k in metrics if k.startswith("guided_")}
        unguided = [a["ttft_s"] for (_, body), a in zip(reqs, answers)
                    if a["ttft_s"] is not None and not structured(body)]
        res["ttft_unguided_p50_s"] = statistics.median(unguided) if unguided else None
    if windows or rounds:
        texts = [(a[1]["choices"][0]["text"], a[1]["usage"]["completion_tokens"]) for _, a in seeded]
        res["seeded"] = {"request": SEEDED, "slots": [slot for slot, _ in seeded], "answers": texts,
                         "identical": texts[0] == texts[1], "non_spec_windows": seeded_windows}
    if spec:
        res["spec_decode"] = metrics["spec_decode"]
        res["accepted_per_round"] = metrics["spec_decode"]["accepted_per_round"]
    if int8:
        res["kv_cache_dtype"], res["weight_dtype"] = mc.kv_cache_dtype, mc.weight_dtype
        res["copy_on_write"] = {"cached_tokens": cow[0], "blocks_copied": cow[1]}
    if extras:
        res["rowwise_windows_total"] = steps["rowwise_windows_total"]
        res["extras"] = extras_checks(extras_kinds, results, rows)
    emit("serve", **res)
    if path == "spec" and (not steps["spec_fused_windows_total"] or not seeded_windows
                           or set(metrics["spec_decode"]) != set(SpecDecodeStats().to_dict())):
        raise AssertionError(f"the spec pass ran no spec window, or the seeded request did not fall back, or "
                             f"its stats lack keys: {steps}, {seeded_windows}, {metrics['spec_decode']}")
    if rounds and (not steps["spec_rounds_total"] or steps["spec_fused_windows_total"] or not steps["decode"]
                   or set(metrics["spec_decode"]) != set(SpecDecodeStats().to_dict())):
        raise AssertionError(f"the spec-rounds pass ran no per-round spec round, or a fused spec window, or the "
                             f"seeded and guided rows did not single-step: {steps}, {metrics['spec_decode']}")
    if path == "megakernel" and not steps["wave_steps_total"]:
        raise AssertionError(f"the 1-step megakernel pass admitted no wave: {steps}")
    if not cached_rep:
        raise AssertionError("the repeated prompt did not hit the prefix cache")
    if steps["forward"] == 0 or any(expected[name] == 0 for name in expected):
        raise AssertionError(f"the {path} pass did not reach all of its kernels: {steps}")
    if launches != want:
        raise AssertionError(f"kernel launches {launches} != expected {want} over steps {steps}")
    if plain:
        raise AssertionError(f"serving called plain versions {plain} times: {counts}")
    if (windows or extras) and (steps["multi_windows_total"] or not steps["fused_sampled_windows_total"]
                                or not steps["fused_guided_windows_total"]):
        raise AssertionError(f"the {path} pass ran a non-fused window, or no sampled or guided fused one: {steps}")
    if extras and not 1 <= steps["rowwise_windows_total"] <= launches["fused_decode_window"]:
        raise AssertionError(f"the extras pass ran no fused window beside its extras rows (row-wise "
                             f"fallback): {steps}, fused window launches {launches['fused_decode_window']}")
    if not extras and steps["rowwise_windows_total"]:
        raise AssertionError(f"the {path} pass, with no extras rows, ran a row-wise window: {steps}")
    if path != "paged+flash" and graphs["captures_after_warmup"] != 0:
        raise AssertionError(f"the {path} pass captured graphs after its warmup: {graphs}")
    if path == "megakernel" and not steps["overlap_steps_total"]:
        raise AssertionError(f"the 1-step megakernel pass ran no overlapped decode step: {steps}")
    if int8 and (steps["fused_windows_total"] or not steps["multi_windows_total"] or cow != (63, 1)):
        raise AssertionError(f"the int8 pass ran a fused window, no decode_multi window, or its repeat did not "
                             f"copy the shared block: {steps}, copy-on-write {cow}")
    if not all(a["in_grammar"] for a in guided_answers):
        raise AssertionError(f"a guided answer left its grammar: {guided_answers}")
    if (windows or rounds) and not (res["seeded"]["identical"]
                                    and res["seeded"]["slots"][0] != res["seeded"]["slots"][1]):
        raise AssertionError(f"the seeded request's answers at two batch slots differ: {res['seeded']}")
    return res


# ---------------------------------------------------------------------------
# distributed: control plane, two workers and the frontend as processes
# ---------------------------------------------------------------------------

DIST_WARMUP_CTX = 2048  # the serve passes' warmup: every step graph of the traffic captured first
DIST_PER_FAMILY = 4
DIST_COUNTERS_MARK = "worker launch counters: "
# The observability plane on the deployment: every request traced, SLO
# targets that the traffic meets on TTFT and misses on TPOT (so both verdict
# families show), and one traced one-token probe (no TPOT: goodput).
DIST_SLO_TTFT_MS = 1000.0
DIST_SLO_TPOT_MS = 0.1
DIST_TRACE_ID = "5eed" * 8
DIST_TRACEPARENT = f"00-{DIST_TRACE_ID}-{'7ace' * 4}-01"
# The frontend families the deployment's traffic makes (item 18's; the
# migration and no-instance counters appear at their first event, as in the
# JAX service: the in-process migration frontend holds migrations_total).
FRONTEND_FAMILIES = (
    "requests_total", "inflight_requests", "time_to_first_token_seconds", "inter_token_latency_seconds",
    "request_duration_seconds", "queue_time_seconds", "output_tokens_total", "input_tokens_total",
    "input_cached_tokens_total", "request_timeouts_total", "slo_attained_total", "slo_violated_total",
    "goodput_requests_total", "goodput_tokens_total", "goodput_requests_per_s", "goodput_tokens_per_s",
    "ttft_seconds", "ttft_seconds_quantile", "tpot_seconds", "tpot_seconds_quantile", "request_seconds",
    "request_seconds_quantile",
)
PLANE_PHASES = ("prefill", "decode", "mixed", "wave")
# The black box on the deployment: each LM worker writes incident bundles
# and its captures under the phase's log directory and samples the card
# every 5 s for 0.1 s (2 % duty, the sampler's cap); the bursts bill two
# tenants by family; a metrics aggregator scrapes the workers every 0.5 s.
DIST_TENANTS = ("smoke-a", "smoke-b")
DIST_PROFILE_INTERVAL_S = 5.0
DIST_PROFILE_WINDOW_S = 0.1
DIST_ON_DEMAND_S = 0.5
DIST_HOST_SAMPLE_S = 0.2
DIST_AGG_INTERVAL_S = 0.5
# A steady stream on both workers after the repeats, long enough for each
# sampler to open a window on traffic (one a 5 s interval, past an incident
# capture of 2 s).
DIST_STEADY_S = DIST_PROFILE_INTERVAL_S + 3.0
# The aggregator's scrape waits this long for a worker that does not answer
# (runtime/client.Client.scrape_stats): a SIGKILLed worker drops out of the
# scrape after it.
DIST_SCRAPE_TIMEOUT_S = 2.0
# The serving path's kernels as the profiler names them.
RAGGED_SYMBOL = "ragged_bf16_kernel"
FUSED_SYMBOL = "fused_window_kernel"


def _http_get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http_post(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    try:
        return resp.status, json.loads(body)
    except ValueError:
        return resp.status, {"raw": body[:300].decode("latin-1")}


def _tenant_headers(fam: dict) -> dict:
    return {"x-dynamo-tenant": fam["tenant"]} if fam.get("tenant") else {}


def _decode_steps(state: dict) -> list:
    """A worker's recent decode steps from its ``/debug/state``: (start
    age s, end age s, duration s) before the state was read."""
    return [(st["age_s"] + st["dur_s"], st["age_s"], st["dur_s"]) for st in state["flight"]["recent_steps"]
            if st["phase"] == "decode"]


def _window_ages(state: dict) -> list:
    """The device profiler's recent windows as (start age s, end age s,
    window) before the state was read."""
    prof = state["incidents"]["profiler"]
    return [(prof["now"] - w["start"], prof["now"] - w["end"], w) for w in prof["windows"]]


async def steady_load(port: int, families: list, seconds: float) -> list:
    """Each family's burst requests again, one at a time per family (with
    its tenant), for ``seconds``: the samplers' windows fall on traffic.
    → the answers."""
    deadline = time.monotonic() + seconds

    async def one_family(fam):
        out, i = [], 0
        while time.monotonic() < deadline:
            (res,) = await _send(port, [fam["burst"][i % len(fam["burst"])]], [_tenant_headers(fam)])
            out.append(_answer_of(res))
            i += 1
        return out

    return [a for answers in await asyncio.gather(*(one_family(f) for f in families)) for a in answers]


async def on_demand_captures(port: int) -> dict:
    """A worker's ``POST /debug/profile`` while the bursts run: the device
    window and the host sampler at once (a continuous window holding the
    profiler answers 409: the device capture is asked again)."""
    await asyncio.sleep(0.15)  # the bursts' first requests are in
    host = asyncio.ensure_future(asyncio.to_thread(_http_post, port,
                                                   f"/debug/profile?kind=host&seconds={DIST_HOST_SAMPLE_S}"))
    busy, deadline = 0, time.monotonic() + 3.0
    while True:
        device = await asyncio.to_thread(_http_post, port, f"/debug/profile?seconds={DIST_ON_DEMAND_S}")
        if device[0] != 409 or time.monotonic() > deadline:
            break
        busy += 1
        await asyncio.sleep(0.02)
    return {"device": device, "host": await host, "busy_answers": busy}


def capture_check(capture: dict, state: dict) -> tuple:
    """``worker_0``'s on-demand captures during its burst: the device one
    answered 200 ``ok`` and its trace parses with the port's
    ``load_trace_dir``: one device lane, the ragged kernel launched, the
    fused window kernel launched where a decode window started inside the
    capture, busy time within the kernels' span; the host one answered 200
    with a frame of the step loop. Its decode steps (the flight recorder's
    ring) inside and outside the profiler's windows. → (summary, checks)."""
    from dynamo_tpu_torch.runtime.profiling import load_trace_dir

    (status, body), (hstatus, hbody) = capture["device"], capture["host"]
    checks, out = [], {"status": status, "busy_answers": capture["busy_answers"],
                       "capture": {k: body.get(k) for k in ("status", "seconds", "window_s")}}
    summary = load_trace_dir(body["path"]) if status == 200 and body.get("status") == "ok" else None
    if summary is None:
        checks.append(f"on-demand capture: {status} {body}")
    else:
        windows = [w for _, _, w in _window_ages(state) if w["path"] == body["path"]]
        held = 0
        if windows:
            (start, end, _), = [a for a in _window_ages(state) if a[2]["path"] == body["path"]]
            held = sum(1 for s0, _, _ in _decode_steps(state) if end <= s0 <= start)
        ragged, fused = summary.launch_count(RAGGED_SYMBOL), summary.launch_count(FUSED_SYMBOL)
        out.update(device_lane_found=summary.device_lane_found, device_lanes=summary.device_lanes,
                   kernel_events=summary.kernel_events, device_time_us=summary.device_time_us,
                   wall_us=summary.wall_us, ragged_launches=ragged, fused_window_launches=fused,
                   decode_windows_started_inside=held, top_kernels=summary.top(5), truncated=summary.truncated)
        if not (summary.device_lane_found and summary.device_lanes == 1):
            checks.append(f"on-demand capture: device lanes {summary.device_lanes}, found {summary.device_lane_found}")
        if ragged <= 0 or (held and fused < 1):
            checks.append(f"on-demand capture: {ragged} ragged launches, {fused} fused window launches with "
                          f"{held} decode windows started inside it")
        if summary.device_time_us > summary.wall_us * 1.0 + 1e-6:
            checks.append(f"on-demand capture: device time {summary.device_time_us} us > wall {summary.wall_us} us")
    frames = [f["frame"] for f in hbody.get("top", [])]
    out["host"] = {"status": hstatus, "samples": hbody.get("samples"), "scheduler_share": hbody.get("scheduler_share"),
                   "top_frames": frames[:5]}
    if hstatus != 200 or not any("dynamo_tpu_torch/engine/" in f for f in frames):
        checks.append(f"host profile: {hstatus}, no frame of the step loop in {frames[:8]}")
    # Decode steps that overlapped a profiler window against the others.
    wins = _window_ages(state)
    inside, outside = [], []
    for s0, e0, dur in _decode_steps(state):
        (inside if any(e0 <= st and s0 >= en for st, en, _ in wins) else outside).append(dur * 1e3)
    out["decode_step_ms"] = {"in_a_capture_p50": statistics.median(inside) if inside else None,
                             "n_in": len(inside), "outside_p50": statistics.median(outside) if outside else None,
                             "n_out": len(outside)}
    return out, checks


def black_box_check(name: str, stats: dict, runs: dict, state: dict, log_text: str) -> tuple:
    """A worker's black box at its scrape before the kill: the cost model
    calibrated (its FLOPs a token beside the analytical count, from the
    worker's log), at least one measured window, each continuous window
    that held fused windows with one fused kernel launch each, the
    measured fractions of the windows with kernels within (0, 1.05], no
    graph captured after warmup and no such incident, every request
    finished billed once. → (summary, checks)."""
    import re

    checks = []
    cal = re.search(r"cost model calibrated by FlopCounterMode: (\S+) flops/token \(analytical (\S+)\)", log_text)
    windows = [w for _, _, w in _window_ages(state) if w["label"] == "continuous"]
    measured = [w for w in windows if w.get("kernel_events")]
    fused = [w for w in windows if w.get("fused_windows")]
    prof = state["incidents"]["profiler"]
    out = {"cost_model_calibrated": stats.get("cost_model_calibrated"),
           "flops_per_token": {"calibrated": float(cal.group(1)) if cal else None,
                               "analytical": float(cal.group(2)) if cal else None},
           "measured_windows_total": stats.get("measured_windows_total", 0),
           "last_window": {k: stats.get(k) for k in ("measured_mfu", "measured_hbm_frac", "measured_device_frac",
                                                     "measured_modeled_mfu_ratio", "measured_top_kernel_share",
                                                     "measured_launches_per_fused_window")},
           "modeled": {k: stats.get(k) for k in ("mfu_decode", "hbm_frac_decode", "mfu_prefill", "hbm_frac_prefill")},
           "windows_with_kernels": [{**{k: w.get(k) for k in ("fused_windows", "fused_kernel_launches",
                                                              "kernel_events", "device_time_s", "measured_mfu",
                                                              "measured_hbm_frac", "measured_device_frac",
                                                              "measured_modeled_mfu_ratio", "aligned")},
                                     "open_s": w["end"] - w["start"]} for w in measured],
           "fused_windows_in_windows": [(w["fused_windows"], w.get("fused_kernel_launches")) for w in fused],
           "duty_cycle": {"configured": stats.get("device_profile_duty_cycle"),
                          "effective": (sum(w["end"] - w["start"] for w in windows)
                                        / max(prof["now"] - windows[0]["start"], 1e-9)) if windows else None},
           "first_start_s": prof["first_start_s"], "captures_total": prof["captures_total"],
           "profiler_capture_conflicts_total": stats.get("profiler_capture_conflicts_total"),
           "device_profile": {k: stats.get(k) for k in ("device_profile_windows_total",
                                                        "device_profile_skipped_busy_total",
                                                        "device_profile_errors_total")},
           "tenant_bills_total": stats.get("tenant_bills_total"), "requests": runs["steps"]["request_total"],
           "incidents_total": stats.get("incidents_total"),
           "incident_bundles": [(b["reason"], b["status"]) for b in state["incidents"]["bundles"]]}
    if stats.get("cost_model_calibrated") != 1.0 or cal is None:
        checks.append(f"{name}: cost_model_calibrated {stats.get('cost_model_calibrated')}, log line {bool(cal)}")
    if not stats.get("measured_windows_total") or not measured:
        checks.append(f"{name}: {stats.get('measured_windows_total')} measured windows, {len(measured)} with kernels")
    bad = [(w["fused_windows"], w.get("fused_kernel_launches")) for w in fused
           if w.get("fused_kernel_launches") != w["fused_windows"]]
    if bad:
        checks.append(f"{name}: launches_per_fused_window not 1 in windows (fused windows, launches) {bad}")
    fracs = [(w.get("measured_hbm_frac", 0), w.get("measured_device_frac", 0)) for w in measured]
    if not fracs or not all(0 < h <= 1.05 and 0 < d <= 1.05 for h, d in fracs):
        checks.append(f"{name}: measured (hbm_frac, device_frac) of the windows with kernels {fracs}")
    if stats.get("compiles_after_warmup_total") != 0 or stats.get("incidents_post_warmup_compile_total") != 0:
        checks.append(f"{name}: compiles_after_warmup_total {stats.get('compiles_after_warmup_total')}, "
                      f"incidents_post_warmup_compile_total {stats.get('incidents_post_warmup_compile_total')}")
    if stats.get("tenant_bills_total") != runs["steps"]["request_total"]:
        checks.append(f"{name}: tenant_bills_total {stats.get('tenant_bills_total')} != "
                      f"{runs['steps']['request_total']} requests")
    return out, checks


def tenant_check(base: dict, after: dict, families: list, answers: list, holders: list) -> tuple:
    """The plane's traffic billed by tenant: each family's requests (probe,
    burst, repeat) carry its tenant, and each family's worker (the one
    holding its prefix) bills its tokens: per tenant, the billed output
    tokens risen over both workers (all on the holder) equal the
    completion tokens the clients counted, and per tenant the TTFT
    verdicts of the ledger count its requests. → (summary, checks)."""
    checks, out = [], {}
    rose = {w: after[w]["tenant_billed_output_tokens_total"] - base[w]["tenant_billed_output_tokens_total"]
            for w in after}

    def judged(stats, tenant):
        slo = (stats.get("tenant_ledger") or {}).get("slo", {}).get(tenant, {})
        return sum(slo.get(kind, {}).get("ttft", 0) for kind in ("attained", "violated"))

    for f, fam in enumerate(families):
        tokens = sum(a["completion_tokens"] for a in answers[f])
        billed = rose[holders[f]]
        requests = sum(judged(after[w], fam["tenant"]) - judged(base[w], fam["tenant"]) for w in after)
        out[fam["tenant"]] = {"client_tokens": tokens, "billed_tokens": billed, "worker": f"{holders[f]:x}",
                              "requests": len(answers[f]), "ledger_requests": requests}
        if billed != tokens or requests != len(answers[f]):
            checks.append(f"tenant {fam['tenant']}: billed {billed} tokens and {requests} requests, the clients "
                          f"counted {tokens} and {len(answers[f])}")
    if sum(rose.values()) != sum(sum(a["completion_tokens"] for a in ans) for ans in answers):
        checks.append(f"billed output tokens rose {rose} over both workers, the clients counted "
                      f"{[sum(a['completion_tokens'] for a in ans) for ans in answers]}")
    return out, checks


def aggregator_check(port: int, plane_stats: dict) -> tuple:
    """The aggregator's ``/metrics`` after the traffic: it parses, carries
    both tenants' fleet families and the fleet TTFT digest whose count is
    the workers' summed (polled for up to 10 scrape intervals: the
    aggregator scrapes on its own clock), and no worker lost yet. →
    (summary, checks)."""
    from dynamo_tpu_torch.runtime.metrics import parse_text
    from dynamo_tpu_torch.runtime.telemetry import LatencyDigest

    want = sum(LatencyDigest.from_wire(s["digests"]["ttft"]["total"]).count for s in plane_stats.values())
    deadline = time.monotonic() + 10 * DIST_AGG_INTERVAL_S
    while True:
        status, body = _http_get(port, "/metrics")
        fams = parse_text(body.decode()) if status == 200 else {}
        fleet = fams.get("dynamo_component_fleet_ttft_seconds", {"samples": []})["samples"]
        count = next((v for n, _, v in fleet if n.endswith("_count")), None)
        if count == want or time.monotonic() > deadline:
            break
        time.sleep(DIST_AGG_INTERVAL_S / 2)
    tenants = {}
    for fam in ("dynamo_component_tenant_device_seconds_total", "dynamo_component_tenant_queue_seconds_total"):
        for n, lab, v in fams.get(fam, {"samples": []})["samples"]:
            if n.endswith("_total"):
                tenants.setdefault(lab.get("tenant"), {})[fam.split("tenant_")[1]] = v
    lost = next((v for n, _, v in fams.get("dynamo_component_fleet_incidents_worker_lost_total", {"samples": []})
                 ["samples"] if n.endswith("_total")), None)
    checks = []
    if status != 200 or count != want or not set(DIST_TENANTS) <= set(tenants) or lost != 0:
        checks.append(f"aggregator /metrics: {status}, fleet TTFT count {count} (workers {want}), tenants "
                      f"{sorted(t for t in tenants if t)}, worker_lost {lost}")
    return {"status": status, "families": len(fams), "fleet_ttft_count": count, "workers_ttft_count": want,
            "tenants": tenants}, checks


def worker_lost_check(port: int, bundle_dir, killed_at: float, victim: str, survivor: str) -> tuple:
    """After the worker's SIGKILL: the aggregator's fleet ``worker_lost``
    counter reads 1 within 3 scrape intervals past the scrape timeout, and
    its incident directory holds one bundle that parses and names the lost
    instance. → (summary, checks)."""
    from pathlib import Path

    from dynamo_tpu_torch.runtime.metrics import parse_text

    deadline = killed_at + 3 * DIST_AGG_INTERVAL_S + DIST_SCRAPE_TIMEOUT_S
    lost = None
    while True:
        fams = parse_text(_http_get(port, "/metrics")[1].decode())
        lost = next((v for n, _, v in fams.get("dynamo_component_fleet_incidents_worker_lost_total",
                                                 {"samples": []})["samples"] if n.endswith("_total")), None)
        if lost or time.time() > deadline + 10:
            break
        time.sleep(0.1)
    bundles = sorted(Path(bundle_dir).glob("incident_*.json"))
    bundle = json.loads(bundles[0].read_text()) if len(bundles) == 1 else {}
    state = bundle.get("debug_state") or {}
    latency = bundle["ts"] - killed_at if bundle else None
    checks = []
    if lost != 1 or len(bundles) != 1 or bundle.get("reason") != "worker_lost":
        checks.append(f"aggregator: worker_lost {lost}, bundles {[b.name for b in bundles]}")
    elif state.get("lost_instances") != [victim] or set(state.get("last_scrape", {})) != {survivor}:
        checks.append(f"aggregator: the worker_lost bundle names {state.get('lost_instances')} (lost) and "
                      f"{sorted(state.get('last_scrape', {}))} (scraped), the killed worker is {victim}")
    elif latency > deadline - killed_at:
        checks.append(f"aggregator: worker_lost captured {latency:.3f} s after the kill, over "
                      f"{deadline - killed_at:.1f} s")
    return {"worker_lost_total": lost, "bundles": [b.name for b in bundles], "kill_to_bundle_s": latency,
            "lost_instances": state.get("lost_instances"), "detail": bundle.get("detail")}, checks


def capture_cost_probe(port: int, engine) -> dict:
    """In process, on an engine no window has opened on: one request at a
    time (a prompt of its own), the decode windows' ms before the first
    capture; a 0.2 s capture on the idle engine (its start's cost); the
    same requests after the last. Its prefix blocks are cleared after."""
    body = {"model": PRESET, "max_tokens": 64, "temperature": 0.0, "stream": True,
            "messages": [{"role": "system", "content": "Charlie. " + "capture probe " * 4},
                         {"role": "user", "content": "how much does a capture cost?"}]}
    flight = engine.scheduler.flight

    def decode_ms(n: int) -> list:
        t0 = time.monotonic()
        for _ in range(n):
            _request(port, "/v1/chat/completions", body)
        return [d * 1e3 for ts, ph, d, _ in list(flight.recent_steps) if ts >= t0 and ph == "decode"]

    before = decode_ms(4)
    res = engine.profiler.capture(0.2, label="probe")
    after = decode_ms(4)
    engine.scheduler.allocator.clear_cached()
    return {"decode_window_ms_p50": {"before_first_capture": statistics.median(before) if before else None,
                                     "after_last_capture": statistics.median(after) if after else None},
            "windows": [len(before), len(after)], "capture": res.get("status"),
            "start_s": engine.profiler.status()["first_start_s"]}


def frontend_metrics_check(port: int, n200: int) -> tuple:
    """``/metrics`` of the frontend process: 200, it parses, every family of
    ``FRONTEND_FAMILIES`` is there, and ``requests_total`` summed over
    ``status="200"`` is the ``n200`` answers this script got through it. →
    (summary, checks)."""
    from dynamo_tpu_torch.runtime.metrics import parse_text

    status, body = _http_get(port, "/metrics")
    fams = parse_text(body.decode()) if status == 200 else {}
    missing = [f for f in FRONTEND_FAMILIES if "dynamo_frontend_" + f not in fams]
    by_status = {}
    for n, lab, v in fams.get("dynamo_frontend_requests_total", {"samples": []})["samples"]:
        if n.endswith("_total"):
            by_status[lab["status"]] = by_status.get(lab["status"], 0) + v
    quant = {lab["quantile"]: v for n, lab, v in fams.get("dynamo_frontend_ttft_seconds_quantile", {"samples": []})
             ["samples"]}
    checks = []
    if status != 200 or missing:
        checks.append(f"frontend /metrics: status {status}, missing families {missing}")
    if by_status.get("200") != n200:
        checks.append(f"frontend requests_total by status {by_status}, but {n200} answers were 200")
    return {"families": len(fams), "requests_total": by_status, "ttft_quantiles_s": quant}, checks


def worker_health_check(port: int, ttft_wire: dict) -> tuple:
    """A worker's health port: ``/health`` 200 and ready, ``/live`` 200,
    ``/metrics`` 200 with the engine's TTFT digest as the
    ``dynamo_component_ttft_seconds`` histogram, its count that of the
    scrape's digest (``ttft_wire``), and ``/debug/state`` with the plane's
    keys. → (summary, checks)."""
    from dynamo_tpu_torch.runtime.metrics import parse_text
    from dynamo_tpu_torch.runtime.telemetry import LatencyDigest

    ttft_count = LatencyDigest.from_wire(ttft_wire).count
    out, checks = {}, []
    for path in ("/health", "/live", "/metrics", "/debug/state"):
        status, body = _http_get(port, path)
        out[path] = status
        if status != 200:
            checks.append(f"health port {port}: {path} answered {status}")
        elif path == "/health" and json.loads(body)["status"] != "ready":
            checks.append(f"health port {port}: /health not ready: {body[:300]!r}")
        elif path == "/metrics":
            fam = parse_text(body.decode()).get("dynamo_component_ttft_seconds")
            count = next((v for n, _, v in fam["samples"] if n.endswith("_count")), None) if fam else None
            out["ttft_histogram_count"] = count
            if count != ttft_count:
                checks.append(f"health port {port}: /metrics ttft histogram count {count}, the scrape's {ttft_count}")
        elif path == "/debug/state":
            keys = set(json.loads(body))
            out["debug_state_keys"] = sorted(keys)
            if not {"digests", "slo", "flight", "watchdog"} <= keys:
                checks.append(f"health port {port}: /debug/state keys {sorted(keys)}")
    return out, checks


def plane_check(name: str, stats: dict, runs: dict, L: int) -> tuple:
    """A worker's stats scrape against its kernel counters line, taken at
    the same moment: no graph captured after warmup, the scrape's fused
    windows the fused kernel's launches, one a window, as the
    ``fused_window_pallas_launches`` gauge reads too, and the
    ragged kernel's launches L × the forwards the recorder's steps imply
    (``PERF.md``: Σ phase steps − fused windows − decode_multi windows +
    their steps + overlapped pipelines' flushes); the decode roofline
    fractions in (0, 1.05]. → (summary, checks)."""
    from dynamo_tpu_torch.runtime.telemetry import LatencyDigest

    k, steps = runs["kernels"], runs["steps"]
    recorded = {ph: stats.get(f"step_{ph}_steps_total", 0) for ph in PLANE_PHASES}
    forwards = (sum(recorded.values()) - stats.get("fused_windows_total", 0) - steps["multi_windows_total"]
                + steps["window_steps_total"] + stats["overlap_flushes_total"])
    checks = []
    if stats["compiles_after_warmup_total"] != 0:
        checks.append(f"{name}: compiles_after_warmup_total {stats['compiles_after_warmup_total']}")
    if stats.get("fused_windows_total") != k["fused_decode_window"]["launches"]:
        checks.append(f"{name}: fused_windows_total {stats.get('fused_windows_total')} != "
                      f"{k['fused_decode_window']['launches']} fused window launches")
    # The gauge is the fused kernel's own launches in the last window: it
    # must be the wrapper's launches a window over the run, and that is 1.
    windows = stats.get("fused_windows_total", 0)
    per_window = k["fused_decode_window"]["launches"] / windows if windows else None
    if not (stats.get("fused_window_pallas_launches") == per_window == 1):
        checks.append(f"{name}: fused_window_pallas_launches {stats.get('fused_window_pallas_launches')}, "
                      f"fused kernel launches a window {per_window}")
    if k["ragged_paged_attention"]["launches"] != L * forwards:
        checks.append(f"{name}: ragged launches {k['ragged_paged_attention']['launches']} != {L} × {forwards} "
                      f"(recorded steps {recorded})")
    if not (0 < stats.get("mfu_decode", 0) <= 1.05 and 0 < stats.get("hbm_frac_decode", 0) <= 1.05):
        checks.append(f"{name}: mfu_decode {stats.get('mfu_decode')}, hbm_frac_decode {stats.get('hbm_frac_decode')}")
    steps_q = {}
    for ph in PLANE_PHASES:
        wire = (stats.get("digests") or {}).get(f"{ph}_step")
        if wire:
            d = LatencyDigest.from_wire(wire["total"])
            steps_q[ph] = {"count": d.count, "p50_ms": d.quantile(0.5) * 1e3, "p99_ms": d.quantile(0.99) * 1e3}
    ttft = LatencyDigest.from_wire(stats["digests"]["ttft"]["total"])
    return {"roofline": {k2: v for k2, v in stats.items() if k2.startswith(("mfu_", "hbm_frac_"))},
            "recorded_steps": recorded, "forwards": forwards,
            "ragged_launches": k["ragged_paged_attention"]["launches"], "step_quantiles": steps_q,
            "ttft_digest_s": {"p50": ttft.quantile(0.5), "p99": ttft.quantile(0.99), "count": ttft.count},
            "slo": {k2: stats.get(k2) for k2 in ("slo_ttft_attained_total", "slo_tpot_violated_total",
                                                  "goodput_requests_total")}}, checks


def trace_check(records: dict) -> tuple:
    """The traced probe in the flushed files: the frontend's and one
    worker's hold its trace id; the frontend has http_request and route,
    the worker worker_handle, parented by the frontend's span, and the
    scheduler's queued, admitted, first_token and finish; the port's
    chrome_trace converts them. → (summary, checks)."""
    from dynamo_tpu_torch.runtime.tracing import chrome_trace

    mine = {name: [r for r in recs if r.get("trace_id") == DIST_TRACE_ID] for name, recs in records.items()}
    front = mine.get("frontend", [])
    served = [n for n, recs in mine.items() if any(r["name"] == "worker_handle" for r in recs)]
    checks = []
    if not {"http_request", "route"} <= {r["name"] for r in front} or len(served) != 1:
        checks.append(f"trace: frontend records {sorted(r['name'] for r in front)}, workers with a span {served}")
        return {}, checks
    worker = mine[served[0]]
    names = {r["name"] for r in worker}
    http = next(r for r in front if r["name"] == "http_request")
    span = next(r for r in worker if r["name"] == "worker_handle")
    if not {"queued", "admitted", "first_token", "finish"} <= names or span["parent_id"] != http["span_id"]:
        checks.append(f"trace: worker records {sorted(names)}, worker span parent {span['parent_id']} "
                      f"(http span {http['span_id']})")
    ct = chrome_trace(front + worker)
    if not {"X", "i"} <= {e["ph"] for e in ct["traceEvents"]}:
        checks.append("trace: chrome_trace lost its spans or events")
    return {"serving_worker": served[0], "frontend_records": sorted(r["name"] for r in front),
            "worker_records": sorted(names), "chrome_events": len(ct["traceEvents"])}, checks


def trace_overhead_us(path, n: int = 20000) -> dict:
    """Host µs of one span begin/end and of one scheduler ``_trace_event``,
    with a tracer on (a file, every trace sampled), ring-only (no file: the
    CLIs' default, the incident bundles' trace evidence) and off."""
    from types import SimpleNamespace

    from dynamo_tpu_torch.engine.scheduler import Scheduler
    from dynamo_tpu_torch.runtime.tracing import Tracer

    out = {}
    for mode, tracer, trace in (("on", Tracer(path=str(path), sample=1.0, service="bench", ring_size=256),
                                 (DIST_TRACE_ID, "7ace" * 4)),
                                ("ring", Tracer(path=None, sample=1.0, service="bench", ring_size=256),
                                 (DIST_TRACE_ID, "7ace" * 4)),
                                ("off", Tracer(path=None, sample=0.0), None)):
        fake = SimpleNamespace(tracer=tracer)
        seq = SimpleNamespace(trace=trace, request_id="r")
        t0 = time.perf_counter()
        for _ in range(n):
            tracer.span("probe", DIST_TRACE_ID, parent_id="7ace" * 4, service="bench").end()
        t1 = time.perf_counter()
        for _ in range(n):
            Scheduler._trace_event(fake, seq, "first_token", ttft_s=0.1, cached_tokens=0)
        t2 = time.perf_counter()
        tracer.flush()
        out[mode] = {"span_us": (t1 - t0) / n * 1e6, "trace_event_us": (t2 - t1) / n * 1e6}
    return out


def dist_traffic() -> list:
    """Two families of chat requests, each behind a system prompt of about
    1000 tokens (distinct from the first byte, so the families share no
    block): per family a probe, a burst of ``DIST_PER_FAMILY`` requests
    with their own user messages, and a repeat of the burst's first
    request. Greedy, 64 tokens, streamed. Each family bills its own tenant
    (``DIST_TENANTS``, sent as ``x-dynamo-tenant``)."""
    rng = np.random.default_rng(23)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    text = lambda n: "".join(rng.choice(letters, size=n))  # noqa: E731
    systems = ["Alpha. " + text(993), "Bravo. " + text(993)]

    def chat(family: int, user: str) -> dict:
        return {"model": PRESET, "max_tokens": 64, "temperature": 0.0, "stream": True,
                "messages": [{"role": "system", "content": systems[family]}, {"role": "user", "content": user}]}

    families = []
    for f in range(2):
        burst = [chat(f, text(48)) for _ in range(DIST_PER_FAMILY)]
        families.append({"probe": chat(f, text(40)), "burst": burst, "repeat": dict(burst[0]),
                         "tenant": DIST_TENANTS[f]})
    return families


def _answer_of(result) -> dict:
    status, data, first, total = result
    n, finish, cached = _summarize(status, data, True)
    if n != 64 and finish != "stop":
        raise AssertionError(f"an answer gave {n} tokens with finish_reason {finish!r}")
    return {"text": _answer_text(data, True, True), "completion_tokens": n, "finish_reason": finish,
            "cached_tokens": cached, "ttft_s": first, "latency_s": total}


async def _send(port: int, bodies: list, headers: Optional[list] = None) -> list:
    """``bodies`` at once (``headers``: each one's extra headers)."""
    headers = headers or [None] * len(bodies)
    return await asyncio.gather(*[asyncio.to_thread(_request, port, "/v1/chat/completions", b, None, 600, h)
                                  for b, h in zip(bodies, headers)])


async def _first_token(first: threading.Event, task) -> None:
    """Until a request's first token is back (or it ended without one)."""
    while not first.is_set() and not task.done():
        await asyncio.sleep(0.001)


async def _family_burst(port: int, bodies: list, headers: Optional[dict] = None) -> tuple:
    """A family's burst: its first request, then, once that one's first
    token is back, the others at once. They mostly reach the engine while
    the first one's decode window runs, and the engine then admits them in
    one wave at its end, on either path: the same steps of the same rows,
    so the same bf16 roundings and the same greedy text. (Sent all at once,
    the first would start alone or not by a race, and bf16 products round
    by the step's shape.) ``headers`` go with each request. → (results,
    each other request's ms from the first one's first token to its own)."""
    firsts = [threading.Event() for _ in bodies]

    def send(i: int):
        return asyncio.ensure_future(asyncio.to_thread(_request, port, "/v1/chat/completions", bodies[i],
                                                       firsts[i].set, 600, headers))

    tasks = [send(0)]
    await _first_token(firsts[0], tasks[0])
    t0 = time.perf_counter()
    tasks += [send(i) for i in range(1, len(bodies))]
    seen = []
    for first, task in zip(firsts[1:], tasks[1:]):
        await _first_token(first, task)
        seen.append((time.perf_counter() - t0) * 1e3)
    return list(await asyncio.gather(*tasks)), seen


async def _bursts(port: int, families: list) -> tuple:
    """Every family's burst at once (8 requests, 4 a family, each with its
    family's tenant) → (answers in family order, wall s, each family's
    follow-ups' first-token ms)."""
    t0 = time.perf_counter()
    done = await asyncio.gather(*[_family_burst(port, fam["burst"], _tenant_headers(fam)) for fam in families])
    answers = [_answer_of(r) for results, _ in done for r in results]
    return answers, time.perf_counter() - t0, [seen for _, seen in done]


def _burst_summary(answers: list, wall: float) -> dict:
    ttfts = [a["ttft_s"] for a in answers if a["ttft_s"] is not None]
    tokens = sum(a["completion_tokens"] for a in answers)
    return {"requests": len(answers), "completion_tokens": tokens, "wall_s": wall, "decode_tok_per_s": tokens / wall,
            "ttft_p50_s": statistics.median(ttfts), "ttft_max_s": max(ttfts)}


class _Children:
    """A phase's processes, each writing its output to a log file under
    ``build/chip_smoke/<phase>`` (git-ignored). ``stop`` sends SIGTERM
    and waits; ``kill`` (in a ``finally``) ends whatever still runs."""

    def __init__(self, root, env, phase: str = "distributed"):
        self.root, self.env, self.procs = root, env, {}
        self.logs = root / "build" / "chip_smoke" / phase
        self.logs.mkdir(parents=True, exist_ok=True)

    def start(self, name: str, module: str, *args: str) -> None:
        log = open(self.logs / f"{name}.log", "w")
        self.procs[name] = (subprocess.Popen([sys.executable, "-m", module, *args], cwd=str(self.root), env=self.env,
                                             stdout=log, stderr=subprocess.STDOUT, text=True), log)

    def text(self, name: str) -> str:
        return (self.logs / f"{name}.log").read_text()

    def alive(self) -> None:
        for name, (proc, _) in self.procs.items():
            if proc.poll() is not None:
                raise AssertionError(f"{name} exited with {proc.returncode}: {self.text(name)[-3000:]}")

    def wait_for(self, name: str, needle: str, timeout_s: float) -> str:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            self.alive()
            for line in self.text(name).splitlines():
                if needle in line:
                    return line
            time.sleep(0.2)
        raise AssertionError(f"{name}: {needle!r} not seen in {timeout_s} s: {self.text(name)[-3000:]}")

    def stop(self, name: str) -> int:
        proc, log = self.procs[name]
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=120)
        log.close()
        return code

    def kill_one(self, name: str) -> None:
        """SIGKILL one process, which then leaves the ones ``alive`` checks
        (its log stays readable)."""
        proc, log = self.procs.pop(name)
        proc.kill()
        proc.wait()
        log.close()

    def snapshot(self, name: str, mark: str, timeout_s: float = 60) -> None:
        """SIGUSR1 to a worker, then until its log holds one more ``mark``
        line (the worker logs its launch counters and serves on)."""
        n = self.text(name).count(mark)
        self.procs[name][0].send_signal(signal.SIGUSR1)
        deadline = time.monotonic() + timeout_s
        while self.text(name).count(mark) <= n:
            self.alive()
            if time.monotonic() > deadline:
                raise AssertionError(f"{name}: no {mark!r} line {timeout_s} s after SIGUSR1")
            time.sleep(0.05)

    def kill(self) -> None:
        for proc, log in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


# ---------------------------------------------------------------------------
# distributed, the rest of the engine's and router's surface: run's text and
# batch modes against dyn://, the router's options, the capacity dial, the
# host library against pure Python, and a worker killed mid-stream
# ---------------------------------------------------------------------------

DIST_RUN_TOKENS = 32  # the run modes' and the dial bursts' max_tokens
DIST_MIGRATE_TOKENS = 64
# Characters of: the batch prompts, the text line, each prefill-counter and
# dial burst prompt, the killed pair's system prompt and each user message.
DIST_CHARS = {"run": 160, "text": 60, "count": 1500, "dial": 300, "system": 993, "user": 48}
DIST_HASH_RUNS = {"native": 400, "python": 40}
DIST_SHARDS = 4
# The migration frontend's overlap weight (``--kv-overlap-score-weight``):
# at 4 a request whose prefix a busy worker holds goes there, so the pair to
# be killed shares one worker.
DIST_MIGRATE_OVERLAP_WEIGHT = 4.0


def dist_surface_traffic() -> dict:
    """Seeded prompts of this part, each new to both workers' caches (their
    first blocks differ from every earlier prompt's)."""
    rng = np.random.default_rng(29)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    text = lambda n: "".join(rng.choice(letters, size=n))  # noqa: E731
    c = DIST_CHARS
    return {
        "run_prompts": [f"Run {i}. " + text(c["run"]) for i in range(4)],
        "text_line": "Delta. " + text(c["text"]),
        "count_prompts": [f"Echo {i}. " + text(c["count"]) for i in range(4)],
        "dial_prompts": [[f"Fox {j}.{i}. " + text(c["dial"]) for i in range(4)] for j in range(2)],
        "system": "Charlie. " + text(c["system"]),
        "users": [text(c["user"]) for _ in range(4)],
    }


def dial_applied(f: float, budget: int, chunk: int, slots: int, block: int) -> dict:
    """The capacity dial's applied values for a worker configured with this
    mixed budget, chunk, slot cap and block size: the JAX scheduler's rule
    (``dynamo_tpu/engine/scheduler.py`` ``set_capacity_dial``), which the
    CPU tests hold the port's scheduler against."""
    f = min(1.0, max(0.0, float(f)))
    b = max(block, min(int(round(2.0 * f * budget)), chunk))
    s = max(1, min(slots, int(round(2.0 * (1.0 - f) * slots))))
    return {"prefill_fraction": f, "mixed_prefill_budget": b, "decode_slots": s}


class PushRecorder:
    """Wraps a router's ``push.generate``: per dispatch, its context id,
    worker, request, token ids, ``cached_tokens`` and first-frame time."""

    def __init__(self, router):
        self.attempts: list = []
        orig = router.push.generate

        async def generate(request, context=None, *, instance_id=None):
            rec = {"ctx": context.id if context is not None else None, "worker": instance_id,
                   "request": json.loads(json.dumps(request)), "tokens": [], "cached": None, "first_t": None}
            self.attempts.append(rec)
            async for item in orig(request, context, instance_id=instance_id):
                data = item.data if hasattr(item, "data") else item
                if isinstance(data, dict):
                    if data.get("token_ids"):
                        rec["first_t"] = rec["first_t"] or time.perf_counter()
                        rec["tokens"] += list(data["token_ids"])
                    if data.get("cached_tokens") is not None and rec["cached"] is None:
                        rec["cached"] = int(data["cached_tokens"])
                yield item

        router.push.generate = generate


async def _drain_pipeline(pipeline, body: dict) -> str:
    from dynamo_tpu_torch.runtime.engine import Context

    parts = []
    async for item in pipeline.generate(body, Context()):
        data = item.data if hasattr(item, "data") else item
        if isinstance(data, dict) and data.get("text"):
            parts.append(data["text"])
    return "".join(parts)


async def surface_run_modes(root, env, surface: dict) -> dict:
    """``python -m dynamo_tpu_torch.run in=batch:<file> out=dyn://...`` with
    the 4 batch prompts, then ``in=text`` with one line on stdin, as
    processes against the phase's workers (greedy, ``DIST_RUN_TOKENS``)."""
    out_dir = root / "build" / "chip_smoke" / "distributed"
    src, dst = out_dir / "prompts.jsonl", out_dir / "results.jsonl"
    src.write_text("".join(json.dumps({"prompt": p}) + "\n" for p in surface["run_prompts"]))
    common = ["--model-name", PRESET, "--max-tokens", str(DIST_RUN_TOKENS), "--temperature", "0", "--timeout", "60"]

    def run(args, stdin=None):
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "dynamo_tpu_torch.run", args[0], "out=dyn://dynamo.backend.generate", *args[1:],
               *common]
        res = subprocess.run(cmd, cwd=str(root), env=env,
                             input=stdin, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise AssertionError(f"run {args[0]} exited with {res.returncode}: {res.stderr[-3000:]}")
        return res.stdout, time.perf_counter() - t0

    _, batch_s = await asyncio.to_thread(run, [f"in=batch:{src}", "--output", str(dst)])
    batch = [json.loads(line) for line in dst.read_text().splitlines()]
    out, text_s = await asyncio.to_thread(run, ["in=text"], surface["text_line"] + "\n")
    banner = f"interactive chat with {PRESET}; ctrl-d to exit\n> "
    if not out.startswith(banner) or not out.endswith("\n> "):
        raise AssertionError(f"in=text printed {out[:200]!r}")
    return {"batch": batch, "text": out[len(banner):-len("\n> ")], "batch_s": batch_s, "text_s": text_s}


async def surface_routers(client, families: list, holders: list, surface: dict) -> dict:
    """Three router configurations over the phase's workers, in this
    process: ``num_indexer_shards`` shards and two ``track_prefill_counters``
    routers (exact KV events), then ``use_kv_events=False``. Each serves
    both families' probe and repeat; a prefill-counter burst goes through
    the two counting routers at once."""
    from dynamo_tpu_torch.llm.entrypoint import build_routed_pipeline
    from dynamo_tpu_torch.llm.kv_router import KvPushRouter, KvRouterConfig
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor, PromptFormatter
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.llm.tokens import compute_block_hashes

    tok = ByteTokenizer()
    pre = OpenAIPreprocessor(tok, PromptFormatter(None))
    bs = get_block_size()
    card = ModelDeploymentCard(name=PRESET)
    checks, res = [], {}

    async def serve(router, rec, body):
        """One request through ``router``: (worker, cached_tokens)."""
        n = len(rec.attempts)
        await _drain_pipeline(build_routed_pipeline(tok, router, card), body)
        # The router frees the request's load when its stream's generator
        # closes, in a task the loop runs next (as between a client's
        # requests); the next request is scheduled after it.
        await asyncio.sleep(0.05)
        (att,) = rec.attempts[n:]
        return att["worker"], att["cached"] or 0

    async def families_through(name, router, rec, holder_of):
        out = []
        for f, fam in enumerate(families):
            probe = await serve(router, rec, fam["probe"])
            repeat = await serve(router, rec, fam["repeat"])
            want = holder_of(f, probe[0])
            out.append({"probe_worker": f"{probe[0]:x}", "repeat_worker": f"{repeat[0]:x}",
                        "repeat_cached_tokens": repeat[1], "holder": f"{want:x}"})
            if repeat[0] != want or repeat[1] <= 0:
                checks.append(f"{name}: family {f}'s repeat went to {repeat[0]:x} with cached_tokens {repeat[1]}, "
                              f"not to {want:x} with a prefix hit")
        return out

    t0 = time.perf_counter()
    sharded = await KvPushRouter.create(client, KvRouterConfig(block_size=bs, num_indexer_shards=DIST_SHARDS))
    counting = [await KvPushRouter.create(client, KvRouterConfig(block_size=bs, track_prefill_counters=True))
                for _ in range(2)]
    try:
        events = await _settled(lambda: [r.indexer.events_applied for r in (sharded, *counting)])
        sharded.indexer.flush()
        prompts = [pre.preprocess(fam[k])[0].token_ids for fam in families for k in ("probe", "repeat")]
        prompts += [pre.preprocess(b)[0].token_ids for fam in families for b in fam["burst"]]
        scores = [(sharded.indexer.find_matches(compute_block_hashes(p, bs)).scores,
                   counting[0].indexer.find_matches(compute_block_hashes(p, bs)).scores) for p in prompts]
        res["sharded_vs_plain"] = {"events": events, "prompts": len(prompts),
                                   "scores_equal": all(a == b for a, b in scores),
                                   "plain_scores": [{f"{w:x}": s for w, s in b.items()} for _, b in scores[:4]]}
        if not res["sharded_vs_plain"]["scores_equal"] or not any(b for _, b in scores):
            checks.append(f"the sharded router's overlap scores differ from the plain indexer's: {scores}")
        recs = {"sharded": PushRecorder(sharded), "count_a": PushRecorder(counting[0]),
                "count_b": PushRecorder(counting[1])}
        holder = lambda f, _probe: holders[f]  # noqa: E731 (exact events: the worker that holds the family)
        res["sharded"] = await families_through("sharded", sharded, recs["sharded"], holder)
        res["counting"] = [await families_through(f"count_{i}", r, recs[f"count_{'ab'[i]}"], holder)
                           for i, r in enumerate(counting)]
        # A burst of fresh prompts, half through each counting router, all
        # at once: while they wait for their first tokens, each router's
        # counters must hold the other's pending prefill tokens.
        bodies = [{"model": PRESET, "prompt": p, "max_tokens": 8, "temperature": 0.0}
                  for p in surface["count_prompts"]]
        seen = [0, 0]
        ids = client.instance_ids()
        tasks = [asyncio.ensure_future(_drain_pipeline(build_routed_pipeline(tok, counting[i // 2], card), b))
                 for i, b in enumerate(bodies)]
        while not all(t.done() for t in tasks):
            for i, r in enumerate(counting):
                seen[i] = max(seen[i], sum(r.prefill_counters.pending_tokens(w) for w in ids))
            await asyncio.sleep(0.001)
        await asyncio.gather(*tasks)
        await asyncio.sleep(0.2)
        after = [sum(r.prefill_counters.pending_tokens(w) for w in ids) for r in counting]
        res["prefill_counters"] = {"max_pending_seen": seen, "after": after,
                                   "burst_tokens": [len(pre.preprocess(b)[0].token_ids) for b in bodies]}
        if not all(seen) or any(after):
            checks.append(f"the counting routers did not see each other's pending prefills: seen {seen}, "
                          f"left after the burst {after}")
    finally:
        for r in (sharded, *counting):
            await r.close()
    approx = await KvPushRouter.create(client, KvRouterConfig(block_size=bs, use_kv_events=False))
    try:
        if approx.subscriber is not None:
            checks.append("the approximate router subscribed to the KV events")
        rec = PushRecorder(approx)
        res["approx"] = await families_through("approx", approx, rec, lambda _f, probe: probe)
    finally:
        await approx.close()
    res["seconds"] = time.perf_counter() - t0
    return res, checks


async def _settled(counts) -> int:
    """Until the indexers' ``counts()`` of applied KV events are all equal,
    non-zero and unchanged 0.2 s apart (no traffic runs meanwhile)."""
    last = None
    for _ in range(300):
        now = counts()
        if len(set(now)) == 1 and now == last and now[0]:
            return now[0]
        last = now
        await asyncio.sleep(0.2)
    raise AssertionError(f"the indexers never caught up with the KV events: {last}")


def get_block_size() -> int:
    from dynamo_tpu_torch.engine.config import get_config

    return get_config(PRESET).block_size


def _raw_request(text: str, max_tokens: int) -> dict:
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    return {"token_ids": ByteTokenizer().encode(text), "sampling_options": {"temperature": 0.0},
            "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}


async def surface_dial(drt, client, wid: int, surface: dict) -> tuple:
    """``set_dial`` to one worker at 0.9, then 0.5, each followed by a burst
    of 4 fresh requests sent to that worker: the reply and the scraped
    ``elastic_*`` keys against ``dial_applied`` for the worker's
    configuration, and the first-token counters' rise against the burst."""
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.runtime import msgpack_codec
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.push_router import PushRouter, RouterMode

    inst = client.instances[wid]
    push = PushRouter(client, RouterMode.DIRECT)
    checks, steps = [], []
    # The worker's configured split, which the dial's 0.5 leaves as it is.
    base = (await client.scrape_stats())[wid]
    keys = ("elastic_prefill_fraction", "elastic_prefill_budget", "elastic_decode_slots", "elastic_dial_changes_total")
    if (base["elastic_prefill_fraction"], base["elastic_dial_changes_total"]) != (0.5, 0):
        checks.append(f"before the dial: {[base[k] for k in keys]}")
    chunk = SchedulerConfig().max_prefill_chunk  # the worker CLI's

    async def one(req):
        t0, first, n = time.perf_counter(), None, 0
        async for item in push.generate(req, Context(), instance_id=wid):
            if item.data and item.data.get("token_ids"):
                first = first or time.perf_counter() - t0
                n += len(item.data["token_ids"])
        return first, n

    for j, f in enumerate((0.9, 0.5)):
        msg = await drt.bus.request(inst.control_subject, msgpack_codec.packb({"op": "set_dial", "prefill_fraction": f}),
                                    timeout=30)
        reply = msgpack_codec.unpackb(msg.data)
        want = dial_applied(f, base["elastic_prefill_budget"] or chunk, chunk, base["elastic_decode_slots"],
                            get_block_size())
        before = (await client.scrape_stats())[wid]
        t0 = time.perf_counter()
        done = await asyncio.wait_for(
            asyncio.gather(*(one(_raw_request(p, DIST_RUN_TOKENS)) for p in surface["dial_prompts"][j])), 180)
        wall = time.perf_counter() - t0
        after = (await client.scrape_stats())[wid]
        rise = {k: after[k] - before[k] for k in ("first_tokens_total", "queue_wait_seconds_total",
                                                  "prefill_wait_seconds_total")}
        ttfts = [d[0] for d in done]
        step = {"fraction": f, "reply": reply, "want": want, "stats": {k: before[k] for k in keys},
                "burst_tokens": [d[1] for d in done], "burst_wall_s": wall, "ttft_s": ttfts, "rise": rise}
        steps.append(step)
        if reply != want:
            checks.append(f"set_dial {f}: replied {reply}, the rule gives {want}")
        if [before[k] for k in keys[:3]] != [want["prefill_fraction"], want["mixed_prefill_budget"],
                                             want["decode_slots"]] or before[keys[3]] != j + 1:
            checks.append(f"set_dial {f}: the stats read {[before[k] for k in keys]}")
        waits = rise["queue_wait_seconds_total"] + rise["prefill_wait_seconds_total"]
        if (any(d[1] != DIST_RUN_TOKENS for d in done) or rise["first_tokens_total"] != len(done)
                or rise["prefill_wait_seconds_total"] <= 0 or rise["queue_wait_seconds_total"] < 0
                or waits > sum(ttfts)):
            checks.append(f"set_dial {f}: the burst gave {[d[1] for d in done]} tokens; the counters rose by "
                          f"{rise} against TTFTs summing to {sum(ttfts)} s")
    return steps, checks


async def surface_native(drt, families: list, surface: dict) -> tuple:
    """The host library against the pure-Python path (``DYN_NATIVE=0``) on
    this machine's host: block hashes of the phase's prompts, the median
    time to hash one family request both ways, and a native and a
    pure-Python tree fed the phase's whole KV-event stream."""
    import os

    from dynamo_tpu_torch import native
    from dynamo_tpu_torch.llm.kv_router.indexer import KvIndexer, NativeRadixTree, RadixTree
    from dynamo_tpu_torch.llm.kv_router.publisher import kv_events_stream_name
    from dynamo_tpu_torch.llm.kv_router.subscriber import KvRouterSubscriber
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor, PromptFormatter
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.llm.tokens import compute_block_hashes

    bs = get_block_size()
    pre = OpenAIPreprocessor(ByteTokenizer(), PromptFormatter(None))
    prompts = [pre.preprocess(fam[k])[0].token_ids for fam in families for k in ("probe", "repeat")]
    prompts += [pre.preprocess({"prompt": p})[0].token_ids for p in surface["count_prompts"]]
    lib = native.get_native()

    def pure(fn, *args):
        old = os.environ.get("DYN_NATIVE")
        os.environ["DYN_NATIVE"] = "0"
        try:
            return fn(*args)
        finally:
            if old is None:
                del os.environ["DYN_NATIVE"]
            else:
                os.environ["DYN_NATIVE"] = old

    def median_us(fn, runs):
        times = []
        for _ in range(runs):
            t0 = time.perf_counter_ns()
            fn()
            times.append((time.perf_counter_ns() - t0) / 1e3)
        return statistics.median(times)

    checks = []
    hashes_equal = all(compute_block_hashes(p, bs) == pure(compute_block_hashes, p, bs) for p in prompts)
    one = prompts[1]  # a family's repeat: its system prompt, user message and template
    timing = {"tokens": len(one), "blocks": len(one) // bs,
              "native_us": median_us(lambda: compute_block_hashes(one, bs), DIST_HASH_RUNS["native"]),
              "python_us": pure(median_us, lambda: compute_block_hashes(one, bs), DIST_HASH_RUNS["python"])}
    trees = {"native": KvIndexer(bs), "python": KvIndexer(bs)}
    trees["python"].tree = RadixTree()
    if not isinstance(trees["native"].tree, NativeRadixTree):
        checks.append("the KV indexer does not sit on the native tree")
    subs = [KvRouterSubscriber(drt, idx, kv_events_stream_name("dynamo", "backend")) for idx in trees.values()]
    for s in subs:
        await s.start()
    try:
        await _settled(lambda: [idx.events_applied for idx in trees.values()])
        t0 = time.perf_counter()
        scores = [(trees["native"].find_matches(compute_block_hashes(p, bs)).scores,
                   trees["python"].find_matches(compute_block_hashes(p, bs)).scores) for p in prompts]
        dumps = (trees["native"].dump(), trees["python"].dump())
        compare_s = time.perf_counter() - t0
    finally:
        for s in subs:
            await s.stop()
    res = {"library": lib.path.rsplit("/", 1)[-1], "hashes_equal": hashes_equal, "hash_request": timing,
           "events": trees["native"].events_applied, "nodes": trees["native"].size(),
           "scores_equal": all(a == b for a, b in scores), "dump_bytes_equal": dumps[0] == dumps[1],
           "dump_bytes": len(dumps[0]), "compare_s": compare_s}
    if not (hashes_equal and res["scores_equal"] and res["dump_bytes_equal"] and res["nodes"]):
        checks.append(f"the host library disagrees with the pure-Python path: {res}")
    return res, checks


async def surface_migration(plane, kids, name_of: dict, families: list, surface: dict) -> tuple:
    """A frontend with ``migration_limit=1`` (``start_frontend``, as
    ``python -m dynamo_tpu_torch.frontend --migration-limit 1`` runs it; in
    this process, so the replays' requests and token ids can be read), then
    4 streaming chat requests of ``DIST_MIGRATE_TOKENS`` tokens (ignoring
    EOS): 2 of the first family, to their end, then 2 behind a system
    prompt neither worker has seen, the second once the first's first token
    is back (at ``DIST_MIGRATE_OVERLAP_WEIGHT`` it joins the first on its
    worker); once both have their first tokens, the worker that holds them
    is SIGKILLed. Every stream must end
    with all its tokens, each killed one replayed once on the other worker
    (which is idle by then) from its prompt and the tokens streamed before
    the kill, with the remaining ``max_tokens``."""
    from dynamo_tpu_torch.llm.entrypoint import FrontendConfig, start_frontend, stop_frontend
    from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor, PromptFormatter
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime.config import Config
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.runtime import Runtime

    def chat(system, user):
        return {"model": PRESET, "max_tokens": DIST_MIGRATE_TOKENS, "temperature": 0.0, "stream": True,
                "nvext": {"ignore_eos": True},
                "messages": [{"role": "system", "content": system}, {"role": "user", "content": user}]}

    first_system = families[0]["probe"]["messages"][0]["content"]
    pair1 = [chat(first_system, u) for u in surface["users"][:2]]
    pair2 = [chat(surface["system"], u) for u in surface["users"][2:]]
    pre = OpenAIPreprocessor(ByteTokenizer(), PromptFormatter(None))
    pair2_ids = [pre.preprocess(b)[0].token_ids for b in pair2]
    drt = await DistributedRuntime.from_settings(Runtime(Config(control_plane=plane)))
    service = await start_frontend(drt, FrontendConfig(host="127.0.0.1", port=0, router_mode="kv", migration_limit=1,
                                                       kv_overlap_score_weight=DIST_MIGRATE_OVERLAP_WEIGHT))
    checks = []
    try:
        for _ in range(600):
            if PRESET in service.routers:
                break
            await asyncio.sleep(0.1)
        rec = PushRecorder(service.routers[PRESET])
        t0 = time.perf_counter()
        done1 = [_answer_of(r) for r in await _send(service.port, pair1)]
        tasks = []
        for i, b in enumerate(pair2):
            # A stream that hangs fails the phase in minutes, not at the
            # script's limit (the request threads end with their timeout).
            tasks.append(asyncio.ensure_future(asyncio.to_thread(_request, service.port, "/v1/chat/completions", b,
                                                                 None, 120)))
            while len(rec.attempts) < 3 + i or not rec.attempts[2 + i]["first_t"]:
                if tasks[-1].done():
                    raise AssertionError("a stream of the pair to be killed ended before its first token")
                await asyncio.sleep(0.001)
        while not all(a["first_t"] for a in rec.attempts[2:4]):
            if any(t.done() for t in tasks):
                raise AssertionError("a stream of the pair to be killed ended before both had their first tokens")
            await asyncio.sleep(0.001)
        victims = {a["worker"] for a in rec.attempts[2:4]}
        victim = rec.attempts[2]["worker"]
        held = [dict(a) for a in rec.attempts[2:4] if a["worker"] == victim]
        streamed = [len(a["tokens"]) for a in held]
        killed_at = time.time()  # kill_one waits for the process to end after its SIGKILL
        kids.kill_one(name_of[victim])
        t_kill = time.perf_counter()
        done2 = [_answer_of(r) for r in await asyncio.wait_for(asyncio.gather(*tasks), 150)]
        wall = time.perf_counter() - t0
        replays = rec.attempts[4:]
        survivor = [w for w in name_of if w != victim][0]
        migrated = []
        for first in rec.attempts[2:4]:
            if first["worker"] != victim or len(first["tokens"]) == DIST_MIGRATE_TOKENS:
                continue  # not on the killed worker, or done before the kill
            # The replay may first go to the killed worker, while its lease is
            # being revoked: the KV router then schedules it again (the push
            # router's InstanceGone), and the last dispatch is the replay.
            tries = [a for a in replays if a["ctx"] == first["ctx"]]
            again = tries[-1]
            k = len(first["tokens"])
            migrated.append({
                "tokens_before_kill": k, "request": again["request"], "replay_tokens": again["tokens"],
                "text": done2[pair2_ids.index(first["request"]["token_ids"])]["text"],
                "first_attempt_tokens": first["tokens"], "replay_worker": f"{again['worker']:x}",
                "kill_to_first_replayed_token_ms": (again["first_t"] - t_kill) * 1e3 if again["first_t"] else None,
                "replay_cached_tokens": again["cached"],
                "dispatches_to_the_killed_worker": [f"{a['worker']:x}" for a in tries[:-1]]})
            req = again["request"]
            if (again["worker"] != survivor or not 0 < k < DIST_MIGRATE_TOKENS
                    or any(a["worker"] != victim or a["tokens"] for a in tries[:-1])
                    or req["token_ids"] != first["request"]["token_ids"] + first["tokens"]
                    or req["stop_conditions"]["max_tokens"] != DIST_MIGRATE_TOKENS - k
                    or k + len(again["tokens"]) != DIST_MIGRATE_TOKENS):
                checks.append(f"a killed stream was not replayed as its prompt and its {k} streamed tokens on "
                              f"{survivor:x}: {migrated[-1]['replay_worker']}, {len(again['tokens'])} tokens")
        answers = done1 + done2
        if any(a["completion_tokens"] != DIST_MIGRATE_TOKENS or a["finish_reason"] != "length" for a in answers):
            checks.append(f"a stream did not end with {DIST_MIGRATE_TOKENS} tokens: "
                          f"{[(a['completion_tokens'], a['finish_reason']) for a in answers]}")
        if len({a["ctx"] for a in replays}) != len(migrated) or not migrated:
            checks.append(f"{len(replays)} replays for {len(migrated)} killed streams")
        lat = [a["latency_s"] for a in answers]
        res = {"victim": f"{victim:x}", "victim_name": name_of[victim], "survivor": f"{survivor:x}",
               "pair_workers": sorted(f"{w:x}" for w in victims), "streamed_before_kill": streamed,
               "migrated": migrated, "wall_s": wall, "killed_at": killed_at,
               "latency_s": {"completed_pair": lat[:2], "killed_pair": lat[2:]},
               "migration_added_ms": [m["kill_to_first_replayed_token_ms"] for m in migrated]}
        # The frontend's /metrics counts each replay (migrations_total).
        from dynamo_tpu_torch.runtime.metrics import parse_text

        fam = parse_text(service.metrics.render().decode()).get("dynamo_frontend_migrations_total")
        res["metrics_migrations_total"] = sum(v for n, _, v in fam["samples"] if n.endswith("_total")) if fam else 0
        if res["metrics_migrations_total"] != len(migrated):
            checks.append(f"migrations_total {res['metrics_migrations_total']} != {len(migrated)} migrated streams")
    finally:
        try:  # a stream still open holds the server's close
            await asyncio.wait_for(stop_frontend(service), 30)
        except asyncio.TimeoutError:
            print("surface_migration: the frontend did not stop within 30 s", file=sys.stderr)
        await drt.shutdown()
    return res, checks


async def surface_references(port: int, engine, surface: dict, surf: dict) -> dict:
    """The in-process references of this part, on the phase's in-process
    engine (the workers' seed, warmup and bf16 reductions), each with the
    prefix cache emptied first: every batch prompt and the text line alone,
    held against ``run``'s outputs, and the killed streams' replays. The
    two replays reached the idle survivor within a millisecond of each
    other, so it admitted them together or one during the other's first
    step, in either order; each such admission is replayed (bf16 products
    round by the step's shape), and the survivor's tokens must be those of
    one of them, the stream's text that of its tokens before the kill and
    the reference's. ``checks`` lists what failed."""
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime.engine import Context

    sched = engine.scheduler
    checks = []

    async def http(path, body):
        sched.allocator.clear_cached()
        status, data, _, _ = await asyncio.to_thread(_request, port, path, body)
        if status != 200:
            raise AssertionError(f"HTTP {status}: {data}")
        return _answer_text(data, False, "chat" in path)

    batch = [await http("/v1/completions", {"model": PRESET, "prompt": p, "max_tokens": DIST_RUN_TOKENS,
                                            "temperature": 0.0}) for p in surface["run_prompts"]]
    text = await http("/v1/chat/completions", {"model": PRESET, "max_tokens": DIST_RUN_TOKENS, "temperature": 0.0,
                                                "messages": [{"role": "user", "content": surface["text_line"]}]})
    run = surf["run"]
    batch_equal = [rec["output"] == want and rec["prompt"] == p
                   for rec, want, p in zip(run["batch"], batch, surface["run_prompts"])]
    if len(run["batch"]) != len(batch) or not all(batch_equal) or run["text"] != text:
        checks.append(f"run's outputs differ from the in-process engine's: batch {batch_equal}, text "
                      f"{run['text'][:60]!r} vs {text[:60]!r}")

    async def one(req):
        toks = []
        async for frame in engine.generate(req, Context()):
            toks += frame["token_ids"]
        return toks

    async def admitted():
        while not any(s.admitted_ts is not None for s in list(sched.by_id.values())):
            await asyncio.sleep(0.0002)

    migrated = surf["migration"]["migrated"]
    reqs = [m["request"] for m in migrated]
    refs = {}
    sched.allocator.clear_cached()
    refs["together"] = list(await asyncio.gather(*(one(r) for r in reqs)))
    if len(reqs) == 2:
        for name, order in (("first_then_second", (0, 1)), ("second_then_first", (1, 0))):
            sched.allocator.clear_cached()
            first = asyncio.ensure_future(one(reqs[order[0]]))
            await admitted()
            second = asyncio.ensure_future(one(reqs[order[1]]))
            got = await asyncio.gather(first, second)
            refs[name] = [got[order.index(i)] for i in range(2)]
    matching = [name for name, toks in refs.items() if all(t == m["replay_tokens"] for t, m in zip(toks, migrated))]
    tok = ByteTokenizer()
    texts_equal = [m["text"] == tok.decode(m["first_attempt_tokens"] + m["replay_tokens"]) for m in migrated]
    if not matching or not all(texts_equal):
        first_diff = {name: [next((i for i, (a, b) in enumerate(zip(t, m["replay_tokens"])) if a != b), None)
                             for t, m in zip(toks, migrated)] for name, toks in refs.items()}
        checks.append(f"the killed streams' replays differ from every in-process reference (first differing "
                      f"token per stream: {first_diff}), or their text from their tokens' ({texts_equal})")
    return {"run_batch_equal": batch_equal, "run_text_equal": run["text"] == text,
            "migration_reference": matching, "migration_texts_equal": texts_equal, "checks": checks}


# ---------------------------------------------------------------------------
# distributed, image prompts and the rest of the HTTP surface: an encode
# worker (the vit-l-14 tower) behind the frontend's --encode-component, image
# chat requests held against an in-process replay, /v1/responses and
# keep-alive through the frontend, the tower against its f32 encode, and
# /v1/embeddings on the in-process reference service
# ---------------------------------------------------------------------------

DIST_VISION = "vit-l-14"  # 224x224 images in 14x14 patches: 256 feature rows of 2048 an image
DIST_VISION_SEED = 11
DIST_MM_TOKENS = 64
VIT_REL_TOL = 2e-2  # the bf16 tower's relative Frobenius error against its f32 encode
EMBED_LENGTHS = (5, 100, 500, 2000)  # one input per bucket of 32, 128, 512 and 2048
EMBED_NORM_TOL = 1e-3
EMBED_COS_MIN = 0.995  # each served vector against the plain f32 embed on the card


def write_png(pixels: np.ndarray, color_type: int, palette: Optional[np.ndarray] = None) -> bytes:
    """An 8-bit PNG of ``pixels`` ([H, W, 3] RGB for colour type 2, [H, W]
    grey or palette indices for 0 and 3), its rows filtered in turn with
    None, Sub, Up, Average and Paeth, compressed with the standard
    library's zlib: the card's machine has no PIL."""
    import struct
    import zlib

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    h, w = pixels.shape[:2]
    bpp = 3 if color_type == 2 else 1
    rows = pixels.reshape(h, w * bpp).astype(np.int32)
    out = bytearray()
    prev = np.zeros(w * bpp, np.int32)
    for r in range(h):
        row, kind = rows[r], r % 5
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        est = a + prev - c
        pa, pb, pc = np.abs(est - a), np.abs(est - prev), np.abs(est - c)
        pred = [np.zeros_like(row), a, prev, (a + prev) >> 1,
                np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))][kind]
        out.append(kind)
        out += ((row - pred) & 255).astype(np.uint8).tobytes()
        prev = row
    png = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
    if palette is not None:
        png += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return png + chunk(b"IDAT", zlib.compress(bytes(out), 6)) + chunk(b"IEND", b"")


def png_url(raw: bytes) -> str:
    import base64

    return "data:image/png;base64," + base64.b64encode(raw).decode()


def mm_traffic() -> dict:
    """The part's seeded requests: a 640x480 photo-like PNG with a short
    question, two images in one message (512 feature rows), a grey and a
    palette PNG, a repeat of the first, and three text-only chats among
    them (each opening with its own first block); greedy, 64 tokens,
    streamed. Plus the responses/chat messages and the keep-alive bodies."""
    rng = np.random.default_rng(31)

    def photo(h, w, phase):
        y, x = np.mgrid[0:h, 0:w]
        base = np.stack([128 + 100 * np.sin(x / (13.0 + c) + phase) * np.cos(y / (17.0 - c) - phase)
                         for c in range(3)], -1)
        return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)

    grey = photo(256, 256, 1.0).mean(axis=2).astype(np.uint8)
    palette = rng.integers(0, 256, (16, 3))
    indexed = (photo(120, 160, 2.0)[..., 0] // 16).astype(np.uint8)
    urls = {"png": png_url(write_png(photo(480, 640, 0.3), 2)),
            "square": png_url(write_png(photo(224, 224, 0.7), 2)),
            "wide": png_url(write_png(photo(200, 300, 1.3), 2)),
            "grey": png_url(write_png(grey, 0)),
            "palette": png_url(write_png(indexed, 3, palette))}
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    text = lambda n: "".join(rng.choice(letters, size=n))  # noqa: E731

    def chat(images, question):
        content = [{"type": "image_url", "image_url": {"url": urls[i]}} for i in images]
        content.append({"type": "text", "text": question})
        return {"model": PRESET, "max_tokens": DIST_MM_TOKENS, "temperature": 0.0, "stream": True,
                "messages": [{"role": "user", "content": content}]}

    def text_chat(i):
        return {"model": PRESET, "max_tokens": DIST_MM_TOKENS, "temperature": 0.0, "stream": True,
                "messages": [{"role": "user", "content": f"Kilo {i}. " + text(120)}]}

    order = [("png", chat(["png"], "What is in this picture?")), ("text_0", text_chat(0)),
             ("two", chat(["square", "wide"], "Compare the two images.")), ("text_1", text_chat(1)),
             ("grey", chat(["grey"], "Describe the grey image.")),
             ("palette", chat(["palette"], "Which colours are there?")), ("text_2", text_chat(2)),
             ("png_repeat", chat(["png"], "What is in this picture?"))]
    return {"order": order, "images_sent": 5, "photo_url": urls["png"],
            "responses_messages": [{"role": "user", "content": "Lima. " + text(200)}],
            "keep_alive": [{"model": PRESET, "max_tokens": 8, "temperature": 0.0,
                            "messages": [{"role": "user", "content": f"Mike {i}. " + text(40)}]} for i in range(5)]}


def _responses_text(status, data, stream: bool) -> str:
    if status != 200:
        raise AssertionError(f"/v1/responses HTTP {status}: {data}")
    if not stream:
        return data["output"][0]["content"][0]["text"]
    done = [e for e in data if e.get("type") == "response.completed"]
    deltas = "".join(e["delta"] for e in data if e.get("type") == "response.output_text.delta")
    text = done[0]["response"]["output"][0]["content"][0]["text"]
    if deltas != text:
        raise AssertionError("the streamed response's deltas differ from its completed text")
    return text


def _keep_alive(port: int, bodies: list) -> list:
    """The bodies one after another on one connection: (status, the
    server's Connection header, the socket's identity) each."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    seen = []
    try:
        for body in bodies:
            conn.request("POST", "/v1/chat/completions", json.dumps(body), {"Content-Type": "application/json"})
            resp = conn.getresponse()
            resp.read()
            seen.append((resp.status, resp.getheader("Connection"), id(conn.sock)))
    finally:
        conn.close()
    return seen


def vit_check(dev) -> dict:
    """The vit-l-14 tower on the card: bf16 (the encode worker's weights:
    the same seed, cast from the same f32 draws) against the plain f32
    encode of 4 images, and its ms an image at batch 1 and 4."""
    from dynamo_tpu_torch.engine.models import vision

    cfg = vision.PRESETS[DIST_VISION]
    f32 = vision.init_params(cfg, torch.Generator(device=dev).manual_seed(DIST_VISION_SEED), device=dev,
                             dtype=torch.float32)
    bf16 = {k: ({n: t.to(torch.bfloat16) for n, t in v.items()} if isinstance(v, dict) else v.to(torch.bfloat16))
            for k, v in f32.items()}
    imgs = torch.rand((4, cfg.image_size, cfg.image_size, 3), generator=torch.Generator(device=dev).manual_seed(5),
                      device=dev)
    plain = vision.encode(f32, cfg, imgs)
    got = vision.encode(bf16, cfg, imgs)
    rel = float(torch.linalg.vector_norm(got - plain) / torch.linalg.vector_norm(plain))
    ms1 = cuda_ms(lambda: vision.encode(bf16, cfg, imgs[:1]), iters=10)
    ms4 = cuda_ms(lambda: vision.encode(bf16, cfg, imgs), iters=10) / 4
    out = {"rel_frobenius": rel, "tol": VIT_REL_TOL, "ms_per_image_batch1": ms1, "ms_per_image_batch4": ms4,
           "finite": bool(torch.isfinite(got).all()), "shape": list(got.shape)}
    del f32, bf16, plain, got
    torch.cuda.empty_cache()
    return out


async def surface_multimodal(port: int, drt, traffic: dict, dev) -> tuple:
    """Image prompts, one at a time, through a frontend in this process
    (``start_frontend(encode_component="encode")`` over the same workers,
    its KV router's dispatches recorded, so each answer's token ids are
    known: the byte tokenizer's text folds invalid bytes into one
    replacement character) and the first of them again through the
    frontend process (``--encode-component encode``), whose text must be
    the same: every answer a 200 with 64 tokens or ``stop``, each one
    dispatch, the repeat of an image request with ``cached_tokens`` 0
    (image sequences neither match nor register prefix blocks), the
    encode worker's ``request_total`` up by the image requests sent; then
    ``/v1/responses`` unary and streamed through the frontend process,
    their texts that of a chat request on the same messages with the same
    cache state (each after the first chat's prefix is cached); five
    requests on one kept-alive connection; the tower on the card; the
    host's decode and resize of the 640x480 PNG. The answers' ids are held
    against the in-process replay later (``multimodal_references``)."""
    from dynamo_tpu_torch.llm.entrypoint import FrontendConfig, start_frontend, stop_frontend
    from dynamo_tpu_torch.llm.image_decode import decode_image_data_url

    checks = []
    t0 = time.perf_counter()
    enc = await drt.namespace("dynamo").component("encode").endpoint("generate").client()
    await enc.wait_for_instances(1, timeout=60)
    before = sum(s.get("request_total", 0) for s in (await enc.scrape_stats()).values())
    answers, ids = {}, {}
    service = await start_frontend(drt, FrontendConfig(host="127.0.0.1", port=0, router_mode="kv",
                                                       encode_component="encode"))
    try:
        for _ in range(600):
            if PRESET in service.routers:
                break
            await asyncio.sleep(0.1)
        rec = PushRecorder(service.routers[PRESET])
        for name, body in traffic["order"]:
            n0 = len(rec.attempts)
            (res,) = await _send(service.port, [body])
            answers[name] = _answer_of(res)
            ids[name] = [a["tokens"] for a in rec.attempts[n0:]]
    finally:
        await stop_frontend(service)
    (res,) = await _send(port, [traffic["order"][0][1]])
    via_process = _answer_of(res)
    rose = sum(s.get("request_total", 0) for s in (await enc.scrape_stats()).values()) - before
    await enc.close()
    if rose != traffic["images_sent"] + 1:
        checks.append(f"the encode worker's request_total rose by {rose}, not {traffic['images_sent'] + 1}")
    if answers["png_repeat"]["cached_tokens"] != 0 or via_process["cached_tokens"] != 0:
        checks.append(f"an image request's repeat reported cached_tokens {answers['png_repeat']['cached_tokens']}, "
                      f"{via_process['cached_tokens']}")
    if any(len(d) != 1 or len(d[0]) != a["completion_tokens"] for d, a in zip(ids.values(), answers.values())):
        checks.append(f"an answer took other than one dispatch of its tokens: {[len(d) for d in ids.values()]}")
    if via_process["text"] != answers["png"]["text"]:
        checks.append("the frontend process's answer to the first image request differs from this process's")
    msgs = traffic["responses_messages"]
    chat = {"model": PRESET, "messages": msgs, "max_tokens": 32, "temperature": 0.0}
    resp = {"model": PRESET, "input": msgs, "max_output_tokens": 32, "temperature": 0.0}
    first = await asyncio.to_thread(_request, port, "/v1/chat/completions", chat)
    unary = _responses_text(*(await asyncio.to_thread(_request, port, "/v1/responses", resp))[:2], False)
    streamed = _responses_text(*(await asyncio.to_thread(_request, port, "/v1/responses",
                                                         {**resp, "stream": True}))[:2], True)
    again = await asyncio.to_thread(_request, port, "/v1/chat/completions", chat)
    chat_text = _answer_text(again[1], False, True)
    if not unary == streamed == chat_text:
        checks.append(f"/v1/responses' text differs from chat's: {unary[:40]!r}, {streamed[:40]!r}, "
                      f"{chat_text[:40]!r}")
    kept = await asyncio.to_thread(_keep_alive, port, traffic["keep_alive"])
    if [s for s, _, _ in kept] != [200] * 5 or {c for _, c, _ in kept} != {"keep-alive"} or len(
            {sock for _, _, sock in kept}) != 1:
        checks.append(f"keep-alive: {kept}")
    tower = await asyncio.to_thread(vit_check, dev)
    if not tower["finite"] or tower["rel_frobenius"] > VIT_REL_TOL:
        checks.append(f"the bf16 tower's error {tower['rel_frobenius']:.4g} > {VIT_REL_TOL} (or not finite)")
    decode_ms = []
    for _ in range(5):
        t1 = time.perf_counter()
        decode_image_data_url(traffic["photo_url"], 224)
        decode_ms.append((time.perf_counter() - t1) * 1e3)
    images = [a for n, a in answers.items() if not n.startswith("text")]
    texts = [a for n, a in answers.items() if n.startswith("text")]
    res = {"answers": {n: {k: a[k] for k in ("completion_tokens", "finish_reason", "cached_tokens", "ttft_s",
                                             "latency_s")} for n, a in answers.items()},
           "token_ids": {n: d[0] for n, d in ids.items()},
           "process_frontend_text_equal": via_process["text"] == answers["png"]["text"],
           "ttft_p50_s": {"image": statistics.median(a["ttft_s"] for a in images),
                          "text_only": statistics.median(a["ttft_s"] for a in texts)},
           "encode_request_total_rose": rose, "responses_equal_chat": unary == streamed == chat_text,
           "first_chat_equal": _answer_text(first[1], False, True) == chat_text,
           "keep_alive": [[s, c] for s, c, _ in kept], "tower": tower,
           "host_decode_resize_640x480_ms": statistics.median(decode_ms), "seconds": time.perf_counter() - t0}
    return res, checks


async def multimodal_references(engine, traffic: dict, surf: dict) -> dict:
    """The image and text-only requests again, one at a time, through an
    in-process pipeline over the phase's in-process engine with a
    ``LocalVisionEncoder`` of the encode worker's preset, seed and dtype
    (bf16 on the card, the same reductions): each answer's token ids, as
    the engine emits them, must be those the frontend's dispatch
    carried."""
    from dynamo_tpu_torch.llm.entrypoint import build_local_pipeline
    from dynamo_tpu_torch.llm.multimodal import LocalVisionEncoder
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.runtime.engine import Context

    class Tap:
        """The engine, its emitted token ids kept."""

        def __init__(self):
            self.tokens = []

        async def generate(self, request, context):
            async for frame in engine.generate(request, context):
                self.tokens += frame.get("token_ids") or []
                yield frame

    t0 = time.perf_counter()
    tap = Tap()
    # The encode worker's --dtype is the LM workers'.
    pipeline = build_local_pipeline(ByteTokenizer(), tap, encoder=LocalVisionEncoder(
        preset=DIST_VISION, seed=DIST_VISION_SEED, device=str(engine.scheduler.device),
        dtype=engine.scheduler.params["embed"].dtype))
    got = surf["multimodal"]["token_ids"]
    equal = {}
    for name, body in traffic["order"]:
        engine.scheduler.allocator.clear_cached()
        tap.tokens = []
        async for _ in pipeline.generate(dict(body), Context()):
            pass
        equal[name] = tap.tokens == got[name]
    checks = [] if all(equal.values()) else [f"image or text answers' ids differ from the in-process replay: {equal}"]
    return {"token_ids_equal": equal, "seconds": time.perf_counter() - t0, "checks": checks}


async def embeddings_check(port: int, engine) -> dict:
    """``/v1/embeddings`` on the in-process reference service: inputs of
    ``EMBED_LENGTHS`` token ids, a list of strings and a list of id lists;
    every vector of norm 1 within ``EMBED_NORM_TOL``, each one's cosine
    with the plain f32 ``llama.embed`` on the card at least
    ``EMBED_COS_MIN``, an input's vector alone bit-equal to it inside a
    list; and the engine's ms for one input of each bucket."""
    from dynamo_tpu_torch.engine.embeddings import EmbeddingEngine
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    t0 = time.perf_counter()
    sched = engine.scheduler
    rng = np.random.default_rng(37)
    ids = {n: rng.integers(1, 255, size=n).tolist() for n in EMBED_LENGTHS}
    strings = ["Embed me, please.", "A second, somewhat longer sentence to embed on the card."]
    bodies = [{"model": PRESET, "input": ids[n]} for n in EMBED_LENGTHS]
    bodies += [{"model": PRESET, "input": strings}, {"model": PRESET, "input": [ids[5], ids[100]]}]
    served = []
    for body in bodies:
        status, data, _, _ = await asyncio.to_thread(_request, port, "/v1/embeddings", body)
        if status != 200:
            raise AssertionError(f"/v1/embeddings HTTP {status}: {data}")
        served.append([d["embedding"] for d in data["data"]])
    inputs = [ids[n] for n in EMBED_LENGTHS] + [ByteTokenizer().encode(s) for s in strings] + [ids[5], ids[100]]
    vectors = [v for group in served for v in group]
    f32 = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict) else v.float())
           for k, v in sched.params.items()}
    embedder = EmbeddingEngine(sched.mc, sched.params)
    cos, norms = [], []
    for toks, vec in zip(inputs, vectors):
        bucket = next(b for b in embedder.buckets if b >= len(toks))
        padded = torch.zeros(bucket, dtype=torch.int32)
        padded[: len(toks)] = torch.tensor(toks, dtype=torch.int32)
        plain = llama.embed(f32, sched.mc, padded.to(sched.device), len(toks))
        v = torch.tensor(vec, device=sched.device)
        norms.append(float(torch.linalg.vector_norm(v)))
        cos.append(float(torch.dot(v, plain) / (torch.linalg.vector_norm(v) * torch.linalg.vector_norm(plain))))
    del f32
    torch.cuda.empty_cache()
    same_bits = served[0][0] == served[-1][0] and served[1][0] == served[-1][1]
    ms = {}
    for n in EMBED_LENGTHS:
        embedder.embed_one(ids[n])
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            embedder.embed_one(ids[n])  # its .tolist() waits for the card
            times.append((time.perf_counter() - t1) * 1e3)
        ms[f"{n}_tokens_bucket_{next(b for b in embedder.buckets if b >= n)}"] = statistics.median(times)
    checks = []
    if any(abs(x - 1.0) > EMBED_NORM_TOL for x in norms) or min(cos) < EMBED_COS_MIN or not same_bits:
        checks.append(f"embeddings: norms {norms}, cosines {cos}, alone vs in a list bit-equal {same_bits}")
    return {"norms": norms, "cosine_vs_f32": cos, "alone_equals_listed": same_bits, "ms_per_bucket": ms,
            "dims": len(vectors[0]), "seconds": time.perf_counter() - t0, "checks": checks}


def phase_distributed(card: str) -> dict:
    """The port's deployment as an operator runs it: ``python -m
    dynamo_tpu_torch.control_plane``, two ``python -m
    dynamo_tpu_torch.worker --model PRESET --warmup-ctx 2048`` (seeded
    random weights from the same default ``--seed``, each its own process
    and CUDA context on the card, started after the build so they load the
    built libraries) and ``python -m dynamo_tpu_torch.frontend --router-mode
    kv``, every role with ``DYN_CONTROL_PLANE=tcp``. The model must appear
    in ``/v1/models`` through discovery. ``dist_traffic``'s two probes go
    at once (the KV router sends the second to the other worker: the first
    loads the one it took), then both families' bursts at once
    (``_bursts``: 8 requests, 4 a worker, each family's as
    ``_family_burst`` sends it), then the two
    repeats one at a time, each beside a stats scrape of both workers:
    each repeat must report ``cached_tokens > 0``, exactly one worker's
    ``cached_tokens_total`` must rise by it, and the two families' repeats
    must land on different workers. Every answer is a 200 with 64 tokens
    or ``stop``. At SIGTERM each worker logs its launch counters since it
    registered: it must have served requests, launched the ragged kernel
    16 × its forward steps (and its non-fused window steps), the fused
    window once per fused window (at least one), nothing else and no plain
    version. Then, in this process, on one ``run.build_service`` engine
    (the same seed and warmup, the workers' bf16 GEMM reductions, PyTorch's
    default): the deployment's traffic, for the printed comparison (tok/s
    and TTFT p50 of the bursts on both paths; the hop's host cost per
    token, a repeat's latency through the frontend less the in-process
    one, over its tokens); then, its prefix cache emptied, the reference,
    which replays each family's sequence as the worker holding the family
    saw it (its probe, its burst, its repeat; the families one after the
    other, as they share no block): each of the 12 answers' text must
    equal the reference's, and each worker's steps and windows are printed
    beside the reference's for its family. A worker that dies fails the
    phase; every child is killed in a ``finally``.

    Then the rest of the engine's and router's surface on the same
    processes (the ``surface_*`` functions): ``run``'s batch and text modes
    through ``out=dyn://`` (each text the in-process engine's for its
    prompt alone); three routers over the workers, each repeat on the
    worker holding its family with a prefix hit, the sharded router's
    scores the plain indexer's, each counting router seeing the other's
    pending prefills; ``set_dial`` 0.9, then 0.5, to ``worker_0`` (reply
    and ``elastic_*`` keys against ``dial_applied``, a burst after each,
    the first-token counters' rise within the burst's TTFTs); the host
    library's hashes and tree against pure Python, with the median time to
    hash a family's request both ways; image prompts (``surface_multimodal``:
    an encode worker, ``--role encode --vision-model vit-l-14``, started
    beside the LM workers, behind the frontend's ``--encode-component
    encode``; four image requests and a repeat, three text-only requests
    among them, ``/v1/responses`` unary and streamed against chat, five
    requests on one kept-alive connection, the tower's bf16 error on the
    card, the host's PNG decode); each worker's launch counters by SIGUSR1
    (the gates above, and no step graph captured after its warmup); and a
    worker killed mid-stream (``surface_migration``), the survivor's
    counters gated again at its shutdown. In process, the image and
    text-only answers are replayed through a ``LocalVisionEncoder`` of the
    encode worker's seed (``multimodal_references``) and ``/v1/embeddings``
    is held against the plain f32 embed (``embeddings_check``)."""
    import os
    import socket
    from pathlib import Path

    from dynamo_tpu_torch import run
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.runtime.config import Config, ControlPlaneConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.runtime import Runtime

    root = Path(__file__).resolve().parent
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        cp_port = s.getsockname()[1]
    env = dict(os.environ, DYN_CONTROL_PLANE="tcp", DYN_CONTROL_PLANE_ADDRESS=f"127.0.0.1:{cp_port}", DYN_LOG="INFO",
               PYTHONPATH=str(root))
    families = dist_traffic()
    surface = dist_surface_traffic()
    mm = mm_traffic()
    gc.collect()
    torch.cuda.empty_cache()
    kids = _Children(root, env)
    workers = ("worker_0", "worker_1")
    # The observability plane: every LM process traces to its own file and
    # judges the SLO targets; each worker serves a health port.
    trace_paths = {name: kids.logs / f"{name}.trace.jsonl" for name in (*workers, "frontend")}
    for path in trace_paths.values():
        path.unlink(missing_ok=True)
    health_ports = {name: _free_port() for name in workers}
    plane_flags = ("--trace-sample", "1.0", "--slo-ttft-ms", str(DIST_SLO_TTFT_MS), "--slo-tpot-ms",
                   str(DIST_SLO_TPOT_MS))
    # The black box: each worker's incident bundles and captures, and the
    # aggregator's fleet bundles, under the phase's log directory.
    incident_dirs = {name: kids.logs / "incidents" / name for name in (*workers, "aggregator")}
    profile_dirs = {name: kids.logs / "profiles" / name for name in workers}
    for d in (*incident_dirs.values(), *profile_dirs.values()):
        shutil.rmtree(d, ignore_errors=True)
    agg_port = _free_port()
    t0 = time.perf_counter()
    try:
        kids.start("control_plane", "dynamo_tpu_torch.control_plane", "--host", "127.0.0.1", "--port", str(cp_port))
        kids.wait_for("control_plane", "control plane ready", 60)
        for name in workers:
            kids.start(name, "dynamo_tpu_torch.worker", "--model", PRESET, "--warmup-ctx", str(DIST_WARMUP_CTX),
                       "--trace-file", str(trace_paths[name]), "--health-port", str(health_ports[name]),
                       *plane_flags, "--incident-dir", str(incident_dirs[name]), "--profile-on-incident",
                       "--profile-dir", str(profile_dirs[name]), "--profile-interval-s", str(DIST_PROFILE_INTERVAL_S),
                       "--profile-window-s", str(DIST_PROFILE_WINDOW_S))
        kids.start("encoder", "dynamo_tpu_torch.worker", "--role", "encode", "--vision-model", DIST_VISION,
                   "--vision-seed", str(DIST_VISION_SEED))
        kids.start("frontend", "dynamo_tpu_torch.frontend", "--http-host", "127.0.0.1", "--http-port", "0",
                   "--router-mode", "kv", "--encode-component", "encode", "--trace-file",
                   str(trace_paths["frontend"]), *plane_flags)
        port = int(kids.wait_for("frontend", "frontend ready on", 120).split(" (")[0].rsplit(":", 1)[1])
        ready = {name: kids.wait_for(name, "worker ready", 300) for name in workers}
        kids.start("aggregator", "dynamo_tpu_torch.metrics_aggregator", "--endpoint", "dynamo/backend/generate",
                   "--port", str(agg_port), "--interval", str(DIST_AGG_INTERVAL_S), "--incident-dir",
                   str(incident_dirs["aggregator"]))
        kids.wait_for("aggregator", "metrics aggregator serving", 60)
        kids.wait_for("encoder", "encode worker ready", 300)
        up_s = time.perf_counter() - t0
        instance_of = {name: int(line.rsplit("instance=", 1)[1], 16) for name, line in ready.items()}

        async def drive():
            deadline = time.monotonic() + 60
            while True:
                kids.alive()
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
                conn.request("GET", "/v1/models")
                models = [m["id"] for m in json.loads(conn.getresponse().read())["data"]]
                conn.close()
                if PRESET in models:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"{PRESET} never appeared in /v1/models: {models}")
                await asyncio.sleep(0.2)
            plane = ControlPlaneConfig(backend="tcp", address=f"127.0.0.1:{cp_port}")
            drt = await DistributedRuntime.from_settings(Runtime(Config(control_plane=plane)))
            try:
                client = await drt.namespace("dynamo").component("backend").endpoint("generate").client()
                await client.wait_for_instances(2, timeout=60)
                base = await client.scrape_stats()
                probes = [_answer_of(r) for r in await _send(port, [fam["probe"] for fam in families],
                                                            [_tenant_headers(fam) for fam in families])]
                # worker_0's on-demand device and host captures while the
                # bursts run.
                capture_task = asyncio.ensure_future(on_demand_captures(health_ports["worker_0"]))
                burst, wall, timing = await _bursts(port, families)
                capture = await capture_task
                state0 = json.loads((await asyncio.to_thread(_http_get, health_ports["worker_0"], "/debug/state"))[1])
                bb_capture, bb_checks = capture_check(capture, state0)
                repeats = []
                for fam in families:
                    before = await client.scrape_stats()
                    (ans,) = [_answer_of(r) for r in await _send(port, [fam["repeat"]], [_tenant_headers(fam)])]
                    after = await client.scrape_stats()
                    rose = {wid: after[wid]["cached_tokens_total"] - before[wid]["cached_tokens_total"]
                            for wid in after}
                    repeats.append({**ans, "cached_tokens_rose": {f"{w:x}": d for w, d in rose.items()}})
                    served = [w for w, d in rose.items() if d]
                    if not ans["cached_tokens"] or len(served) != 1 or rose[served[0]] != ans["cached_tokens"]:
                        raise AssertionError(f"a repeat did not hit the prefix cache of the worker holding its "
                                             f"prefix: cached_tokens {ans['cached_tokens']}, rose {rose}")
                    repeats[-1]["worker"] = served[0]
                n = DIST_PER_FAMILY
                bb_tenants, more = tenant_check(base, after, families,
                                                [[probes[f], *burst[f * n:(f + 1) * n], repeats[f]] for f in range(2)],
                                                [r["worker"] for r in repeats])
                bb_checks += more
                steady = await steady_load(port, families, DIST_STEADY_S)
                # The plane through the frontend: a traced one-token probe,
                # a request past its deadline (a 504), then /metrics.
                probe = {"model": PRESET, "max_tokens": 1, "temperature": 0.0, "stream": True,
                         "messages": [{"role": "user", "content": "trace probe"}]}
                traced = await asyncio.to_thread(_request, port, "/v1/chat/completions", probe, None, 600,
                                                 {"traceparent": DIST_TRACEPARENT})
                late = {"model": PRESET, "max_tokens": 64, "temperature": 0.0, "timeout": 0.001,
                        "messages": [{"role": "user", "content": "too late"}]}
                late_status = (await asyncio.to_thread(_request, port, "/v1/chat/completions", late))[0]
                n200 = len(probes) + len(burst) + len(repeats) + len(steady) + (traced[0] == 200)
                fm, plane_checks = await asyncio.to_thread(frontend_metrics_check, port, n200)
                if traced[0] != 200 or late_status != 504:
                    plane_checks.append(f"the traced probe answered {traced[0]}, the late request {late_status}")
                stats = await client.scrape_stats()
                # The rest of the surface, on the same deployment: run's modes,
                # the router's options, the dial and the host library; then
                # each worker's launch counters so far, and a worker killed.
                t1 = time.perf_counter()
                surf = {"run": await surface_run_modes(root, env, surface)}
                surf["routers"], checks = await surface_routers(client, families, [r["worker"] for r in repeats],
                                                                surface)
                surf["dial"], more = await surface_dial(drt, client, instance_of["worker_0"], surface)
                checks += more
                surf["native"], more = await surface_native(drt, families, surface)
                checks += more
                surf["multimodal"], more = await surface_multimodal(port, drt, mm, torch.device("cuda", 0))
                checks += more
                # Each worker's stats scrape and health port beside its
                # counters line: no traffic runs between them.
                plane_stats = await client.scrape_stats()
                health = {}
                for name in workers:
                    ttft = plane_stats[instance_of[name]]["digests"]["ttft"]["total"]
                    health[name], more = await asyncio.to_thread(worker_health_check, health_ports[name], ttft)
                    plane_checks += more
                bb_states = {name: json.loads((await asyncio.to_thread(_http_get, health_ports[name],
                                                                       "/debug/state"))[1]) for name in workers}
                bb_agg, more = await asyncio.to_thread(aggregator_check, agg_port, plane_stats)
                bb_checks += more
                for name in workers:
                    kids.snapshot(name, DIST_COUNTERS_MARK)
                name_of_id = {i: name for name, i in instance_of.items()}
                surf["migration"], more = await surface_migration(plane, kids, name_of_id, families, surface)
                checks += more
                mig = surf["migration"]
                bb_lost, more = await asyncio.to_thread(worker_lost_check, agg_port, incident_dirs["aggregator"],
                                                        mig["killed_at"], mig["victim"], mig["survivor"])
                bb_checks += more
                surf["seconds"] = time.perf_counter() - t1
                await client.close()
            finally:
                await drt.shutdown()
            black_box = {"capture": bb_capture, "tenants": bb_tenants, "aggregator": bb_agg, "worker_lost": bb_lost,
                         "states": bb_states, "steady_requests": len(steady)}
            return (models, probes, burst, wall, timing, repeats, stats, surf, checks + bb_checks,
                    (fm, plane_checks, plane_stats, health), black_box)

        (models, probes, burst, wall, timing, repeats, stats, surf, surf_checks,
         (front_metrics, plane_checks, plane_stats, health), black_box) = asyncio.run(drive())
        kids.alive()
        codes = {name: kids.stop(name) for name in (*workers, "encoder", "frontend", "aggregator", "control_plane")
                 if name in kids.procs}
    finally:
        kids.kill()
    if any(codes.values()):
        raise AssertionError(f"a process exited with an error: {codes}")
    # Each worker's counters as SIGUSR1 logged them before the kill (the
    # whole deployment's traffic but the killed pair's), and the survivor's
    # at its shutdown.
    worker_runs, survivor_final = {}, None
    for name in workers:
        lines = [ln for ln in kids.text(name).splitlines() if DIST_COUNTERS_MARK in ln]
        worker_runs[name] = json.loads(lines[0].split(DIST_COUNTERS_MARK, 1)[1])
        if name != surf["migration"]["victim_name"]:
            survivor_final = (name, json.loads(lines[-1].split(DIST_COUNTERS_MARK, 1)[1]))
    phase_s = time.perf_counter() - t0

    # In-process, with the workers' bf16 GEMM reductions (PyTorch's
    # default; main() turns them off for the plain versions' checks).
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    step_keys = ("forward_steps_total", "prefill_steps_total", "mixed_steps_total", "wave_steps_total",
                 "fused_windows_total")
    try:
        args = run.parse_args(["in=http", f"out={PRESET}", "--http-host", "127.0.0.1", "--http-port", "0",
                               "--warmup-ctx", str(DIST_WARMUP_CTX)])

        async def in_process():
            service, engine = run.build_service(args)
            await service.start()
            sched = engine.scheduler
            ref, ref_steps, ref_timing = [], [], []
            try:
                # What a capture costs the step loop, before any traffic of
                # the families (its blocks are cleared after).
                cost = await asyncio.to_thread(capture_cost_probe, service.port, engine)
                lprobes = [_answer_of(r) for r in await _send(service.port, [fam["probe"] for fam in families])]
                lburst, lwall, _ = await _bursts(service.port, families)
                lrepeats = [_answer_of(r) for fam in families for r in await _send(service.port, [fam["repeat"]])]
                # The reference on the same engine, its prefix cache emptied.
                sched.allocator.clear_cached()
                for fam in families:
                    before = {k: getattr(sched, k) for k in step_keys}
                    (probe,) = await _send(service.port, [fam["probe"]])
                    fburst, seen = await _family_burst(service.port, fam["burst"])
                    (rep,) = await _send(service.port, [fam["repeat"]])
                    ref.append([_answer_of(r) for r in (probe, *fburst, rep)])
                    ref_steps.append({k: getattr(sched, k) - before[k] for k in step_keys})
                    ref_timing.append(seen)
                surface_refs = await surface_references(service.port, engine, surface, surf)
                surface_refs["multimodal"] = await multimodal_references(engine, mm, surf)
                surface_refs["embeddings"] = await embeddings_check(service.port, engine)
            finally:
                await service.stop()
                await engine.stop()
            return lprobes, lburst, lwall, lrepeats, ref, ref_steps, ref_timing, surface_refs, cost

        (lprobes, lburst, lwall, lrepeats, ref, ref_steps, ref_timing, surface_refs,
         capture_cost) = asyncio.run(in_process())
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced

    L = get_config(PRESET).num_layers
    checks, per_worker = list(surf_checks) + plane_checks, {}
    # The plane: each worker's scrape against its counters line, the traced
    # probe in the flushed files, and the tracer's host cost.
    from dynamo_tpu_torch.runtime.tracing import read_trace_file

    obs = {"frontend_metrics": front_metrics, "health": health, "workers": {}}
    for name in workers:
        obs["workers"][name], more = plane_check(name, plane_stats[instance_of[name]], worker_runs[name], L)
        checks += more
    records = {name: read_trace_file(str(p)) if p.exists() else [] for name, p in trace_paths.items()}
    obs["trace"], more = trace_check(records)
    checks += more
    obs["trace_files"] = {name: {"records": len(records[name]),
                                 "bytes": trace_paths[name].stat().st_size if trace_paths[name].exists() else 0}
                          for name in trace_paths}
    client_ttft = [a["ttft_s"] for a in [*probes, *burst, *repeats]]
    obs["client_ttft_s"] = {"p50": float(np.percentile(client_ttft, 50)), "p99": float(np.percentile(client_ttft, 99))}
    obs["trace_overhead_us"] = trace_overhead_us(kids.logs / "overhead.trace.jsonl")
    # The black box per worker: its scrape before the kill against its
    # counters line, its profiler's windows and its log's calibration line.
    states = black_box.pop("states")
    black_box["workers"] = {}
    for name in workers:
        black_box["workers"][name], more = black_box_check(name, plane_stats[instance_of[name]], worker_runs[name],
                                                           states[name], kids.text(name))
        checks += more
    black_box["capture_cost"] = capture_cost
    # The black box's readings on a line of their own (the phase's line is
    # long), and in the phase's log directory.
    emit("distributed_black_box", **black_box)
    (kids.logs / "black_box.json").write_text(json.dumps(black_box, default=str))

    def launch_check(name, runs, label):
        steps, k = runs["steps"], runs["kernels"]
        launches = {n: c["launches"] for n, c in k.items()}
        want = {n: 0 for n in launches}
        want["ragged_paged_attention"] = L * (steps["forward_steps_total"] + steps["window_steps_total"]
                                              + steps["draft_prefill_steps_total"])
        want["fused_decode_window"] = steps["fused_windows_total"]
        want["fused_decode_window_sampled"] = steps["fused_sampled_windows_total"]
        want["fused_decode_window_guided"] = steps["fused_guided_windows_total"]
        plain = sum(c["plain_calls"] for c in k.values())
        if not steps["request_total"]:
            checks.append(f"{label} served no request")
        if launches != want or not steps["fused_windows_total"] or plain:
            checks.append(f"{label}: launches {launches} != {want}, or no fused window, or {plain} plain calls")
        return {"instance": f"{instance_of[name]:x}", "steps": steps, "launches": launches,
                "expected_launches": want, "plain_calls": plain,
                "captures_after_warmup": runs["captures_after_warmup"]}

    for name, runs in worker_runs.items():
        per_worker[name] = launch_check(name, runs, name)
        if runs["captures_after_warmup"] != 0:
            checks.append(f"{name} captured {runs['captures_after_warmup']} step graphs after its warmup")
    survivor = {"name": survivor_final[0],
                **launch_check(survivor_final[0], survivor_final[1], survivor_final[0] + " at shutdown")}
    checks += surface_refs.pop("checks")
    checks += surface_refs["multimodal"].pop("checks") + surface_refs["embeddings"].pop("checks")
    if repeats[0]["worker"] == repeats[1]["worker"]:
        checks.append("both families' repeats landed on one worker")
    # Every answer against the reference's for its family, in its order:
    # probe, burst, repeat.
    n = DIST_PER_FAMILY
    got = [[probes[f], *burst[f * n:(f + 1) * n], repeats[f]] for f in range(2)]
    texts_equal = [[a["text"] == b["text"] for a, b in zip(got[f], ref[f])] for f in range(2)]
    if not all(all(row) for row in texts_equal):
        differ = [{"family": f, "answer": i, "frontend": got[f][i]["text"][:80], "reference": ref[f][i]["text"][:80]}
                  for f in range(2) for i, ok in enumerate(texts_equal[f]) if not ok]
        checks.append(f"answers differ from the in-process reference's (per family: probe, burst, repeat): "
                      f"{texts_equal}, {differ}")
    # Each family's steps on the reference and on the worker that held it
    # (that worker's whole run: the family's three rounds).
    name_of = {i: name for name, i in instance_of.items()}
    family_steps = [{"worker": name_of[repeats[f]["worker"]], "reference": ref_steps[f],
                     "worker_steps": {k: worker_runs[name_of[repeats[f]["worker"]]]["steps"][k] for k in step_keys}}
                    for f in range(2)]
    # The deployment's traffic on one in-process engine (both families in
    # its steps) against the reference (the families apart), in the
    # in-process run's order: how often the steps' shapes alone move a text.
    ref_order = ([ref[f][0] for f in range(2)] + [a for f in range(2) for a in ref[f][1:n + 1]]
                 + [ref[f][n + 1] for f in range(2)])
    together_equal = sum(a["text"] == b["text"] for a, b in zip([*lprobes, *lburst, *lrepeats], ref_order))
    hop = [(a["latency_s"] - b["latency_s"]) * 1e3 / a["completion_tokens"] for a, b in zip(repeats, lrepeats)]
    res = {
        "card": card, "preset": PRESET, "warmup_ctx": DIST_WARMUP_CTX, "models": models,
        "processes_up_s": up_s, "phase_s": phase_s,
        "burst": _burst_summary(burst, wall), "in_process_burst": _burst_summary(lburst, lwall),
        "probes": [{k: a[k] for k in ("completion_tokens", "finish_reason", "ttft_s", "latency_s")} for a in probes],
        "repeats": [{k: a[k] for k in ("cached_tokens", "cached_tokens_rose", "ttft_s", "latency_s")}
                    for a in repeats],
        "in_process_repeats": [{k: a[k] for k in ("cached_tokens", "ttft_s", "latency_s")} for a in lrepeats],
        "texts_equal_reference": texts_equal, "family_steps": family_steps,
        "follow_up_first_token_ms": {"frontend": timing, "reference": ref_timing},
        "in_process_together_texts_equal_reference": together_equal,
        "hop_ms_per_token": hop, "workers": per_worker, "survivor_at_shutdown": survivor, "plane": obs,
        "black_box": black_box,
        "stats_keys": sorted(next(iter(stats.values()))),
        "surface": {**surf, "references": surface_refs},
        # The image prompts' and embeddings' part: its frontend traffic plus
        # its in-process replays and checks.
        "multimodal_seconds": (surf["multimodal"]["seconds"] + surface_refs["multimodal"]["seconds"]
                               + surface_refs["embeddings"]["seconds"]),
    }
    emit("distributed", **res)
    if checks:
        raise AssertionError("; ".join(checks))
    return res


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# checkpoint: the model served from its own files
# ---------------------------------------------------------------------------
# The phase writes every file it loads: seeded weights in Hugging Face
# safetensors shards and as a q8_0 GGUF, and a tokenizer in Llama-3's
# layout (ByteLevel BPE with ignore_merges, its Split pattern, 256 special
# tokens, a Llama-3.x chat template). The writers are plain functions, so
# the CPU tests hold the port's readers against the wheels on their files.

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*"
                  r"|\s*[\r\n]+|\s+(?!\S)|\s+")
# The chat template in the shape of Llama-3.1/3.2 Instruct's (the
# ``chat_template`` of meta-llama/Llama-3.2-1B-Instruct's
# tokenizer_config.json on the Hugging Face Hub): headers, ``<|eot_id|>``,
# the default system block with its date, tools in the first user turn.
LLAMA3_CHAT_TEMPLATE = """{{- bos_token }}
{%- if custom_tools is defined %}
    {%- set tools = custom_tools %}
{%- endif %}
{%- if not tools_in_user_message is defined %}
    {%- set tools_in_user_message = true %}
{%- endif %}
{%- if not date_string is defined %}
    {%- if strftime_now is defined %}
        {%- set date_string = strftime_now("%d %b %Y") %}
    {%- else %}
        {%- set date_string = "26 Jul 2024" %}
    {%- endif %}
{%- endif %}
{%- if not tools is defined %}
    {%- set tools = none %}
{%- endif %}

{#- This block extracts the system message, so we can slot it into the right place. #}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content']|trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}

{#- System message #}
{{- "<|start_header_id|>system<|end_header_id|>\\n\\n" }}
{%- if tools is not none %}
    {{- "Environment: ipython\\n" }}
{%- endif %}
{{- "Cutting Knowledge Date: December 2023\\n" }}
{{- "Today Date: " + date_string + "\\n\\n" }}
{%- if tools is not none and not tools_in_user_message %}
    {{- "You have access to the following functions. To call a function, please respond with JSON for a function call." }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\\n\\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\\n\\n" }}
    {%- endfor %}
{%- endif %}
{{- system_message }}
{{- "<|eot_id|>" }}

{#- Custom tools are passed in a user message with some extra guidance #}
{%- if tools_in_user_message and not tools is none %}
    {#- Extract the first user message so we can plug it in here #}
    {%- if messages | length != 0 %}
        {%- set first_user_message = messages[0]['content']|trim %}
        {%- set messages = messages[1:] %}
    {%- else %}
        {{- raise_exception("Cannot put tools in the first user message when there's no first user message!") }}
{%- endif %}
    {{- '<|start_header_id|>user<|end_header_id|>\\n\\n' -}}
    {{- "Given the following functions, please respond with a JSON for a function call " }}
    {{- "with its proper arguments that best answers the given prompt.\\n\\n" }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\\n\\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\\n\\n" }}
    {%- endfor %}
    {{- first_user_message + "<|eot_id|>"}}
{%- endif %}

{%- for message in messages %}
    {%- if not (message.role == 'ipython' or message.role == 'tool' or 'tool_calls' in message) %}
        {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n'+ message['content'] | trim + '<|eot_id|>' }}
    {%- elif 'tool_calls' in message %}
        {%- if not message.tool_calls|length == 1 %}
            {{- raise_exception("This model only supports single tool-calls at once!") }}
        {%- endif %}
        {%- set tool_call = message.tool_calls[0].function %}
        {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' -}}
        {{- '{"name": "' + tool_call.name + '", ' }}
        {{- '"parameters": ' }}
        {{- tool_call.arguments | tojson }}
        {{- "}" }}
        {{- "<|eot_id|>" }}
    {%- elif message.role == "tool" or message.role == "ipython" %}
        {{- "<|start_header_id|>ipython<|end_header_id|>\\n\\n" }}
        {%- if message.content is mapping or message.content is iterable %}
            {{- message.content | tojson }}
        {%- else %}
            {{- message.content }}
        {%- endif %}
        {{- "<|eot_id|>" }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}
{%- endif %}
"""
def llama3_special_tokens(n: int = 256) -> list:
    """Llama-3.1's added tokens, in id order from 128000."""
    named = ["<|begin_of_text|>", "<|end_of_text|>", "<|reserved_special_token_0|>",
             "<|reserved_special_token_1|>", "<|finetune_right_pad_id|>", "<|reserved_special_token_2|>",
             "<|start_header_id|>", "<|end_header_id|>", "<|eom_id|>", "<|eot_id|>", "<|python_tag|>"]
    return (named + [f"<|reserved_special_token_{k}|>" for k in range(3, 3 + n)])[:n]


def corpus_words(root: str = ".") -> list:
    """Pieces of the checkout's own Markdown text (a word with its leading
    space, a digit, a run of punctuation, a run of newlines), the most
    frequent first, ties by text."""
    import collections
    import glob
    import os
    import re

    counts = collections.Counter()
    for path in sorted(glob.glob(os.path.join(root, "*.md"))):
        with open(path, encoding="utf-8", errors="replace") as f:
            counts.update(re.findall(r" ?[A-Za-z]+| ?[0-9]| ?[^\sA-Za-z0-9]+|\n+", f.read()))
    return [w for w, _ in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))]


def bpe_vocab(alphabet: list, words: list, size: int, seed: int, max_len: int = 16) -> tuple:
    """A BPE vocabulary of ``size`` tokens and its merges: ``alphabet``
    first, then each of ``words`` (spelled in the alphabet's symbols)
    built as a chain of merges, left to right, then seeded pairs of
    existing tokens up to ``max_len`` characters (many of which no merge
    order reaches: the case ``ignore_merges`` changes)."""
    vocab = {t: i for i, t in enumerate(alphabet)}
    merges = []
    for w in words:
        if len(vocab) >= size:
            break
        cur = w[0]
        for ch in w[1:]:
            if cur + ch not in vocab:
                if len(vocab) >= size:
                    break
                vocab[cur + ch] = len(vocab)
                merges.append([cur, ch])
            cur += ch
    rng = np.random.default_rng(seed)
    toks = list(vocab)
    while len(vocab) < size:
        # Pairs drawn in batches from the tokens there are when the batch starts.
        for i, j in rng.integers(len(toks), size=(4096, 2)).tolist():
            a, b = toks[i], toks[j]
            if len(a) + len(b) <= max_len and a + b not in vocab and len(vocab) < size:
                vocab[a + b] = len(vocab)
                merges.append([a, b])
                toks.append(a + b)
    return vocab, merges


def llama3_tokenizer_spec(size: int = 128000, n_special: int = 256, seed: int = 0, root: str = ".") -> dict:
    """A ``tokenizer.json`` in Llama-3's layout: ``size`` ByteLevel BPE
    tokens (the 256 byte symbols, ``corpus_words`` as merge chains, then
    seeded pairs) with ``ignore_merges``, Llama-3's Split pattern, and
    ``n_special`` special tokens from id ``size``."""
    from dynamo_tpu_torch.llm.tokenizer_json import BYTE_TO_CHAR, bytelevel

    alphabet = [BYTE_TO_CHAR[b] for b in range(256)]
    vocab, merges = bpe_vocab(alphabet, [bytelevel(w) for w in corpus_words(root)], size, seed)
    byte_level = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": True}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": size + i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True} for i, t in enumerate(llama3_special_tokens(n_special))],
        "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN}, "behavior": "Isolated", "invert": False},
            {**byte_level, "use_regex": False}]},
        "post_processor": {"type": "Sequence", "processors": [
            {**byte_level, "trim_offsets": False},
            {"type": "TemplateProcessing",
             "single": [{"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 0}},
                        {"Sequence": {"id": "A", "type_id": 0}}],
             "pair": [{"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                      {"SpecialToken": {"id": "<|begin_of_text|>", "type_id": 1}}, {"Sequence": {"id": "B", "type_id": 1}}],
             "special_tokens": {"<|begin_of_text|>": {"id": "<|begin_of_text|>", "ids": [size],
                                                      "tokens": ["<|begin_of_text|>"]}}}]},
        "decoder": byte_level,
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges},
    }


def write_tokenizer(directory: str, spec: dict, chat_template: Optional[str] = LLAMA3_CHAT_TEMPLATE,
                    bos_token: str = "<|begin_of_text|>", eos_token: str = "<|eot_id|>") -> None:
    """``tokenizer.json`` and a ``tokenizer_config.json`` (BOS and EOS
    tokens, the chat template; Llama-3's by default)."""
    import os

    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    cfg = {"bos_token": bos_token, "eos_token": eos_token, "chat_template": chat_template,
           "model_max_length": 131072, "tokenizer_class": "PreTrainedTokenizerFast"}
    with open(os.path.join(directory, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(cfg, f, ensure_ascii=False, indent=2)


_ST_DTYPES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32", torch.int8: "I8"}


def write_safetensors(path: str, tensors: dict) -> None:
    """A ``.safetensors`` file (name → tensor, written in order, each
    tensor's bytes as they lie in memory), with no wheel: the 8-byte header
    length, the JSON header padded with spaces to 8 bytes, the data."""
    import struct

    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())


def hf_layer_tensor(params, key: str, layer: int) -> torch.Tensor:
    """One layer's weight in HF's layout (``[out, in]`` for a matrix)."""
    w = params["layers"][key][layer]
    return w if w.dim() == 1 else w.T


def write_hf_checkpoint(directory: str, params, config, shards: int = 2) -> list:
    """``config.json`` and the weights as ``shards`` safetensors files
    (``model-0000k-of-0000n.safetensors``: the embedding with the first
    layers, the final norm and head with the last), in the params' dtype.
    → the files' paths."""
    import os

    from dynamo_tpu_torch.engine.weights import HF_NAMES

    os.makedirs(directory, exist_ok=True)
    L = config.num_layers
    hf = {"architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": config.vocab_size,
          "hidden_size": config.hidden_size, "num_hidden_layers": L, "num_attention_heads": config.num_heads,
          "num_key_value_heads": config.num_kv_heads, "head_dim": config.head_dim,
          "intermediate_size": config.intermediate_size, "rope_theta": config.rope_theta,
          "rms_norm_eps": config.rms_norm_eps, "max_position_embeddings": config.max_seq_len,
          "tie_word_embeddings": config.tie_word_embeddings, "torch_dtype": "bfloat16"}
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(hf, f, indent=2)
    bounds = [round(L * k / shards) for k in range(shards + 1)]
    paths = []
    for k in range(shards):
        tensors = {HF_NAMES["embed"]: params["embed"]} if k == 0 else {}
        for l in range(bounds[k], bounds[k + 1]):
            tensors.update({fmt.format(l): hf_layer_tensor(params, key, l)
                            for key, fmt in HF_NAMES.items() if "{}" in fmt})
        if k == shards - 1:
            tensors[HF_NAMES["final_norm"]] = params["final_norm"]
            if "lm_head" in params:
                tensors[HF_NAMES["lm_head"]] = params["lm_head"].T
        path = os.path.join(directory, f"model-{k + 1:05d}-of-{shards:05d}.safetensors")
        write_safetensors(path, tensors)
        paths.append(path)
    return paths


def q8_0_blocks(x: torch.Tensor) -> tuple:
    """ggml's q8_0 of a flat f32 tensor (32 elements a block: an f16 scale
    amax / 127 and 32 int8 codes), on its device → (the blocks' bytes, their
    dequantized f32 values, scale × code)."""
    b = x.reshape(-1, 32)
    d = b.abs().amax(dim=1, keepdim=True) / 127.0
    inv = torch.where(d != 0, 1.0 / d, torch.zeros_like(d))
    q = torch.clamp(torch.round(b * inv), -127, 127).to(torch.int8)
    d16 = d.to(torch.float16)
    raw = torch.cat([d16.view(torch.uint8), q.view(torch.uint8)], dim=1)
    return raw.cpu().numpy().tobytes(), (q.float() * d16.float()).reshape(-1)


def write_gguf_q8_0(path: str, params, config) -> dict:
    """The params as a GGUF v3 file: matrices in q8_0 (quantized on the
    params' device), norms in f32, llama metadata (no RoPE scaling). → the
    dequantized values each tensor reads back as, name → f32 tensor in HF
    layout on the params' device."""
    import struct

    from dynamo_tpu_torch.engine.weights import GGUF_NAMES

    def s(text: str) -> bytes:
        b = text.encode()
        return struct.pack("<Q", len(b)) + b

    c = config
    meta = [("general.architecture", 8, s("llama")), ("general.name", 8, s(c.name)),
            ("general.alignment", 4, struct.pack("<I", 32)),
            ("llama.context_length", 4, struct.pack("<I", c.max_seq_len)),
            ("llama.block_count", 4, struct.pack("<I", c.num_layers)),
            ("llama.embedding_length", 4, struct.pack("<I", c.hidden_size)),
            ("llama.feed_forward_length", 4, struct.pack("<I", c.intermediate_size)),
            ("llama.attention.head_count", 4, struct.pack("<I", c.num_heads)),
            ("llama.attention.head_count_kv", 4, struct.pack("<I", c.num_kv_heads)),
            ("llama.attention.key_length", 4, struct.pack("<I", c.head_dim)),
            ("llama.rope.freq_base", 6, struct.pack("<f", c.rope_theta)),
            ("llama.attention.layer_norm_rms_epsilon", 6, struct.pack("<f", c.rms_norm_eps))]
    named = [(GGUF_NAMES["embed"], params["embed"]), (GGUF_NAMES["final_norm"], params["final_norm"])]
    if "lm_head" in params:
        named.append((GGUF_NAMES["lm_head"], params["lm_head"].T))
    for l in range(c.num_layers):
        named += [(fmt.format(l), hf_layer_tensor(params, key, l)) for key, fmt in GGUF_NAMES.items() if "{}" in fmt]
    infos, offset = [], 0
    for name, t in named:
        gtype = 8 if t.dim() == 2 and t.numel() % 32 == 0 else 0
        n = t.numel() * 34 // 32 if gtype == 8 else t.numel() * 4
        infos.append((name, list(reversed(t.shape)), gtype, offset))
        offset += n + (-n % 32)
    head = b"GGUF" + struct.pack("<IQQ", 3, len(named), len(meta))
    for key, vtype, raw in meta:
        head += s(key) + struct.pack("<I", vtype) + raw
    for name, dims, gtype, off in infos:
        head += s(name) + struct.pack("<I", len(dims)) + b"".join(struct.pack("<Q", d) for d in dims)
        head += struct.pack("<IQ", gtype, off)
    head += b"\0" * (-len(head) % 32)
    values = {}
    with open(path, "wb") as f:
        f.write(head)
        for (name, t), (_, _, gtype, _) in zip(named, infos):
            x = t.detach().float().contiguous()
            if gtype == 8:
                raw, deq = q8_0_blocks(x.reshape(-1))
                values[name] = deq.reshape(x.shape)
            else:
                raw, values[name] = x.cpu().numpy().tobytes(), x
            f.write(raw + b"\0" * (-len(raw) % 32))
    return values


def params_from_hf(values: dict, config, device, dtype, names: dict) -> dict:
    """Port params from HF-layout f32 tensors (``names``: a layer key → its
    name format, with "embed", "final_norm" and "lm_head" too)."""
    L = config.num_layers

    def dev(a, transpose=False):
        t = a.to(device)
        return (t.T if transpose else t).to(dtype).contiguous()

    out = {"embed": dev(values[names["embed"]]), "final_norm": dev(values[names["final_norm"]]),
           "layers": {k: torch.stack([dev(values[fmt.format(l)], transpose=not k.endswith("_norm"))
                                      for l in range(L)]) for k, fmt in names.items() if "{}" in fmt}}
    if names["lm_head"] in values:
        out["lm_head"] = dev(values[names["lm_head"]], transpose=True)
    return out


class RssPeak:
    """The process's resident set, sampled every 2 ms inside the ``with``
    block (``VmRSS``), and ``ru_maxrss``: → {"before", "peak", "maxrss"}
    bytes."""

    def __enter__(self):
        self.before = self._rss()
        self.peak = self.before
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()
        return self

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _run(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(timeout=5)
        import resource

        self.summary = {"rss_before_bytes": self.before, "rss_peak_bytes": max(self.peak, self._rss()),
                        "ru_maxrss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}


class TokenRecorder:
    """Inside the ``with`` block: the request ids in the order the scheduler
    takes them, and every token it appends for each."""

    def __init__(self, sched):
        self.sched, self.order, self.tokens = sched, [], {}

    def __enter__(self):
        add, append = self.sched.add_request, self.sched._append_token
        self.orig = add, append

        def add_request(rid, *args, **kwargs):
            self.order.append(rid)
            return add(rid, *args, **kwargs)

        def append_token(seq, token, *args, **kwargs):
            self.tokens.setdefault(seq.request_id, []).append(int(token))
            return append(seq, token, *args, **kwargs)

        self.sched.add_request, self.sched._append_token = add_request, append_token
        return self

    def __exit__(self, *exc):
        self.sched.add_request, self.sched._append_token = self.orig

    def in_order(self) -> list:
        return [self.tokens.get(rid, []) for rid in self.order]


async def held_burst(service, engine, model: str, reqs: list) -> dict:
    """Send ``reqs`` while the engine's step thread is held, each once the
    one before it is staged, then release: every service admits the burst
    in the same order and runs the same steps (bf16 products round by the
    step's shape, so equal weights give equal tokens only under equal
    batching). → answers (status, data, first-token seconds after the
    release, seconds), each request's token ids, wall seconds."""
    sched = engine.scheduler
    gate = threading.Event()
    blocker = engine._step_thread.submit(gate.wait)
    firsts = [None] * len(reqs)
    futs = []
    with TokenRecorder(sched) as rec:
        try:
            for i, (url, body) in enumerate(reqs):
                def first(i=i):
                    firsts[i] = time.perf_counter()
                futs.append(asyncio.ensure_future(asyncio.to_thread(
                    _request, service.port, url, {**body, "model": model}, first)))
                while len(engine._staged_adds) + len(sched.by_id) < i + 1:
                    if futs[-1].done():
                        futs[-1].result()
                        raise AssertionError(f"request {i} ended before it was staged: {futs[-1].result()}")
                    await asyncio.sleep(0.001)
        finally:
            t0 = time.perf_counter()
            gate.set()
        results = await asyncio.gather(*futs)
        wall = time.perf_counter() - t0
        blocker.result()
    return {"results": results, "ttft_s": [None if f is None else f - t0 for f in firsts],
            "ids": rec.in_order(), "wall_s": wall}


def chat_requests(tokenizer, sizes: list, start: int = 0, root: str = ".") -> list:
    """Greedy chat requests of the checkout's README text, one of about
    each of ``sizes`` tokens (consecutive words from word ``start``, a new
    stretch for each), 64 tokens each, every other one streamed."""
    import os

    with open(os.path.join(root, "README.md"), encoding="utf-8") as f:
        words = f.read().split()
    reqs = []
    for k, tokens in enumerate(sizes):
        at = (start + 400 * k) % max(1, len(words) - 2000)
        n = 8
        while len(tokenizer.encode(" ".join(words[at:at + n]))) < tokens and at + n < len(words):
            n += max(1, (tokens - len(tokenizer.encode(" ".join(words[at:at + n])))) // 4)
        reqs.append(("/v1/chat/completions", {"messages": [{"role": "user", "content": " ".join(words[at:at + n])}],
                                              "max_tokens": 64, "temperature": 0.0, "stream": k % 2 == 0}))
    return reqs


# The checkpoint phase's structured request: a finite grammar (an enum and
# a boolean, both required), so its answer always completes and parses.
CKPT_SCHEMA = {"type": "object", "properties": {"city": {"enum": ["SF", "NY", "LA"]}, "ok": {"type": "boolean"}},
               "required": ["city", "ok"]}


def checkpoint_traffic(tokenizer) -> list:
    """The burst: 8 greedy chat requests (2 of about 1500 tokens, 6 of
    30–200; one behind a system prompt) and a ``json_schema`` one
    (``CKPT_SCHEMA``, streamed)."""
    reqs = chat_requests(tokenizer, [1500, 1480, 30, 60, 90, 120, 150, 200])
    reqs[6][1]["messages"].insert(0, {"role": "system", "content": "You answer in English."})
    guided = chat_requests(tokenizer, [40], start=50)[0]
    guided[1].update(stream=True, response_format={"type": "json_schema",
                                                   "json_schema": {"name": "city", "schema": CKPT_SCHEMA}})
    return reqs + [guided]


def answer_texts(reqs: list, burst: dict) -> list:
    out = []
    for (url, body), (status, data, _, _) in zip(reqs, burst["results"]):
        n, finish, _ = _summarize(status, data, body.get("stream", False))
        out.append({"text": _answer_text(data, bool(body.get("stream")), "chat" in url), "tokens": n,
                    "finish_reason": finish})
    return out


def serve_launches(counts: dict, steps: dict, L: int) -> tuple:
    """(launches, the launches the steps and windows expect on the
    megakernel path with fused windows, plain calls)."""
    expected = {"ragged_paged_attention": L * (steps["forward"] + steps["window_steps_total"]
                                               + steps["draft_prefill_steps_total"]),
                "fused_decode_window": steps["fused_windows_total"],
                "fused_decode_window_sampled": steps["fused_sampled_windows_total"],
                "fused_decode_window_guided": steps["fused_guided_windows_total"],
                "fused_spec_window": steps["spec_fused_windows_total"]}
    launches = {name: c["launches"] for name, c in counts.items()}
    return launches, {name: expected.get(name, 0) for name in launches}, sum(c["plain_calls"] for c in counts.values())


STEP_KINDS = ("forward", "prefill", "decode", "mixed")
SCHED_COUNTERS = WINDOW_COUNTERS + ("draft_prefill_steps_total", "spec_fused_windows_total", "spec_rounds_total")


def sched_steps(sched) -> dict:
    out = {k: getattr(sched, f"{k}_steps_total") for k in STEP_KINDS}
    out.update({k: getattr(sched, k) for k in SCHED_COUNTERS})
    return out


async def serve_files(argv: list, bursts: list, *, params=None, draft_params=None, check=None) -> dict:
    """``run.build_service`` over ``argv`` (and ``params`` /
    ``draft_params``) with a second model, ``"llama3-chat"``, whose
    pipeline (``build_local_pipeline``) carries a card with the Llama-3.x
    chat template; each of ``bursts`` sent to it as a held burst, the
    kernel counts zeroed just before each. ``check(engine)`` runs before
    the first. → each burst with its counts and steps, the loads' seconds
    and host RSS, the build's seconds, ``check``'s result and the warmup."""
    from dynamo_tpu_torch import run
    from dynamo_tpu_torch.engine import engine as engine_mod
    from dynamo_tpu_torch.llm.entrypoint import build_local_pipeline
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard

    args = run.parse_args(["in=http", f"out={PRESET}", "--http-host", "127.0.0.1", "--http-port", "0", *argv])
    gc.collect()
    torch.cuda.empty_cache()
    loads = []
    load = engine_mod.load_checkpoint

    def timed_load(*a, **kw):
        torch.cuda.synchronize()
        with RssPeak() as rss:
            t = time.perf_counter()
            out = load(*a, **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
        loads.append({"seconds": seconds, **rss.summary})
        return out

    engine_mod.load_checkpoint = timed_load
    try:
        t0 = time.perf_counter()
        service, engine = run.build_service(args, params=params, draft_params=draft_params)
        build_s = time.perf_counter() - t0
    finally:
        engine_mod.load_checkpoint = load
    sched = engine.scheduler
    card = ModelDeploymentCard(name="llama3-chat", model_type="chat", chat_template=LLAMA3_CHAT_TEMPLATE,
                               kv_cache_block_size=sched.mc.block_size)
    # The tokenizer build_service loaded and attached for guided decoding.
    service.manager.add_model("chat", "llama3-chat", build_local_pipeline(sched.guided.tokenizer, engine, card))
    await service.start()
    out = {"build_s": build_s, "loads": loads, "warmup": sched.warmup_stats, "L": sched.mc.num_layers,
           "bursts": []}
    try:
        out["check"] = check(engine) if check is not None else None
        for reqs in bursts:
            steps0 = sched_steps(sched)
            reset_counts()  # counts from zero, just before the main path runs
            burst = await held_burst(service, engine, "llama3-chat", reqs)
            burst["counts"] = read_counts()
            burst["steps"] = {k: v - steps0[k] for k, v in sched_steps(sched).items()}
            out["bursts"].append(burst)
        out["captures_after_warmup"] = sched.graph_captures_after_warmup
        out["grammar_compile_s"] = sched.guided.compile_seconds_total
    finally:
        await service.stop()
        await engine.stop()
    return out


def tensors_equal(a: dict, b: dict) -> list:
    """Names of the params that differ (any bit) between two trees."""
    from dynamo_tpu_torch.engine.quant import QuantW

    bad = []
    for k in ("embed", "final_norm", "lm_head"):
        if (k in a) != (k in b) or (k in a and not torch.equal(a[k], b[k])):
            bad.append(k)
    for k, v in a["layers"].items():
        w = b["layers"][k]
        if isinstance(v, QuantW) != isinstance(w, QuantW):
            bad.append(k)
        elif isinstance(v, QuantW):
            if not (torch.equal(v.q, w.q) and torch.equal(v.scale, w.scale)):
                bad.append(k)
        elif not torch.equal(v, w):
            bad.append(k)
    return bad


def tokenizer_costs(tok_dir: str, prompt: str) -> dict:
    """Host costs of the real-vocabulary tokenizer: its load, a ~1500-token
    encode (cold, then with its word cache warm), ``DecodeStream.step`` at
    output positions 64 and 1024, and guided decoding's per-id strings."""
    from dynamo_tpu_torch.llm.guided.processor import GuidedDecoder
    from dynamo_tpu_torch.llm.tokenizer import DecodeStream, load_tokenizer

    t0 = time.perf_counter()
    tok = load_tokenizer(tok_dir)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids = tok.encode(prompt)
    cold_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    tok.encode(prompt)
    warm_ms = 1e3 * (time.perf_counter() - t0)
    stream_ids = (ids * 2)[:1024]
    detok = {}
    for pos in (64, 1024):
        stream = DecodeStream(tok)
        stream.step(stream_ids[:pos - 8])
        t0 = time.perf_counter()
        for t in stream_ids[pos - 8:pos]:
            stream.step([t])
        detok[f"us_per_token_at_{pos}"] = 1e6 * (time.perf_counter() - t0) / 8
    t0 = time.perf_counter()
    GuidedDecoder(tok, pool_rows=1, device="cpu")._token_strings()
    return {"tokenizer_load_s": load_s, "vocab_size": tok.vocab_size, "encode_tokens": len(ids),
            "encode_ms_cold": cold_ms, "encode_ms_warm": warm_ms, **detok,
            "token_strings_s": time.perf_counter() - t0}


def first_divergence(a: list, b: list) -> list:
    """Per request, the index of the first token where two id lists part
    (their length when they agree)."""
    out = []
    for x, y in zip(a, b):
        n = next((i for i, (p, q) in enumerate(zip(x, y)) if p != q), min(len(x), len(y)))
        out.append(n)
    return out


def phase_checkpoint(card: str, dev) -> dict:
    """Serve ``PRESET`` from files the phase writes: seeded bf16 weights
    (``init_params``) as two HF safetensors shards, a Llama-3-layout
    ``tokenizer.json`` of 128,000 BPE tokens and 256 special tokens with a
    Llama-3.x chat template, and a q8_0 GGUF of the same weights. Through
    ``run.build_service`` (``--checkpoint``/``--tokenizer``) with the
    defaults (32-step windows, ``--warmup-ctx 2048``) and a second model
    whose pipeline carries a card with the template, a held burst of 8
    greedy chat requests of README text and one ``json_schema``: the loaded
    weights must be bit-equal to the written ones, the token ids equal to
    those of the same service built with ``params=`` the written weights
    (no warmup), each answer's text the tokenizer's decode of its ids, the
    structured answer complete JSON in its grammar, the ragged kernel 16
    launches a forward step, each fused window one launch, no plain call
    and no graph captured after the warmup. Then: self-speculation
    (``--draft-model``/``--draft-checkpoint`` on the same files, 2
    requests) through the fused spec window, its ids equal to the same
    service given the weights as ``params=``/``draft_params=`` (the first
    divergence from the non-speculative stream is reported: bf16 verify
    and decode round apart); ``--weight-dtype int8 --kv-cache-dtype int8``
    (2 requests of 200 tokens: only the ragged kernel's int8 branch
    launches, and the loaded codes and scales equal
    ``quant.quantize_weight`` of the written weights); and the GGUF (2
    requests: ids equal to a service given ``params=`` its dequantized
    values). Prints each load's seconds, GB/s and host RSS around it, and
    the tokenizer's host costs."""
    import os
    import tempfile

    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.quant import QUANT_KEYS, quantize_weight
    from dynamo_tpu_torch.engine.weights import GGUF_NAMES, init_params
    from dynamo_tpu_torch.llm.tokenizer import load_tokenizer

    cfg = get_config(PRESET)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    res: dict = {"card": card, "preset": PRESET}
    parts = {}
    t_part = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    try:
        ckpt, tok_dir, gguf = (os.path.join(root, d) for d in ("hf", "tokenizer", "model-q8_0.gguf"))
        written = init_params(cfg, torch.Generator(device=dev).manual_seed(1234), device=dev, dtype=torch.bfloat16)
        hf_bytes = sum(os.path.getsize(p) for p in write_hf_checkpoint(ckpt, written, cfg))
        part("write_hf")
        write_tokenizer(tok_dir, llama3_tokenizer_spec(size=cfg.vocab_size - 256, n_special=256))
        tok = load_tokenizer(tok_dir)
        reqs = checkpoint_traffic(tok)
        res["prompt_tokens"] = [len(tok.encode(b["messages"][-1]["content"])) for _, b in reqs]
        part("write_tokenizer")
        res["tokenizer"] = tokenizer_costs(tok_dir, reqs[0][1]["messages"][-1]["content"])
        emit("checkpoint_tokenizer", card=card, **res["tokenizer"])
        part("tokenizer_costs")
        files = ["--checkpoint", ckpt, "--tokenizer", tok_dir]
        two = [reqs[2], reqs[7]]

        # bf16 from the shards, warmed up; then the 2 requests the spec
        # services send, on the same engine.
        main = asyncio.run(serve_files([*files, "--warmup-ctx", str(WARMUP_CTX)], [reqs, two],
                                       check=lambda e: tensors_equal(e.scheduler.params, written)))
        part("bf16")
        ref = asyncio.run(serve_files(["--tokenizer", tok_dir], [reqs], params=written))
        part("bf16_params")
        burst = main["bursts"][0]
        eos = set(tok.eos_token_ids)
        answers = answer_texts(reqs, burst)
        for a, ids in zip(answers, burst["ids"]):
            a["decode_equal"] = a["text"] == tok.decode([t for t in ids if t not in eos])
        guided = answers[-1]
        try:
            json.loads(guided["text"])
            guided["parsed"] = True
        except json.JSONDecodeError:
            guided["parsed"] = False
        guided["in_grammar"] = grammar_holds(reqs[-1][1], guided["text"], guided["finish_reason"])
        launches, want, plain = serve_launches(burst["counts"], burst["steps"], main["L"])
        completion = sum(a["tokens"] for a in answers)
        ttfts = [t for t in burst["ttft_s"] if t is not None]
        load = main["loads"][0]
        res["bf16"] = {
            "load_s": load["seconds"], "load_gb_per_s": hf_bytes / load["seconds"] / 1e9, "file_bytes": hf_bytes,
            "rss": {k: v for k, v in load.items() if k != "seconds"}, "build_s": main["build_s"],
            "warmup": main["warmup"], "weights_differ": main["check"],
            "ids_equal_params": burst["ids"] == ref["bursts"][0]["ids"],
            "answers": [{k: a[k] for k in ("tokens", "finish_reason", "decode_equal")} for a in answers],
            "guided": guided, "grammar_compile_s": main["grammar_compile_s"], "steps": burst["steps"],
            "kernel_launches": launches, "expected_launches": want, "plain_calls": plain,
            "captures_after_warmup": main["captures_after_warmup"],
            "decode_tok_per_s": completion / burst["wall_s"], "wall_s": burst["wall_s"],
            "ttft_p50_s": statistics.median(ttfts), "ttft_n": len(ttfts)}
        emit("checkpoint_bf16", card=card, **res["bf16"])
        b = res["bf16"]
        if b["weights_differ"]:
            raise AssertionError(f"the loaded bf16 weights differ from the written ones: {b['weights_differ']}")
        if not b["ids_equal_params"]:
            raise AssertionError("the checkpoint's token ids differ from the params= service's")
        if not all(a["decode_equal"] for a in answers):
            raise AssertionError(f"an answer's text is not the decode of its ids: {answers}")
        if not (guided["parsed"] and guided["in_grammar"] and guided["finish_reason"] == "stop"):
            raise AssertionError(f"the json_schema answer is not complete JSON in its grammar: {guided}")
        steps = burst["steps"]
        if launches != want or plain or b["captures_after_warmup"] or steps["multi_windows_total"] \
                or not steps["fused_windows_total"] or not steps["fused_guided_windows_total"]:
            raise AssertionError(f"checkpoint launches {launches} != {want}, plain {plain}, steps {steps}, "
                                 f"captures after warmup {b['captures_after_warmup']}")
        non_spec_ids = main["bursts"][1]["ids"]
        del main, ref

        # Self-speculation from the same files, against the same service
        # given the weights.
        spec_argv = ["--draft-model", PRESET, "--spec-gamma", str(SPEC_GAMMA)]
        spec = asyncio.run(serve_files([*files, *spec_argv, "--draft-checkpoint", ckpt], [two]))
        # A copy of the weights for the draft, as the checkpoint's draft is one.
        copy = {k: ({n: w.clone() for n, w in v.items()} if k == "layers" else v.clone()) for k, v in written.items()}
        spec_ref = asyncio.run(serve_files(["--tokenizer", tok_dir, *spec_argv], [two], params=written,
                                           draft_params=copy))
        del copy
        part("spec")
        s_burst = spec["bursts"][0]
        s_launch, s_want, s_plain = serve_launches(s_burst["counts"], s_burst["steps"], spec["L"])
        res["spec"] = {"ids_equal_params": s_burst["ids"] == spec_ref["bursts"][0]["ids"],
                       "load_s": [ld["seconds"] for ld in spec["loads"]], "steps": s_burst["steps"],
                       "kernel_launches": s_launch, "plain_calls": s_plain,
                       "tokens_before_non_spec_divergence": first_divergence(s_burst["ids"], non_spec_ids),
                       "tokens": [len(i) for i in s_burst["ids"]]}
        emit("checkpoint_spec", card=card, **res["spec"])
        if not res["spec"]["ids_equal_params"] or not s_burst["steps"]["spec_fused_windows_total"] or s_plain \
                or s_launch["fused_spec_window"] != s_want["fused_spec_window"]:
            raise AssertionError(f"self-speculation from the checkpoint: {res['spec']}")
        del spec, spec_ref

        # int8 weights and KV from the same files.
        def codes_differ(engine):
            p = engine.scheduler.params
            bad = set()
            for k in QUANT_KEYS:
                for l in range(cfg.num_layers):
                    want_q = quantize_weight(written["layers"][k][l])
                    if not (torch.equal(p["layers"][k].q[l], want_q.q)
                            and torch.equal(p["layers"][k].scale[l], want_q.scale)):
                        bad.add(k)
            return sorted(bad)

        q8 = asyncio.run(serve_files([*files, "--weight-dtype", "int8", "--kv-cache-dtype", "int8"],
                                     [chat_requests(tok, [200, 200], start=2000)], check=codes_differ))
        part("int8")
        q_burst = q8["bursts"][0]
        q_launch = {n: c["launches"] for n, c in q_burst["counts"].items()}
        q_plain = sum(c["plain_calls"] for c in q_burst["counts"].values())
        load = q8["loads"][0]
        res["int8"] = {"load_s": load["seconds"], "load_gb_per_s": hf_bytes / load["seconds"] / 1e9,
                       "rss": {k: v for k, v in load.items() if k != "seconds"}, "codes_differ": q8["check"],
                       "steps": q_burst["steps"], "kernel_launches": q_launch, "plain_calls": q_plain,
                       "tokens": [len(i) for i in q_burst["ids"]]}
        emit("checkpoint_int8", card=card, **res["int8"])
        others = {n: v for n, v in q_launch.items() if n != "ragged_paged_attention_int8" and v}
        reached = q8["L"] * (q_burst["steps"]["forward"] + q_burst["steps"]["window_steps_total"])
        if q8["check"] or others or q_plain or q_launch["ragged_paged_attention_int8"] < reached \
                or q_launch["ragged_paged_attention_int8"] % q8["L"]:
            raise AssertionError(f"int8 from the checkpoint: {res['int8']}")
        del q8

        # The q8_0 GGUF, against params= its dequantized values.
        values = write_gguf_q8_0(gguf, written, cfg)
        deq = params_from_hf(values, cfg, dev, torch.bfloat16, GGUF_NAMES)
        del values
        part("write_gguf")
        g = asyncio.run(serve_files(["--checkpoint", gguf, "--tokenizer", tok_dir], [two],
                                    check=lambda e: tensors_equal(e.scheduler.params, deq)))
        g_ref = asyncio.run(serve_files(["--tokenizer", tok_dir], [two], params=deq))
        part("gguf")
        g_plain = sum(c["plain_calls"] for c in g["bursts"][0]["counts"].values())
        load = g["loads"][0]
        res["gguf"] = {"load_s": load["seconds"], "file_bytes": os.path.getsize(gguf),
                       "load_gb_per_s": os.path.getsize(gguf) / load["seconds"] / 1e9,
                       "rss": {k: v for k, v in load.items() if k != "seconds"}, "params_differ": g["check"],
                       "ids_equal_params": g["bursts"][0]["ids"] == g_ref["bursts"][0]["ids"], "plain_calls": g_plain}
        emit("checkpoint_gguf", card=card, **res["gguf"])
        if g["check"] or not res["gguf"]["ids_equal_params"] or g_plain:
            raise AssertionError(f"GGUF: {res['gguf']}")
        del g, g_ref, deq, written
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    res["seconds"] = parts
    emit("checkpoint_seconds", card=card, **parts)
    return res


def phase_grammar(card: str) -> dict:
    """Not in the default run: the host seconds to compile a
    ``json_object`` grammar's token FSM over a Llama-3-layout vocabulary
    of 128,256 ids (what the first ``json_object`` request to a served
    model waits for), beside the same over the byte tokenizer's 256."""
    import tempfile

    from dynamo_tpu_torch.llm.guided.fsm import compile_token_fsm
    from dynamo_tpu_torch.llm.guided.grammar import build_guided_spec, compile_regex
    from dynamo_tpu_torch.llm.guided.processor import GuidedDecoder
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer, load_tokenizer

    pattern = build_guided_spec({"response_format": {"type": "json_object"}})["pattern"]
    res = {"card": card}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_grammar_") as root:
        write_tokenizer(root, llama3_tokenizer_spec())
        for name, tok in (("bytes", ByteTokenizer()), ("llama3_vocab", load_tokenizer(root))):
            strs = GuidedDecoder(tok, pool_rows=1, device="cpu")._token_strings()
            t0 = time.perf_counter()
            fsm = compile_token_fsm(compile_regex(pattern), strs, tok.eos_token_ids)
            res[name] = {"vocab_size": tok.vocab_size, "json_object_compile_s": time.perf_counter() - t0,
                         "states": fsm.num_states}
    emit("grammar", **res)
    return res


# ---------------------------------------------------------------------------
# kvbm: the KV block manager's tiers on the card
# ---------------------------------------------------------------------------

KVBM_G1_BLOCKS = 256  # 255 usable: the traffic's 6 × 66 cached blocks evict
KVBM_HOST_BLOCKS = 80  # G2 spills to G3
KVBM_DISK_BLOCKS = 1024
KVBM_PROMPT = 1000
KVBM_WARMUP_CTX = 1280  # every step graph of 1,064-token contexts


def kvbm_traffic(vocab_size: int) -> list:
    """Six distinct prompts of ``KVBM_PROMPT`` seeded token ids, then
    repeats of the second (onboarded from G2), of the first (from G3) and
    of the second again (a G1 hit: its blocks were onboarded)."""
    rng = np.random.default_rng(31)
    prompts = [rng.integers(1, min(vocab_size, 100000), size=KVBM_PROMPT).tolist() for _ in range(6)]
    return prompts + [prompts[1], prompts[0], prompts[1]]


def block_digest(k: torch.Tensor, v: torch.Tensor) -> str:
    import hashlib

    h = hashlib.sha1()
    for t in (k, v):
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


async def engine_answer(engine, tokens: list, max_tokens: int = 64) -> dict:
    """One greedy request straight to ``TorchEngine.generate`` → its ids,
    TTFT, latency and cached tokens."""
    from dynamo_tpu_torch.runtime.engine import Context

    req = {"token_ids": tokens, "sampling_options": {"temperature": 0.0},
           "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}
    t0 = time.perf_counter()
    ids, first, cached = [], None, None
    async for frame in engine.generate(req, Context()):
        if first is None and frame["token_ids"]:
            first = time.perf_counter() - t0
            cached = frame.get("cached_tokens")
        ids += frame["token_ids"]
    return {"ids": ids, "ttft_s": first, "latency_s": time.perf_counter() - t0, "cached_tokens": cached}


class KvbmProbe:
    """Wraps one engine's KVBM: each block's bytes at its first offload
    (a digest), each drain's device → host copy (blocks, seconds), each
    onboard (its hashes, G1 blocks and tiers, the tiers' read seconds and
    the upload's), so the onboarded blocks can be read back from G1."""

    def __init__(self, kvbm):
        self.evicted, self.drains, self.onboards = {}, [], []
        put, to_host, onboard, upload = kvbm._cascade_put, kvbm._to_host, kvbm.onboard, kvbm._upload

        def traced_put(h, k, v):
            self.evicted.setdefault(h, block_digest(k, v))
            return put(h, k, v)

        def traced_to_host(rows):
            torch.cuda.synchronize()
            t = time.perf_counter()
            host = to_host(rows)
            self.drains.append({"blocks": len(rows) // 2, "bytes": host.numel() * host.element_size(),
                                "seconds": time.perf_counter() - t})
            return host

        def traced_upload(entries, block_ids):
            torch.cuda.synchronize()
            t = time.perf_counter()
            upload(entries, block_ids)
            torch.cuda.synchronize()
            self._up = (time.perf_counter() - t, sum(k.numel() * k.element_size() * 2 for k, _ in entries))

        def traced_onboard(match, hashes):
            n_g1, tiers = len(match.g1_blocks), [t.name for _, t in match.onboardable]
            self._up = (0.0, 0)
            t = time.perf_counter()
            blocks = onboard(match, hashes)
            seconds = time.perf_counter() - t
            new = blocks[n_g1:]
            if new:
                self.onboards.append({"pairs": list(zip(hashes[n_g1:n_g1 + len(new)], new)),
                                      "tiers": {n: tiers[:len(new)].count(n) for n in set(tiers[:len(new)])},
                                      "seconds": seconds, "upload_s": self._up[0], "bytes": self._up[1]})
            return blocks

        kvbm._cascade_put, kvbm._to_host, kvbm.onboard, kvbm._upload = (traced_put, traced_to_host, traced_onboard,
                                                                         traced_upload)

    def check_onboarded(self, cache, since: int) -> tuple:
        """(blocks read back, the ones whose bytes differ from the bytes
        gathered when their hash was evicted) of the onboards from
        ``since`` on."""
        from dynamo_tpu_torch.llm.block_manager.transfer import gather_blocks

        n, bad = 0, []
        for ob in self.onboards[since:]:
            for h, bid in ob["pairs"]:
                n += 1
                if block_digest(*gather_blocks(cache, bid)) != self.evicted.get(h):
                    bad.append(f"{h & 0xFFFFFFFFFFFFFFFF:016x}")
        return n, bad


def phase_kvbm(card: str, dev) -> dict:
    """KVBM on the card, in process. One ``TorchEngine`` of the preset
    (seeded bf16 weights, ``--warmup-ctx 1280``) with a G1 of
    ``KVBM_G1_BLOCKS`` blocks, ``KVBM_HOST_BLOCKS`` host blocks (G2) and a
    G3 directory under ``build/chip_smoke``, sent ``kvbm_traffic`` one
    request at a time (greedy, 64 tokens): the six prompts evict each
    other's blocks, which offload to G2 and spill to G3; the repeats
    onboard them, and the last is a G1 hit. Gates: blocks onboarded from
    G2 and from G3 and
    ``prefix_onboard_total > 0``; every onboarded block's bytes, read back
    from G1, those gathered when it was evicted; the repeats' ids those of
    the same traffic on an engine whose G1 (2048 blocks) keeps every
    block; ragged launches = 16 × forward steps (+ non-fused window
    steps), each fused window launched once, no plain call; no graph
    capture after the warmup. Reports the drains' device → host GB/s, the
    onboards' ms a block and upload GB/s, and the TTFT of each repeat (with
    the tiers it onboarded from) beside the cold prefills'."""
    import os

    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.engine.weights import init_params

    root = os.path.dirname(os.path.abspath(__file__))
    g3 = os.path.join(root, "build", "chip_smoke", "kvbm_g3")
    shutil.rmtree(g3, ignore_errors=True)
    cfg = get_config(PRESET)
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
    traffic = kvbm_traffic(cfg.vocab_size)

    async def serve(num_blocks: int, tiers: bool):
        args = EngineArgs(model=PRESET, device=str(dev), scheduler=SchedulerConfig(num_blocks=num_blocks),
                          warmup_ctx=KVBM_WARMUP_CTX if tiers else 0,
                          kvbm_host_blocks=KVBM_HOST_BLOCKS if tiers else 0, kvbm_disk_dir=g3 if tiers else None,
                          kvbm_disk_blocks=KVBM_DISK_BLOCKS if tiers else 0)
        t0 = time.perf_counter()
        engine = TorchEngine.build(args, params=params)
        build_s = time.perf_counter() - t0
        sched = engine.scheduler
        probe = KvbmProbe(engine.kvbm) if tiers else None
        answers, checks = [], []
        try:
            steps0 = sched_steps(sched)
            reset_counts()  # counts from zero, just before the main path runs
            for i, tokens in enumerate(traffic):
                m0 = dict(vars(engine.kvbm.metrics)) if tiers else None
                n0 = len(probe.onboards) if tiers else 0
                ans = await engine_answer(engine, tokens)
                if tiers:
                    ans["kvbm"] = {k: v - m0[k] for k, v in vars(engine.kvbm.metrics).items() if v != m0[k]}
                    ans["onboarded_blocks"], bad = probe.check_onboarded(sched.cache, n0)
                    if bad:
                        checks.append(f"request {i}: onboarded blocks {bad[:4]} differ from their evicted bytes")
                answers.append(ans)
            counts = read_counts()
            steps = {k: v - steps0[k] for k, v in sched_steps(sched).items()}
            out = {"build_s": build_s, "answers": answers, "counts": counts, "steps": steps, "checks": checks,
                   "warmup": sched.warmup_stats, "captures_after_warmup": sched.graph_captures_after_warmup,
                   "stats": engine.stats_handler()}
            if tiers:
                out["metrics"] = dict(vars(engine.kvbm.metrics))
                out["probe"] = probe
                out["g3_files"] = len(os.listdir(g3))
        finally:
            await engine.stop()
        return out

    t0 = time.perf_counter()
    run = asyncio.run(serve(KVBM_G1_BLOCKS, True))
    ref = asyncio.run(serve(2048, False))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    L = cfg.num_layers
    probe, m = run.pop("probe"), run["metrics"]
    launches, expected, plain = serve_launches(run["counts"], run["steps"], L)
    checks = list(run["checks"])
    if not (m["onboards_g2"] > 0 and m["onboards_g3"] > 0 and run["stats"]["prefix_onboard_total"] > 0):
        checks.append(f"onboards by tier {m}, prefix_onboard_total {run['stats']['prefix_onboard_total']}")
    repeats = range(6, len(traffic))
    differ = [i for i in repeats if run["answers"][i]["ids"] != ref["answers"][i]["ids"]]
    if differ:
        checks.append(f"repeats {differ} gave other ids than on the G1 that kept the blocks")
    if launches != expected or plain or not run["steps"]["fused_windows_total"]:
        checks.append(f"launches {launches} != {expected}, {plain} plain calls, or no fused window")
    if run["captures_after_warmup"]:
        checks.append(f"{run['captures_after_warmup']} graph captures after the warmup")
    drained = sum(d["bytes"] for d in probe.drains)
    drain_s = sum(d["seconds"] for d in probe.drains)
    up_bytes = sum(o["bytes"] for o in probe.onboards)
    up_s = sum(o["upload_s"] for o in probe.onboards)
    n_onboarded = sum(len(o["pairs"]) for o in probe.onboards)
    pick = lambda a: {k: a[k] for k in ("ttft_s", "latency_s", "cached_tokens")}  # noqa: E731
    res = {
        "card": card, "preset": PRESET, "g1_blocks": KVBM_G1_BLOCKS, "host_blocks": KVBM_HOST_BLOCKS,
        "disk_blocks": KVBM_DISK_BLOCKS, "prompt_tokens": KVBM_PROMPT, "phase_s": time.perf_counter() - t0,
        "metrics": m, "prefix_onboard_total": run["stats"]["prefix_onboard_total"], "g3_files": run["g3_files"],
        "offload": {"drains": len(probe.drains), "blocks": sum(d["blocks"] for d in probe.drains),
                    "bytes": drained, "seconds": drain_s, "gb_per_s": drained / drain_s / 1e9 if drain_s else None},
        "onboard": {"onboards": [{k: o[k] for k in ("tiers", "seconds", "upload_s", "bytes")} | {
                        "blocks": len(o["pairs"]), "ms_per_block": o["seconds"] * 1e3 / len(o["pairs"])}
                    for o in probe.onboards],
                    "blocks": n_onboarded, "upload_gb_per_s": up_bytes / up_s / 1e9 if up_s else None,
                    "ms_per_block": sum(o["seconds"] for o in probe.onboards) * 1e3 / n_onboarded
                    if n_onboarded else None},
        "cold": [pick(a) for a in run["answers"][:6]], "cold_ttft_p50_s": statistics.median(
            a["ttft_s"] for a in run["answers"][:6]),
        "repeats": [{**pick(run["answers"][i]), "kvbm": run["answers"][i]["kvbm"],
                     "onboarded_blocks": run["answers"][i]["onboarded_blocks"]} for i in repeats],
        "reference_repeats": [pick(ref["answers"][i]) for i in repeats],
        "ref_cold_ttft_p50_s": statistics.median(a["ttft_s"] for a in ref["answers"][:6]),
        "repeat_ids_equal_g1": [run["answers"][i]["ids"] == ref["answers"][i]["ids"] for i in repeats],
        "steps": run["steps"], "launches": launches, "expected_launches": expected, "plain_calls": plain,
        "warmup": run["warmup"], "captures_after_warmup": run["captures_after_warmup"],
        "build_s": {"kvbm": run["build_s"], "reference": ref["build_s"]},
    }
    emit("kvbm", **res)
    if checks:
        raise AssertionError("; ".join(checks))
    return res


# ---------------------------------------------------------------------------
# disagg: a prefill worker and a decode worker on one card
# ---------------------------------------------------------------------------

DISAGG_LOCAL_MAX = 512  # the decode worker's --max-local-prefill-length
DISAGG_WARMUP_CTX = 2048  # both workers: no capture (and no capture's eager launches) on the traffic
DISAGG_OWN_PULL_TOKENS = 1500


def disagg_traffic() -> list:
    """Four chat requests of about 1500 tokens (prefilled remotely) and four
    of 32–200 (prefilled locally), interleaved; greedy, 64 tokens,
    streamed."""
    rng = np.random.default_rng(29)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    text = lambda n: "".join(rng.choice(letters, size=n))  # noqa: E731
    out = []
    for i, n in enumerate((1450, 32, 1480, 90, 1500, 150, 1470, 200)):
        out.append({"model": PRESET, "max_tokens": 64, "temperature": 0.0, "stream": True,
                    "messages": [{"role": "user", "content": f"{i}. " + text(n)}]})
    return out


async def _disagg_sequential(port: int, bodies: list) -> list:
    return [_answer_of(r) for b in bodies for r in await _send(port, [b])]


async def _disagg_burst(port: int, bodies: list) -> tuple:
    t0 = time.perf_counter()
    answers = [_answer_of(r) for r in await _send(port, bodies)]
    return answers, time.perf_counter() - t0


async def own_pulls(drt, dev, vocab_size: int) -> dict:
    """From this process, over the port's runtime: a seeded prompt of
    ``DISAGG_OWN_PULL_TOKENS`` ids prefilled on the prefill worker three
    times (``do_remote_decode``); the first export pulled in device mode
    (cold), the second in host mode (``pull_kv_blocks``, the JAX wire) and
    the third in device mode again. The second and third ran the same
    steps (both prefix-cache hits of the first), so their KV must be
    bit-equal across the two modes. → the pulls' seconds and bytes and
    the check."""
    from dynamo_tpu_torch.llm.disagg import pull_kv_blocks, pull_kv_blocks_device
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.push_router import PushRouter

    client = await drt.namespace("dynamo").component("prefill").endpoint("generate").client()
    await client.wait_for_instances(1, timeout=60)
    router = PushRouter(client)
    tokens = np.random.default_rng(37).integers(1, min(vocab_size, 100000), size=DISAGG_OWN_PULL_TOKENS).tolist()
    pulls = []
    for i, mode in enumerate(("device", "host", "device")):
        rid = f"chip-smoke-pull-{i}"
        req = {"token_ids": tokens, "sampling_options": {"temperature": 0.0},
               "stop_conditions": {"max_tokens": 1, "ignore_eos": True},
               "disagg_params": {"do_remote_decode": True}}
        iid = router.select()
        async for _ in router.generate(req, Context(id=rid), instance_id=iid):
            pass
        inst = client.instances[iid]
        torch.cuda.synchronize()
        t = time.perf_counter()
        if mode == "device":
            k, v = await pull_kv_blocks_device(drt, inst, rid, dev)
        else:
            blocks = await pull_kv_blocks(drt, inst, rid)
            k, v = (torch.stack([b[j] for b in blocks], dim=1) for j in (0, 1))
        torch.cuda.synchronize()
        s = time.perf_counter() - t
        nbytes = (k.numel() + v.numel()) * k.element_size()
        pulls.append({"mode": mode, "seconds": s, "bytes": nbytes, "gb_per_s": nbytes / s / 1e9, "blocks": k.shape[1],
                      "k": k.cpu(), "v": v.cpu()})
    await router.close()
    await client.close()
    a, b = pulls[1], pulls[2]
    equal = (a["k"].view(torch.uint8).numpy().tobytes() == b["k"].view(torch.uint8).numpy().tobytes()
             and a["v"].view(torch.uint8).numpy().tobytes() == b["v"].view(torch.uint8).numpy().tobytes())
    return {"pulls": [{k: p[k] for k in ("mode", "seconds", "bytes", "gb_per_s", "blocks")} for p in pulls],
            "host_bytes_equal_device": equal}


def phase_disagg(card: str, dev) -> dict:
    """Disaggregated serving as an operator runs it, on one card: ``python
    -m dynamo_tpu_torch.control_plane``, one ``worker --role prefill``, one
    ``worker --role decode --kv-transfer device --max-local-prefill-length
    512`` (both ``--warmup-ctx 2048``) and the KV-routing ``frontend``. ``disagg_traffic``
    goes through the frontend one request at a time, then as one burst of
    8: each time the four long prompts are prefilled on the prefill worker
    and their KV pulled through CUDA IPC, the four short ones prefilled on
    the decode worker. Gates: each pass moves the decode worker's
    ``remote_prefills`` and ``local_prefills`` by 4 (stats scrapes) and
    ``degrade_disagg_to_colocated_total`` never; every answer a 200 with
    64 tokens or ``stop``; the one-at-a-time answers' text equal to an
    in-process aggregated engine's (``run.build_service``, the same seed)
    sent the same one at a time; the host wire once (``own_pulls``: the
    bytes of a host pull equal a device pull's of the same prompt); at
    SIGTERM the prefill worker's exports all taken, none expired, its
    ragged launches 16 × its forward steps; the decode worker's ragged
    launches 16 × (forward + non-fused window steps), each fused window
    launched once; no plain call on either. Reports the burst's tok/s and
    TTFT p50 beside the in-process engine's burst of the same requests,
    and the pulls' ms and GB/s."""
    import os
    import socket
    from pathlib import Path

    from dynamo_tpu_torch import run
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.runtime.config import Config, ControlPlaneConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.runtime import Runtime

    root = Path(__file__).resolve().parent
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        cp_port = s.getsockname()[1]
    env = dict(os.environ, DYN_CONTROL_PLANE="tcp", DYN_CONTROL_PLANE_ADDRESS=f"127.0.0.1:{cp_port}", DYN_LOG="INFO",
               PYTHONPATH=str(root))
    bodies = disagg_traffic()
    long_ = [i for i in range(len(bodies)) if i % 2 == 0]
    gc.collect()
    torch.cuda.empty_cache()
    kids = _Children(root, env, "disagg")
    t0 = time.perf_counter()
    try:
        kids.start("control_plane", "dynamo_tpu_torch.control_plane", "--host", "127.0.0.1", "--port", str(cp_port))
        kids.wait_for("control_plane", "control plane ready", 60)
        kids.start("prefill", "dynamo_tpu_torch.worker", "--model", PRESET, "--role", "prefill", "--warmup-ctx",
                   str(DISAGG_WARMUP_CTX))
        kids.start("decode", "dynamo_tpu_torch.worker", "--model", PRESET, "--role", "decode", "--kv-transfer",
                   "device", "--max-local-prefill-length", str(DISAGG_LOCAL_MAX), "--warmup-ctx",
                   str(DISAGG_WARMUP_CTX))
        kids.start("frontend", "dynamo_tpu_torch.frontend", "--http-host", "127.0.0.1", "--http-port", "0",
                   "--router-mode", "kv")
        port = int(kids.wait_for("frontend", "frontend ready on", 120).split(" (")[0].rsplit(":", 1)[1])
        for name in ("prefill", "decode"):
            kids.wait_for(name, "worker ready", 300)
        up_s = time.perf_counter() - t0

        async def drive():
            deadline = time.monotonic() + 60
            while True:
                kids.alive()
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
                conn.request("GET", "/v1/models")
                models = [m["id"] for m in json.loads(conn.getresponse().read())["data"]]
                conn.close()
                if PRESET in models:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"{PRESET} never appeared in /v1/models: {models}")
                await asyncio.sleep(0.2)
            plane = ControlPlaneConfig(backend="tcp", address=f"127.0.0.1:{cp_port}")
            drt = await DistributedRuntime.from_settings(Runtime(Config(control_plane=plane)))
            try:
                client = await drt.namespace("dynamo").component("decode").endpoint("generate").client()
                await client.wait_for_instances(1, timeout=60)

                async def disagg_stats():
                    (st,) = (await client.scrape_stats()).values()
                    return st

                passes = {}
                for name in ("sequential", "burst"):
                    before = await disagg_stats()
                    t = time.perf_counter()
                    if name == "sequential":
                        answers = await _disagg_sequential(port, bodies)
                        wall = time.perf_counter() - t
                    else:
                        answers, wall = await _disagg_burst(port, bodies)
                    after = await disagg_stats()
                    passes[name] = {"answers": answers, "wall": wall,
                                    "moved": {k: after[k] - before[k] for k in (
                                        "remote_prefills", "local_prefills", "degrade_disagg_to_colocated_total",
                                        "degrade_colocated_to_disagg_total", "split_prefills_total")}}
                pulls = await own_pulls(drt, dev, get_config(PRESET).vocab_size)
                await client.close()
            finally:
                await drt.shutdown()
            return passes, pulls

        passes, pulls = asyncio.run(drive())
        kids.alive()
        codes = {name: kids.stop(name) for name in ("frontend", "decode", "prefill", "control_plane")}
    finally:
        kids.kill()
    if any(codes.values()):
        raise AssertionError(f"a process exited with an error: {codes}")
    runs = {}
    for name in ("prefill", "decode"):
        (line,) = [ln for ln in kids.text(name).splitlines() if DIST_COUNTERS_MARK in ln]
        runs[name] = json.loads(line.split(DIST_COUNTERS_MARK, 1)[1])
    phase_workers_s = time.perf_counter() - t0

    # In process: one aggregated engine, the same seed, sent the same
    # requests one at a time (the reference) and as one burst (the timing).
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        args = run.parse_args(["in=http", f"out={PRESET}", "--http-host", "127.0.0.1", "--http-port", "0",
                               "--warmup-ctx", str(DISAGG_WARMUP_CTX)])

        async def in_process():
            service, engine = run.build_service(args)
            await service.start()
            try:
                seq = await _disagg_sequential(service.port, bodies)
                engine.scheduler.allocator.clear_cached()
                burst, wall = await _disagg_burst(service.port, bodies)
            finally:
                await service.stop()
                await engine.stop()
            return seq, burst, wall

        ref_seq, ref_burst, ref_wall = asyncio.run(in_process())
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced

    L = get_config(PRESET).num_layers
    checks, workers = [], {}
    for name, r in runs.items():
        steps, k = r["steps"], r["kernels"]
        launches = {n: c["launches"] for n, c in k.items()}
        want = {n: 0 for n in launches}
        want["ragged_paged_attention"] = L * (steps["forward_steps_total"] + steps["window_steps_total"]
                                              + steps["draft_prefill_steps_total"])
        want["fused_decode_window"] = steps["fused_windows_total"]
        want["fused_decode_window_sampled"] = steps["fused_sampled_windows_total"]
        want["fused_decode_window_guided"] = steps["fused_guided_windows_total"]
        plain = sum(c["plain_calls"] for c in k.values())
        workers[name] = {"steps": steps, "launches": launches, "expected_launches": want, "plain_calls": plain,
                         "disagg": r.get("disagg")}
        if launches != want or plain:
            checks.append(f"{name}: launches {launches} != {want}, or {plain} plain calls")
    pre, dec = runs["prefill"]["steps"], runs["decode"]["steps"]
    if not dec["fused_windows_total"]:
        checks.append("the decode worker ran no fused window")
    if pre["fused_windows_total"] or pre["window_steps_total"]:
        checks.append(f"the prefill worker decoded: {pre}")
    if not (pre["exports_total"] == pre["exports_taken_total"] == 2 * len(long_) + 3) or pre["exports_expired_total"]:
        checks.append(f"exports {pre['exports_total']} parked, {pre['exports_taken_total']} taken, "
                      f"{pre['exports_expired_total']} expired")
    for name, p in passes.items():
        mv = p["moved"]
        if (mv["remote_prefills"], mv["local_prefills"], mv["degrade_disagg_to_colocated_total"]) != (4, 4, 0):
            checks.append(f"{name}: the decode worker's counters moved {mv}")
    texts_equal = [a["text"] == b["text"] for a, b in zip(passes["sequential"]["answers"], ref_seq)]
    if not all(texts_equal):
        differ = [{"request": i, "disagg": passes["sequential"]["answers"][i]["text"][:80],
                   "in_process": ref_seq[i]["text"][:80]} for i, ok in enumerate(texts_equal) if not ok]
        checks.append(f"one-at-a-time answers differ from the in-process engine's: {differ}")
    if not pulls["host_bytes_equal_device"]:
        checks.append("a host pull's bytes differ from a device pull's of the same prompt")
    burst_texts_equal = sum(a["text"] == b["text"] for a, b in zip(passes["burst"]["answers"], ref_burst))
    seq_ttft = lambda ans, idx: [ans[i]["ttft_s"] for i in idx]  # noqa: E731
    short = [i for i in range(len(bodies)) if i % 2]
    res = {
        "card": card, "preset": PRESET, "max_local_prefill_length": DISAGG_LOCAL_MAX,
        "warmup_ctx": DISAGG_WARMUP_CTX, "processes_up_s": up_s, "workers_s": phase_workers_s,
        "phase_s": time.perf_counter() - t0,
        "burst": _burst_summary(passes["burst"]["answers"], passes["burst"]["wall"]),
        "in_process_burst": _burst_summary(ref_burst, ref_wall),
        "sequential": {"wall_s": passes["sequential"]["wall"],
                       "ttft_long_s": seq_ttft(passes["sequential"]["answers"], long_),
                       "ttft_short_s": seq_ttft(passes["sequential"]["answers"], short),
                       "in_process_ttft_long_s": seq_ttft(ref_seq, long_),
                       "in_process_ttft_short_s": seq_ttft(ref_seq, short)},
        "moved": {name: p["moved"] for name, p in passes.items()},
        "texts_equal_in_process": texts_equal, "burst_texts_equal_in_process": burst_texts_equal,
        "own_pulls": pulls, "workers": workers,
    }
    emit("disagg", **res)
    if checks:
        raise AssertionError("; ".join(checks))
    return res


# ---------------------------------------------------------------------------
# families: the MoE and MLA model families served through run
# ---------------------------------------------------------------------------

FAMILY_MOE = "mixtral-8x7b"
FAMILY_MOE_LAYERS = 8  # of 32: the 8 layers' ~11.9 B parameters are ~24 GB in bf16
FAMILY_MLA = "deepseek-v2-lite"  # whole: 27 layers, ~15.7 B parameters, ~31.4 GB in bf16
FAMILY_CHECK_LAYERS = 2  # the float32 checks' depth
FAMILY_PROMPT_CHARS = (120, 400, 60, 900, 200, 30, 600, 300)  # the burst's 8 prompts
MOE_BF16_TOL = dict(rtol=0.1, atol=0.05)  # ragged vs dense in bf16: JAX tests/test_moe.py:113-119
MLA_DECODE_TOL = 2e-4  # decode vs prefill logits in f32: JAX tests/test_mla.py:32-66


def family_bodies(model: str, seed: int) -> list:
    """The families' burst: 8 streamed greedy chat requests of 64 tokens."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    return [{"model": model, "messages": [{"role": "user", "content": "".join(rng.choice(letters, size=n))}],
             "stream": True, "temperature": 0.0, "max_tokens": 64} for n in FAMILY_PROMPT_CHARS]


def family_serve(card: str, preset: str, cfg, params, dev) -> dict:
    """``cfg`` (of ``preset``) on ``params`` through ``run.build_service``
    (bf16, the scheduler's defaults: 32-step windows): one short request to
    warm the process (this phase runs first: cuBLAS, the kernels' first
    loads), then the 8-request burst and its first prompt again (a
    prefix-cache hit), every kernel's counts zeroed just before the burst
    and read just after, with the MLA attention calls and the scheduler's
    steps."""
    from dynamo_tpu_torch import run
    from dynamo_tpu_torch.engine.models import mla

    args = run.parse_args(["in=http", f"out={preset}", "--http-host", "127.0.0.1", "--http-port", "0",
                           "--device", str(dev)])
    bodies = family_bodies(preset, 21)

    async def serve():
        t0 = time.perf_counter()
        service, engine = run.build_service(args, model_config=cfg, params=params)
        build_s = time.perf_counter() - t0
        sched = engine.scheduler
        await service.start()
        try:
            warm = {**bodies[0], "messages": [{"role": "user", "content": "warm up"}], "max_tokens": 4}
            warm_s = (await asyncio.to_thread(_request, service.port, "/v1/chat/completions", warm))[3]
            steps0 = sched_steps(sched)
            reset_counts()  # counts from zero, just before the main path runs
            attends0 = mla.ATTEND_CALLS
            t1 = time.perf_counter()
            results = await _send(service.port, bodies)
            wall = time.perf_counter() - t1
            repeat = await asyncio.to_thread(_request, service.port, "/v1/chat/completions", bodies[0])
            counts = read_counts()
            attends = mla.ATTEND_CALLS - attends0
            steps = {k: v - steps0[k] for k, v in sched_steps(sched).items()}
            stats = engine.stats()
        finally:
            await service.stop()
            await engine.stop()
        return (results, wall, repeat, counts, attends, steps, stats, build_s, sched.config_snapshot()["model"],
                warm_s)

    results, wall, repeat, counts, attends, steps, stats, build_s, model, warm_s = asyncio.run(serve())
    answers = [_answer_of(r) for r in results]
    again = _answer_of(repeat)
    launches, expected, plain = serve_launches(counts, steps, cfg.num_layers)
    if cfg.architecture == "mla":
        expected = dict.fromkeys(expected, 0)  # MLA attends in PyTorch ops: no kernel on its path
    return {"preset": preset, "layers": cfg.num_layers, "model": model, "build_s": build_s, "warmup_request_s": warm_s,
            **_burst_summary(answers, wall), "ttfts_s": [a["ttft_s"] for a in answers],
            "repeat": {k: again[k] for k in ("cached_tokens", "ttft_s", "latency_s")},
            "repeat_text_equal": again["text"] == answers[0]["text"],
            "steps": steps, "launches": launches, "expected_launches": expected, "plain_calls": plain,
            "mla_attend_calls": attends, "stats": {k: stats[k] for k in (
                "architecture", "num_experts", "moe_dispatch", "moe_dropped_total", "moe_assignments_total",
                "cached_tokens_total", "graph_captures_total")}}


def moe_layer_case(cfg, params, T: int, dev, seed: int) -> dict:
    """One MoE layer (layer 0's router and experts) on T bf16 rows: the
    ragged dispatch timed, held against the dense dispatch of the same
    weights (JAX's bf16 bound), and its bound: the experts the rows chose
    read once, the rows in and out, over the memory rate; the routed
    products over the bf16 peak."""
    from dynamo_tpu_torch.engine.models import llama

    lp = {k: params["layers"][k][0] for k in ("router", "w_gate", "w_up", "w_down")}
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((T, cfg.hidden_size), generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)
    ragged = cfg.replace(moe_dispatch="ragged")
    out = llama._moe_ragged(x, lp, ragged)
    ref = llama._moe_dense(x, lp, ragged)
    err = (out.float() - ref.float()).abs()
    within = bool((err <= MOE_BF16_TOL["atol"] + MOE_BF16_TOL["rtol"] * ref.float().abs()).all())
    _, ids = llama._route(x, lp, cfg.num_experts_per_tok)
    chosen = int(torch.unique(ids).numel())
    D, F_, E, K = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts, cfg.num_experts_per_tok
    nbytes = 2 * (chosen * 3 * D * F_ + D * E + 2 * T * D)
    flops = 2 * T * K * 3 * D * F_ + 2 * T * D * E
    ms = cuda_ms(lambda: llama._mlp(x, lp, ragged), iters=10, warmup=2)
    dense_ms = cuda_ms(lambda: llama._moe_dense(x, lp, ragged), iters=5, warmup=1)
    return {"rows": T, "experts_chosen": chosen, "max_abs_err_vs_dense": err.max().item(), "within_bf16_bound": within,
            "finite": bool(torch.isfinite(out).all()), "ms": ms, "dense_ms": dense_ms,
            **bound(nbytes, flops, torch.bfloat16)}


def mla_attend_case(cfg, params, *, rows: int, ctx: int, chunk: int, dev, seed: int) -> dict:
    """One MLA attention call at DeepSeek-V2-Lite's widths, bf16: the
    latent gather through the block tables and ``_attend_latent`` (scores
    against the latent, softmax, weighted latent sum, ``w_uv``), ``rows``
    queries of ``chunk`` positions each over ``ctx`` cached tokens. Bound:
    the latent pages, queries, ``w_uv`` and the output moved once over the
    memory rate; the scores', sum's and decompression's products over the
    bf16 peak."""
    from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays
    from dynamo_tpu_torch.engine.models import llama, mla

    R, H, r, V = mla.latent_width(cfg), cfg.num_heads, cfg.kv_lora_rank, cfg.v_head_dim
    bs = cfg.block_size
    W = -(-ctx // bs)
    one = cfg.replace(num_layers=1)
    cache = KvCacheArrays.create(one, rows * W + 1, dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    cache.k.copy_(torch.randn(cache.k.shape, generator=g, device=dev).to(torch.bfloat16))
    tables = torch.arange(1, rows * W + 1, device=dev).view(rows, W)
    lp = {k: params["layers"][k][0] for k in ("w_uv",)}
    q_eff = torch.randn((rows, chunk, H, r), generator=g, device=dev).to(torch.bfloat16)
    q_rope = torch.randn((rows, chunk, H, cfg.qk_rope_head_dim), generator=g, device=dev).to(torch.bfloat16)
    fresh = torch.randn((rows, chunk, R), generator=g, device=dev).to(torch.bfloat16)
    iq = torch.arange(chunk, device=dev)
    mask = torch.cat([torch.ones((chunk, ctx), dtype=torch.bool, device=dev), iq[None, :] <= iq[:, None]], 1)
    flat = cache.k.reshape(W * rows + 1, bs, 1, R)

    def call():
        lat = llama._gather_kv(flat, tables, torch.bfloat16).reshape(rows, W * bs, R)[:, :ctx]
        return mla._attend_latent(q_eff, q_rope, torch.cat([lat, fresh], 1), mask.expand(rows, -1, -1), lp, cfg)

    out = call()
    S = ctx + chunk
    nbytes = 2 * (rows * ctx * R + q_eff.numel() + q_rope.numel() + fresh.numel() + lp["w_uv"].numel()
                  + out.numel())
    flops = 2 * rows * chunk * H * S * (R + r) + 2 * rows * chunk * H * r * V
    return {"rows": rows, "chunk": chunk, "ctx": ctx, "finite": bool(torch.isfinite(out).all()),
            "ms": cuda_ms(call, iters=10, warmup=2), **bound(nbytes, flops, torch.bfloat16)}


def moe_dispatch_checks(card: str, dev) -> dict:
    """mixtral-8x7b at 2 layers in float32: a held burst's greedy ids under
    ``moe_dispatch="ragged"`` equal those under ``"dense"``; under
    ``"capacity"`` the engine counts its routed assignments (> 0) and
    reports the drops."""
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
    from dynamo_tpu_torch.engine.weights import init_params

    cfg = get_config(FAMILY_MOE).replace(num_layers=FAMILY_CHECK_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(3), device=dev, dtype=torch.float32)
    rng = np.random.default_rng(22)
    prompts = [[int(x) for x in rng.integers(0, cfg.vocab_size, n)] for n in (40, 17, 90, 33, 64, 8, 120, 25)]

    async def burst(dispatch: str):
        engine = TorchEngine.build(EngineArgs(model=FAMILY_MOE, model_config=cfg, dtype="float32", device=str(dev),
                                              moe_dispatch=dispatch), params=params)
        try:
            answers = await asyncio.gather(*[engine_answer(engine, p, max_tokens=24) for p in prompts])
            return [a["ids"] for a in answers], engine.stats()
        finally:
            await engine.stop()

    out = {}
    for dispatch in ("ragged", "dense", "capacity"):
        ids, stats = asyncio.run(burst(dispatch))
        out[dispatch] = {"ids": ids, "moe_dispatch": stats["moe_dispatch"],
                         "moe_dropped_total": stats["moe_dropped_total"],
                         "moe_assignments_total": stats["moe_assignments_total"]}
    del params
    return {"preset": FAMILY_MOE, "layers": cfg.num_layers, "dtype": "float32",
            "ragged_ids_equal_dense": out["ragged"]["ids"] == out["dense"]["ids"],
            "capacity_ids_equal_ragged": out["capacity"]["ids"] == out["ragged"]["ids"],
            **{d: {k: v for k, v in o.items() if k != "ids"} for d, o in out.items()}}


def mla_checks(dev) -> dict:
    """deepseek-v2-lite at 2 layers in float32, on the card: decode's logits
    equal a prefill's of the same positions (JAX ``tests/test_mla.py:32``);
    then 8 rows prefilled into an f32 latent cache and an int8 one and 16
    teacher-forced decode steps on each: the int8 cache's greedy ids equal
    the f32 ones wherever the f32 top-2 gap exceeds ``STEP0_GAP_NOISES``
    times the row's int8 noise (its logits' largest distance from f32)."""
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays
    from dynamo_tpu_torch.engine.models import mla
    from dynamo_tpu_torch.engine.weights import init_params

    cfg = get_config(FAMILY_MLA).replace(num_layers=FAMILY_CHECK_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(4), device=dev, dtype=torch.float32)
    rng = np.random.default_rng(23)
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    # 1. decode vs prefill.
    prompt = rng.integers(0, cfg.vocab_size, 41).astype(np.int32)
    table = t(np.arange(1, 5, dtype=np.int32))
    c1 = KvCacheArrays.create(cfg, 8, dtype=torch.float32, device=dev)
    padded = np.zeros(64, np.int32)
    padded[:40] = prompt[:40]
    mla.prefill(params, cfg, c1.k, c1.v, t(padded), 40, 0, table)
    ld = mla.decode(params, cfg, c1.k, c1.v, t(prompt[40:41]), t(np.array([40], np.int32)), table[None],
                    t(np.array([True])))[0][0]
    c2 = KvCacheArrays.create(cfg, 8, dtype=torch.float32, device=dev)
    padded[:41] = prompt
    lf = mla.prefill(params, cfg, c2.k, c2.v, t(padded), 41, 0, table)[0]
    decode_err = (ld - lf).abs().max().item()
    decode_ok = bool(torch.allclose(ld, lf, rtol=MLA_DECODE_TOL, atol=MLA_DECODE_TOL))
    # 2. int8 latent cache vs f32.
    B, P, steps = 8, 100, 16
    W = -(-(P + steps) // cfg.block_size)
    tables = t(np.arange(1, 1 + B * W, dtype=np.int32).reshape(B, W))
    seqs = rng.integers(0, cfg.vocab_size, (B, P + steps)).astype(np.int32)
    logits = {}
    for kv in ("auto", "int8"):
        c = cfg.replace(kv_cache_dtype=kv)
        cache = KvCacheArrays.create(c, 1 + B * W, dtype=torch.float32, device=dev)
        for b in range(B):
            pad = np.zeros(128, np.int32)
            pad[:P] = seqs[b, :P]
            mla.prefill(params, c, cache.k, cache.v, t(pad), P, 0, tables[b])
        rows = []
        for s in range(steps):
            rows.append(mla.decode(params, c, cache.k, cache.v, t(seqs[:, P + s]),
                                   t(np.full(B, P + s, np.int32)), tables, t(np.ones(B, bool)))[0])
        logits[kv] = torch.stack(rows)  # [steps, B, V]
    ref, q = logits["auto"], logits["int8"]
    noise = (q - ref).abs().amax(dim=-1)
    top = ref.topk(2, dim=-1)
    held = (top.values[..., 0] - top.values[..., 1]) > STEP0_GAP_NOISES * noise
    same = bool(torch.equal(q.argmax(-1)[held], top.indices[..., 0][held]))
    del params
    return {"preset": FAMILY_MLA, "layers": cfg.num_layers, "dtype": "float32",
            "decode_vs_prefill_max_abs_err": decode_err, "decode_vs_prefill_tol": MLA_DECODE_TOL,
            "decode_matches_prefill": decode_ok,
            "int8": {"rows": held.numel(), "rows_held": int(held.sum()), "ids_equal_where_held": same,
                     "max_noise": noise.max().item(), "gap_noises": STEP0_GAP_NOISES,
                     "finite": bool(torch.isfinite(q).all())}}


def phase_families(card: str, dev) -> dict:
    """The MoE and MLA families on the card.

    1. ``mixtral-8x7b`` at full width (hidden 4096, 8 experts of FFN 14336,
       32 query and 8 KV heads), cut to ``FAMILY_MOE_LAYERS`` of its 32
       layers, bf16 through ``run``: a burst of 8 streamed requests of 64
       tokens and a repeat of the first. Ragged kernel launches must equal
       layers × (forward steps + window steps) exactly, with no other
       kernel (no fused window: its kernel is dense) and no plain call.
       One layer's ragged MoE output is held against the dense dispatch of
       the same weights at a decode batch and a prefill chunk (JAX's bf16
       bound) and timed beside its bound. At 2 layers in float32 the same
       held burst's greedy ids under ragged and dense dispatch are equal,
       and capacity dispatch counts its assignments.
    2. ``deepseek-v2-lite`` whole (27 layers, MLA with a 512 + 64 latent,
       64 experts, top 6), bf16 through ``run``: the burst and the repeat,
       which must hit the prefix cache (``cached_tokens > 0``); no kernel
       launches (MLA attends in PyTorch ops) and the MLA attention is
       called once a layer for every forward and window step. At 2 layers
       in float32: decode's logits equal a prefill's, and the int8 latent
       cache's greedy ids equal the f32 cache's where the gap holds. One
       MLA attention call is timed at a decode batch and a prefill chunk
       beside its bound.
    Prints each model's TTFT p50, decode tokens/s, the timed MoE layers and
    MLA calls, the cache's bytes a token, and the card's name and power
    limit. Any failed check raises."""
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.models import mla
    from dynamo_tpu_torch.engine.weights import init_params

    t0 = time.perf_counter()
    checks = []
    # 1. MoE.
    moe_cfg = get_config(FAMILY_MOE).replace(num_layers=FAMILY_MOE_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(moe_cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
    moe = family_serve(card, FAMILY_MOE, moe_cfg, params, dev)
    moe["weights_gb"] = tree_bytes(params) / 1e9
    moe["kv_bytes_per_token"] = moe_cfg.num_layers * 2 * moe_cfg.kv_size * 2
    moe["moe_layer"] = {"decode": moe_layer_case(moe_cfg, params, 8, dev, 31),
                        "prefill_chunk": moe_layer_case(moe_cfg, params, 512, dev, 32)}
    moe["moe_layer_calls"] = moe_cfg.num_layers * (moe["steps"]["forward"] + moe["steps"]["window_steps_total"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    moe["dispatch_f32"] = moe_dispatch_checks(card, dev)
    emit("families", card=card, **moe)
    if (moe["launches"] != moe["expected_launches"] or moe["plain_calls"]
            or not moe["launches"]["ragged_paged_attention"] or moe["steps"]["fused_windows_total"]):
        checks.append(f"{FAMILY_MOE}: launches {moe['launches']} != {moe['expected_launches']}, "
                      f"{moe['plain_calls']} plain calls or {moe['steps']['fused_windows_total']} fused windows")
    for name, case in moe["moe_layer"].items():
        if not (case["within_bf16_bound"] and case["finite"]):
            checks.append(f"{FAMILY_MOE}: the {name} MoE layer's ragged output strays from dense: {case}")
    d = moe["dispatch_f32"]
    if not d["ragged_ids_equal_dense"]:
        checks.append(f"{FAMILY_MOE}: f32 greedy ids differ between ragged and dense dispatch")
    if not (d["capacity"]["moe_assignments_total"] > 0 and d["capacity"]["moe_dispatch"] == "capacity"):
        checks.append(f"{FAMILY_MOE}: capacity dispatch counted no assignments: {d['capacity']}")
    # 2. MLA + MoE.
    mla_cfg = get_config(FAMILY_MLA)
    params = init_params(mla_cfg, torch.Generator(device=dev).manual_seed(0), device=dev, dtype=torch.bfloat16)
    lite = family_serve(card, FAMILY_MLA, mla_cfg, params, dev)
    lite["weights_gb"] = tree_bytes(params) / 1e9
    lite["latent_bytes_per_token"] = mla_cfg.num_layers * mla.latent_width(mla_cfg) * 2
    lite["moe_layer"] = {"decode": moe_layer_case(mla_cfg, params, 8, dev, 33),
                         "prefill_chunk": moe_layer_case(mla_cfg, params, 512, dev, 34)}
    lite["mla_attend"] = {"decode": mla_attend_case(mla_cfg, params, rows=8, ctx=1024, chunk=1, dev=dev, seed=35),
                          "prefill_chunk": mla_attend_case(mla_cfg, params, rows=1, ctx=0, chunk=512, dev=dev,
                                                           seed=36)}
    lite["moe_layer_calls"] = lite["mla_attend_calls_expected"] = mla_cfg.num_layers * (
        lite["steps"]["forward"] + lite["steps"]["window_steps_total"])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    lite["f32_checks"] = mla_checks(dev)
    emit("families", card=card, **lite)
    if lite["launches"] != lite["expected_launches"] or lite["plain_calls"]:
        checks.append(f"{FAMILY_MLA}: kernel launches {lite['launches']} or plain calls {lite['plain_calls']}")
    if lite["mla_attend_calls"] != lite["mla_attend_calls_expected"] or not lite["mla_attend_calls"]:
        checks.append(f"{FAMILY_MLA}: {lite['mla_attend_calls']} MLA attention calls, "
                      f"expected {lite['mla_attend_calls_expected']}")
    if not (lite["repeat"]["cached_tokens"] or 0) > 0:
        checks.append(f"{FAMILY_MLA}: the repeated prompt hit no prefix cache: {lite['repeat']}")
    for name, case in lite["moe_layer"].items():
        if not (case["within_bf16_bound"] and case["finite"]):
            checks.append(f"{FAMILY_MLA}: the {name} MoE layer's ragged output strays from dense: {case}")
    if not all(c["finite"] for c in lite["mla_attend"].values()):
        checks.append(f"{FAMILY_MLA}: an MLA attention call gave non-finite values")
    f = lite["f32_checks"]
    if not (f["decode_matches_prefill"] and f["int8"]["ids_equal_where_held"] and f["int8"]["finite"]):
        checks.append(f"{FAMILY_MLA}: f32 checks failed: {f}")
    res = {"card": card, "phase_s": time.perf_counter() - t0,
           "summary": {m: {"ttft_p50_s": r["ttft_p50_s"], "decode_tok_per_s": r["decode_tok_per_s"],
                           "moe_layer_ms": {k: c["ms"] for k, c in r["moe_layer"].items()}}
                       for m, r in ((FAMILY_MOE, moe), (FAMILY_MLA, lite))},
           FAMILY_MOE: moe, FAMILY_MLA: lite}
    res["summary"][FAMILY_MLA]["mla_attend_ms"] = {k: c["ms"] for k, c in lite["mla_attend"].items()}
    res["summary"][FAMILY_MLA]["latent_bytes_per_token"] = lite["latent_bytes_per_token"]
    res["summary"][FAMILY_MOE]["kv_bytes_per_token"] = moe["kv_bytes_per_token"]
    emit("families_summary", card=card, phase_s=res["phase_s"], **res["summary"])
    if checks:
        raise AssertionError("; ".join(checks))
    return res


def kernels_line(timed: dict, served: dict, dist: dict, ckpt: dict, kvbm: dict, disagg: dict, fam: dict) -> list:
    """The ``kernels`` entries: every kernel's route, source, the TPU kernel
    it replaces, its launches on the main path, its checked error and its
    timed, plain, bound and library times. The fused window's sampled and
    guided epilogues are branches of the window's kernel, each listed apart
    with the launches of windows that took it; the sampled epilogue alone
    (not on the serving path) is reported inside its entry."""
    # Launches: each attention kernel's count over the serving pass of its
    # path, and per forward step that reaches it; the fused window's (and
    # its sampled branch's) over the windows pass, and per such window; the
    # probe's, over the probe's run.
    mega, piece, win, spec, int8, rounds, extras = (served[p] for p in SERVE_PASSES)
    launches = {
        "ragged_paged_attention_int8": int8["kernel_launches"]["ragged_paged_attention_int8"],
        "fused_decode_window_guided": win["kernel_launches"]["fused_decode_window_guided"],
        "ragged_paged_attention": mega["kernel_launches"]["ragged_paged_attention"],
        "flash_chunk_attention": piece["kernel_launches"]["flash_chunk_attention"],
        "paged_decode_partials": piece["kernel_launches"]["paged_decode_partials"],
        "fused_decode_window": win["kernel_launches"]["fused_decode_window"],
        "fused_decode_window_sampled": win["kernel_launches"]["fused_decode_window_sampled"],
        "fused_spec_window": spec["kernel_launches"]["fused_spec_window"],
        "nop": timed["nop"]["probe_launches"],
    }
    reached = {
        "ragged_paged_attention": (mega["steps"]["forward"], "step"),
        "ragged_paged_attention_int8": (int8["steps"]["forward"] + int8["steps"]["window_steps_total"], "step"),
        "flash_chunk_attention": (piece["steps"]["prefill"] - piece["steps"]["wave_steps_total"]
                                  + piece["steps"]["mixed"], "step"),
        "paged_decode_partials": (piece["steps"]["decode"] + piece["steps"]["mixed"], "step"),
        "fused_decode_window": (win["steps"]["fused_windows_total"], "window"),
        "fused_decode_window_sampled": (win["steps"]["fused_sampled_windows_total"],
                                        "window with a sampled or guided row"),
        "fused_decode_window_guided": (win["steps"]["fused_guided_windows_total"], "window with a guided row"),
        "fused_spec_window": (spec["steps"]["spec_fused_windows_total"], "spec window"),
    }
    kernels = []
    for name in ("ragged_paged_attention", "ragged_paged_attention_int8", "flash_chunk_attention",
                 "paged_decode_partials", "fused_decode_window", "fused_decode_window_sampled",
                 "fused_decode_window_guided", "fused_spec_window", "nop"):
        t = timed[name]
        # The branches' source is their kernel's.
        src = "fused_decode_window" if name.startswith("fused_decode_window") else name.removesuffix("_int8")
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"dynamo_tpu_torch/csrc/{src}.cu",
            "replaces": TPU_KERNEL[name],
            "launches": launches[name],
            "launches_per_step": launches[name] / reached[name][0] if name in reached else None,
            "unit": reached[name][1] if name in reached else None,
            "max_abs_err": t["max_abs_err"],
            "ms": t["kernel_ms"],
            "plain_ms": t["ref_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        }
        if name == "fused_decode_window_sampled":
            e = timed["sample_epilogue"]
            entry["draw_ms_per_step"] = t["phases_ms_per_step"]["pick_embed"]
            entry["greedy_ms"] = t["greedy_kernel_ms"]
            entry["epilogue_alone"] = {k: e[k] for k in ("case", "draws", "differ", "max_gap", "kernel_ms", "ref_ms",
                                                         "bound_ms", "bound_by", "passes_bound_ms", "library_ms")}
        if name in ("flash_chunk_attention", "paged_decode_partials"):
            # The card's own time (profiler) beside the event times, and the
            # same at llama-3-8b's widths (HD = 128).
            keys = ("device_ms", "library_device_ms", "achieved_kernel", "achieved_device")
            entry.update({k: t[k] for k in keys})
            entry["8b"] = {k: timed[name + " 8b"][k] for k in ("case", "shape", "max_abs_err", "kernel_ms", "ref_ms",
                                                                "bound_ms", "bound_by", "library_ms", *keys)}
        if name.startswith("ragged_paged_attention"):
            # The card's own time beside the event times (a CUDA graph of
            # 20 calls), and the rates it achieves.
            keys = ("device_ms", "library_device_ms", "achieved_kernel", "achieved_device")
            entry.update({k: t[k] for k in keys})
            cases = ("case", "shape", "max_abs_err", "kernel_ms", "ref_ms", "bound_ms", "bound_by", "library_ms", *keys)
        if name.startswith("ragged_paged_attention"):
            # chunk_decode's shapes (PR 13): a wave and a spec verify, with
            # the queries each sends down the chunk and the split path.
            paths = ("chunk_queries", "split_queries")
            entry["wave"] = {k: timed[name + " wave"][k] for k in (*cases, *paths)}
            entry["verify"] = {k: timed[name + " verify"][k] for k in (*cases, *paths)}
        if name == "ragged_paged_attention":
            entry["empty_grid_device_ms"] = t["empty_grid_device_ms"]
            entry["prefill"] = {k: timed[name + " prefill"][k] for k in (*cases, "flash_device_ms")}
            entry["decode"] = {k: timed[name + " decode"][k] for k in cases}
            entry["wave"].update({k: timed[name + " wave"][k] for k in ("sdpa_causal_chunks_ms",
                                                                         "sdpa_causal_chunks_device_ms")})
            entry["verify_packed"] = {k: timed[name + " verify packed"][k] for k in (*cases, *paths)}
            # The spec-rounds pass: 16 a forward step, draft prefill chunk
            # and each of a round's γ + 1 passes.
            entry["launches_spec_rounds"] = rounds["kernel_launches"][name]
            entry["launches_spec_rounds_expected"] = rounds["expected_launches"][name]
            # The extras pass: its extras rows' single steps beside the
            # row-wise fallback's fused windows.
            entry["launches_extras"] = extras["kernel_launches"][name]
            entry["launches_extras_expected"] = extras["expected_launches"][name]
        if name in ("ragged_paged_attention", "fused_decode_window", "fused_decode_window_sampled",
                    "fused_decode_window_guided"):
            # The checkpoint phase: the model served from its files.
            entry["launches_checkpoint"] = ckpt["bf16"]["kernel_launches"][name]
            entry["launches_checkpoint_expected"] = ckpt["bf16"]["expected_launches"][name]
        if name in ("ragged_paged_attention", "fused_decode_window"):
            # The distributed phase: both workers' launches since they
            # registered, beside what their steps and windows expect.
            entry["launches_distributed"] = sum(w["launches"][name] for w in dist["workers"].values())
            entry["launches_distributed_expected"] = sum(w["expected_launches"][name]
                                                         for w in dist["workers"].values())
            # The kvbm phase: the tiered engine's run; disagg: both workers'.
            entry["launches_kvbm"] = kvbm["launches"][name]
            entry["launches_kvbm_expected"] = kvbm["expected_launches"][name]
            entry["launches_disagg"] = {w: r["launches"][name] for w, r in disagg["workers"].items()}
            entry["launches_disagg_expected"] = {w: r["expected_launches"][name]
                                                 for w, r in disagg["workers"].items()}
        if name == "ragged_paged_attention":
            # The families phase: the MoE model's burst (the MLA model's
            # attention is PyTorch ops and launches no kernel).
            entry["launches_families"] = {m: fam[m]["launches"][name] for m in (FAMILY_MOE, FAMILY_MLA)}
            entry["launches_families_expected"] = {m: fam[m]["expected_launches"][name]
                                                   for m in (FAMILY_MOE, FAMILY_MLA)}
        if name == "ragged_paged_attention_int8":
            # library_ms: the gathered codes dequantized to dense K/V, then SDPA.
            entry["sdpa_alone_ms"] = t["sdpa_alone_ms"]
            entry["sdpa_alone_device_ms"] = t["sdpa_alone_device_ms"]
            entry["8b"] = {k: timed[name + " 8b"][k] for k in (*cases, "sdpa_alone_ms", "sdpa_alone_device_ms")}
        if name == "fused_decode_window":
            # The stamps' product phases beside one cuBLAS forward of the
            # same rows, and llama-3.2-3b's greedy window.
            entry.update({k: t[k] for k in ("kernel_ms_per_step", "phases_ms_per_step", "products_per_step", "3b")})
        if name == "fused_decode_window_guided":
            entry["sampled_ms"] = t["sampled_kernel_ms"]
            entry["tokens_outside_grammar"] = t["guided"]["tokens_outside_grammar"]
        if name == "fused_spec_window":
            entry.update({k: t[k] for k in ("case", "kernel_ms_per_round", "streamed_bound_ms", "confirmed_tokens_per_row",
                                             "ms_per_confirmed_token", "window_ms_per_step", "phases_ms_per_round")})
            entry["3b_1b"] = t["3b_1b"]
        kernels.append(entry)
    return kernels


def windows_from(root: str) -> None:
    """The bf16 greedy windows of llama-3.2-1b and llama-3.2-3b (8 rows at
    1024 tokens, 32 steps, ``window_case``'s seeded inputs) through the
    port's package under ``root`` (another tree's, e.g. the parent
    commit's, unpacked by ``git archive``): ms per step by events and the
    phases from the kernel's stamps. Prints one ``windows_from`` line."""
    import os

    sys.path.insert(0, os.path.abspath(root))
    import dynamo_tpu_torch
    from dynamo_tpu_torch.engine.attention import megakernel as mk
    from dynamo_tpu_torch.engine.config import get_config

    dev = torch.device("cuda", 0)
    out = {}
    for name in (PRESET, TARGET_3B):
        case = window_case(f"{name} 8 x 1024", dev, torch.bfloat16, 410, cfg=get_config(name), positions=[1024] * 8,
                           dead=0, steps=32)
        w, k, v, ints, kw = case["weights"], case["k"], case["v"], case["ints"], case["kw"]
        ms = cuda_ms(lambda: mk.fused_decode_window(*w, k, v, *ints, **kw), iters=5, warmup=1)
        out[name] = {"ms_per_step": ms / 32, "phases_ms_per_step": stamp_phases(w, k, v, ints, (), kw, case["cfg"].num_layers)}
        del case, w, k, v
        torch.cuda.empty_cache()
    emit("windows_from", root=root, package=dynamo_tpu_torch.__file__, card=gpu_name_and_power(), windows=out)


# The serve passes ``--parent`` times on both trees.
PARENT_SERVE_PASSES = ("megakernel+windows",)
SERVE_FROM_KEYS = ("decode_tok_per_s", "wall_s", "ttft_p50_s", "ttft_unguided_p50_s", "steps", "graphs")


def serve_from(root: str, path: str) -> None:
    """The serve pass ``path`` of the tree under ``root`` (another tree's,
    e.g. the parent commit's, unpacked by ``git archive``): that tree's own
    ``phase_serve`` over its own package, three times in this process. The
    first run warms the process (libraries loaded, allocator, handles and
    the runtime's lazy state), as the earlier phases do before the serve
    phase of a full run; the later two are the readings. Prints one
    ``serve_from`` line with every run's tokens/s, wall, TTFTs, steps,
    graphs, garbage-collection seconds, grammar compile seconds and each
    answer's latency."""
    import importlib.util
    import os

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("tree_chip_smoke", os.path.join(root, "chip_smoke.py"))
    tree = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tree)
    import dynamo_tpu_torch

    card = gpu_name_and_power()
    # Seconds the garbage collector held the interpreter during each run
    # (an earlier run's engine freed in a later one's steps shows here).
    gc_s, started = [0.0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - started[0]

    gc.callbacks.append(on_gc)
    runs = []
    for _ in range(3):
        gc_s[0] = 0.0
        r = tree.phase_serve(card, path)
        grammars = ((r.get("guided_stats") or {}).get("guided_pool") or {}).get("grammars", [])
        runs.append({**{k: r.get(k) for k in SERVE_FROM_KEYS}, "gc_s": gc_s[0],
                     "latency_s": [a.get("latency_s") for a in r["answers"]],
                     # Each grammar's compile seconds (the windows pass's wall follows json_object's).
                     "grammar_compile_s": {g["pattern"][:24]: g["compile_s"] for g in grammars}})
    gc.callbacks.remove(on_gc)
    emit("serve_from", root=root, package=dynamo_tpu_torch.__file__, card=card, path=path, runs=runs)


def alternate(parent: str, phase: str, argv) -> list:
    """``argv(root)`` of this script over the parent tree and this one in
    separate processes, in the order parent, this, this, parent (one card,
    one call): each run's ``phase`` line."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for root in (parent, here, here, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), *argv(root)],
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(f'{{"phase": "{phase}"')]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"{phase} {root} failed: {proc.stderr[-2000:]}")
        runs.append(json.loads(lines[-1]))
    return runs


def build_tree(root: str) -> subprocess.Popen:
    """Start building another tree's kernels from its own sources, into its
    own ``build/`` (its ``_build.build()``, one ``nvcc`` per source)."""
    return subprocess.Popen([sys.executable, "-c", "from dynamo_tpu_torch import _build; _build.build()"],
                            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def parent_runs(parent: str) -> dict:
    """The parent tree beside this one, in turns: its greedy windows
    (``windows_from``) and each of ``PARENT_SERVE_PASSES`` (``serve_from``)."""
    out = {"windows": alternate(parent, "windows_from", lambda root: ["--windows-from", root])}
    for path in PARENT_SERVE_PASSES:
        out[path] = alternate(parent, "serve_from", lambda root: ["--serve-from", root, "--serve-pass", path])
    return out


FULL_RUN = ("env", "build", "families", "kernel", "model", "breakdown", "serve", "checkpoint", "distributed", "kvbm",
            "disagg")
# The kernels the families phase runs (it runs while the others build).
FAMILIES_KERNELS = ("ragged_paged_attention",)
# The slowest build, and the phases that need none of it (the deployments'
# workers run the ragged kernel and the fused window): they run on the card
# while it still builds on the host.
LAST_KERNELS = ("fused_spec_window",)
DEPLOYMENT_PHASES = ("distributed", "kvbm", "disagg")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phases", default=",".join(FULL_RUN))
    p.add_argument("--parent", default=None,
                   help="another tree of the port (the parent commit's): its greedy windows and its "
                        "PARENT_SERVE_PASSES timed beside this one's, each tree with the kernels built from its "
                        "own sources")
    p.add_argument("--windows-from", default=None, help=argparse.SUPPRESS)
    p.add_argument("--serve-from", default=None, help=argparse.SUPPRESS)
    p.add_argument("--serve-pass", default=PARENT_SERVE_PASSES[0], help=argparse.SUPPRESS)
    args = p.parse_args()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products of the plain versions accumulate in f32, as the kernels'.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if args.windows_from:
        windows_from(args.windows_from)
        return 0
    if args.serve_from:
        serve_from(args.serve_from, args.serve_pass)
        return 0
    parent_build = build_tree(args.parent) if args.parent else None
    dev = torch.device("cuda", 0)
    card = gpu_name_and_power()
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())

    from dynamo_tpu_torch import _build

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    # One nvcc a source, all started together, in three groups: the families
    # phase needs only FAMILIES_KERNELS and the DEPLOYMENT_PHASES all but
    # LAST_KERNELS, so each runs on the card while the rest still builds on
    # the host (the fused kernels take minutes).
    groups = {"middle": [n for n in _build.sources() if n not in FAMILIES_KERNELS + LAST_KERNELS],
              "last": list(LAST_KERNELS)}
    results: dict = {g: {} for g in groups}
    done_at: dict = {}
    # Each library's tensor-core instruction counts, read from its machine
    # code on a thread of its own while the card runs the phases.
    sass: dict = {}
    sass_threads: list = []

    def read_sass(libs: dict) -> None:
        def read():
            sass.update({n: tensor_core_ops(r["path"]) for n, r in libs.items()})

        sass_threads.append(threading.Thread(target=read, name="sass"))
        sass_threads[-1].start()

    def build_group(group):
        try:
            results[group].update(_build.build(groups[group]))
            read_sass(dict(results[group]))
        except BaseException as e:  # re-raised on the main thread below
            results[group]["error"] = e
        done_at[group] = time.perf_counter()

    threads = [threading.Thread(target=build_group, args=(g,), name=f"nvcc-{g}") for g in groups]
    for th in threads:
        th.start()
    # The host library (csrc/native.cc: block hashing, the router's radix
    # tree), with the host compiler while nvcc runs; every engine and router
    # of the later phases loads it.
    host = _build.build_host("native")
    built = _build.build(FAMILIES_KERNELS)
    first_kernels_s = time.perf_counter() - t0
    read_sass(dict(built))
    seconds = {}

    def timed_phase(name, fn):
        t1 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t1
        return out

    dist = kvbm = disagg = None
    try:
        fam = timed_phase("families", lambda: phase_families(card, dev)) if "families" in phases else None
        threads[0].join()
        if "error" in results["middle"]:
            raise results["middle"]["error"]
        if "distributed" in phases:
            dist = timed_phase("distributed", lambda: phase_distributed(card))
            seconds["distributed_multimodal"] = dist["multimodal_seconds"]
        kvbm = timed_phase("kvbm", lambda: phase_kvbm(card, dev)) if "kvbm" in phases else None
        disagg = timed_phase("disagg", lambda: phase_disagg(card, dev)) if "disagg" in phases else None
    finally:
        for th in threads:
            th.join()
    for group in groups:
        if "error" in results[group]:
            raise results[group]["error"]
        built.update(results[group])
    build_s = max(done_at.values()) - t0
    for th in sass_threads:
        th.join()
    if set(built) - set(sass):
        raise RuntimeError(f"cuobjdump read no machine code of {sorted(set(built) - set(sass))}")
    overlapped = [n for n, r in (("families", fam), ("distributed", dist), ("kvbm", kvbm), ("disagg", disagg))
                  if r is not None]
    emit("build", seconds=build_s, families_kernels_seconds=first_kernels_s,
         middle_kernels_seconds=done_at["middle"] - t0, overlapped_phases=overlapped,
         host_library_seconds=host["seconds"],
         libraries={n: {"seconds": r["seconds"], "ptxas": [ln for ln in r["log"].splitlines() if "ptxas" in ln],
                        "sass": sass[n]}
                    for n, r in built.items()})
    if parent_build is not None:
        # The other tree's build ends before anything is timed.
        log, _ = parent_build.communicate()
        if parent_build.returncode != 0:
            raise RuntimeError(f"building {args.parent}'s kernels failed: {log[-2000:]}")
    # The fused kernels' bf16 products run on wgmma: their libraries hold HGMMA.
    for name in ("fused_decode_window", "fused_spec_window"):
        if sass[name]["HGMMA"] == 0:
            raise AssertionError(f"{name}: no HGMMA in the built library ({sass[name]})")

    # Wall seconds of each phase, printed at the end (a run may have a time
    # limit; the build's seconds vary with nvcc's, and hold the phases that
    # ran beside it: the total is the wall since the build began).
    seconds["build"] = build_s

    timed = timed_phase("kernel", lambda: phase_kernel(dev)) if "kernel" in phases else None
    if "model" in phases:
        timed_phase("model", lambda: phase_model(dev))
    if "breakdown" in phases:
        timed_phase("breakdown", lambda: phase_breakdown(dev))
    served = None
    if "serve" in phases:
        served = timed_phase("serve", lambda: {path: phase_serve(card, path) for path in SERVE_PASSES})
    ckpt = timed_phase("checkpoint", lambda: phase_checkpoint(card, dev)) if "checkpoint" in phases else None
    if "grammar" in phases:
        timed_phase("grammar", lambda: phase_grammar(card))
    if args.parent:
        emit("parent", **timed_phase("parent", lambda: parent_runs(args.parent)))
    emit("seconds", **seconds, total=time.perf_counter() - t0)
    if phases != set(FULL_RUN):
        return 0  # a partial run reports no result
    kernels = kernels_line(timed, served, dist, ckpt, kvbm, disagg, fam)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
