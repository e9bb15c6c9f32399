"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``dynamo_tpu_torch/csrc`` with nvcc, holds each kernel against its plain
PyTorch version at the shapes the serving path gives it, runs the
full-width llama-3.2-1b model on the kernel path against the plain path,
then serves ``dynamo_tpu_torch.run in=http out=llama-3.2-1b`` and sends it
concurrent requests, counting the kernel's launches. Every phase prints one
JSON line; any failure raises and exits non-zero. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2 and
prints no result.

``--phases`` runs a subset of kernel,model,breakdown,serve (env and build
always run) for iteration; the full run is the default.
"""

from __future__ import annotations

import argparse
import asyncio
import http.client
import json
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 CUDA-core
TPU_KERNEL = "dynamo_tpu/engine/attention/megakernel.py:123"  # _mega_kernel, launched at :296
PRESET = "llama-3.2-1b"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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
    PyTorch call computing the same function, timed as a yardstick only."""
    q, k_extra, v_extra, k_pages, v_pages, tables, meta = case["args"]
    BS, KVH = case["BS"], case["KVH"]
    NQ, H, HD = q.shape
    row_of, prefix, e_start, e_end, live = meta.long()
    R, W = tables.shape
    counts = torch.bincount(row_of, minlength=R).tolist()
    QM = max(counts)
    S = W * BS + k_extra.shape[0]
    kd = torch.cat([k_pages[tables.long()].reshape(R, W * BS, KVH, HD), k_extra[None].expand(R, -1, -1, -1)], 1)
    vd = torch.cat([v_pages[tables.long()].reshape(R, W * BS, KVH, HD), v_extra[None].expand(R, -1, -1, -1)], 1)
    kd = kd.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()  # [R, H, S, HD]
    vd = vd.repeat_interleave(H // KVH, dim=2).transpose(1, 2).contiguous()
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
    return cuda_ms(fn)


def check_attention(case, *, time_it: bool):
    from dynamo_tpu_torch.engine.attention import megakernel as mk

    args, KVH, BS, dtype = case["args"], case["KVH"], case["BS"], case["dtype"]
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
        # rounding (2^-9·|o| each).
        v_max = max(args[2].abs().max().item(), args[4][1:].abs().max().item())
        tol = 2**-9 * v_max + 2 * 2**-9 * ref.float().abs().max().item() + 1e-6
    dead_nonzero = 0
    if case["dead"]:
        live = args[6][4] != 0
        dead_nonzero = int((out[~live] != 0).sum().item())
    ok = err <= tol and dead_nonzero == 0 and bool(torch.isfinite(out).all())
    res = {"case": case["name"], "dtype": str(dtype).replace("torch.", ""),
           "shape": {"NQ": args[0].shape[0], "H": args[0].shape[1], "KVH": KVH, "HD": args[0].shape[2],
                     "W": args[5].shape[1]},
           "max_abs_err": err, "tol": tol, "dead_nonzero": dead_nonzero, "ok": ok}
    if time_it:
        nbytes, flops = attention_work(case)
        res["kernel_ms"] = cuda_ms(lambda: mk.ragged_paged_attention(*args, **kw))
        res["ref_ms"] = cuda_ms(lambda: mk.ragged_paged_attention_ref(*args, **kw), iters=20)
        res["library_ms"] = sdpa_yardstick(case)
        res["bytes"], res["flops"] = nbytes, flops
        res["bound_ms"] = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]) * 1e3
        res["bound_by"] = "bytes" if nbytes / PEAK_BYTES_PER_S >= flops / PEAK_FLOPS[dtype] else "operations"
    emit("kernel", **res)
    if not ok:
        raise AssertionError(f"kernel disagrees with its plain version: {res}")
    return res




def phase_kernel(dev):
    """The attention kernel at the shapes the serving path gives it, and at
    the ragged edges, in bf16 and f32. Returns the timed llama-3.2-1b case."""
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
    timed = None
    for i, (name, spec) in enumerate(specs):
        for dtype in (torch.bfloat16, torch.float32):
            case = attention_case(name, dtype=dtype, dev=dev, seed=100 + i, **spec)
            res = check_attention(case, time_it=(i == 0 and dtype == torch.bfloat16))
            if "kernel_ms" in res:
                timed = res
            del case
    torch.cuda.empty_cache()
    return timed


# ---------------------------------------------------------------------------
# Phase 4: the full-width model, kernel path against plain path
# ---------------------------------------------------------------------------


def phase_model(dev):
    """llama-3.2-1b at full width in f32, teacher-forced through one
    300-token prefill, 16 decode steps (batch 2, one padded lane) and one
    mixed step, on the card (kernel) and on the CPU (plain version)."""
    from dynamo_tpu_torch.engine.attention import megakernel as mk
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.engine.weights import init_params

    cfg = get_config(PRESET)
    gen = torch.Generator(device=dev).manual_seed(0)
    params_dev = init_params(cfg, gen, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(7)
    seq_a = rng.integers(1, cfg.vocab_size, size=318).astype(np.int32)
    seq_b = rng.integers(1, cfg.vocab_size, size=80).astype(np.int32)
    nb = 48
    table_a = np.zeros(24, np.int32)
    table_a[:20] = np.arange(1, 21)
    table_b = np.zeros(16, np.int32)
    table_b[:6] = np.arange(21, 27)

    def run(params, device):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        cache = KvCacheArrays.create(cfg, nb, dtype=torch.float32, device=device)
        k, v = cache.k, cache.v
        logits = []
        toks = np.zeros(512, np.int32)
        toks[:300] = seq_a[:300]
        lg, k, v = llama.prefill(params, cfg, k, v, t(toks), 300, 0, t(table_a))
        logits.append(lg[None])
        d_tables = np.stack([table_a, np.zeros_like(table_a)])
        for i in range(16):
            pos = 300 + i
            lg, k, v = llama.decode(
                params, cfg, k, v, t(np.array([seq_a[pos], 0], np.int32)), t(np.array([pos, 0], np.int32)),
                t(d_tables), t(np.array([True, False])),
            )
            logits.append(lg[:1])
        p_tok = np.zeros(128, np.int32)
        p_tok[:80] = seq_b
        lg, k, v = llama.mixed_step(
            params, cfg, k, v, t(p_tok), 80, 0, t(table_b),
            t(seq_a[316:317]), t(np.array([316], np.int32)), t(table_a[None]), t(np.array([True])),
        )
        logits.append(lg)
        return [x.float().cpu() for x in logits]

    l0 = mk.KERNEL_LAUNCHES
    t0 = time.perf_counter()
    kern = run(params_dev, dev)
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t0
    launches = mk.KERNEL_LAUNCHES - l0
    params_cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v.cpu())
                  for k, v in params_dev.items()}
    del params_dev
    torch.cuda.empty_cache()
    r0 = mk.REF_CALLS
    t0 = time.perf_counter()
    plain = run(params_cpu, "cpu")
    plain_s = time.perf_counter() - t0
    errs = [(a - b).abs().max().item() for a, b in zip(kern, plain)]
    scale = max(b.abs().max().item() for b in plain)
    # f32 on both sides; the card's and the CPU's matmuls sum in different
    # orders through 16 layers, so allow 1e-3 of the logits' scale.
    tol = 1e-3 * max(1.0, scale)
    ok = max(errs) <= tol and all(bool(torch.isfinite(x).all()) for x in kern)
    steps = 1 + 16 + 1
    res = {"preset": PRESET, "dtype": "float32", "steps": steps, "max_abs_err": max(errs),
           "per_step_err": errs, "logit_scale": scale, "tol": tol, "kernel_launches": launches,
           "expected_launches": cfg.num_layers * steps, "plain_calls": mk.REF_CALLS - r0,
           "card_s": kern_s, "cpu_s": plain_s, "ok": ok}
    emit("model", **res)
    if not ok or launches != cfg.num_layers * steps:
        raise AssertionError(f"model phase failed: {res}")
    del params_cpu


# ---------------------------------------------------------------------------
# Phase 4b: where a forward step's device time goes
# ---------------------------------------------------------------------------


class AttentionTimer:
    """Brackets every attention launch made inside the ``with`` block with
    CUDA events; ``ms()`` is their summed device time."""

    def __enter__(self):
        from dynamo_tpu_torch.engine.attention import megakernel as mk

        self.mk, self.orig, self.pairs = mk, mk.ragged_paged_attention, []

        def timed(*args, **kw):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.orig(*args, **kw)
            b.record()
            self.pairs.append((a, b))
            return out

        mk.ragged_paged_attention = timed
        return self

    def __exit__(self, *exc):
        self.mk.ragged_paged_attention = self.orig

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def phase_breakdown(dev):
    """Device time of one decode step and one mixed step of llama-3.2-1b in
    bf16 (CUDA events, median of 20), and the share of it the 16
    attention launches take."""
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.kv_cache import KvCacheArrays
    from dynamo_tpu_torch.engine.models import llama
    from dynamo_tpu_torch.engine.scheduler import width_bucket
    from dynamo_tpu_torch.engine.weights import init_params

    cfg = get_config(PRESET)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(1), device=dev, dtype=torch.bfloat16)
    cache = KvCacheArrays.create(cfg, 2048, dtype=torch.bfloat16, device=dev)
    cache.k.normal_()
    cache.v.normal_()
    rng = np.random.default_rng(5)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    B, ctx, chunk, BS = 8, 1024, 512, cfg.block_size
    per_row = ctx // BS + 1
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

    def decode():
        llama.decode(params, cfg, cache.k, cache.v, *d_args)

    def mixed():
        llama.mixed_step(params, cfg, cache.k, cache.v, p_tok, chunk, ctx, p_tab, *d_args)

    res = {"preset": PRESET, "dtype": "bfloat16", "decode_rows": B, "context": ctx, "chunk": chunk}
    for name, fn in (("decode", decode), ("mixed", mixed)):
        step_ms = cuda_ms(fn, iters=20)
        attn = []
        for _ in range(5):
            with AttentionTimer() as timer:
                fn()
            attn.append(timer.ms())
        attn_ms = statistics.median(attn)
        res[name] = {"step_ms": step_ms, "attention_ms": attn_ms, "attention_share": attn_ms / step_ms,
                     "attention_launches": len(timer.pairs)}
    emit("breakdown", **res)
    del params, cache
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 5: serving through the HTTP entry point
# ---------------------------------------------------------------------------


def _request(port: int, path: str, body: dict):
    """POST one request; returns (status, parsed body or SSE chunk list,
    seconds to the first content chunk or None, total seconds)."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
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
        chunks.append(chunk)
    conn.close()
    return resp.status, chunks, first, time.perf_counter() - t0


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


def phase_serve(card: str):
    from dynamo_tpu_torch import run
    from dynamo_tpu_torch.engine.attention import megakernel as mk

    args = run.parse_args(["in=http", f"out={PRESET}", "--http-host", "127.0.0.1", "--http-port", "0"])
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
    for _, body in reqs:
        body.setdefault("temperature", 0.0)
        body.update(model=PRESET, max_tokens=64)

    async def serve():
        service, engine = run.build_service(args)
        await service.start()
        try:
            # Counts from zero, just before the main path runs.
            mk.KERNEL_LAUNCHES = 0
            mk.REF_CALLS = 0
            steps0 = engine.scheduler.forward_steps_total
            t0 = time.perf_counter()
            results = await asyncio.gather(
                *[asyncio.to_thread(_request, service.port, path, body) for path, body in reqs]
            )
            wall = time.perf_counter() - t0
            repeat = await asyncio.to_thread(_request, service.port, *reqs[0])
            launches, ref_calls = mk.KERNEL_LAUNCHES, mk.REF_CALLS
            steps = engine.scheduler.forward_steps_total - steps0
            metrics = engine.metrics().to_wire()
        finally:
            await service.stop()
            await engine.stop()
        return results, wall, repeat, launches, ref_calls, steps, metrics, engine.scheduler.mc

    results, wall, repeat, launches, ref_calls, steps, metrics, mc = asyncio.run(serve())
    answers = []
    for (path, body), (status, data, first, total) in zip(reqs, results):
        n, finish, cached = _summarize(status, data, body.get("stream", False))
        if n != 64 and finish != "stop":
            raise AssertionError(f"{path} gave {n} tokens with finish_reason {finish!r}")
        answers.append({"path": path, "stream": bool(body.get("stream")), "completion_tokens": n,
                        "finish_reason": finish, "ttft_s": first, "latency_s": total})
    n_rep, finish_rep, cached_rep = _summarize(repeat[0], repeat[1], False)
    ttfts = [a["ttft_s"] for a in answers if a["ttft_s"] is not None]
    completion = sum(a["completion_tokens"] for a in answers)
    res = {
        "card": card, "preset": PRESET, "dtype": args.dtype, "num_blocks": args.num_blocks,
        "requests": len(answers) + 1, "answers": answers,
        "repeat": {"completion_tokens": n_rep, "finish_reason": finish_rep, "cached_tokens": cached_rep},
        "ttft_p50_s": statistics.median(ttfts), "ttft_n": len(ttfts),
        "decode_tok_per_s": completion / wall, "wall_s": wall, "wall_ms_per_forward_step": 1e3 * wall / steps,
        "forward_steps": steps, "kernel_launches": launches, "expected_launches": mc.num_layers * steps,
        "plain_calls": ref_calls, "mixed_steps_total": metrics["mixed_steps_total"],
        "cached_tokens_total": metrics["cached_tokens_total"],
    }
    emit("serve", **res)
    if not cached_rep:
        raise AssertionError("the repeated prompt did not hit the prefix cache")
    if launches != mc.num_layers * steps or steps == 0:
        raise AssertionError(f"{launches} kernel launches over {steps} forward steps of {mc.num_layers} layers")
    if ref_calls:
        raise AssertionError(f"serving called the plain attention {ref_calls} times")
    return res


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phases", default="env,build,kernel,model,breakdown,serve")
    phases = set(p.parse_args().phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke test needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_power()
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count())

    from dynamo_tpu_torch import _build

    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    built = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         libraries={n: {"seconds": r["seconds"], "ptxas": [ln for ln in r["log"].splitlines() if "ptxas" in ln]}
                    for n, r in built.items()})

    timed = phase_kernel(dev) if "kernel" in phases else None
    if "model" in phases:
        phase_model(dev)
    if "breakdown" in phases:
        phase_breakdown(dev)
    served = phase_serve(card) if "serve" in phases else None
    if phases != {"env", "build", "kernel", "model", "breakdown", "serve"}:
        return 0  # a partial run reports no result
    kernels = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": TPU_KERNEL,
        "launches": served["kernel_launches"],
        "launches_per_step": served["kernel_launches"] / served["forward_steps"],
        "max_abs_err": timed["max_abs_err"],
        "ms": timed["kernel_ms"],
        "plain_ms": timed["ref_ms"],
        "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"],
        "library_ms": timed["library_ms"],
    }]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
