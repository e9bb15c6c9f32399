"""CUDA graphs of the scheduler's per-step work: the port's counterpart of
the JAX scheduler's jit cache.

The JAX package runs each step as one jitted executable per shape key,
compiled before traffic by ``Scheduler.warmup``; the port issues a step's
PyTorch ops from Python, about a thousand launches a step. ``StepGraphs``
captures each step's function once per key as a ``torch.cuda.CUDAGraph``
and replays it, so a step costs the host one staging copy and one replay.
Keys (the shapes a graph is captured at):

- ``("prefill", model, S, W)``: a prefill chunk of bucket S over a table
  of W blocks, of the target (or ``"draft"``) model;
- ``("mixed", S, B, W)``: a mixed step, the chunk's table and the decode
  tables at one width W;
- ``("decode", B, W)`` and ``("decode_sample", B, W, greedy)``: a decode
  step, and a decode step with its draw and the next step's inputs (the
  overlapped pipeline's step);
- ``("draw", B, mode)``: the draw over B rows of logits, ``mode`` one of
  "greedy" (the argmax alone), "key" (one key) and "row_keys" (per-row
  keys);
- ``("decode_multi_step", model, steps, B, W, greedy, logits)``: one step
  of a ``steps``-step decode window of the target (or ``"draft"``) model,
  replayed ``steps`` times, its step index a device input the graph
  advances; ``logits`` keeps each step's logits (the per-round spec path's
  draft window);
- ``("wave", B, S, W)``: a wave admission, ``llama.chunk_decode`` of B
  prompts in S-token rows with each row's last logits;
- ``("spec_draft", γ, B, W, greedy)`` and ``("spec_target", γ, B, W)``: a
  per-round spec round's chunk passes, the draft's over each row's
  unconsumed tokens with the first proposal drawn, and the target's verify
  of ``[last ; proposals]`` with every position's logits.

A greedy graph (an all-greedy batch, which the host knows from its
sampling rows) draws nothing: it takes the argmax, as the JAX sampler
skips the draw of an all-greedy batch.

Each graph reads its inputs from one static int32 buffer of named fields
(tokens, tables, scalars; floats and keys by their bits), which a replay
fills with ONE ``copy_`` from pinned host memory, as the JAX scheduler
packs ``tpa``. Forward graphs leave their logits in a fixed buffer per
batch size, which the draw graphs read. All graphs share one memory pool.
The KV cache and the parameters keep the addresses a graph captured:
neither is ever reallocated. The attention kernels' split counters are
sized up front (``reserve_counters``); one that grows later leaves the
tensor it replaces alive for the graphs that captured it. A graph records the kernel launches its capture made,
and each replay credits them to the kernel wrappers' counters
(``megakernel.KERNEL_LAUNCHES`` and the rest), so the launch counts read
the same as eager calls would.

On a CUDA device the graphs are the only path: a failed capture or replay
raises, never falls back to eager. On the CPU the same buffers are filled
and the step functions run eagerly on them, which is what the tests run.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.engine.attention import decode as paged_decode
from dynamo_tpu_torch.engine.attention import megakernel, prefill as flash
from dynamo_tpu_torch.engine.models import llama
from dynamo_tpu_torch.engine.sampling import sample_batch_device

# The kernel wrappers' counters a capture can move.
_COUNTERS = (
    (megakernel, "KERNEL_LAUNCHES"), (megakernel, "KERNEL_LAUNCHES_INT8"),
    (megakernel, "REF_CALLS"), (megakernel, "REF_CALLS_INT8"),
    (paged_decode, "KERNEL_LAUNCHES"), (paged_decode, "REF_CALLS"),
    (flash, "KERNEL_LAUNCHES"), (flash, "REF_CALLS"),
)

# A field: (name, shape, numpy dtype); int32, float32 and uint32 share the buffer's 4-byte words.
Field = Tuple[str, Tuple[int, ...], type]
_TORCH = {np.int32: torch.int32, np.uint32: torch.int32, np.float32: torch.float32}


def _counts() -> List[int]:
    return [getattr(mod, name) for mod, name in _COUNTERS]


def _samp_fields(batch: int, key: bool) -> List[Field]:
    """A sampled draw's rows (temperature, top-k, top-p), and its key."""
    fields = [("temps", (batch,), np.float32), ("top_ks", (batch,), np.int32), ("top_ps", (batch,), np.float32)]
    return fields + ([("key", (2,), np.uint32)] if key else [])


class _Graph:
    """One key's captured graph (None on the CPU), its static input buffer
    and views, its pinned staging buffers (two, used in turn, each with
    the event of the copy that last read it), its outputs and the kernel
    launches one replay makes."""

    def __init__(self, fields: Sequence[Field], device: torch.device, body: Callable):
        self.body = body
        self.offsets: Dict[str, Tuple[int, Tuple[int, ...], type]] = {}
        off = 0
        for name, shape, dtype in fields:
            self.offsets[name] = (off, tuple(shape), dtype)
            off += int(np.prod(shape, dtype=np.int64))
        self.buf = torch.zeros((max(off, 1),), dtype=torch.int32, device=device)
        self.inputs = {name: self.buf[o:o + int(np.prod(shape, dtype=np.int64))].view(_TORCH[dt]).view(shape)
                       for name, (o, shape, dt) in self.offsets.items()}
        on_card = device.type == "cuda"
        self.host = [torch.zeros_like(self.buf, device="cpu", pin_memory=True) for _ in range(2)] if on_card \
            else [self.buf]
        self.events = [torch.cuda.Event() for _ in self.host] if on_card else []
        self.views = [self.host_views(h) for h in self.host]
        self.turn = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: tuple = ()
        self.launches = [0] * len(_COUNTERS)

    def host_views(self, host: torch.Tensor) -> Dict[str, np.ndarray]:
        words = host.numpy()
        return {name: words[o:o + int(np.prod(shape, dtype=np.int64))].view(dt).reshape(shape)
                for name, (o, shape, dt) in self.offsets.items()}


class HostRead:
    """A device tensor's copy into pinned host memory, started on the
    current stream without waiting; ``wait`` returns it as numpy once the
    copy is done (an event wait, not a stream sync)."""

    def __init__(self, t: torch.Tensor, pinned: Optional[torch.Tensor], event: Optional[torch.cuda.Event]):
        if pinned is None:
            self._host, self._event = t.detach().cpu(), None
        else:
            self._host = pinned[: t.numel()].view(t.shape)
            self._host.copy_(t, non_blocking=True)
            event.record()
            self._event = event

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy().copy()


class HostReads:
    """Non-blocking reads of small int32 device tensors: two pinned
    buffers used in turn (a read must be waited for before the read after
    next starts), each with the event of its copy."""

    def __init__(self, device):
        self.on_card = torch.device(device).type == "cuda"
        self._bufs: List[Tuple[torch.Tensor, torch.cuda.Event]] = []
        self._turn = 0

    def read_async(self, t: torch.Tensor) -> HostRead:
        """Start ``t``'s copy to the host on the current stream."""
        if not self.on_card:
            return HostRead(t, None, None)
        if not self._bufs:
            self._bufs = [(torch.empty((1 << 12,), dtype=torch.int32, pin_memory=True), torch.cuda.Event())
                          for _ in range(2)]
        pinned, event = self._bufs[self._turn]
        self._turn ^= 1
        event.synchronize()
        if t.dtype != torch.int32 or t.numel() > pinned.numel():
            raise ValueError(f"read_async takes int32 of at most {pinned.numel()} elements, got {t.dtype} "
                             f"{tuple(t.shape)}")
        return HostRead(t, pinned, event)


class StepGraphs:
    """The scheduler's graphs by key (module docstring), on one device."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.on_card = self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.on_card else None
        self._stream = torch.cuda.Stream(self.device) if self.on_card else None
        self._graphs: Dict[tuple, _Graph] = {}
        self._warm_kinds: set = set()
        self._logits: Dict[Tuple[int, int], torch.Tensor] = {}
        self._own_logits: Dict[Tuple[str, int], torch.Tensor] = {}
        self._carries: Dict[tuple, llama.WindowCarry] = {}
        self.captures_total = 0
        self.capture_s_total = 0.0
        self.replays_total = 0

    def close(self) -> None:
        """Destroy every graph, its buffers and the pool's memory now (after
        the card finished their work); the counters stay. A later step
        captures its key again."""
        if self.on_card:
            torch.cuda.synchronize(self.device)
        for table in (self._graphs, self._logits, self._own_logits, self._carries):
            table.clear()
        self._warm_kinds.clear()

    def __contains__(self, key: tuple) -> bool:
        return key in self._graphs

    def __len__(self) -> int:
        return len(self._graphs)

    # --- buffers --------------------------------------------------------------
    def rows_logits(self, batch: int, vocab: int) -> torch.Tensor:
        """The ``[batch, vocab]`` f32 buffer the forward graphs leave a
        batch's logits in and the draw graphs read."""
        t = self._logits.get((batch, vocab))
        if t is None:
            t = self._logits[(batch, vocab)] = torch.zeros((batch, vocab), dtype=torch.float32, device=self.device)
        return t

    def own_logits(self, name: str, vocab: int) -> torch.Tensor:
        """``[1, vocab]`` apart from the batches' buffers: a mixed step's
        chunk row ("chunk"), a draft model's prefill ("draft")."""
        t = self._own_logits.get((name, vocab))
        if t is None:
            t = self._own_logits[(name, vocab)] = torch.zeros((1, vocab), dtype=torch.float32, device=self.device)
        return t

    # --- capture and replay ---------------------------------------------------
    def graph(self, key: tuple, fields: Sequence[Field], body: Callable[[Dict[str, torch.Tensor]], tuple]) -> _Graph:
        """``key``'s graph, captured on first use: ``body(inputs)`` over the
        static input views, its outputs static. The first capture of each
        kind runs ``body`` once eagerly first on the capture stream (it
        builds and loads the kernels, sets their attributes and makes the
        library handles); its launches count as launches."""
        g = self._graphs.get(key)
        if g is not None:
            return g
        g = _Graph(fields, self.device, body)
        if self.on_card:
            t0 = time.perf_counter()
            cur = torch.cuda.current_stream(self.device)
            s = self._stream
            s.wait_stream(cur)
            with torch.cuda.stream(s):
                kind = key[:2] if key[0] == "prefill" else key[:1]
                if kind not in self._warm_kinds:
                    body(g.inputs)
                    self._warm_kinds.add(kind)
                before = _counts()
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    outputs = body(g.inputs)
                except BaseException:
                    try:
                        graph.capture_end()
                    except Exception:  # noqa: BLE001 — the body's error is the one to raise
                        pass
                    raise
                graph.capture_end()
                after = _counts()
            cur.wait_stream(s)
            # The capture launched nothing: each replay credits what it recorded.
            g.launches = [a - b for a, b in zip(after, before)]
            for (mod, name), b in zip(_COUNTERS, before):
                setattr(mod, name, b)
            g.graph, g.outputs = graph, tuple(outputs)
            self.captures_total += 1
            self.capture_s_total += time.perf_counter() - t0
        self._graphs[key] = g
        return g

    def stage(self, g: _Graph, values: Dict[str, object], device_inputs: Optional[Dict[str, torch.Tensor]] = None
              ) -> None:
        """Fill ``g``'s static inputs: ``values`` (host arrays and scalars)
        into a pinned buffer and ONE copy to the device, then
        ``device_inputs`` (tensors already on the device) over theirs."""
        host = g.host[g.turn]
        if g.events:
            g.events[g.turn].synchronize()  # the copy that last read this buffer is done
        views = g.views[g.turn]
        for name, value in values.items():
            views[name][...] = value
        if host is not g.buf:
            g.buf.copy_(host, non_blocking=True)
            g.events[g.turn].record()
            g.turn ^= 1
        for name, t in (device_inputs or {}).items():
            g.inputs[name].copy_(t)

    def launch(self, g: _Graph) -> tuple:
        """Replay ``g`` (on the CPU: run its body on the inputs) → outputs."""
        if g.graph is None:
            return tuple(g.body(g.inputs))
        g.graph.replay()
        for (mod, name), n in zip(_COUNTERS, g.launches):
            if n:
                setattr(mod, name, getattr(mod, name) + n)
        self.replays_total += 1
        return g.outputs

    def run(self, key: tuple, fields: Sequence[Field], body: Callable, values: Dict[str, object],
            device_inputs: Optional[Dict[str, torch.Tensor]] = None) -> tuple:
        g = self.graph(key, fields, body)
        self.stage(g, values, device_inputs)
        return self.launch(g)

    # --- the scheduler's steps --------------------------------------------------
    def prefill(self, model: str, params, cfg, cache, tokens: np.ndarray, valid_len: int, cache_len: int,
                table: np.ndarray, *, capture_only: bool = False) -> torch.Tensor:
        """``llama.prefill`` of one chunk → its last row's logits ``[1, V]``
        (the target's in the batch-1 logits buffer, a draft's in its own)."""
        S, W = len(tokens), len(table)
        out = self.rows_logits(1, cfg.vocab_size) if model == "target" else self.own_logits(model, cfg.vocab_size)

        def body(x):
            logits, _, _ = llama.prefill(params, cfg, cache.k, cache.v, x["tokens"], x["valid_len"],
                                         x["cache_len"], x["table"])
            out.copy_(logits[None])
            return ()

        fields = [("tokens", (S,), np.int32), ("valid_len", (), np.int32), ("cache_len", (), np.int32),
                  ("table", (W,), np.int32)]
        key = ("prefill", model, S, W)
        if capture_only:
            self.graph(key, fields, body)
        else:
            self.run(key, fields, body, dict(tokens=tokens, valid_len=valid_len, cache_len=cache_len, table=table))
        return out

    def mixed(self, params, cfg, cache, p_tokens: np.ndarray, p_valid: int, p_cache_len: int, p_table: np.ndarray,
              tpa: np.ndarray, tables: np.ndarray, *, capture_only: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """``llama.mixed_step``, the chunk's table and the decode tables at
        one width → (the chunk row's logits ``[1, V]``, the decode rows'
        ``[B, V]``)."""
        S, (B, W) = len(p_tokens), tables.shape
        if len(p_table) != W:
            raise ValueError(f"mixed: the chunk's table is {len(p_table)} wide, the decode tables {W}")
        chunk, rows = self.own_logits("chunk", cfg.vocab_size), self.rows_logits(B, cfg.vocab_size)

        def body(x):
            tpa_d = x["tpa"]
            logits, _, _ = llama.mixed_step(params, cfg, cache.k, cache.v, x["p_tokens"], x["p_valid"],
                                            x["p_cache_len"], x["p_table"], tpa_d[0], tpa_d[1], x["tables"],
                                            tpa_d[2].bool())
            chunk.copy_(logits[:1])
            rows.copy_(logits[1:])
            return ()

        fields = [("p_tokens", (S,), np.int32), ("p_valid", (), np.int32), ("p_cache_len", (), np.int32),
                  ("p_table", (W,), np.int32), ("tpa", (3, B), np.int32), ("tables", (B, W), np.int32)]
        key = ("mixed", S, B, W)
        if capture_only:
            self.graph(key, fields, body)
        else:
            self.run(key, fields, body, dict(p_tokens=p_tokens, p_valid=p_valid, p_cache_len=p_cache_len,
                                             p_table=p_table, tpa=tpa, tables=tables))
        return chunk, rows

    def decode(self, params, cfg, cache, tpa: np.ndarray, tables: np.ndarray, *, capture_only: bool = False
               ) -> torch.Tensor:
        """``llama.decode`` → the batch's logits ``[B, V]``."""
        B, W = tables.shape
        out = self.rows_logits(B, cfg.vocab_size)

        def body(x):
            tpa_d = x["tpa"]
            logits, _, _ = llama.decode(params, cfg, cache.k, cache.v, tpa_d[0], tpa_d[1], x["tables"],
                                        tpa_d[2].bool())
            out.copy_(logits)
            return ()

        fields = [("tpa", (3, B), np.int32), ("tables", (B, W), np.int32)]
        key = ("decode", B, W)
        if capture_only:
            self.graph(key, fields, body)
        else:
            self.run(key, fields, body, dict(tpa=tpa, tables=tables))
        return out

    def decode_sample(self, params, cfg, cache, tpa, tables: np.ndarray, temps: np.ndarray, top_ks: np.ndarray,
                      top_ps: np.ndarray, key: Optional[np.ndarray], *, capture_only: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``llama.decode_sample`` → (sampled ``[B]``, next_tpa ``[3, B]``),
        both int32 on the device; ``tpa`` is host numpy, or the previous
        step's ``next_tpa`` (a device tensor, copied in after the staging);
        ``key`` None for an all-greedy batch (its greedy graph).
        The outputs are the graph's own: the next replay overwrites them."""
        B, W = tables.shape
        greedy = key is None

        def body(x):
            sampled, next_tpa, _, _ = llama.decode_sample(params, cfg, cache.k, cache.v, x["tpa"], x["tables"],
                                                          x.get("temps"), x.get("top_ks"), x.get("top_ps"),
                                                          x.get("key"))
            return sampled, next_tpa

        fields = [("tpa", (3, B), np.int32), ("tables", (B, W), np.int32)] + ([] if greedy else _samp_fields(B, True))
        gkey = ("decode_sample", B, W, greedy)
        if capture_only:
            self.graph(gkey, fields, body)
            return ()
        values = dict(tables=tables)
        if not greedy:
            values.update(temps=temps, top_ks=top_ks, top_ps=top_ps, key=key)
        on_dev = None
        if isinstance(tpa, torch.Tensor):
            on_dev = {"tpa": tpa}
        else:
            values["tpa"] = tpa
        return self.run(gkey, fields, body, values, on_dev)

    def draw(self, logits: torch.Tensor, temps: np.ndarray, top_ks: np.ndarray, top_ps: np.ndarray,
             key: Optional[np.ndarray], row_keys: Optional[np.ndarray] = None, *, capture_only: bool = False
             ) -> torch.Tensor:
        """``sample_batch_device`` over ``logits [B, V]`` (copied into the
        batch's logits buffer unless they are it) → tokens ``[B]`` int32 on
        the device, the graph's own. No key and no row keys: the greedy
        graph."""
        B, V = logits.shape
        src = self.rows_logits(B, V)
        mode = "row_keys" if row_keys is not None else "greedy" if key is None else "key"

        def body(x):
            return (sample_batch_device(src, x.get("temps"), x.get("top_ks"), x.get("top_ps"), x.get("key"),
                                        x.get("row_keys")),)

        fields = _samp_fields(B, mode == "key")
        if mode == "row_keys":
            fields = _samp_fields(B, False) + [("row_keys", (B, 2), np.uint32)]
        gkey = ("draw", B, mode)
        if capture_only:
            self.graph(gkey, fields, body)
            return src
        if logits.data_ptr() != src.data_ptr():
            src.copy_(logits)
        values = {}
        if mode != "greedy":
            values.update(temps=temps, top_ks=top_ks, top_ps=top_ps)
        if mode == "key":
            values["key"] = key
        if mode == "row_keys":
            values["row_keys"] = row_keys
        (tokens,) = self.run(gkey, fields, body, values)
        return tokens

    def decode_multi(self, params, cfg, cache, tpa: np.ndarray, tables: np.ndarray, temps: np.ndarray,
                     top_ks: np.ndarray, top_ps: np.ndarray, keys: Optional[np.ndarray], steps: int, *,
                     model: str = "target", return_logits: bool = False,
                     first_tokens: Optional[torch.Tensor] = None, capture_only: bool = False):
        """A ``steps``-step decode window: one staging, then the step's
        graph (``llama.decode_multi_step``) replayed ``steps`` times →
        tokens ``[steps, B]`` int32 on the device (the window's carry,
        shared by the windows of one (model, steps, B)), with
        ``return_logits`` also each step's logits ``[steps, B, V]`` f32.
        ``keys`` None: an all-greedy window (its greedy graph).
        ``first_tokens`` (a device tensor) replaces ``tpa[0]`` after the
        staging."""
        B, W = tables.shape
        greedy = keys is None
        ckey = (model, steps, B, return_logits)
        carry = self._carries.get(ckey)
        if carry is None:
            carry = self._carries[ckey] = llama.WindowCarry.create(params, cfg, steps, B, self.device,
                                                                   return_logits=return_logits)

        def body(x):
            tpa_d = x["tpa"]
            llama.decode_multi_step(params, cfg, cache.k, cache.v, tpa_d[0], tpa_d[1], x["tables"], tpa_d[2].bool(),
                                    x.get("temps"), x.get("top_ks"), x.get("top_ps"), x.get("keys"), x["step"], carry)
            return ()

        fields = [("tpa", (3, B), np.int32), ("tables", (B, W), np.int32), ("step", (), np.int32)]
        if not greedy:
            fields += _samp_fields(B, False) + [("keys", (steps, 2), np.uint32)]
        g = self.graph(("decode_multi_step", model, steps, B, W, greedy, return_logits), fields, body)
        out = (carry.out, carry.logits) if return_logits else carry.out
        if capture_only:
            return out
        values = dict(tpa=tpa, tables=tables, step=0)
        if not greedy:
            values.update(temps=temps, top_ks=top_ks, top_ps=top_ps, keys=keys)
        self.stage(g, values)
        if first_tokens is not None:
            g.inputs["tpa"][0].copy_(first_tokens)
        for _ in range(steps):
            self.launch(g)
        return out

    def wave(self, params, cfg, cache, tokens: np.ndarray, pos0: np.ndarray, valid: np.ndarray, tables: np.ndarray,
             *, capture_only: bool = False) -> torch.Tensor:
        """``llama.chunk_decode(last_logits=True)`` of a wave → each row's
        last valid logits ``[B, V]``, in the batch's logits buffer (which
        the draw graph reads)."""
        (B, S), W = tokens.shape, tables.shape[1]
        out = self.rows_logits(B, cfg.vocab_size)

        def body(x):
            logits, _, _ = llama.chunk_decode(params, cfg, cache.k, cache.v, x["tokens"], x["pos0"], x["valid"],
                                              x["tables"], last_logits=True)
            out.copy_(logits)
            return ()

        key = ("wave", B, S, W)
        fields = _chunk_fields(B, S, W)
        if capture_only:
            self.graph(key, fields, body)
        else:
            self.run(key, fields, body, dict(tokens=tokens, pos0=pos0, valid=valid, tables=tables))
        return out

    def spec_draft(self, params, cfg, cache, tokens: np.ndarray, pos0: np.ndarray, valid: np.ndarray,
                   tables: np.ndarray, temps: np.ndarray, top_ks: np.ndarray, top_ps: np.ndarray,
                   key: Optional[np.ndarray], gamma: int, *, capture_only: bool = False) -> tuple:
        """A spec round's draft chunk pass: ``llama.chunk_decode`` over each
        row's unconsumed tokens, its last valid position's logits and the
        first proposal drawn from them (``key`` None: argmax) → (proposal
        ``[B]`` int32, logits ``[B, V]`` f32), the graph's own."""
        (B, S), W = tokens.shape, tables.shape[1]
        greedy = key is None

        def body(x):
            last, _, _ = llama.chunk_decode(params, cfg, cache.k, cache.v, x["tokens"], x["pos0"], x["valid"],
                                            x["tables"], last_logits=True)
            return sample_batch_device(last, x.get("temps"), x.get("top_ks"), x.get("top_ps"), x.get("key")), last

        gkey = ("spec_draft", gamma, B, W, greedy)
        fields = _chunk_fields(B, S, W) + ([] if greedy else _samp_fields(B, True))
        if capture_only:
            self.graph(gkey, fields, body)
            return ()
        values = dict(tokens=tokens, pos0=pos0, valid=valid, tables=tables)
        if not greedy:
            values.update(temps=temps, top_ks=top_ks, top_ps=top_ps, key=key)
        return self.run(gkey, fields, body, values)

    def spec_target(self, params, cfg, cache, tokens: np.ndarray, pos0: np.ndarray, valid: np.ndarray,
                    tables: np.ndarray, gamma: int, *, capture_only: bool = False) -> Optional[torch.Tensor]:
        """A spec round's target verify: ``llama.chunk_decode(all_logits=
        True)`` of ``[last ; proposals]`` → logits ``[B, γ+1, V]`` f32, the
        graph's own."""
        (B, S), W = tokens.shape, tables.shape[1]

        def body(x):
            logits, _, _ = llama.chunk_decode(params, cfg, cache.k, cache.v, x["tokens"], x["pos0"], x["valid"],
                                              x["tables"], all_logits=True)
            return (logits,)

        gkey = ("spec_target", gamma, B, W)
        fields = _chunk_fields(B, S, W)
        if capture_only:
            self.graph(gkey, fields, body)
            return None
        return self.run(gkey, fields, body, dict(tokens=tokens, pos0=pos0, valid=valid, tables=tables))[0]


def _chunk_fields(B: int, S: int, W: int) -> List[Field]:
    """A ``chunk_decode`` batch's inputs: tokens, first positions, valid
    counts and block tables."""
    return [("tokens", (B, S), np.int32), ("pos0", (B,), np.int32), ("valid", (B,), np.int32),
            ("tables", (B, W), np.int32)]
