"""Device-side application of token FSMs: the mask pool + per-sequence state.

The JAX package's ``llm/guided/processor.py`` with the pools as torch
tensors on an explicit device. All compiled grammars share ONE mask pool,
a ``[capacity, ceil(V/32)]`` table of packed allow bits (uint32 bits held
as int32, torch's 32-bit integer) where each grammar occupies a contiguous
block of rows (one row per FSM state) from its base row. Row 0 is the
allow-everything row, so unguided rows in a mixed batch map to row 0 and
pass through the masked sampler unchanged. Beside it, the next-row pool
``[capacity, V]`` int32: ``next[row, token]`` is the row the FSM lands on
after ``token``, which the fused decode window reads to advance guided
rows on the device between steps.

The capacity grows by powers of two from ``POOL_ROWS``. Both tables stay
on the device: registering a grammar writes only its own rows (a new table
is allocated, and the used rows copied, only when the capacity doubles),
so a new schema costs its rows' upload, not a rebuild of the whole
``[capacity, V]`` table on the host. Until rows are freed the tables hold,
element for element, what the JAX package's ``device()`` and
``next_device()`` build. Unlike the JAX pool, a grammar's rows count their
users (the live cursors): when a new grammar does not fit, the rows of
grammars nobody holds are taken back before the capacity doubles, so
traffic whose schema changes from request to request does not grow the
pool without end.

Per step the scheduler packs one i32 row id per batch row (``pool_base +
fsm_state``); the sampler gathers the mask row and puts ``-inf`` on the
disallowed logits (engine/sampling.py ``apply_token_masks``). The FSM
advance on the host is an O(1) table lookup on the token the scheduler
already reads back.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dynamo_tpu_torch.llm.guided.fsm import FsmCache, TokenFSM, compile_token_fsm
from dynamo_tpu_torch.llm.guided.grammar import compile_regex, spec_to_pattern

logger = logging.getLogger(__name__)

# The mask pool's first capacity in FSM rows (the JAX package's
# ``SchedulerConfig.guided_pool_rows`` default).
POOL_ROWS = 1024


class GuidedMaskPool:
    """Shared device mask pool: one row per FSM state across all live
    grammars, row 0 = allow-all (the unguided pass-through), and the
    next-row pool beside it."""

    def __init__(self, vocab_size: int, min_rows: int = POOL_ROWS, device="cpu"):
        self.vocab_size = vocab_size
        self.words = (vocab_size + 31) // 32
        self.capacity = max(int(min_rows), 2)
        self.dev = torch.device(device)
        self._used = 1  # rows below this are row 0, a grammar's or free
        self._free: List[List[int]] = []  # [base, rows] extents below _used, by base
        # id(fsm) -> [fsm, base row, users]; the entry pins the fsm, so its
        # id() stays its own while the rows are.
        self._grammars: Dict[int, list] = {}
        # Allocated at first use, at the capacity: [capacity, words] int32
        # allow bits and [capacity, V] int32 next rows.
        self._mask: Optional[torch.Tensor] = None
        self._next: Optional[torch.Tensor] = None

    def _allow_all_row(self) -> np.ndarray:
        row = np.full((self.words,), 0xFFFFFFFF, dtype=np.uint32)
        tail = self.vocab_size & 31
        if tail:
            row[-1] = np.uint32((1 << tail) - 1)  # pad bits stay 0
        return row

    def _allocate(self, capacity: int) -> None:
        """Device tables at ``capacity`` rows, the used rows carried over
        (row 0 the allow-all row on first allocation). ValueError, and the
        tables as they were, when the device cannot hold them."""
        try:
            mask = torch.zeros((capacity, self.words), dtype=torch.int32, device=self.dev)
            nxt = torch.zeros((capacity, self.vocab_size), dtype=torch.int32, device=self.dev)
        except torch.cuda.OutOfMemoryError as e:
            raise ValueError(f"guided mask pool: no device memory for {capacity} rows") from e
        if self._mask is None:
            mask[0] = torch.from_numpy(self._allow_all_row().view(np.int32))
        else:
            mask[: self._used] = self._mask[: self._used]
            nxt[: self._used] = self._next[: self._used]
        self._mask, self._next, self.capacity = mask, nxt, capacity

    def _take(self, rows: int) -> Optional[int]:
        """First fit among the free extents, else the rows past the used
        ones; None when neither has room."""
        for ext in self._free:
            if ext[1] >= rows:
                base = ext[0]
                ext[0] += rows
                ext[1] -= rows
                if not ext[1]:
                    self._free.remove(ext)
                return base
        if self._used + rows <= self.capacity:
            self._used += rows
            return self._used - rows
        return None

    def _reclaim(self) -> bool:
        """Free the rows of every grammar no cursor holds (a cached FSM that
        comes back is written again); True if any were freed."""
        idle = [k for k, (_, _, users) in self._grammars.items() if not users]
        for k in idle:
            fsm, base, _ = self._grammars.pop(k)
            self._free.append([base, fsm.num_states])
        self._free.sort()
        merged: List[List[int]] = []
        for base, rows in self._free:
            if merged and merged[-1][0] + merged[-1][1] == base:
                merged[-1][1] += rows
            else:
                merged.append([base, rows])
        if merged and merged[-1][0] + merged[-1][1] == self._used:
            self._used = merged.pop()[0]
        self._free = merged
        return bool(idle)

    def register(self, fsm: TokenFSM) -> int:
        """Ensure ``fsm``'s rows are in the pool and count one more user of
        them (``release`` drops it); returns its base row. A grammar that
        does not fit takes the rows of grammars no user holds; past those
        the capacity doubles. ValueError when the device cannot hold it."""
        entry = self._grammars.get(id(fsm))
        if entry is None:
            if self._mask is None:
                self._allocate(self.capacity)
            S = fsm.num_states
            base = self._take(S)
            if base is None and self._reclaim():
                base = self._take(S)
            if base is None:
                cap = self.capacity
                while cap < self._used + S:
                    cap *= 2
                logger.warning("guided mask pool grew %d -> %d rows", self.capacity, cap)
                self._allocate(cap)
                base = self._take(S)
            try:
                self._write(fsm, base)
            except torch.cuda.OutOfMemoryError as e:
                self._free.append([base, S])
                self._reclaim()
                raise ValueError(f"guided mask pool: no device memory to write {S} rows") from e
            entry = self._grammars[id(fsm)] = [fsm, base, 0]
        entry[2] += 1
        return entry[1]

    def release(self, fsm: TokenFSM) -> None:
        """One user of ``fsm``'s rows less (a finished or aborted request)."""
        entry = self._grammars.get(id(fsm))
        if entry is not None and entry[2]:
            entry[2] -= 1

    def _write(self, fsm: TokenFSM, base: int) -> None:
        """``fsm``'s allow bits and next rows at ``base``: next[row, token]
        = base + next_state, row 0 where the transition is dead (-1)."""
        S, V = fsm.next_state.shape
        self._mask[base : base + S] = torch.from_numpy(fsm.allow_words.view(np.int32)).to(self.dev)
        nxt = self._next[base : base + S, :V]
        nxt.copy_(torch.from_numpy(fsm.next_state))
        nxt.add_(base)
        nxt.masked_fill_(nxt < base, 0)  # a dead -1 is now base - 1

    def rows_in_use(self) -> int:
        """Rows that registered grammars hold, row 0 included."""
        return 1 + sum(fsm.num_states for fsm, _, _ in self._grammars.values())

    def device(self) -> torch.Tensor:
        """The mask pool ``[capacity, ceil(V/32)]`` int32 on the device."""
        if self._mask is None:
            self._allocate(self.capacity)
        return self._mask

    def next_pool_bytes(self) -> int:
        """Size of the ``[capacity, V] int32`` next-row pool."""
        return self.capacity * self.vocab_size * 4

    def next_device(self) -> torch.Tensor:
        """The next-row pool ``[capacity, V]`` int32 on the device:
        ``next[row, token]`` is the mask-pool row the FSM lands on after
        emitting ``token`` from ``row``. Dead transitions and row 0 map to
        row 0 (allow-all); the host replay stops the sequence before a
        dead or EOS transition would ever be sampled against."""
        if self._next is None:
            self._allocate(self.capacity)
        return self._next


class GuidedState:
    """Per-sequence FSM cursor, advanced host-side from each sampled token."""

    __slots__ = ("fsm", "pool_base", "state", "finished", "from_cache")

    def __init__(self, fsm: TokenFSM, pool_base: int, from_cache: bool = False):
        self.fsm = fsm
        self.pool_base = pool_base
        self.state = 0
        self.finished = False
        self.from_cache = from_cache

    @property
    def row_id(self) -> int:
        """Mask-pool row for the current state (allow-all row once done —
        the sequence stops before it would sample again)."""
        if self.state < 0 or self.finished:
            return 0
        return self.pool_base + self.state

    @property
    def exhausted(self) -> bool:
        """The grammar is complete (or unrecoverable): force-finish with
        ``finish_reason="stop"`` — the FSM accepts and only EOS remains."""
        if self.finished or self.state < 0:
            return True
        return bool(self.fsm.accept_only[self.state])

    def advance(self, token: int) -> None:
        if self.finished:
            return
        if token in self.fsm.eos_ids:
            self.finished = True
            return
        if 0 <= token < self.fsm.vocab_size and self.state >= 0:
            self.state = int(self.fsm.next_state[self.state, token])
        else:
            self.state = -1
        if self.state < 0:
            # Only possible when something outside the mask forced a token:
            # stop rather than emit unconstrained text under a
            # structured-output contract.
            self.finished = True


class GuidedDecoder:
    """Scheduler-owned facade: spec → cached token FSM → pool registration.
    ``stats()`` gives the request and grammar-compile counters.

    ``prepare`` (the compile) touches no device state and may run on any
    thread; ``open`` (the pool registration) and ``close`` run on the
    scheduler's."""

    def __init__(
        self,
        tokenizer,
        *,
        eos_ids: Sequence[int] = (),
        vocab_size: Optional[int] = None,
        pool_rows: int = POOL_ROWS,
        cache_size: int = 64,
        device="cpu",
    ):
        self.tokenizer = tokenizer
        self.vocab_size = int(vocab_size or tokenizer.vocab_size)
        self.eos_ids = list(eos_ids) or list(getattr(tokenizer, "eos_token_ids", []) or [])
        self.pool = GuidedMaskPool(self.vocab_size, min_rows=pool_rows, device=device)
        self.cache = FsmCache(maxsize=cache_size)
        self._compile_lock = threading.Lock()  # the cache, the token strings and the compile counters
        self._token_strs: Optional[List[str]] = None
        self.requests_total = 0
        self.compiles_total = 0
        self.compile_seconds_total = 0.0

    def _token_strings(self) -> List[str]:
        if self._token_strs is None:
            strs = []
            for tid in range(self.vocab_size):
                try:
                    strs.append(self.tokenizer.decode([tid]))
                except Exception:  # noqa: BLE001 — out-of-vocab ids stay unusable
                    strs.append("")
            self._token_strs = strs
        return self._token_strs

    def prepare(self, spec: dict) -> GuidedState:
        """Compile (or fetch) the spec's token FSM → a fresh cursor, not in
        the pool until ``open``. Raises ValueError (GrammarError) on a bad
        spec — the frontend validates first, so this is the defense line
        for raw engine API users."""
        pattern = spec_to_pattern(spec)
        key = (pattern, id(self.tokenizer), self.vocab_size)

        def build() -> TokenFSM:
            t0 = time.perf_counter()
            fsm = compile_token_fsm(compile_regex(pattern), self._token_strings(), self.eos_ids)
            self.compiles_total += 1
            self.compile_seconds_total += time.perf_counter() - t0
            return fsm

        with self._compile_lock:
            fsm, cached = self.cache.get(key, build)
        return GuidedState(fsm, 0, from_cache=cached)

    def open(self, spec) -> GuidedState:
        """A cursor whose grammar's rows are in the pool, from a spec or
        from the cursor ``prepare`` made of one. ValueError on a bad spec
        or when the device cannot hold the grammar's rows."""
        state = spec if isinstance(spec, GuidedState) else self.prepare(spec)
        state.pool_base = self.pool.register(state.fsm)
        self.requests_total += 1
        return state

    def close(self, state: GuidedState) -> None:
        """The cursor's request is done: its grammar's rows lose a user."""
        self.pool.release(state.fsm)

    def stats(self) -> dict:
        return {
            "guided_requests_total": self.requests_total,
            "guided_grammar_compiles_total": self.compiles_total,
            "guided_grammar_compile_seconds_total": round(self.compile_seconds_total, 6),
        }
