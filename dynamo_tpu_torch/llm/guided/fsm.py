"""Character DFA → token-level FSM against a served vocabulary (the JAX
package's ``llm/guided/fsm.py``, copied: the same tables, bit for bit).

For every (DFA state, vocab token) pair, walk the token's character string
through the DFA once at compile time. The result is two dense tables:

- ``next_state`` ``[S, V] int32`` — landing state (-1 = the token would make
  the string unmatchable);
- ``allow_words`` ``[S, ceil(V/32)] uint32`` — the same information as a
  packed bitmask, the shape the device mask pool uploads (32 tokens per
  word keeps a 128k vocab row at 4 KB).

EOS tokens are allowed exactly in accepting states; tokens that decode to
the empty string (or contain characters outside the grammar alphabet) are
never allowed — an empty token makes no FSM progress and would loop forever.
The walk is trie-structured (shared token prefixes walk once per state), so
compile cost is O(states × trie nodes), not O(states × vocab × token len).

Compiled FSMs are LRU-cached by (pattern, tokenizer), so repeated schemas —
the overwhelmingly common case for tool/extraction traffic — compile once.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, List, Sequence, Tuple

import numpy as np

from dynamo_tpu_torch.llm.guided.grammar import ALPHASET, CharDFA


class TokenFSM:
    __slots__ = (
        "num_states",
        "vocab_size",
        "next_state",
        "allow_words",
        "accepting",
        "accept_only",
        "eos_ids",
        "pattern",
        "compile_s",
    )

    def __init__(
        self,
        num_states: int,
        vocab_size: int,
        next_state: np.ndarray,
        allow_words: np.ndarray,
        accepting: np.ndarray,
        accept_only: np.ndarray,
        eos_ids: frozenset,
        pattern: str,
        compile_s: float,
    ):
        self.num_states = num_states
        self.vocab_size = vocab_size
        self.next_state = next_state
        self.allow_words = allow_words
        self.accepting = accepting
        self.accept_only = accept_only
        self.eos_ids = eos_ids
        self.pattern = pattern
        self.compile_s = compile_s

    @property
    def mask_words(self) -> int:
        return self.allow_words.shape[1]

    def allows(self, state: int, token: int) -> bool:
        if not (0 <= state < self.num_states and 0 <= token < self.vocab_size):
            return False
        return bool((self.allow_words[state, token >> 5] >> np.uint32(token & 31)) & 1)


def _build_trie(token_strs: Sequence[str]) -> dict:
    """Char trie over token strings; terminal token ids under the None key.
    Tokens with empty text or out-of-alphabet characters are dropped (they
    can never legally advance the FSM)."""
    root: dict = {}
    for tid, s in enumerate(token_strs):
        if not s or any(c not in ALPHASET for c in s):
            continue
        node = root
        for c in s:
            node = node.setdefault(c, {})
        node.setdefault(None, []).append(tid)
    return root


def compile_token_fsm(
    dfa: CharDFA,
    token_strs: Sequence[str],
    eos_ids: Sequence[int] = (),
) -> TokenFSM:
    t0 = time.perf_counter()
    S = dfa.num_states
    V = len(token_strs)
    # Tokens with the same text have the same column (501 ids share each
    # byte under the byte tokenizer at a 128k vocabulary): walk each
    # distinct text once, then copy its column to every id that has it.
    # The tables equal the JAX package's walk over every id. The rest is
    # whole-array numpy work, most of it with the GIL released, so a
    # compile in a worker thread leaves the step loop running.
    index: dict = {}
    inverse = np.fromiter((index.setdefault(t, len(index)) for t in token_strs), dtype=np.intp, count=V)
    trie = _build_trie(list(index))
    rows: List[int] = []
    cols: List[int] = []
    vals: List[int] = []
    for s in range(S):
        # Iterative DFS: (trie node, dfa state after consuming the prefix).
        stack: List[Tuple[dict, int]] = [(trie, s)]
        while stack:
            node, st = stack.pop()
            row = dfa.transitions[st]
            for c, child in node.items():
                if c is None:
                    rows.append(s)
                    cols.append(child[0])  # type: ignore[index]  # texts are distinct: one per terminal
                    vals.append(st)
                    continue
                nxt = row.get(c, -1)
                if nxt >= 0:
                    stack.append((child, nxt))
    distinct = np.full((S, len(index)), -1, dtype=np.int32)
    distinct[rows, cols] = vals
    next_state = np.take(distinct, inverse, axis=1)
    accepting = np.asarray(dfa.accepting, dtype=bool)
    eos = frozenset(int(e) for e in eos_ids if 0 <= int(e) < V)

    allow = next_state >= 0
    for e in eos:
        allow[:, e] = accepting
        next_state[:, e] = np.where(accepting, np.arange(S, dtype=np.int32), -1)

    # Bit j of word w is token 32 w + j: little-endian bit order packs each
    # byte from its lowest bit, and four bytes read as one little-endian word.
    words = (V + 31) // 32
    packed = np.zeros((S, words * 4), dtype=np.uint8)
    packed[:, : (V + 7) // 8] = np.packbits(allow, axis=1, bitorder="little")
    allow_words = packed.view("<u4").astype(np.uint32)

    non_eos = allow.copy()
    for e in eos:
        non_eos[:, e] = False
    accept_only = accepting & ~non_eos.any(axis=1)

    return TokenFSM(
        num_states=S,
        vocab_size=V,
        next_state=next_state,
        allow_words=allow_words,
        accepting=accepting,
        accept_only=accept_only,
        eos_ids=eos,
        pattern=dfa.pattern,
        compile_s=time.perf_counter() - t0,
    )


class FsmCache:
    """LRU of compiled token FSMs keyed by (pattern, tokenizer identity)."""

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        self._d: "OrderedDict[tuple, TokenFSM]" = OrderedDict()

    def get(self, key: tuple, builder: Callable[[], TokenFSM]) -> Tuple[TokenFSM, bool]:
        """Returns (fsm, was_cached)."""
        fsm = self._d.get(key)
        if fsm is not None:
            self._d.move_to_end(key)
            return fsm, True
        fsm = builder()
        self._d[key] = fsm
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)
        return fsm, False

    def __len__(self) -> int:
        return len(self._d)
