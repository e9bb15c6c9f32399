"""Tokenizer abstraction + incremental detokenization.

- :class:`ByteTokenizer` — UTF-8 byte-level tokens (vocab 256), the JAX
  package's hermetic tokenizer, so the serving stack runs with no
  tokenizer files.
- :class:`DecodeStream` — incremental detokenization with the prefix-diff
  technique: hold back output while the decoded tail ends in an incomplete
  UTF-8 sequence (U+FFFD).

The JAX package also wraps a local ``tokenizer.json`` through the
``tokenizers`` wheel; that wheel is not assumed here, so loading a real
tokenizer waits for a ``tokenizer.json`` reader (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence


class Tokenizer(Protocol):
    def encode(self, text: str) -> List[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    @property
    def eos_token_ids(self) -> List[int]: ...

    @property
    def vocab_size(self) -> int: ...


class ByteTokenizer:
    """UTF-8 bytes as tokens; id 0 reserved as EOS/pad."""

    EOS = 0

    def encode(self, text: str) -> List[int]:
        return [b if b != 0 else 1 for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i & 0xFF for i in ids if i != self.EOS).decode("utf-8", errors="replace")

    @property
    def eos_token_ids(self) -> List[int]:
        return [self.EOS]

    @property
    def vocab_size(self) -> int:
        return 256


class DecodeStream:
    """Incremental detokenizer: feed token ids, get text deltas."""

    def __init__(self, tokenizer: Tokenizer, skip_token_ids: Optional[Sequence[int]] = None):
        self.tokenizer = tokenizer
        self.ids: List[int] = []
        self._emitted = 0  # chars already emitted
        self._skip = set(skip_token_ids or [])

    def step(self, token_ids: Sequence[int]) -> str:
        self.ids.extend(t for t in token_ids if t not in self._skip)
        text = self.tokenizer.decode(self.ids)
        # Hold back while the tail is an incomplete sequence.
        while text.endswith("�") and len(text) > self._emitted:
            text = text[:-1]
        delta = text[self._emitted :]
        self._emitted += len(delta)
        return delta

    def flush(self) -> str:
        text = self.tokenizer.decode(self.ids)
        delta = text[self._emitted :]
        self._emitted = len(text)
        return delta


def load_tokenizer(path_or_name: Optional[str] = None) -> Tokenizer:
    """The serving tokenizer. Only the byte-level tokenizer is ported;
    a path raises rather than being silently ignored."""
    if path_or_name:
        raise NotImplementedError(
            f"loading tokenizer {path_or_name!r} is not ported yet (ROADMAP Queue 1 item 12: "
            "checkpoint and tokenizer loading); omit it to serve with ByteTokenizer"
        )
    return ByteTokenizer()
