"""Tokenizer abstraction + incremental detokenization.

- :class:`HFTokenizer` — a local ``tokenizer.json`` (and the
  ``tokenizer_config.json`` beside it) through the port's own reader,
  ``llm/tokenizer_json.py``: the JAX package's ``HFTokenizer`` API and
  semantics with no ``tokenizers`` wheel.
- :class:`ByteTokenizer` — UTF-8 byte-level tokens (vocab 256), the JAX
  package's hermetic tokenizer, so the serving stack runs with no
  tokenizer files.
- :class:`DecodeStream` — incremental detokenization with the prefix-diff
  technique: hold back output while the decoded tail ends in an incomplete
  UTF-8 sequence (U+FFFD).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Protocol, Sequence

from dynamo_tpu_torch.llm.tokenizer_json import TokenizerJson


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


class HFTokenizer:
    """A ``tokenizer.json`` file, or a directory holding one. ``encode``
    adds no special tokens; ``decode`` skips the special added tokens. The
    chat template, the BOS and EOS tokens and the EOS id come from the
    ``tokenizer_config.json`` beside it, where there is one."""

    def __init__(self, path: str):
        tokenizer_file = path if path.endswith(".json") else os.path.join(path, "tokenizer.json")
        self._tok = TokenizerJson.from_file(tokenizer_file)
        self._eos_ids: List[int] = []
        self.chat_template: Optional[str] = None
        self.bos_token: Optional[str] = None
        self.eos_token: Optional[str] = None
        cfg_path = os.path.join(os.path.dirname(tokenizer_file), "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            self.chat_template = cfg.get("chat_template")
            for key in ("eos_token", "bos_token"):
                tok = cfg.get(key)
                if isinstance(tok, dict):
                    tok = tok.get("content")
                setattr(self, key, tok)
                if key == "eos_token" and tok:
                    tid = self._tok.token_to_id(tok)
                    if tid is not None:
                        self._eos_ids.append(tid)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tok.token_to_id(token)

    @property
    def eos_token_ids(self) -> List[int]:
        return self._eos_ids

    @property
    def vocab_size(self) -> int:
        return self._tok.vocab_size


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
    """A ``tokenizer.json`` file or a directory holding one → HFTokenizer;
    no path → ByteTokenizer. A path with no ``tokenizer.json`` raises
    ``FileNotFoundError`` (the JAX package serves bytes there, which hides
    a wrong path)."""
    if path_or_name:
        candidate = path_or_name if path_or_name.endswith(".json") else os.path.join(path_or_name, "tokenizer.json")
        if not os.path.exists(candidate):
            raise FileNotFoundError(f"tokenizer {path_or_name!r}: no {candidate}")
        return HFTokenizer(path_or_name)
    return ByteTokenizer()
