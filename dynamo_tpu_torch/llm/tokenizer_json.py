"""A reader of Hugging Face ``tokenizer.json`` files that needs no wheel.

It encodes and decodes exactly as the ``tokenizers`` wheel does for the
components that the published tokenizers of the repo's Llama-family presets
use, and raises ``ValueError`` naming any other component:

- model ``BPE`` (``ignore_merges``, ``byte_fallback``, ``unk_token`` with
  ``fuse_unk``; no dropout, subword prefix or word suffix), merged with the
  wheel's algorithm (lowest rank first, the leftmost on a tie) and a cache
  of merged words;
- normalizers ``NFC``, ``Prepend``, ``Replace`` (a string pattern) and
  ``Sequence``;
- pre-tokenizers ``Split`` (a regex or string pattern, ``Isolated``, not
  inverted), ``ByteLevel`` (no prefix space, no regex of its own),
  ``Metaspace`` and ``Sequence``;
- decoders ``ByteLevel``, ``ByteFallback``, ``Fuse``, ``Strip``,
  ``Replace``, ``Metaspace`` and ``Sequence``;
- post-processors ``ByteLevel``, ``TemplateProcessing`` and ``Sequence``,
  which ``encode`` never applies (it adds no special tokens);
- ``added_tokens``, split out of the text before the model sees it, with
  ``special``, ``lstrip``, ``rstrip``, ``single_word`` and ``normalized``.

Llama-3 (``ignore_merges``, a ``Split`` of its pattern and ``ByteLevel``),
Qwen2.5 (``NFC`` and its own pattern) and Mistral (``byte_fallback`` with
``Prepend``/``Replace`` or ``Metaspace``) are covered. The patterns' regex
is the wheel's Oniguruma syntax; ``\\p{L}``, ``\\p{N}``, ``\\s`` and ``\\S``
are rewritten into explicit classes for the standard ``re`` module:
letters and numbers by ``unicodedata.category`` plus those Unicode 16.0
assigned (Oniguruma's tables; Python 3.12's are 15.0), and ``\\s`` as the
``White_Space`` property (Python's ``\\s`` also takes U+001C–U+001F). Any
other ``\\p``, ``\\w``, ``\\d`` or ``\\b`` escape raises. NFC is
``unicodedata``'s, with the 108 combining marks that the wheel's older
tables lack kept as starters.
"""

from __future__ import annotations

import heapq
import json
import re
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Character classes of the wheel's regex engine
# ---------------------------------------------------------------------------

# Letters and numbers assigned in Unicode 16.0 (unassigned in the 15.0 tables
# of Python 3.12's unicodedata), as inclusive code point ranges.
_LETTERS_16 = ((0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3), (0x10D4A, 0x10D65),
               (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4), (0x11380, 0x11389), (0x1138B, 0x1138B),
               (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113B7), (0x113D1, 0x113D1),
               (0x113D3, 0x113D3), (0x11BC0, 0x11BE0), (0x13460, 0x143FA), (0x16100, 0x1611D),
               (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF), (0x1E5D0, 0x1E5ED), (0x1E5F0, 0x1E5F0),
               (0x2EBF0, 0x2EE5D))
_NUMBERS_16 = ((0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9), (0x16130, 0x16139),
               (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA))
# Combining marks that the wheel's NFC tables (older than Python 3.12's
# Unicode 15.0) give no combining class: there they are starters, which
# canonical reordering does not cross.
_NFC_STARTERS = ((0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8D3), (0x9FE, 0x9FE), (0xC3C, 0xC3C), (0xD3B, 0xD3C),
                 (0xEBA, 0xEBA), (0x1715, 0x1715), (0x1ABF, 0x1ACE), (0x1DF6, 0x1DFA), (0xA82C, 0xA82C),
                 (0x10D24, 0x10D27), (0x10EAB, 0x10EAC), (0x10EFD, 0x10EFF), (0x10F46, 0x10F50), (0x10F82, 0x10F85),
                 (0x11070, 0x11070), (0x1133B, 0x1133B), (0x1145E, 0x1145E), (0x11839, 0x1183A), (0x1193D, 0x1193E),
                 (0x11943, 0x11943), (0x119E0, 0x119E0), (0x11A34, 0x11A34), (0x11A47, 0x11A47), (0x11A99, 0x11A99),
                 (0x11D42, 0x11D42), (0x11D44, 0x11D45), (0x11D97, 0x11D97), (0x11F41, 0x11F42), (0x16FF0, 0x16FF1),
                 (0x1E08F, 0x1E08F), (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF))
_NFC_SPLIT = re.compile("([" + "".join(f"{re.escape(chr(a))}-{re.escape(chr(b))}" for a, b in _NFC_STARTERS) + "])")
# The White_Space property.
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680), (0x2000, 0x200A),
                (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))

_CLASSES: Dict[str, str] = {}


def _ranges_text(ranges) -> str:
    out = []
    for a, b in ranges:
        out.append(re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}")
    return "".join(out)


def _class_body(name: str) -> str:
    """The inside of a ``re`` character class for ``\\p{L}``, ``\\p{N}`` or
    ``\\s``, built once."""
    if name not in _CLASSES:
        if name == "s":
            _CLASSES[name] = _ranges_text(_WHITE_SPACE)
        else:
            extra = _LETTERS_16 if name == "L" else _NUMBERS_16
            ranges: List[List[int]] = []
            for cp in range(0x110000):
                if unicodedata.category(chr(cp))[0] == name or any(a <= cp <= b for a, b in extra):
                    if ranges and ranges[-1][1] == cp - 1:
                        ranges[-1][1] = cp
                    else:
                        ranges.append([cp, cp])
            _CLASSES[name] = _ranges_text(ranges)
    return _CLASSES[name]


def translate_pattern(pattern: str) -> str:
    """An Oniguruma pattern of the kind pre-tokenizers use → the same
    pattern for ``re``, with ``\\p{L}``, ``\\p{N}``, ``\\s`` and ``\\S``
    spelled out as classes."""
    out, i, in_class = [], 0, False
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\":
            nxt = pattern[i + 1:i + 2]
            if nxt in ("p", "P"):
                m = re.match(r"\\[pP]\{(\w+)\}", pattern[i:])
                if not m or m.group(1) not in ("L", "N") or nxt == "P":
                    raise ValueError(f"tokenizer.json: unsupported regex escape {pattern[i:i + 8]!r} in {pattern!r}")
                body = _class_body(m.group(1))
                out.append(body if in_class else f"[{body}]")
                i += len(m.group(0))
                continue
            if nxt == "s":
                out.append(_class_body("s") if in_class else f"[{_class_body('s')}]")
            elif nxt == "S":
                if in_class:
                    raise ValueError(f"tokenizer.json: unsupported regex escape '\\S' inside a class in {pattern!r}")
                out.append(f"[^{_class_body('s')}]")
            elif nxt in ("w", "W", "d", "D", "b", "B", "h", "H", "X", "R", "k", "g"):
                raise ValueError(f"tokenizer.json: unsupported regex escape '\\{nxt}' in {pattern!r}")
            else:
                out.append(pattern[i:i + 2])
            i += 2
            continue
        if ch == "[" and not in_class:
            in_class = True
            out.append(ch)
            # A leading '^' or ']' belongs to the class syntax, not its end.
            if pattern[i + 1:i + 2] == "^":
                out.append("^")
                i += 1
            i += 1
            continue
        if ch == "]" and in_class:
            in_class = False
        elif ch == "[" and in_class:
            raise ValueError(f"tokenizer.json: unsupported nested class in {pattern!r}")
        out.append(ch)
        i += 1
    return "".join(out)


# ---------------------------------------------------------------------------
# Byte-level alphabet (GPT-2's bytes_to_unicode)
# ---------------------------------------------------------------------------


def _bytes_to_unicode() -> Dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_TO_CHAR = _bytes_to_unicode()
CHAR_TO_BYTE = {c: b for b, c in BYTE_TO_CHAR.items()}
_LATIN1_TO_BYTELEVEL = {b: c for b, c in BYTE_TO_CHAR.items()}  # str.translate table over latin-1 text


def bytelevel(text: str) -> str:
    return text.encode("utf-8").decode("latin-1").translate(_LATIN1_TO_BYTELEVEL)


# ---------------------------------------------------------------------------
# Components
# ---------------------------------------------------------------------------


def _need(spec: dict, keys: Sequence[str], what: str) -> None:
    for k in keys:
        if k not in spec:
            raise ValueError(f"tokenizer.json: {what} lacks {k!r}")


def _string_pattern(spec: dict, what: str) -> Tuple[str, bool]:
    """(pattern, is_regex) of a ``{"String": ..}`` / ``{"Regex": ..}``."""
    pat = spec.get("pattern")
    if isinstance(pat, dict) and len(pat) == 1:
        (kind, value), = pat.items()
        if kind in ("String", "Regex"):
            return value, kind == "Regex"
    raise ValueError(f"tokenizer.json: {what} has an unsupported pattern {pat!r}")


def build_normalizer(spec: Optional[dict]) -> Optional[Callable[[str], str]]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "NFC":
        # Each mark of _NFC_STARTERS bounds what NFC reorders and composes.
        return lambda s: "".join(p if i % 2 else unicodedata.normalize("NFC", p)
                                 for i, p in enumerate(_NFC_SPLIT.split(s)))
    if kind == "Prepend":
        _need(spec, ["prepend"], "normalizer Prepend")
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        pattern, is_regex = _string_pattern(spec, "normalizer Replace")
        if is_regex:
            raise ValueError("tokenizer.json: unsupported normalizer Replace with a Regex pattern")
        content = spec.get("content", "")
        return lambda s: s.replace(pattern, content)
    if kind == "Sequence":
        steps = [build_normalizer(n) for n in spec.get("normalizers", [])]

        def seq(s: str) -> str:
            for f in steps:
                s = f(s)
            return s

        return seq
    raise ValueError(f"tokenizer.json: unsupported normalizer {kind!r}")


# A pre-tokenizer maps pieces (text, starts at offset 0 of the input) to pieces.
Piece = Tuple[str, bool]


def _split_isolated(regex: "re.Pattern", text: str, at_start: bool) -> List[Piece]:
    out, pos = [], 0
    for m in regex.finditer(text):
        if m.start() > pos:
            out.append(text[pos:m.start()])
        if m.end() > m.start():
            out.append(m.group(0))
        pos = m.end()
    if pos < len(text):
        out.append(text[pos:])
    return [(p, at_start and i == 0) for i, p in enumerate(out)]


def build_pre_tokenizer(spec: Optional[dict]) -> Callable[[List[Piece]], List[Piece]]:
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [build_pre_tokenizer(p) for p in spec.get("pretokenizers", [])]

        def seq(pieces: List[Piece]) -> List[Piece]:
            for f in steps:
                pieces = f(pieces)
            return pieces

        return seq
    if kind == "Split":
        pattern, is_regex = _string_pattern(spec, "pre-tokenizer Split")
        if spec.get("behavior") != "Isolated":
            raise ValueError(f"tokenizer.json: unsupported pre-tokenizer Split behavior {spec.get('behavior')!r}")
        if spec.get("invert"):
            raise ValueError("tokenizer.json: unsupported pre-tokenizer Split with invert")
        regex = re.compile(translate_pattern(pattern) if is_regex else re.escape(pattern))
        return lambda pieces: [q for text, st in pieces for q in _split_isolated(regex, text, st)]
    if kind == "ByteLevel":
        for key in ("add_prefix_space", "use_regex"):
            if spec.get(key, True):
                raise ValueError(f"tokenizer.json: unsupported pre-tokenizer ByteLevel with {key}")
        return lambda pieces: [(bytelevel(text), st) for text, st in pieces]
    if kind == "Metaspace":
        _need(spec, ["replacement"], "pre-tokenizer Metaspace")
        rep = spec["replacement"]
        scheme = spec.get("prepend_scheme")
        if scheme not in ("always", "first", "never"):
            raise ValueError(f"tokenizer.json: unsupported Metaspace prepend_scheme {scheme!r}")
        split = spec.get("split", True)

        def metaspace(pieces: List[Piece]) -> List[Piece]:
            out = []
            for text, st in pieces:
                text = text.replace(" ", rep)
                if not text.startswith(rep) and (scheme == "always" or (scheme == "first" and st)):
                    text = rep + text
                if not split:
                    out.append((text, st))
                    continue
                # Split on the replacement, each merged with what follows it.
                parts, cur = [], ""
                for ch in text:
                    if ch == rep and cur:
                        parts.append(cur)
                        cur = ""
                    cur += ch
                if cur:
                    parts.append(cur)
                out.extend((p, st and i == 0) for i, p in enumerate(parts))
            return out

        return metaspace
    raise ValueError(f"tokenizer.json: unsupported pre-tokenizer {kind!r}")


def _check_post_processor(spec: Optional[dict]) -> None:
    if spec is None:
        return
    kind = spec.get("type")
    if kind == "Sequence":
        for p in spec.get("processors", []):
            _check_post_processor(p)
    elif kind not in ("ByteLevel", "TemplateProcessing"):
        raise ValueError(f"tokenizer.json: unsupported post-processor {kind!r}")


def _utf8_lossy(data: bytes) -> str:
    return data.decode("utf-8", errors="replace")


def build_decoder(spec: Optional[dict]) -> Callable[[List[str]], List[str]]:
    """A decoder as the wheel's ``decode_chain``: tokens → tokens (joined at
    the end)."""
    if spec is None:
        # The wheel joins the tokens with spaces when there is no decoder.
        return lambda tokens: [" ".join(tokens)]
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [build_decoder(d) for d in spec.get("decoders", [])]

        def seq(tokens: List[str]) -> List[str]:
            for f in steps:
                tokens = f(tokens)
            return tokens

        return seq
    if kind == "ByteLevel":
        def byte_level(tokens: List[str]) -> List[str]:
            out = bytearray()
            for t in tokens:
                try:
                    out.extend(CHAR_TO_BYTE[c] for c in t)
                except KeyError:
                    out.extend(t.encode("utf-8"))
            return [_utf8_lossy(bytes(out))]

        return byte_level
    if kind == "ByteFallback":
        def byte_fallback(tokens: List[str]) -> List[str]:
            out: List[str] = []
            pending = bytearray()

            def flush():
                if pending:
                    try:
                        out.append(bytes(pending).decode("utf-8"))
                    except UnicodeDecodeError:
                        out.extend("\ufffd" for _ in pending)
                    pending.clear()

            for t in tokens:
                if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                    try:
                        pending.append(int(t[3:5], 16))
                        continue
                    except ValueError:
                        pass
                flush()
                out.append(t)
            flush()
            return out

        return byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec.get("content", " "), int(spec.get("start", 0)), int(spec.get("stop", 0))

        def strip(tokens: List[str]) -> List[str]:
            out = []
            for t in tokens:
                a = 0
                while a < min(start, len(t)) and t[a] == content:
                    a += 1
                b = len(t)
                for _ in range(stop):
                    if b > a and t[b - 1] == content:
                        b -= 1
                    else:
                        break
                out.append(t[a:b])
            return out

        return strip
    if kind == "Replace":
        pattern, is_regex = _string_pattern(spec, "decoder Replace")
        if is_regex:
            raise ValueError("tokenizer.json: unsupported decoder Replace with a Regex pattern")
        content = spec.get("content", "")
        return lambda tokens: [t.replace(pattern, content) for t in tokens]
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme not in ("always", "first", "never"):
            raise ValueError(f"tokenizer.json: unsupported Metaspace prepend_scheme {scheme!r}")

        def metaspace(tokens: List[str]) -> List[str]:
            out = []
            for i, t in enumerate(tokens):
                t = t.replace(rep, " ")
                if i == 0 and scheme != "never" and t.startswith(" "):
                    t = t[1:]
                out.append(t)
            return out

        return metaspace
    raise ValueError(f"tokenizer.json: unsupported decoder {kind!r}")


# ---------------------------------------------------------------------------
# Added tokens
# ---------------------------------------------------------------------------


# Word characters of the wheel's single-word test (the regex crate's \w:
# Alphabetic, marks, Nd, Pc and the joiners) beyond the categories below:
# the So letters that are Alphabetic, and the code points Unicode 16.0
# assigned as word characters.
_WORD_EXTRA = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189), (0x200C, 0x200D),
               (0x897, 0x897), (0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3),
               (0x10D40, 0x10D65), (0x10D69, 0x10D6D), (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4), (0x10EFC, 0x10EFC),
               (0x11380, 0x11389), (0x1138B, 0x1138B), (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113C0),
               (0x113C2, 0x113C2), (0x113C5, 0x113C5), (0x113C7, 0x113CA), (0x113CC, 0x113D3), (0x113E1, 0x113E2),
               (0x116D0, 0x116E3), (0x11BC0, 0x11BE0), (0x11BF0, 0x11BF9), (0x11F5A, 0x11F5A), (0x13460, 0x143FA),
               (0x16100, 0x16139), (0x16D40, 0x16D6C), (0x16D70, 0x16D79), (0x18CFF, 0x18CFF), (0x1CCF0, 0x1CCF9),
               (0x1E5D0, 0x1E5FA), (0x2EBF0, 0x2EE5D))


def _is_word_char(c: str) -> bool:
    cat = unicodedata.category(c)
    if cat[0] in "LM" or cat in ("Nd", "Nl", "Pc"):
        return True
    cp = ord(c)
    return any(a <= cp <= b for a, b in _WORD_EXTRA)


def _is_white_space(c: str) -> bool:
    cp = ord(c)
    return any(a <= cp <= b for a, b in _WHITE_SPACE)


def _trie_regex(words: Sequence[str]) -> Optional["re.Pattern"]:
    """A regex that finds the leftmost, then longest, of ``words`` (the
    wheel's Aho-Corasick ``LeftmostLongest``): a trie of alternatives, each
    optional tail greedy, so the longest word wins at a position."""
    if not words:
        return None
    trie: dict = {}
    for w in words:
        node = trie
        for ch in w:
            node = node.setdefault(ch, {})
        node[""] = True

    def emit(node: dict) -> str:
        alts = [re.escape(ch) + emit(child) for ch, child in sorted(node.items()) if ch != ""]
        if not alts:
            return ""
        body = alts[0] if len(alts) == 1 else "(?:" + "|".join(alts) + ")"
        if "" in node:
            return "(?:" + body + ")?"
        return body

    return re.compile(emit(trie))


class AddedTokens:
    """The ``added_tokens`` of a file: ids by content, and the wheel's split
    of a text around them (``AddedVocabulary::find_matches``)."""

    def __init__(self, entries: List[dict]):
        self.by_content: Dict[str, dict] = {}
        self.by_id: Dict[int, str] = {}
        self.special = set()
        for e in entries:
            _need(e, ["id", "content"], "an added token")
            self.by_content[e["content"]] = e
            self.by_id[int(e["id"])] = e["content"]
            if e.get("special"):
                self.special.add(e["content"])
        raw = [c for c, e in self.by_content.items() if not e.get("normalized", not e.get("special", False))]
        norm = [c for c, e in self.by_content.items() if e.get("normalized", not e.get("special", False))]
        self.raw_regex = _trie_regex(raw)
        self.normalized_regex = _trie_regex(norm)

    def split(self, text: str, regex) -> List[Tuple[str, Optional[int], int]]:
        """``text`` → [(piece, added token id or None, start offset)]."""
        if regex is None or not text:
            return [(text, None, 0)]
        out, start_offset = [], 0
        for m in regex.finditer(text):
            start, stop = m.start(), m.end()
            if stop == start:
                continue
            e = self.by_content[m.group(0)]
            if e.get("single_word"):
                start_space = start == 0 or not _is_word_char(text[start - 1])
                stop_space = stop == len(text) or not _is_word_char(text[stop])
                if not (start_space and stop_space):
                    continue
            if e.get("lstrip"):
                newstart = start
                while newstart > 0 and _is_white_space(text[newstart - 1]):
                    newstart -= 1
                start = max(newstart, start_offset)
            if e.get("rstrip"):
                while stop < len(text) and _is_white_space(text[stop]):
                    stop += 1
            if start_offset < start:
                out.append((text[start_offset:start], None, start_offset))
            out.append((text[start:stop], int(e["id"]), start))
            start_offset = stop
        if start_offset != len(text):
            out.append((text[start_offset:], None, start_offset))
        return out


# ---------------------------------------------------------------------------
# BPE
# ---------------------------------------------------------------------------

_CACHE_CAPACITY = 1 << 17


class BPE:
    def __init__(self, spec: dict):
        if spec.get("type", "BPE") != "BPE":
            raise ValueError(f"tokenizer.json: unsupported model {spec.get('type')!r}")
        for key in ("dropout", "continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise ValueError(f"tokenizer.json: unsupported BPE {key} {spec[key]!r}")
        _need(spec, ["vocab", "merges"], "model BPE")
        self.vocab: Dict[str, int] = {k: int(v) for k, v in spec["vocab"].items()}
        self.id_to_token: Dict[int, str] = {v: k for k, v in self.vocab.items()}
        self.unk_token: Optional[str] = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec["merges"]):
            if isinstance(m, str):
                parts = m.split(" ")
                if len(parts) != 2:
                    raise ValueError(f"tokenizer.json: merge {m!r} is not two tokens")
                a, b = parts
            else:
                a, b = m
            new = a + b
            for tok in (a, b, new):
                if tok not in self.vocab:
                    raise ValueError(f"tokenizer.json: merge {a!r} {b!r} names {tok!r}, not in the vocabulary")
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[new])
        self._cache: Dict[str, Tuple[int, ...]] = {}

    def tokenize(self, word: str) -> Tuple[int, ...]:
        if not word:
            return ()
        if self.ignore_merges:
            tid = self.vocab.get(word)
            if tid is not None:
                return (tid,)
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        ids = tuple(self._merge(self._symbols(word)))
        if len(self._cache) >= _CACHE_CAPACITY:
            self._cache.clear()
        self._cache[word] = ids
        return ids

    def _symbols(self, word: str) -> List[int]:
        """The word's characters as ids (the wheel's ``merge_word`` before
        its merges): byte fallback, then the unknown token."""
        out: List[int] = []
        unk: Optional[int] = None
        for s in word:
            tid = self.vocab.get(s)
            if tid is not None:
                if unk is not None:
                    out.append(unk)
                    unk = None
                out.append(tid)
                continue
            if self.byte_fallback:
                ids = [self.vocab.get(f"<0x{b:02X}>") for b in s.encode("utf-8")]
                if all(t is not None for t in ids):
                    out.extend(ids)
                    continue
            if self.unk_token is not None:
                unk_id = self.vocab.get(self.unk_token)
                if unk_id is None:
                    raise ValueError(f"tokenizer.json: unk_token {self.unk_token!r} is not in the vocabulary")
                if unk is not None and not self.fuse_unk:
                    out.append(unk)
                unk = unk_id
        if unk is not None:
            out.append(unk)
        return out

    def _merge(self, c: List[int]) -> List[int]:
        n = len(c)
        if n < 2:
            return c
        merges = self.merges
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((c[i], c[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos]:
                continue
            j = nxt[pos]
            if j >= n:
                continue
            m = merges.get((c[pos], c[j]))
            if m is None or m[1] != new_id:
                continue
            c[pos] = new_id
            alive[j] = False
            k = nxt[j]
            nxt[pos] = k
            if k < n:
                prv[k] = pos
            p = prv[pos]
            if p >= 0:
                m = merges.get((c[p], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            if k < n:
                m = merges.get((new_id, c[k]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, a in zip(c, alive) if a]


# ---------------------------------------------------------------------------
# The tokenizer
# ---------------------------------------------------------------------------


class TokenizerJson:
    """A ``tokenizer.json`` → ``encode`` (no special tokens added) and
    ``decode``, equal to the wheel's for the supported components."""

    def __init__(self, spec: dict):
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise ValueError(f"tokenizer.json: unsupported {key} {spec[key]!r}")
        self.model = BPE(spec.get("model") or {})
        self.added = AddedTokens(spec.get("added_tokens") or [])
        self.normalizer = build_normalizer(spec.get("normalizer"))
        self.pre_tokenizer = build_pre_tokenizer(spec.get("pre_tokenizer"))
        _check_post_processor(spec.get("post_processor"))
        dec = spec.get("decoder")
        self.decoder = build_decoder(dec)
        # A lone ByteLevel decoder decodes through per-id bytes.
        self._bytes: Optional[Dict[int, bytes]] = {} if (dec or {}).get("type") == "ByteLevel" else None
        # Ids whose token is special (skipped by decode), by the token's text as the wheel checks.
        self._special_ids = {tid for tid, tok in self.added.by_id.items() if tok in self.added.special}
        self._special_ids.update(tid for tok in self.added.special
                                 if (tid := self.model.vocab.get(tok)) is not None and self.id_to_token(tid) == tok)
        self.vocab_size = len(set(self.model.vocab) | set(self.added.by_content))

    @classmethod
    def from_file(cls, path: str) -> "TokenizerJson":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

    def token_to_id(self, token: str) -> Optional[int]:
        e = self.added.by_content.get(token)
        return int(e["id"]) if e is not None else self.model.vocab.get(token)

    def id_to_token(self, tid: int) -> Optional[str]:
        tok = self.added.by_id.get(tid)
        return tok if tok is not None else self.model.id_to_token.get(tid)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for raw, tid, start in self.added.split(text, self.added.raw_regex):
            if tid is not None:
                ids.append(tid)
                continue
            if not raw:
                continue
            norm = self.normalizer(raw) if self.normalizer is not None else raw
            for piece, ntid, nstart in self.added.split(norm, self.added.normalized_regex):
                if ntid is not None:
                    ids.append(ntid)
                elif piece:
                    for word, _ in self.pre_tokenizer([(piece, start == 0 and nstart == 0)]):
                        ids.extend(self.model.tokenize(word))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        if self._bytes is not None:
            return self._decode_bytelevel(ids, skip_special_tokens)
        tokens = []
        for tid in ids:
            tok = self.id_to_token(int(tid))
            if tok is None or (skip_special_tokens and tid in self._special_ids):
                continue
            tokens.append(tok)
        return "".join(self.decoder(tokens))

    def _decode_bytelevel(self, ids: Sequence[int], skip_special_tokens: bool) -> str:
        cache, special = self._bytes, self._special_ids if skip_special_tokens else ()
        parts = []
        for tid in ids:
            if tid in special:
                continue
            b = cache.get(tid)
            if b is None:
                tok = self.id_to_token(int(tid))
                if tok is None:
                    continue
                try:
                    b = bytes(CHAR_TO_BYTE[c] for c in tok)
                except KeyError:
                    b = tok.encode("utf-8")
                cache[tid] = b
            parts.append(b)
        return _utf8_lossy(b"".join(parts))
