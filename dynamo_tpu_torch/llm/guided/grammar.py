"""Constraint spec → character-level DFA (the JAX package's
``llm/guided/grammar.py``, copied: the same patterns and the same DFAs).

Three spec kinds compile here: a JSON Schema subset (``schema_to_regex``),
a raw regex (``compile_regex``), and a literal choice list. Everything is
normalized to a regex first, then compiled Thompson-NFA → subset-construction
DFA with dead-state pruning, so the DFA is *exact*: a state exists iff some
completion from it can still accept. That exactness is what makes the token
masks tight — a token is allowed iff the string stays matchable.

The regex dialect is the ``re``-compatible subset a DFA can honor: literals,
escapes (``\\d \\w \\s`` + punctuation), classes ``[a-z]`` / ``[^...]``,
``.``, groups ``(...)`` / ``(?:...)``, alternation, and the quantifiers
``* + ? {m} {m,} {m,n}`` (non-greedy suffixes are accepted and ignored — the
matched *language* is identical). Backreferences, lookarounds, and anchors
raise :class:`GrammarError` (matching is whole-string, so anchors are
implicit). The alphabet is printable ASCII plus ``\\n \\t \\r``; JSON string
escapes (``\\uXXXX``) keep non-ASCII content expressible.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class GrammarError(ValueError):
    """Constraint spec that cannot be compiled (client error — the protocol
    layer maps it to a structured 400, never a 500)."""


ALPHABET: Tuple[str, ...] = tuple(chr(c) for c in range(32, 127)) + ("\n", "\t", "\r")
ALPHASET = frozenset(ALPHABET)
_DIGITS = frozenset("0123456789")
_WORD = frozenset("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(" \t\n\r")

# Subset-construction safety valve: a runaway pattern (huge bounded repeats,
# pathological alternations) errors instead of eating the serving process.
MAX_DFA_STATES = 8192

_RX_SPECIALS = set("\\.[]{}()*+?|^$")


def rx_escape(text: str) -> str:
    """Escape ``text`` so it matches literally."""
    return "".join("\\" + c if c in _RX_SPECIALS else c for c in text)


# --- regex parsing -----------------------------------------------------------
# AST nodes: ("lit", frozenset) | ("cat", [nodes]) | ("alt", [nodes])
#          | ("rep", node, min, max|None)


class _RxParser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.n = len(pattern)

    def parse(self):
        node = self._alt()
        if self.i != self.n:
            raise GrammarError(f"unexpected {self.p[self.i]!r} at position {self.i}")
        return node

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < self.n else None

    def _alt(self):
        branches = [self._cat()]
        while self._peek() == "|":
            self.i += 1
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def _cat(self):
        items = []
        while True:
            c = self._peek()
            if c is None or c in "|)":
                break
            items.append(self._rep())
        if not items:
            return ("cat", [])
        return items[0] if len(items) == 1 else ("cat", items)

    def _rep(self):
        node = self._atom()
        while True:
            c = self._peek()
            if c == "*":
                self.i += 1
                lo, hi = 0, None
            elif c == "+":
                self.i += 1
                lo, hi = 1, None
            elif c == "?":
                self.i += 1
                lo, hi = 0, 1
            elif c == "{":
                spec = self._brace()
                if spec is None:
                    break  # bare '{' is a literal (re semantics)
                lo, hi = spec
            else:
                break
            if self._peek() == "?":  # non-greedy: same language, ignore
                self.i += 1
            if hi is not None and hi < lo:
                raise GrammarError(f"bad repeat range {{{lo},{hi}}}")
            node = ("rep", node, lo, hi)
        return node

    def _brace(self) -> Optional[Tuple[int, Optional[int]]]:
        j = self.p.find("}", self.i)
        if j == -1:
            return None
        body = self.p[self.i + 1 : j]
        parts = body.split(",")
        if not all(p.isdigit() or p == "" for p in parts) or len(parts) > 2 or not body:
            return None
        if not parts[0].isdigit():
            return None
        lo = int(parts[0])
        if len(parts) == 1:
            hi: Optional[int] = lo
        else:
            hi = int(parts[1]) if parts[1] else None
        self.i = j + 1
        return lo, hi

    def _atom(self):
        c = self.p[self.i]
        if c == "(":
            self.i += 1
            if self._peek() == "?":
                if self.i + 1 < self.n and self.p[self.i + 1] == ":":
                    self.i += 2
                else:
                    raise GrammarError(
                        "only (?:...) groups are supported (no lookarounds/named groups)"
                    )
            node = self._alt()
            if self._peek() != ")":
                raise GrammarError("unbalanced '('")
            self.i += 1
            return node
        if c == "[":
            self.i += 1
            return ("lit", self._cls())
        if c == ".":
            self.i += 1
            return ("lit", ALPHASET)
        if c == "\\":
            self.i += 1
            return ("lit", self._esc())
        if c in "^$":
            raise GrammarError(
                "anchors are unsupported (guided matching is whole-string)"
            )
        if c in "*+?":
            raise GrammarError(f"nothing to repeat at position {self.i}")
        self.i += 1
        if c not in ALPHASET:
            raise GrammarError(f"character {c!r} outside the supported alphabet")
        return ("lit", frozenset((c,)))

    def _esc(self) -> frozenset:
        if self.i >= self.n:
            raise GrammarError("dangling escape")
        c = self.p[self.i]
        self.i += 1
        if c == "d":
            return _DIGITS
        if c == "D":
            return ALPHASET - _DIGITS
        if c == "w":
            return _WORD
        if c == "W":
            return ALPHASET - _WORD
        if c == "s":
            return _SPACE
        if c == "S":
            return ALPHASET - _SPACE
        if c == "n":
            return frozenset("\n")
        if c == "t":
            return frozenset("\t")
        if c == "r":
            return frozenset("\r")
        if c.isdigit():
            raise GrammarError("backreferences are unsupported")
        if c.isalpha():
            raise GrammarError(f"unsupported escape \\{c}")
        return frozenset((c,))

    def _cls(self) -> frozenset:
        neg = False
        if self._peek() == "^":
            neg = True
            self.i += 1
        chars: set = set()
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise GrammarError("unterminated character class")
            if c == "]" and not first:
                self.i += 1
                break
            first = False
            if c == "\\":
                self.i += 1
                s = self._esc()
                if len(s) == 1:
                    c = next(iter(s))
                else:
                    chars |= s
                    continue
            else:
                self.i += 1
            # Range?
            if (
                self._peek() == "-"
                and self.i + 1 < self.n
                and self.p[self.i + 1] != "]"
            ):
                self.i += 1
                hi = self.p[self.i]
                self.i += 1
                if hi == "\\":
                    s = self._esc()
                    if len(s) != 1:
                        raise GrammarError("bad range end in character class")
                    hi = next(iter(s))
                if ord(hi) < ord(c):
                    raise GrammarError(f"bad range {c}-{hi} in character class")
                chars |= {chr(o) for o in range(ord(c), ord(hi) + 1)}
            else:
                chars.add(c)
        out = frozenset(chars) & ALPHASET if not neg else ALPHASET - frozenset(chars)
        if not out:
            raise GrammarError("empty character class")
        return out


# --- NFA / DFA ---------------------------------------------------------------


class _Nfa:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.trans: List[List[Tuple[frozenset, int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.trans.append([])
        return len(self.eps) - 1


def _thompson(node, nfa: _Nfa) -> Tuple[int, int]:
    kind = node[0]
    if kind == "lit":
        s, e = nfa.state(), nfa.state()
        nfa.trans[s].append((node[1], e))
        return s, e
    if kind == "cat":
        if not node[1]:
            s = nfa.state()
            return s, s
        s, e = _thompson(node[1][0], nfa)
        for sub in node[1][1:]:
            s2, e2 = _thompson(sub, nfa)
            nfa.eps[e].append(s2)
            e = e2
        return s, e
    if kind == "alt":
        s, e = nfa.state(), nfa.state()
        for sub in node[1]:
            s2, e2 = _thompson(sub, nfa)
            nfa.eps[s].append(s2)
            nfa.eps[e2].append(e)
        return s, e
    if kind == "rep":
        _, sub, lo, hi = node
        # Expand the mandatory prefix, then optional tail (or a star).
        s = e = nfa.state()
        for _ in range(lo):
            s2, e2 = _thompson(sub, nfa)
            nfa.eps[e].append(s2)
            e = e2
        if hi is None:
            s2, e2 = _thompson(sub, nfa)
            loop_out = nfa.state()
            nfa.eps[e].append(s2)
            nfa.eps[e].append(loop_out)
            nfa.eps[e2].append(s2)
            nfa.eps[e2].append(loop_out)
            e = loop_out
        else:
            out = nfa.state()
            nfa.eps[e].append(out)
            for _ in range(hi - lo):
                s2, e2 = _thompson(sub, nfa)
                nfa.eps[e].append(s2)
                nfa.eps[e2].append(out)
                e = e2
            nfa.eps[e].append(out)
            e = out
        return s, e
    raise GrammarError(f"internal: unknown AST node {kind}")


@dataclass
class CharDFA:
    """Exact character-level DFA: every state can still reach acceptance
    (dead states pruned), so "has a transition" ≡ "string stays matchable"."""

    transitions: List[Dict[str, int]] = field(default_factory=list)
    accepting: List[bool] = field(default_factory=list)
    start: int = 0
    pattern: str = ""

    @property
    def num_states(self) -> int:
        return len(self.transitions)

    def step(self, state: int, char: str) -> int:
        """Next state, or -1 (dead)."""
        if state < 0:
            return -1
        return self.transitions[state].get(char, -1)

    def match(self, text: str) -> bool:
        state = self.start
        for c in text:
            state = self.step(state, c)
            if state < 0:
                return False
        return self.accepting[state]


def compile_regex(pattern: str) -> CharDFA:
    """Parse + compile ``pattern`` (anchored, whole-string) to an exact DFA."""
    ast = _RxParser(pattern).parse()
    nfa = _Nfa()
    start, accept = _thompson(ast, nfa)

    def closure(states: frozenset) -> frozenset:
        stack = list(states)
        out = set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in out:
                    out.add(t)
                    stack.append(t)
        return frozenset(out)

    start_set = closure(frozenset((start,)))
    index = {start_set: 0}
    order = [start_set]
    transitions: List[Dict[str, int]] = [{}]
    i = 0
    while i < len(order):
        cur = order[i]
        # Only chars on an outgoing edge can move; group targets per char.
        moves: Dict[str, set] = {}
        for s in cur:
            for chars, t in nfa.trans[s]:
                for c in chars:
                    moves.setdefault(c, set()).add(t)
        for c, targets in moves.items():
            nxt = closure(frozenset(targets))
            if nxt not in index:
                if len(order) >= MAX_DFA_STATES:
                    raise GrammarError(
                        f"grammar too large (> {MAX_DFA_STATES} DFA states)"
                    )
                index[nxt] = len(order)
                order.append(nxt)
                transitions.append({})
            transitions[i][c] = index[nxt]
        i += 1
    accepting = [accept in st for st in order]

    # Dead-state pruning: backward reachability from accepting states. Any
    # transition into a state that can never accept is dropped, making the
    # DFA (and therefore the token masks) exact.
    rev: List[List[int]] = [[] for _ in order]
    for s, tr in enumerate(transitions):
        for t in tr.values():
            rev[t].append(s)
    live = set(i for i, a in enumerate(accepting) if a)
    stack = list(live)
    while stack:
        s = stack.pop()
        for p in rev[s]:
            if p not in live:
                live.add(p)
                stack.append(p)
    if 0 not in live:
        raise GrammarError("grammar matches nothing")
    remap = {}
    for s in range(len(order)):
        if s in live:
            remap[s] = len(remap)
    new_trans = [
        {c: remap[t] for c, t in transitions[s].items() if t in live}
        for s in range(len(order))
        if s in live
    ]
    new_accept = [accepting[s] for s in range(len(order)) if s in live]
    return CharDFA(transitions=new_trans, accepting=new_accept, start=remap[0], pattern=pattern)


# --- JSON Schema subset → regex ----------------------------------------------
# The canonical emitted form is whitespace-free JSON (the tightest DFA). The
# supported subset is documented in README "Structured outputs".

_RX_STR_CHAR = r'[^"\\\n\t\r]'
_RX_STR_ESC = r'\\(?:["\\/bfnrt]|u[0-9a-fA-F]{4})'
RX_INTEGER = r"-?(?:0|[1-9][0-9]*)"
RX_NUMBER = RX_INTEGER + r"(?:\.[0-9]+)?(?:[eE][-+]?[0-9]+)?"

_MAX_SCHEMA_DEPTH = 16


def rx_string(min_len: Optional[int] = None, max_len: Optional[int] = None) -> str:
    inner = f"(?:{_RX_STR_CHAR}|{_RX_STR_ESC})"
    if min_len is None and max_len is None:
        return f'"{inner}*"'
    lo = int(min_len or 0)
    hi = "" if max_len is None else str(int(max_len))
    return f'"{inner}{{{lo},{hi}}}"'


def _json_literal_rx(value) -> str:
    try:
        return rx_escape(json.dumps(value, separators=(",", ":")))
    except (TypeError, ValueError) as e:
        raise GrammarError(f"unencodable literal in schema: {e}") from None


def json_value_regex(depth: int = 2) -> str:
    """Generic JSON *value* with nesting bounded at ``depth`` container
    levels (regular languages can't count arbitrary nesting)."""
    scalar = f"(?:{rx_string()}|{RX_NUMBER}|true|false|null)"
    v = scalar
    for _ in range(max(depth, 0)):
        pair = f"{rx_string()}:{v}"
        obj = r"\{(?:" + pair + r"(?:," + pair + r")*)?\}"
        arr = r"\[(?:" + v + r"(?:," + v + r")*)?\]"
        v = f"(?:{scalar}|{obj}|{arr})"
    return v


def json_object_regex(depth: int = 3) -> str:
    """``response_format: json_object`` — any JSON object (values nested up
    to ``depth - 1`` container levels)."""
    v = json_value_regex(max(depth - 1, 0))
    pair = f"{rx_string()}:{v}"
    return r"\{(?:" + pair + r"(?:," + pair + r")*)?\}"


def schema_to_regex(schema: dict, _depth: int = 0) -> str:
    """Compile the supported JSON Schema subset to a whitespace-free regex.

    Supported: type string (minLength/maxLength/pattern) / integer / number /
    boolean / null, enum, const, arrays (items, minItems/maxItems), objects
    (properties emitted in declaration order — every declared property is
    emitted), anyOf/oneOf, and type lists. ``$ref``, ``allOf``, and
    ``additionalProperties`` schemas raise :class:`GrammarError`."""
    if not isinstance(schema, dict):
        raise GrammarError("schema must be a JSON object")
    if _depth > _MAX_SCHEMA_DEPTH:
        raise GrammarError(f"schema nests deeper than {_MAX_SCHEMA_DEPTH}")
    if "$ref" in schema:
        raise GrammarError("$ref is not supported in guided schemas")
    if "allOf" in schema:
        raise GrammarError("allOf is not supported in guided schemas")
    if "enum" in schema:
        vals = schema["enum"]
        if not isinstance(vals, list) or not vals:
            raise GrammarError("enum must be a non-empty array")
        return "(?:" + "|".join(_json_literal_rx(v) for v in vals) + ")"
    if "const" in schema:
        return _json_literal_rx(schema["const"])
    for key in ("anyOf", "oneOf"):
        if key in schema:
            subs = schema[key]
            if not isinstance(subs, list) or not subs:
                raise GrammarError(f"{key} must be a non-empty array")
            return "(?:" + "|".join(schema_to_regex(s, _depth + 1) for s in subs) + ")"
    t = schema.get("type")
    if isinstance(t, list):
        if not t:
            raise GrammarError("type list must be non-empty")
        return "(?:" + "|".join(
            schema_to_regex({**schema, "type": one}, _depth + 1) for one in t
        ) + ")"
    if t == "string":
        if "pattern" in schema:
            if not isinstance(schema["pattern"], str):
                raise GrammarError("string pattern must be a string")
            return f'"(?:{schema["pattern"]})"'
        return rx_string(schema.get("minLength"), schema.get("maxLength"))
    if t == "integer":
        return RX_INTEGER
    if t == "number":
        return RX_NUMBER
    if t == "boolean":
        return "(?:true|false)"
    if t == "null":
        return "null"
    if t == "array":
        items = schema.get("items")
        item = schema_to_regex(items, _depth + 1) if isinstance(items, dict) else json_value_regex(1)
        lo = int(schema.get("minItems") or 0)
        hi = schema.get("maxItems")
        if hi is not None and int(hi) < lo:
            raise GrammarError("maxItems < minItems")
        if hi is not None and int(hi) == 0:
            return r"\[\]"
        if hi is None:
            body = f"{item}(?:,{item})*" if lo >= 1 else f"(?:{item}(?:,{item})*)?"
            if lo > 1:
                body = f"{item}(?:,{item}){{{lo - 1},}}"
        else:
            body = f"{item}(?:,{item}){{{max(lo - 1, 0)},{int(hi) - 1}}}"
            if lo == 0:
                body = f"(?:{body})?"
        return r"\[" + body + r"\]"
    if t == "object" or (t is None and isinstance(schema.get("properties"), dict)):
        props = schema.get("properties")
        if not isinstance(props, dict) or not props:
            return json_object_regex(2)
        parts = []
        for key, sub in props.items():
            if not isinstance(key, str):
                raise GrammarError("property names must be strings")
            parts.append(_json_literal_rx(key) + ":" + schema_to_regex(sub, _depth + 1))
        return r"\{" + ",".join(parts) + r"\}"
    if t is None:
        return json_value_regex(2)
    raise GrammarError(f"unsupported schema type {t!r}")


# --- spec normalization ------------------------------------------------------


def spec_to_pattern(spec: dict) -> str:
    """Canonical regex for a wire guided-decoding spec (kinds: ``regex``,
    ``choice``)."""
    if not isinstance(spec, dict):
        raise GrammarError("guided spec must be an object")
    kind = spec.get("kind")
    if kind == "regex":
        pattern = spec.get("pattern")
        if not isinstance(pattern, str) or not pattern:
            raise GrammarError("guided regex spec needs a non-empty pattern")
        return pattern
    if kind == "choice":
        choices = spec.get("choices")
        if not isinstance(choices, list) or not choices or not all(
            isinstance(c, str) and c for c in choices
        ):
            raise GrammarError("guided choice spec needs a non-empty list of strings")
        return "(?:" + "|".join(rx_escape(c) for c in choices) + ")"
    raise GrammarError(f"unknown guided spec kind {kind!r}")


def spec_to_dfa(spec: dict) -> CharDFA:
    return compile_regex(spec_to_pattern(spec))


def _tool_call_pattern(tools: list, names: List[str]) -> str:
    """Forced tool call grammar: the model must emit
    ``{"name":"<tool>","arguments":{...}}`` with arguments matching the
    chosen tool's parameter schema, which the JSON tool-call parser turns
    into an OpenAI tool_call."""
    alts = []
    for tool in tools:
        fn = (tool or {}).get("function") or {}
        name = fn.get("name")
        if name not in names:
            continue
        params = fn.get("parameters")
        if params is None:
            params = {"type": "object"}
        args_rx = schema_to_regex(params)
        alts.append(
            r"\{" + _json_literal_rx("name") + ":" + _json_literal_rx(name)
            + "," + _json_literal_rx("arguments") + ":" + args_rx + r"\}"
        )
    if not alts:
        raise GrammarError("tool_choice names no known tool")
    return "(?:" + "|".join(alts) + ")"


def build_guided_spec(body: dict) -> Optional[dict]:
    """Validated request body → wire guided-decoding spec (or None).

    Precedence: forced ``tool_choice`` (named or ``required``) >
    ``response_format`` (json_schema / json_object) > nvext extensions
    (``guided_regex`` / ``guided_choice`` / ``guided_json``). Every produced
    pattern is compiled once here so malformed/unsupported constraints
    surface as a structured 400 at the frontend, never a worker-side 500."""
    from dynamo_tpu_torch.llm.protocols.openai import RequestError

    try:
        spec = _build_spec(body)
        if spec is not None:
            compile_regex(spec["pattern"])  # frontend-side compilability check
        return spec
    except GrammarError as e:
        raise RequestError(f"invalid guided-decoding constraint: {e}") from None


def _build_spec(body: dict) -> Optional[dict]:
    tools = body.get("tools") or []
    tc = body.get("tool_choice")
    if isinstance(tc, dict):
        name = ((tc.get("function") or {}).get("name")) or ""
        return {
            "kind": "regex",
            "pattern": _tool_call_pattern(tools, [name]),
            "source": "tool_choice",
            "forced_tools": [name],
        }
    if tc == "required":
        names = [((t or {}).get("function") or {}).get("name") for t in tools]
        names = [n for n in names if n]
        return {
            "kind": "regex",
            "pattern": _tool_call_pattern(tools, names),
            "source": "tool_choice",
            "forced_tools": names,
        }
    rf = body.get("response_format") or {}
    if rf.get("type") == "json_schema":
        schema = (rf.get("json_schema") or {}).get("schema")
        return {
            "kind": "regex",
            "pattern": schema_to_regex(schema),
            "source": "json_schema",
        }
    if rf.get("type") == "json_object":
        return {"kind": "regex", "pattern": json_object_regex(), "source": "json_object"}
    nv = body.get("nvext") or {}
    if nv.get("guided_regex") is not None:
        return {"kind": "regex", "pattern": nv["guided_regex"], "source": "guided_regex"}
    if nv.get("guided_choice") is not None:
        return {
            "kind": "regex",
            "pattern": spec_to_pattern({"kind": "choice", "choices": nv["guided_choice"]}),
            "source": "guided_choice",
        }
    if nv.get("guided_json") is not None:
        return {
            "kind": "regex",
            "pattern": schema_to_regex(nv["guided_json"]),
            "source": "guided_json",
        }
    return None
