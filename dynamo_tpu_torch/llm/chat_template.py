"""An interpreter for the Jinja subset that chat templates use, with no
jinja2 wheel.

``Template(source).render(**variables)`` gives the bytes that
``jinja2.Environment(keep_trailing_newline=True).from_string(source)
.render(**variables)`` gives, for templates made of:

- ``{{ }}``, ``{% if/elif/else %}``, ``{% for %}`` (tuple targets, an
  ``if`` filter, ``{% else %}``; ``loop.index``, ``index0``, ``revindex``,
  ``revindex0``, ``first``, ``last``, ``length``), ``{% set %}`` (names,
  tuples and ``namespace()`` attributes), comments, and the ``-``
  whitespace control on every tag;
- literals, ``and``/``or``/``not``, comparisons, ``in``/``not in``,
  ``+ - * / // % **``, ``~``, the inline ``if``/``else``, subscripts and
  slices, attribute lookups (an attribute, else an item) and calls (a
  string's ``strip``, ``startswith``, ``split``...; ``range``, ``dict``,
  ``namespace``, ``raise_exception``);
- the tests ``defined``, ``undefined``, ``none``, ``string``, ``mapping``,
  ``iterable``, ``sequence``, ``number``, ``boolean``, ``true``,
  ``false``, ``eq``/``equalto``/``==``, ``ne``/``!=`` and ``in``;
- the filters ``trim``, ``length``, ``tojson`` (HTML-safe, keys sorted;
  its result escapes a string it is added to, as markupsafe's ``Markup``
  does), ``default``/``d``, ``join``, ``upper``, ``lower``, ``list``,
  ``string``, ``selectattr`` and ``rejectattr``: what the Llama-3.x,
  Qwen2.5 and Mistral templates use.

Semantics follow jinja2's: an undefined name renders empty, tests false,
iterates as empty and raises ``UndefinedError`` on arithmetic, attributes
and calls; each loop iteration has its own scope (a ``set`` inside a loop
does not outlive the iteration), an ``if`` has none; newlines in data and
string literals are normalized to ``\\n``. Any other tag, filter, test or
syntax raises ``TemplateSyntaxError`` (a ``ValueError``) when the template
is constructed, naming it.
"""

from __future__ import annotations

import json
import operator
import re
from collections import abc
from typing import Any, Callable, Dict, List, Optional, Tuple


class TemplateSyntaxError(ValueError):
    pass


class UndefinedError(Exception):
    pass


# ---------------------------------------------------------------------------
# Runtime values
# ---------------------------------------------------------------------------


class Undefined:
    """jinja2's default ``Undefined``."""

    __slots__ = ("_hint",)

    def __init__(self, hint: str = "value is undefined"):
        self._hint = hint

    def _fail(self, *args, **kwargs):
        raise UndefinedError(self._hint)

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _fail
    __truediv__ = __rtruediv__ = __floordiv__ = __rfloordiv__ = __mod__ = __rmod__ = _fail
    __pow__ = __rpow__ = __pos__ = __neg__ = __getitem__ = __call__ = _fail
    __lt__ = __le__ = __gt__ = __ge__ = __int__ = __float__ = __complex__ = _fail

    def __getattr__(self, name: str):
        if name[:2] == "__":
            raise AttributeError(name)
        return self._fail()

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __hash__(self) -> int:
        return id(type(self))

    def __str__(self) -> str:
        return ""

    def __len__(self) -> int:
        return 0

    def __iter__(self):
        return iter(())

    def __bool__(self) -> bool:
        return False

    def __repr__(self) -> str:
        return "Undefined"


def _escape(s) -> "Markup":
    if hasattr(s, "__html__"):
        return Markup(s.__html__())
    return Markup(str(s).replace("&", "&amp;").replace(">", "&gt;").replace("<", "&lt;")
                  .replace("'", "&#39;").replace('"', "&#34;"))


class Markup(str):
    """markupsafe's ``Markup`` as far as templates reach it: adding a
    string to it (on either side) escapes that string."""

    __slots__ = ()

    def __html__(self):
        return self

    def __add__(self, other):
        if isinstance(other, str) or hasattr(other, "__html__"):
            return Markup(str.__add__(self, _escape(other)))
        return NotImplemented

    def __radd__(self, other):
        if isinstance(other, str) or hasattr(other, "__html__"):
            return Markup(str.__add__(_escape(other), self))
        return NotImplemented

    def _wrap(name):  # noqa: N805 — a class-body helper
        def method(self, *args, **kwargs):
            return Markup(getattr(str, name)(self, *args, **kwargs))

        method.__name__ = name
        return method

    strip = _wrap("strip")
    lstrip = _wrap("lstrip")
    rstrip = _wrap("rstrip")
    upper = _wrap("upper")
    lower = _wrap("lower")
    del _wrap


class Namespace:
    """``namespace(...)``: the one object a ``set`` may assign attributes of."""

    def __init__(self, *args, **kwargs):
        self.__dict__["_attrs"] = dict(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return self.__dict__["_attrs"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __repr__(self) -> str:
        return f"<Namespace {self.__dict__['_attrs']!r}>"


class LoopContext:
    def __init__(self, items: list, index0: int):
        self._items = items
        self.index0 = index0

    @property
    def index(self):
        return self.index0 + 1

    @property
    def length(self):
        return len(self._items)

    @property
    def revindex(self):
        return len(self._items) - self.index0

    @property
    def revindex0(self):
        return len(self._items) - self.index0 - 1

    @property
    def first(self):
        return self.index0 == 0

    @property
    def last(self):
        return self.index0 == len(self._items) - 1



def _getattr(obj, name):
    """jinja2's ``Environment.getattr``: an attribute, else an item, else
    undefined."""
    try:
        return getattr(obj, name)
    except AttributeError:
        pass
    try:
        return obj[name]
    except (TypeError, LookupError, AttributeError):
        return Undefined(f"{_type_name(obj)!r} has no attribute {name!r}")


def _getitem(obj, key):
    """jinja2's ``Environment.getitem``: an item, else (for a string key)
    an attribute, else undefined."""
    try:
        return obj[key]
    except (AttributeError, TypeError, LookupError):
        if isinstance(key, str):
            try:
                return getattr(obj, key)
            except AttributeError:
                pass
        return Undefined(f"{_type_name(obj)} has no element {key!r}")


def _type_name(obj) -> str:
    return f"{type(obj).__name__} object"


def _soft_str(value) -> str:
    return value if isinstance(value, str) else str(value)


# ---------------------------------------------------------------------------
# Filters and tests
# ---------------------------------------------------------------------------


def _tojson(value, indent=None):
    text = json.dumps(value, sort_keys=True, indent=indent)
    return Markup(text.replace("<", "\\u003c").replace(">", "\\u003e").replace("&", "\\u0026").replace("'", "\\u0027"))


def _default(value, default_value="", boolean=False):
    if isinstance(value, Undefined) or (boolean and not value):
        return default_value
    return value


def _join(value, d="", attribute=None):
    if attribute is not None:
        value = [_getattr(v, attribute) if isinstance(attribute, str) else _getitem(v, attribute) for v in value]
    return str(d).join(map(str, value))


def _test_sequence(value) -> bool:
    try:
        len(value)
        value.__getitem__  # noqa: B018 — the probe jinja2 makes
    except Exception:  # noqa: BLE001 — jinja2's test catches everything
        return False
    return True


def _test_iterable(value) -> bool:
    try:
        iter(value)
    except TypeError:
        return False
    return True


TESTS: Dict[str, Callable] = {
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
    "none": lambda v: v is None,
    "string": lambda v: isinstance(v, str),
    "mapping": lambda v: isinstance(v, abc.Mapping),
    "iterable": _test_iterable,
    "sequence": _test_sequence,
    "number": lambda v: isinstance(v, (int, float, complex)),
    "boolean": lambda v: v is True or v is False,
    "true": lambda v: v is True,
    "false": lambda v: v is False,
    "eq": operator.eq, "equalto": operator.eq, "==": operator.eq,
    "ne": operator.ne, "!=": operator.ne,
    "in": lambda v, seq: v in seq,
}


def _selectattr(seq, attribute, test_args, keep: bool):
    """selectattr (``keep``) and rejectattr: the items whose ``attribute``
    passes the named test (truthiness without one)."""
    if test_args:
        name, args = test_args[0], test_args[1:]
        if name not in TESTS:
            raise TemplateSyntaxError(f"chat template: unsupported test {name!r}")
        test = TESTS[name]
    else:
        test, args = bool, ()
    for item in seq:
        if bool(test(_getattr(item, attribute), *args)) == keep:
            yield item


FILTERS: Dict[str, Callable] = {
    "trim": lambda v, chars=None: _soft_str(v).strip(chars),
    "length": len,
    "tojson": _tojson,
    "default": _default, "d": _default,
    "join": _join,
    "upper": lambda v: _soft_str(v).upper(),
    "lower": lambda v: _soft_str(v).lower(),
    "list": list,
    "string": _soft_str,
    "selectattr": lambda seq, attr, *a: _selectattr(seq, attr, a, True),
    "rejectattr": lambda seq, attr, *a: _selectattr(seq, attr, a, False),
}


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_NEWLINES = re.compile(r"\r\n|\r|\n")
_TAG_START = re.compile(r"\{\{|\{%|\{#")
_WS = re.compile(r"\s+")
_FLOAT = re.compile(r"(?<!\.)(\d+_)*\d+((\.(\d+_)*\d+)?e[+\-]?(\d+_)*\d+|\.(\d+_)*\d+)", re.IGNORECASE)
_INTEGER = re.compile(r"(0b(_?[0-1])+|0o(_?[0-7])+|0x(_?[\da-f])+|[1-9](_?\d)*|0(_?0)*)", re.IGNORECASE)
_NAME = re.compile(r"[^\W\d]\w*")
_STRING = re.compile(r"('([^'\\]*(?:\\.[^'\\]*)*)'|\"([^\"\\]*(?:\\.[^\"\\]*)*)\")", re.S)
_OPERATORS = ("//", "**", "==", "!=", "<=", ">=", "+", "-", "/", "*", "%", "~", "[", "]", "(", ")", "{", "}",
              "=", ".", ":", "|", ",", ";", "<", ">")
_OPEN, _CLOSE = "([{", ")]}"

Tok = Tuple[str, Any]  # (kind, value): kind in name, string, integer, float, op


def _lex(source: str) -> List[tuple]:
    """The template → [("data", text) | ("var", [tokens]) | ("block",
    [tokens])], whitespace control applied."""
    out: List[tuple] = []
    pos, strip_next = 0, False
    n = len(source)
    while pos <= n:
        m = _TAG_START.search(source, pos)
        data = source[pos:m.start()] if m else source[pos:]
        if strip_next:
            data = data.lstrip()
        if m is None:
            if data:
                out.append(("data", _NEWLINES.sub("\n", data)))
            break
        kind = m.group(0)
        p = m.end()
        if source[p:p + 1] == "-":
            data = data.rstrip()
            p += 1
        elif source[p:p + 1] == "+":
            p += 1
        if data:
            out.append(("data", _NEWLINES.sub("\n", data)))
        if kind == "{#":
            end = source.find("#}", p)
            if end < 0:
                raise TemplateSyntaxError("chat template: unclosed comment")
            strip_next = source[end - 1:end] == "-" and end - 1 >= p
            pos = end + 2
            continue
        close = "}}" if kind == "{{" else "%}"
        tokens, pos, strip_next = _lex_tag(source, p, close)
        out.append(("var" if kind == "{{" else "block", tokens))
    return out


def _lex_tag(source: str, pos: int, close: str) -> Tuple[List[Tok], int, bool]:
    tokens: List[Tok] = []
    stack: List[str] = []
    n = len(source)
    while pos < n:
        if not stack:
            if source.startswith("-" + close, pos):
                return tokens, pos + 1 + len(close), True
            if source.startswith(close, pos):
                return tokens, pos + len(close), False
        m = _WS.match(source, pos)
        if m:
            pos = m.end()
            continue
        for kind, regex in (("float", _FLOAT), ("integer", _INTEGER), ("name", _NAME), ("string", _STRING)):
            m = regex.match(source, pos)
            if m:
                text = m.group(0)
                if kind == "float":
                    tokens.append(("float", float(text.replace("_", ""))))
                elif kind == "integer":
                    tokens.append(("integer", int(text.replace("_", ""), 0)))
                elif kind == "name":
                    tokens.append(("name", text))
                else:
                    body = _NEWLINES.sub("\n", text[1:-1])
                    tokens.append(("string", body.encode("ascii", "backslashreplace").decode("unicode-escape")))
                pos = m.end()
                break
        else:
            for op in _OPERATORS:
                if source.startswith(op, pos):
                    if op in _OPEN:
                        stack.append(op)
                    elif op in _CLOSE:
                        if not stack:
                            raise TemplateSyntaxError(f"chat template: unexpected {op!r}")
                        stack.pop()
                    tokens.append(("op", op))
                    pos += len(op)
                    break
            else:
                raise TemplateSyntaxError(f"chat template: unexpected character {source[pos]!r}")
    raise TemplateSyntaxError(f"chat template: unclosed tag (expected {close!r})")


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_COMPARE = {"==": operator.eq, "!=": operator.ne, "<": operator.lt, "<=": operator.le, ">": operator.gt,
            ">=": operator.ge}
_MATH = {"+": operator.add, "-": operator.sub, "*": operator.mul, "/": operator.truediv,
         "//": operator.floordiv, "%": operator.mod, "**": operator.pow}
_UNSUPPORTED_TAGS = ("macro", "call", "filter", "include", "import", "from", "extends", "block", "with",
                     "raw", "break", "continue", "do", "autoescape", "trans", "generation")


class _Expr:
    """Tokens of one tag → expression trees (tuples)."""

    def __init__(self, tokens: List[Tok]):
        self.toks = tokens
        self.i = 0

    # --- token helpers ------------------------------------------------------
    def peek(self, k: int = 0) -> Optional[Tok]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def at(self, kind: str, value=None, k: int = 0) -> bool:
        t = self.peek(k)
        return t is not None and t[0] == kind and (value is None or t[1] == value)

    def skip(self, kind: str, value=None) -> bool:
        if self.at(kind, value):
            self.i += 1
            return True
        return False

    def expect(self, kind: str, value=None) -> Tok:
        if not self.at(kind, value):
            got = self.peek()
            raise TemplateSyntaxError(f"chat template: expected {value or kind!r}, got {got[1] if got else 'end'!r}")
        t = self.toks[self.i]
        self.i += 1
        return t

    def done(self) -> bool:
        return self.i >= len(self.toks)

    def end(self) -> None:
        if not self.done():
            raise TemplateSyntaxError(f"chat template: unexpected {self.peek()[1]!r}")

    # --- grammar (jinja2's precedence) ---------------------------------------
    def expression(self):
        return self.condexpr()

    def condexpr(self):
        expr = self.or_()
        while self.skip("name", "if"):
            test = self.or_()
            other = self.condexpr() if self.skip("name", "else") else None
            expr = ("cond", test, expr, other)
        return expr

    def or_(self):
        left = self.and_()
        while self.skip("name", "or"):
            left = ("or", left, self.and_())
        return left

    def and_(self):
        left = self.not_()
        while self.skip("name", "and"):
            left = ("and", left, self.not_())
        return left

    def not_(self):
        if self.at("name", "not"):
            self.i += 1
            return ("not", self.not_())
        return self.compare()

    def compare(self):
        expr = self.math1()
        ops = []
        while True:
            t = self.peek()
            if t is not None and t[0] == "op" and t[1] in _COMPARE:
                self.i += 1
                ops.append((t[1], self.math1()))
            elif self.skip("name", "in"):
                ops.append(("in", self.math1()))
            elif self.at("name", "not") and self.at("name", "in", 1):
                self.i += 2
                ops.append(("notin", self.math1()))
            else:
                break
        return ("compare", expr, ops) if ops else expr

    def math1(self):
        left = self.concat()
        while self.at("op", "+") or self.at("op", "-"):
            op = self.toks[self.i][1]
            self.i += 1
            left = ("binop", op, left, self.concat())
        return left

    def concat(self):
        args = [self.math2()]
        while self.skip("op", "~"):
            args.append(self.math2())
        return ("concat", args) if len(args) > 1 else args[0]

    def math2(self):
        left = self.pow_()
        while any(self.at("op", o) for o in ("*", "/", "//", "%")):
            op = self.toks[self.i][1]
            self.i += 1
            left = ("binop", op, left, self.pow_())
        return left

    def pow_(self):
        left = self.unary()
        while self.skip("op", "**"):
            left = ("binop", "**", left, self.unary())
        return left

    def unary(self, with_filter: bool = True):
        if self.skip("op", "-"):
            node = ("neg", self.unary(False))
        elif self.skip("op", "+"):
            node = ("pos", self.unary(False))
        else:
            node = self.primary()
        node = self.postfix(node)
        if with_filter:
            node = self.filter_expr(node)
        return node

    def primary(self):
        t = self.peek()
        if t is None:
            raise TemplateSyntaxError("chat template: unexpected end of an expression")
        kind, value = t
        if kind == "name":
            self.i += 1
            if value in ("true", "True"):
                return ("const", True)
            if value in ("false", "False"):
                return ("const", False)
            if value in ("none", "None"):
                return ("const", None)
            if value in _UNSUPPORTED_GLOBALS:
                raise TemplateSyntaxError(f"chat template: unsupported global {value!r}")
            return ("name", value)
        if kind == "string":
            self.i += 1
            parts = [value]
            while self.at("string"):
                parts.append(self.toks[self.i][1])
                self.i += 1
            return ("const", "".join(parts))
        if kind in ("integer", "float"):
            self.i += 1
            return ("const", value)
        if kind == "op" and value == "(":
            self.i += 1
            return self.tuple_(closing=")")
        if kind == "op" and value == "[":
            self.i += 1
            items = []
            while not self.skip("op", "]"):
                if items:
                    self.expect("op", ",")
                    if self.skip("op", "]"):
                        break
                items.append(self.expression())
            return ("list", items)
        if kind == "op" and value == "{":
            self.i += 1
            items = []
            while not self.skip("op", "}"):
                if items:
                    self.expect("op", ",")
                    if self.skip("op", "}"):
                        break
                key = self.expression()
                self.expect("op", ":")
                items.append((key, self.expression()))
            return ("dict", items)
        raise TemplateSyntaxError(f"chat template: unexpected {value!r}")

    def tuple_(self, closing: Optional[str] = None):
        """A parenthesized expression or tuple (``closing``), or a bare
        comma-separated tuple (``for``/``set`` targets and values)."""
        items, trailing = [], False
        while True:
            if closing and self.skip("op", closing):
                break
            if items:
                if not self.skip("op", ","):
                    if closing:
                        self.expect("op", closing)
                    break
                trailing = True
                if closing and self.skip("op", closing):
                    break
                if not closing and (self.done() or self.at("name", "in") or self.at("op", "=")):
                    break
            items.append(self.expression())
            trailing = False
        if len(items) == 1 and not trailing:
            return items[0]
        return ("tuple", items)

    def postfix(self, node):
        while True:
            if self.skip("op", "."):
                t = self.peek()
                if t is not None and t[0] == "name":
                    self.i += 1
                    if node == ("name", "loop") and t[1] not in _LOOP_ATTRS:
                        raise TemplateSyntaxError(f"chat template: unsupported loop attribute {t[1]!r}")
                    node = ("getattr", node, t[1])
                elif t is not None and t[0] == "integer":
                    self.i += 1
                    node = ("getitem", node, ("const", t[1]))
                else:
                    raise TemplateSyntaxError("chat template: expected a name after '.'")
            elif self.skip("op", "["):
                node = ("getitem", node, self.subscript())
            elif self.at("op", "("):
                node = self.call(node)
            else:
                return node

    def subscript(self):
        parts: List[Optional[tuple]] = [None]
        while not self.skip("op", "]"):
            if self.skip("op", ":"):
                parts.append(None)
                continue
            if self.skip("op", ","):
                raise TemplateSyntaxError("chat template: unsupported tuple subscript")
            parts[-1] = self.expression()
        if len(parts) == 1:
            if parts[0] is None:
                raise TemplateSyntaxError("chat template: empty subscript")
            return parts[0]
        if len(parts) > 3:
            raise TemplateSyntaxError("chat template: bad slice")
        while len(parts) < 3:
            parts.append(None)
        return ("slice", *parts)

    def call_args(self):
        self.expect("op", "(")
        args, kwargs = [], []
        while not self.skip("op", ")"):
            if args or kwargs:
                self.expect("op", ",")
                if self.skip("op", ")"):
                    break
            if self.at("op", "*") or self.at("op", "**"):
                raise TemplateSyntaxError("chat template: unsupported *args or **kwargs in a call")
            if self.at("name") and self.at("op", "=", 1):
                key = self.toks[self.i][1]
                self.i += 2
                kwargs.append((key, self.expression()))
            else:
                if kwargs:
                    raise TemplateSyntaxError("chat template: a positional argument after a keyword argument")
                args.append(self.expression())
        return args, kwargs

    def call(self, node):
        args, kwargs = self.call_args()
        return ("call", node, args, kwargs)

    def filter_expr(self, node):
        while True:
            if self.skip("op", "|"):
                name = self.expect("name")[1]
                while self.skip("op", "."):
                    name += "." + self.expect("name")[1]
                if name not in FILTERS:
                    raise TemplateSyntaxError(f"chat template: unsupported filter {name!r}")
                args, kwargs = self.call_args() if self.at("op", "(") else ([], [])
                node = ("filter", name, node, args, kwargs)
            elif self.at("name", "is"):
                self.i += 1
                negated = self.skip("name", "not")
                name = self.expect("name")[1]
                if name not in TESTS:
                    raise TemplateSyntaxError(f"chat template: unsupported test {name!r}")
                args, kwargs = [], []
                if self.at("op", "("):
                    args, kwargs = self.call_args()
                elif self._test_arg_follows():
                    if self.at("name", "is"):
                        raise TemplateSyntaxError("chat template: tests cannot be chained with 'is'")
                    args = [self.postfix(self.primary())]
                node = ("test", name, node, args, kwargs)
                if negated:
                    node = ("not", node)
            elif self.at("op", "("):
                node = self.call(node)
            else:
                return node

    def _test_arg_follows(self) -> bool:
        """jinja2's rule: a test takes one argument without parentheses
        when a name (but else, or, and), a literal or a bracket follows."""
        t = self.peek()
        if t is None:
            return False
        if t[0] in ("string", "integer", "float"):
            return True
        if t[0] == "name":
            return t[1] not in ("else", "or", "and")
        return t[0] == "op" and t[1] in ("(", "[", "{")

    # --- targets --------------------------------------------------------------
    def target(self, with_namespace: bool = False):
        if with_namespace and self.at("name") and self.at("op", ".", 1):
            obj = self.expect("name")[1]
            self.expect("op", ".")
            return ("nsref", obj, self.expect("name")[1])
        names, comma = [self.expect("name")[1]], False
        while self.skip("op", ","):
            comma = True
            if not self.at("name"):
                break
            names.append(self.expect("name")[1])
        return ("names", names) if comma else ("name", names[0])


def _parse(tokens: List[tuple]) -> list:
    """Lexed items → a body: [("data", s) | ("output", expr) | ("if", ..)
    | ("for", ..) | ("set", ..)]."""
    body, i, end = _parse_body(tokens, 0, ())
    if end is not None:
        raise TemplateSyntaxError(f"chat template: unexpected {{% {end} %}}")
    return body


def _parse_body(items: List[tuple], i: int, stop: Tuple[str, ...]):
    """Statements until a block tag whose name is in ``stop`` → (body,
    index just past that tag, (tag name, its expression parser)) or
    (body, len, None) at the end."""
    body = []
    while i < len(items):
        kind, value = items[i]
        i += 1
        if kind == "data":
            body.append(("data", value))
            continue
        p = _Expr(value)
        if kind == "var":
            body.append(("output", p.expression()))
            p.end()
            continue
        name = p.expect("name")[1]
        if name in stop:
            return body, i, (name, p)
        if name == "if":
            branches = [(p.expression(), None)]
            p.end()
            else_body = []
            while True:
                sub, i, found = _parse_body(items, i, ("elif", "else", "endif"))
                if found is None:
                    raise TemplateSyntaxError("chat template: unclosed {% if %}")
                branches[-1] = (branches[-1][0], sub)
                tag, q = found
                if tag == "elif":
                    branches.append((q.expression(), None))
                    q.end()
                elif tag == "else":
                    q.end()
                    else_body, i, found = _parse_body(items, i, ("endif",))
                    if found is None:
                        raise TemplateSyntaxError("chat template: unclosed {% if %}")
                    found[1].end()
                    break
                else:
                    q.end()
                    break
            body.append(("if", branches, else_body))
        elif name == "for":
            target = p.target()
            p.expect("name", "in")
            iterable = p.or_()
            cond = p.or_() if p.skip("name", "if") else None
            if p.at("name", "recursive"):
                raise TemplateSyntaxError("chat template: unsupported recursive loop")
            p.end()
            sub, i, found = _parse_body(items, i, ("else", "endfor"))
            if found is None:
                raise TemplateSyntaxError("chat template: unclosed {% for %}")
            else_body = []
            if found[0] == "else":
                found[1].end()
                else_body, i, found = _parse_body(items, i, ("endfor",))
                if found is None:
                    raise TemplateSyntaxError("chat template: unclosed {% for %}")
            found[1].end()
            body.append(("for", target, iterable, cond, sub, else_body))
        elif name == "set":
            target = p.target(with_namespace=True)
            if not p.skip("op", "="):
                raise TemplateSyntaxError("chat template: unsupported block {% set %}")
            value = p.tuple_()
            p.end()
            body.append(("set", target, value))
        elif name in _UNSUPPORTED_TAGS:
            raise TemplateSyntaxError(f"chat template: unsupported tag {{% {name} %}}")
        else:
            raise TemplateSyntaxError(f"chat template: unknown tag {{% {name} %}}")
    return body, i, None


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


class _Scope:
    __slots__ = ("vars", "parent")

    def __init__(self, parent: Optional["_Scope"], variables: Optional[dict] = None):
        self.vars = variables if variables is not None else {}
        self.parent = parent

    def lookup(self, name: str):
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return Undefined(f"{name!r} is undefined")


def _eval(node, scope: _Scope):
    kind = node[0]
    if kind == "const":
        return node[1]
    if kind == "name":
        return scope.lookup(node[1])
    if kind == "getattr":
        return _getattr(_eval(node[1], scope), node[2])
    if kind == "getitem":
        return _getitem(_eval(node[1], scope), _eval(node[2], scope))
    if kind == "slice":
        return slice(*(None if n is None else _eval(n, scope) for n in node[1:]))
    if kind == "filter":
        _, name, arg, args, kwargs = node
        value = _eval(arg, scope)
        return FILTERS[name](value, *[_eval(a, scope) for a in args], **{k: _eval(v, scope) for k, v in kwargs})
    if kind == "test":
        _, name, arg, args, kwargs = node
        value = _eval(arg, scope)
        return TESTS[name](value, *[_eval(a, scope) for a in args], **{k: _eval(v, scope) for k, v in kwargs})
    if kind == "call":
        fn = _eval(node[1], scope)
        return fn(*[_eval(a, scope) for a in node[2]], **{k: _eval(v, scope) for k, v in node[3]})
    if kind == "not":
        return not _eval(node[1], scope)
    if kind == "and":
        return _eval(node[1], scope) and _eval(node[2], scope)
    if kind == "or":
        return _eval(node[1], scope) or _eval(node[2], scope)
    if kind == "compare":
        left = _eval(node[1], scope)
        for op, rnode in node[2]:
            right = _eval(rnode, scope)
            if op == "in":
                ok = left in right
            elif op == "notin":
                ok = left not in right
            else:
                ok = _COMPARE[op](left, right)
            if not ok:
                return False
            left = right
        return True
    if kind == "binop":
        return _MATH[node[1]](_eval(node[2], scope), _eval(node[3], scope))
    if kind == "concat":
        return "".join(str(_eval(n, scope)) for n in node[1])
    if kind == "neg":
        return -_eval(node[1], scope)
    if kind == "pos":
        return +_eval(node[1], scope)
    if kind == "cond":
        if _eval(node[1], scope):
            return _eval(node[2], scope)
        if node[3] is None:
            return Undefined("the inline if-expression evaluated to false and no else section was defined.")
        return _eval(node[3], scope)
    if kind == "list":
        return [_eval(n, scope) for n in node[1]]
    if kind == "tuple":
        return tuple(_eval(n, scope) for n in node[1])
    if kind == "dict":
        return {_eval(k, scope): _eval(v, scope) for k, v in node[1]}
    raise TemplateSyntaxError(f"chat template: unknown expression {kind!r}")


def _assign(target, value, scope: _Scope) -> None:
    kind = target[0]
    if kind == "name":
        scope.vars[target[1]] = value
    elif kind == "names":
        values = list(value)
        if len(values) != len(target[1]):
            raise ValueError(f"cannot unpack {len(values)} values into {len(target[1])} names")
        for name, v in zip(target[1], values):
            scope.vars[name] = v
    else:
        ns = scope.lookup(target[1])
        if not isinstance(ns, Namespace):
            raise UndefinedError("cannot assign attribute on non-namespace object")
        ns.__dict__["_attrs"][target[2]] = value


def _run(body: list, scope: _Scope, out: List[str]) -> None:
    for node in body:
        kind = node[0]
        if kind == "data":
            out.append(node[1])
        elif kind == "output":
            value = _eval(node[1], scope)
            if not isinstance(value, Undefined):
                out.append(str(value))
        elif kind == "if":
            for cond, sub in node[1]:
                if _eval(cond, scope):
                    _run(sub, scope, out)
                    break
            else:
                _run(node[2], scope, out)
        elif kind == "for":
            _, target, iterable, cond, sub, else_body = node
            items = list(_eval(iterable, scope))
            if cond is not None:
                kept = []
                for item in items:
                    probe = _Scope(scope)
                    _assign(target, item, probe)
                    if _eval(cond, probe):
                        kept.append(item)
                items = kept
            for idx, item in enumerate(items):
                it = _Scope(scope, {"loop": LoopContext(items, idx)})
                _assign(target, item, it)
                _run(sub, it, out)
            if not items:
                _run(else_body, scope, out)
        else:  # set
            _assign(node[1], _eval(node[2], scope), scope)


GLOBALS = {"range": range, "dict": dict, "namespace": Namespace}
# jinja2's other default globals, and the loop attributes left out: a
# template that names one is refused when it is built.
_UNSUPPORTED_GLOBALS = ("lipsum", "cycler", "joiner")
_LOOP_ATTRS = ("index", "index0", "revindex", "revindex0", "first", "last", "length")


class Template:
    """A parsed chat template. ``render(**variables)`` → the text."""

    def __init__(self, source: str, globals: Optional[dict] = None):
        self.source = source
        self.body = _parse(_lex(source))
        self.globals = {**GLOBALS, **(globals or {})}

    def render(self, **variables) -> str:
        out: List[str] = []
        root = _Scope(_Scope(None, dict(self.globals)), dict(variables))
        _run(self.body, _Scope(root), out)
        return "".join(out)
