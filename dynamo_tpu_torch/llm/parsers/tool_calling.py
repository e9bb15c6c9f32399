"""Tool-call extraction from model output text.

Ref surface: lib/parsers/src/tool_calling — formats Json / Pythonic /
Harmony / Typescript / Xml (config.rs:8), named configs hermes /
nemotron_deci / llama3_json / mistral / phi4 / pythonic / harmony /
deepseek_v3_1 / default (parsers.rs:15-29). Each parse returns
``(tool_calls, remaining_content)`` like try_tool_call_parse
(parsers.rs:35+).
"""

from __future__ import annotations

import ast
import json
import re
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class ToolCall:
    """OpenAI-wire tool call (id + function name + JSON-encoded arguments)."""

    name: str
    arguments: str  # JSON string, like OpenAI's function.arguments
    id: str = field(default_factory=lambda: f"call-{uuid.uuid4().hex[:24]}")

    def to_openai(self) -> dict:
        return {
            "id": self.id,
            "type": "function",
            "function": {"name": self.name, "arguments": self.arguments},
        }


@dataclass
class ToolCallConfig:
    format: str = "json"  # json | pythonic | harmony | typescript | xml
    # Markers wrapping a whole parallel-call list (e.g. "<TOOLCALL>[...]</TOOLCALL>").
    list_start: List[str] = field(default_factory=list)
    list_end: List[str] = field(default_factory=list)
    # Markers wrapping each individual call.
    call_start: List[str] = field(default_factory=list)
    call_end: List[str] = field(default_factory=list)
    name_keys: List[str] = field(default_factory=lambda: ["name"])
    arguments_keys: List[str] = field(default_factory=lambda: ["arguments", "parameters"])
    # Parse bare top-level JSON objects with a name key (no markers needed).
    allow_bare_json: bool = True

    def all_start_markers(self) -> List[str]:
        return [m for m in (self.list_start + self.call_start) if m]


def _first_json_value(text: str) -> Tuple[Optional[object], int, int]:
    """Find the first complete JSON object/array in ``text``.

    Returns (value, start, end) or (None, -1, -1). Scans for balanced
    braces/brackets respecting strings — tolerant of surrounding prose, the
    way the reference's find_json parsers behave."""
    decoder = json.JSONDecoder()
    for i, ch in enumerate(text):
        if ch not in "{[":
            continue
        try:
            value, end = decoder.raw_decode(text, i)
        except ValueError:
            continue
        return value, i, end
    return None, -1, -1


def _calls_from_json_value(value: object, config: ToolCallConfig) -> List[ToolCall]:
    items = value if isinstance(value, list) else [value]
    calls: List[ToolCall] = []
    for item in items:
        if not isinstance(item, dict):
            continue
        name = next((item[k] for k in config.name_keys if k in item), None)
        if name is None and isinstance(item.get("function"), dict):
            fn = item["function"]
            name = next((fn[k] for k in config.name_keys if k in fn), None)
            item = fn
        if not isinstance(name, str):
            continue
        args = next((item[k] for k in config.arguments_keys if k in item), {})
        if isinstance(args, str):
            try:
                args = json.loads(args)
            except ValueError:
                pass
        calls.append(ToolCall(name=name, arguments=json.dumps(args)))
    return calls


def _strip_markers(text: str, config: ToolCallConfig) -> Tuple[str, bool]:
    """Remove the outermost list/call markers. Returns (inner, found)."""
    found = False
    for start in sorted(config.list_start + config.call_start, key=len, reverse=True):
        if start and start in text:
            text = text.replace(start, "\n")
            found = True
    for end in sorted(config.list_end + config.call_end, key=len, reverse=True):
        if end and end in text:
            text = text.replace(end, "\n")
    return text, found


def _parse_json_format(text: str, config: ToolCallConfig) -> Tuple[List[ToolCall], Optional[str]]:
    inner, had_markers = _strip_markers(text, config)
    if not had_markers and not config.allow_bare_json:
        return [], text
    calls: List[ToolCall] = []
    content_parts: List[str] = []
    rest = inner
    while rest:
        value, start, end = _first_json_value(rest)
        if value is None:
            content_parts.append(rest)
            break
        parsed = _calls_from_json_value(value, config)
        if parsed:
            calls.extend(parsed)
            content_parts.append(rest[:start])
        else:
            # JSON that isn't a tool call stays in the content.
            content_parts.append(rest[: end])
        rest = rest[end:]
    if not calls:
        return [], text
    content = "".join(content_parts).strip() or None
    return calls, content


_PYTHONIC_CALL = re.compile(r"\[\s*[\w.]+\s*\(.*\)\s*\]", re.DOTALL)


def _parse_pythonic(text: str) -> Tuple[List[ToolCall], Optional[str]]:
    """``[get_weather(city="SF"), get_time(tz="PST")]`` (llama-4 style)."""
    m = _PYTHONIC_CALL.search(text)
    if not m:
        return [], text
    try:
        tree = ast.parse(m.group(0), mode="eval")
    except SyntaxError:
        return [], text
    if not isinstance(tree.body, ast.List):
        return [], text
    calls: List[ToolCall] = []
    for el in tree.body.elts:
        if not isinstance(el, ast.Call):
            return [], text
        name = el.func.attr if isinstance(el.func, ast.Attribute) else getattr(el.func, "id", None)
        if name is None:
            return [], text
        try:
            args = {kw.arg: ast.literal_eval(kw.value) for kw in el.keywords if kw.arg}
        except ValueError:
            return [], text
        calls.append(ToolCall(name=name, arguments=json.dumps(args)))
    content = (text[: m.start()] + text[m.end() :]).strip() or None
    return calls, content


_HARMONY_CALL = re.compile(
    r"<\|channel\|>commentary to=(?:functions\.)?([\w.]+)"
    r".*?<\|message\|>(.*?)(?:<\|call\|>|$)",
    re.DOTALL,
)
_HARMONY_FINAL = re.compile(r"<\|channel\|>final<\|message\|>(.*?)(?:<\|end\|>|<\|return\|>|$)", re.DOTALL)


def _parse_harmony(text: str) -> Tuple[List[ToolCall], Optional[str]]:
    """gpt-oss harmony channels: commentary-to-functions carries the call."""
    calls = []
    for name, payload in _HARMONY_CALL.findall(text):
        value, _, _ = _first_json_value(payload)
        calls.append(ToolCall(name=name, arguments=json.dumps(value if value is not None else {})))
    if not calls:
        return [], text
    final = _HARMONY_FINAL.search(text)
    content = final.group(1).strip() if final else None
    return calls, content or None


_TYPESCRIPT_CALL = re.compile(r"functions\.([\w.]+)\s*\(\s*(\{.*?\})\s*\)", re.DOTALL)


def _parse_typescript(text: str) -> Tuple[List[ToolCall], Optional[str]]:
    """``<function_call>```typescript\nfunctions.f({...})\n``` `` style."""
    calls = []
    for name, payload in _TYPESCRIPT_CALL.findall(text):
        value, _, _ = _first_json_value(payload)
        if value is None:
            continue
        calls.append(ToolCall(name=name, arguments=json.dumps(value)))
    if not calls:
        return [], text
    content = _TYPESCRIPT_CALL.sub("", text)
    content = re.sub(r"<function_call>|```(typescript)?|</function_call>", "", content).strip()
    return calls, content or None


_XML_INVOKE = re.compile(r"<invoke\s+name=\"([^\"]+)\"\s*>(.*?)</invoke>", re.DOTALL)
_XML_PARAM = re.compile(r"<parameter\s+name=\"([^\"]+)\"\s*>(.*?)</parameter>", re.DOTALL)


def _parse_xml(text: str) -> Tuple[List[ToolCall], Optional[str]]:
    calls = []
    for name, body in _XML_INVOKE.findall(text):
        args: Dict[str, object] = {}
        for pname, pval in _XML_PARAM.findall(body):
            pval = pval.strip()
            try:
                args[pname] = json.loads(pval)
            except ValueError:
                args[pname] = pval
        calls.append(ToolCall(name=name, arguments=json.dumps(args)))
    if not calls:
        return [], text
    content = re.sub(r"<function_calls>.*?</function_calls>", "", text, flags=re.DOTALL).strip()
    return calls, content or None


def try_tool_call_parse(text: str, config: ToolCallConfig) -> Tuple[List[ToolCall], Optional[str]]:
    """Parse tool calls out of a complete message. Returns
    ``(calls, normal_content)`` — ``([], text)`` when nothing parses."""
    if config.format == "json":
        return _parse_json_format(text, config)
    if config.format == "pythonic":
        return _parse_pythonic(text)
    if config.format == "harmony":
        return _parse_harmony(text)
    if config.format == "typescript":
        return _parse_typescript(text)
    if config.format == "xml":
        return _parse_xml(text)
    raise ValueError(f"unknown tool-call format: {config.format}")


def detect_tool_call_start(chunk: str, config: ToolCallConfig) -> bool:
    """Could ``chunk`` be the beginning of a tool call? Used by the
    streaming jail — errs on the side of True for any marker prefix."""
    chunk = chunk.lstrip()
    if not chunk:
        return False
    markers = config.all_start_markers()
    if config.format == "pythonic":
        markers = markers + ["["]
    if config.format == "harmony":
        markers = markers + ["<|channel|>"]
    if config.format == "typescript":
        markers = markers + ["<function_call>", "functions."]
    if config.format == "xml":
        markers = markers + ["<function_calls>", "<invoke"]
    if config.format == "json" and config.allow_bare_json:
        markers = markers + ["{", "["]
    for m in markers:
        if chunk.startswith(m) or m.startswith(chunk):
            return True
    return False


# --- named registry (parity with parsers.rs:15-29) --------------------------

PARSER_MAP: Dict[str, ToolCallConfig] = {
    "hermes": ToolCallConfig(
        call_start=["<tool_call>"], call_end=["</tool_call>"], allow_bare_json=False
    ),
    "nemotron_deci": ToolCallConfig(list_start=["<TOOLCALL>"], list_end=["</TOOLCALL>"], allow_bare_json=False),
    "llama3_json": ToolCallConfig(call_start=["<|python_tag|>"], call_end=["<|eom_id|>"]),
    "mistral": ToolCallConfig(list_start=["[TOOL_CALLS]"], list_end=[]),
    "phi4": ToolCallConfig(list_start=["functools"], list_end=[], allow_bare_json=False),
    "deepseek_v3_1": ToolCallConfig(
        call_start=["<｜tool▁call▁begin｜>", "<｜tool▁calls▁begin｜>"],
        call_end=["<｜tool▁call▁end｜>", "<｜tool▁calls▁end｜>"],
        allow_bare_json=False,
    ),
    "pythonic": ToolCallConfig(format="pythonic"),
    "harmony": ToolCallConfig(format="harmony"),
    "typescript": ToolCallConfig(format="typescript"),
    "xml": ToolCallConfig(format="xml"),
    "default": ToolCallConfig(call_start=["<TOOLCALL>", "<|python_tag|>"], call_end=["</TOOLCALL>"]),
}


def get_tool_parser(name: Optional[str]) -> ToolCallConfig:
    key = name if name else "default"
    try:
        return PARSER_MAP[key]
    except KeyError:
        raise ValueError(f"unknown tool parser {key!r}; available: {sorted(PARSER_MAP)}") from None


def get_available_tool_parsers() -> List[str]:
    return sorted(PARSER_MAP)
