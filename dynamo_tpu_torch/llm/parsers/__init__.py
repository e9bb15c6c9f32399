"""Tool-call + reasoning parsers (ref: lib/parsers/src/{tool_calling,reasoning},
SURVEY.md §2 N6).

The reference ships per-format Rust parsers behind a name registry
(tool_calling/parsers.rs:15 ``get_tool_parser_map``). Here the same surface
is config-driven: one JSON extractor + one pythonic extractor + one harmony
extractor, parameterized by :class:`ToolCallConfig` (start/end markers, name
and argument keys). Streaming gets a *jail*: once a chunk looks like the
start of a tool call, deltas are withheld until the call parses or the
stream ends (ref: preprocessor.rs tool-call jail behavior).

A copy of the JAX package's ``llm/parsers`` (pure Python), kept apart so
the port imports nothing of that package.
"""

from dynamo_tpu_torch.llm.parsers.tool_calling import (
    ToolCallConfig,
    ToolCall,
    detect_tool_call_start,
    get_available_tool_parsers,
    get_tool_parser,
    try_tool_call_parse,
)
from dynamo_tpu_torch.llm.parsers.reasoning import (
    ReasoningParser,
    ReasoningResult,
    get_available_reasoning_parsers,
    get_reasoning_parser,
)
from dynamo_tpu_torch.llm.parsers.stream import StreamingToolCallJail

__all__ = [
    "ToolCall",
    "ToolCallConfig",
    "detect_tool_call_start",
    "get_available_tool_parsers",
    "get_tool_parser",
    "try_tool_call_parse",
    "ReasoningParser",
    "ReasoningResult",
    "get_available_reasoning_parsers",
    "get_reasoning_parser",
    "StreamingToolCallJail",
]
