"""Streaming tool-call jail + reasoning splitting for the Backend operator.

Ref behavior: the reference's preprocessor "jails" streamed deltas once the
text could be the opening of a tool call, releasing either parsed tool calls
at end-of-stream or the withheld text when it turns out not to be a call
(preprocessor.rs streaming postprocess, SURVEY.md §2b).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from dynamo_tpu_torch.llm.parsers.reasoning import ReasoningParser
from dynamo_tpu_torch.llm.parsers.tool_calling import (
    ToolCall,
    ToolCallConfig,
    detect_tool_call_start,
    try_tool_call_parse,
)


@dataclass
class StreamingToolCallJail:
    """Feed text deltas; withholds anything that might be a tool call.

    ``feed`` returns the text safe to stream now. Once jailed, nothing
    streams until ``finish``, which parses the held text into tool calls
    (or releases it verbatim when parsing fails).
    """

    config: ToolCallConfig
    reasoning: Optional[ReasoningParser] = None

    _jailed: bool = field(default=False, init=False)
    _held: str = field(default="", init=False)
    _reasoning_parts: List[str] = field(default_factory=list, init=False)

    def feed(self, delta: str) -> Tuple[str, str]:
        """Returns (reasoning_delta, content_delta) safe to emit now."""
        r_delta = ""
        if self.reasoning is not None:
            r_delta, delta = self.reasoning.feed(delta)
        if self._jailed:
            self._held += delta
            return r_delta, ""
        candidate = self._held + delta
        if detect_tool_call_start(candidate, self.config):
            self._jailed = True
            self._held = candidate
            return r_delta, ""
        # Hold a whitespace-only tail: a marker could still start after it.
        if candidate.strip() == "":
            self._held = candidate
            return r_delta, ""
        self._held = ""
        return r_delta, candidate

    def finish(self) -> Tuple[str, str, List[ToolCall]]:
        """End of stream → (reasoning_tail, content_tail, tool_calls)."""
        r_tail = ""
        if self.reasoning is not None:
            rr, cc = self.reasoning.flush()
            r_tail = rr
            self._held += cc
        held, self._held = self._held, ""
        if not held:
            return r_tail, "", []
        if self._jailed:
            calls, content = try_tool_call_parse(held, self.config)
            if calls:
                return r_tail, content or "", calls
        return r_tail, held, []
