"""Reasoning-block parsers: split model output into reasoning vs content.

Ref surface: lib/parsers/src/reasoning (base_parser.rs marker splitting;
mod.rs:81 ReasoningParserType — DeepseekR1 / Basic / Qwen / Mistral / Kimi /
Step3 / NemotronDeci / GptOss). Incremental: feed deltas, get
(reasoning_delta, content_delta) back; a truncated stream counts everything
after the start marker as reasoning.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class ReasoningResult:
    reasoning: str = ""
    content: str = ""


@dataclass
class ReasoningParser:
    think_start: str = "<think>"
    think_end: str = "</think>"
    # DeepSeek-R1-style models open the response already inside reasoning
    # (the template emits the start marker before generation).
    starts_in_reasoning: bool = False

    _in_reasoning: bool = field(default=False, init=False)
    _buffer: str = field(default="", init=False)
    _started: bool = field(default=False, init=False)

    def __post_init__(self):
        self._in_reasoning = self.starts_in_reasoning

    # --- one-shot ----------------------------------------------------------
    def parse(self, text: str) -> ReasoningResult:
        """Parse a complete message."""
        p = ReasoningParser(self.think_start, self.think_end, self.starts_in_reasoning)
        r, c = p.feed(text)
        rr, cc = p.flush()
        return ReasoningResult(reasoning=r + rr, content=c + cc)

    # --- streaming ---------------------------------------------------------
    def feed(self, delta: str) -> Tuple[str, str]:
        """Feed a text delta; returns (reasoning_delta, content_delta).
        Holds back marker-prefix-ambiguous tails until resolved."""
        self._buffer += delta
        reasoning_out: List[str] = []
        content_out: List[str] = []
        while True:
            marker = self.think_end if self._in_reasoning else self.think_start
            idx = self._buffer.find(marker)
            if idx >= 0:
                seg = self._buffer[:idx]
                (reasoning_out if self._in_reasoning else content_out).append(seg)
                self._buffer = self._buffer[idx + len(marker) :]
                self._in_reasoning = not self._in_reasoning
                continue
            # No full marker: emit all but a potential marker prefix at the tail.
            keep = 0
            for k in range(min(len(marker) - 1, len(self._buffer)), 0, -1):
                if marker.startswith(self._buffer[-k:]):
                    keep = k
                    break
            emit = self._buffer[: len(self._buffer) - keep]
            self._buffer = self._buffer[len(self._buffer) - keep :]
            if emit:
                (reasoning_out if self._in_reasoning else content_out).append(emit)
            break
        return "".join(reasoning_out), "".join(content_out)

    def flush(self) -> Tuple[str, str]:
        """End of stream: release any held-back tail."""
        emit, self._buffer = self._buffer, ""
        return (emit, "") if self._in_reasoning else ("", emit)


class HarmonyReasoningParser(ReasoningParser):
    """gpt-oss: reasoning rides the ``analysis`` channel, the answer the
    ``final`` channel (ref: reasoning/gpt_oss_parser.rs)."""

    _ANALYSIS = re.compile(r"<\|channel\|>analysis<\|message\|>(.*?)(?:<\|end\|>|$)", re.DOTALL)
    _FINAL = re.compile(r"<\|channel\|>final<\|message\|>(.*?)(?:<\|end\|>|<\|return\|>|$)", re.DOTALL)

    def parse(self, text: str) -> ReasoningResult:
        reasoning = "".join(m for m in self._ANALYSIS.findall(text))
        final = self._FINAL.search(text)
        content = final.group(1) if final else ""
        if not reasoning and not final:
            return ReasoningResult(reasoning="", content=text)
        return ReasoningResult(reasoning=reasoning.strip(), content=content.strip())

    def feed(self, delta: str) -> Tuple[str, str]:  # buffered: channels interleave
        self._buffer += delta
        return "", ""

    def flush(self) -> Tuple[str, str]:
        result = self.parse(self._buffer)
        self._buffer = ""
        return result.reasoning, result.content


_REGISTRY: Dict[str, Tuple[type, dict]] = {
    "basic": (ReasoningParser, {}),
    "deepseek_r1": (ReasoningParser, {"starts_in_reasoning": True}),
    "qwen": (ReasoningParser, {}),
    "step3": (ReasoningParser, {"starts_in_reasoning": True}),
    "nemotron_deci": (ReasoningParser, {}),
    "kimi": (ReasoningParser, {"think_start": "◁think▷", "think_end": "◁/think▷"}),
    "mistral": (ReasoningParser, {"think_start": "[THINK]", "think_end": "[/THINK]"}),
    "gpt_oss": (HarmonyReasoningParser, {}),
}


def get_reasoning_parser(name: Optional[str]) -> ReasoningParser:
    key = name if name else "basic"
    try:
        cls, kwargs = _REGISTRY[key]
    except KeyError:
        raise ValueError(f"unknown reasoning parser {key!r}; available: {sorted(_REGISTRY)}") from None
    return cls(**kwargs)


def get_available_reasoning_parsers() -> List[str]:
    return sorted(_REGISTRY)
