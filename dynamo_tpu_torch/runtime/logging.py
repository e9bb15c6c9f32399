"""Process logging and the W3C ``traceparent`` header the wire carries.

A copy of the JAX package's ``runtime/logging.py`` as far as the wire needs
it: ``init_logging`` / ``get_logger``, and ``TraceParent``'s parse, format
and child span. A request's context carries the caller's ``traceparent`` to
the worker, so a frontend of either package can follow it; the spans
themselves are ``runtime/tracing.py``'s. The JSONL log format
(``DYN_LOGGING_JSONL``) is not ported yet (ROADMAP Queue 1 item 18, second
part).
"""

from __future__ import annotations

import logging
import os
import secrets
import sys
from dataclasses import dataclass
from typing import Mapping, Optional

TRACEPARENT_HEADER = "traceparent"
TRACESTATE_HEADER = "tracestate"


@dataclass
class TraceParent:
    """W3C trace-context carrier."""

    version: int = 0
    trace_id: str = ""
    parent_id: str = ""
    flags: int = 1
    tracestate: Optional[str] = None

    @classmethod
    def new_root(cls) -> "TraceParent":
        return cls(trace_id=secrets.token_hex(16), parent_id=secrets.token_hex(8))

    @classmethod
    def from_header(cls, value: str, tracestate: Optional[str] = None) -> Optional["TraceParent"]:
        try:
            parts = value.strip().split("-")
            if len(parts) != 4:
                return None
            version, trace_id, parent_id, flags = parts
            if len(trace_id) != 32 or len(parent_id) != 16 or set(trace_id) == {"0"}:
                return None
            return cls(
                version=int(version, 16),
                trace_id=trace_id.lower(),
                parent_id=parent_id.lower(),
                flags=int(flags, 16),
                tracestate=tracestate,
            )
        except (ValueError, AttributeError):
            return None

    @classmethod
    def from_headers(cls, headers: Mapping[str, str]) -> Optional["TraceParent"]:
        lowered = {k.lower(): v for k, v in headers.items()}
        tp = lowered.get(TRACEPARENT_HEADER)
        if tp is None:
            return None
        return cls.from_header(tp, lowered.get(TRACESTATE_HEADER))

    def child(self) -> "TraceParent":
        """New span within the same trace."""
        return TraceParent(
            version=self.version,
            trace_id=self.trace_id,
            parent_id=secrets.token_hex(8),
            flags=self.flags,
            tracestate=self.tracestate,
        )

    def to_header(self) -> str:
        return f"{self.version:02x}-{self.trace_id}-{self.parent_id}-{self.flags:02x}"


_INITIALIZED = False


def init_logging(level: Optional[str] = None) -> None:
    """Initialise process logging once; ``DYN_LOG`` sets the level."""
    global _INITIALIZED
    if _INITIALIZED:
        return
    _INITIALIZED = True
    level = level or os.environ.get("DYN_LOG", "INFO")
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname).1s %(name)s %(message)s", datefmt="%H:%M:%S"))
    root = logging.getLogger()
    root.handlers[:] = [handler]
    try:
        root.setLevel(level.upper())
    except ValueError:
        root.setLevel(logging.INFO)


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)
