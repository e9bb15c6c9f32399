"""Distributed request tracing: spans, events, JSONL and Chrome-trace export.

The JAX package's ``runtime/tracing.py`` in the port, with its file format
field for field, so the repo's ``tools/trace_view.py`` and the JAX package's
``chrome_trace`` read the port's traces and one trace runs across a mixed
deployment of the two packages:

- **Emitters on both sides of the thread boundary.** The scheduler emits
  from the engine's step thread, the HTTP service and the worker's ingress
  from the event loop: records ride a ``queue.SimpleQueue`` that a daemon
  writer thread drains, so ``emit`` never blocks.
- **One trace across processes.** Head sampling is a deterministic function
  of the trace id (crc32), so the frontend, the worker and the scheduler
  reach the same keep/drop decision without talking to each other.
- **Off by default, one branch when off.** ``tracer.enabled`` is a plain
  attribute; the call sites guard on it (or on the sequence's ``trace``
  pair).
- **A ring.** Once configured, the tracer keeps its last ``ring_size``
  records in memory, with or without a file.
- **Tail keep.** With ``tail=True`` a trace that loses the head-sampling
  draw still records into the ring, unexported; ``promote(trace_id)``
  exports it afterwards (the frontend promotes a request that missed its
  SLO).

Span ids follow W3C trace-context: 32-hex trace ids, 16-hex span ids
(``runtime/logging.TraceParent`` carries them on the wire). Configure with
``configure_tracing`` or ``DYN_TRACE_FILE`` / ``DYN_TRACE_SAMPLE`` /
``DYN_TRACE_RING`` / ``DYN_TRACE_TAIL``.
"""

from __future__ import annotations

import json
import os
import queue
import secrets
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

from dynamo_tpu_torch.runtime.logging import TraceParent, get_logger

logger = get_logger(__name__)

TRACE_FILE_ENV = "DYN_TRACE_FILE"
TRACE_SAMPLE_ENV = "DYN_TRACE_SAMPLE"
TRACE_RING_ENV = "DYN_TRACE_RING"
TRACE_TAIL_ENV = "DYN_TRACE_TAIL"

# Default in-memory ring depth once tracing is configured (0 disables).
DEFAULT_RING_SIZE = 256


class Span:
    """An in-flight span. ``end()`` (or the ``with`` block) emits it."""

    __slots__ = ("tracer", "name", "service", "trace_id", "span_id", "parent_id",
                 "start_ns", "attrs", "events", "export", "_done")

    def __init__(self, tracer: "Tracer", name: str, service: str, trace_id: str,
                 parent_id: Optional[str], attrs: Dict[str, Any], export: bool = True):
        self.tracer = tracer
        self.name = name
        self.service = service
        self.trace_id = trace_id
        self.span_id = secrets.token_hex(8)
        self.parent_id = parent_id
        self.start_ns = time.time_ns()
        self.attrs = attrs
        self.events: List[dict] = []
        # False = ring-only (tail mode, trace not head-sampled): the record
        # stays promotable until it ages out of the ring.
        self.export = export
        self._done = False

    def event(self, name: str, **attrs: Any) -> None:
        """Instant event attached to this span's timeline."""
        self.events.append({"name": name, "ts": time.time_ns() / 1e9, **attrs})

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def end(self) -> None:
        if self._done:
            return
        self._done = True
        rec = {
            "kind": "span",
            "name": self.name,
            "service": self.service,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "ts": self.start_ns / 1e9,
            "dur_s": (time.time_ns() - self.start_ns) / 1e9,
        }
        if self.attrs:
            rec["attrs"] = self.attrs
        if self.events:
            rec["events"] = self.events
        self.tracer._put(rec, export=self.export)

    def child_traceparent(self) -> TraceParent:
        """Wire carrier for downstream hops: same trace, this span as parent."""
        return TraceParent(trace_id=self.trace_id, parent_id=self.span_id)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.attrs.setdefault("error", f"{type(exc).__name__}: {exc}")
        self.end()


class _NullSpan:
    """Span stand-in when the trace is not sampled: every op is a no-op."""

    __slots__ = ()

    def event(self, name: str, **attrs: Any) -> None:
        pass

    def set(self, **attrs: Any) -> None:
        pass

    def end(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Process tracer: sampling decision + non-blocking JSONL export.

    ``emit``/``Span.end`` enqueue records on a thread-safe queue; a daemon
    writer thread batches them to disk, so neither the event loop nor the
    engine step thread ever waits on file IO (the perf.py Recorder
    pattern, portable across the thread boundary)."""

    def __init__(self, path: Optional[str] = None, sample: float = 1.0,
                 service: str = "dynamo", ring_size: int = 0, tail: bool = False):
        self.path = path
        self.sample = sample
        self.service = service
        self.ring_size = max(int(ring_size), 0)
        # Tail-based keep: record unsampled traces into the ring so they can
        # be promoted to the export after the fact (SLO violations).
        self.tail = bool(tail) and self.ring_size > 0
        # Ring-only tracing (path=None, ring_size>0) is a valid enabled
        # state: the ring records without any file export configured.
        self.enabled = (path is not None or self.ring_size > 0) and sample > 0.0
        self.events_written = 0
        # Ring entries are mutable {"rec": ..., "exported": bool} cells so
        # promote() can mark what it already shipped (no double-export).
        self._ring: "deque[dict]" = deque(maxlen=self.ring_size or 1)
        self._queue: "queue.SimpleQueue[Optional[dict]]" = queue.SimpleQueue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # --- sampling -----------------------------------------------------------
    def sampled(self, trace_id: str) -> bool:
        """Deterministic head sampling keyed on the trace id: every process
        in the request's path reaches the same decision, so one request is
        either fully traced everywhere or not at all."""
        if not self.enabled:
            return False
        if self.sample >= 1.0:
            return True
        # crc32 over the whole id: stable across processes/runs (unlike
        # hash()) and uniform even for low-entropy ids.
        frac = (zlib.crc32(trace_id.encode()) & 0xFFFFFFFF) / 0xFFFFFFFF
        return frac < self.sample

    def record_allowed(self, trace_id: str) -> bool:
        """Should this trace produce records at all? Head-sampled traces
        export; in tail mode unsampled traces still record into the ring
        (promotable later)."""
        if not self.enabled:
            return False
        return self.tail or self.sampled(trace_id)

    # --- span / event API ---------------------------------------------------
    def span(self, name: str, trace_id: str, parent_id: Optional[str] = None,
             service: Optional[str] = None, **attrs: Any):
        if not self.record_allowed(trace_id):
            return NULL_SPAN
        return Span(self, name, service or self.service, trace_id, parent_id,
                    attrs, export=self.sampled(trace_id))

    def span_from(self, name: str, tp: TraceParent, **attrs: Any):
        """Span continuing a wire TraceParent (its parent_id is the remote
        caller's span)."""
        return self.span(name, tp.trace_id, parent_id=tp.parent_id, **attrs)

    def event(self, name: str, trace_id: str, parent_id: Optional[str] = None,
              service: Optional[str] = None, **attrs: Any) -> None:
        """Instant (zero-duration) event in a trace."""
        if not self.record_allowed(trace_id):
            return
        rec = {
            "kind": "event",
            "name": name,
            "service": service or self.service,
            "trace_id": trace_id,
            "parent_id": parent_id,
            "ts": time.time_ns() / 1e9,
        }
        if attrs:
            rec["attrs"] = attrs
        self._put(rec, export=self.sampled(trace_id))

    # --- ring / tail promotion ----------------------------------------------
    def ring_records(self) -> List[dict]:
        """Snapshot of the in-memory ring, oldest first: the process's
        recent trace records, file or no file."""
        return [cell["rec"] for cell in list(self._ring)]

    def promote(self, trace_id: str) -> int:
        """Export every still-buffered (unexported) record of ``trace_id``
        from the ring — the tail-sampling keep decision. Returns how many
        records were promoted. A no-op without a trace file (the ring alone
        already retains them)."""
        n = 0
        for cell in list(self._ring):
            if cell["exported"] or cell["rec"].get("trace_id") != trace_id:
                continue
            cell["exported"] = True
            n += 1
            if self.path is not None:
                self._queue.put(cell["rec"])
        if n and self.path is not None:
            self._ensure_writer()
        return n

    # --- export plumbing ----------------------------------------------------
    def _put(self, rec: dict, export: bool = True) -> None:
        if self.ring_size:
            self._ring.append({"rec": rec, "exported": export})
        if not export or self.path is None:
            return
        self._queue.put(rec)
        self._ensure_writer()

    def _ensure_writer(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._writer, name="trace-writer", daemon=True
                )
                self._thread.start()

    def _writer(self) -> None:
        with open(self.path, "a") as f:
            while True:
                item = self._queue.get()
                if item is None:
                    return
                batch = [item]
                # Batch whatever is already queued into one write+flush.
                while True:
                    try:
                        nxt = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is None:
                        self._drain(f, batch)
                        return
                    batch.append(nxt)
                self._drain(f, batch)

    def _drain(self, f, batch: List[dict]) -> None:
        for rec in batch:
            f.write(json.dumps(rec) + "\n")
        f.flush()
        self.events_written += len(batch)

    def flush(self, timeout: float = 5.0) -> None:
        """Stop the writer after draining everything queued so far. The next
        emit restarts it — safe to call between requests or at exit."""
        if self._thread is None or not self._thread.is_alive():
            return
        self._queue.put(None)
        self._thread.join(timeout)
        self._thread = None

    def close(self) -> None:
        self.flush()
        self.enabled = False


# --- process-global tracer ---------------------------------------------------

_TRACER = Tracer(path=None, sample=0.0)


def configure_tracing(path: Optional[str] = None, sample: Optional[float] = None,
                      service: Optional[str] = None, ring_size: Optional[int] = None,
                      tail: Optional[bool] = None) -> Tracer:
    """(Re)configure the process tracer. Falls back to ``DYN_TRACE_FILE`` /
    ``DYN_TRACE_SAMPLE`` / ``DYN_TRACE_RING`` / ``DYN_TRACE_TAIL`` env (the
    knobs worker/frontend CLIs expose). The ring defaults ON
    (``DEFAULT_RING_SIZE`` records) so every configured process keeps a
    ring of recent records even with no trace file."""
    global _TRACER
    if path is None:
        path = os.environ.get(TRACE_FILE_ENV) or None
    if sample is None:
        try:
            sample = float(os.environ.get(TRACE_SAMPLE_ENV, "1.0"))
        except ValueError:
            sample = 1.0
    if ring_size is None:
        try:
            ring_size = int(os.environ.get(TRACE_RING_ENV, str(DEFAULT_RING_SIZE)))
        except ValueError:
            ring_size = DEFAULT_RING_SIZE
    if tail is None:
        tail = os.environ.get(TRACE_TAIL_ENV, "").strip().lower() in ("1", "true", "yes", "on")
    _TRACER.flush()
    _TRACER = Tracer(path=path, sample=sample, service=service or _TRACER.service,
                     ring_size=ring_size, tail=tail)
    return _TRACER


def get_tracer() -> Tracer:
    return _TRACER


def add_trace_args(p) -> None:
    """The tracer's flags on an argparse parser: the JAX worker's and
    frontend's."""
    p.add_argument("--trace-file", default=None, help="JSONL span export path (enables tracing)")
    p.add_argument("--trace-sample", type=float, default=None,
                   help="trace sampling ratio in [0,1]; the decision is per trace id (default 1.0)")
    p.add_argument("--trace-ring", type=int, default=None,
                   help="in-memory ring of recent trace records (default 256; 0 disables)")
    p.add_argument("--trace-tail", action="store_true",
                   help="tail keep: unsampled traces record into the ring, so an SLO-violating request can be "
                        "promoted to the export afterwards")


def setup_tracing(args, service: str) -> None:
    """Configure the process tracer from the trace flags or the DYN_TRACE_*
    environment; with neither, tracing stays off."""
    envs = (TRACE_FILE_ENV, TRACE_SAMPLE_ENV, TRACE_RING_ENV, TRACE_TAIL_ENV)
    if (args.trace_file is None and args.trace_sample is None and args.trace_ring is None and not args.trace_tail
            and not any(os.environ.get(k) for k in envs)):
        return
    configure_tracing(path=args.trace_file, sample=args.trace_sample, service=service, ring_size=args.trace_ring,
                      tail=args.trace_tail or None)


# --- readers / exporters -----------------------------------------------------


def read_trace_file(path: str) -> List[dict]:
    """Parse a JSONL trace file, skipping malformed lines (a crash mid-write
    must not make the whole file unreadable)."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def chrome_trace(records: Iterable[dict]) -> dict:
    """Convert span/event records to the Chrome trace-event format (loadable
    in chrome://tracing and Perfetto). Services map to pids; each trace id
    gets its own tid lane so concurrent requests don't interleave."""
    services: Dict[str, int] = {}
    lanes: Dict[str, int] = {}
    events: List[dict] = []

    def pid(service: str) -> int:
        if service not in services:
            services[service] = len(services) + 1
            events.append({
                "ph": "M", "pid": services[service], "name": "process_name",
                "args": {"name": service},
            })
        return services[service]

    def tid(trace_id: str) -> int:
        if trace_id not in lanes:
            lanes[trace_id] = len(lanes) + 1
        return lanes[trace_id]

    for rec in records:
        if rec.get("kind") not in ("span", "event"):
            continue
        base = {
            "pid": pid(rec.get("service") or "dynamo"),
            "tid": tid(rec.get("trace_id") or "?"),
            "name": rec.get("name") or "?",
            "ts": float(rec.get("ts") or 0.0) * 1e6,  # µs
            "args": {
                "trace_id": rec.get("trace_id"),
                "span_id": rec.get("span_id"),
                "parent_id": rec.get("parent_id"),
                **(rec.get("attrs") or {}),
            },
        }
        if rec["kind"] == "span":
            events.append({**base, "ph": "X", "dur": float(rec.get("dur_s") or 0.0) * 1e6})
            for ev in rec.get("events") or []:
                events.append({
                    "ph": "i", "s": "t",
                    "pid": base["pid"], "tid": base["tid"],
                    "name": ev.get("name") or "?",
                    "ts": float(ev.get("ts") or 0.0) * 1e6,
                    "args": {k: v for k, v in ev.items() if k not in ("name", "ts")},
                })
        else:
            events.append({**base, "ph": "i", "s": "t"})
    return {"traceEvents": events, "displayTimeUnit": "ms"}
