"""Stream perf capture and JSONL event recording.

The JAX package's ``llm/perf.py`` in the port: ``record_stream`` wraps an
async response stream and stamps each item with a monotonic ns clock as it
passes (``RecordedStream``: TTFT and inter-token latencies, analysed after
the stream closes); ``Recorder`` appends events to a JSONL file from a
background task, off the hot path; ``KvRecorder`` taps a worker's KV event
stream (``kv_events_stream_name``) into a ``Recorder`` for replayable
router traces; ``analyze_logprobs`` gives a sequence's perplexity and
logprob extremes.
"""

from __future__ import annotations

import asyncio
import json
import math
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Dict, List, Optional

from dynamo_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)


# ---------------------------------------------------------------------------
# Stream timestamping (perf.rs)
# ---------------------------------------------------------------------------


@dataclass
class TimestampedResponse:
    """One stream item + its arrival time (ref: perf.rs:32)."""

    data: Any
    t_ns: int
    seq: int


@dataclass
class RecordedStream:
    """Accumulates timestamps while a stream flows; analysis afterwards."""

    start_ns: int = field(default_factory=time.perf_counter_ns)
    responses: List[TimestampedResponse] = field(default_factory=list)

    def append(self, data: Any) -> None:
        self.responses.append(TimestampedResponse(data, time.perf_counter_ns(), len(self.responses)))

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first response (the TTFT histogram's input)."""
        if not self.responses:
            return None
        return (self.responses[0].t_ns - self.start_ns) / 1e9

    @property
    def itls_s(self) -> List[float]:
        """Inter-token latencies between consecutive responses."""
        ts = [r.t_ns for r in self.responses]
        return [(b - a) / 1e9 for a, b in zip(ts, ts[1:])]

    @property
    def duration_s(self) -> float:
        if not self.responses:
            return 0.0
        return (self.responses[-1].t_ns - self.start_ns) / 1e9

    def summarize(self) -> Dict[str, Any]:
        itls = self.itls_s
        return {
            "responses": len(self.responses),
            "ttft_s": self.ttft_s,
            "duration_s": self.duration_s,
            "itl_mean_s": sum(itls) / len(itls) if itls else None,
            "itl_p50_s": _quantile(itls, 0.5),
            "itl_p99_s": _quantile(itls, 0.99),
        }


def _quantile(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    ys = sorted(xs)
    idx = min(int(q * len(ys)), len(ys) - 1)
    return ys[idx]


async def record_stream(stream: AsyncIterator, recorded: Optional[RecordedStream] = None):
    """Wrap ``stream``: yields items unchanged while stamping arrivals into a
    ``RecordedStream``. Usage::

        rec = RecordedStream()
        async for item in record_stream(engine.generate(...), rec):
            ...
        print(rec.summarize())
    """
    rec = recorded if recorded is not None else RecordedStream()
    async for item in stream:
        rec.append(item)
        yield item


# ---------------------------------------------------------------------------
# JSONL event recorder (recorder.rs)
# ---------------------------------------------------------------------------


class Recorder:
    """Append events to a JSONL file off the hot path (ref: recorder.rs:26).

    ``emit`` is synchronous and non-blocking: events go to an unbounded
    queue; a background task serializes and writes them. ``close`` drains."""

    def __init__(self, path: str):
        self.path = path
        self._queue: "asyncio.Queue[Optional[dict]]" = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self.events_written = 0

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._writer())

    def emit(self, event: str, **data: Any) -> None:
        self._queue.put_nowait({"ts": time.time(), "event": event, **data})

    async def _writer(self) -> None:
        loop = asyncio.get_running_loop()
        with open(self.path, "a") as f:
            while True:
                item = await self._queue.get()
                stop = item is None
                # Batch whatever is already queued into one write.
                batch = [] if stop else [item]
                while not self._queue.empty():
                    nxt = self._queue.get_nowait()
                    if nxt is None:
                        stop = True
                        break
                    batch.append(nxt)
                if batch:
                    # File IO off the event loop: a slow disk must not stall
                    # in-flight request streams.
                    await loop.run_in_executor(None, self._drain_batch, f, batch)
                if stop:
                    return

    def _drain_batch(self, f, batch: List[dict]) -> None:
        for ev in batch:
            f.write(json.dumps(ev) + "\n")
        f.flush()
        self.events_written += len(batch)

    async def close(self) -> None:
        if self._task is not None:
            self._queue.put_nowait(None)
            await self._task
            self._task = None


class KvRecorder:
    """Tap a worker's KV event stream into a Recorder (ref:
    kv_router/recorder.rs) — replayable traces for router tuning."""

    def __init__(self, drt, namespace: str, component: str, recorder: Recorder):
        from dynamo_tpu_torch.llm.kv_router.publisher import kv_events_stream_name

        self.drt = drt
        self.stream_name = kv_events_stream_name(namespace, component)
        self.recorder = recorder
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()

    async def start(self, from_seq: int = 1) -> None:
        stream = await self.drt.bus.stream(self.stream_name)

        async def loop():
            it = stream.consume(from_seq)
            while not self._stop.is_set():
                nxt = asyncio.ensure_future(anext(it))
                stop = asyncio.ensure_future(self._stop.wait())
                done, pending = await asyncio.wait({nxt, stop}, return_when=asyncio.FIRST_COMPLETED)
                for t in pending:
                    t.cancel()
                await asyncio.gather(*pending, return_exceptions=True)
                if nxt in done and nxt.exception() is None:
                    msg = nxt.result()
                    try:
                        payload = json.loads(msg.data)
                    except ValueError:
                        payload = {"raw": msg.data.hex()}
                    self.recorder.emit("kv_event", seq=msg.seq, **payload)
                else:
                    return

        self._task = asyncio.get_running_loop().create_task(loop())

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            await self._task
            self._task = None


# ---------------------------------------------------------------------------
# Logprobs analysis (perf/logprobs.rs)
# ---------------------------------------------------------------------------


def analyze_logprobs(token_logprobs: List[float]) -> Dict[str, Any]:
    """Sequence-level stats over per-token logprobs: perplexity and
    uncertainty markers (ref: perf/logprobs.rs)."""
    if not token_logprobs:
        return {"tokens": 0, "perplexity": None, "mean_logprob": None, "min_logprob": None}
    n = len(token_logprobs)
    mean_lp = sum(token_logprobs) / n
    return {
        "tokens": n,
        "perplexity": math.exp(-mean_lp),
        "mean_logprob": mean_lp,
        "min_logprob": min(token_logprobs),
    }
