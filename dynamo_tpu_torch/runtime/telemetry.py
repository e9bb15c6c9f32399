"""Streaming latency telemetry: mergeable percentile digests, SLO and goodput
accounting, and the engine stall watchdog.

The JAX package's ``runtime/telemetry.py`` in the port. The digest is a
DDSketch-style log-bucketed sketch:

- **Fixed relative error.** Bucket ``i`` covers ``(γ^(i-1), γ^i]`` with
  ``γ = (1+α)/(1-α)``; its midpoint is within relative error ``α`` of every
  sample in it.
- **Mergeable.** Two sketches of one ``α`` share their bucket boundaries,
  so ``merge`` is bucket-wise addition, and equals the sketch of the two
  streams together: an aggregator computes fleet quantiles from the
  workers' snapshots.
- **One wire.** ``to_wire``/``from_wire`` are the JAX package's byte for
  byte, so a JAX aggregator merges a port worker's ``digests`` and the
  reverse.

Everything here is host-side Python: observing a sample is a dict update and
one ``math.log``; no device work. ``DigestCollector`` renders digests
through the port's own registry (``runtime/metrics.py``).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.metrics import MetricFamily

logger = get_logger(__name__)

# Default relative error: 1% keeps the sketch small (a 9-decade latency
# range spans ~1000 buckets worst case; real streams touch a few dozen).
DEFAULT_RELATIVE_ERROR = 0.01

# Values below this are clamped into the zero bucket (sub-nanosecond
# latencies are measurement noise, and log() needs a positive floor).
_MIN_TRACKABLE = 1e-9


class LatencyDigest:
    """DDSketch-style log-bucketed quantile sketch (sparse buckets)."""

    __slots__ = ("relative_error", "_gamma", "_log_gamma", "buckets",
                 "zero_count", "count", "sum", "min", "max")

    def __init__(self, relative_error: float = DEFAULT_RELATIVE_ERROR):
        if not 0.0 < relative_error < 1.0:
            raise ValueError(f"relative_error must be in (0, 1), got {relative_error}")
        self.relative_error = relative_error
        self._gamma = (1.0 + relative_error) / (1.0 - relative_error)
        self._log_gamma = math.log(self._gamma)
        self.buckets: Dict[int, int] = {}
        self.zero_count = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = 0.0

    # --- recording ----------------------------------------------------------
    def observe(self, value: float) -> None:
        self.count += 1
        if value <= _MIN_TRACKABLE:
            self.zero_count += 1
            if value > 0:
                self.sum += value
            self.min = min(self.min, max(value, 0.0))
            return
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        key = math.ceil(math.log(value) / self._log_gamma)
        self.buckets[key] = self.buckets.get(key, 0) + 1

    # --- queries ------------------------------------------------------------
    def _bucket_value(self, key: int) -> float:
        # Midpoint of (γ^(k-1), γ^k]: within relative_error of any sample
        # that landed in the bucket.
        return 2.0 * (self._gamma ** key) / (self._gamma + 1.0)

    def quantile(self, q: float) -> float:
        """q in [0, 1]. Returns 0.0 on an empty digest."""
        if self.count == 0:
            return 0.0
        q = min(max(q, 0.0), 1.0)
        rank = q * (self.count - 1)
        if rank < self.zero_count:
            return 0.0
        seen = self.zero_count
        for key in sorted(self.buckets):
            seen += self.buckets[key]
            if seen > rank:
                return self._bucket_value(key)
        return self._bucket_value(max(self.buckets)) if self.buckets else 0.0

    def percentiles(self, qs: Sequence[float] = (0.5, 0.9, 0.99)) -> List[float]:
        return [self.quantile(q) for q in qs]

    def rank(self, value: float) -> float:
        """Fraction of observed samples ≤ ``value`` — a value's percentile
        position in the distribution (the inverse of ``quantile``). The
        autopsy uses this for fleet context: "this request's 480 ms queue
        wait sits at p99.7 of the window"."""
        if self.count == 0:
            return 0.0
        seen = self.zero_count
        for key, n in sorted(self._buckets_snapshot().items()):
            if self._bucket_value(key) <= value:
                seen += n
            else:
                break
        return seen / self.count

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def histogram(self, bounds: Sequence[float]) -> Tuple[List[int], float]:
        """Cumulative counts ≤ each bound plus the total (the +Inf count) —
        the shape a native Prometheus histogram family wants. Bucket
        contents are attributed at their midpoint estimate."""
        cum = [0] * len(bounds)
        items = sorted(self.buckets.items())
        for i, b in enumerate(bounds):
            c = self.zero_count
            for key, n in items:
                if self._bucket_value(key) <= b:
                    c += n
                else:
                    break
            cum[i] = c
        return cum, float(self.count)

    # --- merge / wire -------------------------------------------------------
    def _buckets_snapshot(self) -> Dict[int, int]:
        """Copy of the bucket map, safe against a concurrent observe() on
        another thread (a new key landing mid-iteration raises
        RuntimeError; monitoring reads just retry)."""
        for _ in range(8):
            try:
                return dict(self.buckets)
            except RuntimeError:
                continue
        return dict(self.buckets)

    def merge(self, other: "LatencyDigest") -> "LatencyDigest":
        """In-place bucket-wise merge. Digests must share relative_error so
        bucket boundaries align (merge is then exact: merge(a,b) equals the
        single-stream digest)."""
        if abs(other.relative_error - self.relative_error) > 1e-12:
            raise ValueError(
                f"cannot merge digests with different relative error "
                f"({self.relative_error} vs {other.relative_error})"
            )
        for key, n in other._buckets_snapshot().items():
            self.buckets[key] = self.buckets.get(key, 0) + n
        self.zero_count += other.zero_count
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def to_wire(self) -> dict:
        return {
            "re": self.relative_error,
            "zero": self.zero_count,
            "count": self.count,
            "sum": round(self.sum, 9),
            "min": self.min if math.isfinite(self.min) else None,
            "max": self.max,
            # String keys: strict msgpack unpackers reject int map keys,
            # and JSON stringifies them anyway — from_wire accepts both.
            "buckets": {str(k): v for k, v in self._buckets_snapshot().items()},
        }

    @classmethod
    def from_wire(cls, d: dict) -> "LatencyDigest":
        out = cls(relative_error=float(d.get("re", DEFAULT_RELATIVE_ERROR)))
        out.zero_count = int(d.get("zero", 0))
        out.count = int(d.get("count", 0))
        out.sum = float(d.get("sum", 0.0))
        mn = d.get("min")
        out.min = math.inf if mn is None else float(mn)
        out.max = float(d.get("max", 0.0))
        out.buckets = {int(k): int(v) for k, v in (d.get("buckets") or {}).items()}
        return out


class WindowedDigest:
    """Rolling view over a stream: a ring of per-interval digests plus a
    cumulative all-time digest.

    ``snapshot()`` merges the live intervals — "the last ~window_s seconds"
    — which is what quantile *gauges* should report (an all-time p99 never
    recovers from one bad minute). ``total`` stays monotonic, which is what
    Prometheus *histogram* export needs."""

    def __init__(
        self,
        relative_error: float = DEFAULT_RELATIVE_ERROR,
        window_s: float = 60.0,
        slices: int = 6,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.relative_error = relative_error
        self.window_s = window_s
        self.slices = max(slices, 1)
        self._slice_s = window_s / self.slices
        self._clock = clock
        self._ring: deque = deque(
            [LatencyDigest(relative_error) for _ in range(self.slices)], maxlen=self.slices
        )
        self._slice_start = clock()
        self.total = LatencyDigest(relative_error)

    def _rotate(self, now: float) -> None:
        elapsed = now - self._slice_start
        if elapsed < self._slice_s:
            return
        steps = min(int(elapsed / self._slice_s), self.slices)
        for _ in range(steps):
            self._ring.append(LatencyDigest(self.relative_error))
        self._slice_start = now

    def observe(self, value: float) -> None:
        now = self._clock()
        self._rotate(now)
        self._ring[-1].observe(value)
        self.total.observe(value)

    def snapshot(self) -> LatencyDigest:
        self._rotate(self._clock())
        out = LatencyDigest(self.relative_error)
        for d in self._ring:
            out.merge(d)
        return out

    def to_wire(self) -> dict:
        """{"window": ..., "total": ...} — the window snapshot feeds fleet
        quantile gauges, the cumulative digest feeds the monotone Prometheus
        histogram export."""
        return {"window": self.snapshot().to_wire(), "total": self.total.to_wire()}


class Telemetry:
    """A named set of windowed digests — one per latency stream (ttft, tpot,
    itl, queue_wait, per-phase step durations, ...). Owned by a scheduler /
    mocker / frontend; exported through the stats scrape as one nested
    ``digests`` dict."""

    def __init__(
        self,
        relative_error: float = DEFAULT_RELATIVE_ERROR,
        window_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.relative_error = relative_error
        self.window_s = window_s
        self._clock = clock
        self._digests: Dict[str, WindowedDigest] = {}
        # Digest creation can race (scheduler thread vs event loop scrape);
        # observes on an existing digest are GIL-atomic enough for
        # monitoring data.
        self._lock = threading.Lock()

    def digest(self, name: str) -> WindowedDigest:
        d = self._digests.get(name)
        if d is None:
            with self._lock:
                d = self._digests.setdefault(
                    name,
                    WindowedDigest(self.relative_error, self.window_s, clock=self._clock),
                )
        return d

    def observe(self, name: str, value: float) -> None:
        self.digest(name).observe(value)

    def names(self) -> List[str]:
        return sorted(self._digests)

    def to_wire(self) -> Dict[str, dict]:
        return {name: d.to_wire() for name, d in list(self._digests.items())}

    def summary(self, qs: Sequence[float] = (0.5, 0.9, 0.99)) -> Dict[str, dict]:
        """Human-oriented snapshot (the /debug/state digest block)."""
        out = {}
        for name, d in list(self._digests.items()):
            snap = d.snapshot()
            out[name] = {
                "count": d.total.count,
                "window_count": snap.count,
                **{f"p{int(q * 100)}": round(snap.quantile(q), 6) for q in qs},
                "mean": round(snap.mean, 6),
                "max": round(snap.max, 6),
            }
        return out


# --- SLO / goodput accounting -----------------------------------------------

class SloConfig:
    """Per-request latency targets. ``None`` disables judging a phase."""

    __slots__ = ("ttft_ms", "tpot_ms")

    def __init__(self, ttft_ms: Optional[float] = None, tpot_ms: Optional[float] = None):
        self.ttft_ms = ttft_ms
        self.tpot_ms = tpot_ms

    @property
    def enabled(self) -> bool:
        return self.ttft_ms is not None or self.tpot_ms is not None


class SloJudge:
    """Judges each finished request against the SLO targets and keeps the
    goodput account: requests (and their tokens) that met EVERY configured
    target. Counters are monotonic; the per-second gauges are computed over
    a short rolling window so they read as live rates."""

    def __init__(self, config: SloConfig, clock: Callable[[], float] = time.monotonic,
                 rate_window_s: float = 30.0):
        self.config = config
        self._clock = clock
        self.rate_window_s = rate_window_s
        self.attained = {"ttft": 0, "tpot": 0}
        self.violated = {"ttft": 0, "tpot": 0}
        self.goodput_requests_total = 0
        self.goodput_tokens_total = 0
        self.requests_total = 0
        self._recent: deque = deque()  # (ts, good_requests, good_tokens)

    def judge(self, ttft_s: Optional[float], tpot_s: Optional[float], n_tokens: int) -> bool:
        """Returns True when the request attained every configured target.
        A phase with no measurement (e.g. single-token request has no TPOT)
        is not judged."""
        if not self.config.enabled:
            return True
        self.requests_total += 1
        good = True
        if self.config.ttft_ms is not None and ttft_s is not None:
            if ttft_s * 1000.0 <= self.config.ttft_ms:
                self.attained["ttft"] += 1
            else:
                self.violated["ttft"] += 1
                good = False
        if self.config.tpot_ms is not None and tpot_s is not None:
            if tpot_s * 1000.0 <= self.config.tpot_ms:
                self.attained["tpot"] += 1
            else:
                self.violated["tpot"] += 1
                good = False
        if good:
            self.goodput_requests_total += 1
            self.goodput_tokens_total += n_tokens
            self._recent.append((self._clock(), 1, n_tokens))
        else:
            self._recent.append((self._clock(), 0, 0))
        return good

    def _trim(self) -> None:
        horizon = self._clock() - self.rate_window_s
        while self._recent and self._recent[0][0] < horizon:
            self._recent.popleft()

    def goodput_rates(self) -> Tuple[float, float]:
        """(SLO-attained req/s, tok/s) over the rolling window."""
        self._trim()
        if not self._recent:
            return 0.0, 0.0
        span = max(self._clock() - self._recent[0][0], 1e-6)
        reqs = sum(r for _, r, _ in self._recent)
        toks = sum(t for _, _, t in self._recent)
        return reqs / span, toks / span

    def attainment(self) -> float:
        """Fraction of judged phase checks that attained, 1.0 with no data."""
        a = sum(self.attained.values())
        v = sum(self.violated.values())
        return a / (a + v) if (a + v) else 1.0

    def to_stats(self) -> dict:
        """Flat keys for the worker stats scrape (COUNTER_KEYS names)."""
        req_s, tok_s = self.goodput_rates()
        return {
            "slo_ttft_attained_total": self.attained["ttft"],
            "slo_ttft_violated_total": self.violated["ttft"],
            "slo_tpot_attained_total": self.attained["tpot"],
            "slo_tpot_violated_total": self.violated["tpot"],
            "goodput_requests_total": self.goodput_requests_total,
            "goodput_tokens_total": self.goodput_tokens_total,
            "slo_attainment": round(self.attainment(), 6),
            "goodput_req_per_s": round(req_s, 6),
            "goodput_tok_per_s": round(tok_s, 6),
        }


# --- stall watchdog ----------------------------------------------------------

class StallWatchdog:
    """Detects a wedged step loop: work is queued but the engine has not
    completed a step for ``stall_after_s``. Evaluated lazily at probe time
    (``check()``) — no background thread, deterministic under a
    monkeypatched clock — and called from the stats scrape and the health
    endpoint, both of which poll anyway.

    ``probe`` returns ``(has_work, last_step_ts)`` where ``last_step_ts``
    is the clock time the last engine step completed (None = no step yet;
    the reference point is then the watchdog's own start)."""

    def __init__(
        self,
        probe: Callable[[], Tuple[bool, Optional[float]]],
        stall_after_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.probe = probe
        self.stall_after_s = stall_after_s
        self._clock = clock
        self._start_ts = clock()
        # check() is called from every poller (stats scrape on the event
        # loop, the health server's thread, bench loops): the transition
        # edge must fire its counter exactly once.
        self._check_lock = threading.Lock()
        self.stalled = False  # guarded-by: _check_lock
        self.stalls_total = 0  # guarded-by: _check_lock

    def last_step_age_s(self) -> float:
        _, last = self.probe()
        ref = self._start_ts if last is None else last
        return max(self._clock() - ref, 0.0)

    def check(self) -> bool:
        """Re-evaluate; returns the current stalled state. Fires the log +
        counter only on the not-stalled → stalled transition."""
        has_work, last = self.probe()
        ref = self._start_ts if last is None else last
        now_stalled = bool(has_work) and (self._clock() - ref) > self.stall_after_s
        with self._check_lock:
            if now_stalled and not self.stalled:
                self.stalls_total += 1
                logger.error(
                    "engine_stalled: step loop has not advanced for %.1fs with work queued",
                    self._clock() - ref,
                )
            self.stalled = now_stalled
        return now_stalled

    def to_stats(self) -> dict:
        stalled = self.check()
        return {
            "engine_stalled": 1.0 if stalled else 0.0,
            "engine_stalls_total": self.stalls_total,
            "last_step_age_s": round(self.last_step_age_s(), 3),
        }


# --- Prometheus export --------------------------------------------------------

# Fixed bounds for the native-histogram re-export of merged digests: latency
# scales from sub-ms engine steps to minute-long requests. (Digest buckets
# are re-attributed at their midpoints; with α=1% the attribution error is
# far below the bound spacing.)
DIGEST_HISTOGRAM_BOUNDS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

DIGEST_QUANTILES: Tuple[float, ...] = (0.5, 0.9, 0.99)


class DigestCollector:
    """A registry collector (``runtime/metrics.CollectorRegistry``) rendering a set of digests as
    native histogram families (from the cumulative digests — monotone, so
    PromQL ``histogram_quantile``/``rate`` behave) plus quantile gauges
    (from the windowed snapshots — live percentiles without PromQL math).

    Families: ``<prefix><name>_seconds`` (histogram) and
    ``<prefix><name>_seconds_quantile{quantile="0.5|0.9|0.99"}`` (gauge)."""

    def __init__(self, prefix: str, registry=None, telemetry: Optional[Telemetry] = None):
        self.prefix = prefix
        # name -> (window LatencyDigest, total LatencyDigest)
        self._digests: Dict[str, Tuple[LatencyDigest, LatencyDigest]] = {}
        self._lock = threading.Lock()
        # Live mode: read digests straight from a local Telemetry at collect
        # time (the frontend's own e2e digests); otherwise update() /
        # update_from_wire() push merged fleet digests (the aggregator).
        self._telemetry = telemetry
        if registry is not None:
            registry.register(self)

    def update(self, merged: Dict[str, Tuple[LatencyDigest, LatencyDigest]]) -> None:
        """Replace the exported set with freshly merged (window, total)
        digest pairs."""
        with self._lock:
            self._digests = dict(merged)

    def update_from_wire(self, per_worker: Iterable[Dict[str, dict]]) -> None:
        """Merge per-worker ``Telemetry.to_wire()`` payloads into fleet
        digests and export them."""
        merged: Dict[str, Tuple[LatencyDigest, LatencyDigest]] = {}
        for wires in per_worker:
            for name, pair in (wires or {}).items():
                try:
                    win = LatencyDigest.from_wire(pair["window"])
                    tot = LatencyDigest.from_wire(pair["total"])
                except (KeyError, TypeError, ValueError):
                    continue
                if name in merged:
                    merged[name][0].merge(win)
                    merged[name][1].merge(tot)
                else:
                    merged[name] = (win, tot)
        self.update(merged)

    def collect(self):
        if self._telemetry is not None:
            digests = {
                name: (self._telemetry.digest(name).snapshot(), self._telemetry.digest(name).total)
                for name in self._telemetry.names()
            }
        else:
            with self._lock:
                digests = dict(self._digests)
        for name, (window, total) in sorted(digests.items()):
            full = f"{self.prefix}{name}_seconds"
            cum, count = total.histogram(DIGEST_HISTOGRAM_BOUNDS)
            hist = MetricFamily(full, "histogram", f"fleet-merged {name} latency digest (cumulative)")
            for b, c in zip(DIGEST_HISTOGRAM_BOUNDS, cum):
                hist.add_sample(full + "_bucket", {"le": str(b)}, float(c))
            hist.add_sample(full + "_bucket", {"le": "+Inf"}, count)
            hist.add_sample(full + "_count", {}, count)
            hist.add_sample(full + "_sum", {}, total.sum)
            yield hist
            g = MetricFamily(f"{full}_quantile", "gauge", f"fleet-merged {name} quantiles over the rolling window")
            for q in DIGEST_QUANTILES:
                g.add_sample(f"{full}_quantile", {"quantile": str(q)}, window.quantile(q))
            yield g

    def describe(self):
        # Unchecked collector: families vary with the digest set.
        return []
