"""Device-truth profiling: on-demand captures, a continuous sampler, and a
stdlib trace-event parser.

The JAX package's ``runtime/profiling.py`` in the port, on
``torch.profiler`` where JAX uses ``jax.profiler``:

- ``DeviceProfiler`` opens ``torch.profiler.profile`` windows: CUDA
  activity (CUPTI: every kernel of the process, CUDA-graph replays
  included) on a CUDA engine, CPU activity only on an engine the caller put
  on the CPU. The profiler is process-global, so every capture path
  (``POST /debug/profile``, incident captures, the continuous sampler)
  serialises through one capture lock; a caller that will not wait gets a
  "busy" answer and the collision counts in ``capture_conflicts_total``.
  A ``guard`` lock, the scheduler's step-graph capture lock, is held for
  the window, so no profiler window overlaps a graph capture. The trace is
  written as ``<path>/<host>.trace.json`` (Kineto's Chrome trace). On a CUDA
  device a capture that records no CUDA activity (the CUDA activity is not
  supported, or the runtime launched kernels the trace does not hold) is an
  error result, never a CPU capture.
- ``parse_trace_events`` / ``load_trace_dir`` attribute device time per
  kernel name. A trace whose events carry ``cat`` (Kineto's) counts only
  ``cat == "kernel"`` events, keyed by the demangled symbol: the lanes'
  ``gpu_memcpy`` / ``gpu_memset`` / ``gpu_user_annotation`` ranges and the
  host's ``cuda_runtime`` launch events are not kernels. Its lanes are CUDA
  streams, so busy time is the union of the kernels' intervals over every
  stream of a device (overlapping streams count once) and ``device_lanes``
  counts devices. A trace without ``cat`` (the JAX package's XPlane export)
  keeps the JAX rules: device processes by name, the "XLA Ops" thread, a
  union per (pid, tid) lane. Truncated or malformed traces give the
  summary of what survives.
- ``ContinuousProfiler`` opens short windows at a bounded duty cycle,
  parses each, and feeds the flight recorder its measured device time, so
  the modelled ``mfu_*`` / ``hbm_frac_*`` gain measured siblings. The
  gating is arithmetic over an injected clock.
- ``HostStackSampler`` is a stdlib sampling profiler over
  ``sys._current_frames()`` (``POST /debug/profile?kind=host``).

Captures run on threads of their own around a sleep window; parsing
happens after the window closes. ``torch`` is imported inside the capture,
never at module import.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import socket
import sys
import tempfile
import threading
import time
import zlib
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from dynamo_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)

PROFILE_DIR_ENV = "DYN_PROFILE_DIR"

# /debug/profile refuses windows beyond this: a forgotten profiler is a
# disk- and overhead-leak on a production worker.
MAX_CAPTURE_SECONDS = 60.0

# The longest a window waits to open or close between scheduler iterations
# (a prefill chunk or a decode window is far shorter).
STEP_WAIT_S = 2.0

# Capture windows kept in ``DeviceProfiler.status()["windows"]``.
_RECENT_WINDOWS = 64

# torch.profiler is one per process: two sessions at once crash it. Every
# DeviceProfiler of the process (one an engine) serialises on this lock.
_PROCESS_CAPTURE_LOCK = threading.Lock()
# Capture directories are numbered across the process's profilers too.
_CAPTURE_SEQ = itertools.count(1)


def profiler_lock() -> threading.Lock:
    """The process's one ``torch.profiler`` session: hold it around any
    other use of ``torch.profiler`` in a process whose engines sample (a
    ``DeviceProfiler`` that finds it held answers busy)."""
    return _PROCESS_CAPTURE_LOCK


class DeviceProfiler:
    """Serialised ``torch.profiler`` captures.

    One capture at a time in the process (the profiler is process-global).
    ``wait=False`` (the HTTP 409 path) gets ``{"status": "busy"}``;
    ``wait=True`` (incident captures) queues behind the running capture.
    Either way the collision increments ``capture_conflicts_total``. Errors
    land in the result dict (``status`` ``"error: ..."``). ``device``: the
    engine's device (None: the current CUDA device). ``guard``: a lock held
    through the window (the scheduler's graph-capture lock).
    ``step_lock``: the scheduler's iteration lock; the window opens and
    closes between iterations (waiting at most ``STEP_WAIT_S`` for one),
    so it holds whole steps: their kernels and the cost they record.

    On the card the window ends with a device synchronise before the
    profiler stops, so every kernel launched while it was open is in the
    trace whole; ``window_s`` in the result is how long it was open.
    ``status()["windows"]`` lists the recent windows (monotonic start and
    end, label, the profiler's start cost, and what the continuous sampler
    measured in them, ``note_measured``)."""

    def __init__(self, out_dir: Optional[str] = None, device=None, guard: Optional[threading.Lock] = None,
                 step_lock: Optional[threading.Lock] = None):
        self.out_dir = (out_dir or os.environ.get(PROFILE_DIR_ENV)
                        or os.path.join(tempfile.gettempdir(), "dynamo_profiles"))
        self.device = device
        self.device_type = "cuda" if device is None else str(getattr(device, "type", device)).split(":")[0]
        self.guard = guard
        self.step_lock = step_lock
        self._lock = threading.Lock()
        # Held for the whole window; THE serialisation point for every
        # capture path (HTTP, incident, continuous) of every engine.
        self._capture_lock = _PROCESS_CAPTURE_LOCK
        self._busy = False  # guarded-by: _lock
        self.captures_total = 0  # guarded-by: _lock
        self.capture_conflicts_total = 0  # guarded-by: _lock
        self.last: Optional[dict] = None  # guarded-by: _lock
        self.windows: deque = deque(maxlen=_RECENT_WINDOWS)  # guarded-by: _lock
        # The first capture's start: the profiler's one-time initialisation.
        self.first_start_s: Optional[float] = None  # guarded-by: _lock

    def _activities(self) -> list:
        from torch.profiler import ProfilerActivity, supported_activities

        if self.device_type == "cpu":
            return [ProfilerActivity.CPU]
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("torch.profiler cannot record CUDA activity in this process")
        return [ProfilerActivity.CUDA]

    def capture(self, seconds: float, label: str = "manual", wait: bool = False,
                on_open: Optional[Callable[[], None]] = None, on_close: Optional[Callable[[], None]] = None) -> dict:
        """Blocking capture: start the profiler, hold it open for
        ``seconds`` of live traffic, stop, write the trace and return its
        directory (``path``). ``on_open`` runs right after the profiler
        started, ``on_close`` right before the window closes (the
        continuous sampler reads its cost probe there).

        ``wait=False``: if another capture is running, return
        ``{"status": "busy"}`` at once (and count the conflict).
        ``wait=True``: serialise behind the running capture instead.
        """
        seconds = min(max(float(seconds), 0.05), MAX_CAPTURE_SECONDS)
        if not self._capture_lock.acquire(blocking=False):
            with self._lock:
                self.capture_conflicts_total += 1
            if not wait:
                return {"status": "busy", "error": "a capture is already running", "label": label}
            self._capture_lock.acquire()
        try:
            with self._lock:
                self._busy = True
            seq = next(_CAPTURE_SEQ)  # under the process capture lock
            path = os.path.join(self.out_dir, f"profile_{seq:04d}_{label}")
            result = {"status": "ok", "path": path, "seconds": seconds, "label": label}
            window = None
            try:
                window = self._window(path, seconds, on_open, on_close)
                result["window_s"] = round(window["end"] - window["start"], 6)
            except Exception as e:  # noqa: BLE001 — a debug surface degrades to a structured error
                result = {"status": f"error: {type(e).__name__}: {e}", "path": path, "seconds": seconds,
                          "label": label}
                logger.warning("device profile capture failed: %s", result["status"])
            with self._lock:
                self._busy = False
                if result["status"] == "ok":
                    self.captures_total += 1
                if window is not None:
                    self.windows.append({**window, "label": label, "path": path})
                    if self.first_start_s is None:
                        self.first_start_s = window["start_s"]
                self.last = result
            return result
        finally:
            self._capture_lock.release()

    def _window(self, path: str, seconds: float, on_open, on_close) -> dict:
        """One profiler window into ``path``, opened and closed between the
        scheduler's iterations: its monotonic start and end, the seconds the
        profiler took to start, and whether both ends met an iteration
        boundary (``aligned``)."""
        import torch

        activities = self._activities()
        os.makedirs(path, exist_ok=True)
        guard = self.guard if self.guard is not None else threading.Lock()
        prof = torch.profiler.profile(activities=activities)
        # Between iterations no step graph captures (warmup is over before
        # a sampler arms): the guard is free then, and held until the close.
        aligned = self._boundary()
        started = False
        guard.acquire()
        try:
            try:
                t0 = time.monotonic()
                prof.start()
                started = True
                t1 = time.monotonic()
                if on_open is not None:
                    on_open()
            finally:
                if aligned:
                    self.step_lock.release()
            time.sleep(seconds)
        finally:
            # A step waiting on the guard (a graph capture) would hold its
            # iteration: the wait for a boundary is bounded.
            closed_aligned = self._boundary()
            try:
                if started:
                    try:
                        if on_close is not None:
                            on_close()
                    finally:
                        if self.device_type != "cpu":
                            # Everything launched so far runs inside the window.
                            torch.cuda.synchronize(self.device)
                        prof.stop()
                t2 = time.monotonic()
            finally:
                guard.release()
                if closed_aligned:
                    self.step_lock.release()
        trace = os.path.join(path, f"{socket.gethostname()}.trace.json")
        prof.export_chrome_trace(trace)
        if self.device_type != "cpu":
            with open(trace, "rb") as f:
                data = f.read()
            if not _has_cuda_activity(data):
                raise RuntimeError("the trace holds no CUDA kernel although the runtime launched kernels")
        return {"start": round(t1, 6), "end": round(t2, 6), "start_s": round(t1 - t0, 6),
                "aligned": bool(aligned and closed_aligned)}

    def _boundary(self) -> bool:
        """Wait for the scheduler to be between iterations and hold it there
        (True), or give up after ``STEP_WAIT_S`` (False)."""
        return self.step_lock is not None and self.step_lock.acquire(timeout=STEP_WAIT_S)

    def note_measured(self, path: str, **fields) -> None:
        """Attach what a window measured (the continuous sampler's parse)
        to its entry in ``windows``."""
        with self._lock:
            for w in self.windows:
                if w["path"] == path:
                    w.update(fields)

    def capture_background(self, seconds: float, label: str = "incident") -> threading.Thread:
        """Fire-and-forget capture on a daemon thread (the incident path:
        the stats scrape must not block on the window). Waits for a running
        capture rather than dropping the incident's window."""
        t = threading.Thread(target=self.capture, args=(seconds, label), kwargs={"wait": True},
                             name="device-profile-capture", daemon=True)
        t.start()
        return t

    def status(self) -> dict:
        with self._lock:
            return {
                "busy": self._busy,
                "captures_total": self.captures_total,
                "capture_conflicts_total": self.capture_conflicts_total,
                "out_dir": self.out_dir,
                "last": dict(self.last) if self.last else None,
                "device": self.device_type,
                "first_start_s": self.first_start_s,
                "now": round(time.monotonic(), 6),
                "windows": [dict(w) for w in self.windows],
            }


def _has_cuda_activity(data: bytes) -> bool:
    """A CUDA window's trace recorded the device: it holds kernel events,
    or the host launched nothing in it (an idle engine: its synchronise is
    a runtime call, not a launch). Kineto names a kernel ``"cat":
    "kernel"`` and the host's calls ``"cat": "cuda_runtime"``
    (``cudaLaunchKernel``, ``cudaGraphLaunch``, ...)."""
    events, _ = _scan_events(data.decode("utf-8", "replace"))
    if any(ev.get("cat") == KINETO_KERNEL_CAT for ev in events):
        return True
    return not any(ev.get("cat") in ("cuda_runtime", "cuda_driver") and "Launch" in str(ev.get("name", ""))
                   for ev in events)


# ---------------------------------------------------------------------------
# Trace-event parsing (stdlib only; runs on the CPU against fixtures)
# ---------------------------------------------------------------------------

# Process-name patterns (lowercased substring match) that mark a trace lane
# as a device lane in a trace without ``cat`` fields (the JAX package's
# rule); with no match every duration event counts as a kernel.
DEVICE_PROCESS_PATTERNS = ("/device:", "tpu", "gpu", "accelerator")

# Within such a device process, kernels live on the "XLA Ops" thread.
DEVICE_OPS_THREAD_PATTERNS = ("xla ops",)

# Kineto's category of a kernel on the card.
KINETO_KERNEL_CAT = "kernel"


@dataclass
class KernelStat:
    """Aggregate device time for one kernel name."""

    name: str
    count: int = 0
    total_us: float = 0.0
    max_us: float = 0.0

    def observe(self, dur_us: float) -> None:
        self.count += 1
        self.total_us += dur_us
        if dur_us > self.max_us:
            self.max_us = dur_us


@dataclass
class TraceSummary:
    """What one profile window measured, attributed per kernel."""

    kernels: Dict[str, KernelStat] = field(default_factory=dict)
    device_time_us: float = 0.0  # interval union of kernel events, per device
    wall_us: float = 0.0  # span from first kernel start to last kernel end
    events_total: int = 0  # all ph=="X" events seen (host + device)
    kernel_events: int = 0  # ph=="X" events attributed to devices
    device_lanes: int = 0  # devices (Kineto) or (pid, tid) lanes kernels came from
    device_lane_found: bool = False  # False → fallback: every X event counted
    truncated: bool = False  # trace was cut; summary covers the prefix

    def top(self, n: int = 10) -> List[dict]:
        total = sum(k.total_us for k in self.kernels.values()) or 1.0
        ranked = sorted(self.kernels.values(), key=lambda k: -k.total_us)[:n]
        return [
            {"name": k.name, "count": k.count, "total_us": round(k.total_us, 3),
             "max_us": round(k.max_us, 3), "share": round(k.total_us / total, 4)}
            for k in ranked
        ]

    def launch_count(self, pattern: str) -> int:
        """Launches of kernels whose name contains ``pattern``: the dynamic
        side of the one-launch-per-fused-window invariant."""
        return sum(k.count for name, k in self.kernels.items() if pattern in name)

    def top_share(self) -> float:
        total = sum(k.total_us for k in self.kernels.values())
        if total <= 0:
            return 0.0
        return max(k.total_us for k in self.kernels.values()) / total


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    """Total covered length of a set of (start, end) intervals."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    total += cur_e - cur_s
    return total


def _kineto_device(ev: dict):
    """The device of a Kineto kernel event: ``args.device``, else its pid
    (Kineto's device lanes are pid = device index, tid = stream)."""
    args = ev.get("args")
    if isinstance(args, dict) and args.get("device") is not None:
        return args.get("device")
    return ev.get("pid")


def parse_trace_events(events: List[dict], *, truncated: bool = False) -> TraceSummary:
    """Attribute a Chrome trace-event list to per-kernel device time.

    With ``cat`` on the events (Kineto): kernels are the ``ph == "X"``,
    ``cat == "kernel"`` events; busy time is each device's union over its
    streams. Without (the JAX package's traces): metadata events
    (``ph == "M"``) name the processes and threads, duration events on
    device lanes are kernels, and with no device lane every duration event
    counts."""
    out = TraceSummary(truncated=truncated)
    process_names: Dict[object, str] = {}
    thread_names: Dict[Tuple[object, object], str] = {}
    durations: List[dict] = []
    for ev in events:
        if not isinstance(ev, dict):
            continue
        ph = ev.get("ph")
        if ph == "M":
            args = ev.get("args") or {}
            if ev.get("name") == "process_name":
                process_names[ev.get("pid")] = str(args.get("name", ""))
            elif ev.get("name") == "thread_name":
                thread_names[(ev.get("pid"), ev.get("tid"))] = str(args.get("name", ""))
        elif ph == "X":
            durations.append(ev)
    out.events_total = len(durations)
    kineto = any("cat" in ev for ev in durations)

    if kineto:
        def _is_kernel(ev: dict) -> bool:
            return ev.get("cat") == KINETO_KERNEL_CAT

        lane_of = _kineto_device
    else:
        device_pids = {
            pid for pid, name in process_names.items()
            if any(p in name.lower() for p in DEVICE_PROCESS_PATTERNS)
        }
        out.device_lane_found = bool(device_pids)

        def _is_kernel(ev: dict) -> bool:
            if not device_pids:
                return True  # fallback: no device lane — count everything
            pid = ev.get("pid")
            if pid not in device_pids:
                return False
            tname = thread_names.get((pid, ev.get("tid")), "").lower()
            # Only filter by thread when the device pid HAS named ops
            # threads; fixtures without thread metadata keep all events.
            has_ops = any(
                any(p in tn.lower() for p in DEVICE_OPS_THREAD_PATTERNS)
                for (tpid, _), tn in thread_names.items() if tpid == pid
            )
            if not has_ops:
                return True
            return any(p in tname for p in DEVICE_OPS_THREAD_PATTERNS)

        def lane_of(ev: dict):
            return ev.get("pid"), ev.get("tid")

    lanes: Dict[object, List[Tuple[float, float]]] = {}
    t0 = float("inf")
    t1 = float("-inf")
    for ev in durations:
        if not _is_kernel(ev):
            continue
        try:
            ts = float(ev.get("ts", 0.0))
            dur = float(ev.get("dur", 0.0))
        except (TypeError, ValueError):
            continue
        if dur < 0:
            continue
        name = str(ev.get("name", "?"))
        stat = out.kernels.get(name)
        if stat is None:
            stat = out.kernels[name] = KernelStat(name)
        stat.observe(dur)
        out.kernel_events += 1
        lanes.setdefault(lane_of(ev), []).append((ts, ts + dur))
        t0 = min(t0, ts)
        t1 = max(t1, ts + dur)
    if kineto:
        out.device_lane_found = bool(lanes)
    out.device_lanes = len(lanes)
    # Busy time is the per-lane interval union (nested or overlapping events
    # in one lane count once) summed across lanes (devices add).
    out.device_time_us = sum(_union_us(iv) for iv in lanes.values())
    out.wall_us = (t1 - t0) if out.kernel_events else 0.0
    return out


def _decompress_partial(data: bytes) -> bytes:
    """Gunzip as much as survives — a truncated .gz yields its prefix."""
    d = zlib.decompressobj(16 + zlib.MAX_WBITS)
    out = []
    for i in range(0, len(data), 1 << 16):
        try:
            out.append(d.decompress(data[i:i + (1 << 16)]))
        except zlib.error:
            break
    return b"".join(out)


def _scan_events(text: str) -> Tuple[List[dict], bool]:
    """Extract the traceEvents list, tolerating truncation: when the full
    document fails to parse, raw_decode individual events until the cut."""
    try:
        obj = json.loads(text)
        if isinstance(obj, dict):
            events = obj.get("traceEvents", [])
        elif isinstance(obj, list):
            events = obj
        else:
            events = []
        return [e for e in events if isinstance(e, dict)], False
    except ValueError:
        pass
    idx = text.find('"traceEvents"')
    start = text.find("[", idx if idx >= 0 else 0)
    if start < 0:
        return [], True
    dec = json.JSONDecoder()
    events: List[dict] = []
    i = start + 1
    n = len(text)
    while True:
        while i < n and text[i] in " \t\r\n,":
            i += 1
        if i >= n or text[i] == "]":
            break
        try:
            ev, i = dec.raw_decode(text, i)
        except ValueError:
            break  # the cut point — keep what we recovered
        if isinstance(ev, dict):
            events.append(ev)
    return events, True


def parse_trace_bytes(data: bytes) -> TraceSummary:
    """Parse raw trace-event bytes (gzipped or plain, possibly truncated)."""
    if data[:2] == b"\x1f\x8b":
        data = _decompress_partial(data)
    text = data.decode("utf-8", "replace")
    events, truncated = _scan_events(text)
    return parse_trace_events(events, truncated=truncated)


def load_trace_dir(path: str) -> Optional[TraceSummary]:
    """Find and parse the newest ``*.trace.json[.gz]`` under a capture
    directory (``DeviceProfiler`` writes ``<path>/<host>.trace.json``).
    Returns None when no trace artifact exists."""
    newest: Optional[str] = None
    newest_mtime = -1.0
    try:
        for root, _dirs, files in os.walk(path):
            for fn in files:
                if fn.endswith(".trace.json.gz") or fn.endswith(".trace.json"):
                    p = os.path.join(root, fn)
                    try:
                        m = os.path.getmtime(p)
                    except OSError:
                        continue
                    if m > newest_mtime:
                        newest, newest_mtime = p, m
    except OSError:
        return None
    if newest is None:
        return None
    try:
        with open(newest, "rb") as f:
            return parse_trace_bytes(f.read())
    except OSError:
        return None


# ---------------------------------------------------------------------------
# Continuous sampling
# ---------------------------------------------------------------------------


@dataclass
class ContinuousProfileConfig:
    """Knobs of the background device-truth sampler.

    A 250 ms window every 30 s is a 0.83 % duty cycle, further clamped by
    ``max_duty``: the effective interval is
    ``max(interval_s, window_s / max_duty)``."""

    enabled: bool = True
    window_s: float = 0.25
    interval_s: float = 30.0
    max_duty: float = 0.02
    keep_artifacts: bool = False
    top_n: int = 8
    # Kernel-name substring whose launch count is held against the
    # scheduler's fused-window count (one launch a window, measured): the
    # fused decode window kernel's symbol (``csrc/fused_decode_window.cu``),
    # which the spec window's and the sampler's kernels do not contain.
    fused_kernel_pattern: str = "fused_window_kernel"


class ContinuousProfiler:
    """Duty-cycled background captures feeding measured truth into the
    flight recorder.

    ``cost_probe`` returns the recorder's cumulative ``(flops, bytes,
    step_seconds, fused_windows)``, read inside the window as it opens and
    as it closes, so each window's deltas attribute measured device time to
    the modelled work of the same span; a record's ``wall_s`` is how long
    the window was open. ``sink`` receives the per-window record
    (``FlightRecorder.record_measured_window``); the fused windows, kernel
    launches, device time and the sink's ``measured_*`` gauges of each
    window go onto its entry in the profiler's ``windows``. The sampler
    yields to on-demand and incident captures: a busy profiler means the
    window is skipped and counted."""

    def __init__(
        self,
        profiler: DeviceProfiler,
        config: Optional[ContinuousProfileConfig] = None,
        *,
        cost_probe: Optional[Callable[[], Tuple[float, float, float, int]]] = None,
        sink: Optional[Callable[[dict], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.profiler = profiler
        self.config = config or ContinuousProfileConfig()
        self.cost_probe = cost_probe
        self.sink = sink
        self.clock = clock
        self._lock = threading.Lock()
        self._last_attempt = clock()  # guarded-by: _lock — first window waits a full interval
        self.windows_total = 0  # guarded-by: _lock
        self.window_seconds_total = 0.0  # guarded-by: _lock
        self.skipped_busy_total = 0  # guarded-by: _lock
        self.errors_total = 0  # guarded-by: _lock
        self.last: Optional[dict] = None  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- pure gating (unit-testable under an injected clock) ---------------
    @property
    def effective_interval_s(self) -> float:
        floor = self.config.window_s / max(self.config.max_duty, 1e-6)
        return max(self.config.interval_s, floor)

    @property
    def duty_cycle(self) -> float:
        return self.config.window_s / self.effective_interval_s

    def due(self, now: float) -> bool:
        with self._lock:
            return (now - self._last_attempt) >= self.effective_interval_s

    # --- one window ---------------------------------------------------------
    def sample_once(self, now: Optional[float] = None, force: bool = False) -> dict:
        """Open one capture window if the rate limiter allows, parse the
        artifact, and push the measured record to the sink."""
        if now is None:
            now = self.clock()
        with self._lock:
            if not force and (now - self._last_attempt) < self.effective_interval_s:
                return {"status": "not_due"}
            self._last_attempt = now
        zero = (0.0, 0.0, 0.0, 0)
        marks = {}

        def opened() -> None:
            marks["pre"] = self.cost_probe() if self.cost_probe else zero

        def closing() -> None:
            marks["post"] = self.cost_probe() if self.cost_probe else zero

        # The cost probe is read inside the window, right after the profiler
        # started and right before it stops: the work it counts is the work
        # the trace holds.
        res = self.profiler.capture(self.config.window_s, label="continuous", wait=False, on_open=opened,
                                    on_close=closing)
        status = res.get("status")
        if status == "busy":
            with self._lock:
                self.skipped_busy_total += 1
            return {"status": "skipped_busy"}
        if status != "ok":
            with self._lock:
                self.errors_total += 1
            return res
        pre, post = marks.get("pre", zero), marks.get("post", zero)
        summary = load_trace_dir(res["path"])
        if not self.config.keep_artifacts:
            shutil.rmtree(res["path"], ignore_errors=True)
        if summary is None:
            with self._lock:
                self.errors_total += 1
            return {"status": "error: no trace artifact", "path": res["path"]}
        fused_delta = max(0, int(post[3]) - int(pre[3]))
        fused_launches = summary.launch_count(self.config.fused_kernel_pattern)
        record = {
            "status": "ok",
            "wall_s": res.get("window_s", self.config.window_s),
            "device_time_s": summary.device_time_us / 1e6,
            "flops": max(0.0, post[0] - pre[0]),
            "bytes": max(0.0, post[1] - pre[1]),
            "step_seconds": max(0.0, post[2] - pre[2]),
            "kernel_events": summary.kernel_events,
            "device_lanes": summary.device_lanes,
            "device_lane_found": summary.device_lane_found,
            "truncated": summary.truncated,
            "top_kernels": summary.top(self.config.top_n),
            "top_kernel_share": summary.top_share(),
            "fused_windows": fused_delta,
            "fused_kernel_launches": fused_launches,
            "launches_per_fused_window": (
                fused_launches / fused_delta if fused_delta > 0 else None
            ),
        }
        note = getattr(self.profiler, "note_measured", None)
        if note is not None:
            note(res["path"], fused_windows=fused_delta, fused_kernel_launches=fused_launches,
                 kernel_events=summary.kernel_events, device_time_s=round(record["device_time_s"], 6))
        with self._lock:
            self.windows_total += 1
            self.window_seconds_total += self.config.window_s
            self.last = record
        derived = None
        if self.sink is not None:
            try:
                derived = self.sink(record)
            except Exception as e:  # noqa: BLE001 — a sink bug must not kill the sampler
                logger.warning("measured-window sink failed: %s", e)
        if note is not None and isinstance(derived, dict):
            note(res["path"], **{k: v for k, v in derived.items() if k.startswith("measured_")})
        return record

    # --- background thread --------------------------------------------------
    def start(self) -> None:
        if not self.config.enabled:
            return
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="continuous-profiler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0 + self.config.window_s)
            self._thread = None

    @property
    def armed(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        poll = min(5.0, max(0.25, self.effective_interval_s / 20.0))
        while not self._stop.wait(poll):
            try:
                self.sample_once()
            except Exception as e:  # noqa: BLE001 — the sampler must outlive one bad window
                with self._lock:
                    self.errors_total += 1
                logger.warning("continuous profile window failed: %s", e)

    def to_stats(self) -> dict:
        """Wire-format stats families (pure dict assembly, no device work)."""
        with self._lock:
            return {
                "device_profile_windows_total": self.windows_total,
                "device_profile_window_seconds_total": self.window_seconds_total,
                "device_profile_skipped_busy_total": self.skipped_busy_total,
                "device_profile_errors_total": self.errors_total,
                "device_profile_duty_cycle": self.duty_cycle,
            }


def _frame_key(frame) -> Optional[str]:
    """Innermost frame inside this package (or the JAX one), as
    ``file:line func``: the attribution unit. Frames entirely outside
    (idle selector loops, queue waits) collapse to None."""
    f = frame
    while f is not None:
        fn = f.f_code.co_filename
        if "dynamo_tpu" in fn:
            short = fn[fn.rindex("dynamo_tpu"):]
            return f"{short}:{f.f_lineno} {f.f_code.co_name}"
        f = f.f_back
    return None


class HostStackSampler:
    """Stdlib sampling profiler: attributes host time to code paths.

    ``start()``/``stop()`` run it continuously from a daemon thread;
    ``sample_for(seconds)`` is the blocking one-shot used by
    ``POST /debug/profile?kind=host``. ``report()`` returns the top frames
    overall plus the ``engine/scheduler.py`` rollup — the "which scheduler
    code path owns the host gap" answer.
    """

    def __init__(self, interval_s: float = 0.005):
        self.interval_s = max(float(interval_s), 0.001)
        self._lock = threading.Lock()
        self._counts: Counter = Counter()  # guarded-by: _lock
        self._other = 0  # guarded-by: _lock  (samples with no package frame)
        self.samples = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- continuous mode ----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="host-stack-sampler", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._sample()

    # --- one-shot mode ------------------------------------------------------
    def sample_for(self, seconds: float) -> dict:
        """Blocking burst of samples for ``seconds``; returns the report of
        ONLY this burst (state is reset first)."""
        self.reset()
        deadline = time.monotonic() + min(max(float(seconds), 0.05), MAX_CAPTURE_SECONDS)
        while time.monotonic() < deadline:
            self._sample()
            time.sleep(self.interval_s)
        return self.report()

    # --- core ---------------------------------------------------------------
    def _sample(self) -> None:
        me = threading.get_ident()
        hits: List[str] = []
        misses = 0
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            key = _frame_key(frame)
            if key is None:
                misses += 1
            else:
                hits.append(key)
        with self._lock:
            self.samples += 1
            self._other += misses
            for key in hits:
                self._counts[key] += 1

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._other = 0
            self.samples = 0

    def report(self, top: int = 15) -> dict:
        """Top frames by samples + the scheduler-path rollup share."""
        with self._lock:
            counts = Counter(self._counts)
            samples = self.samples
            other = self._other
        total_hits = sum(counts.values())
        sched = sum(c for k, c in counts.items() if "engine/scheduler.py" in k)
        return {
            "samples": samples,
            "attributed": total_hits,
            "unattributed_thread_samples": other,
            "scheduler_share": round(sched / total_hits, 4) if total_hits else 0.0,
            "top": [
                {
                    "frame": key,
                    "count": c,
                    "share": round(c / total_hits, 4) if total_hits else 0.0,
                }
                for key, c in counts.most_common(top)
            ],
        }
