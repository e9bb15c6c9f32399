"""Incident plane: anomaly-triggered black-box bundles.

The JAX package's ``runtime/incidents.py`` in the port, its names, rules,
counters and bundle schema kept so that ``tools/autopsy.py`` reads a port
bundle:

- ``AnomalyDetector`` watches what the stats scrape carries: windowed
  digest p99 jumps against a trailing baseline (TTFT, TPOT, queue wait),
  SLO violation-rate steps, ``compiles_after_warmup_total`` increments (in
  the port a step graph captured after warmup), stall-watchdog transitions,
  ``decode_host_gap`` regressions and, on a fleet plane, a shrinking
  instance set. It is evaluated at scrape time (no thread of its own,
  deterministic under an injected clock) and debounced per reason.
- ``IncidentRecorder`` writes one self-contained JSON bundle an incident
  (``debug_state()``, the flight recorder's recent-step ring, the tracer's
  ring, the scrape, thread stacks, the configuration, the detector's values
  and baselines, the registered evidence probes) under a global rate limit
  and an LRU cap on the files it keeps.
- ``IncidentPlane`` ties them together behind ``observe(stats)`` on every
  scrape and ``to_stats()`` merged into it (``incidents_*_total`` per
  reason, ``incident_last_age_s``, the profiler's capture counters).

All of it is host Python on the scrape path: no device work.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from dynamo_tpu_torch.runtime.logging import get_logger
from dynamo_tpu_torch.runtime.telemetry import LatencyDigest

logger = get_logger(__name__)

BUNDLE_SCHEMA = "dynamo-incident-v1"

# The closed reason set: each is a per-reason counter on the stats wire
# (``incidents_<reason>_total`` — registered in metrics_aggregator
# COUNTER_KEYS and pinned by the Grafana "Incidents" row).
REASONS = (
    "ttft_p99",
    "tpot_p99",
    "queue_wait_p99",
    "slo_violation",
    "post_warmup_compile",
    "engine_stall",
    "host_gap",
    # Fleet-level: the live instance set shrank between scrapes (a worker
    # crashed or its lease lapsed). Fired by planes that observe
    # ``worker_instance_count`` — the aggregator's fleet plane — never by a
    # worker about itself; the key still exports as 0 on workers so the
    # metric family is uniform.
    "worker_lost",
)

# Which digest stream feeds each quantile-jump signal.
_QUANTILE_SIGNALS: Tuple[Tuple[str, str], ...] = (
    ("ttft", "ttft_p99"),
    ("tpot", "tpot_p99"),
    ("queue_wait", "queue_wait_p99"),
)

INCIDENT_DIR_ENV = "DYN_INCIDENT_DIR"


@dataclass
class DetectorConfig:
    """Thresholds for the anomaly rules. Defaults are deliberately blunt —
    the detector's job is catching order-of-magnitude regressions worth a
    black-box capture, not sub-10% drift (dashboards own that)."""

    # Quantile jump: window p99 must exceed jump_factor × trailing baseline
    # AND beat it by min_abs_s (absolute floor so microsecond-scale noise
    # on near-zero baselines cannot fire).
    jump_factor: float = 3.0
    min_abs_s: float = 0.005
    # Window sample count below which a quantile is not judged (a p99 of 2
    # samples is noise).
    min_window_count: int = 8
    # Checks absorbed into the EMA baseline before a signal arms.
    baseline_checks: int = 3
    ema_alpha: float = 0.3
    # SLO violation-rate step: fraction of newly judged phase checks that
    # violated since the previous check.
    violation_rate: float = 0.5
    min_judged: int = 4
    # Decode host-gap regression: mean gap over the scrape delta vs its
    # trailing baseline.
    gap_factor: float = 3.0
    min_gap_events: int = 32
    min_gap_abs_s: float = 0.0005
    # A reason that fired cannot re-fire within this window: a persistent
    # anomaly produces ONE capture, not one per scrape.
    debounce_s: float = 60.0


class AnomalyDetector:
    """Pure function of successive stats snapshots + a clock.

    ``update(stats)`` consumes one worker-scrape-shaped stats dict (the
    dict ``TorchEngine.stats_handler`` builds) and returns
    the list of reasons that fired this check, post-debounce. All state
    lives here, keyed off deltas between checks, so a monkeypatched clock
    plus a synthetic stats stream reproduces exact (reason, fire-count)
    sequences — the determinism the tests pin.
    """

    def __init__(self, config: Optional[DetectorConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config or DetectorConfig()
        self._clock = clock
        # update() is called from whichever thread polls stats (event loop,
        # health server, bench loop): one lock serializes the whole check.
        self._lock = threading.Lock()
        self.checks_total = 0  # guarded-by: _lock
        self.fired_total = 0  # guarded-by: _lock
        # Per-quantile-signal baseline state: {reason: {"baseline", "checks"}}.
        self._qstate: Dict[str, dict] = {}  # guarded-by: _lock
        self._gap_baseline: Optional[float] = None  # guarded-by: _lock
        self._gap_checks = 0  # guarded-by: _lock
        # Counter snapshots from the previous check (delta signals).
        self._last: Dict[str, float] = {}  # guarded-by: _lock
        self._last_fire: Dict[str, float] = {}  # guarded-by: _lock
        # Last evaluated values + the baselines they were judged against —
        # embedded in bundles so the autopsy can rank signals by ratio.
        self.last_values: Dict[str, float] = {}  # guarded-by: _lock
        self.baselines: Dict[str, float] = {}  # guarded-by: _lock

    # --- helpers ------------------------------------------------------------
    @staticmethod
    def _window_digest(stats: dict, name: str) -> Optional[LatencyDigest]:
        wire = (stats.get("digests") or {}).get(name)
        if not isinstance(wire, dict) or "window" not in wire:
            return None
        try:
            return LatencyDigest.from_wire(wire["window"])
        except (TypeError, ValueError, KeyError):
            return None

    def _debounced(self, reason: str, now: float) -> bool:
        last = self._last_fire.get(reason)
        return last is not None and (now - last) < self.config.debounce_s

    def _fire(self, reason: str, now: float, fired: List[str]) -> None:
        if self._debounced(reason, now):
            return
        self._last_fire[reason] = now
        self.fired_total += 1
        fired.append(reason)

    # --- the check ----------------------------------------------------------
    def update(self, stats: dict) -> List[str]:
        """Evaluate every rule against one stats snapshot; returns the
        reasons that fired (post-debounce), in REASONS order."""
        cfg = self.config
        with self._lock:
            now = self._clock()
            self.checks_total += 1
            fired: List[str] = []

            # (1) Digest quantile jumps vs trailing EMA baselines.
            for digest_name, reason in _QUANTILE_SIGNALS:
                d = self._window_digest(stats, digest_name)
                if d is None or d.count < cfg.min_window_count:
                    continue
                p99 = d.quantile(0.99)
                st = self._qstate.setdefault(reason, {"baseline": None, "checks": 0})
                self.last_values[reason] = p99
                if st["baseline"] is not None:
                    self.baselines[reason] = st["baseline"]
                armed = st["baseline"] is not None and st["checks"] >= cfg.baseline_checks
                anomalous = (
                    armed
                    and p99 > cfg.jump_factor * st["baseline"]
                    and (p99 - st["baseline"]) > cfg.min_abs_s
                )
                if anomalous:
                    # The spike is NOT absorbed into the baseline — a
                    # sustained regression keeps reading as anomalous (and
                    # keeps being debounced) instead of becoming the new
                    # normal within a few checks.
                    self._fire(reason, now, fired)
                else:
                    st["baseline"] = (
                        p99 if st["baseline"] is None
                        else cfg.ema_alpha * p99 + (1.0 - cfg.ema_alpha) * st["baseline"]
                    )
                    st["checks"] += 1

            # (2) SLO violation-rate step over the scrape delta.
            viol = float(stats.get("slo_ttft_violated_total", 0)) + float(
                stats.get("slo_tpot_violated_total", 0)
            )
            att = float(stats.get("slo_ttft_attained_total", 0)) + float(
                stats.get("slo_tpot_attained_total", 0)
            )
            pv, pa = self._last.get("violated"), self._last.get("attained")
            if pv is not None:
                dv, da = max(viol - pv, 0.0), max(att - pa, 0.0)
                judged = dv + da
                if judged >= cfg.min_judged:
                    rate = dv / judged
                    self.last_values["slo_violation"] = rate
                    self.baselines["slo_violation"] = cfg.violation_rate
                    if rate >= cfg.violation_rate:
                        self._fire("slo_violation", now, fired)
            self._last["violated"], self._last["attained"] = viol, att

            # (3) A compile after warmup (in the port a step-graph capture;
            # any increment fires).
            compiles = stats.get("compiles_after_warmup_total")
            if compiles is not None:
                compiles = float(compiles)
                prev = self._last.get("compiles")
                self.last_values["post_warmup_compile"] = compiles
                if prev is not None and compiles > prev:
                    self._fire("post_warmup_compile", now, fired)
                self._last["compiles"] = compiles

            # (4) Stall-watchdog transition (not-stalled → stalled).
            stalled = float(stats.get("engine_stalled", 0.0))
            if stalled and not self._last.get("stalled", 0.0):
                self.last_values["engine_stall"] = stalled
                self._fire("engine_stall", now, fired)
            self._last["stalled"] = stalled

            # (5b) Instance-set shrink: a worker vanished between scrapes
            # (crash / lease lapse). Any shrink fires — scale-down should
            # drain first (worker_drains_total moves instead).
            n_inst = stats.get("worker_instance_count")
            if n_inst is not None:
                n_inst = float(n_inst)
                prev_inst = self._last.get("instances")
                self.last_values["worker_lost"] = n_inst
                if prev_inst is not None and n_inst < prev_inst:
                    self.baselines["worker_lost"] = prev_inst
                    self._fire("worker_lost", now, fired)
                self._last["instances"] = n_inst

            # (5) Decode host-gap regression: mean gap over the delta.
            ev = stats.get("decode_host_gap_events_total")
            s = stats.get("decode_host_gap_seconds_total")
            if ev is not None and s is not None:
                ev, s = float(ev), float(s)
                pe, ps = self._last.get("gap_events"), self._last.get("gap_seconds")
                if pe is not None and (ev - pe) >= cfg.min_gap_events:
                    mean = max(s - ps, 0.0) / (ev - pe)
                    self.last_values["host_gap"] = mean
                    if self._gap_baseline is not None:
                        self.baselines["host_gap"] = self._gap_baseline
                    armed = (
                        self._gap_baseline is not None
                        and self._gap_checks >= cfg.baseline_checks
                    )
                    if (
                        armed
                        and mean > cfg.gap_factor * self._gap_baseline
                        and (mean - self._gap_baseline) > cfg.min_gap_abs_s
                    ):
                        self._fire("host_gap", now, fired)
                    else:
                        self._gap_baseline = (
                            mean if self._gap_baseline is None
                            else cfg.ema_alpha * mean + (1.0 - cfg.ema_alpha) * self._gap_baseline
                        )
                        self._gap_checks += 1
                    self._last["gap_events"], self._last["gap_seconds"] = ev, s
                elif pe is None:
                    self._last["gap_events"], self._last["gap_seconds"] = ev, s

            return fired

    def snapshot(self) -> dict:
        """Detector state for bundle embedding / /debug/state: the values
        each signal last read and the baselines they were judged against —
        the evidence the autopsy ranks attribution candidates with."""
        with self._lock:
            return {
                "checks_total": self.checks_total,
                "fired_total": self.fired_total,
                "last_values": dict(self.last_values),
                "baselines": dict(self.baselines),
                "last_fire_age_s": {
                    r: round(self._clock() - t, 3) for r, t in self._last_fire.items()
                },
            }


# --- global evidence probes ---------------------------------------------------
# Components that hold incident-relevant state but no IncidentPlane of their
# own (the router's routing-decision ring, for one) register a probe here;
# every bundle captured in this process attaches each probe's snapshot under
# ``evidence.<name>``. Registration is last-writer-wins per name, so a
# rebuilt router simply replaces its predecessor's probe.
_EVIDENCE_PROBES: Dict[str, Callable[[], dict]] = {}
_EVIDENCE_LOCK = threading.Lock()


def register_evidence_probe(name: str, probe: Callable[[], dict]) -> None:
    with _EVIDENCE_LOCK:
        _EVIDENCE_PROBES[name] = probe


def unregister_evidence_probe(name: str) -> None:
    with _EVIDENCE_LOCK:
        _EVIDENCE_PROBES.pop(name, None)


def collect_evidence() -> Dict[str, dict]:
    with _EVIDENCE_LOCK:
        probes = dict(_EVIDENCE_PROBES)
    out: Dict[str, dict] = {}
    for name, probe in probes.items():
        try:
            out[name] = probe()
        except Exception as e:  # noqa: BLE001 — a broken probe must not lose the bundle
            out[name] = {"probe_error": f"{type(e).__name__}: {e}"}
    return out


def dump_thread_stacks() -> Dict[str, List[str]]:
    """Python stacks of every live thread (the /debug/stacks payload,
    callable without a server): the first question when the step loop
    wedges is "where is it stuck"."""
    import sys
    import traceback

    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for tid, frame in sys._current_frames().items():
        out[f"{names.get(tid, '?')}-{tid}"] = traceback.format_stack(frame)
    return out


@dataclass
class IncidentConfig:
    """Capture knobs (worker CLI: --incident-dir/--incident-keep/
    --profile-on-incident; ``DYN_INCIDENT_DIR`` is the env default)."""

    dir: Optional[str] = None  # None = detect + count, never write bundles
    keep: int = 16  # LRU retention cap on bundle files
    min_interval_s: float = 30.0  # global floor between any two captures
    profile_on_incident: bool = False
    profile_seconds: float = 2.0
    detector: DetectorConfig = field(default_factory=DetectorConfig)


class IncidentRecorder:
    """Writes (and retains) incident bundles. One bundle is ONE JSON file —
    self-contained by design: it can be attached to a CI run, mailed
    around, and fed to ``tools/autopsy.py`` with no sidecar files."""

    def __init__(self, dir: Optional[str] = None, keep: int = 16,
                 min_interval_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.dir = dir
        self.keep = max(int(keep), 1)
        self.min_interval_s = min_interval_s
        self._clock = clock
        self._lock = threading.Lock()
        self.captures_total = 0  # guarded-by: _lock
        self.rate_limited_total = 0  # guarded-by: _lock
        self.by_reason: Dict[str, int] = {r: 0 for r in REASONS}  # guarded-by: _lock
        self.last_capture_ts: Optional[float] = None  # guarded-by: _lock
        self.last_capture: Optional[dict] = None  # guarded-by: _lock
        self._bundles: List[dict] = []  # guarded-by: _lock  (retained manifests)

    def capture(self, reason: str, detail: dict, parts: dict) -> Optional[str]:
        """Record one incident. Returns the bundle path (None when capture
        was rate-limited or no directory is configured — the counters still
        advance so the scrape reflects every detected incident)."""
        with self._lock:
            now = self._clock()
            if (
                self.last_capture_ts is not None
                and (now - self.last_capture_ts) < self.min_interval_s
            ):
                self.rate_limited_total += 1
                logger.warning(
                    "incident %s rate-limited (last capture %.1fs ago < %.1fs floor)",
                    reason, now - self.last_capture_ts, self.min_interval_s,
                )
                return None
            self.last_capture_ts = now
            self.captures_total += 1
            self.by_reason[reason] = self.by_reason.get(reason, 0) + 1
            seq = self.captures_total
        wall_ts = time.time()
        summary = {"reason": reason, "ts": wall_ts, "detail": detail, "path": None,
                   "status": "counted"}
        if self.dir is not None:
            bundle = {
                "schema": BUNDLE_SCHEMA,
                "reason": reason,
                "ts": wall_ts,
                "detail": detail,
                **parts,
            }
            try:
                os.makedirs(self.dir, exist_ok=True)
                path = os.path.join(self.dir, f"incident_{seq:04d}_{reason}.json")
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(bundle, f, default=str)
                os.replace(tmp, path)  # readers never see a torn bundle
                summary["path"] = path
                summary["status"] = "written"
            except OSError as e:
                summary["status"] = f"error: {e}"
        logger.error("incident captured: reason=%s detail=%s bundle=%s",
                     reason, detail, summary["path"])
        with self._lock:
            self.last_capture = summary
            self._bundles.append(
                {k: summary[k] for k in ("reason", "ts", "path", "status")}
            )
            evicted = self._bundles[: -self.keep]
            self._bundles = self._bundles[-self.keep:]
        for old in evicted:
            if old.get("path"):
                try:
                    os.remove(old["path"])
                except OSError:
                    pass
        return summary["path"]

    def list(self) -> List[dict]:
        """Manifests of the retained bundles, oldest first."""
        with self._lock:
            return [dict(b) for b in self._bundles]

    def to_stats(self) -> dict:
        """Flat worker-scrape keys (COUNTER_KEYS / GAUGE_KEYS names)."""
        with self._lock:
            out: dict = {"incidents_total": self.captures_total}
            for reason in REASONS:
                out[f"incidents_{reason}_total"] = self.by_reason.get(reason, 0)
            out["incident_last_age_s"] = (
                round(self._clock() - self.last_capture_ts, 3)
                if self.last_capture_ts is not None
                else -1.0
            )
            return out


class IncidentPlane:
    """Detector + recorder + capture probes behind the two calls a stats
    handler makes: ``observe(stats)`` then merge ``to_stats()``.

    Probes are pulled lazily at capture time, never per check:

    - ``state_probe`` → ``debug_state()`` (sequences, block pool, digest
      summary, recent-step timeline)
    - ``flight_probe`` → the flight recorder's step-ring snapshot
    - ``config_probe`` → engine/scheduler configuration
    - the process tracer's ring and every thread's Python stack ride along
      unconditionally.
    """

    def __init__(
        self,
        config: Optional[IncidentConfig] = None,
        *,
        state_probe: Optional[Callable[[], dict]] = None,
        flight_probe: Optional[Callable[[], dict]] = None,
        config_probe: Optional[Callable[[], dict]] = None,
        profiler=None,  # runtime.profiling.DeviceProfiler
        clock: Callable[[], float] = time.monotonic,
    ):
        self.config = config or IncidentConfig()
        self.detector = AnomalyDetector(self.config.detector, clock=clock)
        self.recorder = IncidentRecorder(
            dir=self.config.dir, keep=self.config.keep,
            min_interval_s=self.config.min_interval_s, clock=clock,
        )
        self.state_probe = state_probe
        self.flight_probe = flight_probe
        self.config_probe = config_probe
        self.profiler = profiler

    def _build_parts(self, stats: dict) -> dict:
        from dynamo_tpu_torch.runtime.tracing import get_tracer

        def probe(fn):
            if fn is None:
                return None
            try:
                return fn()
            except Exception as e:  # noqa: BLE001 — a broken probe must not lose the bundle
                return {"probe_error": f"{type(e).__name__}: {e}"}

        return {
            "stats": stats,
            "debug_state": probe(self.state_probe),
            "flight": probe(self.flight_probe),
            "config": probe(self.config_probe),
            "detector": self.detector.snapshot(),
            "trace_ring": get_tracer().ring_records(),
            "thread_stacks": dump_thread_stacks(),
            # Cross-component evidence (e.g. the router's routing-decision
            # ring: what was being sent where just before a worker_lost).
            "evidence": collect_evidence(),
        }

    def observe(self, stats: dict) -> List[str]:
        """One detector check against one stats snapshot; captures a bundle
        per fired reason (subject to the recorder's global rate limit — a
        multi-signal anomaly produces ONE bundle, whose detector snapshot
        still carries every signal's evidence)."""
        fired = self.detector.update(stats)
        for reason in fired:
            detail = {
                "value": self.detector.last_values.get(reason),
                "baseline": self.detector.baselines.get(reason),
            }
            path = self.recorder.capture(reason, detail, self._build_parts(stats))
            if (
                path is not None
                and self.config.profile_on_incident
                and self.profiler is not None
            ):
                # Short device profile written beside the bundle,
                # captured off-thread so the scrape path never blocks on
                # the profiler's sleep window.
                self.profiler.capture_background(
                    self.config.profile_seconds,
                    label=os.path.splitext(os.path.basename(path))[0],
                )
        return fired

    def to_stats(self) -> dict:
        out = self.recorder.to_stats()
        out["profiler_captures_total"] = (
            self.profiler.captures_total if self.profiler is not None else 0
        )
        # Capture-path collisions (incident vs continuous vs HTTP): each one
        # used to be a silent drop; now every contender either queues or is
        # refused WITH this counter ticking.
        out["profiler_capture_conflicts_total"] = (
            self.profiler.capture_conflicts_total if self.profiler is not None else 0
        )
        return out

    def debug_info(self) -> dict:
        """The /debug/state "incidents" block: retained bundle list, last
        capture status, detector evidence."""
        return {
            "bundles": self.recorder.list(),
            "last_capture": self.recorder.last_capture,
            "rate_limited_total": self.recorder.rate_limited_total,
            "detector": self.detector.snapshot(),
            "profiler": (
                self.profiler.status() if self.profiler is not None else None
            ),
        }
