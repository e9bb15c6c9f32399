"""Engine flight recorder: step histograms, the roofline account and the
graph-capture tracker.

The JAX package's ``engine/flight_recorder.py`` in the port, keeping a
host-side account of every dispatch of the scheduler's step loop:

- **Step-duration histograms by phase** (prefill / decode / mixed / wave /
  spec) with per-phase token counts.
- **A live roofline account** (``StepCostModel``): FLOPs and bytes per step
  from the real parameter and cache byte widths, over the card's peaks:
  ``mfu_*`` and ``hbm_frac_*``. Peaks come from ``detect_peaks``: the H100's
  published bf16 dense and HBM3 rates, the JAX package's nominal floor on
  the CPU, and nothing for any other card (its ``mfu_*`` / ``hbm_frac_*``
  are left out of the scrape rather than computed over a made-up peak).
- **A compile tracker.** The JAX package counts XLA compiles after warmup;
  the port's counterpart of a compile is a CUDA-graph capture
  (``engine/graphs.py``): ``compile_probe`` reads the scheduler's capture
  count, and ``compiles_total`` / ``compiles_after_warmup_total`` keep the
  JAX key names so dashboards and ``/health`` read them.

The scheduler owns its window counters; ``window_stats`` lays them out as
the JAX recorder's scrape keys.

Times are host wall time at the points where the JAX scheduler takes them
(``StepTimer``): no device sync is added for a timer, so a step that
returns before the card finishes is charged its host time, and the device
time lands on the step that waits for it.

Everything is plain Python ints and floats mutated from the step thread and
read from the event loop by ``to_stats()``: last-write-wins races on a
scrape are fine for monitoring data, so the hot path takes no lock.
"""

from __future__ import annotations

import bisect
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from dynamo_tpu_torch.runtime.logging import get_logger

logger = get_logger(__name__)

# Step durations span sub-ms CPU steps to multi-second captures.
STEP_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0
)

PHASES = ("prefill", "decode", "mixed", "wave", "spec")

# Host-gap buckets: the sub-millisecond window between a decode dispatch
# returning and the next one being issued. The overlapped pipeline's steady
# state sits in the lowest buckets; sync-path steps pay the readback,
# bookkeeping and upload gap.
GAP_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25
)


class _PhaseHist:
    __slots__ = ("counts", "total", "sum_s", "tokens", "buckets")

    def __init__(self, buckets: Tuple[float, ...] = STEP_BUCKETS) -> None:
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.total = 0
        self.sum_s = 0.0
        self.tokens = 0

    def observe(self, dur_s: float, tokens: int) -> None:
        self.counts[bisect.bisect_left(self.buckets, dur_s)] += 1
        self.total += 1
        self.sum_s += dur_s
        self.tokens += tokens

    def percentile(self, q: float) -> float:
        """Approximate q-quantile (0..1) from the bucket counts: linear
        interpolation within the covering bucket, upper bound for +Inf."""
        if not self.total:
            return 0.0
        rank = q * self.total
        seen = 0
        lo = 0.0
        for i, c in enumerate(self.counts):
            hi = self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
            if seen + c >= rank:
                if c == 0:
                    return hi
                frac = (rank - seen) / c
                return lo + frac * (hi - lo)
            seen += c
            lo = hi
        return self.buckets[-1]


# Peak rates for the live MFU / HBM-roofline gauges, keyed by a substring of
# ``torch.cuda.get_device_name()``: (bf16 dense FLOP/s, HBM bytes/s). The
# H100 row is NVIDIA's H100 SXM5 datasheet (989.4 TFLOP/s bf16 dense, 3.35
# TB/s HBM3). No other card has a row. The CPU keeps the JAX package's
# nominal floor so the CPU tests see the same keys (its absolute values mean
# nothing off the card).
_PEAKS: Tuple[Tuple[str, float, float], ...] = (
    ("H100", 989.4e12, 3.35e12),
)
_CPU_PEAKS = (1e12, 100e9)


def detect_peaks(device=None) -> Optional[Tuple[float, float]]:
    """(peak FLOP/s, peak HBM bytes/s) of ``device`` (a torch device or its
    name; None = the current CUDA device if any, else the CPU); None for a
    CUDA card with no row in ``_PEAKS``."""
    import torch

    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        return _CPU_PEAKS
    name = torch.cuda.get_device_name(dev)
    for sub, flops, bw in _PEAKS:
        if sub in name:
            return flops, bw
    return None


class StepCostModel:
    """Per-step FLOPs and bytes, analytical and host-side only:

    - FLOPs ≈ 2 · params · tokens (the matmul-dominated transformer count;
      attention FLOPs are second-order at serving context lengths).
    - Bytes: a step streams the parameter set once per parameter pass, plus
      the resident KV it reads and the KV rows it writes.

    ``param_count`` / ``param_bytes`` come from the served parameters and
    ``kv_bytes_per_token`` from the cache tensors, so int8 weights and KV
    are modeled at their stored widths. ``kv_read_factor`` is the attention
    path's traffic over the true prefix bytes: the gather path copies the
    prefix into a packed tensor and attends over the copy (3.0); the ragged
    and paged kernels read each page once (1.0). ``peak_flops`` /
    ``peak_bw`` default to ``detect_peaks()``; None for a card with no row,
    when the scrape leaves its ``mfu_*`` / ``hbm_frac_*`` out. The count is
    never calibrated: the JAX package calibrates it from XLA's cost
    analysis, which the port's profiling plane (ROADMAP item 18, second
    part) replaces."""

    __slots__ = ("param_count", "param_bytes", "kv_bytes_per_token", "kv_read_factor", "peak_flops", "peak_bw",
                 "flops_per_token")

    def __init__(self, param_count: int, param_bytes: int, kv_bytes_per_token: float,
                 peak_flops: Optional[float] = None, peak_bw: Optional[float] = None,
                 kv_read_factor: float = 1.0, device=None):
        self.param_count = max(int(param_count), 1)
        self.param_bytes = max(int(param_bytes), 1)
        self.kv_bytes_per_token = max(float(kv_bytes_per_token), 0.0)
        self.kv_read_factor = max(float(kv_read_factor), 0.0)
        if peak_flops is None or peak_bw is None:
            peak_flops, peak_bw = detect_peaks(device) or (None, None)
        self.peak_flops = peak_flops
        self.peak_bw = peak_bw
        self.flops_per_token = 2.0 * self.param_count

    @property
    def has_peaks(self) -> bool:
        return self.peak_flops is not None and self.peak_bw is not None

    def step_cost(self, tokens: int, kv_read_tokens: int, param_passes: float = 1.0) -> Tuple[float, float]:
        """(flops, bytes) of one dispatch computing ``tokens`` token rows
        while reading ``kv_read_tokens`` of resident KV. ``param_passes``:
        how often the dispatch streams the parameters from HBM: 1 for a
        step, ``num_steps`` for a window (``decode_multi``'s forwards and
        the fused kernel's products alike stream them every step)."""
        flops = self.flops_per_token * tokens
        bytes_moved = (
            self.param_bytes * max(param_passes, 1.0)
            + kv_read_tokens * self.kv_bytes_per_token * self.kv_read_factor
            + tokens * self.kv_bytes_per_token  # written KV rows
        )
        return flops, bytes_moved

    def roofline_time(self, flops: float, bytes_moved: float) -> float:
        """Lower-bound seconds for (flops, bytes) on this device, the
        max(compute, bandwidth) roofline; 0 without peaks."""
        if not self.has_peaks:
            return 0.0
        return max(flops / self.peak_flops, bytes_moved / self.peak_bw)


class _PhaseRoofline:
    """Rolling (flops, bytes, seconds) account per phase: a bounded deque of
    recent steps, so a quiet engine's MFU follows recent traffic."""

    __slots__ = ("recent", "flops_total", "bytes_total", "secs_total")

    def __init__(self, maxlen: int = 256):
        self.recent: deque = deque(maxlen=maxlen)  # (flops, bytes, dur_s)
        self.flops_total = 0.0
        self.bytes_total = 0.0
        self.secs_total = 0.0

    def record(self, flops: float, bytes_moved: float, dur_s: float) -> None:
        self.recent.append((flops, bytes_moved, dur_s))
        self.flops_total += flops
        self.bytes_total += bytes_moved
        self.secs_total += dur_s

    def live(self, peak_flops: float, peak_bw: float) -> Tuple[float, float]:
        """(MFU, HBM-roofline fraction) over the recent-step window."""
        if not self.recent:
            return 0.0, 0.0
        f = sum(x for x, _, _ in self.recent)
        b = sum(x for _, x, _ in self.recent)
        t = sum(x for _, _, x in self.recent)
        if t <= 0:
            return 0.0, 0.0
        return f / t / peak_flops, b / t / peak_bw


class FlightRecorder:
    """Owned by one Scheduler; mutated on the step thread only.
    ``compile_probe`` returns the step graphs captured so far (the
    scheduler's ``graph_captures_total``)."""

    def __init__(self, telemetry=None, compile_probe: Optional[Callable[[], int]] = None) -> None:
        self._hists: Dict[str, _PhaseHist] = {p: _PhaseHist() for p in PHASES}
        # Optional runtime.telemetry.Telemetry: record_step feeds per-phase
        # ``{phase}_step`` digests so step-duration percentiles merge
        # fleet-wide.
        self.telemetry = telemetry
        # Per-step FLOPs+bytes account (set_cost_model); None keeps
        # record_step cost-free.
        self.cost_model: Optional[StepCostModel] = None
        self._roofline: Dict[str, _PhaseRoofline] = {}
        # Stall watchdog reference point and /debug/state step timeline.
        self.last_step_ts: Optional[float] = None
        self.recent_steps: deque = deque(maxlen=64)  # (ts, phase, dur_s, tokens)
        # Decode host gap: from a decode dispatch RETURNING to the next decode
        # dispatch being issued (phase changes reset it).
        self._gap = _PhaseHist(GAP_BUCKETS)
        # Compile tracker: graph captures, and the count when traffic could
        # start (mark_warmup_done).
        self._compile_probe = compile_probe
        self._captures_at_warmup: Optional[int] = None
        self._warmed = False
        self.last_step_phase: Optional[str] = None
        self.last_step_s = 0.0

    # --- step accounting ----------------------------------------------------
    def set_cost_model(self, model: StepCostModel) -> None:
        """Attach the per-step FLOPs+bytes model: record_step then keeps a
        live per-phase MFU / HBM-roofline account."""
        self.cost_model = model

    def _note_step(self, phase: str, dur_s: float, tokens: int) -> None:
        self.last_step_phase = phase
        self.last_step_s = dur_s
        self.last_step_ts = time.monotonic()
        self.recent_steps.append((self.last_step_ts, phase, round(dur_s, 6), tokens))
        if self.telemetry is not None:
            self.telemetry.observe(f"{phase}_step", dur_s)

    def record_step(self, phase: str, dur_s: float, tokens: int, kv_read_tokens: int = 0,
                    param_passes: float = 1.0) -> None:
        h = self._hists.get(phase)
        if h is None:
            h = self._hists.setdefault(phase, _PhaseHist())
        h.observe(dur_s, tokens)
        self._note_step(phase, dur_s, tokens)
        if self.cost_model is not None:
            flops, bytes_moved = self.cost_model.step_cost(tokens, kv_read_tokens, param_passes)
            self._record_roofline(phase, flops, bytes_moved, dur_s)

    def _record_roofline(self, phase: str, flops: float, bytes_moved: float, dur_s: float) -> None:
        r = self._roofline.get(phase)
        if r is None:
            r = self._roofline.setdefault(phase, _PhaseRoofline())
        r.record(flops, bytes_moved, dur_s)

    def record_mixed_step(self, dur_s: float, prefill_tokens: int, decode_tokens: int, kv_read_prefill: int = 0,
                          kv_read_decode: int = 0) -> None:
        """One MIXED prefill+decode dispatch. The step histogram stays under
        "mixed", but the FLOPs/bytes account is split into the prefill and
        decode buckets (the ragged kernel serves both phases in one launch;
        charging all of it to "mixed" would starve ``mfu_prefill`` and
        ``hbm_frac_decode`` of the traffic mixed steps carry). The wall time
        is apportioned by each phase's roofline time (a chunk is FLOPs-bound,
        decode rows are bytes-bound), half and half without peaks."""
        self._hists["mixed"].observe(dur_s, prefill_tokens + decode_tokens)
        self._note_step("mixed", dur_s, prefill_tokens + decode_tokens)
        if self.cost_model is None:
            return
        # The parameter stream is shared by both phases: it goes to the
        # decode rows (the batch ran anyway; the chunk rides along).
        f_p, b_p = self.cost_model.step_cost(prefill_tokens, kv_read_prefill, 0.0)
        f_d, b_d = self.cost_model.step_cost(decode_tokens, kv_read_decode, 1.0)
        t_p = self.cost_model.roofline_time(f_p, b_p)
        t_d = self.cost_model.roofline_time(f_d, b_d)
        share_p = t_p / (t_p + t_d) if (t_p + t_d) > 0 else 0.5
        if prefill_tokens > 0:
            self._record_roofline("prefill", f_p, b_p, dur_s * share_p)
        if decode_tokens > 0:
            self._record_roofline("decode", f_d, b_d, dur_s * (1.0 - share_p))

    def utilization(self) -> Dict[str, Tuple[float, float]]:
        """{phase: (mfu, hbm_roofline_fraction)} over the recent-step window;
        empty without a cost model or without peaks."""
        cm = self.cost_model
        if cm is None or not cm.has_peaks:
            return {}
        return {phase: r.live(cm.peak_flops, cm.peak_bw) for phase, r in list(self._roofline.items())}

    def record_host_gap(self, gap_s: float) -> None:
        """One dispatch-return → next-dispatch interval on the decode path."""
        self._gap.observe(gap_s, 0)

    def gap_percentile(self, q: float) -> float:
        """Approximate decode-host-gap quantile in seconds."""
        return self._gap.percentile(q)

    # --- compile tracking ---------------------------------------------------
    @property
    def compiles_total(self) -> int:
        return int(self._compile_probe()) if self._compile_probe is not None else 0

    @property
    def compiles_after_warmup_total(self) -> int:
        if self._captures_at_warmup is None:
            return 0
        return self.compiles_total - self._captures_at_warmup

    def mark_warmup_done(self, warmed: bool) -> None:
        """Called once traffic may start: captures after this point count as
        ``compiles_after_warmup_total``. ``warmed`` = a warmup pass captured
        the serving set (a later capture is then unexpected and logged)."""
        self._captures_at_warmup = self.compiles_total
        self._warmed = warmed

    def check_compiles(self) -> None:
        """Log captures after a warmup (a coverage gap: the key was not
        warmed); an engine that skipped warmup captures lazily by design."""
        n = self.compiles_after_warmup_total
        if n and self._warmed:
            logger.warning("step graphs captured after warmup: %d", n)

    # --- export -------------------------------------------------------------
    def to_stats(self) -> dict:
        """Flat dict merged into the worker stats scrape (monotonic keys end
        in ``_total`` so the aggregator exports them as counters)."""
        out: dict = {
            "compiles_total": self.compiles_total,
            "compiles_after_warmup_total": self.compiles_after_warmup_total,
            # Host-gap histogram as sum+count counters: rate(sum)/rate(count)
            # is the live average gap.
            "decode_host_gap_events_total": self._gap.total,
            "decode_host_gap_seconds_total": round(self._gap.sum_s, 6),
        }
        for phase, h in list(self._hists.items()):
            if not h.total and phase not in ("prefill", "decode", "mixed"):
                continue  # wave/spec only when the path ran
            out[f"step_{phase}_steps_total"] = h.total
            out[f"step_{phase}_time_seconds_total"] = round(h.sum_s, 6)
            out[f"step_{phase}_tokens_total"] = h.tokens
        cm = self.cost_model
        if cm is not None:
            for phase, r in list(self._roofline.items()):
                out[f"step_{phase}_flops_total"] = round(r.flops_total, 1)
                out[f"step_{phase}_bytes_total"] = round(r.bytes_total, 1)
                if cm.has_peaks:
                    mfu, hbm = r.live(cm.peak_flops, cm.peak_bw)
                    out[f"mfu_{phase}"] = round(mfu, 6)
                    out[f"hbm_frac_{phase}"] = round(hbm, 6)
            out["cost_model_calibrated"] = 0.0  # analytical (StepCostModel)
        return out

    def histogram(self, phase: str) -> Tuple[Tuple[float, ...], List[int]]:
        """(bucket upper bounds, counts incl. +Inf) for one phase; the
        ``"host_gap"`` pseudo-phase returns the decode host-gap histogram."""
        h = self._gap if phase == "host_gap" else self._hists[phase]
        return h.buckets, list(h.counts)

    def debug_state(self, now: Optional[float] = None) -> dict:
        """``debug_state["flight"]``: the last step, the compile tracker and
        the recent-step timeline (the JAX scheduler's keys)."""
        now = time.monotonic() if now is None else now
        return {
            "last_step_phase": self.last_step_phase,
            "last_step_s": round(self.last_step_s, 6),
            "last_step_age_s": round(now - self.last_step_ts, 3) if self.last_step_ts is not None else None,
            "compiles_total": self.compiles_total,
            "compiles_after_warmup_total": self.compiles_after_warmup_total,
            "post_warmup_keys": [],
            "recent_steps": [
                {"age_s": round(now - ts, 3), "phase": ph, "dur_s": d, "tokens": t}
                for ts, ph, d, t in list(self.recent_steps)
            ],
            "utilization": {ph: {"mfu": round(m, 6), "hbm_frac": round(h, 6)}
                            for ph, (m, h) in self.utilization().items()},
        }


def window_stats(fused_windows: int, fused_sampled_windows: int, window_launches: Optional[int],
                 spec_windows: int, spec_accepted_tokens: int) -> dict:
    """The fused windows' scrape keys, present when the JAX recorder's are:
    ``fused_window_pallas_launches`` is the fused decode window kernel's
    launches in the last window (1 on the card, where a window the plain
    version ran reads 0; JAX counts the ``pallas_call`` sites traced into
    one window executable, spec windows' too)."""
    out: dict = {}
    if fused_windows or window_launches is not None:
        out["fused_windows_total"] = fused_windows
        out["fused_sampled_windows_total"] = fused_sampled_windows
        out["fused_window_pallas_launches"] = window_launches if window_launches is not None else 0
    if spec_windows:
        out["spec_fused_windows_total"] = spec_windows
        out["spec_fused_accepted_tokens_total"] = spec_accepted_tokens
    return out


class StepTimer:
    """``with StepTimer() as t: ...; flight.record_step(phase, t.dur, n)``:
    host wall time of the block, no device sync."""

    __slots__ = ("t0", "dur")

    def __enter__(self) -> "StepTimer":
        self.t0 = time.perf_counter()
        self.dur = 0.0
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.dur = time.perf_counter() - self.t0
