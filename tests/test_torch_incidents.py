"""The port's incident plane (``runtime/incidents.py``) and JSONL log
format against the JAX package's, on the same scripted stats.

- ``AnomalyDetector``: the same stats sequence under a patched clock fires
  the same reasons in the same order (digest p99 jumps, debounce, SLO
  violation steps, compiles after warmup, stall transitions, host-gap
  regressions, a shrinking instance set), with the same snapshot;
- ``IncidentRecorder``: the same rate limit, LRU retention and counters;
- ``IncidentPlane``: a bundle with JAX's schema, key for key (the engine's
  too: ``TorchEngine``'s probes against ``TpuEngine``'s), and the same
  scrape keys; ``tools/autopsy.py`` reads a port bundle in process and as
  a CLI (``PYTHONPATH`` at the repo root);
- ``DYN_LOGGING_JSONL``: the port's lines carry JAX's keys.

Tolerance: exact equality (the detector is host arithmetic on the same
digest wire).
"""

from __future__ import annotations

import asyncio
import glob
import json
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.runtime import incidents as jinc
from dynamo_tpu.runtime import logging as jlog
from dynamo_tpu.runtime import telemetry as jtel
from dynamo_tpu.runtime.tracing import configure_tracing as jconfigure
from dynamo_tpu_torch.runtime import incidents as pinc
from dynamo_tpu_torch.runtime import logging as plog
from dynamo_tpu_torch.runtime import telemetry as ptel
from dynamo_tpu_torch.runtime.tracing import configure_tracing, get_tracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import autopsy  # noqa: E402  (tools/autopsy.py)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def digest_wire(tel, values):
    d = tel.LatencyDigest()
    for v in values:
        d.observe(v)
    w = d.to_wire()
    return {"window": w, "total": w}


def script(tel):
    """(t, stats) checks: calm digests, a TTFT spike (debounced, re-fired),
    an SLO violation step, a compile, a stall, host-gap growth, a lost
    worker."""
    calm = {"ttft": [0.01] * 8, "tpot": [0.002] * 8, "queue_wait": [0.001] * 8}

    def stats(t, streams=calm, **flat):
        return t, {"digests": {n: digest_wire(tel, v) for n, v in streams.items()}, **flat}

    base = dict(slo_ttft_attained_total=0, slo_ttft_violated_total=0, compiles_after_warmup_total=0,
                engine_stalled=0.0, decode_host_gap_events_total=0, decode_host_gap_seconds_total=0.0,
                worker_instance_count=2)
    spike = {**calm, "ttft": [0.2] * 8, "queue_wait": [0.3] * 8}
    out = [stats(1.0, **base), stats(2.0, **{**base, "decode_host_gap_events_total": 40,
                                             "decode_host_gap_seconds_total": 0.004}),
           stats(3.0, **{**base, "decode_host_gap_events_total": 80, "decode_host_gap_seconds_total": 0.008}),
           stats(4.0, **{**base, "decode_host_gap_events_total": 120, "decode_host_gap_seconds_total": 0.012}),
           stats(5.0, spike, **{**base, "decode_host_gap_events_total": 160,
                                "decode_host_gap_seconds_total": 0.016}),
           stats(6.0, spike, **{**base, "slo_ttft_attained_total": 2, "slo_ttft_violated_total": 6}),
           stats(7.0, **{**base, "compiles_after_warmup_total": 1, "engine_stalled": 1.0}),
           stats(8.0, **{**base, "decode_host_gap_events_total": 200, "decode_host_gap_seconds_total": 0.116}),
           stats(9.0, **{**base, "worker_instance_count": 1}),
           stats(16.0, spike, **{**base, "worker_instance_count": 1}),
           stats(17.0, spike, **{**base, "compiles_after_warmup_total": 3, "worker_instance_count": 0})]
    return out


@pytest.mark.parametrize("debounce_s", [5.0, 60.0])
def test_detector_fires_as_jax(debounce_s):
    fired, snaps = [], []
    for inc, tel in ((pinc, ptel), (jinc, jtel)):
        clock = FakeClock()
        det = inc.AnomalyDetector(inc.DetectorConfig(min_window_count=4, baseline_checks=2, debounce_s=debounce_s,
                                                     min_judged=4, min_gap_events=32), clock=clock)
        seq = []
        for t, stats in script(tel):
            clock.t = t
            seq.append(det.update(stats))
        fired.append(seq)
        snaps.append(det.snapshot())
    assert fired[0] == fired[1]
    assert snaps[0] == snaps[1]
    flat = [r for step in fired[0] for r in step]
    assert {"ttft_p99", "queue_wait_p99", "slo_violation", "post_warmup_compile", "engine_stall", "host_gap",
            "worker_lost"} <= set(flat)
    assert pinc.REASONS == jinc.REASONS


def _recorders(tmp_path, keep, min_interval_s):
    out = []
    for inc, sub in ((pinc, "p"), (jinc, "j")):
        clock = FakeClock(100.0)
        out.append((inc.IncidentRecorder(dir=str(tmp_path / sub), keep=keep, min_interval_s=min_interval_s,
                                         clock=clock), clock))
    return out


@pytest.mark.parametrize("keep,min_interval_s", [(2, 10.0), (3, 0.0)])
def test_recorder_rate_limit_and_lru_match_jax(tmp_path, keep, min_interval_s):
    recs = _recorders(tmp_path, keep, min_interval_s)
    plan = [(100.0, "ttft_p99"), (105.0, "tpot_p99"), (111.0, "host_gap"), (112.0, "engine_stall"),
            (130.0, "ttft_p99"), (150.0, "worker_lost"), (151.0, "worker_lost")]
    got = []
    for rec, clock in recs:
        paths = []
        for t, reason in plan:
            clock.t = t
            path = rec.capture(reason, {"value": t}, {"stats": {"t": t}})
            paths.append(os.path.basename(path) if path else None)
        files = sorted(os.path.basename(p) for p in glob.glob(os.path.join(rec.dir, "incident_*.json")))
        got.append((paths, files, [(b["reason"], b["status"], os.path.basename(b["path"] or ""))
                                   for b in rec.list()], rec.to_stats(), rec.rate_limited_total))
    assert got[0] == got[1]
    assert len(got[0][1]) <= keep


def _plane_bundle(inc, tel, tmp_path, configure):
    configure(path=None, sample=1.0, ring_size=64, service="test")
    try:
        from dynamo_tpu_torch.runtime.tracing import get_tracer as pget
        from dynamo_tpu.runtime.tracing import get_tracer as jget

        tracer = pget() if inc is pinc else jget()
        tid = "ef" * 16
        tracer.event("queued", tid, service="scheduler", prompt_tokens=12)
        tracer.event("admitted", tid, service="scheduler", queue_s=0.45)
        tracer.event("first_token", tid, service="scheduler", ttft_s=0.47, cached_tokens=0)
        tracer.event("finish", tid, service="scheduler", reason="stop", output_tokens=8, preemptions=0)
        clock = FakeClock()
        plane = inc.IncidentPlane(
            inc.IncidentConfig(dir=str(tmp_path), keep=4, min_interval_s=30.0,
                               detector=inc.DetectorConfig(min_window_count=4, baseline_checks=2, debounce_s=10.0)),
            config_probe=lambda: {"engine": "synthetic"}, state_probe=lambda: {"running": []},
            flight_probe=lambda: {"recent_steps": []}, clock=clock)
        calm = {"digests": {"queue_wait": digest_wire(tel, [0.001] * 8), "ttft": digest_wire(tel, [0.01] * 8)}}
        for i in range(3):
            clock.t = float(i + 1)
            assert plane.observe(calm) == []
        clock.t = 10.0
        spike = {"digests": {"queue_wait": digest_wire(tel, [0.45] * 8), "ttft": digest_wire(tel, [0.47] * 8)}}
        fired = plane.observe(spike)
        (path,) = glob.glob(str(tmp_path / "incident_*.json"))
        return fired, path, plane
    finally:
        configure(path=None, sample=0.0, ring_size=0)


def test_bundle_schema_matches_jax_and_autopsy_reads_it(tmp_path):
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    p_fired, p_path, p_plane = _plane_bundle(pinc, ptel, tmp_path / "p", configure_tracing)
    j_fired, j_path, j_plane = _plane_bundle(jinc, jtel, tmp_path / "j", jconfigure)
    assert p_fired == j_fired == ["ttft_p99", "queue_wait_p99"]
    assert os.path.basename(p_path) == os.path.basename(j_path)
    pb, jb = json.load(open(p_path)), json.load(open(j_path))
    assert set(pb) == set(jb) and pb["schema"] == jb["schema"] == jinc.BUNDLE_SCHEMA
    assert set(pb["detector"]) == set(jb["detector"]) and pb["detector"]["last_values"] == jb["detector"]["last_values"]
    assert [{k: r[k] for k in ("name", "trace_id", "attrs")} for r in pb["trace_ring"]] == [
        {k: r[k] for k in ("name", "trace_id", "attrs")} for r in jb["trace_ring"]]
    assert set(pb["trace_ring"][0]) == set(jb["trace_ring"][0])
    assert p_plane.to_stats() == j_plane.to_stats()
    assert set(p_plane.debug_info()) == set(j_plane.debug_info())
    bundle = autopsy.load_bundle(p_path)
    assert bundle is not None
    report = autopsy.incident_report(bundle)
    assert report == {**autopsy.incident_report(autopsy.load_bundle(j_path)), "ts": report["ts"]}
    assert report["attribution"] == "queue_wait"
    req = autopsy.request_report(bundle["trace_ring"], "ef" * 16, bundle=bundle)
    assert req["attribution"] == "queue_wait" and req["phases_ms"]["queue_wait"] == pytest.approx(450.0)
    # The CLI on the port's bundle.
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, os.path.join(REPO, "tools", "autopsy.py"), p_path, "--json"],
                         capture_output=True, text=True, timeout=60, env=env)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["attribution"] == "queue_wait"


def test_engine_bundles_match_jax(tmp_path):
    """A compile after warmup in the scrape: each package's engine writes a
    bundle through its real probes (state, the flight recorder's ring, the
    configuration, the tenant ledger's evidence), with the same keys."""
    from dynamo_tpu.engine import scheduler as jsched
    from dynamo_tpu.engine.config import get_config as jax_config
    from dynamo_tpu.engine.engine import EngineArgs as JaxEngineArgs, TpuEngine
    from dynamo_tpu.engine.models import llama as jllama
    from dynamo_tpu_torch.engine import scheduler as tsched
    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
    from dynamo_tpu_torch.engine.weights import params_from_numpy

    jp = jllama.init_params(jax_config("tiny"), jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), get_config("tiny"), device="cpu",
                           dtype=torch.float32)
    kw = dict(num_blocks=32, prefill_buckets=[16], decode_buckets=[2])
    port = TorchEngine.build(EngineArgs(model="tiny", dtype="float32", device="cpu", continuous_profiling=False,
                                        incident_dir=str(tmp_path / "p"), scheduler=tsched.SchedulerConfig(**kw)),
                             params=tp)
    ref = TpuEngine.build(JaxEngineArgs(model="tiny", dtype="float32", continuous_profiling=False,
                                        incident_dir=str(tmp_path / "j"), scheduler=jsched.SchedulerConfig(**kw)),
                          params=jp)
    bundles = []
    for engine in (port, ref):
        stats = engine.stats_handler()
        assert stats["incidents_total"] == 0 and stats["incident_last_age_s"] == -1.0
        stats["compiles_after_warmup_total"] += 1
        assert engine.incidents.observe(stats) == ["post_warmup_compile"]
        after = engine.stats_handler()
        assert after["incidents_total"] == after["incidents_post_warmup_compile_total"] == 1
        (path,) = glob.glob(os.path.join(engine.incidents.config.dir, "incident_*.json"))
        bundles.append(json.load(open(path)))
        assert set(engine.debug_state()["incidents"]) == {"bundles", "last_capture", "rate_limited_total",
                                                          "detector", "profiler"}
    pb, jb = bundles
    assert set(pb) == set(jb)
    for key in ("flight", "detector"):
        assert set(pb[key]) == set(jb[key]), key
    assert set(pb["stats"]) == set(jb["stats"])
    assert "tenant_ledger" in pb["evidence"] and "tenant_ledger" in jb["evidence"]
    assert set(pb["evidence"]["tenant_ledger"]) == set(jb["evidence"]["tenant_ledger"])
    assert set(pb["debug_state"]) == set(jb["debug_state"])
    rep = autopsy.incident_report(pb)
    assert rep["reason"] == "post_warmup_compile" and rep == {**autopsy.incident_report(jb), "ts": rep["ts"]}
    asyncio.run(port.stop())
    asyncio.run(ref.stop())


def _record(mod):
    rec = logging.LogRecord("dynamo.test", logging.WARNING, __file__, 1, "stream %s cut", ("r1",), None)
    rec.trace_id, rec.span_id, rec.request_id = "ab" * 16, "cd" * 8, "r1"
    return json.loads(mod.JsonlFormatter().format(rec))


def test_jsonl_log_lines_carry_jax_keys():
    got, want = _record(plog), _record(jlog)
    assert set(got) == set(want) == {"ts", "level", "target", "message", "trace_id", "span_id", "request_id"}
    assert {k: got[k] for k in got if k != "ts"} == {k: want[k] for k in want if k != "ts"}
    code = ("from dynamo_tpu_torch.runtime.logging import get_logger, init_logging\n"
            "init_logging()\n"
            "get_logger('dynamo.x').warning('hello %d', 7, extra={'trace_id': 'ef' * 16})\n")
    lines = {}
    for flag in ("1", ""):
        env = dict(os.environ, PYTHONPATH=REPO, DYN_LOGGING_JSONL=flag)
        res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60, env=env)
        assert res.returncode == 0, res.stderr
        lines[flag] = res.stderr.strip().splitlines()[-1]
    entry = json.loads(lines["1"])
    assert entry["message"] == "hello 7" and entry["trace_id"] == "ef" * 16 and entry["level"] == "WARNING"
    assert lines[""].endswith("W dynamo.x hello 7")  # the default stays plain text
