"""The port's device-truth profiling (``runtime/profiling.py``, on
``torch.profiler``) against the JAX package's (``jax.profiler``).

- On JAX-shaped traces (no ``cat`` fields: device processes by name, the
  "XLA Ops" thread), seeded random ones among them, plain, gzipped and cut
  at random points (a truncated ``.gz`` too), ``parse_trace_bytes`` /
  ``parse_trace_events`` give the JAX package's summary field for field.
- A Kineto-shaped trace (``cat`` fields, one pid a device, one tid a CUDA
  stream) counts only ``cat == "kernel"`` events: two overlapping streams on
  one device give the union and ``device_lanes == 1``; memcpy, memset,
  annotations and the host's ``cuda_runtime`` launches are not kernels; the
  fused window pattern counts ``fused_window_kernel`` and not the spec or
  sampler kernels.
- A window opens between scheduler iterations (the step lock) and a failed
  one releases its locks.
- A real CPU ``torch.profiler`` capture through ``DeviceProfiler`` parses;
  a profiler meant for the card in this CPU-only process fails its capture
  (never a quiet CPU capture), which ``POST /debug/profile`` answers 500.
- ``ContinuousProfiler``'s gating, duty clamp, records and stats equal
  JAX's under an injected clock; busy captures answer as JAX's do and count
  their conflicts; the route's 400s equal JAX's; ``kind=host`` answers.
- The flight recorder's measured gauges equal JAX's on the same window; an
  engine on the CPU arms the sampler after warmup, folds a window in and
  captures no graph for it.

Tolerance: exact equality (both parsers run the same float arithmetic).
"""

from __future__ import annotations

import asyncio
import dataclasses
import gzip
import http.client
import json
import random
import threading
import time

import pytest

from dynamo_tpu.engine import flight_recorder as jfr
from dynamo_tpu.runtime import profiling as jprof
from dynamo_tpu_torch.engine import flight_recorder as pfr
from dynamo_tpu_torch.runtime import profiling as pprof


def _pmeta(pid, name):
    return {"ph": "M", "pid": pid, "name": "process_name", "args": {"name": name}}


def _tmeta(pid, tid, name):
    return {"ph": "M", "pid": pid, "tid": tid, "name": "thread_name", "args": {"name": name}}


def _x(pid, tid, name, ts, dur, **extra):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": ts, "dur": dur, **extra}


def _summary(s) -> dict:
    d = dataclasses.asdict(s)
    d["top"] = s.top(5)
    d["top_share"] = s.top_share()
    return d


def jax_fixture():
    """The JAX package's fixture shape: a device lane with ops and modules
    threads, a host lane."""
    return [
        _pmeta(7, "/device:TPU:0 (fixture)"), _tmeta(7, 1, "XLA Ops"), _tmeta(7, 2, "XLA Modules"),
        _pmeta(99, "python"), _tmeta(99, 1, "main"),
        _x(7, 1, "fused_decode_window(steps=8)", 0, 100), _x(7, 1, "fused_decode_window(steps=8)", 200, 50),
        _x(7, 1, "fused_decode_window(steps=8)", 300, 50), _x(7, 1, "fusion.sample_rows", 400, 25),
        _x(7, 2, "jit_decode_window", 0, 425), _x(99, 1, "host_busy_loop", 0, 1000),
    ]


def random_jax_trace(seed: int):
    rng = random.Random(seed)
    ev = [_pmeta(3, "/device:TPU:0"), _pmeta(4, "/device:TPU:1"), _pmeta(1, "python")]
    if seed % 2:
        ev += [_tmeta(3, 1, "XLA Ops"), _tmeta(3, 2, "XLA Modules")]
    for _ in range(rng.randint(20, 60)):
        pid = rng.choice([1, 3, 3, 4])
        ev.append(_x(pid, rng.choice([1, 2]), rng.choice(["fused_decode_window", "matmul", "copy", "rms"]),
                     round(rng.uniform(0, 5000), 3), round(rng.uniform(-1, 300), 3)))
    rng.shuffle(ev)
    return ev


FIXTURES = {
    "jax-fixture": jax_fixture(),
    "nested": [_pmeta(7, "/device:TPU:0"), _x(7, 1, "outer", 0, 100), _x(7, 1, "child", 10, 30),
               _x(7, 1, "tail", 90, 30), _x(7, 2, "outer", 0, 100)],
    "no-device": [_pmeta(1, "python"), _x(1, 1, "cpu_fusion", 0, 40), _x(1, 2, "cpu_copy", 100, 10)],
    "malformed": [_pmeta(7, "/device:TPU:0"), _x(7, 1, "good", 0, 10), _x(7, 1, "neg", 20, -5),
                  {"ph": "X", "pid": 7, "tid": 1, "name": "bad", "ts": "nan?", "dur": "x"}, "not a dict",
                  {"ph": "B", "pid": 7, "tid": 1, "name": "begin", "ts": 5}],
    **{f"random-{seed}": random_jax_trace(seed) for seed in range(4)},
}


def _doc(events) -> bytes:
    return json.dumps({"traceEvents": events, "displayTimeUnit": "ns"}).encode()


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_jax_shaped_traces_parse_to_jax_summary(name):
    events = FIXTURES[name]
    assert _summary(pprof.parse_trace_events(events)) == _summary(jprof.parse_trace_events(events))
    raw = _doc([e for e in events if isinstance(e, dict)])
    rng = random.Random(name)
    cuts = [len(raw), rng.randint(10, len(raw) - 1), rng.randint(10, len(raw) - 1)]
    for data in [raw[:c] for c in cuts] + [gzip.compress(raw), gzip.compress(raw)[: len(gzip.compress(raw)) // 2]]:
        assert _summary(pprof.parse_trace_bytes(data)) == _summary(jprof.parse_trace_bytes(data))
    for pattern in ("fused_decode_window", "matmul", "nope"):
        assert (pprof.parse_trace_events(events).launch_count(pattern)
                == jprof.parse_trace_events(events).launch_count(pattern))


def test_garbage_and_empty_dirs_match_jax(tmp_path):
    for data in (b"\x00\xffnot a trace at all", b"", b"{}", b"[]"):
        assert _summary(pprof.parse_trace_bytes(data)) == _summary(jprof.parse_trace_bytes(data))
    assert pprof.load_trace_dir(str(tmp_path)) is None and pprof.load_trace_dir(str(tmp_path / "none")) is None
    (tmp_path / "run").mkdir()
    (tmp_path / "run" / "host.trace.json.gz").write_bytes(gzip.compress(_doc(jax_fixture())))
    assert _summary(pprof.load_trace_dir(str(tmp_path))) == _summary(jprof.load_trace_dir(str(tmp_path)))


def kineto_trace(devices=(0,)):
    """A Kineto-shaped window: per device two streams (tids 7 and 13) whose
    kernels overlap, a memcpy, a memset and an annotation on the lanes; the
    host's launches (``cuda_runtime``) and ops (``cpu_op``)."""
    ev = [{"ph": "M", "name": "process_name", "pid": 4242, "tid": 0, "args": {"name": "python"}}]
    for d in devices:
        ev += [{"ph": "M", "name": "process_name", "pid": d, "tid": 0, "args": {"name": f"GPU {d}"}},
               {"ph": "M", "name": "thread_name", "pid": d, "tid": 7, "args": {"name": "stream 7"}},
               {"ph": "M", "name": "thread_name", "pid": d, "tid": 13, "args": {"name": "stream 13"}}]
        k = {"cat": "kernel", "args": {"device": d, "stream": 7}}
        ev += [
            _x(d, 7, "ragged_bf16_kernel(RaggedParams)", 100, 40, **k),
            _x(d, 7, "fused_window_kernel(FusedParams)", 150, 100, **k),
            _x(d, 13, "ragged_bf16_kernel(RaggedParams)", 120, 60, cat="kernel", args={"device": d, "stream": 13}),
            _x(d, 13, "fused_spec_kernel(SpecParams)", 400, 50, cat="kernel", args={"device": d, "stream": 13}),
            _x(d, 7, "sample_rows_kernel", 460, 10, **k),
            _x(d, 7, "Memcpy HtoD (Pageable -> Device)", 90, 5, cat="gpu_memcpy", args={"device": d}),
            _x(d, 7, "Memset (Device)", 300, 20, cat="gpu_memset", args={"device": d}),
            _x(d, 7, "decode_window", 100, 400, cat="gpu_user_annotation", args={"device": d}),
        ]
    ev += [_x(4242, 1, "cudaLaunchKernel", 95, 4, cat="cuda_runtime", args={"correlation": 1}),
           _x(4242, 1, "ragged_bf16_kernel", 95, 4, cat="cuda_runtime"),
           _x(4242, 1, "aten::mm", 10, 50, cat="cpu_op"),
           {"ph": "f", "id": 1, "pid": 0, "tid": 7, "ts": 100, "cat": "ac2g", "name": "ac2g"}]
    return ev


def test_kineto_trace_counts_kernels_and_unions_streams_per_device():
    s = pprof.parse_trace_events(kineto_trace())
    assert s.device_lane_found and s.device_lanes == 1 and not s.truncated
    assert s.kernel_events == 5 and s.events_total == 11
    assert set(s.kernels) == {"ragged_bf16_kernel(RaggedParams)", "fused_window_kernel(FusedParams)",
                              "fused_spec_kernel(SpecParams)", "sample_rows_kernel"}
    # Stream 7: [100,140) [150,250) [460,470); stream 13: [120,180) [400,450):
    # the union over both streams is [100,250) [400,450) [460,470) = 210 us.
    assert s.device_time_us == 210.0 and s.wall_us == 370.0
    assert s.kernels["ragged_bf16_kernel(RaggedParams)"].count == 2
    assert s.launch_count(pprof.ContinuousProfileConfig().fused_kernel_pattern) == 1
    assert s.launch_count("ragged_bf16_kernel") == 2
    assert s.device_time_us / s.wall_us <= 1.0
    two = pprof.parse_trace_events(kineto_trace(devices=(0, 1)))
    assert two.device_lanes == 2 and two.device_time_us == 420.0 and two.kernel_events == 10
    gz = pprof.parse_trace_bytes(gzip.compress(_doc(kineto_trace())))
    assert _summary(gz) == _summary(s)
    # No kernel in a Kineto window (an idle engine, or a CPU capture): no
    # device lane, and not every duration event counted.
    idle = pprof.parse_trace_events([e for e in kineto_trace() if e.get("cat") != "kernel"])
    assert not idle.device_lane_found and idle.kernel_events == 0 and idle.device_time_us == 0.0


def test_cuda_activity_check():
    assert pprof._has_cuda_activity(_doc(kineto_trace()))
    no_kernels = _doc([e for e in kineto_trace() if e.get("cat") != "kernel"])
    assert not pprof._has_cuda_activity(no_kernels)
    assert pprof._has_cuda_activity(_doc([_x(1, 1, "aten::mm", 0, 1, cat="cpu_op")]))


def _busy_load(stop: threading.Event):
    import torch

    a = torch.randn(64, 64)
    while not stop.is_set():
        (a @ a).sum()
        time.sleep(0.001)


def test_cpu_capture_through_device_profiler_parses(tmp_path):
    prof = pprof.DeviceProfiler(out_dir=str(tmp_path), device="cpu")
    res = prof.capture(0.05, label="cpu")
    assert res["status"] == "ok", res
    s = pprof.load_trace_dir(res["path"])
    assert s is not None and not s.truncated and s.events_total >= 1
    assert s.kernel_events == 0 and not s.device_lane_found  # a CPU window holds no kernel
    st = prof.status()
    assert st["captures_total"] == 1 and st["device"] == "cpu" and st["first_start_s"] >= 0
    (window,) = st["windows"]
    assert window["label"] == "cpu" and window["path"] == res["path"] and res["window_s"] >= 0.05
    assert window["end"] - window["start"] >= 0.05 and window["start_s"] == st["first_start_s"]
    assert st["now"] >= window["end"]
    assert set(jprof.DeviceProfiler(out_dir=str(tmp_path)).status()) <= set(st)


def test_windows_open_between_steps_and_release_their_locks(tmp_path):
    """A window opens only once the scheduler's iteration lock is free, and
    a window that fails (here its ``on_open``) releases the graph-capture
    guard and the iteration lock; the next capture runs."""
    guard, step = threading.Lock(), threading.Lock()
    prof = pprof.DeviceProfiler(out_dir=str(tmp_path), device="cpu", guard=guard, step_lock=step)
    step.acquire()
    released = []

    def release_later():
        time.sleep(0.2)
        released.append(time.monotonic())
        step.release()

    t = threading.Thread(target=release_later)
    t.start()
    assert prof.capture(0.05, label="aligned")["status"] == "ok"
    t.join(5)
    (window,) = prof.status()["windows"]
    assert window["aligned"] and window["start"] >= released[0]

    def boom():
        raise RuntimeError("probe failed")

    res = prof.capture(0.05, label="boom", on_open=boom)
    assert res["status"] == "error: RuntimeError: probe failed"
    assert not guard.locked() and not step.locked()
    assert prof.capture(0.05, label="again")["status"] == "ok"


def test_card_profiler_without_cuda_fails_not_cpu(tmp_path):
    """A profiler meant for the card in a process whose torch records no
    CUDA activity fails its capture: no CPU trace is written instead."""
    prof = pprof.DeviceProfiler(out_dir=str(tmp_path), device="cuda")
    res = prof.capture(0.05, label="card")
    assert res["status"].startswith("error: RuntimeError") and "CUDA" in res["status"]
    assert prof.captures_total == 0 and pprof.load_trace_dir(str(tmp_path)) is None


def test_busy_capture_answers_as_jax(tmp_path):
    port = pprof.DeviceProfiler(out_dir=str(tmp_path), device="cpu")
    ref = jprof.DeviceProfiler(out_dir=str(tmp_path))
    for prof in (port, ref):
        prof._capture_lock.acquire()
    try:
        got = [prof.capture(0.05, label="b", wait=False) for prof in (port, ref)]
    finally:
        for prof in (port, ref):
            prof._capture_lock.release()
    assert got[0] == got[1] == {"status": "busy", "error": "a capture is already running", "label": "b"}
    assert port.capture_conflicts_total == ref.capture_conflicts_total == 1
    # Two engines' profilers share the process's one profiler: the second
    # waits (the incident path) or is busy (the HTTP path).
    other = pprof.DeviceProfiler(out_dir=str(tmp_path), device="cpu")
    results = {}
    t = threading.Thread(target=lambda: results.setdefault("a", port.capture(0.3, label="a")))
    t.start()
    deadline = time.monotonic() + 10
    while not port.status()["busy"] and time.monotonic() < deadline:
        time.sleep(0.005)
    busy = other.capture(0.05, label="b", wait=False)
    waited = other.capture(0.05, label="c", wait=True)
    t.join(10)
    assert not t.is_alive()
    assert busy["status"] == "busy" and results["a"]["status"] == "ok" and waited["status"] == "ok"
    assert other.capture_conflicts_total == 2 and other.captures_total == 1
    a_end, c_start = port.status()["windows"][-1]["end"], other.status()["windows"][-1]["start"]
    assert c_start >= a_end  # the windows never overlap


class _StubProfiler:
    """A DeviceProfiler stand-in that writes a fixed trace: the same one
    for both packages' samplers."""

    def __init__(self, tmp_path, mode="ok", events=None):
        self.tmp_path, self.mode, self.calls, self._seq = tmp_path, mode, [], 0
        self.events = events if events is not None else jax_fixture()

    def capture(self, seconds, label="manual", wait=False, on_open=None, on_close=None):
        self.calls.append((seconds, label, wait))
        if self.mode == "busy":
            return {"status": "busy"}
        if self.mode == "error":
            return {"status": "error: RuntimeError: no backend"}
        for hook in (on_open, on_close):
            if hook is not None:
                hook()
        self._seq += 1
        d = self.tmp_path / f"cap_{self._seq}_{id(self)}"
        d.mkdir()
        (d / "host.trace.json").write_text(json.dumps({"traceEvents": self.events}))
        return {"status": "ok", "path": str(d), "seconds": seconds, "label": label}


@pytest.mark.parametrize("window_s,interval_s,max_duty", [(0.25, 30.0, 0.02), (0.5, 1.0, 0.02), (0.1, 5.0, 0.05)])
def test_continuous_profiler_gating_matches_jax(tmp_path, window_s, interval_s, max_duty):
    probes = [(1e12, 2e12, 0.20, 10), (2e12, 3e12, 0.43, 13)]
    samplers = []
    for mod in (pprof, jprof):
        t = [0.0]
        it = iter(probes * 4)
        sunk = []
        cfg = mod.ContinuousProfileConfig(window_s=window_s, interval_s=interval_s, max_duty=max_duty,
                                          fused_kernel_pattern="fused_decode_window")
        cont = mod.ContinuousProfiler(_StubProfiler(tmp_path), cfg, cost_probe=lambda it=it: next(it),
                                      sink=sunk.append, clock=lambda t=t: t[0])
        samplers.append((cont, t, sunk))
    (pc, pt, psunk), (jc, jt, jsunk) = samplers
    assert pc.effective_interval_s == jc.effective_interval_s and pc.duty_cycle == jc.duty_cycle
    assert pc.duty_cycle <= max_duty + 1e-12
    for now in (0.0, interval_s * 0.5, pc.effective_interval_s, pc.effective_interval_s * 1.5,
                pc.effective_interval_s * 2.01):
        assert pc.due(now) == jc.due(now), now
        assert pc.sample_once(now=now) == jc.sample_once(now=now), now
    assert pc.sample_once(now=1.0, force=True) == jc.sample_once(now=1.0, force=True)
    assert psunk == jsunk and psunk and psunk[-1]["launches_per_fused_window"] == 1.0
    assert pc.to_stats() == jc.to_stats()
    for mode, want in (("busy", {"status": "skipped_busy"}), ("error", None)):
        p = pprof.ContinuousProfiler(_StubProfiler(tmp_path, mode=mode), clock=lambda: 0.0)
        j = jprof.ContinuousProfiler(_StubProfiler(tmp_path, mode=mode), clock=lambda: 0.0)
        got, ref = p.sample_once(force=True), j.sample_once(force=True)
        assert got == ref and (want is None or got == want)
        assert p.to_stats() == j.to_stats() and p.profiler.calls[-1][2] is False


def test_measured_window_gauges_match_jax():
    record = {"wall_s": 0.25, "device_time_s": 0.2, "flops": 1e12, "bytes": 1e11, "step_seconds": 0.19,
              "top_kernel_share": 0.6, "launches_per_fused_window": 1.0,
              "top_kernels": [{"name": "fused_window_kernel", "share": 0.6}]}
    recs = []
    for mod in (pfr, jfr):
        fr = mod.FlightRecorder()
        fr.set_cost_model(mod.StepCostModel(10**9, 2 * 10**9, 1000.0, peak_flops=1e14, peak_bw=1e12))
        fr.record_step("decode", 0.01, 4, kv_read_tokens=100)
        assert "measured_windows_total" not in fr.to_stats() and fr.measured_snapshot() is None
        fr.record_measured_window(record)
        fr.record_measured_window({**record, "launches_per_fused_window": None, "device_time_s": 0.0})
        recs.append(fr)
    keys = [k for k in recs[1].to_stats() if k.startswith("measured_")]
    assert {k: recs[0].to_stats()[k] for k in keys} == {k: recs[1].to_stats()[k] for k in keys}
    assert recs[0].measured_snapshot() == recs[1].measured_snapshot()
    assert recs[0].roofline_totals()[:3] == recs[1].roofline_totals()[:3]
    p_ring, j_ring = recs[0].ring_snapshot(), recs[1].ring_snapshot()
    assert set(p_ring) == set(j_ring) and set(p_ring["host_gap"]) == set(j_ring["host_gap"])
    cm = pfr.StepCostModel(10**9, 2 * 10**9, 1000.0, peak_flops=1e14, peak_bw=1e12)
    jcm = jfr.StepCostModel(10**9, 2 * 10**9, 1000.0, peak_flops=1e14, peak_bw=1e12)
    for f in (0.0, 1e8, 2e8 * 0.2, 2e9, 2e9 * 5.0, 2e9 * 5.01):
        assert cm.calibrate(f) == jcm.calibrate(f) and cm.flops_per_token == jcm.flops_per_token, f


def _post(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", path)
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    return resp.status, body


def test_debug_profile_route(tmp_path):
    """``POST /debug/profile``: 200 on a CPU capture, 500 on a failed
    capture, 409 while another runs, JAX's 400s, ``kind=host``'s report,
    and ``/live`` answering while a window runs."""
    from dynamo_tpu.runtime import config as jconfig
    from dynamo_tpu.runtime import health as jhealth
    from dynamo_tpu_torch.runtime import config as pconfig
    from dynamo_tpu_torch.runtime import health as phealth

    async def run():
        cpu = pprof.DeviceProfiler(out_dir=str(tmp_path / "cpu"), device="cpu")
        card = pprof.DeviceProfiler(out_dir=str(tmp_path / "card"), device="cuda")
        servers = [phealth.SystemStatusServer(phealth.SystemHealth(),
                                              config=pconfig.SystemConfig(port=0, host="127.0.0.1"), profiler=p)
                   for p in (cpu, card)]
        servers.append(jhealth.SystemStatusServer(jhealth.SystemHealth(),
                                                  config=jconfig.SystemConfig(port=0, host="127.0.0.1"),
                                                  profiler=jprof.DeviceProfiler(out_dir=str(tmp_path / "j"))))
        for s in servers:
            await s.start()
        out = {}
        try:
            pc, pk, js = (s.port for s in servers)
            for q in ("seconds=abc", "seconds=0", "seconds=61"):
                out[q] = [await asyncio.to_thread(_post, p, f"/debug/profile?{q}") for p in (pc, js)]
            window = asyncio.ensure_future(asyncio.to_thread(_post, pc, "/debug/profile?seconds=0.4"))
            while not cpu.status()["busy"]:
                await asyncio.sleep(0.005)
            out["live"] = await asyncio.to_thread(http.client.HTTPConnection("127.0.0.1", pc, timeout=5).request,
                                                  "GET", "/live")
            out["busy"] = await asyncio.to_thread(_post, pc, "/debug/profile?seconds=0.1")
            out["ok"] = await window
            out["card"] = await asyncio.to_thread(_post, pk, "/debug/profile?seconds=0.05")
            out["host"] = await asyncio.to_thread(_post, pc, "/debug/profile?seconds=0.1&kind=host")
        finally:
            for s in servers:
                await s.stop()
        return out

    out = asyncio.run(run())
    for q in ("seconds=abc", "seconds=0", "seconds=61"):
        (st, body), (jst, jbody) = out[q]
        assert st == jst == 400 and body == jbody, q
    status, body = out["ok"]
    assert status == 200 and body["kind"] == "device" and body["status"] == "ok"
    assert pprof.load_trace_dir(body["path"]) is not None
    assert out["busy"][0] == 409 and out["busy"][1]["status"] == "busy"
    status, body = out["card"]
    assert status == 500 and body["status"].startswith("error") and "CUDA" in body["status"]
    status, body = out["host"]
    assert status == 200 and body["kind"] == "host"
    assert set(body) == {"kind", "samples", "attributed", "unattributed_thread_samples", "scheduler_share", "top"}


def test_host_sampler_report_matches_jax():
    stop = threading.Event()
    t = threading.Thread(target=_busy_load, args=(stop,), daemon=True)
    t.start()
    try:
        reports = [mod.HostStackSampler(interval_s=0.002).sample_for(0.05) for mod in (pprof, jprof)]
    finally:
        stop.set()
        t.join(5)
    assert set(reports[0]) == set(reports[1]) and reports[0]["samples"] > 0


def test_engine_arms_the_sampler_after_warmup_and_folds_a_window(tmp_path):
    """A CPU engine with the sampler armed: a forced window lands in the
    flight recorder's measured keys and the stats scrape, and no step graph
    is captured after warmup."""
    import numpy as np
    import torch

    from dynamo_tpu_torch.engine.config import get_config
    from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.engine.weights import init_params
    from dynamo_tpu_torch.runtime.engine import Context

    cfg = get_config("tiny")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    engine = TorchEngine.build(EngineArgs(
        model="tiny", dtype="float32", device="cpu", warmup_ctx=64, profile_dir=str(tmp_path),
        profile_window_s=0.05, profile_interval_s=3600.0,
        scheduler=SchedulerConfig(num_blocks=64, prefill_buckets=[16, 32, 64], decode_buckets=[1, 2, 4])),
        params=params)
    assert engine.continuous_profiler.armed and engine.scheduler.flight.cost_model.calibrated

    async def run():
        async def one(prompt):
            req = {"token_ids": prompt, "sampling_options": {"temperature": 0.0}, "tenant": "t1",
                   "stop_conditions": {"max_tokens": 12, "ignore_eos": True}}
            return [t async for f in engine.generate(req, Context()) for t in f["token_ids"]]

        work = asyncio.gather(*(one(list(np.arange(1, 20 + i) % 200)) for i in range(3)))
        record = await asyncio.to_thread(engine.continuous_profiler.sample_once, None, True)
        tokens = await work
        stats = engine.stats_handler()
        await engine.stop()
        return record, tokens, stats

    record, tokens, stats = asyncio.run(run())
    assert record["status"] == "ok" and all(len(t) == 12 for t in tokens)
    assert stats["measured_windows_total"] == 1 and stats["device_profile_windows_total"] == 1
    assert stats["compiles_after_warmup_total"] == 0 and stats["cost_model_calibrated"] == 1.0
    assert stats["tenant_bills_total"] == 3 and stats["tenant_billed_output_tokens_total"] == 36
    assert not engine.continuous_profiler.armed
