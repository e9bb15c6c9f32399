"""The port's flight recorder (``engine/flight_recorder.py``) and the
scheduler's observability hooks against the JAX package's, on ``tiny``
(f32, CPU):

- ``FlightRecorder`` / ``StepCostModel``: the same ``record_step``,
  ``record_mixed_step`` and ``record_host_gap`` calls with explicit peaks,
  and the same fused windows (counted on the JAX recorder and laid out by
  the port's ``window_stats``), give the same scrape keys (every key, every
  value), histograms, percentiles, utilization and step digests;
- ``detect_peaks``: the CPU keeps JAX's nominal floor, an H100 gets its
  datasheet row, any other card none, and its ``mfu_*`` / ``hbm_frac_*``
  are left out of the scrape;
- the compile tracker counts graph captures after ``mark_warmup_done``;
- the port's scheduler against JAX's on the same traffic, one decode step an
  iteration (mixed steps, a preemption, a prefix hit) and 8-step windows
  (fused windows): per-phase ``steps_total`` and ``tokens_total`` equal
  (times are each package's own and not compared), the same digest streams
  with the same sample counts, and each request's trace events equal in
  name and order (both tracers on a ring, every trace recorded).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import flight_recorder as jfr
from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.engine.sampling import SamplingParams as JaxSampling
from dynamo_tpu.runtime import telemetry as jtel
from dynamo_tpu.runtime import tracing as jtracing
from dynamo_tpu_torch.engine import flight_recorder as pfr
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime import telemetry as ptel
from dynamo_tpu_torch.runtime import tracing as ptracing

TCFG, JCFG = get_config("tiny"), jax_config("tiny")
BUCKETS = dict(prefill_buckets=[32, 64], decode_buckets=[1, 2, 4])
PEAKS = dict(peak_flops=2.5e12, peak_bw=4.0e11)


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, device="cpu", dtype=torch.float32)


def _record(rec, seed: int, window) -> None:
    """A seeded mix of every recording call, the same for both packages;
    ``window(sampled)`` counts one fused window where each package counts it
    (JAX's recorder, the port's scheduler)."""
    rng = np.random.default_rng(seed)
    for _ in range(400):
        op = int(rng.integers(0, 6))
        dur = float(rng.exponential(0.01))
        if op == 0:
            rec.record_step("prefill", dur, int(rng.integers(1, 512)), kv_read_tokens=int(rng.integers(0, 900)))
        elif op == 1:
            passes = float(rng.choice([1.0, 8.0]))
            rec.record_step("decode", dur, int(rng.integers(1, 64)), kv_read_tokens=int(rng.integers(0, 9000)),
                            param_passes=passes)
        elif op == 2:
            rec.record_mixed_step(dur, int(rng.integers(0, 256)), int(rng.integers(0, 32)),
                                  kv_read_prefill=int(rng.integers(0, 500)), kv_read_decode=int(rng.integers(0, 5000)))
        elif op == 3:
            rec.record_step(str(rng.choice(["wave", "spec"])), dur, int(rng.integers(1, 128)),
                            kv_read_tokens=int(rng.integers(0, 2000)))
        elif op == 4:
            rec.record_host_gap(float(rng.exponential(0.002)))
        else:
            window(int(rng.integers(0, 2)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recorder_stats_equal_jax(seed):
    class Clock:
        t = 50.0

        def __call__(self):
            return self.t

    cj, cp = Clock(), Clock()
    j = jfr.FlightRecorder(telemetry=jtel.Telemetry(clock=cj))
    p = pfr.FlightRecorder(telemetry=ptel.Telemetry(clock=cp))
    cost = (106816, 427264, 512.0)
    j.set_cost_model(jfr.StepCostModel(*cost, kv_read_factor=1.0, **PEAKS))
    p.set_cost_model(pfr.StepCostModel(*cost, kv_read_factor=1.0, **PEAKS))
    def j_window(sampled: int) -> None:
        j.fused_windows_total += 1
        j.fused_sampled_windows_total += sampled
        j.record_window_launches(1)

    windows = [0, 0]

    def p_window(sampled: int) -> None:
        windows[0] += 1
        windows[1] += sampled

    _record(j, seed, j_window)
    _record(p, seed, p_window)
    assert windows[0] > 0
    assert {**p.to_stats(), **pfr.window_stats(windows[0], windows[1], 1, 0, 0)} == j.to_stats()
    for phase in ("prefill", "decode", "mixed", "wave", "spec", "host_gap"):
        assert p.histogram(phase) == j.histogram(phase)
    assert [p.gap_percentile(q) for q in (0.5, 0.99)] == [j.gap_percentile(q) for q in (0.5, 0.99)]
    assert p.utilization() == j.utilization()
    assert p.telemetry.to_wire() == j.telemetry.to_wire()
    assert [(ph, d, t) for _, ph, d, t in p.recent_steps] == [(ph, d, t) for _, ph, d, t in j.recent_steps]
    cm_j, cm_p = j.cost_model, p.cost_model
    assert cm_p.step_cost(40, 700, 3.0) == cm_j.step_cost(40, 700, 3.0)
    assert cm_p.roofline_time(1e9, 1e8) == cm_j.roofline_time(1e9, 1e8)


def test_peaks_are_the_cards_or_none(monkeypatch):
    assert pfr.detect_peaks("cpu") == jfr._CPU_PEAKS == (1e12, 100e9)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert pfr.detect_peaks("cuda:0") == (989.4e12, 3.35e12)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA A100-SXM4-80GB")
    assert pfr.detect_peaks("cuda:0") is None
    # A card with no row: FLOPs and bytes are counted, no MFU is made up.
    cm = pfr.StepCostModel(1000, 4000, 8.0, device="cuda:0")
    assert not cm.has_peaks and cm.roofline_time(1e9, 1e9) == 0.0
    rec = pfr.FlightRecorder()
    rec.set_cost_model(cm)
    rec.record_step("decode", 0.01, 4, kv_read_tokens=100)
    rec.record_mixed_step(0.02, 16, 4, kv_read_prefill=10, kv_read_decode=100)
    stats = rec.to_stats()
    assert stats["step_decode_flops_total"] > 0 and stats["step_decode_bytes_total"] > 0
    assert not any(k.startswith(("mfu_", "hbm_frac_")) for k in stats) and rec.utilization() == {}


def test_compile_tracker_counts_captures_after_warmup():
    captures = [3]
    rec = pfr.FlightRecorder(compile_probe=lambda: captures[0])
    assert (rec.compiles_total, rec.compiles_after_warmup_total) == (3, 0)
    rec.mark_warmup_done(warmed=True)
    captures[0] = 5
    stats = rec.to_stats()
    assert (stats["compiles_total"], stats["compiles_after_warmup_total"]) == (5, 2)
    assert rec.debug_state()["compiles_after_warmup_total"] == 2


def _trace():
    """(arrival step, request id, prompt, max_tokens): C shares A's first
    two blocks and arrives while A decodes (a mixed step and a prefix hit);
    the pool cannot hold all of them at their final lengths (a
    preemption)."""
    rng = np.random.default_rng(0)
    a = rng.integers(1, 255, size=40).tolist()
    return [
        (0, "A", a, 30),
        (2, "B", rng.integers(1, 255, size=80).tolist(), 20),
        (4, "C", a[:32] + rng.integers(1, 255, size=10).tolist(), 25),
        (6, "D", rng.integers(1, 255, size=20).tolist(), 40),
        (60, "E", a[:32] + rng.integers(1, 255, size=5).tolist(), 10),
    ]


def _replay(sched, mod, sampling_cls, tracer) -> dict:
    """Replay ``_trace()`` greedily, every request traced (trace id = its
    request id, padded); → {request id: [event names in order]}."""
    for step in range(400):
        for at, rid, prompt, max_tokens in _trace():
            if at == step:
                sched.add_request(rid, prompt, sampling_cls(temperature=0.0),
                                  mod.StopConditions(max_tokens=max_tokens),
                                  trace=(rid.lower() * 32, "ab" * 8))
        if step > _trace()[-1][0] and not sched.has_work():
            break
        sched.step()
    assert not sched.has_work()
    events = {}
    for rec in tracer.ring_records():
        assert rec["service"] == "scheduler" and rec["parent_id"] == "ab" * 8
        events.setdefault(rec["attrs"]["request_id"], []).append(rec["name"])
    return events


CONFIGS = {
    "one-step": (dict(num_blocks=16, max_running=4, mixed_prefill_budget=32, num_scheduler_steps=1), "gather"),
    "windows": (dict(num_blocks=24, max_running=4, mixed_prefill_budget=32, num_scheduler_steps=8), "megakernel"),
}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_scheduler_steps_tokens_and_trace_events_match_jax(weights, config):
    jp, tp = weights
    kw, jax_attn = CONFIGS[config]
    jt = jtracing.configure_tracing(path=None, sample=1.0, service="test", ring_size=10000)
    pt = ptracing.configure_tracing(path=None, sample=1.0, service="test", ring_size=10000)
    try:
        j = jsched.Scheduler(JCFG.replace(attention_impl=jax_attn), jp, jsched.SchedulerConfig(**kw, **BUCKETS),
                             dtype=jnp.float32, eos_token_ids=[0])
        t = tsched.Scheduler(TCFG, tp, tsched.SchedulerConfig(**kw, **BUCKETS), dtype=torch.float32, device="cpu",
                             eos_token_ids=[0])
        want = _replay(j, jsched, JaxSampling, jt)
        got = _replay(t, tsched, SamplingParams, pt)
    finally:
        jtracing.configure_tracing(path=None, sample=0.0)
        ptracing.configure_tracing(path=None, sample=0.0)
    assert got == want
    assert {"queued", "admitted", "first_token", "finish"} <= set(got["A"])
    ps, js = {**t.flight.to_stats(), **t.window_stats()}, j.flight.to_stats()
    counted = [k for k in js if k.startswith("step_") and k.endswith(("_steps_total", "_tokens_total"))]
    assert counted and {k: ps[k] for k in counted} == {k: js[k] for k in counted}
    assert ps["decode_host_gap_events_total"] == js["decode_host_gap_events_total"]
    if config == "windows":
        assert ps["fused_windows_total"] == js["fused_windows_total"] > 0
        assert ps["fused_window_pallas_launches"] == js["fused_window_pallas_launches"] == 1
    else:
        assert t.preempt_total >= 1 and ps["step_mixed_steps_total"] > 0
    assert {n: d["total"]["count"] for n, d in t.telemetry.to_wire().items()} == {
        n: d["total"]["count"] for n, d in j.telemetry.to_wire().items()}
    assert t.slo.to_stats() == j.slo.to_stats()
