"""The port's telemetry plane (``runtime/telemetry.py``, ``runtime/metrics.py``)
against the JAX package's, on the same seeded inputs:

- ``LatencyDigest``: the same observations give the same quantiles, ranks,
  histograms and ``to_wire`` bytes (JSON, keys sorted), and digests merge
  across the two packages through their wires, either way; ``WindowedDigest``
  and ``Telemetry`` under one patched clock give the same snapshots, wires
  and summaries;
- ``SloJudge``: the same verdicts, counters, attainment and goodput rates
  under a patched clock;
- ``StallWatchdog``: the same stall edges, counters and ages under a
  patched clock;
- ``MetricsRegistry.render()`` against ``prometheus_client``'s output for
  the same operations: families, types, help, label sets and sample values
  equal (a ``_created`` sample's value is a wall time, so only its presence
  and labels are compared), and the label-mismatch refusal;
- ``DigestCollector`` (live and fleet-merged) renders JAX's families and
  samples.

Tolerances: none; every value compared is equal, floats to the last bit.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
from prometheus_client import CollectorRegistry as PromRegistry

from dynamo_tpu.runtime import metrics as jmetrics
from dynamo_tpu.runtime import telemetry as jtel
from dynamo_tpu_torch.runtime import metrics as pmetrics
from dynamo_tpu_torch.runtime import telemetry as ptel


def _samples(seed: int, n: int = 2000) -> list:
    """Latency-like samples over six decades, zeros and sub-floor values
    among them."""
    rng = np.random.default_rng(seed)
    x = np.exp(rng.normal(-4.0, 2.0, n))
    x[rng.integers(0, n, n // 50)] = 0.0
    x[rng.integers(0, n, n // 100)] = 1e-12
    return [float(v) for v in x]


def _wire_bytes(d) -> bytes:
    return json.dumps(d.to_wire(), sort_keys=True).encode()


@pytest.mark.parametrize("re", [0.01, 0.02, 0.05])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_digest_quantiles_and_wire_bytes_equal(seed, re):
    j, p = jtel.LatencyDigest(re), ptel.LatencyDigest(re)
    for v in _samples(seed):
        j.observe(v)
        p.observe(v)
    qs = [0.0, 0.001, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0]
    assert p.percentiles(qs) == j.percentiles(qs)
    assert [p.rank(v) for v in (1e-4, 0.01, 0.5)] == [j.rank(v) for v in (1e-4, 0.01, 0.5)]
    assert p.histogram(ptel.DIGEST_HISTOGRAM_BOUNDS) == j.histogram(jtel.DIGEST_HISTOGRAM_BOUNDS)
    assert (p.mean, p.count, p.zero_count) == (j.mean, j.count, j.zero_count)
    assert _wire_bytes(p) == _wire_bytes(j)


def test_digests_merge_across_packages():
    """A JAX digest merged from a port worker's wire equals the digest of
    both streams, and the reverse."""
    a, b = _samples(3), _samples(4)
    pa, ja = ptel.LatencyDigest(), jtel.LatencyDigest()
    pb, jb = ptel.LatencyDigest(), jtel.LatencyDigest()
    both = jtel.LatencyDigest()
    for v in a:
        pa.observe(v)
        ja.observe(v)
        both.observe(v)
    for v in b:
        pb.observe(v)
        jb.observe(v)
        both.observe(v)
    into_jax = jtel.LatencyDigest.from_wire(ja.to_wire()).merge(jtel.LatencyDigest.from_wire(pb.to_wire()))
    into_port = ptel.LatencyDigest.from_wire(pa.to_wire()).merge(ptel.LatencyDigest.from_wire(jb.to_wire()))
    assert _wire_bytes(into_jax) == _wire_bytes(both) == _wire_bytes(into_port)
    with pytest.raises(ValueError, match="different relative error"):
        ptel.LatencyDigest(0.01).merge(ptel.LatencyDigest(0.02))


class Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def test_windowed_digests_and_telemetry_equal_under_one_clock():
    cj, cp = Clock(), Clock()
    tj = jtel.Telemetry(window_s=60.0, clock=cj)
    tp = ptel.Telemetry(window_s=60.0, clock=cp)
    rng = np.random.default_rng(5)
    for i, v in enumerate(_samples(6, 600)):
        name = ("ttft", "tpot", "itl")[i % 3]
        tj.observe(name, v)
        tp.observe(name, v)
        dt = float(rng.exponential(0.5))
        cj.t += dt
        cp.t += dt
        if i % 100 == 0:
            assert json.dumps(tp.to_wire(), sort_keys=True) == json.dumps(tj.to_wire(), sort_keys=True)
    assert tp.names() == tj.names()
    assert tp.summary() == tj.summary()
    assert json.dumps(tp.to_wire(), sort_keys=True) == json.dumps(tj.to_wire(), sort_keys=True)


SLO_CASES = [(200.0, 50.0), (200.0, None), (None, 30.0), (None, None)]


@pytest.mark.parametrize("ttft_ms,tpot_ms", SLO_CASES)
def test_slo_judge_verdicts_and_goodput_equal(ttft_ms, tpot_ms):
    cj, cp = Clock(), Clock()
    j = jtel.SloJudge(jtel.SloConfig(ttft_ms, tpot_ms), clock=cj)
    p = ptel.SloJudge(ptel.SloConfig(ttft_ms, tpot_ms), clock=cp)
    rng = np.random.default_rng(7)
    for i in range(300):
        ttft = float(rng.exponential(0.2))
        tpot = None if i % 7 == 0 else float(rng.exponential(0.04))
        n = int(rng.integers(1, 200))
        assert p.judge(ttft, tpot, n) == j.judge(ttft, tpot, n)
        dt = float(rng.exponential(0.3))
        cj.t += dt
        cp.t += dt
        if i % 50 == 0:
            assert p.to_stats() == j.to_stats()
    assert p.to_stats() == j.to_stats()
    assert p.attainment() == j.attainment() and p.goodput_rates() == j.goodput_rates()


def test_stall_watchdog_equal_under_one_clock():
    cj, cp = Clock(), Clock()
    state = {"work": False, "last": None}

    def probe():
        return state["work"], state["last"]

    j = jtel.StallWatchdog(probe, stall_after_s=5.0, clock=cj)
    p = ptel.StallWatchdog(probe, stall_after_s=5.0, clock=cp)
    script = [(1.0, True, None), (3.0, True, None), (2.0, True, None), (0.5, True, 1006.0), (6.0, True, 1006.0),
              (1.0, False, 1006.0), (1.0, True, 1014.0), (9.0, True, 1014.0), (0.1, True, 1014.0)]
    seen = []
    for dt, work, last in script:
        cj.t += dt
        cp.t += dt
        state.update(work=work, last=last)
        assert p.check() == j.check()
        assert p.to_stats() == j.to_stats()
        seen.append(p.to_stats()["engine_stalled"])
    assert seen == [0.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 1.0, 1.0] and p.stalls_total == j.stalls_total == 3


def _ops(m) -> None:
    """The same operations on a registry of either package."""
    m.counter("requests_total", "HTTP re\\quests\nby status", model='a"b', status="200").inc(2)
    m.counter("requests_total", "HTTP re\\quests\nby status", model='a"b', status="404").inc()
    m.gauge("inflight_requests", "in-flight", model="x").inc()
    m.gauge("inflight_requests", "in-flight", model="x").dec(3)
    m.gauge("goodput_requests_per_s", "plain gauge").set(1.5e9)
    h = m.histogram("time_to_first_token_seconds", "TTFT", buckets=jmetrics.TTFT_BUCKETS, model="m")
    for v in (0.0004, 0.001, 0.3, 5.0, 100.0):
        h.observe(v)
    m.histogram("default_buckets_seconds", "d").observe(0.07)
    m.counter("plain_events", "no labels, no _total")
    child = m.child(worker="w1")
    child.counter("x_total", "inherits labels").inc(0.5)
    child.gauge("circuit_open", "per-worker", extra="e").set(0.5)


def _families(text: str) -> dict:
    fams = pmetrics.parse_text(text)
    out = {}
    for name, fam in fams.items():
        samples = sorted((n, tuple(sorted(lab.items())), None if n.endswith("_created") else v)
                         for n, lab, v in fam["samples"])
        out[name] = (fam["type"], fam["help"], samples)
    return out


@pytest.mark.parametrize("prefix", [pmetrics.COMPONENT_PREFIX, pmetrics.FRONTEND_PREFIX])
def test_registry_render_equals_prometheus_client(prefix):
    j = jmetrics.MetricsRegistry(registry=PromRegistry(), prefix=prefix)
    p = pmetrics.MetricsRegistry(prefix=prefix)
    _ops(j)
    _ops(p)
    jt, pt = j.render().decode(), p.render().decode()
    assert _families(pt) == _families(jt)
    # Line for line, but the _created values.
    strip = lambda s: [ln.rsplit(" ", 1)[0] if "_created" in ln and not ln.startswith("#") else ln  # noqa: E731
                       for ln in s.splitlines()]
    assert strip(pt) == strip(jt)
    # A metric name reused under another label set is refused, as in JAX.
    for m in (j, p):
        with pytest.raises(ValueError, match="already registered with labels"):
            m.child(other="1").counter("x_total", "inherits labels")


def test_digest_collector_renders_jax_families():
    cj, cp = Clock(), Clock()
    tj, tp = jtel.Telemetry(clock=cj), ptel.Telemetry(clock=cp)
    for i, v in enumerate(_samples(9, 300)):
        tj.observe(("ttft", "request")[i % 2], v)
        tp.observe(("ttft", "request")[i % 2], v)
    jreg, preg = PromRegistry(), pmetrics.CollectorRegistry()
    jtel.DigestCollector("dynamo_frontend_", registry=jreg, telemetry=tj)
    ptel.DigestCollector("dynamo_frontend_", registry=preg, telemetry=tp)
    from prometheus_client import generate_latest

    assert pmetrics.generate_latest(preg).decode() == generate_latest(jreg).decode()
    # Fleet mode: per-worker wires merged (a port worker's beside a JAX one's).
    jfleet, pfleet = PromRegistry(), pmetrics.CollectorRegistry()
    jc = jtel.DigestCollector("dynamo_component_", registry=jfleet)
    pc = ptel.DigestCollector("dynamo_component_", registry=pfleet)
    wires = [tj.to_wire(), tp.to_wire()]
    jc.update_from_wire(wires)
    pc.update_from_wire(wires)
    assert pmetrics.generate_latest(pfleet).decode() == generate_latest(jfleet).decode()


@pytest.mark.parametrize("value", [0.0, 1.0, 0.1, 1e-9, 123456.0, 1234567.0, 1.5e9, float("inf"), -2.5, float("nan")])
def test_float_format_equals_prometheus_client(value):
    from prometheus_client.utils import floatToGoString

    assert pmetrics.float_to_go_string(value) == floatToGoString(value)
