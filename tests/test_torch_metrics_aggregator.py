"""The port's metrics aggregator (``metrics_aggregator.py``) against the JAX
package's, and the port's registries against ``test_metrics_hygiene.py``'s
rules and the Grafana dashboard's families.

- The key lists are JAX's; the same scrapes (every key, digests, tenant
  ledgers; a second scrape for the deltas, a worker restart) render the
  same families with the same samples (``prometheus_client`` adds
  ``_created`` samples, which the port's exposition leaves out).
- ``worker_lost`` fires on an instance-set shrink, as JAX's does, and its
  fleet bundle names the lost worker.
- The CLI (``python -m dynamo_tpu_torch.metrics_aggregator``) scrapes a
  served endpoint over the port's control plane, serves ``/metrics``,
  counts a lost worker and exits 0 on SIGTERM, importing no torch.
- The port's frontend, worker and aggregator registries pass the hygiene
  rules; every family the dashboard reads is in the port's rendering.

Tolerance: exact equality of sample values.
"""

from __future__ import annotations

import asyncio
import glob
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from dynamo_tpu import metrics_aggregator as jagg
from dynamo_tpu.runtime import ledger as jledger
from dynamo_tpu.runtime import telemetry as jtel
from dynamo_tpu_torch import metrics_aggregator as pagg
from dynamo_tpu_torch.runtime import ledger as pledger
from dynamo_tpu_torch.runtime import telemetry as ptel
from dynamo_tpu_torch.runtime.metrics import parse_text
from test_metrics_hygiene import _DEFAULT_LE, parse_families

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_key_lists_are_jax():
    assert pagg.GAUGE_KEYS == jagg.GAUGE_KEYS and pagg.COUNTER_KEYS == jagg.COUNTER_KEYS
    assert pagg.DIGEST_KEYS == jagg.DIGEST_KEYS and pagg.FLEET_DIGEST_PREFIX == jagg.FLEET_DIGEST_PREFIX
    assert pagg.TENANT_FAMILY_BY_DIM == jagg.TENANT_FAMILY_BY_DIM


def _scrapes(tel, led_mod, slo_cls, n_workers=2):
    """Per worker: every key, digests, a tenant ledger; the second scrape
    moves every counter, the third restarts worker 0."""
    out = []
    for scrape in range(3):
        stats = {}
        for w in range(n_workers):
            t = tel.Telemetry()
            for i, name in enumerate(pagg.DIGEST_KEYS):
                for j in range(3 + scrape + w):
                    t.observe(name, 0.01 * (i + 1) * (j + 1))
            led = led_mod.TenantLedger(top_k=2, slo=slo_cls(ttft_ms=100.0, tpot_ms=10.0), clock=lambda: 50.0)
            for j, tenant in enumerate(["a", "b", "c", "a"][: 2 + scrape + w]):
                led.record(led_mod.RequestBill(tenant=tenant, prefill_device_s=0.1 * (j + 1), decode_device_s=0.2,
                                               kv_block_s=1.0 + j, queue_s=0.01, output_tokens=8, ttft_s=0.05,
                                               tpot_s=0.002 * (j + 1) * 10))
            value = 1.0 + scrape * 2.0 + w if not (scrape == 2 and w == 0) else 0.5
            stats[0xA0 + w] = {**{k: value for k in pagg.GAUGE_KEYS + pagg.COUNTER_KEYS},
                               "digests": t.to_wire(), "tenant_ledger": led.to_wire()}
        out.append(stats)
    return out


def _samples(text: str) -> dict:
    fams = parse_text(text)
    return {name: (f["type"], sorted((n, tuple(sorted(l.items())), v) for n, l, v in f["samples"]
                                     if not n.endswith("_created")))
            for name, f in fams.items()}


def test_same_scrapes_render_the_same_families():
    p = pagg.MetricsAggregator(drt=None, namespace="ns", component="backend", endpoint="generate")
    j = jagg.MetricsAggregator(drt=None, namespace="ns", component="backend", endpoint="generate")
    for ps, js in zip(_scrapes(ptel, pledger, ptel.SloConfig), _scrapes(jtel, jledger, jtel.SloConfig)):
        p.export_stats(ps)
        j.export_stats(js)
    got, want = _samples(p.registry.render().decode()), _samples(j.registry.render().decode())
    assert got.keys() == want.keys()
    for fam in want:
        assert got[fam] == want[fam], fam
    assert 'tenant="other"' in p.registry.render().decode()


def test_worker_lost_fires_on_a_shrink(tmp_path):
    aggs = [mod.MetricsAggregator(drt=None, namespace="ns", component="backend", endpoint="generate",
                                  incident_dir=str(tmp_path / name)) for mod, name in ((pagg, "p"), (jagg, "j"))]
    plans = [{0xA: {"num_running": 1}, 0xB: {"num_running": 2}}, {0xA: {"num_running": 1}},
             {0xA: {"num_running": 1}, 0xC: {"num_running": 0}}, {0xC: {"num_running": 0}}]
    counts = []
    for agg in aggs:
        seen = []
        for stats in plans:
            agg.export_stats(stats)
            # incident_last_age_s reads the wall clock: each package its own.
            seen.append({k: v for k, v in agg.incidents.to_stats().items() if k != "incident_last_age_s"})
        counts.append(seen)
    assert counts[0] == counts[1]
    assert [s["incidents_worker_lost_total"] for s in counts[0]] == [0, 1, 1, 1]  # debounced 60 s
    for agg, name in zip(aggs, ("p", "j")):
        text = agg.registry.render().decode()
        assert re.search(r"^dynamo_component_fleet_incidents_worker_lost_total\S* 1\.0$", text, re.M), name
    (path,) = glob.glob(str(tmp_path / "p" / "incident_*_worker_lost.json"))
    bundle = json.load(open(path))
    assert bundle["reason"] == "worker_lost" and bundle["detail"] == {"value": 1.0, "baseline": 2.0}
    assert set(bundle["debug_state"]["last_scrape"]) == {"a"} and bundle["config"]["role"] == "metrics_aggregator"
    (jpath,) = glob.glob(str(tmp_path / "j" / "incident_*_worker_lost.json"))
    assert set(bundle) == set(json.load(open(jpath)))


def _frontend_registry():
    from dynamo_tpu_torch.llm.discovery import ModelManager
    from dynamo_tpu_torch.llm.http.service import HttpService

    service = HttpService(ModelManager(), host="127.0.0.1", port=0, slo=ptel.SloConfig(ttft_ms=100.0, tpot_ms=20.0))
    model = "hygiene-model"
    service._m_requests(model, "200").inc()
    service._m_inflight(model).set(1)
    service._m_ttft(model).observe(0.1)
    service._m_itl(model).observe(0.01)
    service._m_duration(model).observe(0.5)
    service._m_queue(model).observe(0.02)
    service._m_output_tokens(model).inc(10)
    service._m_input_tokens(model).inc(20)
    service.note_migration(model)
    t0 = time.monotonic()
    service._record_request_telemetry(model, t0 - 0.05, t0 - 0.04, t0, 8)
    service._record_request_telemetry(model, t0 - 5.0, t0 - 0.1, t0, 8)
    return service.metrics


def _worker_registry():
    from dynamo_tpu_torch.runtime.metrics import COMPONENT_PREFIX, MetricsRegistry

    tel = ptel.Telemetry()
    for name in pagg.DIGEST_KEYS:
        tel.observe(name, 0.1)
    metrics = MetricsRegistry(prefix=COMPONENT_PREFIX)
    ptel.DigestCollector(COMPONENT_PREFIX, registry=metrics.registry, telemetry=tel)
    return metrics


def _aggregator_registry():
    agg = pagg.MetricsAggregator(drt=None, namespace="ns", component="backend", endpoint="generate")
    for stats in _scrapes(ptel, pledger, ptel.SloConfig)[:2]:
        agg.export_stats(stats)
    return agg.registry


@pytest.mark.parametrize("make", [_frontend_registry, _worker_registry, _aggregator_registry],
                         ids=["frontend", "worker", "aggregator"])
def test_port_registries_pass_the_hygiene_rules(make):
    text = make().render().decode()
    fams = parse_families(text)
    assert fams
    names = re.findall(r"# TYPE (\S+) ", text)
    assert len(names) == len(set(names)), sorted(names)
    for name, fam in fams.items():
        if fam["type"] == "counter":
            assert any(s.endswith("_total") for s in fam["samples"]), name
        if fam["type"] == "histogram":
            assert fam["le"] and fam["le"] != _DEFAULT_LE, name
    if make is _aggregator_registry:
        for key in pagg.COUNTER_KEYS:
            fam = f"dynamo_component_worker_{key}"
            assert fams.get(fam if fam.endswith("_total") else fam + "_total", {}).get("type") == "counter", key


def test_dashboard_families_are_in_the_port_rendering():
    with open(os.path.join(REPO, "deploy", "grafana", "dynamo_tpu_serving.json")) as f:
        dash = json.load(f)
    families = {re.sub(r"_(bucket|sum|count)$", "", m) for p in dash["panels"] for t in p["targets"]
                for m in re.findall(r"dynamo_[a-z0-9_]+", t["expr"])}
    rendered = set(parse_text(_aggregator_registry().render().decode())) | set(
        parse_text(_frontend_registry().render().decode()))
    # prometheus_client names a counter family without _total; the port's
    # exposition does too: a rate() over name_total reads that family.
    rendered |= {f + "_total" for f in rendered}
    missing = sorted(f for f in families if f not in rendered)
    assert not missing, missing
    assert any(f.startswith("dynamo_component_") for f in families)
    assert any(f.startswith("dynamo_frontend_") for f in families)


async def _serve_stats(address: str, stats: dict):
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.runtime import Runtime
    from dynamo_tpu_torch.runtime.transports import tcp_control as ptcp

    conn = await ptcp.connect_control_plane(address)
    drt = DistributedRuntime(runtime=Runtime(), store=ptcp.TcpKvStore(conn), bus=ptcp.TcpPubSub(conn))
    await drt.start()

    async def generate(request, context):
        yield {}

    ep = drt.namespace("dynamo").component("backend").endpoint("generate")
    handle = await ep.serve_endpoint(generate, stats_handler=lambda: stats)
    return drt, handle


def _metrics(port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        return r.read().decode()


def test_cli_scrapes_serves_and_counts_a_lost_worker(tmp_path):
    from dynamo_tpu_torch.runtime.transports import tcp_control as ptcp

    async def run():
        server = ptcp.ControlPlaneServer(host="127.0.0.1", port=0)
        await server.start()
        address = f"127.0.0.1:{server.port}"
        workers = []
        for i in range(2):
            led = pledger.TenantLedger()
            led.record(pledger.RequestBill(tenant=f"t{i}", decode_device_s=0.5, output_tokens=4))
            workers.append(await _serve_stats(address, {"num_running": i, "request_total": 3 + i,
                                                        "tenant_ledger": led.to_wire(), **led.to_stats()}))
        env = dict(os.environ, PYTHONPATH=REPO, DYN_CONTROL_PLANE="tcp", DYN_CONTROL_PLANE_ADDRESS=address,
                   DYN_LOG="INFO")
        code = ("import runpy, sys\n"
                "sys.argv = ['metrics_aggregator'] + sys.argv[1:]\n"
                "runpy.run_module('dynamo_tpu_torch.metrics_aggregator', run_name='__main__')\n"
                "assert 'torch' not in sys.modules, 'the aggregator imported torch'\n")
        log = tmp_path / "aggregator.log"
        with open(log, "w") as err:
            proc = subprocess.Popen([sys.executable, "-c", code, "--endpoint", "dynamo/backend/generate", "--port",
                                     "0", "--interval", "0.2", "--incident-dir", str(tmp_path)], env=env, stderr=err)
        try:
            port = None
            deadline = time.monotonic() + 30
            while port is None and time.monotonic() < deadline and proc.poll() is None:
                m = re.search(r"metrics aggregator serving :(\d+)/metrics", log.read_text())
                port = int(m.group(1)) if m else None
                await asyncio.sleep(0.05)
            assert port, log.read_text()
            text = ""
            workers_2 = re.compile(r"^dynamo_component_workers\{[^}]*\} 2\.0$", re.M)
            lost_1 = re.compile(r"^dynamo_component_fleet_incidents_worker_lost_total\{[^}]*\} 1\.0$", re.M)
            while not workers_2.search(text) and time.monotonic() < deadline:
                text = await asyncio.to_thread(_metrics, port)
                await asyncio.sleep(0.1)
            fams = parse_text(text)
            assert {"dynamo_component_worker_request_total", "dynamo_component_tenant_device_seconds_total",
                    "dynamo_component_fleet_incidents_worker_lost_total"} <= set(fams)
            drt, handle = workers.pop()
            await handle.stop()
            await drt.shutdown()
            while not lost_1.search(text) and time.monotonic() < deadline:
                text = await asyncio.to_thread(_metrics, port)
                await asyncio.sleep(0.1)
            assert lost_1.search(text), text
            proc.send_signal(signal.SIGTERM)
            code = await asyncio.to_thread(proc.wait, 30)
            assert code == 0, log.read_text()
        finally:
            if proc.poll() is None:
                proc.kill()
            for drt, handle in workers:
                await handle.stop()
                await drt.shutdown()
            await server.close()
        return code

    assert asyncio.run(run()) == 0
    (path,) = glob.glob(str(tmp_path / "incident_*_worker_lost.json"))
    assert json.load(open(path))["reason"] == "worker_lost"
