"""The port's system status server (``runtime/health.py``, on
``asyncio.start_server``) against the JAX package's (aiohttp), both in one
loop with the same probes:

- every route's status and JSON keys (``/health``, ``/live``, ``/metrics``,
  ``/debug/state``, ``/debug/stacks``, ``POST /drain``, an unknown path, a
  wrong method), with and without an engine probe, a state probe and a
  drain hook;
- readiness drops when the watchdog reads a stall (a ``StallWatchdog``
  under a patched clock behind ``attach_engine``) and comes back when the
  step loop moves, and a probe that raises reads as stalled;
- ``POST /drain`` answers 202 once, flips readiness, and runs its hook once;
- ``POST /debug/profile`` with no profiler attached answers JAX's 404 (the
  attached profiler's answers are ``test_torch_profiling.py``'s);
- ``SystemConfig`` reads the ``DYN_SYSTEM_*`` variables as JAX's does, and
  the worker's status server follows them (``DYN_SYSTEM_ENABLED`` or
  ``--health-port``, the host, the starting status, endpoint readiness),
  with the engine's digests on its ``/metrics``;
- a ``TorchEngine``'s ``debug_state`` behind the port's server has the
  ``digests``, ``slo``, ``flight`` and ``watchdog`` keys.
"""

from __future__ import annotations

import asyncio
import http.client
import json

import pytest

from dynamo_tpu.runtime import config as jconfig
from dynamo_tpu.runtime import health as jhealth
from dynamo_tpu.runtime import telemetry as jtel
from dynamo_tpu_torch.runtime import config as pconfig
from dynamo_tpu_torch.runtime import health as phealth
from dynamo_tpu_torch.runtime import telemetry as ptel
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry


def _call(port: int, method: str, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request(method, path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    try:
        parsed = json.loads(body) if body else None
    except ValueError:
        parsed = body.decode()
    return resp.status, resp.getheader("Content-Type", ""), parsed


def _shape(obj):
    """JSON keys, recursively, with a stand-in for each leaf."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    return type(obj).__name__ if not isinstance(obj, list) else "list"


class Clock:
    t = 100.0

    def __call__(self):
        return self.t


async def _servers(mod, tel, cfg_mod, *, with_probes: bool, clock: Clock, state: dict, drains: list):
    health = mod.SystemHealth()
    health.set_system_ready()
    kw = {}
    if with_probes:
        dog = tel.StallWatchdog(lambda: (state["work"], state["last"]), stall_after_s=5.0, clock=clock)
        health.attach_engine(lambda: {**dog.to_stats(), "compiles_after_warmup_total": 0})

        async def drain():
            drains.append(mod.__name__)

        kw = dict(state_probe=lambda: {"running": [], "watchdog": dog.to_stats()}, drain_cb=drain)
    server = mod.SystemStatusServer(health, config=cfg_mod.SystemConfig(port=0, host="127.0.0.1"), **kw)
    await server.start()
    return server, health


ROUTES = [("GET", "/health"), ("GET", "/live"), ("GET", "/metrics"), ("GET", "/debug/state"),
          ("GET", "/debug/stacks"), ("GET", "/nowhere"), ("POST", "/health")]


@pytest.mark.parametrize("with_probes", [False, True], ids=["bare", "probes"])
def test_routes_match_jax(with_probes):
    async def run():
        clocks = (Clock(), Clock())
        state = {"work": False, "last": None}
        drains: list = []
        servers = [await _servers(m, t, c, with_probes=with_probes, clock=k, state=state, drains=drains)
                   for (m, t, c), k in zip(((phealth, ptel, pconfig), (jhealth, jtel, jconfig)), clocks)]
        try:
            out = []
            for method, path in ROUTES:
                got, want = [await asyncio.to_thread(_call, s.port, method, path) for s, _ in servers]
                out.append((method, path, got, want))
            if with_probes:
                # A stall: work queued and no step for more than 5 s.
                state.update(work=True, last=99.0)
                for k in clocks:
                    k.t = 106.0
                out.append(("GET", "/health stalled", *[await asyncio.to_thread(_call, s.port, "GET", "/health")
                                                        for s, _ in servers]))
                state.update(last=105.5)
                out.append(("GET", "/health moving", *[await asyncio.to_thread(_call, s.port, "GET", "/health")
                                                       for s, _ in servers]))
                for _ in range(2):
                    out.append(("POST", "/drain", *[await asyncio.to_thread(_call, s.port, "POST", "/drain")
                                                    for s, _ in servers]))
                out.append(("GET", "/health drained", *[await asyncio.to_thread(_call, s.port, "GET", "/health")
                                                        for s, _ in servers]))
                await asyncio.sleep(0.05)
            else:
                out.append(("POST", "/drain", *[await asyncio.to_thread(_call, s.port, "POST", "/drain")
                                                for s, _ in servers]))
            profile = [await asyncio.to_thread(_call, s.port, "POST", "/debug/profile?seconds=1")
                       for s, _ in servers]
        finally:
            for s, _ in servers:
                await s.stop()
        return out, profile, drains

    out, profile, drains = asyncio.run(run())
    for method, path, (st, ct, body), (jst, jct, jbody) in out:
        assert st == jst, (method, path, st, jst)
        assert ct.split(";")[0] == jct.split(";")[0], (path, ct, jct)
        if path == "/debug/stacks":
            assert isinstance(body, dict) and body and all(isinstance(v, list) for v in body.values())
        elif isinstance(jbody, dict):
            assert _shape(body) == _shape(jbody), path
            if "status" in jbody:
                assert body["status"] == jbody["status"], path
    statuses = {path: st for method, path, (st, _, _), _ in out if method != "POST" or path == "/drain"}
    if with_probes:
        assert statuses["/health"] == 200 and statuses["/health stalled"] == 503
        assert statuses["/health moving"] == 200 and statuses["/health drained"] == 503
        assert sorted(drains) == ["dynamo_tpu.runtime.health", "dynamo_tpu_torch.runtime.health"]
    else:
        assert statuses["/debug/state"] == 404 and statuses["/drain"] == 404
    assert profile[0][0] == profile[1][0] == 404 and profile[0][2] == profile[1][2]


def test_metrics_route_renders_the_registry():
    async def run():
        m = MetricsRegistry()
        m.counter("requests_total", "requests", model="tiny").inc(3)
        server = phealth.SystemStatusServer(phealth.SystemHealth(), metrics=m,
                                            config=pconfig.SystemConfig(port=0, host="127.0.0.1"))
        await server.start()
        try:
            return await asyncio.to_thread(_call, server.port, "GET", "/metrics")
        finally:
            await server.stop()

    status, ctype, text = asyncio.run(run())
    assert status == 200 and ctype.startswith("text/plain")
    assert 'dynamo_component_requests_total{model="tiny"} 3.0' in text


def test_engine_probe_error_reads_as_stalled():
    for mod in (phealth, jhealth):
        h = mod.SystemHealth(starting_status=mod.HEALTHY)

        def boom():
            raise RuntimeError("probe down")

        h.attach_engine(boom)
        snap = h.snapshot()
        assert snap["status"] == "notready" and snap["engine"]["probe_error"] == "probe down"
        h = mod.SystemHealth(use_endpoint_health=True)
        assert not h.is_healthy()
        h.set_endpoint_health("dynamo/backend/generate", mod.HEALTHY)
        assert h.is_healthy()
        h.set_endpoint_health("dynamo/backend/other", mod.UNHEALTHY)
        assert not h.is_healthy()


ENVS = [
    {},
    {"DYN_SYSTEM_ENABLED": "true", "DYN_SYSTEM_PORT": "9090", "DYN_SYSTEM_HOST": "127.0.0.1",
     "DYN_SYSTEM_USE_ENDPOINT_HEALTH_STATUS": "1", "DYN_SYSTEM_STARTING_HEALTH_STATUS": "ready"},
    {"DYN_SYSTEM_ENABLED": "off", "DYN_SYSTEM_USE_ENDPOINT_HEALTH_STATUS": "no"},
]


@pytest.mark.parametrize("env", range(len(ENVS)))
def test_system_config_reads_dyn_system_env_as_jax(monkeypatch, env):
    for k in ENVS[1]:
        monkeypatch.delenv(k, raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    assert vars(pconfig.SystemConfig()) == vars(jconfig.SystemConfig())
    assert vars(pconfig.Config.from_env().system) == vars(jconfig.Config.from_env().system)


def test_engine_debug_state_behind_the_server():
    """A served ``TorchEngine``: ``/debug/state`` carries its digests, SLO
    account, flight recorder and watchdog after a request, and ``/health``
    reads ready with the watchdog's keys."""
    from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.runtime.engine import Context

    async def run():
        engine = TorchEngine.build(EngineArgs(model="tiny", dtype="float32", device="cpu", eos_token_ids=[0],
                                              scheduler=SchedulerConfig(num_blocks=32, prefill_buckets=[16, 32],
                                                                        decode_buckets=[1, 2])))
        req = {"token_ids": [5, 6, 7, 8], "sampling_options": {"temperature": 0.0},
               "stop_conditions": {"max_tokens": 4, "ignore_eos": True}}
        async for _ in engine.generate(req, Context()):
            pass
        health = phealth.SystemHealth()
        health.set_system_ready()
        health.attach_engine(lambda: {**engine.watchdog.to_stats(),
                                      "compiles_after_warmup_total": engine.scheduler.flight.compiles_after_warmup_total})
        server = phealth.SystemStatusServer(health, config=pconfig.SystemConfig(port=0, host="127.0.0.1"),
                                            state_probe=engine.debug_state)
        await server.start()
        try:
            return [await asyncio.to_thread(_call, server.port, "GET", p) for p in ("/debug/state", "/health")]
        finally:
            await server.stop()
            await engine.stop()

    (st, _, state), (hst, _, snap) = asyncio.run(run())
    assert st == 200 and {"digests", "slo", "flight", "watchdog"} <= set(state)
    assert state["digests"]["ttft"]["count"] == 1 and state["flight"]["last_step_phase"] == "decode"
    assert state["watchdog"]["engine_stalled"] == 0.0 and state["watchdog"]["stall_after_s"] == 120.0
    assert hst == 200 and snap["status"] == "ready" and snap["engine"]["compiles_after_warmup_total"] == 0


WORKER_CASES = {
    # DYN_SYSTEM_* alone turns the server on: readiness is the served
    # endpoint's, none before the worker registers.
    "env": ([], {"DYN_SYSTEM_ENABLED": "1", "DYN_SYSTEM_PORT": "0", "DYN_SYSTEM_HOST": "127.0.0.1",
                 "DYN_SYSTEM_USE_ENDPOINT_HEALTH_STATUS": "1"}, 503),
    # --health-port turns it on at its port; the process starts ready.
    "flag": (["--health-port", "0"], {"DYN_SYSTEM_HOST": "127.0.0.1", "DYN_SYSTEM_STARTING_HEALTH_STATUS": "ready"},
             200),
}


@pytest.mark.parametrize("case", list(WORKER_CASES))
def test_worker_status_server_follows_dyn_system_env(monkeypatch, case):
    """The worker's status server from ``worker.system_config``: started
    before the worker registers, at ``DYN_SYSTEM_HOST`` and the port, with
    ``DYN_SYSTEM_STARTING_HEALTH_STATUS`` / ``_USE_ENDPOINT_HEALTH_STATUS``;
    ready with its endpoint once served; ``/metrics`` renders the engine's
    digests; ``POST /drain`` removes the endpoint and reads notready."""
    from dynamo_tpu_torch import worker as pworker
    from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
    from dynamo_tpu_torch.engine.scheduler import SchedulerConfig
    from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.engine import Context
    from dynamo_tpu_torch.runtime.metrics import parse_text

    flags, env, before = WORKER_CASES[case]
    for k in ENVS[1]:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("DYN_CONTROL_PLANE", "mem")
    assert not pworker.system_config(pworker.build_parser().parse_args([])).enabled
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = pworker.system_config(pworker.build_parser().parse_args(flags))
    assert cfg.enabled and cfg.port == 0 and cfg.host == "127.0.0.1"

    async def run():
        engine = TorchEngine.build(EngineArgs(model="tiny", dtype="float32", device="cpu", eos_token_ids=[0],
                                              scheduler=SchedulerConfig(num_blocks=32, prefill_buckets=[16, 32],
                                                                        decode_buckets=[1, 2])))
        drt = await DistributedRuntime.from_settings()
        server = await pworker.start_health_server(cfg, engine)
        try:
            out = {"starting": await asyncio.to_thread(_call, server.port, "GET", "/health")}
            worker = await pworker.serve_engine(drt, engine, ModelDeploymentCard(name="tiny"))
            pworker.mark_served(server, drt, worker, "dynamo/backend/generate")
            req = {"token_ids": [5, 6, 7, 8], "sampling_options": {"temperature": 0.0},
                   "stop_conditions": {"max_tokens": 3, "ignore_eos": True}}
            async for _ in engine.generate(req, Context()):
                pass
            out["served"] = await asyncio.to_thread(_call, server.port, "GET", "/health")
            out["metrics"] = await asyncio.to_thread(_call, server.port, "GET", "/metrics")
            out["drain"] = await asyncio.to_thread(_call, server.port, "POST", "/drain")
            await asyncio.sleep(0.2)
            out["drained"] = await asyncio.to_thread(_call, server.port, "GET", "/health")
            out["shutdown"] = drt.runtime.cancellation.is_cancelled()
            return out
        finally:
            await server.stop()
            await drt.shutdown()
            await engine.stop()

    out = asyncio.run(run())
    assert out["starting"][0] == before and out["starting"][2]["endpoints"] == {}
    st, _, snap = out["served"]
    assert st == 200 and snap["endpoints"] == {"dynamo/backend/generate": "ready"}
    st, ctype, text = out["metrics"]
    fam = parse_text(text)["dynamo_component_ttft_seconds"]
    assert st == 200 and ctype.startswith("text/plain") and fam["type"] == "histogram"
    assert [v for n, _, v in fam["samples"] if n.endswith("_count")] == [1.0]
    assert "dynamo_component_ttft_seconds_quantile" in parse_text(text)
    assert out["drain"][0] == 202
    st, _, snap = out["drained"]
    assert st == 503 and snap["endpoints"] == {} and out["shutdown"]
