"""The elastic capacity dial, the first-token counters and the engine's
introspection against the JAX package's, on ``tiny`` (f32, CPU):

- ``Scheduler.set_capacity_dial``'s applied values for fractions in [0, 1]
  and past both ends (clamped), over several configurations, and the
  mixed-step warm buckets across the dial's range, equal the JAX
  scheduler's;
- ``TorchEngine.stats_handler``'s key set is the JAX engine's less the keys
  of its profiler, tenant-ledger and incident planes (ROADMAP Queue 1 item
  18, second part), listed here by name; the flight recorder's, SLO,
  watchdog and digest keys (its first part) are there under JAX's names;
- on the same traffic (a dial of 0.9, then bursts) both engines give the
  same tokens and the same ``first_tokens_total``, and the port's wait
  sums are the queue and prefill times of its first tokens;
- ``set_dial`` over the wire: a worker applies it and answers the applied
  values, which its stats scrape then reports;
- ``debug_state``'s keys are the JAX engine's, less the incident plane's.
"""

import asyncio

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.engine import EngineArgs as JaxEngineArgs
from dynamo_tpu.engine.engine import TpuEngine
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch import worker as pworker
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.engine import EngineArgs, TorchEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.runtime import msgpack_codec
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.runtime import Runtime
from dynamo_tpu_torch.runtime.transports import tcp_control as ptcp

TCFG, JCFG = get_config("tiny"), jax_config("tiny")
BUCKETS = dict(prefill_buckets=[32, 64, 128], decode_buckets=[1, 2, 4])

# The JAX engine's stats keys of ROADMAP Queue 1 item 18. The first part's
# (flight recorder, SLO and goodput, stall watchdog, digests) are ported and
# must be there; the second part's (profiler, tenant ledger, incidents) not
# yet.
ITEM_18_KEYS = {
    "compiles_after_warmup_total", "compiles_total", "cost_model_calibrated", "decode_host_gap_events_total",
    "decode_host_gap_seconds_total", "digests", "engine_stalled", "engine_stalls_total", "goodput_req_per_s",
    "goodput_requests_total", "goodput_tok_per_s", "goodput_tokens_total", "last_step_age_s", "slo_attainment",
    "slo_tpot_attained_total", "slo_tpot_violated_total", "slo_ttft_attained_total", "slo_ttft_violated_total",
    "step_decode_steps_total", "step_decode_time_seconds_total", "step_decode_tokens_total", "step_mixed_steps_total",
    "step_mixed_time_seconds_total", "step_mixed_tokens_total", "step_prefill_steps_total",
    "step_prefill_time_seconds_total", "step_prefill_tokens_total",
}
ITEM_18_SECOND_PART_KEYS = {
    "incident_last_age_s", "incidents_engine_stall_total", "incidents_host_gap_total",
    "incidents_post_warmup_compile_total", "incidents_queue_wait_p99_total", "incidents_slo_violation_total",
    "incidents_total", "incidents_tpot_p99_total", "incidents_ttft_p99_total", "incidents_worker_lost_total",
    "profiler_capture_conflicts_total", "profiler_captures_total", "tenant_billed_device_seconds_total",
    "tenant_billed_kv_block_seconds_total", "tenant_billed_output_tokens_total", "tenant_billed_queue_seconds_total",
    "tenant_bills_total", "tenant_ledger", "tenant_slo_attained_total", "tenant_slo_violated_total", "tenant_tracked",
}
# ... and its flight recorder's per-phase keys, present once a phase ran
# (ported: the port's must equal JAX's on the same traffic).
ITEM_18_PHASE_KEYS = {f"{k}_{ph}" for k in ("mfu", "hbm_frac") for ph in ("prefill", "decode", "mixed", "wave")} | {
    f"step_{ph}_{k}_total" for ph in ("prefill", "decode", "mixed", "wave")
    for k in ("steps", "time_seconds", "tokens", "bytes", "flops")}
ITEM_18_DEBUG_KEYS = {"digests", "slo", "flight", "watchdog"}
ITEM_18_SECOND_PART_DEBUG_KEYS = {"incidents"}
ELASTIC_KEYS = ("elastic_prefill_fraction", "elastic_prefill_budget", "elastic_decode_slots",
                "elastic_dial_changes_total")


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, device="cpu", dtype=torch.float32)


CONFIGS = [
    {},
    dict(mixed_prefill_budget=32, max_running=4),
    dict(mixed_prefill_budget=0, max_running=5, max_prefill_chunk=64),
    dict(mixed_prefill_budget=100, max_running=1, max_prefill_chunk=128),
]
FRACTIONS = [-0.5, 0.0, 0.01, 0.1, 0.25, 0.5, 0.6, 0.73, 0.9, 0.99, 1.0, 1.7]


@pytest.mark.parametrize("cfg", range(len(CONFIGS)), ids=["defaults", "small", "no-budget", "one-slot"])
def test_dial_applied_values_and_warm_buckets_match_jax(weights, cfg):
    jp, tp = weights
    kw = dict(num_blocks=32, **BUCKETS, **CONFIGS[cfg])
    j = jsched.Scheduler(JCFG, jp, jsched.SchedulerConfig(**kw), dtype=jnp.float32, eos_token_ids=[0])
    t = tsched.Scheduler(TCFG, tp, tsched.SchedulerConfig(**kw), dtype=torch.float32, device="cpu", eos_token_ids=[0])
    assert t._mixed_warm_buckets() == j._mixed_warm_buckets()
    for f in FRACTIONS:
        assert t.set_capacity_dial(f) == j.set_capacity_dial(f), f
        mt, mj = t.metrics(), j.metrics()
        assert {k: getattr(mt, k) for k in ELASTIC_KEYS} == {k: getattr(mj, k) for k in ELASTIC_KEYS}
        assert (t.sc.mixed_prefill_budget, t.sc.max_running) == (j.sc.mixed_prefill_budget, j.sc.max_running)
    assert t._mixed_warm_buckets() == j._mixed_warm_buckets()  # the bases, not the live knobs
    assert t.elastic_dial_changes_total == len(FRACTIONS)


def port_engine(tp) -> TorchEngine:
    return TorchEngine.build(EngineArgs(model="tiny", dtype="float32", device="cpu", eos_token_ids=[0],
                                        scheduler=tsched.SchedulerConfig(num_blocks=64, num_scheduler_steps=1,
                                                                         **BUCKETS)), params=tp)


def jax_engine(jp) -> TpuEngine:
    return TpuEngine.build(JaxEngineArgs(model="tiny", dtype="float32", continuous_profiling=False, eos_token_ids=[0],
                                         scheduler=jsched.SchedulerConfig(num_blocks=64, num_scheduler_steps=1,
                                                                          **BUCKETS)), params=jp)


PROMPTS = [list(range(1, 41)), list(range(1, 33)) + [7] * 9, [3, 5, 7] * 7, list(range(60, 130))]


async def _traffic(engine, ctx_cls):
    """Dial 0.9, two prompts alone, all four at once, dial 0.5, all four
    again: (tokens, stats, the debug state while the burst runs)."""

    async def one(prompt, max_tokens):
        req = {"token_ids": prompt, "sampling_options": {"temperature": 0.0},
               "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True}}
        toks = []
        async for f in engine.generate(req, ctx_cls()):
            toks += f["token_ids"]
        return toks

    engine.set_capacity_dial(0.9)
    tokens = [await one(p, 6) for p in PROMPTS[:2]]
    burst = asyncio.gather(*(one(p, 5) for p in PROMPTS))
    for _ in range(2000):
        debug = engine.debug_state()
        if debug["running"] or debug["waiting"]:
            break
        await asyncio.sleep(0.001)
    tokens += await burst
    engine.set_capacity_dial(0.5)
    tokens += await asyncio.gather(*(one(p, 4) for p in PROMPTS))
    stats = engine.stats_handler()
    await engine.stop()
    return tokens, stats, debug


def test_stats_keys_first_tokens_and_waits_match_jax(weights):
    jp, tp = weights
    port = port_engine(tp)
    firsts = []
    orig = port.scheduler._append_token

    def recording(seq, token, outputs, *a, **kw):
        orig(seq, token, outputs, *a, **kw)
        if len(seq.output_ids) == 1:
            firsts.append((seq.admitted_ts - seq.arrival_ts, seq.first_token_ts - seq.admitted_ts))

    port.scheduler._append_token = recording
    p_tokens, p_stats, p_debug = asyncio.run(_traffic(port, Context))
    j_tokens, j_stats, j_debug = asyncio.run(_traffic(jax_engine(jp), JaxContext))
    assert p_tokens == j_tokens
    assert set(p_stats) == set(j_stats) - ITEM_18_SECOND_PART_KEYS
    assert ITEM_18_KEYS | ITEM_18_SECOND_PART_KEYS <= set(j_stats) and ITEM_18_KEYS <= set(p_stats)
    assert {k for k in p_stats if k in ITEM_18_PHASE_KEYS} == {k for k in j_stats if k in ITEM_18_PHASE_KEYS}
    n = len(PROMPTS) * 2 + 2
    assert p_stats["first_tokens_total"] == j_stats["first_tokens_total"] == n == len(firsts)
    assert p_stats["queue_wait_seconds_total"] == pytest.approx(sum(q for q, _ in firsts), abs=1e-5)
    assert p_stats["prefill_wait_seconds_total"] == pytest.approx(sum(p for _, p in firsts), abs=1e-5)
    assert p_stats["prefill_wait_seconds_total"] > 0
    assert {k: p_stats[k] for k in ELASTIC_KEYS} == {k: j_stats[k] for k in ELASTIC_KEYS}
    assert p_stats["elastic_dial_changes_total"] == 2 and p_stats["elastic_decode_slots"] == 32
    assert set(p_debug) == set(j_debug) - ITEM_18_SECOND_PART_DEBUG_KEYS and ITEM_18_DEBUG_KEYS <= set(p_debug)
    assert set(p_debug["flight"]) == set(j_debug["flight"]) and set(p_debug["watchdog"]) == set(j_debug["watchdog"])
    assert set(p_debug["slo"]) == set(j_debug["slo"])
    assert set(p_debug["block_pool"]) == set(j_debug["block_pool"])
    rows = p_debug["running"] + p_debug["waiting"]
    j_rows = j_debug["running"] + j_debug["waiting"]
    assert rows and j_rows and set(rows[0]) == set(j_rows[0])


async def _wire(tp):
    server = ptcp.ControlPlaneServer(host="127.0.0.1", port=0)
    await server.start()
    address = f"127.0.0.1:{server.port}"
    drts = []
    for _ in range(2):
        conn = await ptcp.connect_control_plane(address)
        drt = DistributedRuntime(runtime=Runtime(), store=ptcp.TcpKvStore(conn), bus=ptcp.TcpPubSub(conn))
        await drt.start()
        drts.append(drt)
    engine = port_engine(tp)
    worker = await pworker.serve_engine(drts[0], engine, ModelDeploymentCard(name="tiny"))
    try:
        client = await drts[1].namespace("dynamo").component("backend").endpoint("generate").client()
        (inst,) = await client.wait_for_instances(1, timeout=10)
        replies, stats = [], []
        for f in (0.9, 1.3, 0.5):
            msg = await drts[1].bus.request(inst.control_subject,
                                            msgpack_codec.packb({"op": "set_dial", "prefill_fraction": f}), timeout=10)
            replies.append(msgpack_codec.unpackb(msg.data))
            stats.append({k: v for k, v in (await client.scrape_stats())[inst.instance_id].items()
                          if k in ELASTIC_KEYS})
        await client.close()
        return replies, stats
    finally:
        await worker.stop(drain_timeout_s=1)
        await engine.stop()
        for drt in drts:
            await drt.shutdown()
        await server.close()


def test_set_dial_over_the_wire(weights):
    jp, tp = weights
    replies, stats = asyncio.run(_wire(tp))
    ref = jsched.Scheduler(JCFG, jp, jsched.SchedulerConfig(num_blocks=64, **BUCKETS), dtype=jnp.float32)
    want = [ref.set_capacity_dial(f) for f in (0.9, 1.3, 0.5)]
    assert replies == want
    assert replies[0] == {"prefill_fraction": 0.9, "mixed_prefill_budget": 922, "decode_slots": 6}
    assert [(s["elastic_prefill_fraction"], s["elastic_prefill_budget"], s["elastic_decode_slots"],
             s["elastic_dial_changes_total"]) for s in stats] == [
        (r["prefill_fraction"], r["mixed_prefill_budget"], r["decode_slots"], i + 1) for i, r in enumerate(want)]
    # The JAX package's own wire codec reads the reply as the port wrote it.
    assert msgpack.unpackb(msgpack_codec.packb(replies[0]), raw=False) == replies[0]
