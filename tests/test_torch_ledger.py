"""The port's tenant ledger (``runtime/ledger.py``) and the scheduler's
billing against the JAX package's, on the same seeded inputs.

- ``SpaceSaving`` keeps the same items, counts and errors on the same
  weighted stream, merges the same, and its wire is byte-equal;
- ``TenantLedger.to_wire`` is byte-equal (JSON and msgpack) under the same
  clock, ``to_stats`` and ``snapshot`` equal;
- ``TenantFleet`` merges a port worker's wire with a JAX worker's into the
  same fleet wire in either package, and ``attribute`` agrees;
- the scheduler on ``tiny``, both packages on the same traffic with two
  tenants: the same bills, output tokens, tenants and SLO verdicts; every
  billed step splits exactly its time over its rows (both packages), the
  bills' device seconds stay within the steps' time; the port's calibrated
  FLOPs a token equals the products' 2·M·N·K count exactly and lies in the
  band (printed beside the JAX package's XLA ``cost_analysis`` count).

Tolerance: exact equality everywhere but the conservation sums (rel 1e-9,
float summation order).
"""

from __future__ import annotations

import json
import random

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import scheduler as jsched
from dynamo_tpu.engine.config import get_config as jax_config
from dynamo_tpu.engine.models import llama as jllama
from dynamo_tpu.runtime import ledger as jledger
from dynamo_tpu.runtime.telemetry import SloConfig as JSloConfig
from dynamo_tpu_torch.engine import scheduler as tsched
from dynamo_tpu_torch.engine.config import get_config
from dynamo_tpu_torch.engine.flight_recorder import StepCostModel
from dynamo_tpu_torch.engine.sampling import SamplingParams
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime import ledger as pledger
from dynamo_tpu_torch.runtime import msgpack_codec
from dynamo_tpu_torch.runtime.telemetry import SloConfig as PSloConfig


def _stream(seed: int, n: int = 400, tenants: int = 30):
    rng = random.Random(seed)
    keys = [f"t{i:02d}" for i in range(tenants)]
    # Zipf-ish skew: a few heavy tenants, a long tail.
    weights = [1.0 / (i + 1) ** 1.2 for i in range(tenants)]
    return [(rng.choices(keys, weights)[0], round(rng.uniform(0.01, 2.0), 3)) for _ in range(n)]


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 8), (2, 16)])
def test_spacesaving_matches_jax(seed, k):
    port, ref = pledger.SpaceSaving(k), jledger.SpaceSaving(k)
    for key, w in _stream(seed):
        port.offer(key, w)
        ref.offer(key, w)
    assert port.items() == ref.items() and port.total == ref.total
    assert port.min_count() == ref.min_count()
    assert json.dumps(port.to_wire()).encode() == json.dumps(ref.to_wire()).encode()
    # Merges (each package its own, then across the wire).
    p2, r2 = pledger.SpaceSaving(k), jledger.SpaceSaving(k)
    for key, w in _stream(seed + 10):
        p2.offer(key, w)
        r2.offer(key, w)
    assert port.merge(p2).items() == ref.merge(r2).items()
    cross = pledger.SpaceSaving.from_wire(ref.to_wire())
    assert cross.to_wire() == ref.to_wire()


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _bills(mod, seed: int):
    rng = random.Random(seed)
    out = []
    for i in range(60):
        tenant = rng.choice(["acme", "beta", "gamma", "delta", "eps", "zeta"] + ["acme"] * 4)
        out.append(mod.RequestBill(
            tenant=tenant, request_id=f"r{i}", queue_s=round(rng.uniform(0, 0.2), 4),
            prefill_device_s=round(rng.uniform(0, 0.05), 5), decode_device_s=round(rng.uniform(0, 0.3), 5),
            flops=float(rng.randint(1, 10**9)), output_tokens=rng.randint(1, 64),
            kv_block_s=round(rng.uniform(0, 3.0), 4), finish_reason=rng.choice(["stop", "length", "cancelled"]),
            ttft_s=round(rng.uniform(0.01, 0.5), 4), tpot_s=round(rng.uniform(0.005, 0.05), 5)))
    return out


def _ledgers(seed: int, top_k: int = 4):
    out = []
    for mod, slo in ((pledger, PSloConfig), (jledger, JSloConfig)):
        clock = Clock()
        led = mod.TenantLedger(top_k=top_k, slo=slo(ttft_ms=200.0, tpot_ms=20.0), clock=clock)
        for i, bill in enumerate(_bills(mod, seed)):
            clock.t += 0.25
            led.record(bill)
        out.append(led)
    return out


@pytest.mark.parametrize("seed,top_k", [(3, 4), (4, 16)])
def test_ledger_wire_bytes_equal_jax(seed, top_k):
    port, ref = _ledgers(seed, top_k)
    pw, rw = port.to_wire(), ref.to_wire()
    assert json.dumps(pw).encode() == json.dumps(rw).encode()
    assert msgpack_codec.packb(pw) == msgpack.packb(rw)
    assert port.to_stats() == ref.to_stats()
    assert port.snapshot() == ref.snapshot()
    assert pledger.attribute(pw) == jledger.attribute(rw)


def test_tenant_fleet_merges_across_packages():
    (pa, ja), (pb, jb) = _ledgers(5), _ledgers(6)
    # A port worker beside a JAX worker: either package's fleet merges them
    # into the same wire.
    wires = [pa.to_wire(), jb.to_wire()]
    port_fleet = pledger.TenantFleet().merge(wires)
    jax_fleet = jledger.TenantFleet().merge(wires)
    assert json.dumps(port_fleet).encode() == json.dumps(jax_fleet).encode()
    assert port_fleet == jledger.TenantFleet().merge([ja.to_wire(), pb.to_wire()])
    assert pledger.attribute(port_fleet) == jledger.attribute(jax_fleet)
    assert pledger.TenantFleet(top_k=2).merge(wires) == jledger.TenantFleet(top_k=2).merge(wires)
    assert pledger.TenantFleet().merge([]) == jledger.TenantFleet().merge([]) == {}


# ---------------------------------------------------------------------------
# The scheduler's billing on tiny
# ---------------------------------------------------------------------------

TCFG, JCFG = get_config("tiny"), jax_config("tiny")
# SLO targets far off: every verdict is "attained" whatever the host's speed
# (step times are each package's own).
SCHED = dict(num_blocks=64, prefill_buckets=[16], decode_buckets=[4], num_scheduler_steps=1,
             enable_prefix_caching=False, slo_ttft_ms=1e7, slo_tpot_ms=1e7, ledger_top_k=8)
TRAFFIC = [("a0", list(range(1, 15)), 5, "acme"), ("a1", list(range(2, 12)), 4, "acme"),
           ("b0", list(range(5, 16)), 5, "beta"), ("x0", [9] * 12, 3, None)]


@pytest.fixture(scope="module")
def weights():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, device="cpu", dtype=torch.float32)


def _drive(sched, sampling_cls, stop_cls):
    """The traffic through one scheduler: every ``_bill_step`` call's time
    beside the sum of its rows' increments, and the finished ids."""
    steps = []
    orig = sched._bill_step

    def recording(dur_s, rows):
        before = {id(r[0]): r[0].bill_prefill_s + r[0].bill_decode_s for r in rows}
        orig(dur_s, rows)
        after = sum(r[0].bill_prefill_s + r[0].bill_decode_s - before[id(r[0])] for r in rows)
        steps.append((dur_s, after, len(rows)))

    sched._bill_step = recording
    for rid, prompt, n, tenant in TRAFFIC:
        kw = {} if tenant is None else {"tenant": tenant}
        sched.add_request(rid, prompt, sampling_cls(temperature=0.0), stop_cls(max_tokens=n, ignore_eos=True), **kw)
    finished = {}
    for _ in range(400):
        if not sched.has_work():
            break
        for seq, out in sched.step():
            if out.finished:
                finished[seq.request_id] = (out.finish_reason, len(seq.output_ids))
    return steps, finished


def test_scheduler_bills_match_jax(weights):
    jp, tp = weights
    j = jsched.Scheduler(JCFG, jp, jsched.SchedulerConfig(**SCHED), dtype=jnp.float32)
    t = tsched.Scheduler(TCFG, tp, tsched.SchedulerConfig(**SCHED), dtype=torch.float32, device="cpu")
    from dynamo_tpu.engine.sampling import SamplingParams as JSamplingParams

    j_steps, j_done = _drive(j, JSamplingParams, jsched.StopConditions)
    t_steps, t_done = _drive(t, SamplingParams, tsched.StopConditions)
    assert t_done == j_done and len(t_done) == len(TRAFFIC)
    pw, jw = t.ledger.to_wire(), j.ledger.to_wire()
    assert pw["bills"] == jw["bills"] == len(TRAFFIC)
    assert pw["totals"]["output_tokens"] == jw["totals"]["output_tokens"] == sum(n for _, _, n, _ in TRAFFIC)
    for wire in (pw, jw):
        assert {row[0] for row in wire["sketches"]["device_seconds"]["items"]} == {"acme", "beta", "anon"}
    assert pw["slo"] == jw["slo"] and pw["slo"]["acme"]["attained"]["ttft"] == 2
    assert t.ledger.to_stats()["tenant_bills_total"] == j.ledger.to_stats()["tenant_bills_total"]
    # The same steps billed, each splitting exactly its own time.
    assert [n for _, _, n in t_steps] == [n for _, _, n in j_steps]
    for steps in (t_steps, j_steps):
        for dur, billed, _ in steps:
            assert billed == pytest.approx(dur, rel=1e-9)
    step_time = sum(d for d, _, _ in t_steps)
    assert 0 < pw["totals"]["device_seconds"] <= step_time * (1 + 1e-9)
    assert pw["totals"]["kv_block_seconds"] > 0 and pw["totals"]["flops"] > 0
    assert t.allocator.num_active == 0


def test_calibrated_flops_per_token_is_the_products_count(weights):
    """``_calibrate_cost_model`` counts the decode forward's products: 2·K·N
    for every layer's seven matrices and the head, a token."""
    jp, tp = weights
    t = tsched.Scheduler(TCFG, tp, tsched.SchedulerConfig(**SCHED), dtype=torch.float32, device="cpu")
    cm = t.flight.cost_model
    hand = cm.flops_per_token
    t._calibrate_cost_model(1, t._width_bucket(1))
    layer = tp["layers"]
    products = sum(2 * w.shape[-2] * w.shape[-1] * w.shape[0]
                   for name, w in layer.items() if name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    head = tp.get("lm_head")
    products += 2 * TCFG.hidden_size * TCFG.vocab_size if head is None else 2 * head.shape[0] * head.shape[1]
    assert cm.calibrated and cm.calibration_source == "torch_flop_counter"
    assert cm.flops_per_token == products
    lo, hi = StepCostModel.CALIBRATION_BAND
    assert lo * hand <= cm.flops_per_token <= hi * hand
    assert t.flight.to_stats()["cost_model_calibrated"] == 1.0
    j = jsched.Scheduler(JCFG, jp, jsched.SchedulerConfig(**SCHED), dtype=jnp.float32)
    j._calibrate_cost_model(1, j._width_bucket(1))
    print(f"flops/token: port FlopCounterMode {cm.flops_per_token:.6g}, JAX cost_analysis "
          f"{j.flight.cost_model.flops_per_token:.6g} (calibrated {j.flight.cost_model.calibrated}), "
          f"analytical {hand:.6g}")
    # Out of the band: refused, the count kept.
    assert not cm.calibrate(hand * 100) and cm.flops_per_token == products
