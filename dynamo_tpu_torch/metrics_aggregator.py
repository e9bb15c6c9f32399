"""Metrics aggregator: scrape the workers' stats into Prometheus families.

The JAX package's ``metrics_aggregator.py`` in the port, on the port's
``runtime/metrics.MetricsRegistry`` and ``runtime/health.SystemStatusServer``
(no prometheus_client or aiohttp), with its key lists, families and
deltas: worker gauges (``GAUGE_KEYS``) and counters (``COUNTER_KEYS``, a
scrape's totals exported as deltas, a total that went back counted from
zero), fleet digests merged bucket-wise (``DIGEST_KEYS`` →
``dynamo_component_fleet_*``), the tenant ledgers' fleet families
(``TENANT_FAMILY_BY_DIM`` and the per-tenant SLO verdicts, with an
``other`` bucket so the labelled series sum to the fleet's total), and a
fleet ``IncidentPlane`` whose ``worker_lost`` fires when the scraped
instance set shrinks. Run:

    python -m dynamo_tpu_torch.metrics_aggregator --endpoint dynamo/backend/generate --port 9090

(``--endpoint`` repeats; ``--interval`` seconds between scrapes;
``--incident-dir`` for the fleet's bundles, default ``DYN_INCIDENT_DIR``).
It reaches the control plane named by ``DYN_CONTROL_PLANE`` /
``DYN_CONTROL_PLANE_ADDRESS``, logs ``metrics aggregator serving
:PORT/metrics``, and exits on SIGINT or SIGTERM. It imports no torch.
"""

from __future__ import annotations

import argparse
import asyncio
from typing import Optional, Sequence

from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.health import SystemHealth, SystemStatusServer, HEALTHY
from dynamo_tpu_torch.runtime.logging import get_logger, init_logging
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.telemetry import DigestCollector

logger = get_logger(__name__)


# Point-in-time worker stats → Gauges.
GAUGE_KEYS = (
    "kv_usage", "kv_total_blocks", "kv_active_blocks",
    "num_running", "num_waiting", "in_flight",
    "remote_prefills", "local_prefills",
    # KV-pool utilization (free/cached depth, internal fragmentation) and
    # the prefix-cache hit rate — the load-skew signals elastic
    # prefill/decode rebalancing observes.
    "kv_free_blocks", "kv_cached_blocks", "kv_fragmentation", "prefix_hit_rate",
    # SLO attainment + live goodput rates (the SloJudge rolling window).
    "slo_attainment", "goodput_req_per_s", "goodput_tok_per_s",
    # Live roofline estimates per phase (flight-recorder FLOPs+bytes model).
    "mfu_prefill", "mfu_decode", "mfu_mixed", "mfu_wave", "mfu_spec",
    "hbm_frac_prefill", "hbm_frac_decode", "hbm_frac_mixed",
    "hbm_frac_wave", "hbm_frac_spec",
    # Stall watchdog: 1.0 = step loop wedged with work queued.
    "engine_stalled", "last_step_age_s",
    # Drain lifecycle: 1.0 while the worker is deregistered and finishing
    # (or migrating) its in-flight work.
    "draining",
    # KV warmth: fraction of the worker's KV pool holding registered
    # (reusable) prefix blocks — the engine-side half of the planner's
    # coldest-worker scale-down ranking.
    "kv_warmth",
    # Planner (autoscale controller) targets + mode, scraped from the
    # planner's own stats endpoint (planner/fleet.py serve_planner).
    "planner_prefill_target", "planner_decode_target", "planner_dry_run",
    # Incident autopsy plane: seconds since the last black-box capture
    # (-1 = never) — the "is anything firing / did we capture it" gauge.
    "incident_last_age_s",
    # The fused decode window kernel's launches in one window (must be
    # exactly 1 — see flight_recorder.window_stats).
    "fused_window_pallas_launches",
    # Elastic capacity dial: the live prefill:decode split each worker is
    # running (fraction ∈ [0,1]; 0.5 = configured identity) and the budget /
    # slot values it resolves to, plus the planner's fleet-wide ratio target.
    "elastic_prefill_fraction", "elastic_prefill_budget", "elastic_decode_slots",
    "planner_elastic_ratio",
    # Device-truth profiling plane: the continuous sampler's live
    # duty cycle, the measured (trace-derived) siblings of the modeled
    # roofline gauges, the measured÷modeled cross-check ratio, and whether
    # the cost model was calibrated (FlopCounterMode in the port).
    "device_profile_duty_cycle",
    "measured_mfu", "measured_hbm_frac", "measured_device_frac",
    "measured_modeled_mfu_ratio", "measured_top_kernel_share",
    "measured_launches_per_fused_window",
    "cost_model_calibrated",
    # Profile-derived capacity: EMA of measured per-worker tok/s the
    # autoscale controller is currently steering on (0 until warm).
    "planner_measured_prefill_tok_s", "planner_measured_decode_tok_s",
    # Tenant capacity ledger (runtime/ledger.py): tenants currently tracked
    # by the worker's device-seconds heavy-hitter sketch (≤ top_k).
    "tenant_tracked",
)

# Fleet-level digest families the aggregator re-exports (merged across
# workers): each becomes ``dynamo_component_fleet_<name>_seconds`` (native
# histogram, cumulative) + ``..._seconds_quantile`` (windowed p50/p90/p99
# gauges). Workers may export any subset; unknown names flow through too.
DIGEST_KEYS = (
    "ttft", "tpot", "itl", "queue_wait",
    "prefill_step", "decode_step", "mixed_step", "wave_step", "spec_step",
)
FLEET_DIGEST_PREFIX = "dynamo_component_fleet_"

# Monotonic worker stats → Counters (``rate()``-able; a Gauge here breaks
# PromQL rate/increase semantics). The scrape sees running totals, so the
# aggregator exports per-scrape deltas; a total going backwards means the
# worker restarted and the new total is counted from zero.
COUNTER_KEYS = (
    "request_total", "preemptions_total",
    "moe_dropped_total", "moe_assignments_total",
    "mixed_steps_total", "mixed_prefill_tokens_total", "mixed_decode_tokens_total",
    "overlap_steps_total", "overlap_flushes_total",
    "cached_tokens_total",
    "prefix_hit_blocks_total", "prefix_miss_blocks_total",
    "prefix_evicted_blocks_total", "prefix_onboard_total",
    "queue_wait_seconds_total", "prefill_wait_seconds_total", "first_tokens_total",
    "decode_host_gap_events_total", "decode_host_gap_seconds_total",
    "compiles_total", "compiles_after_warmup_total",
    "guided_requests_total", "guided_grammar_compiles_total",
    "guided_grammar_compile_seconds_total",
    "step_prefill_steps_total", "step_prefill_time_seconds_total", "step_prefill_tokens_total",
    "step_decode_steps_total", "step_decode_time_seconds_total", "step_decode_tokens_total",
    "step_mixed_steps_total", "step_mixed_time_seconds_total", "step_mixed_tokens_total",
    "step_wave_steps_total", "step_wave_time_seconds_total", "step_wave_tokens_total",
    "step_spec_steps_total", "step_spec_time_seconds_total", "step_spec_tokens_total",
    # SLO attainment + goodput (SLO-attained requests/tokens; rate() gives
    # goodput req/s and tok/s over any window).
    "slo_ttft_attained_total", "slo_ttft_violated_total",
    "slo_tpot_attained_total", "slo_tpot_violated_total",
    "goodput_requests_total", "goodput_tokens_total",
    # Per-phase FLOPs/bytes from the flight-recorder cost model: rate()
    # against the chip peaks gives MFU / HBM-roofline fraction in PromQL.
    "step_prefill_flops_total", "step_prefill_bytes_total",
    "step_decode_flops_total", "step_decode_bytes_total",
    "step_mixed_flops_total", "step_mixed_bytes_total",
    "step_wave_flops_total", "step_wave_bytes_total",
    "step_spec_flops_total", "step_spec_bytes_total",
    # Stall watchdog transitions (each is one wedged-engine incident).
    "engine_stalls_total",
    # Fused decode windows dispatched (one kernel launch each),
    # plus the sampled-epilogue and speculative variants of that window.
    "fused_windows_total", "fused_sampled_windows_total",
    "spec_fused_windows_total", "spec_fused_accepted_tokens_total",
    # Incident autopsy plane (runtime/incidents.py): anomaly-triggered
    # black-box captures, total and per trigger reason, plus on-demand /
    # per-incident device-profile captures.
    "incidents_total",
    "incidents_ttft_p99_total", "incidents_tpot_p99_total",
    "incidents_queue_wait_p99_total", "incidents_slo_violation_total",
    "incidents_post_warmup_compile_total", "incidents_engine_stall_total",
    "incidents_host_gap_total", "incidents_worker_lost_total",
    "profiler_captures_total",
    # Failure lifecycle (chaos plane, runtime/faults.py + hardened paths):
    # deadline evictions, completed drains, and injected faults total /
    # per kind (keys only present on chaos-armed workers).
    "request_timeouts_total", "worker_drains_total",
    # Traffic shape (mocker fleets / frontend-less stacks): the planner's
    # observer derives request rate and avg ISL/OSL from these deltas.
    "input_tokens_total", "output_tokens_total", "disagg_prefill_done_total",
    # Autoscale controller decisions (planner/controller.py to_stats):
    # actions taken and the anti-flap gates that suppressed them.
    "planner_decisions_total",
    "planner_scale_up_total", "planner_scale_down_total",
    "planner_hysteresis_suppressed_total", "planner_cooldown_suppressed_total",
    "planner_drain_debounced_total",
    "faults_injected_total",
    "faults_crash_total", "faults_hang_total", "faults_stream_drop_total",
    "faults_delay_total", "faults_partition_total", "faults_lease_drop_total",
    "faults_stats_blackout_total", "faults_slow_total",
    # Elastic prefill/decode: dial moves, degradation-ladder
    # transitions in both directions, and token-boundary prefill splits.
    "elastic_dial_changes_total",
    "degrade_disagg_to_colocated_total", "degrade_colocated_to_disagg_total",
    "split_prefills_total", "planner_dial_total",
    # Device-truth profiling plane: continuous-sampler window
    # accounting (attempted windows, trace seconds, yields to on-demand
    # captures, parse/capture errors), the flight-recorder fold of parsed
    # windows, and capture-lock contention on the shared DeviceProfiler.
    "device_profile_windows_total", "device_profile_window_seconds_total",
    "device_profile_skipped_busy_total", "device_profile_errors_total",
    "measured_windows_total", "measured_device_seconds_total",
    "measured_wall_seconds_total",
    "profiler_capture_conflicts_total",
    # Tenant capacity ledger: per-worker exact billed totals (unlabeled —
    # the labeled per-tenant families are fleet-side, built from the merged
    # sketch wire in _export_tenant_families).
    "tenant_billed_device_seconds_total", "tenant_billed_kv_block_seconds_total",
    "tenant_billed_queue_seconds_total", "tenant_billed_output_tokens_total",
    "tenant_bills_total", "tenant_slo_attained_total", "tenant_slo_violated_total",
)

# Fleet-merged per-tenant counter families: top-K tenants by label plus an
# ``other`` bucket so Σ labeled series ≈ the fleet's exact billed total
# (the SpaceSaving over-count bias lands in the clamped ``other``).
TENANT_FAMILY_BY_DIM = {
    "device_seconds": "tenant_device_seconds_total",
    "kv_block_seconds": "tenant_kv_block_seconds_total",
    "queue_seconds": "tenant_queue_seconds_total",
}


class MetricsAggregator:
    def __init__(self, drt: DistributedRuntime, namespace: str, component: str, endpoint: str, interval_s: float = 2.0,
                 incident_dir: Optional[str] = None, extra_endpoints: Sequence[str] = ()):
        self.drt = drt
        self.namespace = namespace
        self.component = component
        self.endpoint_name = endpoint
        # Additional ``ns/component/endpoint`` paths scraped into the same
        # registry — a disaggregated deployment's prefill + decode pools
        # (plus the planner's stats endpoint) aggregate in one process.
        self.extra_endpoints = list(extra_endpoints)
        self.interval_s = interval_s
        self.registry = MetricsRegistry(labels={"namespace": namespace, "component": component})
        # Fleet-level incident plane: the aggregator is the one process that
        # sees the whole instance set, so the ``worker_lost`` detector (set
        # shrink between scrapes — a crash or lease lapse, since drains move
        # worker_drains_total instead) lives here. Bundles attach the
        # process's registered evidence probes — in single-process demo
        # stacks that includes the router's routing-decision ring.
        import os as _os

        from dynamo_tpu_torch.runtime.incidents import (
            INCIDENT_DIR_ENV,
            IncidentConfig,
            IncidentPlane,
        )

        self.incidents = IncidentPlane(
            IncidentConfig(dir=incident_dir or _os.environ.get(INCIDENT_DIR_ENV)),
            config_probe=lambda: {
                "role": "metrics_aggregator",
                "endpoint": f"{namespace}/{component}/{endpoint}",
            },
        )
        self._last_scrape: dict = {}
        # Fleet-merged latency digests: per-worker wire sketches merge
        # bucket-wise into TRUE fleet quantiles (averaging per-worker p99s
        # does not compose), re-exported as native Prometheus histograms +
        # quantile gauges under dynamo_component_fleet_*.
        self.digests = DigestCollector(FLEET_DIGEST_PREFIX, registry=self.registry.registry)
        self._task: Optional[asyncio.Task] = None
        self.client = None
        # Last-seen totals per (worker, key) for Counter delta export.
        self._last: dict = {}
        # Latest tenant-ledger wire per worker (kept across scrapes so a
        # briefly-missed worker doesn't re-count its history when it
        # reappears); merged fleet-wide each scrape.
        self._tenant_wires: dict = {}

    async def start(self) -> None:
        ep = self.drt.namespace(self.namespace).component(self.component).endpoint(self.endpoint_name)
        self.client = await ep.client()
        self.extra_clients = []
        for path in self.extra_endpoints:
            ns, comp, name = path.split("/")
            extra = self.drt.namespace(ns).component(comp).endpoint(name)
            self.extra_clients.append(await extra.client())
        self._task = asyncio.get_running_loop().create_task(self._loop())

    def export_stats(self, stats: dict) -> None:
        """Fold one scrape ({worker_id: stats_dict}) into the registry.
        Separated from the poll loop so tests (and the metrics-hygiene
        check) can drive it without a control plane."""
        self.registry.gauge("workers", "live worker instances").set(len(stats))
        for wid, s in stats.items():
            labels = {"worker": f"{wid:x}"}
            for key in GAUGE_KEYS:
                if key in s:
                    self.registry.gauge(f"worker_{key}", f"worker {key}", **labels).set(float(s[key]))
            for key in COUNTER_KEYS:
                if key not in s:
                    continue
                c = self.registry.counter(f"worker_{key}", f"worker {key} (monotonic)", **labels)
                cur = float(s[key])
                prev = self._last.get((wid, key))
                if prev is None or cur < prev:
                    c.inc(cur)  # first sight, or worker restarted
                else:
                    c.inc(cur - prev)
                self._last[(wid, key)] = cur
        self.digests.update_from_wire(
            s.get("digests") for s in stats.values() if isinstance(s.get("digests"), dict)
        )
        # Tenant ledger: fold each worker's sketch wire and export the
        # fleet-merged labeled families (delta-per-scrape, like counters).
        for wid, s in stats.items():
            if isinstance(s.get("tenant_ledger"), dict):
                self._tenant_wires[wid] = s["tenant_ledger"]
        self._export_tenant_families()
        # Fleet-level anomaly check: a shrinking instance set fires
        # worker_lost and captures a bundle with the per-worker scrape
        # summary + registered evidence (router decisions) attached.
        lost = sorted(set(self._last_scrape) - {f"{wid:x}" for wid in stats})
        self._last_scrape = {
            f"{wid:x}": {
                k: s.get(k)
                for k in ("num_running", "num_waiting", "kv_usage", "in_flight", "draining")
                if k in s
            }
            for wid, s in stats.items()
        }
        # The port's bundle also names the instances the last scrape lost.
        self.incidents.state_probe = lambda: {"last_scrape": self._last_scrape, "lost_instances": lost}
        self.incidents.observe({"worker_instance_count": len(stats)})
        plane = self.incidents.to_stats()
        for key, help_ in (
            ("incidents_total", "fleet-level incident captures (worker_lost et al)"),
            ("incidents_worker_lost_total", "instance-set shrink incidents"),
        ):
            c = self.registry.counter(f"fleet_{key}", help_)
            cur = float(plane[key])
            prev = self._last.get(("fleet", key))
            c.inc(cur if prev is None else max(cur - prev, 0.0))
            self._last[("fleet", key)] = cur

    def _export_tenant_families(self) -> None:
        """Merge per-worker tenant-ledger wires into fleet-true top-K
        sketches and export labeled counter families: per-tenant
        device/KV-block/queue seconds (plus ``other`` so totals conserve)
        and per-tenant/per-phase SLO verdicts. Cumulative merged values
        diff against the last scrape (clamped ≥ 0 — sketch estimates may
        wobble when the merged top-K set shifts)."""
        from dynamo_tpu_torch.runtime.ledger import TenantFleet, attribute

        merged = TenantFleet().merge(self._tenant_wires.values())
        if not merged:
            return

        def inc_delta(family: str, value: float, **labels) -> None:
            c = self.registry.counter(family, f"fleet per-tenant {family}", **labels)
            key = ("tenant", family, tuple(sorted(labels.items())))
            prev = self._last.get(key)
            c.inc(float(value) if prev is None else max(float(value) - prev, 0.0))
            self._last[key] = float(value)

        att = attribute(merged)
        for dim, family in TENANT_FAMILY_BY_DIM.items():
            d = att.get(dim) or {}
            for row in d.get("tenants") or []:
                inc_delta(family, row["value"], tenant=row["tenant"])
            inc_delta(family, d.get("other") or 0.0, tenant="other")
        for tenant, counts in (merged.get("slo") or {}).items():
            for kind, family in (("violated", "tenant_slo_violated_total"),
                                 ("attained", "tenant_slo_attained_total")):
                for phase, n in (counts.get(kind) or {}).items():
                    inc_delta(family, n, tenant=tenant, phase=phase)

    async def scrape_once(self) -> dict:
        """One merged scrape across the primary + extra endpoints (worker
        ids are lease ids, unique across components)."""
        stats = await self.client.scrape_stats()
        for client in getattr(self, "extra_clients", ()):
            stats.update(await client.scrape_stats())
        return stats

    async def _loop(self) -> None:
        try:
            while True:
                self.export_stats(await self.scrape_once())
                await asyncio.sleep(self.interval_s)
        except asyncio.CancelledError:
            pass

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass


async def amain(args) -> None:
    drt = await DistributedRuntime.from_settings()
    drt.runtime.install_signal_handlers()
    primary, *extra = args.endpoint
    ns, comp, ep = primary.split("/")
    agg = MetricsAggregator(drt, ns, comp, ep, interval_s=args.interval,
                            incident_dir=args.incident_dir,
                            extra_endpoints=extra)
    await agg.start()
    health = SystemHealth()
    health.set_system_ready()
    server = SystemStatusServer(health, metrics=agg.registry)
    server.config.port = args.port
    await server.start()
    logger.info("metrics aggregator serving :%d/metrics for %s", server.port, args.endpoint)
    try:
        await drt.runtime.cancellation.cancelled()
    finally:
        await server.stop()
        await agg.stop()
        await drt.shutdown()


def main() -> None:
    init_logging()
    p = argparse.ArgumentParser(description="dynamo-tpu metrics aggregator on the PyTorch/CUDA port")
    p.add_argument("--endpoint", action="append", required=True,
                   help="ns/component/endpoint to scrape (repeatable: a "
                        "disagg deployment names its prefill, decode, and "
                        "planner endpoints)")
    p.add_argument("--port", type=int, default=9090)
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--incident-dir", default=None,
                   help="write fleet-level (worker_lost) incident bundles here "
                        "(default DYN_INCIDENT_DIR)")
    try:
        asyncio.run(amain(p.parse_args()))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
