"""Per-tenant capacity accounting: request bills into a bounded tenant ledger.

The JAX package's ``runtime/ledger.py`` in the port, byte for byte on the
wire, so either package's aggregator merges either package's workers. The
scheduler charges each request's queue time, device time, FLOPs, output
tokens and KV block-seconds into a :class:`RequestBill`; bills roll into a
:class:`TenantLedger` whose memory is bounded whatever the number of
tenants:

- a :class:`SpaceSaving` top-K heavy-hitter sketch per billed dimension
  (device-seconds, KV block-seconds, queue-seconds): weighted
  Metwally/Agrawal/El Abbadi stream summary, over-counting by at most
  ``total/k``, mergeable across workers, with deterministic ties (the
  smaller tenant wins a rank tie, the smallest min-count entry is evicted);
- per-tenant windowed :class:`~dynamo_tpu_torch.runtime.telemetry.WindowedDigest`
  TTFT/TPOT streams and SLO counters, kept only for tenants the
  device-seconds sketch tracks;
- exact totals per dimension, so the aggregator conserves mass: fleet
  total − Σ top-K is the ``other`` bucket.

``TenantLedger.to_wire()`` rides the worker's stats scrape (under
``tenant_ledger``); :class:`TenantFleet` merges the workers' wires into
fleet top-K families; ``attribute()`` feeds ``tools/autopsy.py --tenant``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from dynamo_tpu_torch.runtime.telemetry import SloConfig, WindowedDigest

ANON_TENANT = "anon"
DEFAULT_TOP_K = 16


# ---------------------------------------------------------------------------
# SpaceSaving heavy-hitter sketch
# ---------------------------------------------------------------------------


class SpaceSaving:
    """Weighted SpaceSaving stream summary over string keys.

    Tracks at most ``k`` keys. ``offer(key, w)`` either bumps a tracked
    key, fills a free slot, or evicts the minimum-count entry and adopts
    its count as the new key's error floor. Invariants (tested in
    tests/test_ledger.py):

    - ``estimate(key) ≥ true(key)`` for every key (over-estimate only);
    - ``estimate(key) − true(key) ≤ error(key) ≤ total/k``;
    - any key with ``true(key) > total/k`` is guaranteed tracked.

    Determinism: eviction picks the (count, key) lexicographic minimum;
    ``items()`` ranks by (−count, key) — equal counts rank the smaller
    key first — so independent replicas of the same stream agree exactly.
    """

    __slots__ = ("k", "total", "_items")

    def __init__(self, k: int = DEFAULT_TOP_K):
        if k < 1:
            raise ValueError(f"SpaceSaving k must be ≥ 1, got {k}")
        self.k = int(k)
        self.total = 0.0
        # key -> [count, error]
        self._items: Dict[str, List[float]] = {}

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def offer(self, key: str, weight: float = 1.0) -> None:
        if weight <= 0.0:
            return
        self.total += weight
        slot = self._items.get(key)
        if slot is not None:
            slot[0] += weight
            return
        if len(self._items) < self.k:
            self._items[key] = [weight, 0.0]
            return
        victim = min(self._items, key=lambda t: (self._items[t][0], t))
        vcount = self._items.pop(victim)[0]
        self._items[key] = [vcount + weight, vcount]

    def estimate(self, key: str) -> float:
        slot = self._items.get(key)
        return slot[0] if slot is not None else 0.0

    def error(self, key: str) -> float:
        slot = self._items.get(key)
        return slot[1] if slot is not None else 0.0

    def min_count(self) -> float:
        """The eviction floor: an untracked key's true count is ≤ this."""
        if len(self._items) < self.k:
            return 0.0
        return min(c for c, _ in self._items.values())

    def items(self) -> List[Tuple[str, float, float]]:
        """[(key, count, error)] ranked by (−count, key) — deterministic."""
        return sorted(
            ((key, c, e) for key, (c, e) in self._items.items()),
            key=lambda t: (-t[1], t[0]),
        )

    def merge(self, other: "SpaceSaving") -> "SpaceSaving":
        """Merge another sketch in place (union of keys, counts summed;
        a key absent from one sketch contributes that sketch's eviction
        floor to both count and error — the over-estimate property and
        the summed ``total/k`` bound survive the merge), then trim back
        to k entries by the deterministic rank order."""
        floor_self = self.min_count()
        floor_other = other.min_count()
        merged: Dict[str, List[float]] = {}
        for key, (c, e) in self._items.items():
            oc = other._items.get(key)
            if oc is not None:
                merged[key] = [c + oc[0], e + oc[1]]
            else:
                merged[key] = [c + floor_other, e + floor_other]
        for key, (c, e) in other._items.items():
            if key not in merged:
                merged[key] = [c + floor_self, e + floor_self]
        kept = sorted(merged.items(), key=lambda t: (-t[1][0], t[0]))[: self.k]
        self._items = {key: slot for key, slot in kept}
        self.total += other.total
        return self

    def to_wire(self) -> dict:
        return {
            "k": self.k,
            "total": self.total,
            "items": [[key, c, e] for key, c, e in self.items()],
        }

    @classmethod
    def from_wire(cls, d: dict) -> "SpaceSaving":
        s = cls(int(d.get("k") or DEFAULT_TOP_K))
        s.total = float(d.get("total") or 0.0)
        for key, c, e in d.get("items") or []:
            s._items[str(key)] = [float(c), float(e)]
        return s


# ---------------------------------------------------------------------------
# Request bill
# ---------------------------------------------------------------------------


@dataclass
class RequestBill:
    """One finished (or timed-out / migrated-away / cancelled) request's
    capacity account, emitted by the scheduler at its finish choke point.
    Device-seconds are the request's pro-rated share of each step's wall
    time (marginal-roofline weights from the step cost model, scaled by
    the measured/modeled ratio when the continuous profiler has a live
    window); on a migration/disagg leg each scheduler bills only the
    device time IT spent, so multi-leg requests sum without
    double-billing."""

    tenant: str = ANON_TENANT
    request_id: str = ""
    queue_s: float = 0.0
    prefill_device_s: float = 0.0
    decode_device_s: float = 0.0
    flops: float = 0.0
    output_tokens: int = 0
    kv_block_s: float = 0.0
    finish_reason: str = "stop"
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None

    @property
    def device_s(self) -> float:
        return self.prefill_device_s + self.decode_device_s


# ---------------------------------------------------------------------------
# Per-worker tenant ledger
# ---------------------------------------------------------------------------

_SLO_PHASES = ("ttft", "tpot")


@dataclass
class _TenantSlo:
    attained: Dict[str, int] = field(default_factory=lambda: {p: 0 for p in _SLO_PHASES})
    violated: Dict[str, int] = field(default_factory=lambda: {p: 0 for p in _SLO_PHASES})


class TenantLedger:
    """Bounded-memory per-tenant accounting for one worker.

    ``record(bill)`` is called from the scheduler thread at request
    finish; ``to_wire()``/``to_stats()`` from the stats scrape (event
    loop) — a lock covers the sketch/digest mutations."""

    def __init__(
        self,
        top_k: int = DEFAULT_TOP_K,
        slo: Optional[SloConfig] = None,
        window_s: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.top_k = int(top_k)
        self.slo = slo or SloConfig()
        self.window_s = window_s
        self._clock = clock
        self._lock = threading.Lock()
        self.device_s = SpaceSaving(self.top_k)
        self.kv_block_s = SpaceSaving(self.top_k)
        self.queue_s = SpaceSaving(self.top_k)
        # Per-tenant telemetry exists only for tenants the device-seconds
        # sketch currently tracks — bounded at O(top_k) regardless of
        # tenant cardinality.
        self._digests: Dict[str, Dict[str, WindowedDigest]] = {}
        self._slo: Dict[str, _TenantSlo] = {}
        # Exact totals (conservation anchors for the `other` bucket).
        self.totals: Dict[str, float] = {
            "device_seconds": 0.0,
            "prefill_device_seconds": 0.0,
            "decode_device_seconds": 0.0,
            "kv_block_seconds": 0.0,
            "queue_seconds": 0.0,
            "flops": 0.0,
            "output_tokens": 0.0,
            "slo_attained": 0.0,
            "slo_violated": 0.0,
        }
        self.bills_total = 0

    def record(self, bill: RequestBill) -> None:
        tenant = bill.tenant or ANON_TENANT
        with self._lock:
            self.bills_total += 1
            t = self.totals
            t["device_seconds"] += bill.device_s
            t["prefill_device_seconds"] += bill.prefill_device_s
            t["decode_device_seconds"] += bill.decode_device_s
            t["kv_block_seconds"] += bill.kv_block_s
            t["queue_seconds"] += bill.queue_s
            t["flops"] += bill.flops
            t["output_tokens"] += bill.output_tokens
            self.device_s.offer(tenant, bill.device_s)
            self.kv_block_s.offer(tenant, bill.kv_block_s)
            self.queue_s.offer(tenant, bill.queue_s)
            if tenant in self.device_s:
                self._observe_tracked(tenant, bill)
            self._evict_untracked()

    def _observe_tracked(self, tenant: str, bill: RequestBill) -> None:
        dig = self._digests.get(tenant)
        if dig is None:
            dig = self._digests[tenant] = {
                p: WindowedDigest(window_s=self.window_s, clock=self._clock)
                for p in _SLO_PHASES
            }
            self._slo[tenant] = _TenantSlo()
        slo = self._slo[tenant]
        judged = bill.finish_reason in ("stop", "length")
        if bill.ttft_s is not None:
            dig["ttft"].observe(bill.ttft_s)
            if judged and self.slo.ttft_ms is not None:
                ok = bill.ttft_s * 1000.0 <= self.slo.ttft_ms
                self._count_slo(slo, "ttft", ok)
        if bill.tpot_s is not None:
            dig["tpot"].observe(bill.tpot_s)
            if judged and self.slo.tpot_ms is not None:
                ok = bill.tpot_s * 1000.0 <= self.slo.tpot_ms
                self._count_slo(slo, "tpot", ok)

    def _count_slo(self, slo: _TenantSlo, phase: str, ok: bool) -> None:
        if ok:
            slo.attained[phase] += 1
            self.totals["slo_attained"] += 1
        else:
            slo.violated[phase] += 1
            self.totals["slo_violated"] += 1

    def _evict_untracked(self) -> None:
        """Drop digests/SLO state for tenants the device sketch evicted —
        this is what keeps the telemetry footprint bounded."""
        if len(self._digests) <= self.top_k:
            return
        for tenant in [t for t in self._digests if t not in self.device_s]:
            self._digests.pop(tenant, None)
            self._slo.pop(tenant, None)

    # --- export ------------------------------------------------------------

    def to_wire(self) -> dict:
        """The nested stats-scrape payload the aggregator merges."""
        with self._lock:
            return {
                "top_k": self.top_k,
                "bills": self.bills_total,
                "totals": dict(self.totals),
                "sketches": {
                    "device_seconds": self.device_s.to_wire(),
                    "kv_block_seconds": self.kv_block_s.to_wire(),
                    "queue_seconds": self.queue_s.to_wire(),
                },
                "slo": {
                    tenant: {
                        "attained": dict(s.attained),
                        "violated": dict(s.violated),
                    }
                    for tenant, s in self._slo.items()
                },
                "digests": {
                    tenant: {p: d.to_wire() for p, d in dig.items()}
                    for tenant, dig in self._digests.items()
                },
            }

    def to_stats(self) -> dict:
        """Flat unlabeled worker-plane keys (registered in the aggregator
        key lists, pinned by the Grafana Tenants row). The labeled
        per-tenant families are aggregator-side only — built from the
        merged sketch wire, not from these."""
        with self._lock:
            return {
                "tenant_billed_device_seconds_total": self.totals["device_seconds"],
                "tenant_billed_kv_block_seconds_total": self.totals["kv_block_seconds"],
                "tenant_billed_queue_seconds_total": self.totals["queue_seconds"],
                "tenant_billed_output_tokens_total": self.totals["output_tokens"],
                "tenant_bills_total": self.bills_total,
                "tenant_slo_attained_total": self.totals["slo_attained"],
                "tenant_slo_violated_total": self.totals["slo_violated"],
                "tenant_tracked": float(len(self.device_s)),
            }

    def snapshot(self) -> dict:
        """Incident-bundle evidence: ranked shares per dimension, so
        ``autopsy --tenant`` can attribute a spike without the raw
        sketches."""
        wire = self.to_wire()
        return attribute(wire)


# ---------------------------------------------------------------------------
# Fleet-side merge (aggregator) + attribution (autopsy)
# ---------------------------------------------------------------------------

_DIMENSIONS = ("device_seconds", "kv_block_seconds", "queue_seconds")


class TenantFleet:
    """Aggregator-side: merge per-worker ledger wires into fleet-true
    top-K sketches + exact fleet totals. Stateless across scrapes — the
    caller feeds it every worker's latest wire each time and diffs the
    resulting cumulative counts itself."""

    def __init__(self, top_k: Optional[int] = None):
        self.top_k = top_k

    def merge(self, wires: Iterable[dict]) -> dict:
        wires = [w for w in wires if w]
        if not wires:
            return {}
        k = self.top_k or max(int(w.get("top_k") or DEFAULT_TOP_K) for w in wires)
        sketches = {dim: SpaceSaving(k) for dim in _DIMENSIONS}
        totals: Dict[str, float] = {}
        slo: Dict[str, Dict[str, Dict[str, int]]] = {}
        bills = 0
        for w in wires:
            bills += int(w.get("bills") or 0)
            for key, val in (w.get("totals") or {}).items():
                totals[key] = totals.get(key, 0.0) + float(val)
            for dim in _DIMENSIONS:
                sw = (w.get("sketches") or {}).get(dim)
                if sw:
                    sketches[dim].merge(SpaceSaving.from_wire(sw))
            for tenant, counts in (w.get("slo") or {}).items():
                dst = slo.setdefault(
                    tenant,
                    {"attained": {p: 0 for p in _SLO_PHASES},
                     "violated": {p: 0 for p in _SLO_PHASES}},
                )
                for kind in ("attained", "violated"):
                    for phase, n in (counts.get(kind) or {}).items():
                        dst[kind][phase] = dst[kind].get(phase, 0) + int(n)
        return {
            "top_k": k,
            "bills": bills,
            "totals": totals,
            "sketches": {dim: s.to_wire() for dim, s in sketches.items()},
            "slo": slo,
        }


def attribute(wire: dict) -> dict:
    """Rank tenants by share per billed dimension. Input is a ledger (or
    fleet-merged) wire; output is what autopsy renders:

        {"device_seconds": {"total": 12.3,
                            "tenants": [{"tenant": "x", "value": 10.3,
                                         "error": 0.0, "share": 0.84}, ...],
                            "other": 2.0, "other_share": 0.16}, ...}

    ``other`` = exact total − Σ tracked estimates, floored at 0 (sketch
    estimates over-count by ≤ total/k, so the floor absorbs the bias and
    shares stay in [0, 1])."""
    out: dict = {"bills": int(wire.get("bills") or 0)}
    totals = wire.get("totals") or {}
    for dim in _DIMENSIONS:
        sw = (wire.get("sketches") or {}).get(dim)
        total = float(totals.get(dim) or 0.0)
        tenants = []
        tracked_sum = 0.0
        if sw:
            for tenant, count, err in SpaceSaving.from_wire(sw).items():
                tracked_sum += count
                tenants.append({
                    "tenant": tenant,
                    "value": count,
                    "error": err,
                    "share": (count / total) if total > 0 else 0.0,
                })
        other = max(0.0, total - tracked_sum)
        out[dim] = {
            "total": total,
            "tenants": tenants,
            "other": other,
            "other_share": (other / total) if total > 0 else 0.0,
        }
    out["slo"] = wire.get("slo") or {}
    return out
