"""Hierarchical metrics registries and the Prometheus text exposition.

The JAX package's ``runtime/metrics.py`` names and hierarchy
(``MetricsRegistry`` nodes that children inherit labels from,
``dynamo_component_*`` / ``dynamo_frontend_*`` prefixes), on counters,
gauges and histograms of the port's own: the card's machine has no
``prometheus_client``. ``render`` writes the text format 0.0.4 as
``prometheus_client.generate_latest`` writes it: ``# HELP`` / ``# TYPE``
per family, a counter's ``_total`` samples, a histogram's cumulative
``_bucket{le=...}`` then ``_count`` and ``_sum``, label pairs sorted by
name, Go-style floats, and each counter's and histogram's ``_created``
samples in a gauge family after it. Custom collectors (``telemetry.
DigestCollector``) register with ``CollectorRegistry.register`` and yield
``MetricFamily`` objects.
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Canonical metric name prefixes (the JAX package's).
COMPONENT_PREFIX = "dynamo_component_"
FRONTEND_PREFIX = "dynamo_frontend_"

INF = float("inf")
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0, 7.5, 10.0, INF)


def float_to_go_string(d: float) -> str:
    """A sample value or bound as Prometheus (and prometheus_client) writes
    it: ``+Inf``, ``NaN``, ``1.0``, ``1e+09``."""
    d = float(d)
    if d == INF:
        return "+Inf"
    if d == -INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    # Go switches to exponents sooner than Python, for positive values.
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


class MetricFamily:
    """One family of samples: ``(name, labels, value)`` triples under a
    base name, a type (counter, gauge, histogram) and a help text."""

    __slots__ = ("name", "type", "documentation", "samples")

    def __init__(self, name: str, mtype: str, documentation: str):
        self.name = name
        self.type = mtype
        self.documentation = documentation
        self.samples: List[Tuple[str, Dict[str, str], float]] = []

    def add_sample(self, name: str, labels: Dict[str, str], value: float) -> None:
        self.samples.append((name, labels, value))


class CollectorRegistry:
    """Collectors in registration order; ``register`` refuses a collector
    whose sample names another already owns."""

    def __init__(self):
        self._collectors: List[object] = []
        self._names_to_collectors: Dict[str, object] = {}
        self._lock = threading.Lock()

    def register(self, collector, names: Iterable[str] = ()) -> None:
        names = tuple(names)
        with self._lock:
            dup = set(names) & set(self._names_to_collectors)
            if dup:
                raise ValueError(f"Duplicated timeseries in CollectorRegistry: {dup}")
            for n in names:
                self._names_to_collectors[n] = collector
            self._collectors.append(collector)

    def collect(self) -> Iterable[MetricFamily]:
        with self._lock:
            collectors = list(self._collectors)
        for c in collectors:
            yield from c.collect()


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(doc: str) -> str:
    return doc.replace("\\", r"\\").replace("\n", r"\n")


def _sample_line(name: str, labels: Dict[str, str], value: float) -> str:
    labelstr = ""
    if labels:
        labelstr = "{" + ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in sorted(labels.items())) + "}"
    return f"{name}{labelstr} {float_to_go_string(value)}\n"


def generate_latest(registry: CollectorRegistry) -> bytes:
    """The registry's samples in the Prometheus text format 0.0.4."""
    out: List[str] = []
    for fam in registry.collect():
        mname = fam.name + "_total" if fam.type == "counter" else fam.name
        doc = _escape_help(fam.documentation)
        out.append(f"# HELP {mname} {doc}\n# TYPE {mname} {fam.type}\n")
        created: List[str] = []
        for name, labels, value in fam.samples:
            line = _sample_line(name, labels, value)
            (created if name == fam.name + "_created" else out).append(line)
        if created:
            out.append(f"# HELP {fam.name}_created {doc}\n# TYPE {fam.name}_created gauge\n")
            out.extend(created)
    return "".join(out).encode("utf-8")


# --- metric kinds --------------------------------------------------------------


class _Child:
    """One labelled series of a metric."""

    __slots__ = ("_lock", "value", "created", "buckets", "sum")

    def __init__(self, n_buckets: int = 0):
        self._lock = threading.Lock()
        self.value = 0.0
        self.created = time.time()
        self.buckets = [0.0] * n_buckets
        self.sum = 0.0


class _CounterChild(_Child):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("Counters can only be incremented by non-negative amounts.")
        with self._lock:
            self.value += amount


class _GaugeChild(_Child):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value -= amount

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


class _HistogramChild(_Child):
    __slots__ = ("bounds",)

    def __init__(self, bounds: Tuple[float, ...]):
        super().__init__(len(bounds))
        self.bounds = bounds

    def observe(self, amount: float) -> None:
        # The first bucket whose upper bound holds the value (le).
        i = bisect.bisect_left(self.bounds, amount)
        with self._lock:
            self.sum += amount
            self.buckets[i] += 1.0


class _Metric:
    """A metric with its label names: ``labels(**values)`` gives a series;
    an unlabelled metric is its own (only) series."""

    kind = ""

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str] = (),
                 registry: Optional[CollectorRegistry] = None):
        self._name = name
        self._documentation = documentation
        self._labelnames = tuple(labelnames)
        self._children: Dict[tuple, _Child] = {}
        self._lock = threading.Lock()
        if not self._labelnames:
            self._children[()] = self._new_child()
        if registry is not None:
            registry.register(self, self._sample_names())

    def _new_child(self) -> _Child:
        raise NotImplementedError

    def _sample_names(self) -> Tuple[str, ...]:
        return (self._name,)

    def labels(self, **values: str) -> _Child:
        if not self._labelnames:
            raise ValueError(f"No label names were set when constructing {self._name}")
        if set(values) != set(self._labelnames):
            raise ValueError("Incorrect label names")
        key = tuple(str(values[n]) for n in self._labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
        return child

    def __getattr__(self, attr: str):
        # inc / dec / set / observe on an unlabelled metric go to its series.
        if attr.startswith("_") or not self.__dict__.get("_children") or self._labelnames:
            raise AttributeError(attr)
        return getattr(self._children[()], attr)

    def _series(self) -> List[Tuple[Dict[str, str], _Child]]:
        with self._lock:
            items = list(self._children.items())
        return [(dict(zip(self._labelnames, key)), child) for key, child in items]


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str] = (),
                 registry: Optional[CollectorRegistry] = None):
        # prometheus_client's naming: the family is the name less "_total".
        super().__init__(name[: -len("_total")] if name.endswith("_total") else name, documentation, labelnames,
                         registry)

    def _new_child(self) -> _Child:
        return _CounterChild()

    def _sample_names(self) -> Tuple[str, ...]:
        return (self._name, self._name + "_total", self._name + "_created")

    def collect(self) -> List[MetricFamily]:
        fam = MetricFamily(self._name, "counter", self._documentation)
        for labels, child in self._series():
            fam.add_sample(self._name + "_total", labels, child.value)
            fam.add_sample(self._name + "_created", labels, child.created)
        return [fam]


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self) -> _Child:
        return _GaugeChild()

    def collect(self) -> List[MetricFamily]:
        fam = MetricFamily(self._name, "gauge", self._documentation)
        for labels, child in self._series():
            fam.add_sample(self._name, labels, child.value)
        return [fam]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, documentation: str, labelnames: Sequence[str] = (),
                 registry: Optional[CollectorRegistry] = None, buckets: Sequence[float] = DEFAULT_BUCKETS):
        bounds = [float(b) for b in buckets]
        if bounds != sorted(bounds):
            raise ValueError("Buckets not in sorted order")
        if not bounds or bounds[-1] != INF:
            bounds.append(INF)
        if len(bounds) < 2:
            raise ValueError("Must have at least two buckets")
        self._bounds = tuple(bounds)
        super().__init__(name, documentation, labelnames, registry)

    def _new_child(self) -> _Child:
        return _HistogramChild(self._bounds)

    def _sample_names(self) -> Tuple[str, ...]:
        n = self._name
        return (n, n + "_bucket", n + "_count", n + "_sum", n + "_created")

    def collect(self) -> List[MetricFamily]:
        fam = MetricFamily(self._name, "histogram", self._documentation)
        for labels, child in self._series():
            acc = 0.0
            for bound, count in zip(self._bounds, list(child.buckets)):
                acc += count
                fam.add_sample(self._name + "_bucket", {**labels, "le": float_to_go_string(bound)}, acc)
            fam.add_sample(self._name + "_count", labels, acc)
            fam.add_sample(self._name + "_sum", labels, child.sum)
            fam.add_sample(self._name + "_created", labels, child.created)
        return [fam]


# --- the hierarchy ----------------------------------------------------------------


class MetricsRegistry:
    """A node in the metrics hierarchy. Children inherit labels."""

    def __init__(
        self,
        registry: Optional[CollectorRegistry] = None,
        labels: Optional[Dict[str, str]] = None,
        prefix: str = COMPONENT_PREFIX,
    ):
        self.registry = registry or CollectorRegistry()
        self.labels = dict(labels or {})
        self.prefix = prefix
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def child(self, **labels: str) -> "MetricsRegistry":
        merged = {**self.labels, **labels}
        return MetricsRegistry(self.registry, merged, self.prefix)

    def _full_name(self, name: str) -> str:
        return name if name.startswith("dynamo_") else f"{self.prefix}{name}"

    def _get_or_create(self, kind, name: str, documentation: str, extra_labels: Iterable[str] = (), **kwargs):
        full = self._full_name(name)
        label_names = tuple(sorted(self.labels)) + tuple(extra_labels)
        key = f"{full}|{','.join(label_names)}"
        with self._lock:
            metric = self._metrics.get(key)
            if metric is None:
                try:
                    metric = kind(full, documentation, labelnames=label_names, registry=self.registry, **kwargs)
                except ValueError:
                    # Already registered on the shared registry by a sibling
                    # node: reuse the collector, but ONLY if its label set
                    # matches (a mismatch would record under the wrong
                    # series, or fail far from the declaring call).
                    metric = self.registry._names_to_collectors.get(full)
                    if metric is None:
                        raise
                    existing = tuple(getattr(metric, "_labelnames", ()))
                    if tuple(sorted(existing)) != tuple(sorted(label_names)):
                        raise ValueError(
                            f"metric {full!r} already registered with labels "
                            f"{sorted(existing)}, requested {sorted(label_names)}; "
                            "sibling registries must declare identical label sets "
                            "for a shared metric name"
                        )
                self._metrics[key] = metric
        return metric

    def _labelled(self, metric, extra: Dict[str, str]):
        values = {**self.labels, **extra}
        return metric.labels(**values) if values else metric

    def counter(self, name: str, documentation: str = "", **extra_labels: str):
        m = self._get_or_create(Counter, name, documentation, extra_labels=sorted(extra_labels))
        return self._labelled(m, extra_labels)

    def gauge(self, name: str, documentation: str = "", **extra_labels: str):
        m = self._get_or_create(Gauge, name, documentation, extra_labels=sorted(extra_labels))
        return self._labelled(m, extra_labels)

    def histogram(
        self,
        name: str,
        documentation: str = "",
        buckets: Optional[Tuple[float, ...]] = None,
        **extra_labels: str,
    ):
        kwargs = {"buckets": buckets} if buckets else {}
        m = self._get_or_create(Histogram, name, documentation, extra_labels=sorted(extra_labels), **kwargs)
        return self._labelled(m, extra_labels)

    def render(self) -> bytes:
        """Prometheus text exposition."""
        return generate_latest(self.registry)


def parse_text(text: str) -> Dict[str, dict]:
    """Read a text exposition back: ``{family: {"type", "help", "samples":
    [(name, labels, value), ...]}}``, families named as their ``# TYPE``
    lines name them. Raises ``ValueError`` on a line it cannot read."""
    fams: Dict[str, dict] = {}
    current: Optional[dict] = None
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            name, _, doc = line[7:].partition(" ")
            current = fams.setdefault(name, {"type": None, "help": doc, "samples": []})
            continue
        if line.startswith("# TYPE "):
            name, _, mtype = line[7:].partition(" ")
            current = fams.setdefault(name, {"type": None, "help": "", "samples": []})
            current["type"] = mtype
            continue
        if line.startswith("#"):
            continue
        if current is None:
            raise ValueError(f"sample before any family: {line!r}")
        head, _, value = line.rpartition(" ")
        labels: Dict[str, str] = {}
        name = head
        if head.endswith("}"):
            name, _, body = head[:-1].partition("{")
            i = 0
            while i < len(body):
                eq = body.index("=", i)
                key = body[i:eq]
                if body[eq + 1] != '"':
                    raise ValueError(f"unquoted label value: {line!r}")
                j, val = eq + 2, []
                while body[j] != '"':
                    if body[j] == "\\":
                        val.append({"n": "\n", "\\": "\\", '"': '"'}[body[j + 1]])
                        j += 2
                    else:
                        val.append(body[j])
                        j += 1
                labels[key] = "".join(val)
                i = j + 1
                if i < len(body) and body[i] == ",":
                    i += 1
        current["samples"].append((name, labels, float(value)))
    return fams


# Latency histogram buckets tuned for LLM serving (TTFT ms-scale, ITL
# ms-scale): the JAX package's.
TTFT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
ITL_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)
DURATION_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)
# Mixed-step composition: prefill tokens riding one engine step (the
# scheduler's prefill-bucket rungs).
MIXED_PREFILL_TOKEN_BUCKETS = (0.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0, 1024.0, 2048.0)
