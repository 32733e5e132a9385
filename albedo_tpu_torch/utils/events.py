"""Dependency-free metric primitives and the process-global event counters.

Host-only copy of ``albedo_tpu/utils/events.py`` for the PyTorch port: the
Prometheus-compatible :class:`Counter`/:class:`Gauge`/:class:`Histogram`
primitives the serving metrics plane is built from, the ``albedo_*`` metric
names, and the process-global counters of the layers the port has (injected
fault firings, retrieval-bank queries). ``MetricsRegistry.render`` appends
``global_metrics()`` to every exposition.

Exposition follows the Prometheus text format 0.0.4 (`# HELP` / `# TYPE`
lines, cumulative `_bucket{le=...}` histogram rows, `_sum`/`_count` totals).
"""

from __future__ import annotations

import threading
from typing import Iterable, Mapping

# Latency-oriented default buckets (seconds): sub-ms dispatches up to
# multi-second degraded responses.
DEFAULT_TIME_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0,
)
# Batch-size buckets: the power-of-two shape ladder the micro-batcher pads to.
DEFAULT_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def _fmt_value(v: float) -> str:
    """Prometheus renders integers bare and floats as-is; +Inf specially."""
    if v == float("inf"):
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


def _escape_label(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: Mapping[str, str] | None) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Monotonic counter, optionally labelled (one child per label set)."""

    kind = "counter"

    def __init__(self, name: str, help_: str, label_names: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._values: dict[tuple[str, ...], float] = {}
        # Leaf lock, one per counter, never held across another acquisition.
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            return self._values.get(key, 0.0)

    def total(self) -> float:
        """Sum across every label set (convenience for tests/reports)."""
        with self._lock:
            return sum(self._values.values())

    def clear(self) -> None:
        """Drop all samples — test isolation for process-global counters."""
        with self._lock:
            self._values.clear()

    def render(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]  # unlabelled counters always expose a sample
        for key, value in items:
            labels = dict(zip(self.label_names, key))
            yield f"{self.name}{_fmt_labels(labels)} {_fmt_value(value)}"


class Gauge(Counter):
    """Settable value; shares the labelled-children plumbing of Counter."""

    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = tuple(str(labels.get(n, "")) for n in self.label_names)
        with self._lock:
            self._values[key] = float(value)


class Histogram:
    """Cumulative-bucket histogram (unlabelled — one series per metric)."""

    kind = "histogram"

    def __init__(self, name: str, help_: str, buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._sum += value
            self._count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def snapshot(self) -> dict:
        """(count, sum, per-bucket cumulative counts) under one lock."""
        with self._lock:
            cum, total = [], 0
            for c in self._counts:
                total += c
                cum.append(total)
            return {"count": self._count, "sum": self._sum, "cumulative": cum}

    def render(self) -> Iterable[str]:
        snap = self.snapshot()
        edges = [*self.buckets, float("inf")]
        for edge, c in zip(edges, snap["cumulative"]):
            yield f'{self.name}_bucket{{le="{_fmt_value(edge)}"}} {c}'
        yield f"{self.name}_sum {_fmt_value(snap['sum'])}"
        yield f"{self.name}_count {snap['count']}"


# --- the metric-name registry -------------------------------------------------
#
# Every ``albedo_*`` metric name is defined here, once, as a constant (the
# same names as the JAX package's, so one dashboard reads both).

# Serving plane (serving/metrics.py MetricsRegistry).
REQUESTS_TOTAL = "albedo_requests_total"
REQUEST_LATENCY_SECONDS = "albedo_request_latency_seconds"
SERVING_BATCH_SIZE = "albedo_serving_batch_size"
SERVING_BATCH_SECONDS = "albedo_serving_batch_seconds"
CACHE_HITS_TOTAL = "albedo_cache_hits_total"
CACHE_MISSES_TOTAL = "albedo_cache_misses_total"
DEGRADED_TOTAL = "albedo_degraded_total"
SHED_TOTAL = "albedo_shed_total"
DEADLINE_SHED_TOTAL = "albedo_deadline_shed_total"
MODEL_GENERATION = "albedo_model_generation"
RELOAD_TOTAL = "albedo_reload_total"
RELOAD_REJECTED_TOTAL = "albedo_reload_rejected_total"
GENERATION_REQUESTS_TOTAL = "albedo_generation_requests_total"
BREAKER_STATE = "albedo_breaker_state"
BREAKER_TRANSITIONS_TOTAL = "albedo_breaker_transitions_total"

# The process-global counters below.
FAULTS_FIRED_TOTAL = "albedo_faults_fired_total"
RETRIEVAL_QUERIES_TOTAL = "albedo_retrieval_queries_total"

# Overload-resilience plane (serving/overload.py).
BROWNOUT_LEVEL = "albedo_brownout_level"
OVERLOAD_SHED_TOTAL = "albedo_overload_shed_total"
ADMISSION_LIMIT = "albedo_admission_limit"

METRIC_NAMES: frozenset = frozenset(
    v for k, v in list(globals().items())
    if k.isupper() and isinstance(v, str) and v.startswith("albedo_")
)


# --- process-global offline counters -----------------------------------------

# Held only around registry-dict access; a leaf like the per-counter locks.
_global_lock = threading.Lock()
_global_metrics: dict[str, Counter] = {}


def global_counter(name: str, help_: str, label_names: tuple[str, ...] = ()) -> Counter:
    """Get-or-create a process-global counter by metric name.

    The label schema is fixed by the first caller; a mismatched re-request is
    a programming error and raises rather than silently forking the series.
    """
    with _global_lock:
        existing = _global_metrics.get(name)
        if existing is not None:
            if existing.label_names != tuple(label_names):
                raise ValueError(
                    f"global counter {name!r} exists with labels "
                    f"{existing.label_names}, requested {tuple(label_names)}"
                )
            return existing
        m = Counter(name, help_, label_names)
        _global_metrics[name] = m
        return m


def global_metrics() -> list[Counter]:
    """Every process-global metric, render-order stable (registration order)."""
    with _global_lock:
        return list(_global_metrics.values())


def reset_global_metrics() -> None:
    """Zero every global counter (keeps registrations) — test isolation."""
    for m in global_metrics():
        m.clear()


# The process-global counters of the ported layers, pre-registered so
# /metrics exposes them from the first scrape.
faults_fired = global_counter(
    FAULTS_FIRED_TOTAL,
    "Injected faults fired by the utils.faults harness, by site.",
    ("site",),
)
retrieval_queries = global_counter(
    RETRIEVAL_QUERIES_TOTAL,
    "User rows answered by the device-resident retrieval bank, by source.",
    ("source",),
)
