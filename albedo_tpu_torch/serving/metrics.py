"""Observability plane: the serving metrics registry and `/metrics` page.

Host-only copy of ``albedo_tpu/serving/metrics.py`` for the PyTorch port.
The Prometheus-compatible primitives (:class:`Counter`/:class:`Gauge`/
:class:`Histogram`, text format 0.0.4) live in ``utils.events`` and are
re-exported here; this module owns the serving registry, with the same
metric names as the JAX package's (the hot-swap and breaker series render
0 until those layers are ported). ``render()`` also appends the
process-global counters (``utils.events.global_metrics()``): injected-fault
firings and retrieval-bank queries surface on the same `/metrics` page.
"""

from __future__ import annotations

import threading

from albedo_tpu_torch.utils import events
from albedo_tpu_torch.utils.events import (  # noqa: F401  (re-exported API)
    DEFAULT_SIZE_BUCKETS,
    DEFAULT_TIME_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    global_metrics,
)


class MetricsRegistry:
    """All serving metrics, renderable as one Prometheus text page."""

    def __init__(self):
        self._metrics: list = []
        self._lock = threading.Lock()
        # Core serving metrics, pre-registered so /metrics is stable from the
        # first scrape (counters render 0 before any traffic).
        self.requests = self.counter(
            events.REQUESTS_TOTAL, "HTTP requests by route and status code.",
            ("route", "status"),
        )
        self.request_latency = self.histogram(
            events.REQUEST_LATENCY_SECONDS, "End-to-end request latency."
        )
        self.batch_size = self.histogram(
            events.SERVING_BATCH_SIZE,
            "Users per coalesced device batch (pre-padding).",
            DEFAULT_SIZE_BUCKETS,
        )
        self.batch_latency = self.histogram(
            events.SERVING_BATCH_SECONDS, "Device batch execution latency."
        )
        self.cache_hits = self.counter(
            events.CACHE_HITS_TOTAL, "Result-cache hits."
        )
        self.cache_misses = self.counter(
            events.CACHE_MISSES_TOTAL, "Result-cache misses."
        )
        self.degraded = self.counter(
            events.DEGRADED_TOTAL,
            "Requests answered on a degraded path, by reason.",
            ("reason",),
        )
        self.shed = self.counter(
            events.SHED_TOTAL,
            "Requests rejected with 429 (queue overflow or deadline shed).",
        )
        self.deadline_shed = self.counter(
            events.DEADLINE_SHED_TOTAL,
            "Requests shed by admission control: deadline expired while queued.",
        )
        # --- live-ops plane: hot swap + circuit breakers --------------------
        self.model_generation = self.gauge(
            events.MODEL_GENERATION,
            "Currently-promoted model generation (0 = none promoted yet).",
        )
        self.reloads = self.counter(
            events.RELOAD_TOTAL,
            "Hot-swap reload attempts by outcome (promoted/rejected/rolled_back).",
            ("outcome",),
        )
        self.reload_rejected = self.counter(
            events.RELOAD_REJECTED_TOTAL,
            "Hot-swap candidates rejected, by the validation gate that failed.",
            ("gate",),
        )
        self.generation_requests = self.counter(
            events.GENERATION_REQUESTS_TOTAL,
            "Recommend requests answered, by the model generation that served them.",
            ("generation",),
        )
        self.breaker_state = self.gauge(
            events.BREAKER_STATE,
            "Per-source circuit breaker state (0=closed, 1=half_open, 2=open).",
            ("source",),
        )
        self.breaker_transitions = self.counter(
            events.BREAKER_TRANSITIONS_TOTAL,
            "Circuit breaker state transitions, by source and new state.",
            ("source", "to"),
        )
        # --- overload-resilience plane (serving/overload.py) ----------------
        self.admission_limit = self.gauge(
            events.ADMISSION_LIMIT,
            "Current AIMD adaptive admission limit (outstanding requests).",
        )
        self.brownout_level = self.gauge(
            events.BROWNOUT_LEVEL,
            "Brownout ladder level (0=full .. 4=shed).",
        )
        self.overload_shed = self.counter(
            events.OVERLOAD_SHED_TOTAL,
            "Requests shed by the overload layer, by active brownout tier.",
            ("tier",),
        )

    def counter(self, name, help_, label_names=()) -> Counter:
        m = Counter(name, help_, label_names)
        with self._lock:
            self._metrics.append(m)
        return m

    def gauge(self, name, help_, label_names=()) -> Gauge:
        m = Gauge(name, help_, label_names)
        with self._lock:
            self._metrics.append(m)
        return m

    def histogram(self, name, help_, buckets=DEFAULT_TIME_BUCKETS) -> Histogram:
        m = Histogram(name, help_, buckets)
        with self._lock:
            self._metrics.append(m)
        return m

    def render(self) -> str:
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics)
        # Process-global counters (injected faults, bank queries) ride every
        # exposition.
        for m in [*metrics, *global_metrics()]:
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + "\n"
