"""Per-source circuit breakers: stop calling a dependency that stopped working.

Host-only copy of ``albedo_tpu/serving/breaker.py`` for the PyTorch port. The
JAX module guards its state with locksmith's ``named_lock``; the port has no
lock-order sanitizer yet, so the breaker holds a plain ``threading.Lock``
(a leaf: no other lock is taken under it, and transition callbacks run after
it is released).

The two-stage pipeline's original failure handling was a bare timeout-drop:
a source that missed its deadline was dropped from THAT request's fusion,
and the next request submitted to it again. Against a source that is down
(not merely slow once), that burns a pool thread per request on work that
cannot succeed — the zombie-thread problem the ranker's dedicated pool
already works around — and keeps request latency pinned at the stage
deadline for as long as the outage lasts.

A breaker makes the failure cheap. Per source:

- **closed** (healthy): calls pass through; consecutive failures are
  counted, success resets the count.
- **open** (tripped, after ``failure_threshold`` consecutive failures):
  calls are skipped outright — the request degrades immediately with
  ``breaker_open_<source>`` instead of waiting out the deadline.
- **half-open** (reopen timer expired): exactly ONE trial call is admitted;
  success closes the breaker, failure re-opens it with a longer timer.

Reopen timing rides the shared :class:`~albedo_tpu_torch.utils.retry.RetryPolicy`
schedule — the same base/multiplier/cap curve the offline retries use —
with **equal jitter** (delay ~ cap/2 + U(0, cap/2)) rather than the
retries' full jitter: a breaker that can draw a ~0 s reopen delay would
hammer a dead dependency exactly when it should be backing off, while
synchronized reopens across a fleet are still smeared across half the cap.
Consecutive trips walk up the schedule (attempt = trip count), so a source
that keeps failing its trial calls is probed geometrically less often.

The ``serving.breaker.<source>`` fault site (``utils.faults``) fires inside
every breaker-admitted call, so chaos tests can trip/recover a breaker
deterministically (``serving.breaker.als:error@1*5``) without stubbing the
source itself. State transitions update the
``albedo_breaker_state{source=}`` gauge (0 closed / 1 half-open / 2 open)
and the ``albedo_breaker_transitions_total{source=,to=}`` counter; the
readiness probe reports every breaker's state.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable

from albedo_tpu_torch.utils.retry import RetryPolicy

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# Gauge encoding for albedo_breaker_state{source=}.
STATE_VALUES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Trip threshold + reopen schedule (immutable, shareable).

    ``reopen`` supplies the backoff curve fields (base/multiplier/cap,
    ``jitter=False`` for deterministic tests); its attempt/deadline fields
    are unused here — a breaker never gives up, it just probes less often.
    """

    failure_threshold: int = 3
    reopen: RetryPolicy = RetryPolicy(
        base_s=1.0, multiplier=2.0, max_delay_s=30.0, jitter=True
    )

    def __post_init__(self):
        if self.failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {self.failure_threshold}"
            )

    def reopen_delay(self, trip: int, rng: random.Random) -> float:
        """Open -> half-open delay for the ``trip``-th consecutive trip
        (1-based): equal jitter over the policy's backoff cap."""
        cap = self.reopen.cap(trip - 1)
        if not self.reopen.jitter:
            return cap
        return cap / 2.0 + rng.uniform(0.0, cap / 2.0)


class CircuitBreaker:
    """One source's breaker (thread-safe).

    The caller contract is ``allow()`` -> perform the call ->
    ``record_success()`` / ``record_failure()``. A denied ``allow()`` means
    skip the call entirely. ``clock``/``rng`` are injectable so tests drive
    the reopen timer deterministically instead of sleeping.
    """

    def __init__(
        self,
        name: str,
        config: BreakerConfig | None = None,
        clock: Callable[[], float] = time.monotonic,
        rng: random.Random | None = None,
        on_transition: Callable[[str, str], None] | None = None,
    ):
        self.name = name
        self.config = config or BreakerConfig()
        self.clock = clock
        self._rng = rng or random.Random()
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._trips = 0          # consecutive open periods (resets on close)
        self._reopen_at = 0.0
        self._trial_in_flight = False
        self.total_trips = 0     # lifetime, for snapshots/metrics
        self.total_skipped = 0   # calls denied while open

    # ------------------------------------------------------------- internals

    def _set_state(self, new_state: str) -> Callable | None:
        """Flip state under the caller's lock; returns the notification
        thunk to run AFTER the lock is released (metrics callbacks must not
        run under the breaker lock)."""
        if new_state == self._state:
            return None
        self._state = new_state
        cb = self._on_transition
        if cb is None:
            return None
        return lambda: cb(self.name, new_state)

    # ------------------------------------------------------------ public API

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May the caller perform the protected call right now?

        ``False`` means skip-and-degrade. In half-open, only one trial is
        admitted at a time — concurrent requests during a probe window don't
        stampede a barely-recovering dependency.
        """
        notify = None
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._state == OPEN:
                if self.clock() < self._reopen_at:
                    self.total_skipped += 1
                    return False
                notify = self._set_state(HALF_OPEN)
                self._trial_in_flight = True
                allowed = True
            else:  # HALF_OPEN
                if self._trial_in_flight:
                    self.total_skipped += 1
                    allowed = False
                else:
                    self._trial_in_flight = True
                    allowed = True
        if notify is not None:
            notify()
        return allowed

    def record_success(self) -> None:
        notify = None
        with self._lock:
            if self._state == OPEN:
                # A late success from a zombie thread (the call timed out for
                # the request, then finished): the timeout already counted as
                # the failure; don't let the zombie flip state.
                return
            self._consecutive_failures = 0
            self._trial_in_flight = False
            if self._state == HALF_OPEN:
                self._trips = 0
                notify = self._set_state(CLOSED)
        if notify is not None:
            notify()

    def record_failure(self) -> None:
        notify = None
        with self._lock:
            if self._state == OPEN:
                return  # already open; late zombie failures change nothing
            self._consecutive_failures += 1
            self._trial_in_flight = False
            tripped = (
                self._state == HALF_OPEN
                or self._consecutive_failures >= self.config.failure_threshold
            )
            if tripped:
                self._trips += 1
                self.total_trips += 1
                self._reopen_at = self.clock() + self.config.reopen_delay(
                    self._trips, self._rng
                )
                notify = self._set_state(OPEN)
        if notify is not None:
            notify()

    def abandon_trial(self) -> None:
        """The protected call never completed for reasons unrelated to the
        dependency (the request was aborted mid-flight, e.g. by a hot-swap
        retirement): release a held half-open trial slot without recording
        an outcome, so the next request can run the trial instead of every
        caller being denied forever."""
        with self._lock:
            self._trial_in_flight = False

    def reset(self) -> None:
        """Force-close (admin/testing escape hatch)."""
        notify = None
        with self._lock:
            self._consecutive_failures = 0
            self._trips = 0
            self._trial_in_flight = False
            notify = self._set_state(CLOSED)
        if notify is not None:
            notify()

    def snapshot(self) -> dict:
        """State + counters for the readiness probe / admin surface."""
        with self._lock:
            out = {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "total_trips": self.total_trips,
                "total_skipped": self.total_skipped,
            }
            if self._state == OPEN:
                out["reopen_in_s"] = round(max(0.0, self._reopen_at - self.clock()), 3)
            return out
