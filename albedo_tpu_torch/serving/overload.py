"""Overload resilience: adaptive admission, CoDel shed, the brownout ladder.

Host-only copy of ``albedo_tpu/serving/overload.py`` for the PyTorch port
(plain ``threading`` locks): the same decisions on the same observations.

The serving plane's load shedding used to be a static bounded queue: 256
waiting requests, then 429s priced from queue depth x EWMA batch latency.
That protects the process but not the latency SLO — a queue sized for peak
throughput holds seconds of standing delay long before it overflows, and
the Retry-After estimate knows nothing about how degraded the service
already is. This module replaces it with three cooperating mechanisms:

- :class:`AdaptiveLimit` — an **AIMD concurrency limit** on the number of
  requests the batcher will hold: every observed batch under the latency
  SLO grows the limit additively, every breach shrinks it multiplicatively
  (the TCP congestion-control shape; see also Netflix concurrency-limits).
  The live limit is exported as ``albedo_admission_limit`` and a submit
  beyond it is shed with a 429 whose ``Retry-After`` reflects the *current*
  limit, not the configured queue capacity.
- :class:`CoDelShedder` — a **CoDel-style queue discipline**: when the
  oldest queued request's sojourn has exceeded ``target_s`` continuously
  for a full ``interval_s``, the batcher starts shedding the
  oldest-lapsed work first, at the classic ``interval / sqrt(count)``
  control-law cadence, until the head sojourn drops back under target.
  Standing queue delay drains instead of being served stale.
- :class:`BrownoutLadder` — a **hysteresis state machine** over the
  degradation tiers of the two-stage pipeline::

      0 full              full two-stage re-rank
      1 skip_rerank       skip the LR re-rank; raw bank/ALS MIPS scores
      2 bank_only         reduced k, bank-resident sources only
      3 cache_popularity  TTL-cached bodies + popularity fallback only
      4 shed              429 + Retry-After before any compute

  Escalation takes ``engage_after`` *consecutive* pressure observations
  (a batch or head-of-queue sojourn over the SLO) with at least
  ``dwell_s`` between transitions; de-escalation steps down ONE tier per
  ``recovery_window_s`` of sustained calm — a brief lull never snaps a
  browned-out service straight back to full work. Every transition moves
  the ``albedo_brownout_level`` gauge; every shed is counted per tier in
  ``albedo_overload_shed_total{tier=}``; every degraded response carries
  the active tier tag. No overload path returns a 5xx.

:class:`OverloadController` composes the three and is shared across model
generations (the service owns one; every generation's batcher feeds it),
so a hot swap under pressure inherits the brownout state instead of
resetting it. The ``serving.admit`` fault site fires inside every
admission decision — arm ``serving.admit:error@1*N`` to drill the shed
path without real load.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time

from albedo_tpu_torch.utils import faults

log = logging.getLogger(__name__)

# Chaos hook: one dict lookup per admission decision when unarmed; armed
# `error` forces the decision to "shed" (the 429 drill), armed `delay`
# stalls admission itself.
_ADMIT_FAULT = faults.site("serving.admit")

# The brownout ladder's tiers, in degradation order. Indices are the levels
# the `albedo_brownout_level` gauge reports.
TIERS = ("full", "skip_rerank", "bank_only", "cache_popularity", "shed")
LEVEL_FULL = 0
LEVEL_SKIP_RERANK = 1
LEVEL_BANK_ONLY = 2
LEVEL_CACHE_POPULARITY = 3
LEVEL_SHED = 4


def tier_name(level: int) -> str:
    return TIERS[max(LEVEL_FULL, min(int(level), LEVEL_SHED))]


@dataclasses.dataclass(frozen=True)
class OverloadConfig:
    """Tuning for the overload-resilience layer.

    ``slo_s`` is the *batch latency* objective the AIMD limit tracks — one
    device batch (plus its head-of-queue wait) staying under it keeps the
    end-to-end budget honest. The defaults are deliberately permissive: a
    service that never breaches its SLO behaves exactly like the static
    bounded queue it replaced (the initial limit equals ``max_limit``).
    """

    slo_s: float = 0.25
    min_limit: int = 4
    max_limit: int = 256
    increase: float = 1.0          # additive growth per under-SLO batch
    decrease: float = 0.5          # multiplicative cut per breach
    codel_target_s: float = 0.05   # acceptable standing head-of-queue sojourn
    codel_interval_s: float = 1.0  # how long above target before shedding
    engage_after: int = 3          # consecutive pressure signals per step down
    dwell_s: float = 0.5           # min seconds between ladder transitions
    recovery_window_s: float = 2.0  # sustained calm per step back up


class AdaptiveLimit:
    """AIMD concurrency limit driven by observed batch latency vs the SLO."""

    def __init__(self, cfg: OverloadConfig, gauge=None, initial: float | None = None):
        self.cfg = cfg
        self._gauge = gauge
        self._lock = threading.Lock()
        self._limit = float(cfg.max_limit if initial is None else initial)
        if gauge is not None:
            gauge.set(int(self._limit))

    @property
    def limit(self) -> int:
        with self._lock:
            return int(self._limit)

    def would_admit(self, outstanding: int) -> bool:
        return int(outstanding) < self.limit

    def observe(self, batch_s: float) -> int:
        """Feed one observed batch latency; returns the updated limit."""
        cfg = self.cfg
        with self._lock:
            if batch_s <= cfg.slo_s:
                self._limit = min(float(cfg.max_limit), self._limit + cfg.increase)
            else:
                self._limit = max(float(cfg.min_limit), self._limit * cfg.decrease)
            lim = int(self._limit)
        if self._gauge is not None:
            self._gauge.set(lim)
        return lim


class CoDelShedder:
    """CoDel control law over the head-of-queue sojourn.

    ``offer(head_sojourn_s)`` is called once per would-be shed with the
    OLDEST queued request's sojourn; ``True`` means "shed it". Below
    ``target_s`` all state resets; above it continuously for ``interval_s``
    the shedder enters the dropping state and fires at the classic
    ``interval / sqrt(drop_count)`` cadence — sparse sheds that drain
    standing delay without clear-cutting the queue.
    """

    def __init__(self, target_s: float, interval_s: float, clock=time.monotonic):
        self.target_s = float(target_s)
        self.interval_s = float(interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._first_above: float | None = None
        self._dropping = False
        self._drop_count = 0
        self._next_drop = 0.0

    def offer(self, head_sojourn_s: float) -> bool:
        now = self._clock()
        with self._lock:
            if head_sojourn_s < self.target_s:
                self._first_above = None
                self._dropping = False
                self._drop_count = 0
                return False
            if self._first_above is None:
                self._first_above = now + self.interval_s
                return False
            if not self._dropping:
                if now < self._first_above:
                    return False
                self._dropping = True
                self._drop_count = 1
                self._next_drop = now + self.interval_s
                return True
            if now >= self._next_drop:
                self._drop_count += 1
                self._next_drop = now + self.interval_s / math.sqrt(self._drop_count)
                return True
            return False


class BrownoutLadder:
    """Hysteresis state machine over the degradation tiers.

    Escalates one tier after ``engage_after`` consecutive pressure
    observations (with ``dwell_s`` between transitions); de-escalates one
    tier per ``recovery_window_s`` of sustained calm. Recovery is also
    *passive*: reading :attr:`level` applies any step-downs the elapsed
    quiet time has earned, so a service whose traffic stopped entirely
    still walks back to full work.
    """

    def __init__(
        self,
        engage_after: int = 3,
        dwell_s: float = 0.5,
        recovery_window_s: float = 2.0,
        clock=time.monotonic,
        gauge=None,
    ):
        self.engage_after = max(1, int(engage_after))
        self.dwell_s = float(dwell_s)
        self.recovery_window_s = float(recovery_window_s)
        self._clock = clock
        self._gauge = gauge
        self._lock = threading.Lock()
        self._level = LEVEL_FULL
        self._over_streak = 0
        self._changed_at = clock()
        self._last_signal = self._changed_at
        self._calm_since: float | None = self._changed_at
        if gauge is not None:
            gauge.set(LEVEL_FULL)

    @property
    def level(self) -> int:
        now = self._clock()
        with self._lock:
            self._decay_locked(now)
            return self._level

    def tier(self, level: int | None = None) -> str:
        return tier_name(self.level if level is None else level)

    def observe(self, pressure: bool) -> int:
        """Feed one pressure observation; returns the (new) level."""
        now = self._clock()
        with self._lock:
            self._decay_locked(now)
            if pressure:
                self._over_streak += 1
                self._calm_since = None
                if (
                    self._over_streak >= self.engage_after
                    and self._level < LEVEL_SHED
                    and now - self._changed_at >= self.dwell_s
                ):
                    self._set_level_locked(self._level + 1, now)
                    self._over_streak = 0
            else:
                self._over_streak = 0
                if self._calm_since is None:
                    self._calm_since = now
            self._last_signal = now
            return self._level

    def _decay_locked(self, now: float) -> None:
        # One step down per FULL recovery window of quiet — sequential
        # reversal, never a snap back to full under a long-idle read.
        while self._level > LEVEL_FULL:
            quiet_since = (
                self._calm_since if self._calm_since is not None else self._last_signal
            )
            ref = max(quiet_since, self._changed_at)
            if now - ref < self.recovery_window_s:
                break
            self._set_level_locked(self._level - 1, ref + self.recovery_window_s)

    def _set_level_locked(self, level: int, at: float) -> None:
        old, self._level = self._level, max(LEVEL_FULL, min(level, LEVEL_SHED))
        self._changed_at = at
        if self._gauge is not None:
            self._gauge.set(self._level)
        if self._level != old:
            log.info(
                "brownout ladder %s -> %s (level %d)",
                tier_name(old), tier_name(self._level), self._level,
            )


class OverloadController:
    """Adaptive admission + CoDel shed + brownout ladder, as one unit.

    Owned by the service and shared across model generations: every
    generation's micro-batcher feeds batch observations in and consults
    the same admission limit, so a hot swap under pressure inherits the
    brownout state instead of resetting the ladder mid-incident.
    """

    def __init__(self, config: OverloadConfig | None = None, metrics=None,
                 clock=time.monotonic):
        self.config = config or OverloadConfig()
        self._shed_counter = getattr(metrics, "overload_shed", None)
        self.limit = AdaptiveLimit(
            self.config, gauge=getattr(metrics, "admission_limit", None)
        )
        self.codel = CoDelShedder(
            self.config.codel_target_s, self.config.codel_interval_s, clock=clock
        )
        self.ladder = BrownoutLadder(
            engage_after=self.config.engage_after,
            dwell_s=self.config.dwell_s,
            recovery_window_s=self.config.recovery_window_s,
            clock=clock,
            gauge=getattr(metrics, "brownout_level", None),
        )

    # ------------------------------------------------------------- decisions

    def admit(self, outstanding: int) -> bool:
        """One admission decision: ``False`` = shed (429 upstream).

        Rejections caused by the *limit* feed the ladder as pressure;
        rejections caused by the ladder's shed tier do NOT — a trickle of
        shed requests during recovery must not reset the recovery window
        and wedge the service at the shed tier forever.
        """
        try:
            _ADMIT_FAULT.hit()
        except Exception:  # noqa: BLE001 — any armed fault = forced shed, never a 5xx
            self.count_shed()
            return False
        if self.ladder.level >= LEVEL_SHED:
            self.count_shed()
            return False
        if not self.limit.would_admit(outstanding):
            self.ladder.observe(True)
            self.count_shed()
            return False
        return True

    def codel_shed(self, head_sojourn_s: float) -> bool:
        """Should the oldest queued request be shed right now?"""
        if self.codel.offer(head_sojourn_s):
            self.count_shed()
            return True
        return False

    # ----------------------------------------------------------- observations

    def observe_batch(self, batch_s: float, head_sojourn_s: float = 0.0) -> None:
        """Feed one executed batch: latency drives the AIMD limit, and a
        batch OR head-of-queue sojourn over the SLO is ladder pressure."""
        self.limit.observe(batch_s)
        self.ladder.observe(
            batch_s > self.config.slo_s or head_sojourn_s > self.config.slo_s
        )

    def idle_tick(self) -> None:
        """An idle batcher worker's heartbeat: calm evidence for recovery."""
        self.ladder.observe(False)

    # -------------------------------------------------------------- reporting

    @property
    def brownout_level(self) -> int:
        return self.ladder.level

    @property
    def brownout_tier(self) -> str:
        return tier_name(self.ladder.level)

    def count_shed(self, tier: str | None = None) -> None:
        if self._shed_counter is not None:
            self._shed_counter.inc(tier=tier or self.brownout_tier)

    def price_retry_after(self, base_s: float, outstanding: int) -> float:
        """Fold the current limit and brownout level into a Retry-After
        estimate: queue-depth x EWMA alone under-prices a browned-out
        service and clients hammer a degraded tier."""
        level = self.ladder.level
        lim = max(1, self.limit.limit)
        congestion = max(1.0, float(outstanding + 1) / float(lim))
        return float(base_s) * (1.0 + level) * congestion

    def snapshot(self) -> dict:
        """The readiness probe's view of the overload layer."""
        level = self.ladder.level
        return {
            "admission_limit": self.limit.limit,
            "brownout_level": level,
            "brownout_tier": tier_name(level),
            "slo_s": self.config.slo_s,
        }
