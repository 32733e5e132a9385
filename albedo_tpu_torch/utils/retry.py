"""Shared retry policy: exponential backoff with full jitter + deadline budget.

Host-only copy of ``albedo_tpu/utils/retry.py`` for the PyTorch port. In the
port the serving circuit breakers (``serving.breaker``) use it for their
reopen schedule; the layers the JAX package also retries (the crawler's
transport, artifact IO, the ``run_pipeline`` stage driver) are not ported
yet. Full jitter (delay ~ U(0, min(cap, base * mult^n)))
follows the AWS architecture-blog result ALX-style preemptible fleets rely
on: synchronized retry storms after a shared outage are worse than the
failure itself.

Servers that SAY when to come back are honored exactly: raise
:class:`RetryAfter` from the attempt (the crawler does, from the GitHub
``Retry-After`` / ``X-RateLimit-Reset`` headers) and the wait is the server's
number, not the backoff curve's. Every performed retry is counted in the
process-global ``albedo_retry_attempts_total{site=...}`` counter
(``utils.events``) so `/metrics` shows which dependency is flapping.

The serving circuit breakers (``serving.breaker``) ride the SAME
:class:`RetryPolicy` schedule for their open -> half-open reopen timing
(base/multiplier/cap walked up per consecutive trip), with equal jitter
instead of full jitter — a breaker drawing a ~0 s delay would probe a dead
dependency exactly when it should back off.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable

from albedo_tpu_torch.utils import events


# Substrings a device OOM carries. Classification is by class name + message
# (the JAX package's XlaRuntimeError, PyTorch's ``OutOfMemoryError``), which
# also covers the fault harness's InjectedResourceExhausted (a MemoryError).
_RESOURCE_EXHAUSTED_MARKERS = (
    "RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED", "Out of memory",
    "out of memory", "OOM",
)


def is_resource_exhausted(exc: BaseException) -> bool:
    """True for device/host OOM-shaped failures: ``MemoryError``, an
    ``XlaRuntimeError`` (by class name — jaxlib moves it between modules)
    whose message says RESOURCE_EXHAUSTED/out-of-memory, or the fault
    harness's injected OOM. These are PERMANENT for retry purposes: the
    same allocation re-OOMs the same device, so backoff burns the whole
    budget re-crashing — the caller must fail fast to the degrade path
    (``utils.capacity``) instead."""
    if isinstance(exc, MemoryError):
        return True
    msg = str(exc)
    name = type(exc).__name__
    if name == "OutOfMemoryError":  # torch.cuda.OutOfMemoryError / torch.OutOfMemoryError
        return True
    if name == "XlaRuntimeError" or "XlaRuntimeError" in name:
        return any(m in msg for m in _RESOURCE_EXHAUSTED_MARKERS)
    return any(m in msg for m in _RESOURCE_EXHAUSTED_MARKERS[:2])


# Substrings a dead/hung collective carries, across backends and jax
# versions: jaxlib surfaces a shard that stopped answering as an
# XlaRuntimeError DEADLINE_EXCEEDED from the stuck all-gather/psum, and the
# distributed runtime (coordination service) reports the lost worker as a
# missed-heartbeat failure. Classification is by name + message, like the
# OOM predicate above — which also covers the fault harness's
# InjectedDeviceLoss without importing jax here.
_COLLECTIVE_LOST_MARKERS = (
    "DEADLINE_EXCEEDED", "DEADLINE EXCEEDED", "heartbeat",
    "coordination service", "task disconnected", "device lost",
)


def is_collective_lost(exc: BaseException) -> bool:
    """True for device-loss-shaped collective failures: a jaxlib
    ``XlaRuntimeError`` whose message says DEADLINE_EXCEEDED (the stuck
    collective's timeout), a distributed-runtime heartbeat/coordination
    failure, the elastic watchdog's own :class:`CollectiveTimeout`-shaped
    deadline trip, or the fault harness's injected ``loss`` kind. These are
    PERMANENT for retry purposes: the shard is dead or wedged, so every
    retry re-hangs the same collective until the backoff budget burns —
    the caller must fail FAST to the elastic remesh-resume path
    (``parallel/elastic.py``) instead."""
    msg = str(exc)
    name = type(exc).__name__
    if name in ("InjectedDeviceLoss", "CollectiveTimeout"):
        return True
    if "XlaRuntimeError" in name or "RuntimeError" in name:
        return any(m.lower() in msg.lower() for m in _COLLECTIVE_LOST_MARKERS)
    return any(m.lower() in msg.lower() for m in _COLLECTIVE_LOST_MARKERS[:2])


def default_retry_predicate(exc: BaseException) -> bool:
    """The shared baseline predicate: any Exception retries EXCEPT
    resource exhaustion (see :func:`is_resource_exhausted`) and collective
    device loss (see :func:`is_collective_lost`) — both re-fail identically
    on retry and must fail fast to their degrade/elastic paths. Callers
    with their own predicate should compose it:
    ``lambda e: my_check(e) and default_retry_predicate(e)``."""
    return not (is_resource_exhausted(exc) or is_collective_lost(exc))


class RetryAfter(Exception):
    """An attempt failed but the server supplied the wait: honor it.

    ``delay_s`` overrides the backoff curve for this one retry (still clipped
    to the policy's remaining deadline). Raised by callers' attempt
    functions; never raised by this module.
    """

    def __init__(self, delay_s: float, message: str = ""):
        super().__init__(message or f"retry after {delay_s:g}s")
        self.delay_s = max(0.0, float(delay_s))


class RetriesExhausted(Exception):
    """All attempts failed (or the deadline expired). ``__cause__`` is the
    last attempt's exception; ``attempts`` is how many were made."""

    def __init__(self, site: str, attempts: int, last: BaseException):
        super().__init__(f"{site}: giving up after {attempts} attempts: {last!r}")
        self.site = site
        self.attempts = attempts
        self.last = last


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff schedule + stop conditions (immutable, shareable).

    ``max_attempts`` counts TOTAL attempts (first try included);
    ``deadline_s`` caps wall-clock across attempts AND sleeps — a retry whose
    jittered delay would overshoot the deadline sleeps only the remainder,
    gets one last attempt, and then gives up.
    """

    max_attempts: int = 5
    base_s: float = 0.5
    multiplier: float = 2.0
    max_delay_s: float = 60.0
    deadline_s: float | None = None
    jitter: bool = True  # full jitter; False = deterministic caps (tests)

    def cap(self, attempt: int) -> float:
        """The (un-jittered) backoff ceiling after the ``attempt``-th failure
        (0-based) — the one place the curve is defined. The exponent guard
        keeps a counter that keeps climbing (e.g. a breaker open for hours)
        from overflowing float range long after ``max_delay_s`` took over."""
        return min(
            self.max_delay_s, self.base_s * (self.multiplier ** min(attempt, 64))
        )

    def delay(self, attempt: int, rng: random.Random) -> float:
        """Backoff delay after the ``attempt``-th failure (0-based)."""
        cap = self.cap(attempt)
        return rng.uniform(0.0, cap) if self.jitter else cap


def retry_call(
    fn: Callable[[], Any],
    *,
    policy: RetryPolicy | None = None,
    retry_on: Callable[[BaseException], bool] | None = None,
    site: str = "call",
    sleeper: Callable[[float], None] = time.sleep,
    rng: random.Random | None = None,
    clock: Callable[[], float] = time.monotonic,
    on_retry: Callable[[int, BaseException, float], None] | None = None,
) -> Any:
    """Call ``fn()`` until it returns, the predicate rejects, or budget ends.

    - ``retry_on(exc)`` decides retryability (default:
      :func:`default_retry_predicate` — any Exception EXCEPT resource
      exhaustion, which re-OOMs identically and must fail fast to the
      capacity degrade path); non-retryable exceptions propagate unchanged.
      :class:`RetryAfter` is always retryable and carries its own delay.
    - ``on_retry(attempt, exc, delay_s)`` observes each scheduled retry.
    - Exhaustion raises :class:`RetriesExhausted` from the last exception.

    ``sleeper``/``rng``/``clock`` are injectable for deterministic tests.
    """
    policy = policy or RetryPolicy()
    rng = rng or random.Random()
    start = clock()
    last: BaseException | None = None
    for attempt in range(max(1, policy.max_attempts)):
        try:
            return fn()
        except RetryAfter as e:
            last = e
            delay = e.delay_s
        except Exception as e:  # noqa: BLE001 — predicate decides
            predicate = retry_on if retry_on is not None else default_retry_predicate
            if not predicate(e):
                raise
            last = e
            delay = policy.delay(attempt, rng)
        if attempt + 1 >= policy.max_attempts:
            break
        if policy.deadline_s is not None:
            remaining = policy.deadline_s - (clock() - start)
            if remaining <= 0:
                break
            delay = min(delay, remaining)
        events.retry_attempts.inc(site=site)
        if on_retry is not None:
            on_retry(attempt, last, delay)
        if delay > 0:
            sleeper(delay)
    raise RetriesExhausted(site, min(policy.max_attempts, attempt + 1), last) from last
