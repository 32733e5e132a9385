"""The port's ``utils/retry.py`` against the JAX package's: each test of
``tests/test_retry.py`` (backoff shape, jitter bounds, deadline budget,
predicates, Retry-After honoring, the retry counter) runs on both packages,
and the two draw the same delays from the same seed."""

import random

import pytest
import torch

import albedo_tpu.utils.events as j_events
import albedo_tpu.utils.retry as j_retry
import albedo_tpu_torch.utils.events as t_events
import albedo_tpu_torch.utils.retry as t_retry


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    """(retry module, events module) of one package, the port's global
    counters zeroed (the suite's conftest zeroes the JAX package's)."""
    t_events.reset_global_metrics()
    return (j_retry, j_events) if request.param == "jax" else (t_retry, t_events)


def test_succeeds_after_transient_failures(pkg):
    R, E = pkg
    calls = []

    def fn():
        calls.append(1)
        if len(calls) < 3:
            raise ValueError("transient")
        return "ok"

    sleeps = []
    out = R.retry_call(
        fn,
        policy=R.RetryPolicy(max_attempts=5, base_s=0.1, max_delay_s=1.0),
        sleeper=sleeps.append,
        rng=random.Random(0),
    )
    assert out == "ok"
    assert len(calls) == 3
    assert len(sleeps) == 2  # one sleep per retry, none after success


def test_exhaustion_raises_with_cause(pkg):
    R, E = pkg
    def fn():
        raise ValueError("always")

    with pytest.raises(R.RetriesExhausted) as ei:
        R.retry_call(
            fn,
            policy=R.RetryPolicy(max_attempts=3, base_s=0.0),
            sleeper=lambda s: None,
        )
    assert ei.value.attempts == 3
    assert isinstance(ei.value.last, ValueError)
    assert isinstance(ei.value.__cause__, ValueError)


def test_non_retryable_propagates_unchanged(pkg):
    R, E = pkg
    calls = []

    def fn():
        calls.append(1)
        raise KeyError("fatal")

    with pytest.raises(KeyError):
        R.retry_call(
            fn,
            retry_on=lambda e: isinstance(e, ValueError),
            sleeper=lambda s: None,
        )
    assert len(calls) == 1  # no second attempt for a non-retryable error


def test_full_jitter_delays_bounded_by_exponential_caps(pkg):
    R, E = pkg
    policy = R.RetryPolicy(max_attempts=6, base_s=1.0, multiplier=2.0, max_delay_s=6.0)
    sleeps = []

    def fn():
        raise ValueError("x")

    with pytest.raises(R.RetriesExhausted):
        R.retry_call(fn, policy=policy, sleeper=sleeps.append, rng=random.Random(7))
    caps = [1.0, 2.0, 4.0, 6.0, 6.0]  # base * mult^n clipped at max_delay_s
    assert len(sleeps) == 5
    for delay, cap in zip(sleeps, caps):
        assert 0.0 <= delay <= cap


def test_no_jitter_uses_deterministic_caps(pkg):
    R, E = pkg
    policy = R.RetryPolicy(max_attempts=4, base_s=0.5, multiplier=2.0,
                         max_delay_s=10.0, jitter=False)
    sleeps = []

    def fn():
        raise ValueError("x")

    with pytest.raises(R.RetriesExhausted):
        R.retry_call(fn, policy=policy, sleeper=sleeps.append)
    assert sleeps == [0.5, 1.0, 2.0]


def test_retry_after_overrides_backoff(pkg):
    R, E = pkg
    calls = []

    def fn():
        calls.append(1)
        if len(calls) == 1:
            raise R.RetryAfter(123.0, "server says wait")
        return "ok"

    sleeps = []
    assert R.retry_call(fn, sleeper=sleeps.append) == "ok"
    assert sleeps == [123.0]


def test_deadline_stops_retrying(pkg):
    R, E = pkg
    clock = {"t": 0.0}

    def fake_clock():
        return clock["t"]

    def fake_sleep(s):
        clock["t"] += s

    def fn():
        raise ValueError("x")

    policy = R.RetryPolicy(max_attempts=100, base_s=1.0, multiplier=1.0,
                         max_delay_s=1.0, deadline_s=3.5, jitter=False)
    with pytest.raises(R.RetriesExhausted) as ei:
        R.retry_call(fn, policy=policy, sleeper=fake_sleep, clock=fake_clock)
    # 1s sleeps until the 3.5s budget is gone: far fewer than 100 attempts.
    assert ei.value.attempts <= 6
    assert clock["t"] <= 3.6


def test_retry_counter_increments_by_site(pkg):
    R, E = pkg
    before = E.retry_attempts.value(site="test.site")
    calls = []

    def fn():
        calls.append(1)
        if len(calls) < 3:
            raise ValueError("x")
        return 1

    R.retry_call(fn, site="test.site", policy=R.RetryPolicy(max_attempts=5, base_s=0.0),
               sleeper=lambda s: None)
    assert E.retry_attempts.value(site="test.site") == before + 2


def test_same_delays_from_the_same_seed():
    def delays(mod):
        sleeps = []

        def fn():
            raise ValueError("x")

        with pytest.raises(mod.RetriesExhausted):
            mod.retry_call(fn, policy=mod.RetryPolicy(max_attempts=8, base_s=0.3, max_delay_s=5.0),
                           sleeper=sleeps.append, rng=random.Random(11))
        return sleeps

    assert delays(t_retry) == delays(j_retry)


def test_oom_and_device_loss_are_permanent():
    """The predicates agree with JAX on the shared cases, and the port also
    fails fast on PyTorch's out-of-memory error."""
    cases = [MemoryError("x"), RuntimeError("RESOURCE_EXHAUSTED: y"), ValueError("z"),
             RuntimeError("DEADLINE_EXCEEDED: collective"), RuntimeError("fine")]
    for exc in cases:
        assert t_retry.default_retry_predicate(exc) == j_retry.default_retry_predicate(exc)
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
    assert t_retry.is_resource_exhausted(oom)
    calls = []

    def fn():
        calls.append(1)
        raise oom

    with pytest.raises(torch.OutOfMemoryError):
        t_retry.retry_call(fn, sleeper=lambda s: None)
    assert len(calls) == 1
