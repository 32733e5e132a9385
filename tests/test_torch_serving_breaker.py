"""The port's circuit breakers against the JAX package's: the state-machine
tests of ``tests/test_serving_breaker.py`` run on both packages' breakers;
the integration tests (an open breaker skips its source, the half-open trial
recovers or reopens it, breakers off, readiness, the drill over HTTP) run on
the port's service on the CPU, driven through the port's fault sites."""

import json
import random
import urllib.request

import pytest

import albedo_tpu.serving.breaker as j_breaker
import albedo_tpu.utils.retry as j_retry
import albedo_tpu_torch.serving.breaker as t_breaker
import albedo_tpu_torch.utils.retry as t_retry
from albedo_tpu_torch.datasets import synthetic_tables
from albedo_tpu_torch.datasets.tables import popular_repos
from albedo_tpu_torch.models.als import ImplicitALS
from albedo_tpu_torch.recommenders import PopularityRecommender
from albedo_tpu_torch.serving import RecommendationService, serve
from albedo_tpu_torch.utils import events, faults


@pytest.fixture(autouse=True)
def _reset_port_faults():
    """The suite's conftest resets the JAX package's registry; this file
    drives the port's."""
    faults.reset()
    events.reset_global_metrics()
    yield
    faults.reset()
    events.reset_global_metrics()


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    mods = (j_breaker, j_retry) if request.param == "jax" else (t_breaker, t_retry)
    return mods[0].CircuitBreaker, mods[0].BreakerConfig, mods[1].RetryPolicy


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def _config(threshold=2, base=10.0, BreakerConfig=t_breaker.BreakerConfig, RetryPolicy=t_retry.RetryPolicy):
    return BreakerConfig(
        failure_threshold=threshold,
        reopen=RetryPolicy(base_s=base, multiplier=2.0, max_delay_s=60.0, jitter=False),
    )


# --- unit: the state machine -------------------------------------------------


def test_breaker_trips_after_consecutive_failures(pkg):
    CircuitBreaker, BreakerConfig, RetryPolicy = pkg
    clock = FakeClock()
    br = CircuitBreaker("src", _config(threshold=3, BreakerConfig=BreakerConfig, RetryPolicy=RetryPolicy), clock=clock)
    assert br.state == "closed"
    br.record_failure()
    br.record_failure()
    assert br.state == "closed" and br.allow()
    # A success in between resets the consecutive count.
    br.record_success()
    br.record_failure()
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()  # third consecutive: trip
    assert br.state == "open"
    assert not br.allow()
    assert br.snapshot()["reopen_in_s"] == pytest.approx(10.0)


def test_breaker_half_open_single_trial_then_close(pkg):
    CircuitBreaker, BreakerConfig, RetryPolicy = pkg
    clock = FakeClock()
    br = CircuitBreaker("src", _config(threshold=1, BreakerConfig=BreakerConfig, RetryPolicy=RetryPolicy), clock=clock)
    br.record_failure()
    assert br.state == "open" and not br.allow()
    clock.now += 10.0  # reopen timer expires
    assert br.allow()  # the ONE half-open trial
    assert br.state == "half_open"
    assert not br.allow()  # concurrent callers are still denied
    br.record_success()
    assert br.state == "closed" and br.allow()


def test_breaker_failed_trial_reopens_with_backoff(pkg):
    CircuitBreaker, BreakerConfig, RetryPolicy = pkg
    clock = FakeClock()
    br = CircuitBreaker("src", _config(threshold=1, base=10.0, BreakerConfig=BreakerConfig, RetryPolicy=RetryPolicy), clock=clock)
    br.record_failure()              # trip 1: reopen after 10s
    clock.now += 10.0
    assert br.allow()
    br.record_failure()              # failed trial -> trip 2: 20s
    assert br.state == "open"
    assert br.snapshot()["reopen_in_s"] == pytest.approx(20.0)
    clock.now += 19.0
    assert not br.allow()
    clock.now += 1.0
    assert br.allow()
    br.record_success()              # recovered: schedule resets
    br.record_failure()
    assert br.snapshot()["reopen_in_s"] == pytest.approx(10.0)


def test_breaker_ignores_late_zombie_results_while_open(pkg):
    CircuitBreaker, BreakerConfig, RetryPolicy = pkg
    """A timed-out call finishing in its zombie thread after the trip must
    not flip the breaker state."""
    clock = FakeClock()
    br = CircuitBreaker("src", _config(threshold=1, BreakerConfig=BreakerConfig, RetryPolicy=RetryPolicy), clock=clock)
    br.record_failure()
    assert br.state == "open"
    br.record_success()   # zombie success
    assert br.state == "open"
    br.record_failure()   # zombie failure: no double-trip either
    assert br.snapshot()["total_trips"] == 1


def test_abandon_trial_releases_the_half_open_slot(pkg):
    CircuitBreaker, BreakerConfig, RetryPolicy = pkg
    """An aborted call (hot-swap retirement mid-request) records no outcome;
    abandoning must free the trial slot or every later caller is denied."""
    clock = FakeClock()
    br = CircuitBreaker("src", _config(threshold=1, BreakerConfig=BreakerConfig, RetryPolicy=RetryPolicy), clock=clock)
    br.record_failure()
    clock.now += 10.0
    assert br.allow()          # trial admitted...
    br.abandon_trial()         # ...but the call was abandoned, not judged
    assert br.state == "half_open"
    assert br.allow()          # next caller gets the trial instead
    br.record_success()
    assert br.state == "closed"


def test_breaker_transition_callback_and_config_validation(pkg):
    CircuitBreaker, BreakerConfig, RetryPolicy = pkg
    seen = []
    br = CircuitBreaker(
        "src", _config(threshold=1, BreakerConfig=BreakerConfig, RetryPolicy=RetryPolicy),
        clock=FakeClock(), on_transition=lambda n, s: seen.append((n, s)),
    )
    br.record_failure()
    assert seen == [("src", "open")]
    with pytest.raises(ValueError):
        BreakerConfig(failure_threshold=0)


def test_breaker_equal_jitter_reopen_bounds(pkg):
    CircuitBreaker, BreakerConfig, RetryPolicy = pkg
    cfg = BreakerConfig(
        failure_threshold=1,
        reopen=RetryPolicy(base_s=8.0, multiplier=2.0, max_delay_s=60.0, jitter=True),
    )
    import random

    rng = random.Random(7)
    delays = [cfg.reopen_delay(1, rng) for _ in range(200)]
    assert all(4.0 <= d <= 8.0 for d in delays)  # equal jitter: [cap/2, cap]
    assert min(delays) < 5.0 < max(delays)       # actually jittered
    caps = [cfg.reopen_delay(t, rng) for t in range(1, 12)]
    assert max(caps) <= 60.0                     # schedule honors the cap


# --- integration: pipeline + service -----------------------------------------


@pytest.fixture(scope="module")
def artifacts():
    tables = synthetic_tables(n_users=80, n_items=50, mean_stars=6, seed=11)
    matrix = tables.star_matrix(policy="off")
    model = ImplicitALS(rank=8, max_iter=2, seed=0, device="cpu").fit(matrix)
    pop = PopularityRecommender(popular_repos(tables.repo_info, 1, 10**9), top_k=20)
    return tables, matrix, model, pop


def _service(artifacts, **kw):
    tables, matrix, model, pop = artifacts
    kw.setdefault("batch_window_ms", 0.0)
    kw.setdefault("breaker_config", _config(threshold=2))
    return RecommendationService(
        model, matrix, repo_info=tables.repo_info,
        recommenders={"popularity": pop}, **kw,
    )


def test_open_breaker_skips_source_instead_of_calling(artifacts):
    _, matrix, _, _ = artifacts
    with _service(artifacts) as svc:
        uid = int(matrix.user_ids[0])
        faults.arm("serving.source.popularity", kind="error", at=1, times=2)
        for i in range(2):
            status, body = svc.handle_recommend(uid, k=5)
            assert status == 200
            assert "candidate_error_popularity" in body["degraded"]
        br = svc.pipeline.breakers["popularity"]
        assert br.state == "open"

        hits_before = faults.FAULTS.hits("serving.source.popularity")
        status, body = svc.handle_recommend(uid, k=5)
        assert status == 200
        assert "breaker_open_popularity" in body["degraded"]
        assert body["items"]  # ALS still answers
        # The source was NOT called: no new hits on its fault site.
        assert faults.FAULTS.hits("serving.source.popularity") == hits_before
        assert svc.metrics.degraded.value(reason="breaker_open_popularity") == 1
        assert svc.metrics.breaker_state.value(source="popularity") == 2


def test_half_open_trial_recovers_the_source(artifacts):
    _, matrix, _, _ = artifacts
    with _service(artifacts) as svc:
        uid = int(matrix.user_ids[1])
        faults.arm("serving.source.popularity", kind="error", at=1, times=2)
        for _ in range(2):
            svc.handle_recommend(uid, k=5)
        br = svc.pipeline.breakers["popularity"]
        assert br.state == "open"

        # Force the reopen timer to expire (deterministic, no sleeping).
        with br._lock:
            br._reopen_at = 0.0
        status, body = svc.handle_recommend(uid, k=5)
        assert status == 200
        # The fault is exhausted (times=2), so the trial call succeeds and
        # the breaker closes; popularity is back in the fusion.
        assert "breaker_open_popularity" not in body["degraded"]
        assert br.state == "closed"
        assert svc.metrics.breaker_transitions.value(source="popularity", to="closed") == 1


def test_failed_trial_reopens(artifacts):
    _, matrix, _, _ = artifacts
    with _service(artifacts) as svc:
        uid = int(matrix.user_ids[2])
        faults.arm("serving.source.popularity", kind="error", at=1, times=0)  # forever
        for _ in range(2):
            svc.handle_recommend(uid, k=5)
        br = svc.pipeline.breakers["popularity"]
        assert br.state == "open"
        with br._lock:
            br._reopen_at = 0.0
        svc.handle_recommend(uid, k=5)  # trial fails (fault still armed)
        assert br.state == "open"
        assert br.snapshot()["total_trips"] == 2


def test_breakers_disabled_keeps_prior_behavior(artifacts):
    _, matrix, _, _ = artifacts
    with _service(artifacts, breakers_enabled=False, breaker_config=None) as svc:
        uid = int(matrix.user_ids[3])
        faults.arm("serving.source.popularity", kind="error", at=1, times=0)
        for _ in range(4):
            status, body = svc.handle_recommend(uid, k=5)
            assert status == 200
            assert "candidate_error_popularity" in body["degraded"]
        assert svc.pipeline.breakers == {}


def test_readiness_reports_breaker_states(artifacts):
    _, matrix, _, _ = artifacts
    with _service(artifacts) as svc:
        uid = int(matrix.user_ids[4])
        svc.handle_recommend(uid, k=5)
        ready, report = svc.readiness()
        assert ready
        assert report["breakers"]["popularity"]["state"] == "closed"
        assert report["breakers"]["als"]["state"] == "closed"


# --- chaos drill over HTTP ---------------------------------------------------


def _get_json(handle, path):
    host, port = handle.server_address[:2]
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=30) as r:
        return json.loads(r.read().decode())


@pytest.mark.chaos
def test_breaker_trip_and_recovery_drill_over_http(artifacts):
    """Acceptance: the serving.breaker.<source> site trips the ALS breaker
    through real HTTP; requests degrade to the surviving sources; the
    half-open trial recovers it; every phase is visible on /metrics."""
    _, matrix, _, _ = artifacts
    with _service(artifacts) as svc:
        with serve(svc, port=0) as handle:
            uid = int(matrix.user_ids[5])
            # Trip the ALS stage at the breaker boundary: 2 failures.
            faults.arm("serving.breaker.als", kind="error", at=1, times=2)
            for _ in range(2):
                body = _get_json(handle, f"/recommend/{uid}?k=5")
                assert "candidate_error_als" in body["degraded"]
                assert body["items"]  # popularity still answers

            body = _get_json(handle, f"/recommend/{uid}?k=5")
            assert "breaker_open_als" in body["degraded"]
            assert all(i["source"] == "popularity" for i in body["items"])

            host, port = handle.server_address[:2]
            with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=30) as r:
                text = r.read().decode()
            assert 'albedo_breaker_state{source="als"} 2' in text
            assert 'albedo_breaker_transitions_total{source="als",to="open"} 1' in text
            assert 'albedo_faults_fired_total{site="serving.breaker.als"} 2' in text

            # Recovery: expire the reopen timer; the half-open trial runs
            # against the now-healthy source and closes the breaker.
            br = svc.pipeline.breakers["als"]
            with br._lock:
                br._reopen_at = 0.0
            body = _get_json(handle, f"/recommend/{uid}?k=5")
            assert "breaker_open_als" not in body["degraded"]
            assert any(i["source"] == "als" for i in body["items"])
            assert br.state == "closed"
            ready, report = svc.readiness()
            assert report["breakers"]["als"]["state"] == "closed"
            with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=30) as r:
                text = r.read().decode()
            assert 'albedo_breaker_state{source="als"} 0' in text
