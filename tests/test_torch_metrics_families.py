"""The `/metrics` families of a fresh registry in each package: the port
exposes every family the JAX package exposes for a module the port has, and
no family of its own. Each JAX family still missing is named here with the
module that will bring it (``ROADMAP.md`` queue 1); a family that appears
must leave this list, and a missing one not on it fails the test."""

import re

from albedo_tpu.serving.metrics import MetricsRegistry as JaxRegistry
from albedo_tpu_torch.serving.metrics import MetricsRegistry as PortRegistry

# family -> the JAX module not ported yet that registers or bumps it
NOT_PORTED = {
    "albedo_aot_fingerprint_mismatches_total": "utils/aot.py",
    "albedo_artifact_corruptions_total": "datasets/artifacts.py",
    "albedo_capacity_verdicts_total": "utils/capacity.py",
    "albedo_checkpoint_fallbacks_total": "utils/checkpoint.py",
    "albedo_data_violations_total": "datasets/validate.py",
    "albedo_drift_refits_total": "streaming/drift.py",
    "albedo_elastic_resumes_total": "parallel/elastic.py",
    "albedo_foldin_users_total": "streaming/foldin.py",
    "albedo_lockcheck_violations_total": "analysis/locksmith.py",
    "albedo_mesh_degraded_total": "parallel/mesh.py",
    "albedo_mesh_losses_total": "parallel/elastic.py",
    "albedo_publish_rejected_total": "builders/pipeline.py",
    "albedo_retrieval_fallbacks_total": "retrieval/stage.py",
    "albedo_retrieval_promotions_total": "retrieval/stage.py",
    "albedo_score_publish_rejected_total": "scoring/sweep.py",
    "albedo_score_shards_total": "scoring/sweep.py",
    "albedo_score_users_total": "scoring/sweep.py",
    "albedo_stream_deltas_total": "streaming/deltas.py",
    "albedo_stream_publishes_total": "streaming/job.py",
}

# Families of ported modules that the port's registry once lacked.
ONCE_MISSING = ("albedo_stage_seconds", "albedo_stage_calls", "albedo_watchdog_trips_total",
                   "albedo_retry_attempts_total")


def _families(registry) -> dict[str, str]:
    return dict(re.findall(r"^# TYPE (\S+) (\S+)$", registry.render(), re.M))


def test_port_exposes_every_family_of_its_ported_modules():
    jax, port = _families(JaxRegistry()), _families(PortRegistry())
    assert set(port) - set(jax) == set()
    assert set(jax) - set(port) == set(NOT_PORTED)
    assert {name: port[name] for name in port} == {name: jax[name] for name in port}  # same kinds
    for name in ONCE_MISSING:
        assert name in port


def test_observe_timer_and_cache_hit_rate_match_jax():
    from albedo_tpu.utils.profiling import Timer as JaxTimer
    from albedo_tpu_torch.utils.profiling import Timer as PortTimer

    pages = []
    for registry, timer in ((JaxRegistry(), JaxTimer()), (PortRegistry(), PortTimer())):
        for name in ("stage1_candidates", "stage2_rank", "stage1_candidates"):
            with timer.section(name):
                pass
        timer.totals = {k: 0.25 for k in timer.totals}  # fixed values to compare pages
        registry.observe_timer(timer)
        registry.cache_hits.inc(3)
        registry.cache_misses.inc()
        assert registry.cache_hit_rate() == 0.75
        pages.append([line for line in registry.render().splitlines() if "albedo_stage_" in line])
    assert pages[0] == pages[1]
