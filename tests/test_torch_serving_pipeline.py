"""The port's two-stage pipeline against the JAX package's, on the CPU.

Both packages build ``serve --two-stage`` at ``--small`` as the job does
(popularity and curation beside the ALS source, the LR ranker trained in
process), once per module, from the same inputs: one numpy ALS init and
numpy Word2Vec vectors (as ``jax_reference_ndcg.py two_stage --shared``), so
the L-BFGS solves from zeros differ only by float32 round-off. Held against
JAX's direct ``TwoStagePipeline.recommend`` (no batching):

- each source's candidates: the same repos in the same order, ALS scores
  within 1e-5 of the largest, popularity and curation exactly;
- the fused list: exactly;
- the LR probabilities of the fused candidates: within PROB_TOL = 1e-4
  (float32 round-off of two L-BFGS runs from zeros);
- the served lists: the same repos, ordered alike up to near-ties;
- the degrade matrix (ranker error, timeout and empty answer, a failing
  source, cold artifacts, brownout levels 1-3): the same stage, tags and
  items.

The port's batched service (ALS source through the micro-batcher) must
answer byte for byte as its direct one.
"""

import time

import numpy as np
import pandas as pd
import pytest

import albedo_tpu.builders.jobs as j_jobs
import albedo_tpu.models.als as j_als
import albedo_tpu.models.word2vec as j_w2v
import albedo_tpu_torch.builders.jobs as t_jobs
import albedo_tpu_torch.models.als as t_als
import albedo_tpu_torch.models.word2vec as t_w2v
from albedo_tpu import settings as j_settings
from albedo_tpu.datasets.tables import popular_repos as j_popular
from albedo_tpu.recommenders import CurationRecommender as JCuration
from albedo_tpu.recommenders import PopularityRecommender as JPopularity
from albedo_tpu.serving import RecommendationService as JService
from albedo_tpu.serving import StageDeadlines as JDeadlines
from albedo_tpu.utils import faults as j_faults
from albedo_tpu_torch.datasets.tables import popular_repos as t_popular
from albedo_tpu_torch.recommenders import CurationRecommender as TCuration
from albedo_tpu_torch.recommenders import PopularityRecommender as TPopularity
from albedo_tpu_torch.serving import RecommendationService as TService
from albedo_tpu_torch.serving import StageDeadlines as TDeadlines
from albedo_tpu_torch.utils import faults as t_faults

PROB_TOL = 1e-4
ALS_TOL = 1e-5
LONG = (60.0, 60.0)  # stage deadlines no CPU run reaches


def _shared_init(n_users, n_items, rank):
    rng = np.random.default_rng(1)
    s = np.float32(1 / np.sqrt(rank))
    return ((rng.standard_normal((n_users, rank)) * s).astype(np.float32),
            (rng.standard_normal((n_items, rank)) * s).astype(np.float32))


def _share(mp, als_mod, w2v_mod):
    """Every ALS fit of ``als_mod`` starts from the shared init; every
    Word2Vec fit returns numpy vectors over its vocabulary."""
    fit = als_mod.ImplicitALS.fit

    def als_fit(self, matrix, *a, **k):
        self.init_factors = _shared_init(matrix.n_users, matrix.n_items, self.rank)
        return fit(self, matrix, *a, **k)

    def w2v_fit(self, sentences):
        counts = pd.Series([w for s in sentences for w in s]).value_counts()
        vocab = sorted((w for w, c in counts.items() if c >= self.min_count), key=lambda w: (-counts[w], w))
        vectors = np.random.default_rng(1).normal(scale=0.3, size=(len(vocab), self.dim)).astype(np.float32)
        return w2v_mod.Word2VecModel(vocab=vocab, vectors=vectors, input_col=self.input_col,
                                     output_col=self.output_col or f"{self.input_col}__w2v")

    mp.setattr(als_mod.ImplicitALS, "fit", als_fit)
    mp.setattr(w2v_mod.Word2Vec, "fit_corpus", w2v_fit)


def _build(jobs, popular, popularity, curation):
    import argparse

    ns = argparse.Namespace(small=True, now=1600000000.0, w2v_full=False, data_policy="off",
                            no_compilation_cache=True, device="cpu")
    ctx = jobs.JobContext(ns)
    lo, hi = ctx.star_range()
    curators = ctx.curators()
    recs = {
        "popularity": popularity(popular(ctx.tables().repo_info, lo, hi), top_k=30),
        "curation": curation(ctx.tables().starring, **({"curator_ids": curators} if curators else {}),
                             top_k=30),
    }
    return ctx, recs, ctx.ranker_model()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ALBEDO_DATA_DIR", str(tmp_path_factory.mktemp("albedo-data")))
        j_settings.reset_settings()
        _share(mp, j_als, j_w2v)
        _share(mp, t_als, t_w2v)
        jctx, jrecs, jranker = _build(j_jobs, j_popular, JPopularity, JCuration)
        tctx, trecs, tranker = _build(t_jobs, t_popular, TPopularity, TCuration)
        jmodel, tmodel = jctx.als_model(), tctx.als_model()
    j_settings.reset_settings()
    users = tctx.matrix().user_ids[tctx.test_user_dense(40)]
    return {"j": (jctx, jrecs, jranker, jmodel), "t": (tctx, trecs, tranker, tmodel), "users": users}


def _jax_service(world, **kw):
    jctx, jrecs, jranker, jmodel = world["j"]
    kw.setdefault("deadlines", JDeadlines(*LONG))
    kw.setdefault("ranker", jranker)
    return JService(jmodel, jctx.matrix(), repo_info=jctx.tables().repo_info, recommenders=jrecs,
                    batching=False, **kw)


def _port_service(world, batching=False, **kw):
    tctx, trecs, tranker, tmodel = world["t"]
    kw.setdefault("deadlines", TDeadlines(*LONG))
    kw.setdefault("ranker", tranker)
    return TService(tmodel, tctx.matrix(), repo_info=tctx.tables().repo_info, recommenders=trecs,
                    batching=batching, batch_window_ms=1.0, **kw)


def _same_frame(t, j, score_tol):
    assert list(t["repo_id"]) == list(j["repo_id"])
    assert list(t["source"]) == list(j["source"])
    scale = max(1.0, float(np.abs(j["score"]).max())) if len(j) else 1.0
    np.testing.assert_allclose(t["score"].to_numpy(np.float64), j["score"].to_numpy(np.float64),
                               rtol=0, atol=score_tol * scale)


def _same_items(t_items, j_items, tol):
    """The same repos with scores within ``tol``, in the same order up to
    swaps of items whose scores are within ``tol``."""
    assert sorted(i["repo_id"] for i in t_items) == sorted(i["repo_id"] for i in j_items)
    want = {i["repo_id"]: i for i in j_items}
    for pos, item in enumerate(t_items):
        ref = want[item["repo_id"]]
        assert abs(item["score"] - ref["score"]) <= tol, (item, ref)
        assert item["source"] == ref["source"]
        other = j_items[pos]
        assert abs(other["score"] - item["score"]) <= 2 * tol, (pos, item, other)


def test_models_and_ranker_inputs_match(world):
    jctx, _, _, jmodel = world["j"]
    tctx, _, _, tmodel = world["t"]
    np.testing.assert_array_equal(tctx.matrix().user_ids, jctx.matrix().user_ids)
    np.testing.assert_allclose(tmodel.user_factors, np.asarray(jmodel.user_factors), atol=1e-4)


def test_candidates_match_jax(world):
    with _jax_service(world) as js, _port_service(world) as ts:
        for uid in world["users"][:10]:
            jd, td = [], []
            jf = js.pipeline.candidates(int(uid), jd, extra_sources={"als": js.generation.als_source})
            tf = ts.pipeline.candidates(int(uid), td, extra_sources={"als": ts.generation.als_source})
            assert jd == td == [] and set(tf) == set(jf) == {"als", "popularity", "curation"}
            for name in jf:
                _same_frame(tf[name].reset_index(drop=True), jf[name].reset_index(drop=True),
                            ALS_TOL if name == "als" else 0.0)


def test_fused_candidates_and_probabilities_match_jax(world):
    from albedo_tpu.recommenders.base import fuse_candidates as j_fuse
    from albedo_tpu_torch.recommenders.base import fuse_candidates as t_fuse

    _, _, jranker, _ = world["j"]
    _, _, tranker, _ = world["t"]
    with _jax_service(world) as js, _port_service(world) as ts:
        for uid in world["users"][:6]:
            jf = js.pipeline.candidates(int(uid), [], extra_sources={"als": js.generation.als_source})
            tf = ts.pipeline.candidates(int(uid), [], extra_sources={"als": ts.generation.als_source})
            order = ts.pipeline._source_order([n for n in tf if len(tf[n])])
            j_fused = j_fuse([jf[n] for n in order]).reset_index(drop=True)
            t_fused = t_fuse([tf[n] for n in order]).reset_index(drop=True)
            _same_frame(t_fused, j_fused, ALS_TOL)
            jp = jranker.score(j_fused).sort_values("repo_id")["probability"].to_numpy(np.float64)
            tp = tranker.score(t_fused).sort_values("repo_id")["probability"].to_numpy(np.float64)
            np.testing.assert_allclose(tp, jp, rtol=0, atol=PROB_TOL)


def test_served_two_stage_lists_match_jax(world):
    with _jax_service(world) as js, _port_service(world) as ts:
        for uid in world["users"][:12]:
            js_status, jb = js.handle_recommend(int(uid), k=30)
            ts_status, tb = ts.handle_recommend(int(uid), k=30)
            assert js_status == ts_status == 200
            assert tb["stage"] == jb["stage"] == "two_stage" and tb["degraded"] == jb["degraded"] == []
            assert set(tb) == set(jb)
            assert all(set(i) == {"repo_id", "score", "source", "repo_full_name"} for i in tb["items"])
            _same_items(tb["items"], jb["items"], PROB_TOL)


def test_batched_two_stage_equals_direct(world):
    """The ALS source through the micro-batcher answers as the direct one."""
    with _port_service(world) as direct, _port_service(world, batching=True) as batched:
        assert batched.generation.batcher is not None
        for uid in world["users"][:8]:
            assert batched.handle_recommend(int(uid), k=30) == direct.handle_recommend(int(uid), k=30)


def _slow_ranker(ranker):
    class Slow:
        def score(self, candidates):
            time.sleep(0.5)
            return ranker.score(candidates)

    return Slow()


class _EmptyRanker:
    def score(self, candidates):
        return candidates.iloc[:0].assign(probability=np.zeros(0, np.float32))


# (case, service overrides per package, fault site, brownout level)
DEGRADE = {
    "ranker_error": ({}, "serving.rank", 0),
    "ranker_timeout": ({"deadlines": (5.0, 0.05), "ranker": _slow_ranker}, None, 0),
    "ranker_empty": ({"ranker": lambda r: _EmptyRanker()}, None, 0),
    "candidate_error_curation": ({}, "serving.source.curation", 0),
    "brownout_1": ({}, None, 1),
    "brownout_2": ({}, None, 2),
    "brownout_3": ({}, None, 3),
}


def _degraded(world, package, case):
    over, site, level = DEGRADE[case]
    kw = {}
    if "deadlines" in over:
        kw["deadlines"] = (JDeadlines if package == "j" else TDeadlines)(*over["deadlines"])
    if "ranker" in over:
        kw["ranker"] = over["ranker"](world[package][2])
    make = _jax_service if package == "j" else _port_service
    faults = j_faults if package == "j" else t_faults
    uid = int(world["users"][0])
    with make(world, **kw) as svc:
        if site is not None:
            faults.arm(site, kind="error", at=1, times=0)
        try:
            out = svc.pipeline.recommend(uid, 10, exclude_seen=True,
                                         extra_sources={"als": svc.generation.als_source},
                                         brownout_level=level)
        finally:
            faults.reset()
        return out, svc.metrics


@pytest.mark.parametrize("case", sorted(DEGRADE))
def test_degrade_matrix_matches_jax(world, case):
    jo, _ = _degraded(world, "j", case)
    to, metrics = _degraded(world, "t", case)
    assert to["stage"] == jo["stage"] and to["degraded"] == jo["degraded"]
    assert {k: v for k, v in to.items() if k != "items"} == {k: v for k, v in jo.items() if k != "items"}
    _same_items(to["items"], jo["items"], PROB_TOL if to["stage"] == "two_stage" else ALS_TOL)
    for reason in to["degraded"]:
        assert metrics.degraded.value(reason=reason) >= 1


def test_cold_artifacts_serve_popularity_as_jax(world):
    jctx, jrecs, _, _ = world["j"]
    tctx, trecs, _, _ = world["t"]
    uid = int(world["users"][1])
    with JService(None, jctx.matrix(), recommenders=jrecs) as js, \
            TService(None, tctx.matrix(), recommenders=trecs) as ts:
        js_status, jb = js.handle_recommend(uid, k=10)
        ts_status, tb = ts.handle_recommend(uid, k=10)
        assert js_status == ts_status == 200
        assert tb["degraded"][0] == jb["degraded"][0] == "cold_artifacts"
        assert tb == jb
        ready, report = ts.readiness()
        assert not ready and report["model_loaded"] is False
        assert ts.metrics.degraded.value(reason="cold_artifacts") == 1


def test_stage_gauges_split_the_request(world):
    with _port_service(world, batching=True) as ts:
        for uid in world["users"][:3]:
            ts.handle_recommend(int(uid), k=30)
        ts.metrics.observe_timer(ts.pipeline.timer)
        text = ts.metrics.render()
    for stage in ("stage1_candidates", "stage2_rank", "fuse", "source_als", "source_popularity",
                  "source_curation"):
        assert f'albedo_stage_calls{{stage="{stage}"}} 3' in text
        assert f'albedo_stage_seconds{{stage="{stage}"}}' in text


def test_serve_two_stage_without_a_card_fails(monkeypatch):
    import torch

    from albedo_tpu_torch.cli import main as torch_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_main(["serve", "--small", "--two-stage", "--duration", "1"])


@pytest.mark.parametrize("flag", ["--bank", "--reload-watch", "--reload-require-stamp"])
def test_serve_flags_not_ported_exit_2(flag, capsys):
    from albedo_tpu_torch.cli import main as torch_main

    with pytest.raises(SystemExit) as exc:
        torch_main(["serve", "--small", "--device", "cpu", "--two-stage", flag])
    assert exc.value.code == 2
    assert "not ported yet" in capsys.readouterr().err
