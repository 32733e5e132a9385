"""The port's ``train_ranker`` against the JAX package's, on the ranker test
world of ``tests/test_ranker.py``, with the same ALS and Word2Vec weights
(a port fit of each, carried into the JAX package's models), on the CPU.

Everything upstream of the LR fit is identical (``tests/test_torch_features.py``),
so the two rankers differ only by the float32 round-off of the LR solve:
AUC within 1e-4, re-ranked NDCG@30 within 1e-3 (a near-tie between two
candidates' probabilities may swap them), the same L-BFGS iteration count
within 2, and the final training loss within rtol 1e-5. In CV-grid mode
(``weight_cols``, the five weight columns in one batched solve) each
column's AUC agrees within 1e-4 and the grid comes out in the same order.
"""

import numpy as np
import pytest

import albedo_tpu.builders as jb
import albedo_tpu.recommenders as jrec
from albedo_tpu.datasets import synthetic_tables as j_tables
from albedo_tpu.datasets.tables import popular_repos as j_popular
from albedo_tpu.models.als import ALSModel as JALSModel
from albedo_tpu.models.word2vec import Word2VecModel as JW2VModel
import albedo_tpu_torch.builders as tb
import albedo_tpu_torch.recommenders as trec
from albedo_tpu.features.weights import WEIGHT_COLUMNS as J_WEIGHT_COLUMNS
from albedo_tpu_torch.features.weights import WEIGHT_COLUMNS
from albedo_tpu_torch.datasets import synthetic_tables as t_tables
from albedo_tpu_torch.datasets.tables import popular_repos as t_popular
from albedo_tpu_torch.models.als import ImplicitALS
from albedo_tpu_torch.models.word2vec import Word2Vec

NOW = 1.52e9


def _train(builders, recs_mod, popular, tables, matrix, als, w2v, **kw):
    up, uc = builders.build_user_profile(tables, now=NOW)
    rp, rc = builders.build_repo_profile(tables, now=NOW, min_stars=1, max_stars=10**9, language_bin_threshold=3)
    config = builders.RankerConfig(lr_max_iter=60, popular_min_stars=1, popular_max_stars=10**9,
                                   min_df=3, test_ratio=0.2, n_test_users=60)
    recs = [
        recs_mod.ALSRecommender(als, matrix, top_k=20),
        recs_mod.CurationRecommender(
            tables.starring, curator_ids=tuple(tables.starring["user_id"].iloc[:3].tolist()), top_k=10),
        recs_mod.PopularityRecommender(popular(tables.repo_info, 1, 10**9), top_k=10),
    ]
    return builders.train_ranker(tables, up, uc, rp, rc, als, matrix, w2v, now=NOW, config=config,
                                 recommenders=recs, **kw)


@pytest.fixture(scope="module")
def world():
    tt = t_tables(n_users=300, n_items=220, mean_stars=18, seed=31)
    jt = j_tables(n_users=300, n_items=220, mean_stars=18, seed=31)
    matrix = tt.star_matrix()
    als = ImplicitALS(rank=8, max_iter=5, reg_param=0.1, device="cpu").fit(matrix)
    up, _ = tb.build_user_profile(tt, now=NOW)
    rp, _ = tb.build_repo_profile(tt, now=NOW, min_stars=1, max_stars=10**9, language_bin_threshold=3)
    corpus = [s.split() for s in rp["repo_text"]] + [s.split() for s in up["user_recent_repo_descriptions"]]
    w2v = Word2Vec(dim=8, min_count=3, max_iter=2, subsample=0.0, batch_size=512, device="cpu").fit_corpus(corpus)
    return tt, jt, matrix, als, w2v


def _both(world, **kw):
    tt, jt, matrix, als, w2v = world
    port = _train(tb, trec, t_popular, tt, matrix, als, w2v, device="cpu", **kw.get("port", {}))
    jax = _train(jb, jrec, j_popular, jt, jt.star_matrix(policy="off"),
                 JALSModel.from_arrays(als.to_arrays()), JW2VModel(vocab=list(w2v.vocab), vectors=w2v.vectors),
                 **kw.get("jax", {}))
    return port, jax


@pytest.fixture(scope="module")
def results(world):
    return _both(world)


def test_weight_grid_matches_jax(world):
    """``train_ranker(weight_cols=...)``: every column's AUC within 1e-4 of
    JAX's, the grid in JAX's order, and the best column's model carried on."""
    port, jax = _both(world, port={"weight_cols": WEIGHT_COLUMNS}, jax={"weight_cols": J_WEIGHT_COLUMNS})
    assert [c for c, _ in port.grid] == [c for c, _ in jax.grid], (port.grid, jax.grid)
    assert sorted(c for c, _ in port.grid) == sorted(WEIGHT_COLUMNS)
    for (col, a), (_, b) in zip(port.grid, jax.grid):
        assert abs(a - b) <= 1e-4, (col, a, b)
    assert port.auc == port.grid[0][1] and port.model.lr_model.n_iter_run > 2
    assert abs(port.ndcg - jax.ndcg) <= 1e-3, (port.ndcg, jax.ndcg)


def test_auc_and_ndcg_match_jax(results):
    port, jax = results
    assert port.n_rows == jax.n_rows
    assert abs(port.auc - jax.auc) <= 1e-4, (port.auc, jax.auc)
    assert abs(port.ndcg - jax.ndcg) <= 1e-3, (port.ndcg, jax.ndcg)
    assert port.auc > 0.75  # the JAX test's gate (tests/test_ranker.py)


def test_lr_solve_matches_jax(results):
    port, jax = results
    p, j = port.model.lr_model, jax.model.lr_model
    assert abs(p.n_iter_run - int(j.n_iter_run)) <= 2, (p.n_iter_run, j.n_iter_run)
    np.testing.assert_allclose(p.train_loss, j.train_loss, rtol=1e-5)


def test_ranker_model_scores_candidates(results):
    port, _ = results
    rp = port.model.repo_profile
    cands = port.model.user_profile[["user_id"]].head(3).merge(rp[["repo_id"]].head(4), how="cross")
    scored = port.model.score(cands)
    assert len(scored) == 12
    assert np.all((scored["probability"] > 0) & (scored["probability"] < 1))


def test_unported_modes_raise(results):
    port, _ = results
    for kw in ({"weight_cols": ["default_weight"], "grid_mesh": object()}, {"lr_mesh": object()}):
        with pytest.raises(NotImplementedError):
            tb.train_ranker(None, None, None, None, None, port.model, None, None, now=NOW, **kw)
