"""The port's host feature layer against the JAX package's, on the ranker test
world of ``tests/test_ranker.py`` (``synthetic_tables(n_users=300,
n_items=220, mean_stars=18, seed=31)``), on the CPU.

Profiles, the fitted feature pipeline's output frame and the assembled
``FeatureMatrix`` arrays are equal, not close: both packages run the same
pandas/numpy code on the same tables, and the pipeline's two model stages
(ALS scores, Word2Vec document vectors) are fed the same weights — a port
ALS fit and a port Word2Vec fit, carried into the JAX package's models by
``to_arrays``.
"""

import numpy as np
import pandas as pd
import pytest

import albedo_tpu.builders.profiles as jprof
import albedo_tpu.builders.ranker as jrank
import albedo_tpu.features as jfeat
from albedo_tpu.datasets import synthetic_tables as j_tables
from albedo_tpu.datasets.tables import popular_repos as j_popular
from albedo_tpu.models.als import ALSModel as JALSModel
from albedo_tpu.models.word2vec import Word2VecModel as JW2VModel
import albedo_tpu_torch.builders.profiles as tprof
import albedo_tpu_torch.builders.ranker as trank
import albedo_tpu_torch.features as tfeat
from albedo_tpu_torch.datasets import synthetic_tables as t_tables
from albedo_tpu_torch.datasets.tables import popular_repos as t_popular
from albedo_tpu_torch.models.als import ImplicitALS
from albedo_tpu_torch.models.word2vec import Word2Vec

NOW = 1.52e9


def _cells_equal(a, b) -> bool:
    if isinstance(a, (np.ndarray, list, tuple)) or isinstance(b, (np.ndarray, list, tuple)):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a) and np.isnan(b):
        return True
    return a == b or (pd.isna(a) and pd.isna(b))


def assert_frames_equal(got: pd.DataFrame, want: pd.DataFrame) -> None:
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        g, w = got[col], want[col]
        assert g.dtype == w.dtype, col
        if w.dtype == object:
            bad = [i for i, (x, y) in enumerate(zip(g, w)) if not _cells_equal(x, y)]
            assert not bad, (col, bad[:5])
        else:
            pd.testing.assert_series_equal(g.reset_index(drop=True), w.reset_index(drop=True), obj=col)


@pytest.fixture(scope="module")
def world():
    jt = j_tables(n_users=300, n_items=220, mean_stars=18, seed=31)
    tt = t_tables(n_users=300, n_items=220, mean_stars=18, seed=31)
    matrix = tt.star_matrix()
    als = ImplicitALS(rank=8, max_iter=5, reg_param=0.1, device="cpu").fit(matrix)
    j_up, j_uc = jprof.build_user_profile(jt, now=NOW)
    j_rp, j_rc = jprof.build_repo_profile(jt, now=NOW, min_stars=1, max_stars=10**9, language_bin_threshold=3)
    t_up, t_uc = tprof.build_user_profile(tt, now=NOW)
    t_rp, t_rc = tprof.build_repo_profile(tt, now=NOW, min_stars=1, max_stars=10**9, language_bin_threshold=3)
    corpus = [s.split() for s in t_rp["repo_text"]] + [s.split() for s in t_up["user_recent_repo_descriptions"]]
    w2v = Word2Vec(dim=8, min_count=3, max_iter=2, subsample=0.0, batch_size=512, device="cpu").fit_corpus(corpus)
    return {
        "jax": (jt, jt.star_matrix(policy="off"), JALSModel.from_arrays(als.to_arrays()),
                JW2VModel(vocab=list(w2v.vocab), vectors=w2v.vectors), (j_up, j_uc, j_rp, j_rc)),
        "port": (tt, matrix, als, w2v, (t_up, t_uc, t_rp, t_rc)),
    }


def test_profiles_equal(world):
    j_up, j_uc, j_rp, j_rc = world["jax"][4]
    t_up, t_uc, t_rp, t_rc = world["port"][4]
    assert_frames_equal(t_up, j_up)
    assert_frames_equal(t_rp, j_rp)
    for a, b in ((t_uc, j_uc), (t_rc, j_rc)):
        assert (a.boolean, a.continuous, a.categorical, a.list_, a.text) == (
            b.boolean, b.continuous, b.categorical, b.list_, b.text)


def _featurize(pkg, world, rank_mod, feat_mod, popular):
    tables, matrix, als, w2v, (up, uc, rp, rc) = world[pkg]
    reduced = rank_mod.reduce_starring(tables.starring, 4000)
    positives = reduced.merge(up, on="user_id").merge(rp, on="repo_id")
    pipeline, spec = rank_mod.build_feature_pipeline(rank_mod.ALSScorer(als, matrix), uc, rc, w2v, 3)
    fitted = pipeline.fit(positives)
    balancer = feat_mod.NegativeBalancer(popular(tables.repo_info, 1, 10**9)["repo_id"].to_numpy(np.int64))
    balanced = balancer.transform(reduced).merge(up, on="user_id").merge(rp, on="repo_id")
    featured = fitted.transform(balanced)
    fm = feat_mod.FeatureAssembler(**spec, max_bag_pad=256).fit(featured).assemble(
        feat_mod.InstanceWeigher(now=NOW).transform(featured)
    )
    return featured, fm


def test_feature_pipeline_frame_and_matrix_equal(world):
    j_frame, j_fm = _featurize("jax", world, jrank, jfeat, j_popular)
    t_frame, t_fm = _featurize("port", world, trank, tfeat, t_popular)
    assert_frames_equal(t_frame, j_frame)
    np.testing.assert_array_equal(t_fm.dense, j_fm.dense)
    assert t_fm.dense_names == j_fm.dense_names
    for name in ("cat", "cat_sizes", "bag_idx", "bag_val", "bag_sizes", "vec", "vec_rep", "bag_rep"):
        a, b = getattr(t_fm, name), getattr(j_fm, name)
        assert list(a) == list(b), name
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{name}:{k}")
    for (ra, ca, va), (rb, cb, vb) in zip(t_fm.flat_bags().values(), j_fm.flat_bags().values()):
        for x, y in ((ra, rb), (ca, cb), (va, vb)):
            np.testing.assert_array_equal(x, y)
    assert j_fm.vec and j_fm.bag_idx and j_fm.cat  # every block kind is exercised
