"""The port's ``ImplicitALS``/``ALSModel`` against the JAX package's, fed the
same numpy Gaussian init (torch cannot reproduce ``jax.random``).

Tolerances: Cholesky fits atol 1e-4 (measured ~1e-5: float32 round-off over
the sweeps); one CG iteration atol 1e-5; an 8-iteration CG fit by held-out
NDCG@30 within 1e-3, because unconverged 3-step CG carries round-off from
sweep to sweep and whole CG fits drift apart at the 1e-3 level."""

import numpy as np
import pytest
import torch

from albedo_tpu.datasets.ragged import padded_rows
from albedo_tpu.datasets.split import random_split_by_user, sample_test_users
from albedo_tpu.datasets.synthetic import synthetic_stars
from albedo_tpu.evaluators import RankingEvaluator as JEval
from albedo_tpu.evaluators import UserItems as JItems
from albedo_tpu.evaluators import user_actual_items as j_actual
from albedo_tpu.models.als import ImplicitALS as JALS
from albedo_tpu_torch.evaluators import RankingEvaluator, UserItems, user_actual_items
from albedo_tpu_torch.models.als import ALSModel, ImplicitALS


@pytest.fixture(scope="module")
def matrix():
    return synthetic_stars(n_users=400, n_items=300, mean_stars=20, seed=42)


def _init(m, rank, seed=7):
    rng = np.random.default_rng(seed)
    s = np.float32(1 / np.sqrt(rank))
    return (
        (rng.standard_normal((m.n_users, rank)) * s).astype(np.float32),
        (rng.standard_normal((m.n_items, rank)) * s).astype(np.float32),
    )


def _fit_both(m, rank, iters, solver="cholesky"):
    init = _init(m, rank)
    kw = dict(rank=rank, max_iter=iters, solver=solver, init_factors=init)
    jm = JALS(**kw, chunked=False).fit(m)
    est = ImplicitALS(**kw, device="cpu")
    tm = est.fit(m)
    return jm, tm, est


@pytest.mark.parametrize("rank,iters", [(16, 8), (50, 26)])
def test_cholesky_fit_matches(matrix, rank, iters):
    jm, tm, est = _fit_both(matrix, rank, iters)
    np.testing.assert_allclose(tm.user_factors, jm.user_factors, atol=1e-4)
    np.testing.assert_allclose(tm.item_factors, jm.item_factors, atol=1e-4)
    assert est.last_fit_report["health"]["nonfinite"] == 0
    assert est.last_fit_report["mode"] == "resident"


def test_cg_one_iteration_matches(matrix):
    jm, tm, _ = _fit_both(matrix, 16, 1, solver="cg")
    np.testing.assert_allclose(tm.user_factors, jm.user_factors, atol=1e-5)
    np.testing.assert_allclose(tm.item_factors, jm.item_factors, atol=1e-5)


def test_cg_fit_ndcg_matches(matrix):
    train, test = random_split_by_user(matrix, test_ratio=0.2, seed=42)
    jm, tm, _ = _fit_both(train, 16, 8, solver="cg")
    users = sample_test_users(train, n=200, seed=42)
    indptr, cols, _ = train.csr()
    excl = padded_rows(indptr, cols, users)
    _, ji = jm.recommend(users, k=30, exclude_idx=excl)
    _, ti = tm.recommend(users, k=30, exclude_idx=excl)
    j_ndcg = JEval(metric_name="ndcg@k", k=30).evaluate(JItems(users, ji.astype(np.int32)), j_actual(test, k=30))
    t_ndcg = RankingEvaluator(metric_name="ndcg@k", k=30).evaluate(
        UserItems(users, ti.astype(np.int32)), user_actual_items(test, k=30)
    )
    assert abs(t_ndcg - j_ndcg) <= 1e-3, (t_ndcg, j_ndcg)


def test_from_jax_arrays_recommends_the_same(matrix):
    rng = np.random.default_rng(3)
    arrays = {
        "user_factors": rng.standard_normal((matrix.n_users, 8)).astype(np.float32),
        "item_factors": rng.standard_normal((matrix.n_items, 8)).astype(np.float32),
        "rank": np.int64(8),
    }
    from albedo_tpu.models.als import ALSModel as JModel

    jm = JModel.from_arrays(arrays)
    tm = ALSModel.from_arrays(jm.to_arrays(), device="cpu")
    users = np.array([0, 7, 99, 398])
    indptr, cols, _ = matrix.csr()
    excl = padded_rows(indptr, cols, users)
    jv, ji = jm.recommend(users, k=30, exclude_idx=excl)
    tv, ti = tm.recommend(users, k=30, exclude_idx=excl)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tm.to_arrays()["item_factors"], arrays["item_factors"])
    np.testing.assert_allclose(tm.predict([1, 2], [3, 4]), jm.predict([1, 2], [3, 4]), rtol=1e-6)
    with pytest.raises(IndexError):
        tm.recommend(np.array([matrix.n_users]))


def test_seeded_fit_callback_and_unported_options():
    seen = []
    matrix = synthetic_stars(n_users=60, n_items=40, mean_stars=6, seed=9)
    est = ImplicitALS(rank=8, max_iter=3, device="cpu")
    model = est.fit(matrix, callback=lambda it, uf, vf: seen.append((it, uf.shape, vf.shape)))
    assert seen == [(i, (matrix.n_users, 8), (matrix.n_items, 8)) for i in range(3)]
    again = ImplicitALS(rank=8, max_iter=3, device="cpu").fit(matrix)
    np.testing.assert_array_equal(model.user_factors, again.user_factors)  # seeded
    assert est.last_fit_report["prep_cached"] is False  # first fit on this matrix
    for bad in (dict(gather_dtype="bfloat16"), dict(mesh=object()), dict(chunked=True)):
        with pytest.raises(NotImplementedError):
            ImplicitALS(rank=8, max_iter=1, device="cpu", **bad).fit(matrix)
    assert isinstance(model.user_table, torch.Tensor)
