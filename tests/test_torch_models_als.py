"""The port's ``ImplicitALS``/``ALSModel`` against the JAX package's, fed the
same numpy Gaussian init (torch cannot reproduce ``jax.random``).

Tolerances: Cholesky fits atol 1e-4 (measured ~1e-5: float32 round-off over
the sweeps); one CG iteration atol 1e-5; an 8-iteration CG fit by held-out
NDCG@30 within 1e-3, because unconverged 3-step CG carries round-off from
sweep to sweep and whole CG fits drift apart at the 1e-3 level.

Under bf16 gathers (``gather_dtype="bfloat16"``) a float32 round-off
difference in a factor can flip its bf16 rounding at the next half-sweep (a
2^-9 relative step), so two correct bf16 fits part at the 1e-3 level after
their first half-sweep. The first half-sweep reads the shared init and is
held at atol 1e-5 (Cholesky; measured 8e-7); whole fits by held-out NDCG@30
within 3e-3, about twice the largest move from float32 to bf16 gathers
measured within either package over four inits (1.4e-3; port against JAX
at bf16 up to 1.7e-3). JAX's compiled CG on the CPU also keeps the Jacobi
diagonal's ``y * y`` in float32 (XLA may use excess precision there), where
the port rounds it as the program is written, so a bf16 CG fit is held by
NDCG@30 only."""

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


BF16_NDCG_TOL = 3e-3


def _fit_both(m, rank, iters, solver="cholesky", gather_dtype=None):
    init = _init(m, rank)
    kw = dict(rank=rank, max_iter=iters, solver=solver, init_factors=init, gather_dtype=gather_dtype)
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


def _heldout_ndcg(matrix, solver, gather_dtype=None) -> tuple[float, float]:
    """(port, JAX) held-out NDCG@30 of an 8-iteration rank-16 fit of each
    package from the shared init."""
    train, test = random_split_by_user(matrix, test_ratio=0.2, seed=42)
    jm, tm, _ = _fit_both(train, 16, 8, solver=solver, gather_dtype=gather_dtype)
    users = sample_test_users(train, n=200, seed=42)
    indptr, cols, _ = train.csr()
    excl = padded_rows(indptr, cols, users)
    _, ji = jm.recommend(users, k=30, exclude_idx=excl)
    _, ti = tm.recommend(users, k=30, exclude_idx=excl)
    j_ndcg = JEval(metric_name="ndcg@k", k=30).evaluate(JItems(users, ji.astype(np.int32)), j_actual(test, k=30))
    t_ndcg = RankingEvaluator(metric_name="ndcg@k", k=30).evaluate(
        UserItems(users, ti.astype(np.int32)), user_actual_items(test, k=30)
    )
    return t_ndcg, j_ndcg


def test_cg_fit_ndcg_matches(matrix):
    t_ndcg, j_ndcg = _heldout_ndcg(matrix, "cg")
    assert abs(t_ndcg - j_ndcg) <= 1e-3, (t_ndcg, j_ndcg)


@pytest.mark.parametrize("solver", ["cholesky", "cg"])
def test_bf16_fit_matches(matrix, solver):
    """bf16 gathers against the JAX ``ImplicitALS(gather_dtype="bfloat16")``
    from the shared init: the first half-sweep's factors (Cholesky) and the
    held-out NDCG@30 of an 8-iteration fit (both solvers)."""
    if solver == "cholesky":
        jm, tm, est = _fit_both(matrix, 16, 1, gather_dtype="bfloat16")
        np.testing.assert_allclose(tm.item_factors, jm.item_factors, atol=1e-5)
        assert est.last_fit_report["gather_dtype"] == "bfloat16"
        assert tm.user_table.dtype == torch.float32
    t_ndcg, j_ndcg = _heldout_ndcg(matrix, solver, "bfloat16")
    assert abs(t_ndcg - j_ndcg) <= BF16_NDCG_TOL, (t_ndcg, j_ndcg)


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


@pytest.mark.parametrize("solver", ["cholesky", "cg"])
def test_bf16_gather_fit_quality(solver):
    """``tests/test_als.py``'s criteria for bf16 gathers, on the port: against
    the port's float32 fit from the same seed, the objective within 1% and
    a prediction correlation above 0.995."""
    from albedo_tpu_torch.ops.als import implicit_loss

    m = synthetic_stars(n_users=120, n_items=80, mean_stars=8, seed=11)
    kw = dict(rank=8, reg_param=0.5, alpha=10.0, max_iter=10, seed=1, solver=solver, device="cpu")
    f32 = ImplicitALS(**kw).fit(m)
    bf16 = ImplicitALS(**kw, gather_dtype="bfloat16").fit(m)

    def loss(model):
        return float(implicit_loss(model.user_table, model.item_table, *(torch.as_tensor(a) for a in
                                   (m.rows, m.cols, m.vals)), reg=0.5, alpha=10.0))

    assert loss(bf16) <= loss(f32) * 1.01, (loss(bf16), loss(f32))
    corr = float(np.corrcoef(f32.predict(m.rows, m.cols), bf16.predict(m.rows, m.cols))[0, 1])
    assert corr > 0.995, corr


def test_seeded_fit_callback_and_unported_options():
    seen = []
    matrix = synthetic_stars(n_users=60, n_items=40, mean_stars=6, seed=9)
    est = ImplicitALS(rank=8, max_iter=3, device="cpu")
    model = est.fit(matrix, callback=lambda it, uf, vf: seen.append((it, uf.shape, vf.shape)))
    assert seen == [(i, (matrix.n_users, 8), (matrix.n_items, 8)) for i in range(3)]
    again = ImplicitALS(rank=8, max_iter=3, device="cpu").fit(matrix)
    np.testing.assert_array_equal(model.user_factors, again.user_factors)  # seeded
    assert est.last_fit_report["prep_cached"] is False  # first fit on this matrix
    for bad in (dict(mesh=object()), dict(chunked=True)):
        with pytest.raises(NotImplementedError):
            ImplicitALS(rank=8, max_iter=1, device="cpu", **bad).fit(matrix)
    with pytest.raises(ValueError, match="gather_dtype"):
        ImplicitALS(rank=8, max_iter=1, device="cpu", gather_dtype="float16").fit(matrix)
    for solver in ("cholesky", "cg"):  # bf16 gathers run, with either solver
        bf16 = ImplicitALS(rank=8, max_iter=1, device="cpu", solver=solver, gather_dtype="bfloat16")
        assert np.isfinite(bf16.fit(matrix).user_factors).all()
        assert bf16.last_fit_report["gather_dtype"] == "bfloat16"
    assert isinstance(model.user_table, torch.Tensor)
