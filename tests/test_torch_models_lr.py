"""The port's ``LogisticRegression`` (its own L-BFGS and zoom line search)
against the JAX package's optax fit, on the same FeatureMatrix, on the CPU.

Tolerances: final loss rtol 1e-6; standardized-space coefficients (the
optimizer's variables) atol 1e-5 (float32 sums in another order: the port's
flat-vector dot products against optax's per-leaf ones); raw-space
coefficients rtol 1e-4, because folding the scales multiplies by 1/std
(~1e3 for the near-constant column) and the centering shift into the bias
by its mean (250); probabilities atol 1e-5; L-BFGS iterations within 2 of
the JAX count (a float32 rounding in another order can move one accepted
step; measured equal on these problems); AUC within 1e-4. ``fit_many`` (the
CV weight grid, one batched solve) is held row by row at the same bands
against JAX's vmapped ``fit_many`` and the port's own sequential ``fit``.
"""

import numpy as np
import pytest

from albedo_tpu.evaluators import area_under_roc
from albedo_tpu.features.assembler import FeatureMatrix as JFM
from albedo_tpu.models.logistic_regression import LogisticRegression as JLR
from albedo_tpu_torch.features.assembler import FeatureMatrix as TFM
from albedo_tpu_torch.models.logistic_regression import LogisticRegression, LogisticRegressionModel


def _problem(seed, n=800, factored=False):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(n, 3)).astype(np.float32)
    dense[:, 0] = 250.0 + rng.normal(size=n).astype(np.float32) * 1e-3  # near-constant, large
    bag_idx = rng.integers(0, 6, size=(n, 3)).astype(np.int32)
    bag_idx[rng.random((n, 3)) < 0.4] = -1
    bag_val = np.where(bag_idx >= 0, rng.integers(1, 3, size=(n, 3)), 0).astype(np.float32)
    kw = dict(
        dense=dense, dense_names=["d0", "d1", "d2"],
        cat={"c": rng.integers(0, 4, size=n).astype(np.int32)}, cat_sizes={"c": 4},
        bag_idx={"b": bag_idx}, bag_val={"b": bag_val}, bag_sizes={"b": 6},
    )
    if factored:
        kw["vec"] = {"v": rng.normal(size=(12, 5)).astype(np.float32)}
        kw["vec_rep"] = {"v": rng.integers(0, 12, size=n).astype(np.int32)}
        kw["dense_names"] = kw["dense_names"] + [f"v[{i}]" for i in range(5)]
    jfm = JFM(**kw)
    true_w = rng.normal(size=jfm.num_features)
    true_w[0] = 0.0
    x = jfm.to_dense()
    logits = x @ true_w
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(logits - logits.mean())))).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    return jfm, TFM(**kw), y, w


@pytest.mark.parametrize("seed,reg,factored", [(0, 0.1, False), (0, 0.7, False), (1, 0.7, True)])
def test_fit_matches_jax(seed, reg, factored):
    jfm, tfm, y, w = _problem(seed, factored=factored)
    mj = JLR(max_iter=200, reg_param=reg).fit(jfm, y, w)
    mt = LogisticRegression(max_iter=200, reg_param=reg, device="cpu").fit(tfm, y, w)
    np.testing.assert_allclose(mt.train_loss, mj.train_loss, rtol=1e-6)
    assert abs(mt.n_iter_run - mj.n_iter_run) <= 2, (mt.n_iter_run, mj.n_iter_run)
    for k in mj.params:
        np.testing.assert_allclose(mt.params[k], np.asarray(mj.params[k]), atol=1e-5, err_msg=k)
    cj, ct = mj.coefficients, mt.coefficients
    for k in cj:
        np.testing.assert_allclose(ct[k], np.asarray(cj[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    auc_j = area_under_roc(y, mj.predict_proba(jfm))
    auc_t = area_under_roc(y, mt.predict_proba(tfm))
    assert abs(auc_t - auc_j) <= 1e-4


def test_max_iter_caps_the_steps():
    jfm, tfm, y, w = _problem(2)
    mj = JLR(max_iter=3, reg_param=0.7).fit(jfm, y, w)
    mt = LogisticRegression(max_iter=3, reg_param=0.7, device="cpu").fit(tfm, y, w)
    assert mt.n_iter_run == mj.n_iter_run == 3
    np.testing.assert_allclose(mt.train_loss, mj.train_loss, rtol=1e-6)


def test_from_arrays_scores_like_the_jax_model():
    jfm, tfm, y, w = _problem(3)
    mj = JLR(max_iter=50, reg_param=0.7).fit(jfm, y, w)
    mt = LogisticRegressionModel.from_arrays(
        {k: np.asarray(v) for k, v in mj.params.items()}, mj.scales, mj.center, device="cpu"
    )
    np.testing.assert_allclose(mt.predict_proba(tfm), mj.predict_proba(jfm), atol=1e-5)


def test_unported_options_raise():
    _, tfm, y, w = _problem(4, n=50)
    with pytest.raises(NotImplementedError):
        LogisticRegression(solver="adam", device="cpu").fit(tfm, y, w)
    with pytest.raises(NotImplementedError):
        LogisticRegression(mesh=object(), device="cpu").fit(tfm, y, w)
    with pytest.raises(NotImplementedError, match="grid_mesh"):
        LogisticRegression(device="cpu").fit_many(tfm, y, np.stack([w, w]), grid_mesh=object())


def _grid_weights(y, w, seed):
    """Five weight rows that converge at different speeds: the problem's
    weights, other uniform weights, a random half of the rows, four rows
    only, and one row alone (its fit stops after 2 steps, long before the
    others)."""
    rng = np.random.default_rng(seed)
    n = len(y)
    return np.stack([
        w,
        rng.uniform(0.1, 2.0, size=n),
        np.where(rng.random(n) < 0.5, w, 0.0),
        np.where(np.arange(n) < 4, 1.0, 0.0),
        np.eye(1, n, 7)[0],
    ]).astype(np.float32)


@pytest.mark.parametrize("seed,factored", [(0, False), (1, True)])
def test_fit_many_rows_match_jax_and_sequential_fits(seed, factored):
    jfm, tfm, y, w = _problem(seed, n=500, factored=factored)
    ws = _grid_weights(y, w, seed)
    mj = JLR(max_iter=100, reg_param=0.7).fit_many(jfm, y, ws)
    mt = LogisticRegression(max_iter=100, reg_param=0.7, device="cpu").fit_many(tfm, y, ws)
    seq = [LogisticRegression(max_iter=100, reg_param=0.7, device="cpu").fit(tfm, y, row) for row in ws]
    steps = [m.n_iter_run for m in mt]
    assert steps[-1] == 2 and min(steps[:-1]) > 5, steps  # the lone row stops early
    assert len({m.prep_s for m in mt}) == 1 and len({m.run_s for m in mt}) == 1
    for g, (t, j, s) in enumerate(zip(mt, mj, seq)):
        for ref in (j, s):
            np.testing.assert_allclose(t.train_loss, float(ref.train_loss), rtol=1e-6, err_msg=str(g))
            assert abs(t.n_iter_run - int(ref.n_iter_run)) <= 2, (g, t.n_iter_run, ref.n_iter_run)
            for k in t.params:
                np.testing.assert_allclose(t.params[k], np.asarray(ref.params[k]), atol=1e-5, err_msg=f"{g} {k}")


def test_fit_many_rejects_what_jax_rejects():
    _, tfm, y, w = _problem(4, n=50)
    with pytest.raises(ValueError, match="lbfgs"):
        LogisticRegression(solver="adam", device="cpu").fit_many(tfm, y, np.stack([w]))
    with pytest.raises(ValueError, match="grid_mesh"):
        LogisticRegression(mesh=object(), device="cpu").fit_many(tfm, y, np.stack([w]))
    with pytest.raises(ValueError, match="at least one grid row"):
        LogisticRegression(device="cpu").fit_many(tfm, y, np.zeros((0, len(w)), np.float32))
