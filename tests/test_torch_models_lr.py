"""The port's ``LogisticRegression`` (its own L-BFGS and zoom line search)
against the JAX package's optax fit, on the same FeatureMatrix, on the CPU.

Tolerances: final loss rtol 1e-6; standardized-space coefficients (the
optimizer's variables) atol 1e-5 (float32 sums in another order: the port's
flat-vector dot products against optax's per-leaf ones); raw-space
coefficients rtol 1e-4, because folding the scales multiplies by 1/std
(~1e3 for the near-constant column) and the centering shift into the bias
by its mean (250); probabilities atol 1e-5; L-BFGS iterations within 2 of
the JAX count (a float32 rounding in another order can move one accepted
step; measured equal on these problems); AUC within 1e-4.
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
    with pytest.raises(NotImplementedError):
        LogisticRegression(device="cpu").fit_many(tfm, y, np.stack([w, w]))
