"""The port's model selection (``albedo_tpu_torch/cv.py`` and the ``cv_als``
and ``cv_lr`` jobs) against the JAX package's, on the CPU.

``param_grid`` and ``k_fold_interactions`` are host code: equal.
``cross_validate`` over ALS fits that start from one injected numpy init in
both packages: each fold's NDCG@30 within 1e-6 (the fits differ by float32
round-off only; measured equal on this matrix) and the same ranking of the
grid. The ``cv_als --small`` jobs, with that init injected into every fit
of both: the same grid order and each mean NDCG@30 within 1e-3 (a near-tie
in a top-30 list may swap two items). Seeded runs cannot share
``jax.random``'s draws; the full-size seeded job is held to the JAX seed
spread on the card (``chip_smoke.py``).
"""

import re

import numpy as np
import pytest

import albedo_tpu.cv as jcv
import albedo_tpu.models.als as jax_als_mod
from albedo_tpu.cli import main as jax_main
from albedo_tpu.datasets import sample_test_users as j_sample
from albedo_tpu.datasets.synthetic import synthetic_stars as j_stars
from albedo_tpu.evaluators import RankingEvaluator as JEval
from albedo_tpu.evaluators import user_actual_items as j_actual
from albedo_tpu.evaluators import user_items_from_pairs as j_pairs
from albedo_tpu.models.als import ImplicitALS as JALS
from albedo_tpu.recommenders import ALSRecommender as JRec
import albedo_tpu_torch.cv as tcv
from albedo_tpu_torch.builders import jobs as torch_jobs
from albedo_tpu_torch.cli import main as torch_main
from albedo_tpu_torch.datasets.synthetic import synthetic_stars as t_stars
from albedo_tpu_torch.models.als import ImplicitALS as TALS

NOW = "1600000000"


def test_param_grid_matches_jax():
    axes = dict(rank=[50, 100], reg_param=[0.01, 0.5], alpha=[0.01, 40.0])
    assert tcv.param_grid(**axes) == jcv.param_grid(**axes)
    assert tcv.param_grid() == jcv.param_grid() == [{}]


@pytest.mark.parametrize("n_folds,seed", [(2, 42), (3, 7)])
def test_k_fold_interactions_match_jax(n_folds, seed):
    jm, tm = j_stars(n_users=80, n_items=60, mean_stars=6, seed=3), t_stars(n_users=80, n_items=60, mean_stars=6, seed=3)
    jf, tf = jcv.k_fold_interactions(jm, n_folds, seed), tcv.k_fold_interactions(tm, n_folds, seed)
    assert len(jf) == len(tf) == n_folds
    for (jtr, jte), (ttr, tte) in zip(jf, tf):
        for j, t in ((jtr, ttr), (jte, tte)):
            for name in ("rows", "cols", "vals", "user_ids", "item_ids"):
                np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
        assert ttr.nnz + tte.nnz == tm.nnz


def _init(n_users, n_items, rank):
    rng = np.random.default_rng(1)
    s = np.float32(1 / np.sqrt(rank))
    return ((rng.standard_normal((n_users, rank)) * s).astype(np.float32),
            (rng.standard_normal((n_items, rank)) * s).astype(np.float32))


def _jax_fold_ndcg(model, train, test):
    """The JAX ``cv_als`` job's fold metric (its ``evaluate`` closure)."""
    users = j_sample(test, n=150)
    frame = JRec(model, train, top_k=30).recommend_for_users(train.user_ids[users])
    predicted = j_pairs(train.users_of(frame["user_id"].to_numpy(np.int64)),
                        train.items_of(frame["repo_id"].to_numpy(np.int64)),
                        order_key=frame["score"].to_numpy(np.float64), k=30)
    return JEval(metric_name="ndcg@k", k=30).evaluate(predicted, j_actual(test, k=30))


def test_cross_validate_with_injected_inits_matches_jax():
    grid = jcv.param_grid(rank=[4, 8], reg_param=[0.1], alpha=[1.0, 40.0])
    kw = dict(n_users=300, n_items=150, mean_stars=8, seed=5)

    def jfit(params, train):
        return JALS(max_iter=4, init_factors=_init(train.n_users, train.n_items, params["rank"]), **params).fit(train)

    def tfit(params, train):
        return TALS(max_iter=4, init_factors=_init(train.n_users, train.n_items, params["rank"]), device="cpu",
                    **params).fit(train)

    want = jcv.cross_validate(jfit, _jax_fold_ndcg, j_stars(**kw), grid, n_folds=2)
    got = tcv.cross_validate(tfit, torch_jobs.cv_als_evaluate, t_stars(**kw), grid, n_folds=2)
    assert [r.params for r in got] == [r.params for r in want]
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.fold_metrics, j.fold_metrics, rtol=0, atol=1e-6, err_msg=str(t.params))
        assert 0.0 < t.mean_metric <= 1.0


def _shared(cls):
    """``cls`` with every fit starting from :func:`_init` at its own rank."""

    class Injected(cls):
        def fit(self, matrix, *a, **k):
            self.init_factors = _init(matrix.n_users, matrix.n_items, self.rank)
            return super().fit(matrix, *a, **k)

    return Injected


def _grid_lines(text: str) -> list[tuple[str, float]]:
    return [(p, float(v)) for p, v in re.findall(r"^(\{.*\}) -> (\S+)$", text, flags=re.M)]


def test_cv_als_small_job_matches_jax_grid_order(capsys, monkeypatch):
    monkeypatch.setattr(torch_jobs, "ImplicitALS", _shared(torch_jobs.ImplicitALS))
    monkeypatch.setattr(jax_als_mod, "ImplicitALS", _shared(jax_als_mod.ImplicitALS))
    argv = ["cv_als", "--small", "--now", NOW]
    assert torch_main(argv + ["--device", "cpu"]) == 0
    t = capsys.readouterr().out
    assert jax_main(argv + ["--data-policy", "off"]) == 0
    j = capsys.readouterr().out
    tl, jl = _grid_lines(t), _grid_lines(j)
    assert len(tl) == len(jl) == 8
    t_sorted = sorted(tl, key=lambda pv: -pv[1])
    j_sorted = sorted(jl, key=lambda pv: -pv[1])
    assert [p for p, _ in t_sorted] == [p for p, _ in j_sorted], (t_sorted, j_sorted)
    for (p, a), (_, b) in zip(tl, jl):
        assert abs(a - b) <= 1e-3, (p, a, b)
    best = re.compile(r"\[cv_als\] best params = (.*)")
    assert best.search(t).group(1) == best.search(j).group(1)


def test_cv_lr_small_job_runs_on_cpu(capsys):
    assert torch_main(["cv_lr", "--small", "--device", "cpu", "--now", NOW]) == 0
    out = capsys.readouterr().out
    grid = re.findall(r"\[cv_lr\] (\S+) -> AUC (\S+)", out)
    assert len(grid) == 5
    aucs = [float(a) for _, a in grid]
    assert aucs == sorted(aucs, reverse=True) and 0.5 < aucs[0] <= 1.0
    assert re.search(r"\[cv_lr\] best weight column = " + re.escape(grid[0][0]), out)
    assert re.search(r"\[cv_lr\] AUC = 0\.\d+", out)


@pytest.mark.parametrize("job", ["cv_als", "cv_lr"])
def test_cv_jobs_without_a_card_fail(monkeypatch, job):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_main([job, "--small"])
