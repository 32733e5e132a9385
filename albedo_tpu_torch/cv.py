"""Hyperparameter search: param grids + k-fold cross-validation.

Port of ``albedo_tpu/cv.py`` (the package's own copy; it imports nothing of
the JAX package). Reference parity: ``ALSRecommenderCV.scala:16-102`` (2-fold
``CrossValidator`` over a rank x regParam x alpha grid, scored by
``RankingEvaluator``) and ``LogisticRegressionRankerCV.scala:326-332`` (grid
over instance-weight columns). Each (fold, params) ALS fit runs in turn (a fit
already fills the card); the ranker's weight-column grid, which refits one
shared featurized set, runs as a single batched solve instead
(``LogisticRegression.fit_many``, used by the ``cv_lr`` job). The folds are
drawn as the JAX module draws them (``numpy.random.default_rng(seed)``), so
both packages split a matrix the same way.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Sequence

import numpy as np

from albedo_tpu_torch.datasets.star_matrix import StarMatrix


def param_grid(**axes: Sequence[Any]) -> list[dict[str, Any]]:
    """``ParamGridBuilder`` parity: cartesian product of named axes."""
    names = list(axes)
    return [dict(zip(names, combo)) for combo in itertools.product(*axes.values())]


@dataclasses.dataclass
class CVResult:
    params: dict[str, Any]
    fold_metrics: list[float]

    @property
    def mean_metric(self) -> float:
        return float(np.mean(self.fold_metrics))


def k_fold_interactions(
    matrix: StarMatrix, n_folds: int, seed: int = 42
) -> list[tuple[StarMatrix, StarMatrix]]:
    """Split nonzeros into k folds (per-interaction, like Spark's
    ``CrossValidator`` row split); returns (train, test) per fold."""
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, n_folds, size=matrix.nnz)
    folds = []
    for f in range(n_folds):
        test_mask = assignment == f
        folds.append((matrix.select(~test_mask), matrix.select(test_mask)))
    return folds


def cross_validate(
    fit: Callable[[dict[str, Any], StarMatrix], Any],
    evaluate: Callable[[Any, StarMatrix, StarMatrix], float],
    matrix: StarMatrix,
    grid: list[dict[str, Any]],
    n_folds: int = 2,
    seed: int = 42,
    larger_is_better: bool = True,
    verbose: bool = False,
) -> list[CVResult]:
    """Fit every grid point on every fold; returns results sorted best-first
    (stable: equal means keep the grid's order).

    ``fit(params, train) -> model``; ``evaluate(model, train, test) -> metric``
    (train is passed so evaluators can exclude seen items).
    """
    folds = k_fold_interactions(matrix, n_folds, seed)
    results = []
    for params in grid:
        metrics = []
        for train, test in folds:
            model = fit(params, train)
            metrics.append(float(evaluate(model, train, test)))
        result = CVResult(params=params, fold_metrics=metrics)
        results.append(result)
        if verbose:
            print(f"{params} -> {result.mean_metric:.6f}")
    results.sort(key=lambda r: r.mean_metric, reverse=larger_is_better)
    return results
