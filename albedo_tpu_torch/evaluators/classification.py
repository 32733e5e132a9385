"""Binary classification metrics for the ranking stage.

Reference: ``BinaryClassificationEvaluator`` scoring ``areaUnderROC`` on the
LR ranker's held-out split (``LogisticRegressionRanker.scala:354-364``,
expected 0.9425, BASELINE.md).

Host code, copied from ``albedo_tpu/evaluators/classification.py`` with its imports pointed at
the port; the port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

import numpy as np


def area_under_roc(
    labels: np.ndarray, scores: np.ndarray, weights: np.ndarray | None = None
) -> float:
    """Exact AUC via the rank statistic with average ranks on ties.

    Argument order follows sklearn's ``roc_auc_score(y_true, y_score)``.
    Equivalent to the trapezoidal area under the ROC curve with score-grouped
    thresholds (what Spark's evaluator computes), including optional instance
    weights. Returns nan when only one class is present.
    """
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels, dtype=np.float64)
    w = np.ones_like(scores) if weights is None else np.asarray(weights, np.float64)

    order = np.argsort(scores, kind="stable")
    s, y, w = scores[order], labels[order] > 0.5, w[order]

    # Average rank within tied score groups, weighted: rank of a group is the
    # cumulative weight before it plus half the group's weight.
    _, group_idx, group_counts = np.unique(s, return_inverse=True, return_counts=True)
    group_w = np.zeros(group_counts.shape[0])
    np.add.at(group_w, group_idx, w)
    cum_before = np.concatenate([[0.0], np.cumsum(group_w)[:-1]])
    avg_rank = cum_before[group_idx] + 0.5 * group_w[group_idx]

    w_pos = w[y].sum()
    w_neg = w[~y].sum()
    if w_pos == 0 or w_neg == 0:
        return float("nan")
    # Sum over positives of the (weighted) count of negatives ranked below,
    # with ties counting half — derived from the average-rank statistic.
    u = (w[y] * avg_rank[y]).sum() - 0.5 * w_pos * w_pos
    return float(u / (w_pos * w_neg))
