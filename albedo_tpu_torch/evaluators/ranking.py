"""Ranking metrics with Spark-MLlib parity, on torch tensors.

Reference: ``evaluators/RankingEvaluator.scala:83-103`` feeds per-user
``(predictedItems, actualItems)`` pairs — both sliced to the first ``k`` — into
``mllib.RankingMetrics`` and returns the mean metric over the users present in
*both* frames (inner join on user). The metric definitions replicated here are
MLlib's:

- ``ndcgAt(k)``: binary gains, ``n = min(max(|pred|, |actual|), k)``; ideal DCG
  sums the first ``min(|actual|, n)`` gain terms; users with no actuals score 0
  and still count toward the mean.
- ``precisionAt(k)``: hits within the first ``min(|pred|, k)`` divided by ``k``
  (not by ``|pred|``).
- ``meanAveragePrecision``: sum of precision-at-each-hit over the full (here:
  pre-sliced) prediction list, divided by ``|actual|``.

Port of ``albedo_tpu/evaluators/ranking.py``. Users are rows of fixed-width
``-1``-padded index arrays; :func:`_ranking_metrics` (K13) is plain float32
torch over them, on the CPU: the lists are small host arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from albedo_tpu_torch.datasets.star_matrix import StarMatrix


@dataclasses.dataclass(frozen=True)
class UserItems:
    """Per-user item lists in padded-array form.

    ``users[q]`` is a dense user index; ``items[q]`` its item list, ``-1`` on
    padding. Order within a row is rank order (best first).
    """

    users: np.ndarray  # (Q,) int32
    items: np.ndarray  # (Q, W) int32, -1 padded

    def __post_init__(self) -> None:
        assert self.items.ndim == 2 and self.users.ndim == 1
        assert self.items.shape[0] == self.users.shape[0]
        if np.unique(self.users).shape[0] != self.users.shape[0]:
            raise ValueError("UserItems.users must be unique (one row per user)")

    def sliced(self, k: int) -> "UserItems":
        """First-k slice (the ``.slice(0, k)`` in ``RankingEvaluator.scala:96-97``)."""
        return UserItems(self.users, self.items[:, :k])


def _pad_lists(lists: list[np.ndarray], width: int | None = None) -> np.ndarray:
    w = width if width is not None else max((len(x) for x in lists), default=0)
    w = max(w, 1)
    out = np.full((len(lists), w), -1, dtype=np.int32)
    for i, x in enumerate(lists):
        out[i, : len(x)] = x[:w]
    return out


def user_items_from_pairs(
    users: np.ndarray,
    items: np.ndarray,
    order_key: np.ndarray | None = None,
    k: int | None = None,
) -> UserItems:
    """Group flat (user, item) pairs into per-user rank-ordered lists.

    Parity with ``intoUserActualItems`` / ``intoUserPredictedItems``
    (``RankingEvaluator.scala:121-143``): rank within each user by
    ``order_key`` DESCENDING (e.g. score, or starred_at), keep the top ``k``.
    Ties broken by input order (the reference's ``rank()`` keeps ties
    nondeterministically; stable sort here makes tests reproducible). NaN
    scores — a diverged model's output — rank LAST deterministically
    (negated NaN would otherwise sort ahead of every real score and shuffle
    with the platform's NaN ordering), which the canary publish gate relies
    on: garbage scores must depress NDCG, not inflate it.
    """
    users = np.asarray(users)
    items = np.asarray(items, dtype=np.int32)
    if order_key is None:
        order_key = -np.arange(users.shape[0], dtype=np.float64)  # input order
    key = np.asarray(order_key, dtype=np.float64)
    key = np.where(np.isnan(key), -np.inf, key)
    order = np.lexsort((-key, users))
    u_sorted = users[order]
    uniq, starts = np.unique(u_sorted, return_index=True)
    bounds = np.append(starts[1:], u_sorted.shape[0])
    lists = [
        items[order[lo : (hi if k is None else min(hi, lo + k))]]
        for lo, hi in zip(starts, bounds)
    ]
    return UserItems(uniq.astype(np.int32), _pad_lists(lists, width=k))


def user_actual_items(
    matrix: StarMatrix, k: int, order_key: np.ndarray | None = None
) -> UserItems:
    """Held-out positives per user, most recent first, top ``k``.

    Parity: ``RankingEvaluator.loadUserActualItemsDF`` orders by
    ``starred_at desc`` (``RankingEvaluator.scala:111-119``); ``order_key``
    is the per-nonzero recency key (defaults to insertion order).
    """
    if order_key is None:
        order_key = np.arange(matrix.nnz, dtype=np.float64)
    return user_items_from_pairs(matrix.rows, matrix.cols, order_key=order_key, k=k)


# --- metric kernels (padded arrays, plain torch) ---------------------------


def _ranking_metrics(pred: torch.Tensor, actual: torch.Tensor, k: int) -> dict[str, torch.Tensor]:
    """All three MLlib metrics per query; inputs already sliced to k."""
    hits = ((pred[:, :, None] == actual[:, None, :]) & (pred[:, :, None] >= 0)).any(-1)
    pred_len = (pred >= 0).sum(dim=1)
    lab_size = (actual >= 0).sum(dim=1)

    kp = pred.shape[1]
    pos = torch.arange(max(kp, actual.shape[1]), dtype=torch.float32)
    gains = 1.0 / torch.log(pos + 2.0)

    # NDCG: n = min(max(|pred|, |actual|), k); pads never hit so the dcg sum
    # over all slots equals the sum over i < n.
    dcg = (hits * gains[:kp]).sum(dim=1)
    n = torch.clamp(torch.maximum(pred_len, lab_size), max=k)
    ideal_terms = torch.minimum(lab_size, n)
    max_dcg = torch.where(pos[None, :] < ideal_terms[:, None], gains[None, :], 0.0).sum(dim=1)
    ndcg = torch.where(lab_size > 0, dcg / torch.clamp(max_dcg, min=1e-12), 0.0)

    # Precision@k: hits in the first min(|pred|, k) slots, over k.
    prec = torch.where(pos[None, :kp] < k, hits, False).sum(dim=1) / k

    # MAP over the (pre-sliced) prediction list.
    cum_hits = torch.cumsum(hits, dim=1)
    prec_at_hit = torch.where(hits, cum_hits / (pos[None, :kp] + 1.0), 0.0).sum(dim=1)
    ap = torch.where(lab_size > 0, prec_at_hit / torch.clamp(lab_size, min=1), 0.0)

    return {"ndcg": ndcg, "precision": prec, "map": ap}


def _metrics(pred: np.ndarray, actual: np.ndarray, k: int) -> dict[str, torch.Tensor]:
    return _ranking_metrics(
        torch.as_tensor(np.asarray(pred[:, :k], dtype=np.int32)),
        torch.as_tensor(np.asarray(actual[:, :k], dtype=np.int32)),
        k,
    )


def ndcg_at_k(pred: np.ndarray, actual: np.ndarray, k: int) -> float:
    """Mean NDCG@k over queries; ``pred``/``actual`` are -1-padded index arrays."""
    return float(_metrics(pred, actual, k)["ndcg"].mean())


@dataclasses.dataclass
class RankingEvaluator:
    """Mean ranking metric over users present in both predicted and actual.

    Parity: ``RankingEvaluator.scala:14-103``. ``metric_name`` one of
    ``"ndcg@k"`` (default), ``"precision@k"``, ``"map"``; ``k`` defaults to 15
    as the reference does (builders set 30).
    """

    metric_name: str = "ndcg@k"
    k: int = 15

    @property
    def formatted_metric_name(self) -> str:
        return self.metric_name.replace("@k", f"@{self.k}")

    def evaluate(self, predicted: UserItems, actual: UserItems) -> float:
        common, pi, ai = np.intersect1d(
            predicted.users, actual.users, assume_unique=True, return_indices=True
        )
        if common.shape[0] == 0:
            raise ValueError("no users in common between predicted and actual")
        m = _metrics(predicted.items[pi], actual.items[ai], self.k)
        key = {"ndcg@k": "ndcg", "precision@k": "precision", "map": "map"}[self.metric_name]
        return float(m[key].mean())
