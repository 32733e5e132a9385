"""Evaluation: ranking metrics (NDCG@k, precision@k, MAP) with MLlib parity,
and the ranker's AUC."""

from albedo_tpu_torch.evaluators.classification import area_under_roc
from albedo_tpu_torch.evaluators.ranking import (
    RankingEvaluator,
    UserItems,
    ndcg_at_k,
    user_actual_items,
    user_items_from_pairs,
)

__all__ = [
    "RankingEvaluator",
    "UserItems",
    "area_under_roc",
    "ndcg_at_k",
    "user_actual_items",
    "user_items_from_pairs",
]
