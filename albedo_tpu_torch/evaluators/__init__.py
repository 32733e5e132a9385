"""Ranking evaluation (NDCG@k, precision@k, MAP) with MLlib parity."""

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
    "ndcg_at_k",
    "user_actual_items",
    "user_items_from_pairs",
]
