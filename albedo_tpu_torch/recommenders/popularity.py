"""Global popularity baseline.

Reference parity: ``recommenders/PopularityRecommender.scala:8-37`` — top-k of
the popular-repo view cross-joined to every requested user with
``score = round(log10(stars) * 1000) / 1000 + (created_epoch_s / (60*60*24*30*12)) / 5``
(value score + slow time decay favoring newer repos).

Host code, copied from ``albedo_tpu/recommenders/popularity.py`` with its imports pointed at
the port; the port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from albedo_tpu_torch.recommenders.base import Recommender


def popularity_score(stars: np.ndarray, created_at: np.ndarray) -> np.ndarray:
    value = np.round(np.log10(np.maximum(stars, 1)) * 1000.0) / 1000.0
    time = created_at / (60 * 60 * 24 * 30 * 12) / 5.0
    return value + time


class PopularityRecommender(Recommender):
    source = "popularity"

    def __init__(self, popular_repo_df: pd.DataFrame, **kwargs):
        """``popular_repo_df``: the ``popular_repos`` view (repo_id,
        repo_stargazers_count, repo_created_at), stars-descending."""
        super().__init__(**kwargs)
        self.popular_repo_df = popular_repo_df

    def recommend_for_users(self, user_ids: np.ndarray) -> pd.DataFrame:
        top = self.popular_repo_df.head(self.top_k)
        items = top["repo_id"].to_numpy(np.int64)
        scores = popularity_score(
            top["repo_stargazers_count"].to_numpy(np.float64),
            top["repo_created_at"].to_numpy(np.float64),
        )
        n_u, n_i = len(user_ids), len(items)
        return self._frame(
            np.repeat(np.asarray(user_ids, dtype=np.int64), n_i),
            np.tile(items, n_u),
            np.tile(scores, n_u),
        )
