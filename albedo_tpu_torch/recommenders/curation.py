"""Curated recommendations: repos recently starred by trusted curators.

Reference parity: ``recommenders/CurationRecommender.scala:8-43`` — starrings
of five hard-coded curator user ids, grouped per repo by most recent
``starred_at``, newest first, top-k cross-joined to every user with
``score = starred_at`` epoch seconds.

Host code, copied from ``albedo_tpu/recommenders/curation.py`` with its imports pointed at
the port; the port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from albedo_tpu_torch.recommenders.base import Recommender

# vinta, saiday, tzangms, fukuball, wancw (CurationRecommender.scala:24)
CURATOR_IDS = (652070, 1912583, 59990, 646843, 28702)


class CurationRecommender(Recommender):
    source = "curation"

    def __init__(
        self,
        starring_df: pd.DataFrame,
        curator_ids: tuple[int, ...] = CURATOR_IDS,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.starring_df = starring_df
        self.curator_ids = tuple(curator_ids)

    def recommend_for_users(self, user_ids: np.ndarray) -> pd.DataFrame:
        curated = (
            self.starring_df[self.starring_df["user_id"].isin(self.curator_ids)]
            .groupby("repo_id", as_index=False)["starred_at"]
            .max()
            .sort_values("starred_at", ascending=False, kind="stable")
            .head(self.top_k)
        )
        items = curated["repo_id"].to_numpy(np.int64)
        scores = curated["starred_at"].to_numpy(np.float64)
        n_u, n_i = len(user_ids), len(items)
        return self._frame(
            np.repeat(np.asarray(user_ids, dtype=np.int64), n_i),
            np.tile(items, n_u),
            np.tile(scores, n_u),
        )
