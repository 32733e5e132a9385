"""ALS top-k retrieval recommender.

Reference parity: ``recommenders/ALSRecommender.scala:16-66`` — score the
requested users against every item and keep a bounded top-k per user. Here
that is the K5 kernel behind ``ALSModel.recommend``. Port of
``albedo_tpu/recommenders/als.py`` without the mesh (item-sharded) branch.

Unknown users (no factor row — the model never saw them) get no rows, matching
the inner join on userFactors (:34).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from albedo_tpu_torch.datasets.ragged import padded_rows
from albedo_tpu_torch.datasets.star_matrix import StarMatrix
from albedo_tpu_torch.models.als import ALSModel
from albedo_tpu_torch.recommenders.base import Recommender


class ALSRecommender(Recommender):
    source = "als"

    def __init__(
        self,
        model: ALSModel,
        matrix: StarMatrix,
        exclude_seen: bool = False,
        item_block: int = 4096,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.model = model
        self.matrix = matrix  # owns the raw-id <-> dense-index maps
        self.exclude_seen = exclude_seen
        self.item_block = item_block

    def recommend_for_users(self, user_ids: np.ndarray) -> pd.DataFrame:
        dense = self.matrix.users_of(user_ids)
        known = dense >= 0
        users = np.asarray(user_ids, dtype=np.int64)[known]
        rows = dense[known]
        if rows.size == 0:
            return self._frame(np.zeros(0), np.zeros(0), np.zeros(0))

        excl = None
        if self.exclude_seen:
            indptr, cols, _ = self.matrix.csr()
            excl = padded_rows(indptr, cols, rows)

        vals, idx = self.model.recommend(
            rows, k=self.top_k, exclude_idx=excl, item_block=self.item_block
        )
        return self._topk_frame(users, vals, idx, self.matrix.item_ids)
