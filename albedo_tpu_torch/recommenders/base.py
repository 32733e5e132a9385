"""Abstract recommender: the candidate-generation contract.

Reference parity: ``recommenders/Recommender.scala:9-68`` — every source
returns ``(user, item, score, source)`` rows for the requested users and tags
them, so a fused candidate set remembers provenance. Port of
``albedo_tpu/recommenders/base.py`` without the feature-pipeline
``Transformer`` base, which is not ported yet.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


class Recommender:
    source: str = "unknown"

    def __init__(
        self,
        user_col: str = "user_id",
        item_col: str = "repo_id",
        score_col: str = "score",
        source_col: str = "source",
        top_k: int = 15,
    ):
        self.user_col = user_col
        self.item_col = item_col
        self.score_col = score_col
        self.source_col = source_col
        self.top_k = top_k

    def recommend_for_users(self, user_ids: np.ndarray) -> pd.DataFrame:
        """Return a frame [user_col, item_col, score_col, source_col] with up
        to ``top_k`` rows per requested (raw) user id."""
        raise NotImplementedError

    def _topk_frame(
        self,
        users: np.ndarray,
        vals: np.ndarray,
        idx: np.ndarray,
        item_ids: np.ndarray,
    ) -> pd.DataFrame:
        """Flatten ``(U, k)`` top-k output into the candidate frame.

        Masks BEFORE gathering ``item_ids``: -1 sentinels and -inf pad
        entries must never reach the gather."""
        k = vals.shape[1]
        ok = (idx >= 0) & np.isfinite(vals)
        return self._frame(
            np.repeat(users, k)[ok.ravel()], item_ids[idx[ok]], vals[ok]
        )

    def _frame(
        self, users: np.ndarray, items: np.ndarray, scores: np.ndarray
    ) -> pd.DataFrame:
        return pd.DataFrame(
            {
                self.user_col: np.asarray(users, dtype=np.int64),
                self.item_col: np.asarray(items, dtype=np.int64),
                self.score_col: np.asarray(scores, dtype=np.float64),
                self.source_col: self.source,
            }
        )
