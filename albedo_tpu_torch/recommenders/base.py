"""Abstract recommender: the candidate-generation contract.

Reference parity: ``recommenders/Recommender.scala:9-68`` — a Transformer
whose ``transform`` delegates to ``recommendForUsers(userDF)``; every source
returns ``(user, item, score, source)`` rows for the requested users and tags
them, so a fused candidate set remembers provenance. Port of
``albedo_tpu/recommenders/base.py``.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from albedo_tpu_torch.features.pipeline import Transformer


class Recommender(Transformer):
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

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        self.require_cols(df, [self.user_col])
        return self.recommend_for_users(df[self.user_col].to_numpy(np.int64))

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


def recent_starred_provider(
    starring_df: pd.DataFrame, top_k: int = 30, offset: int = 0
):
    """A user's most recent stars, newest first — the query shape every
    More-Like-This source uses (the content recommender, the tf-idf
    candidate source). ``offset`` is the evaluation-mode window shift (query
    with the NEXT ``top_k`` stars so candidates aren't the held-out query
    items, ``ContentRecommender.scala:44-46``)."""
    s = starring_df.sort_values("starred_at", ascending=False, kind="stable")
    per_user = {
        int(uid): grp.to_numpy(np.int64)
        for uid, grp in s.groupby("user_id", sort=False)["repo_id"]
    }

    def recent_items(user_id: int) -> np.ndarray:
        repos = per_user.get(int(user_id))
        if repos is None:
            return np.zeros(0, dtype=np.int64)
        return repos[offset : offset + top_k]

    return recent_items


def fuse_candidates(frames: list[pd.DataFrame], user_col: str = "user_id", item_col: str = "repo_id") -> pd.DataFrame:
    """Union candidate sets and drop duplicate (user, item) pairs, keeping the
    first source's row — the ranker's ``map(recommendForUsers).reduce(union)
    .distinct`` fusion (``LogisticRegressionRanker.scala:397-404``)."""
    out = pd.concat(frames, ignore_index=True)
    return out.drop_duplicates([user_col, item_col], keep="first").reset_index(drop=True)
