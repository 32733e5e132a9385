"""Negative sampling for the ranker: popular-minus-positives per user.

Reference parity: ``transformers/NegativeBalancer.scala:13-119`` — per user,
take the (popularity-ordered) popular-item set minus the user's positives,
emit the first ``negativePositiveRatio * n_positives`` of them with label
``negativeValue`` and the sentinel timestamp 1999-07-01 (:107), then union with
the positives. The LinkedHashSet preserves popularity order, so negatives are
deterministically the most popular items the user has NOT starred — same here
(SURVEY.md §7 hard part (f)).

The RDD ``aggregateByKey`` over a broadcast set becomes one vectorized numpy
pass on the host.

Host code, copied from ``albedo_tpu/features/balancer.py`` with its imports pointed at
the port; the port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from albedo_tpu_torch.datasets.ragged import segment_positions
from albedo_tpu_torch.features.pipeline import Transformer

# 1999-07-01T00:00:00Z, the reference's sentinel (NegativeBalancer.scala:107).
SENTINEL_TIME = 930787200.0


class NegativeBalancer(Transformer):
    def __init__(
        self,
        popular_items: np.ndarray,
        user_col: str = "user_id",
        item_col: str = "repo_id",
        time_col: str = "starred_at",
        label_col: str = "starring",
        negative_value: float = 0.0,
        negative_positive_ratio: float = 1.0,
    ):
        # Popularity-ordered (most popular first), like the broadcast
        # LinkedHashSet built from loadPopularRepoDF (LogisticRegressionRanker.scala:250-255).
        self.popular_items = np.asarray(popular_items, dtype=np.int64)
        self.user_col = user_col
        self.item_col = item_col
        self.time_col = time_col
        self.label_col = label_col
        self.negative_value = negative_value
        self.negative_positive_ratio = negative_positive_ratio

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        self.require_cols(df, [self.user_col, self.item_col, self.time_col, self.label_col])
        users = df[self.user_col].to_numpy(np.int64)
        items = df[self.item_col].to_numpy(np.int64)
        neg_users, neg_items = self.sample_negatives(users, items)
        negative = pd.DataFrame(
            {
                self.user_col: neg_users,
                self.item_col: neg_items,
                self.time_col: np.full(len(neg_items), SENTINEL_TIME),
                self.label_col: np.full(len(neg_items), self.negative_value),
            }
        )
        out_df = pd.concat(
            [df[[self.user_col, self.item_col, self.time_col, self.label_col]], negative],
            ignore_index=True,
        )
        return out_df

    def sample_negatives(
        self, users: np.ndarray, items: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Per user: the first ``ratio * n_positives`` popularity-ordered items
        the user has NOT starred, fully vectorized.

        The round-1 implementation walked the popularity list per user in
        Python (O(users x popular) with per-item casts — VERDICT.md weak #4).
        Here the walk is replaced by the classic "j-th missing index" formula:
        with a user's positive popularity-ranks sorted as p_0 < p_1 < ... and
        g_i = p_i - i, the j-th non-positive index is f(j) = j + |{i: g_i <= j}|,
        computed for all users at once with one composite-key searchsorted.
        """
        pop = self.popular_items
        n_pop = pop.size
        if users.size == 0 or n_pop == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)

        # Distinct (user, item) pairs, user-major (the reference aggregates
        # positives into a per-user set first).
        order = np.lexsort((items, users))
        du, di = users[order], items[order]
        first = np.ones(du.size, dtype=bool)
        first[1:] = (du[1:] != du[:-1]) | (di[1:] != di[:-1])
        du, di = du[first], di[first]

        # Popularity rank of each distinct positive (or -1 if not popular).
        pop_order = np.argsort(pop, kind="stable")
        pop_sorted = pop[pop_order]
        loc = np.searchsorted(pop_sorted, di)
        loc_c = np.minimum(loc, n_pop - 1)
        in_pop = pop_sorted[loc_c] == di
        rank = np.where(in_pop, pop_order[loc_c], -1)

        # Per-user group boundaries over the distinct pairs.
        u_starts = np.nonzero(np.concatenate(([True], du[1:] != du[:-1])))[0]
        n_pos = np.diff(np.concatenate((u_starts, [du.size])))
        uniq_users = du[u_starts]
        n_users = uniq_users.size
        user_idx = np.repeat(np.arange(n_users), n_pos)

        # Sorted positive ranks per user -> g = p_i - i within each group.
        k_per_user = np.bincount(user_idx[in_pop], minlength=n_users)
        g_user = user_idx[in_pop]
        g_order = np.lexsort((rank[in_pop], g_user))
        g_user = g_user[g_order]
        g_rank = rank[in_pop][g_order]
        g = g_rank - segment_positions(k_per_user)  # non-decreasing per user

        need = (n_pos * self.negative_positive_ratio).astype(np.int64)
        take = np.minimum(need, n_pop - k_per_user)
        take = np.maximum(take, 0)

        # Flat (user, j) queries; one searchsorted over composite keys
        # user*K + value resolves the per-user count(g <= j).
        q_user = np.repeat(np.arange(n_users), take)
        j = segment_positions(take)
        K = np.int64(n_pop + 1)
        g_keys = g_user.astype(np.int64) * K + g.astype(np.int64)
        q_keys = q_user.astype(np.int64) * K + j.astype(np.int64)
        k_prefix = np.cumsum(k_per_user) - k_per_user
        count = np.searchsorted(g_keys, q_keys, side="right") - k_prefix[q_user]
        f = j + count
        return uniq_users[q_user], pop[f].astype(np.int64)
