"""Stratified train/test splitting.

Reference parity: ``DatasetUtils.randomSplitByUser`` (``utils/DatasetUtils.scala:17-34``)
splits each user's interactions independently so every user appears in both
sides — required for ranking evaluation, where NDCG needs held-out positives
per evaluated user.
"""

from __future__ import annotations

import numpy as np

from albedo_tpu_torch.datasets.star_matrix import StarMatrix


def random_split_by_user(
    matrix: StarMatrix, test_ratio: float = 0.1, seed: int = 42
) -> tuple[StarMatrix, StarMatrix]:
    """Per-user random split of interactions into (train, test).

    Each user's nonzeros are permuted with a per-user-independent stream and the
    first ``ceil(test_ratio * n_u)`` go to test, guaranteeing at least one test
    item for users with >= 1 star when ``test_ratio > 0`` — except single-item
    users, who stay entirely in train so ALS has something to fit.
    """
    rng = np.random.default_rng(seed)
    nnz = matrix.nnz
    # Random priority per interaction; rank within user decides the side.
    priority = rng.random(nnz)
    order = np.lexsort((priority, matrix.rows))
    counts = matrix.user_counts()
    starts = np.zeros(matrix.n_users, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])

    # Position of each (sorted) interaction within its user's block.
    pos_in_user = np.arange(nnz) - starts[matrix.rows[order]]
    n_test = np.ceil(counts * test_ratio).astype(np.int64)
    n_test = np.where(counts <= 1, 0, np.minimum(n_test, counts - 1))
    is_test_sorted = pos_in_user < n_test[matrix.rows[order]]

    test_mask = np.zeros(nnz, dtype=bool)
    test_mask[order] = is_test_sorted
    return matrix.select(~test_mask), matrix.select(test_mask)


def sample_test_users(
    matrix: StarMatrix,
    n: int = 250,
    always_include: np.ndarray | None = None,
    min_stars: int = 1,
    seed: int = 42,
) -> np.ndarray:
    """Sample dense user indices for evaluation.

    Reference parity: every builder samples a few hundred test users and
    force-appends the smoke-canary user (id 652070)
    (``ALSRecommenderBuilder.scala:67-68``). ``always_include`` takes DENSE
    indices — map raw ids through ``matrix.users_of`` first.
    """
    rng = np.random.default_rng(seed)
    counts = matrix.user_counts()
    eligible = np.nonzero(counts >= min_stars)[0]
    take = min(n, eligible.shape[0])
    chosen = rng.choice(eligible, size=take, replace=False)
    if always_include is not None:
        extra = np.asarray(always_include, dtype=chosen.dtype)
        if extra.size and (extra.min() < 0 or extra.max() >= matrix.n_users):
            raise ValueError(
                "always_include must be dense user indices in [0, n_users); "
                "map raw ids with matrix.users_of() first"
            )
        chosen = np.union1d(chosen, extra)
    return np.unique(chosen).astype(np.int32)
