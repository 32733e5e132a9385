"""Synthetic star-matrix generator with planted low-rank structure.

The reference's dataset (``albedo.sql``, crawled from the GitHub API) is not
distributable with this repo, so tests and benchmarks use a generator that
reproduces its statistical shape: a power-law item popularity (GitHub stars),
power-law user activity, and a low-rank preference structure that implicit ALS
can recover — so ranking metrics behave like the reference's (ALS >> popularity
baseline >> random, cf. BASELINE.md).

Generation: scores S = signal_scale * U V^T / sqrt(rank) + popularity logit;
each user stars their Gumbel-top-k items, i.e. samples without replacement from
softmax(S / temperature). ``signal_scale`` sets how much personalization
dominates popularity + Gumbel noise — at the default, a tuned ALS beats the
popularity baseline by a wide margin, mirroring the reference's metric gap
(0.052 vs 0.002, BASELINE.md).

The same numpy draws as the JAX package's generator: one seed gives the same
matrix in both packages.
"""

from __future__ import annotations

import numpy as np

from albedo_tpu_torch.datasets.star_matrix import StarMatrix


def synthetic_stars(
    n_users: int = 2000,
    n_items: int = 1000,
    rank: int = 16,
    mean_stars: float = 30.0,
    popularity_alpha: float = 1.0,
    signal_scale: float = 4.0,
    temperature: float = 1.0,
    seed: int = 42,
    chunk: int = 2048,
) -> StarMatrix:
    """Sample an implicit-feedback star matrix.

    Returns a ``StarMatrix`` whose raw ids are offset from the dense indices
    (users +1_000_000, items +5_000_000) so tests exercise the reindex maps.
    """
    rng = np.random.default_rng(seed)
    # Unit-variance per-pair preference signal, scaled by signal_scale.
    scale = np.sqrt(signal_scale / np.sqrt(rank))
    u_fac = rng.normal(0.0, scale, size=(n_users, rank)).astype(np.float32)
    v_fac = rng.normal(0.0, scale, size=(n_items, rank)).astype(np.float32)

    # Zipf-ish popularity logit: item j gets -alpha * log(rank_j).
    pop_rank = rng.permutation(n_items) + 1
    pop_logit = (-popularity_alpha * np.log(pop_rank)).astype(np.float32)

    # Per-user activity: lognormal, clipped to [1, n_items // 2].
    n_stars = np.clip(
        rng.lognormal(np.log(mean_stars), 0.9, size=n_users).astype(np.int64),
        1,
        max(1, n_items // 2),
    )

    rows_parts: list[np.ndarray] = []
    cols_parts: list[np.ndarray] = []
    for lo in range(0, n_users, chunk):
        hi = min(lo + chunk, n_users)
        scores = (u_fac[lo:hi] @ v_fac.T + pop_logit) / temperature
        gumbel = rng.gumbel(size=scores.shape).astype(np.float32)
        noisy = scores + gumbel
        kmax = int(n_stars[lo:hi].max())
        # Gumbel-top-k == sampling w/o replacement from softmax(scores).
        # argpartition returns the top-kmax unordered; sort within it so the
        # per-user :k slice really is that user's top-k by noisy score.
        part = np.argpartition(-noisy, kmax - 1, axis=1)[:, :kmax]
        inner = np.argsort(np.take_along_axis(-noisy, part, axis=1), axis=1)
        top = np.take_along_axis(part, inner, axis=1)
        for r in range(hi - lo):
            k = int(n_stars[lo + r])
            cols_parts.append(top[r, :k].astype(np.int32))
            rows_parts.append(np.full(k, lo + r, dtype=np.int32))

    rows = np.concatenate(rows_parts)
    cols = np.concatenate(cols_parts)
    return StarMatrix.from_interactions(
        raw_users=rows.astype(np.int64) + 1_000_000,
        raw_items=cols.astype(np.int64) + 5_000_000,
        vals=np.ones(rows.shape[0], dtype=np.float32),
    )
