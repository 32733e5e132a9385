"""The JAX package's held-out NDCG@30 on the bench split from the pinned numpy
init — the reference values ``chip_smoke.py`` holds the port against.

    JAX_PLATFORMS=cpu python jax_reference_ndcg.py [cholesky|cg ...]

Same protocol as ``chip_smoke.py`` phase 5 and ``bench.py``'s quality gate:
``synthetic_stars(30000, 20000, rank=24, mean_stars=60, seed=42)``, a 10%
per-user split (seed 42), rank 50 x 26 iterations from
``default_rng(42)`` Gaussian factors scaled by 1/sqrt(50), 500 test users,
seen items excluded. Prints one JSON line per solver. Takes about a minute
and a half per solver on a CPU.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from albedo_tpu.datasets import random_split_by_user, sample_test_users
from albedo_tpu.datasets.ragged import padded_rows
from albedo_tpu.datasets.synthetic import synthetic_stars
from albedo_tpu.evaluators import RankingEvaluator, UserItems, user_actual_items
from albedo_tpu.models.als import ImplicitALS


def main(solvers: list[str]) -> None:
    matrix = synthetic_stars(30000, 20000, rank=24, mean_stars=60, seed=42)
    train, test = random_split_by_user(matrix, test_ratio=0.1, seed=42)
    rng = np.random.default_rng(42)
    s = np.float32(1 / np.sqrt(50))
    u0 = (rng.standard_normal((train.n_users, 50)) * s).astype(np.float32)
    v0 = (rng.standard_normal((train.n_items, 50)) * s).astype(np.float32)
    users = sample_test_users(train, n=500, seed=42)
    indptr, cols, _ = train.csr()
    excl = padded_rows(indptr, cols, users)
    actual = user_actual_items(test, k=30)
    for solver in solvers:
        model = ImplicitALS(
            rank=50, reg_param=0.5, alpha=40.0, max_iter=26, seed=42, solver=solver,
            cg_steps=3, init_factors=(u0, v0), chunked=False,
        ).fit(train)
        _, idx = model.recommend(users, k=30, exclude_idx=excl)
        ndcg = RankingEvaluator(metric_name="ndcg@k", k=30).evaluate(
            UserItems(users=users, items=idx.astype(np.int32)), actual
        )
        print(json.dumps({"solver": solver, "ndcg": ndcg, "train_nnz": train.nnz}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["cholesky", "cg"])
