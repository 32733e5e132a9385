"""CLI jobs: one per reference entry point (``train_als`` in this port).

Reference parity: the ``ALSRecommenderBuilder`` main and its Makefile target
(``make train_als``). Port of the ``train_als`` path of
``albedo_tpu/builders/jobs.py``: deterministic synthetic tables, the star
matrix (data policy ``off``: the validation firewall is not ported yet), the
ALS fit under the divergence watchdog, top-30 retrieval, and NDCG@30.

Evaluation protocol matches the builders: train on the FULL star matrix,
sample test users (+ the canary user), recommend top-30, and score NDCG@30
against each user's most recent 30 stars (``ALSRecommenderBuilder.scala:60-105``).
Not ported yet: the ``--tables`` sources, the date-keyed artifact cache,
checkpointed and mesh fits, and the other jobs.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import pandas as pd

from albedo_tpu_torch.datasets import sample_test_users, synthetic_tables
from albedo_tpu_torch.datasets.tables import RawTables
from albedo_tpu_torch.evaluators import RankingEvaluator, user_actual_items, user_items_from_pairs
from albedo_tpu_torch.models.als import ALSModel, ImplicitALS
from albedo_tpu_torch.recommenders import ALSRecommender
from albedo_tpu_torch.utils.device import resolve_device
from albedo_tpu_torch.utils.watchdog import guarded_fit

TOP_K = 30
VINTA_USER_ID = 652070  # the smoke-canary user (ALSRecommenderBuilder.scala:68)
ALS_REG = ImplicitALS.reg_param
ALS_ALPHA = ImplicitALS.alpha


class JobContext:
    """Shared lazily-built products for one CLI invocation."""

    def __init__(self, args: argparse.Namespace, tables: RawTables | None = None):
        self.args = args
        self.small = bool(getattr(args, "small", False))
        now = getattr(args, "now", None)
        self.now = float(now) if now is not None else time.time()
        self.device = resolve_device(getattr(args, "device", None) or "cuda")
        self._cache: dict[str, object] = {}
        if tables is not None:
            self._cache["tables"] = tables

    def tables(self) -> RawTables:
        if "tables" not in self._cache:
            n_users, n_items = (400, 300) if self.small else (5000, 3000)
            self._cache["tables"] = synthetic_tables(
                n_users=n_users, n_items=n_items, mean_stars=20, seed=42
            )
        return self._cache["tables"]  # type: ignore[return-value]

    def matrix(self):
        if "matrix" not in self._cache:
            self._cache["matrix"] = self.tables().star_matrix(policy="off")
        return self._cache["matrix"]

    def als_solver(self) -> tuple[str, int]:
        """(solver, cg_steps) from the CLI ``--solver``/``--cg-steps`` flags."""
        steps = getattr(self.args, "cg_steps", None)
        return (
            getattr(self.args, "solver", "cholesky") or "cholesky",
            3 if steps is None else int(steps),
        )

    def als_estimator(self, rank=50, reg=ALS_REG, alpha=ALS_ALPHA, iters=26) -> ImplicitALS:
        """The flagship estimator (rank 16 x 8 iterations under ``--small``)."""
        if self.small:
            rank, iters = 16, 8
        solver, cg_steps = self.als_solver()
        return ImplicitALS(
            rank=rank, reg_param=reg, alpha=alpha, max_iter=iters,
            solver=solver, cg_steps=cg_steps, device=self.device,
        )

    def als_model(self, rank=50, reg=ALS_REG, alpha=ALS_ALPHA, iters=26) -> ALSModel:
        """The fitted flagship model; the fit runs under the divergence
        watchdog (check-final + one damped re-fit)."""
        if "als" not in self._cache:
            est = self.als_estimator(rank=rank, reg=reg, alpha=alpha, iters=iters)
            model, trips = guarded_fit(est, self.matrix())
            self._cache["als"] = model
            self._cache["als_report"] = dict(est.last_fit_report, watchdog_trips=trips)
        return self._cache["als"]  # type: ignore[return-value]

    def test_user_dense(self, n=250) -> np.ndarray:
        matrix = self.matrix()
        canary = matrix.users_of(np.array([VINTA_USER_ID]))
        extra = canary[canary >= 0]
        return sample_test_users(matrix, n=n, always_include=extra if extra.size else None)

    def evaluate_topk(self, frame: pd.DataFrame) -> float:
        """NDCG@30 of a (user_id, repo_id, score) candidate frame."""
        matrix = self.matrix()
        predicted = user_items_from_pairs(
            matrix.users_of(frame["user_id"].to_numpy(np.int64)),
            matrix.items_of(frame["repo_id"].to_numpy(np.int64)),
            order_key=frame["score"].to_numpy(np.float64),
            k=TOP_K,
        )
        actual = user_actual_items(matrix, k=TOP_K)
        return RankingEvaluator(metric_name="ndcg@k", k=TOP_K).evaluate(predicted, actual)


def _report(job: str, metric_name: str, value: float, t0: float) -> None:
    print(f"[{job}] {metric_name} = {value}")
    print(f"[{job}] wall-clock = {time.time() - t0:.1f}s")


def train_als_job(args) -> None:
    """``ALSRecommenderBuilder`` — the flagship (NDCG@30 gate 0.05209)."""
    t0 = time.time()
    ctx = JobContext(args)
    print(f"[train_als] star-matrix sparsity = {ctx.matrix().sparsity():.6f}")
    model = ctx.als_model()
    print(f"[train_als] fit health = {ctx._cache['als_report']['health']}")
    rec = ALSRecommender(model, ctx.matrix(), top_k=TOP_K)
    users = ctx.matrix().user_ids[ctx.test_user_dense()]
    ndcg = ctx.evaluate_topk(rec.recommend_for_users(users))
    _report("train_als", "NDCG@30", ndcg, t0)


JOBS = {"train_als": train_als_job}
