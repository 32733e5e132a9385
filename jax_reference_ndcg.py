"""The JAX package's reference values that ``chip_smoke.py`` holds the port
against: the held-out NDCG@30 on the bench split from the pinned numpy init,
and the ranker job's AUC and NDCG@30.

    JAX_PLATFORMS=cpu python jax_reference_ndcg.py [cholesky|cg ...]
    JAX_PLATFORMS=cpu python jax_reference_ndcg.py ranker [--port] [--seeds 42,1,2] [--shared]
    JAX_PLATFORMS=cpu python jax_reference_ndcg.py candidates [--port] [--seeds 42,1,2,3]
    JAX_PLATFORMS=cpu python jax_reference_ndcg.py serve [--port]

Same protocol as ``chip_smoke.py`` phase 5 and ``bench.py``'s quality gate:
``synthetic_stars(30000, 20000, rank=24, mean_stars=60, seed=42)``, a 10%
per-user split (seed 42), rank 50 x 26 iterations from
``default_rng(42)`` Gaussian factors scaled by 1/sqrt(50), 500 test users,
seen items excluded. Prints one JSON line per solver. Takes about a minute
and a half per solver on a CPU.

``ranker`` runs the ``train_lr`` job as ``chip_smoke.py`` runs it: the
default synthetic tables (5000 x 3000, mean 20 stars, seed 42), Word2Vec at
the reference config (dim 200, 30 epochs), LR 300 iterations at reg 0.7,
``--now 1600000000``, data policy ``off``. ``--seeds`` re-runs it with the
ALS and Word2Vec seeds set to each value (the JAX and torch generators
differ, so the seed spread is what bounds a seeded port run against the
JAX values); ``--port`` runs the port on the CPU instead of the JAX package.
One JSON line per seed; about a minute per seed on a CPU.

``ranker --shared`` takes the random streams out of the comparison: every
ALS fit starts from one numpy init (``default_rng(1)`` Gaussian factors
scaled by 1/sqrt(rank)) and Word2Vec is not trained but returns numpy
vectors over the job's vocabulary (``default_rng(1)``, normal, scale 0.3).
Both packages then compute the same function of the same inputs, so their
AUC and NDCG@30 differ only by float32 round-off; ``chip_smoke.py`` holds
the card to the JAX package's values from this mode.

``candidates`` runs the candidate-generator jobs at full size as
``chip_smoke.py`` phase 6 runs them (the default synthetic tables, data
policy ``off``, ``--now 1600000000``): ``popularity``, ``curation``,
``item_cf``, ``user_cf`` and ``tfidf_content``, which are deterministic, once;
``ranking_mf`` and ``content --w2v-full`` once per seed of ``--seeds`` (the
factorization's and Word2Vec's seed); and ``content`` (Word2Vec dim 16) with
the Word2Vec vectors of ``ranker --shared``. One JSON line per run, with the
job's NDCG@30 (for ``tfidf_content``, its similar-repo list); a few minutes
in all on a CPU.

``serve`` pins the ``serve`` phase of ``chip_smoke.py``: the ALS model of the
``train_als`` job's tables (rank 50, 26 iterations, Cholesky, data policy
``off``) fitted from the numpy init of ``--shared``, served for the job's
250 test users at k = 30 with seen items kept (the job's protocol) through
the service's direct path, and the NDCG@30 of those served lists beside the
job's offline evaluation of the same model. One JSON line; about a minute on
a CPU.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import os
import re
import sys
import tempfile

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


def _seeded(cls, method: str, seed: dict) -> None:
    """Make ``cls.<method>`` run with ``self.seed = seed["value"]``."""
    orig = getattr(cls, method)

    def run(self, *a, **k):
        self.seed = seed["value"]
        return orig(self, *a, **k)

    setattr(cls, method, run)


SHARED_SEED = 1
SHARED_W2V_SCALE = 0.3


def shared_als_init(n_users: int, n_items: int, rank: int) -> tuple[np.ndarray, np.ndarray]:
    """The ALS init of ``--shared``: Gaussian factors scaled by 1/sqrt(rank)."""
    rng = np.random.default_rng(SHARED_SEED)
    s = np.float32(1 / np.sqrt(rank))
    return ((rng.standard_normal((n_users, rank)) * s).astype(np.float32),
            (rng.standard_normal((n_items, rank)) * s).astype(np.float32))


def shared_w2v_vectors(n_words: int, dim: int) -> np.ndarray:
    """The Word2Vec vectors of ``--shared``, one row per vocabulary word."""
    rng = np.random.default_rng(SHARED_SEED)
    return rng.normal(scale=SHARED_W2V_SCALE, size=(n_words, dim)).astype(np.float32)


def _vocab(sentences: list[list[str]], min_count: int) -> list[str]:
    """Word2Vec's vocabulary: words seen ``min_count`` times or more, in
    (-count, word) order, as both packages build it."""
    counts = collections.Counter(w for s in sentences for w in s)
    return sorted((w for w, c in counts.items() if c >= min_count), key=lambda w: (-counts[w], w))


def _share_weights(als, word2vec) -> None:
    """Make every ALS fit start from :func:`shared_als_init` and every
    Word2Vec fit return :func:`shared_w2v_vectors` (``--shared``)."""
    _share_als_init(als)
    _share_w2v_vectors(word2vec)


def _share_als_init(als) -> None:
    """Make every ALS fit start from :func:`shared_als_init`."""
    als_fit = als.ImplicitALS.fit

    def fit(self, matrix, *a, **k):
        self.init_factors = shared_als_init(matrix.n_users, matrix.n_items, self.rank)
        return als_fit(self, matrix, *a, **k)

    als.ImplicitALS.fit = fit


def _share_w2v_vectors(word2vec) -> None:
    """Make every Word2Vec fit return :func:`shared_w2v_vectors` over the
    corpus's vocabulary instead of training."""
    def fit_corpus(self, sentences):
        vocab = _vocab(sentences, self.min_count)
        return word2vec.Word2VecModel(vocab=vocab, vectors=shared_w2v_vectors(len(vocab), self.dim),
                                      input_col=self.input_col,
                                      output_col=self.output_col or f"{self.input_col}__w2v")

    word2vec.Word2Vec.fit_corpus = fit_corpus


def _run_job(jobs, name: str, port: bool, **flags) -> str:
    """The printed output of job ``name`` at full size on the CPU (data
    policy off, --now 1600000000), in a fresh artifact store: cached models
    are keyed by their hyperparameters, not by the seed."""
    ns = argparse.Namespace(**{"small": False, "now": 1600000000.0, "w2v_full": False, "data_policy": "off",
                               "no_compilation_cache": True, "device": "cpu", **flags})
    with tempfile.TemporaryDirectory() as data_dir:
        os.environ["ALBEDO_DATA_DIR"] = data_dir
        os.environ["ALBEDO_CHECKPOINT_DIR"] = os.path.join(data_dir, "checkpoints")
        if not port:
            from albedo_tpu.settings import reset_settings

            reset_settings()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            getattr(jobs, f"{name}_job")(ns)
    return out.getvalue()


def ranker(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(prog="jax_reference_ndcg.py ranker")
    ap.add_argument("--port", action="store_true", help="run the port on the CPU")
    ap.add_argument("--seeds", default="42", help="comma-separated ALS/Word2Vec seeds")
    ap.add_argument("--shared", action="store_true",
                    help="numpy ALS init and numpy Word2Vec vectors, the same in both packages")
    args = ap.parse_args(argv)
    if args.port:
        from albedo_tpu_torch.builders import jobs
        from albedo_tpu_torch.models import als, word2vec
    else:
        from albedo_tpu.builders import jobs
        from albedo_tpu.models import als, word2vec
    current = {"value": 42}
    _seeded(als.ImplicitALS, "fit", current)
    _seeded(word2vec.Word2Vec, "fit_corpus", current)
    if args.shared:
        _share_weights(als, word2vec)
    for seed in ([SHARED_SEED] if args.shared else (int(x) for x in args.seeds.split(","))):
        current["value"] = seed
        text = _run_job(jobs, "train_lr", args.port, w2v_full=True)
        print(json.dumps({
            "package": "albedo_tpu_torch (cpu)" if args.port else "albedo_tpu (jax cpu)",
            "weights": "shared" if args.shared else "seeded", "seed": seed,
            "auc": float(re.search(r"areaUnderROC = (\S+)", text).group(1)),
            "ndcg": float(re.search(r"NDCG@30 = (\S+)", text).group(1)),
        }), flush=True)


def candidates(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(prog="jax_reference_ndcg.py candidates")
    ap.add_argument("--port", action="store_true", help="run the port on the CPU")
    ap.add_argument("--seeds", default="42,1,2,3", help="comma-separated ranking_mf/Word2Vec seeds")
    args = ap.parse_args(argv)
    if args.port:
        from albedo_tpu_torch.builders import jobs
        from albedo_tpu_torch.models import ranking_factorization as rf
        from albedo_tpu_torch.models import word2vec
    else:
        from albedo_tpu.builders import jobs
        from albedo_tpu.models import ranking_factorization as rf
        from albedo_tpu.models import word2vec
    package = "albedo_tpu_torch (cpu)" if args.port else "albedo_tpu (jax cpu)"

    def emit(job: str, text: str, **extra) -> None:
        rec = {"package": package, "job": job, **extra}
        m = re.search(r"NDCG@30 = (\S+)", text)
        if m:
            rec["ndcg"] = float(m.group(1))
        else:
            rec["similar"] = re.findall(r"\[tfidf_content\] (\d\.\d{4}) (\S+)", text)
        print(json.dumps(rec), flush=True)

    for job in ("popularity", "curation", "item_cf", "user_cf", "tfidf_content"):
        emit(job, _run_job(jobs, job, args.port))
    current = {"value": 42}
    _seeded(rf.RankingFactorization, "fit", current)
    _seeded(word2vec.Word2Vec, "fit_corpus", current)
    for seed in (int(x) for x in args.seeds.split(",")):
        current["value"] = seed
        emit("ranking_mf", _run_job(jobs, "ranking_mf", args.port), seed=seed)
        emit("content", _run_job(jobs, "content", args.port, w2v_full=True), seed=seed,
             weights="seeded", w2v_full=True)

    _share_w2v_vectors(word2vec)
    emit("content", _run_job(jobs, "content", args.port), weights="shared", w2v_full=False)


def serve(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(prog="jax_reference_ndcg.py serve")
    ap.add_argument("--port", action="store_true", help="run the port on the CPU")
    args = ap.parse_args(argv)
    import pandas as pd

    if args.port:
        from albedo_tpu_torch.builders import jobs
        from albedo_tpu_torch.models import als
        from albedo_tpu_torch.recommenders import ALSRecommender
        from albedo_tpu_torch.serving import RecommendationService
    else:
        from albedo_tpu.builders import jobs
        from albedo_tpu.models import als
        from albedo_tpu.recommenders import ALSRecommender
        from albedo_tpu.serving import RecommendationService
    _share_als_init(als)
    ns = argparse.Namespace(small=False, now=1600000000.0, w2v_full=False, data_policy="off",
                            no_compilation_cache=True, device="cpu")
    with tempfile.TemporaryDirectory() as data_dir:
        os.environ["ALBEDO_DATA_DIR"] = data_dir
        os.environ["ALBEDO_CHECKPOINT_DIR"] = os.path.join(data_dir, "checkpoints")
        if not args.port:
            from albedo_tpu.settings import reset_settings

            reset_settings()
        ctx = jobs.JobContext(ns)
        model, matrix = ctx.als_model(), ctx.matrix()
        users = matrix.user_ids[ctx.test_user_dense()]
        offline = ctx.evaluate_topk(ALSRecommender(model, matrix, top_k=30).recommend_for_users(users))
        with RecommendationService(model, matrix, batching=False) as service:
            rows = [(int(u), item["repo_id"], item["score"]) for u in users
                    for item in service.recommend(int(u), k=30, exclude_seen=False)["items"]]
        served = ctx.evaluate_topk(pd.DataFrame(rows, columns=["user_id", "repo_id", "score"]))
    print(json.dumps({
        "package": "albedo_tpu_torch (cpu)" if args.port else "albedo_tpu (jax cpu)",
        "served_ndcg": served, "offline_ndcg": offline, "users": int(users.size),
    }), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["ranker"]:
        ranker(sys.argv[2:])
    elif sys.argv[1:2] == ["serve"]:
        serve(sys.argv[2:])
    elif sys.argv[1:2] == ["candidates"]:
        candidates(sys.argv[2:])
    else:
        main(sys.argv[1:] or ["cholesky", "cg"])
