"""The JAX package's reference values that ``chip_smoke.py`` holds the port
against: the held-out NDCG@30 on the bench split from the pinned numpy init,
and the ranker job's AUC and NDCG@30.

    JAX_PLATFORMS=cpu python jax_reference_ndcg.py [cholesky|cg ...] [--gather-dtype bfloat16]
    JAX_PLATFORMS=cpu python jax_reference_ndcg.py ranker [--port] [--seeds 42,1,2] [--shared] [--lr-solver adam]
    JAX_PLATFORMS=cpu python jax_reference_ndcg.py w2v_shared [--port] [--seeds 42,1,2,3]
    JAX_PLATFORMS=cpu python jax_reference_ndcg.py candidates [--port] [--seeds 42,1,2,3]
    JAX_PLATFORMS=cpu python jax_reference_ndcg.py serve [--port]
    JAX_PLATFORMS=cpu python jax_reference_ndcg.py two_stage [--port] [--shared]
    JAX_PLATFORMS=cpu python jax_reference_ndcg.py wide_rank [--port] [--rank 100] [--solver cg] [--permute-seeds 1,2]
    JAX_PLATFORMS=cpu python jax_reference_ndcg.py cv_als [--port] [--seeds 42,1,2,3] [--shared] [--solver cg]
    JAX_PLATFORMS=cpu python jax_reference_ndcg.py cv_lr [--port] [--seeds 42,1,2,3] [--shared]

Same protocol as ``chip_smoke.py`` phase 5 and ``bench.py``'s quality gate:
``synthetic_stars(30000, 20000, rank=24, mean_stars=60, seed=42)``, a 10%
per-user split (seed 42), rank 50 x 26 iterations from
``default_rng(42)`` Gaussian factors scaled by 1/sqrt(50), 500 test users,
seen items excluded. Prints one JSON line per solver. Takes about a minute
and a half per solver on a CPU. ``--gather-dtype bfloat16`` fits with the
bf16 gathers (``ImplicitALS(gather_dtype="bfloat16")``) from the same init.

``ranker`` runs the ``train_lr`` job as ``chip_smoke.py`` runs it: the
default synthetic tables (5000 x 3000, mean 20 stars, seed 42), Word2Vec at
the reference config (dim 200, 30 epochs), LR 300 iterations at reg 0.7,
``--now 1600000000``, data policy ``off``. ``--seeds`` re-runs it with the
ALS and Word2Vec seeds set to each value (the JAX and torch generators
differ, so the seed spread is what bounds a seeded port run against the
JAX values); ``--port`` runs the port on the CPU instead of the JAX package.
One JSON line per seed; about a minute per seed on a CPU. ``--lr-solver
adam`` fits the LR with ``solver="adam"`` (300 steps at learning rate 0.05)
and adds its ``train_loss`` to the line (``--lr-max-iter`` sets the
steps). ``--permute-seeds 1,2,3`` runs the
job once more per seed with the LR's training rows in another order
(``default_rng(seed).permutation``): the objective is a sum over rows, so
only the float32 summation order changes, and the spread of these runs is
how far round-off alone moves a fit.

``w2v_shared`` fits the ``train_word2vec`` job's Word2Vec (the reference
config: dim 200, 30 epochs, batch 4096, min count 10, no subsampling) on the
job's corpus with ``shared_negatives=512``, once per seed of ``--seeds``,
and prints each epoch's mean loss (the JAX fit does not return its losses:
they are read from the epoch program's outputs, as the port's report keeps
them). A few minutes per seed on a CPU.

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

``two_stage`` pins the ``two_stage`` phase of ``chip_smoke.py``: ``serve
--two-stage`` as the job builds it (popularity and curation sources beside
the ALS source, re-ranked by the LR ranker the job trains in process), with
``--shared`` on the inputs of ``ranker --shared`` (the numpy ALS init and
numpy Word2Vec vectors, dim 200, so that L-BFGS from zeros is
deterministic). Through the service's direct path (no batching; stage
deadlines long enough that nothing degrades) it serves the job's 250 test
users at k = 30 with seen items excluded and prints the NDCG@30 of the
re-ranked lists, then the first users' lists with their probabilities. A few
minutes on a CPU.

``wide_rank`` pins the rank-100 fit of ``chip_smoke.py`` (the K1-K3 wide
paths): ``ImplicitALS(rank=100)``, 26 iterations, Cholesky, on the
``train_als`` job's tables from the numpy init of ``--shared``, evaluated as
the job evaluates (the 250 test users' top 30 against their most recent 30
stars). One JSON line; about a minute on a CPU. ``--solver cg`` fits with
3-step CG instead (``chip_smoke.py``'s rank-100 CG fit). ``--permute-seeds
1,2`` (with ``--port``) fits once more per seed with the live entries of
every row of every bucket group in another order (``torch.Generator``
seeded with the seed): a row's terms are the same, so only the float32
summation order changes, and the spread of these fits is how far round-off
alone moves the fit.

``cv_als`` runs the ``cv_als`` job at full size (the default synthetic
tables, data policy ``off``): the grid the job takes without ``--tables``
(rank [8, 16] x regParam [0.1, 0.5] x alpha [1, 40], 13 iterations, 2
folds), once per ALS seed of ``--seeds``, and prints each grid point's mean
NDCG@30 and the best params (a few minutes per seed). ``cv_als --shared``
runs the real grid (rank [50, 100] x regParam [0.01, 0.5] x alpha [0.01,
40], 13 iterations, 2 folds) through ``cross_validate`` on the same tables,
every fit from the numpy init of ``--shared`` (rank-wide), scored as the
job scores a fold, and prints the per-fold NDCG@30 of every grid point and
the best params (about ten minutes). ``--solver cg`` fits every grid point
with 3-step CG, as ``cv_als --solver cg`` does.

``cv_lr`` runs the ``cv_lr`` job at full size (Word2Vec dim 200 x 30 epochs,
LR 300 iterations, the five weight columns in one batched solve), once per
ALS/Word2Vec seed of ``--seeds`` or once with ``--shared`` (the weights of
``ranker --shared``), and prints each column's AUC in the job's grid order.
A few minutes per run.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
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


def main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(prog="jax_reference_ndcg.py")
    ap.add_argument("solvers", nargs="*", default=["cholesky", "cg"])
    ap.add_argument("--gather-dtype", default=None, choices=["bfloat16"])
    args = ap.parse_args(argv)
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
    for solver in args.solvers:
        model = ImplicitALS(
            rank=50, reg_param=0.5, alpha=40.0, max_iter=26, seed=42, solver=solver,
            cg_steps=3, init_factors=(u0, v0), chunked=False, gather_dtype=args.gather_dtype,
        ).fit(train)
        _, idx = model.recommend(users, k=30, exclude_idx=excl)
        ndcg = RankingEvaluator(metric_name="ndcg@k", k=30).evaluate(
            UserItems(users=users, items=idx.astype(np.int32)), actual
        )
        print(json.dumps({"solver": solver, "gather_dtype": args.gather_dtype, "ndcg": ndcg,
                          "train_nnz": train.nnz}), flush=True)


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
    ap.add_argument("--lr-solver", default="lbfgs", choices=["lbfgs", "adam"])
    ap.add_argument("--permute-seeds", default="", help="comma-separated seeds of LR row permutations")
    ap.add_argument("--lr-max-iter", type=int, default=None, help="the LR's max_iter (the job's 300 if not given)")
    args = ap.parse_args(argv)
    if args.port:
        from albedo_tpu_torch.builders import jobs
        from albedo_tpu_torch.models import als, logistic_regression, word2vec
    else:
        from albedo_tpu.builders import jobs
        from albedo_tpu.models import als, logistic_regression, word2vec
    current = {"value": 42}
    _seeded(als.ImplicitALS, "fit", current)
    _seeded(word2vec.Word2Vec, "fit_corpus", current)
    if args.shared:
        _share_weights(als, word2vec)
    lr_fit = logistic_regression.LogisticRegression.fit
    fitted = {}

    permutation = {"seed": None}

    def fit(self, fm, labels, sample_weight=None, *a, **k):
        self.solver, self.learning_rate = args.lr_solver, ADAM_LEARNING_RATE
        self.max_iter = args.lr_max_iter or self.max_iter
        if permutation["seed"] is not None:
            fm, labels, sample_weight = _permuted_rows(fm, labels, sample_weight, permutation["seed"])
        fitted["model"], fitted["model_max_iter"] = lr_fit(self, fm, labels, sample_weight, *a, **k), self.max_iter
        return fitted["model"]

    logistic_regression.LogisticRegression.fit = fit
    perms = [None] + [int(x) for x in args.permute_seeds.split(",") if x]
    for seed in ([SHARED_SEED] if args.shared else (int(x) for x in args.seeds.split(","))):
        current["value"] = seed
        for perm in perms:
            permutation["seed"] = perm
            text = _run_job(jobs, "train_lr", args.port, w2v_full=True)
            print(json.dumps({
                "package": "albedo_tpu_torch (cpu)" if args.port else "albedo_tpu (jax cpu)",
                "weights": "shared" if args.shared else "seeded", "seed": seed,
                "auc": float(re.search(r"areaUnderROC = (\S+)", text).group(1)),
                "ndcg": float(re.search(r"NDCG@30 = (\S+)", text).group(1)),
                "lr_solver": args.lr_solver, "lr_max_iter": fitted["model_max_iter"],
                "train_loss": float(fitted["model"].train_loss), "row_permutation": perm,
            }), flush=True)


def _permuted_rows(fm, labels, weights, seed: int):
    """The LR's training set with its rows in the order of
    ``default_rng(seed).permutation``: per-row blocks are permuted, the
    factored (distinct-row) tables stay and their row indices move."""
    perm = np.random.default_rng(seed).permutation(fm.n_rows)
    fields = {f.name: getattr(fm, f.name) for f in dataclasses.fields(fm)}
    rep = fields["bag_rep"]
    fields.update(
        dense=fields["dense"][perm],
        cat={k: v[perm] for k, v in fields["cat"].items()},
        bag_idx={k: v if k in rep else v[perm] for k, v in fields["bag_idx"].items()},
        bag_val={k: v if k in rep else v[perm] for k, v in fields["bag_val"].items()},
        bag_rep={k: v[perm] for k, v in rep.items()},
        vec_rep={k: v[perm] for k, v in fields["vec_rep"].items()},
    )
    weights = np.ones(fm.n_rows, np.float32) if weights is None else np.asarray(weights)
    return type(fm)(**fields), np.asarray(labels)[perm], weights[perm]


ADAM_LEARNING_RATE = 0.05  # LogisticRegression's default for solver="adam"
SHARED_NEGATIVES = 512


def w2v_shared(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(prog="jax_reference_ndcg.py w2v_shared")
    ap.add_argument("--port", action="store_true", help="run the port on the CPU")
    ap.add_argument("--seeds", default="42", help="comma-separated Word2Vec seeds")
    args = ap.parse_args(argv)
    if args.port:
        from albedo_tpu_torch.builders import jobs
    else:
        import albedo_tpu.models.word2vec as jax_w2v
        from albedo_tpu.builders import jobs

        # The JAX fit drops each epoch's mean loss: keep it from the epoch
        # program's outputs.
        losses: list[float] = []
        acquire = jax_w2v.persistent_aot_executable

        def recording_acquire(*a, **k):
            compiled, *rest = acquire(*a, **k)

            def run(*args_):
                out = compiled(*args_)
                losses.append(float(out[3]))
                return out

            return (run, *rest)

        jax_w2v.persistent_aot_executable = recording_acquire
    with tempfile.TemporaryDirectory() as data_dir:
        ctx = _job_context(jobs, args.port, data_dir, w2v_full=True)
        corpus = ctx.word2vec_corpus()
        for seed in (int(x) for x in args.seeds.split(",")):
            est = ctx.word2vec_estimator()
            est.seed, est.shared_negatives = seed, SHARED_NEGATIVES
            if not args.port:
                losses.clear()
            est.fit_corpus(corpus)
            epoch_loss = est.last_fit_report["epoch_loss"] if args.port else list(losses)
            print(json.dumps({
                "package": "albedo_tpu_torch (cpu)" if args.port else "albedo_tpu (jax cpu)",
                "seed": seed, "dim": est.dim, "batch": est.batch_size, "shared_negatives": SHARED_NEGATIVES,
                "epochs": len(epoch_loss), "final_epoch_loss": epoch_loss[-1], "epoch_loss": epoch_loss,
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


def _job_context(jobs, port: bool, data_dir: str, **flags):
    """A full-size JobContext on the CPU (data policy off, --now 1600000000)
    over a fresh artifact store."""
    ns = argparse.Namespace(**{"small": False, "now": 1600000000.0, "w2v_full": False, "data_policy": "off",
                               "no_compilation_cache": True, "device": "cpu", **flags})
    os.environ["ALBEDO_DATA_DIR"] = data_dir
    os.environ["ALBEDO_CHECKPOINT_DIR"] = os.path.join(data_dir, "checkpoints")
    if not port:
        from albedo_tpu.settings import reset_settings

        reset_settings()
    return jobs.JobContext(ns)


def two_stage(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(prog="jax_reference_ndcg.py two_stage")
    ap.add_argument("--port", action="store_true", help="run the port on the CPU")
    ap.add_argument("--shared", action="store_true",
                    help="numpy ALS init and numpy Word2Vec vectors, the same in both packages")
    ap.add_argument("--show", type=int, default=3, help="users whose lists are printed")
    args = ap.parse_args(argv)
    import pandas as pd

    if args.port:
        from albedo_tpu_torch.builders import jobs
        from albedo_tpu_torch.datasets.tables import popular_repos
        from albedo_tpu_torch.models import als, word2vec
        from albedo_tpu_torch.recommenders import CurationRecommender, PopularityRecommender
        from albedo_tpu_torch.serving import RecommendationService, StageDeadlines
    else:
        from albedo_tpu.builders import jobs
        from albedo_tpu.datasets.tables import popular_repos
        from albedo_tpu.models import als, word2vec
        from albedo_tpu.recommenders import CurationRecommender, PopularityRecommender
        from albedo_tpu.serving import RecommendationService, StageDeadlines
    if args.shared:
        _share_weights(als, word2vec)
    with tempfile.TemporaryDirectory() as data_dir:
        ctx = _job_context(jobs, args.port, data_dir, w2v_full=True)
        with contextlib.redirect_stdout(io.StringIO()):
            model, matrix, ranker_model = ctx.als_model(), ctx.matrix(), ctx.ranker_model()
        lo, hi = ctx.star_range()
        curators = ctx.curators()
        recommenders = {
            "popularity": PopularityRecommender(popular_repos(ctx.tables().repo_info, lo, hi), top_k=30),
            "curation": CurationRecommender(ctx.tables().starring,
                                            **({"curator_ids": curators} if curators else {}), top_k=30),
        }
        users = matrix.user_ids[ctx.test_user_dense()]
        with RecommendationService(model, matrix, recommenders=recommenders, ranker=ranker_model,
                                   batching=False, deadlines=StageDeadlines(600.0, 600.0)) as service:
            bodies = [service.handle_recommend(int(u), k=30, exclude_seen=True)[1] for u in users]
        rows = [(int(u), item["repo_id"], item["score"]) for u, body in zip(users, bodies)
                for item in body["items"]]
        ndcg = ctx.evaluate_topk(pd.DataFrame(rows, columns=["user_id", "repo_id", "score"]))
    print(json.dumps({
        "package": "albedo_tpu_torch (cpu)" if args.port else "albedo_tpu (jax cpu)",
        "weights": "shared" if args.shared else "seeded", "two_stage_ndcg": ndcg, "users": int(users.size),
        "stages": sorted({b["stage"] for b in bodies}),
        "degraded": sum(bool(b["degraded"]) for b in bodies),
        "lists": [{"user_id": int(u), "items": [[i["repo_id"], i["score"], i["source"]] for i in b["items"][:10]]}
                  for u, b in zip(users[:args.show], bodies)],
    }), flush=True)


def _permuted_groups(als, original, seed: int) -> None:
    """Make the port's ``ImplicitALS.device_groups`` return ``original``'s
    bucket groups with the live entries of each row in another order (a
    uniform random order per row, ``torch.Generator`` seeded with ``seed``);
    the padding stays at the end of the row."""
    import torch

    from albedo_tpu_torch.datasets.ragged import Bucket

    def permute(g):
        gen = torch.Generator().manual_seed(seed)
        keys = torch.rand(g.mask.shape, generator=gen).masked_fill(~g.mask, 2.0)
        order = torch.argsort(keys, dim=-1)
        return Bucket(idx=g.idx.gather(-1, order), val=g.val.gather(-1, order), mask=g.mask,
                      row_ids=g.row_ids)

    def device_groups(self, matrix):
        ug, ig, u_land, i_land = original(self, matrix)
        return [permute(g) for g in ug], [permute(g) for g in ig], u_land, i_land

    als.ImplicitALS.device_groups = device_groups


def wide_rank(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(prog="jax_reference_ndcg.py wide_rank")
    ap.add_argument("--port", action="store_true", help="run the port on the CPU")
    ap.add_argument("--rank", type=int, default=100)
    ap.add_argument("--solver", default="cholesky", choices=["cholesky", "cg"])
    ap.add_argument("--permute-seeds", default="", help="comma-separated seeds of entry permutations (--port)")
    args = ap.parse_args(argv)
    if args.port:
        from albedo_tpu_torch.builders import jobs
        from albedo_tpu_torch.models import als
        from albedo_tpu_torch.recommenders import ALSRecommender
    else:
        from albedo_tpu.builders import jobs
        from albedo_tpu.models import als
        from albedo_tpu.recommenders import ALSRecommender
    seeds = [None] + [int(x) for x in args.permute_seeds.split(",") if x]
    if not args.port and len(seeds) > 1:
        ap.error("--permute-seeds needs --port")
    original = als.ImplicitALS.device_groups
    for seed in seeds:
        if seed is not None:
            _permuted_groups(als, original, seed)
        with tempfile.TemporaryDirectory() as data_dir:
            ctx = _job_context(jobs, args.port, data_dir)
            matrix = ctx.matrix()
            est = als.ImplicitALS(rank=args.rank, reg_param=jobs.ALS_REG, alpha=jobs.ALS_ALPHA, max_iter=26,
                                  solver=args.solver,
                                  init_factors=shared_als_init(matrix.n_users, matrix.n_items, args.rank),
                                  **({"device": "cpu"} if args.port else {}))
            model = est.fit(matrix)
            users = matrix.user_ids[ctx.test_user_dense()]
            ndcg = ctx.evaluate_topk(ALSRecommender(model, matrix, top_k=30).recommend_for_users(users))
        print(json.dumps({
            "package": "albedo_tpu_torch (cpu)" if args.port else "albedo_tpu (jax cpu)",
            "rank": args.rank, "solver": args.solver, "permute_seed": seed, "ndcg": ndcg,
            "users": int(users.size),
        }), flush=True)


def _cv_packages(port: bool):
    if port:
        from albedo_tpu_torch import cv
        from albedo_tpu_torch.builders import jobs
        from albedo_tpu_torch.models import als, word2vec
    else:
        from albedo_tpu import cv
        from albedo_tpu.builders import jobs
        from albedo_tpu.models import als, word2vec
    return cv, jobs, als, word2vec


CV_ALS_REAL_GRID = {"rank": [50, 100], "reg_param": [0.01, 0.5], "alpha": [0.01, 40.0]}


def cv_fold_ndcg(model, train, test, recommender_cls, datasets, evaluators) -> float:
    """The ``cv_als`` job's fold metric (``albedo_tpu/builders/jobs.py:540``):
    NDCG@30 of 150 test users sampled from the fold's test stars, their top
    30 from ``model`` (seen items kept) against their 30 most recent test
    stars; ``datasets``/``evaluators`` are either package's modules."""
    users = datasets.sample_test_users(test, n=150)
    frame = recommender_cls(model, train, top_k=30).recommend_for_users(train.user_ids[users])
    predicted = evaluators.user_items_from_pairs(
        train.users_of(frame["user_id"].to_numpy(np.int64)),
        train.items_of(frame["repo_id"].to_numpy(np.int64)),
        order_key=frame["score"].to_numpy(np.float64), k=30,
    )
    on = {"device": "cpu"} if evaluators.__name__.startswith("albedo_tpu_torch") else {}  # the port on the CPU
    return evaluators.RankingEvaluator(metric_name="ndcg@k", k=30, **on).evaluate(
        predicted, evaluators.user_actual_items(test, k=30))


def cv_als(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(prog="jax_reference_ndcg.py cv_als")
    ap.add_argument("--port", action="store_true", help="run the port on the CPU")
    ap.add_argument("--seeds", default="42", help="comma-separated ALS seeds")
    ap.add_argument("--shared", action="store_true",
                    help="the real grid, every fit from the shared numpy init")
    ap.add_argument("--solver", default="cholesky", choices=["cholesky", "cg"], help="the real grid's solver")
    args = ap.parse_args(argv)
    cv, jobs, als, _ = _cv_packages(args.port)
    package = "albedo_tpu_torch (cpu)" if args.port else "albedo_tpu (jax cpu)"
    if not args.shared:
        current = {"value": 42}
        _seeded(als.ImplicitALS, "fit", current)
        for seed in (int(x) for x in args.seeds.split(",")):
            current["value"] = seed
            text = _run_job(jobs, "cv_als", args.port)
            points = re.findall(r"^(\{.*\}) -> (\S+)$", text, flags=re.M)
            print(json.dumps({
                "package": package, "grid": "job", "seed": seed,
                "mean_ndcg": {p: float(v) for p, v in points},
                "best": re.search(r"\[cv_als\] best params = (.*)", text).group(1),
                "ndcg": float(re.search(r"NDCG@30 = (\S+)", text).group(1)),
            }), flush=True)
        return
    if args.port:
        from albedo_tpu_torch import datasets, evaluators
        from albedo_tpu_torch.recommenders import ALSRecommender
    else:
        from albedo_tpu import datasets, evaluators
        from albedo_tpu.recommenders import ALSRecommender
    with tempfile.TemporaryDirectory() as data_dir:
        matrix = _job_context(jobs, args.port, data_dir).matrix()

        def fit(params, train):
            init = shared_als_init(train.n_users, train.n_items, params["rank"])
            return als.ImplicitALS(max_iter=13, init_factors=init, solver=args.solver, **params,
                                   **({"device": "cpu"} if args.port else {})).fit(train)

        def evaluate(model, train, test):
            return cv_fold_ndcg(model, train, test, ALSRecommender, datasets, evaluators)

        results = cv.cross_validate(fit, evaluate, matrix, cv.param_grid(**CV_ALS_REAL_GRID), n_folds=2)
    print(json.dumps({
        "package": package, "grid": "real", "init": "shared", "solver": args.solver,
        "results": [{"params": r.params, "fold_ndcg": r.fold_metrics, "mean": r.mean_metric} for r in results],
        "best": results[0].params,
    }), flush=True)


def cv_lr(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(prog="jax_reference_ndcg.py cv_lr")
    ap.add_argument("--port", action="store_true", help="run the port on the CPU")
    ap.add_argument("--seeds", default="42", help="comma-separated ALS/Word2Vec seeds")
    ap.add_argument("--shared", action="store_true",
                    help="numpy ALS init and numpy Word2Vec vectors, the same in both packages")
    args = ap.parse_args(argv)
    _, jobs, als, word2vec = _cv_packages(args.port)
    current = {"value": 42}
    _seeded(als.ImplicitALS, "fit", current)
    _seeded(word2vec.Word2Vec, "fit_corpus", current)
    if args.shared:
        _share_weights(als, word2vec)
    for seed in ([SHARED_SEED] if args.shared else (int(x) for x in args.seeds.split(","))):
        current["value"] = seed
        text = _run_job(jobs, "cv_lr", args.port, w2v_full=True)
        grid = re.findall(r"\[cv_lr\] (\S+) -> AUC (\S+)", text)
        print(json.dumps({
            "package": "albedo_tpu_torch (cpu)" if args.port else "albedo_tpu (jax cpu)",
            "weights": "shared" if args.shared else "seeded", "seed": seed,
            "grid": [[col, float(auc)] for col, auc in grid],
        }), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["ranker"]:
        ranker(sys.argv[2:])
    elif sys.argv[1:2] == ["serve"]:
        serve(sys.argv[2:])
    elif sys.argv[1:2] == ["candidates"]:
        candidates(sys.argv[2:])
    elif sys.argv[1:2] == ["two_stage"]:
        two_stage(sys.argv[2:])
    elif sys.argv[1:2] == ["wide_rank"]:
        wide_rank(sys.argv[2:])
    elif sys.argv[1:2] == ["cv_als"]:
        cv_als(sys.argv[2:])
    elif sys.argv[1:2] == ["cv_lr"]:
        cv_lr(sys.argv[2:])
    elif sys.argv[1:2] == ["w2v_shared"]:
        w2v_shared(sys.argv[2:])
    else:
        main(sys.argv[1:])
