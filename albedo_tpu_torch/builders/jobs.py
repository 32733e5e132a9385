"""CLI jobs: one per reference entry point (``train_als``, ``train_word2vec``,
``train_lr``, the candidate generators ``popularity``, ``curation``,
``content``, ``item_cf``, ``user_cf``, ``ranking_mf`` and ``tfidf_content``,
``serve``, and the model-selection jobs ``cv_als`` and ``cv_lr`` in this
port).

Reference parity: the ``ALSRecommenderBuilder``, ``Word2VecCorpusBuilder``,
``LogisticRegressionRanker``, ``ALSRecommenderCV``,
``LogisticRegressionRankerCV``, ``PopularityRecommenderBuilder``,
``CurationRecommenderBuilder`` and ``ContentRecommenderBuilder`` mains, and
the legacy trainers ``train_item_cf``, ``train_user_cf``, ``train_graphlab``
and ``train_content_based``. Port of those paths of
``albedo_tpu/builders/jobs.py``: deterministic synthetic tables, the star
matrix (data policy ``off``: the validation firewall is not ported yet), the
ALS fit under the divergence watchdog, top-30 retrieval and NDCG@30; the
profiles, the Word2Vec corpus and fit, and the LR ranker with its AUC and
re-ranked NDCG@30; the candidate sources with their NDCG@30 (the CFs and the
ranking factorization on a held-out split) and the tf-idf similar-repo list;
``serve``, in ALS mode or two-stage (``--two-stage``: popularity and
curation beside the batched ALS source, re-ranked by the LR ranker trained
in process); ``cv_als``, the 2-fold grid over rank x regParam x alpha, and
``cv_lr``, the instance-weight columns fit as one batched L-BFGS solve.

Evaluation protocol matches the builders: train on the FULL star matrix,
sample test users (+ the canary user), recommend top-30, and score NDCG@30
against each user's most recent 30 stars (``ALSRecommenderBuilder.scala:60-105``).
The port has no artifact cache yet, so the ALS and Word2Vec models a job
needs are trained in process, once per :class:`JobContext`. Not ported yet:
the ``--tables`` sources (so ``cv_als`` always takes the grid the JAX job
takes without them), the artifact cache, checkpointed fits (the CLI has no
``--checkpoint-every``, so no ``cv_als`` fit is checkpointed) and mesh fits,
``serve --bank/--reload-watch``, and the other jobs (the profile,
``build_bank``, scoring and streaming jobs).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import pandas as pd

from albedo_tpu_torch.builders.profiles import VINTA_USER_ID, build_repo_profile, build_user_profile
from albedo_tpu_torch.builders.ranker import RankerConfig, train_ranker
from albedo_tpu_torch.datasets import random_split_by_user, sample_test_users, synthetic_tables
from albedo_tpu_torch.datasets.ragged import padded_rows
from albedo_tpu_torch.datasets.tables import RawTables, popular_repos
from albedo_tpu_torch.evaluators import RankingEvaluator, UserItems, user_actual_items, user_items_from_pairs
from albedo_tpu_torch.features.text import StopWordsRemover, Tokenizer
from albedo_tpu_torch.models.als import ALSModel, ImplicitALS
from albedo_tpu_torch.models.ranking_factorization import RankingFactorization
from albedo_tpu_torch.models.word2vec import Word2Vec, Word2VecModel
from albedo_tpu_torch.recommenders import (
    ALSRecommender,
    ContentRecommender,
    CurationRecommender,
    EmbeddingSearchBackend,
    ItemCFRecommender,
    PopularityRecommender,
    TfidfSimilaritySearch,
    UserCFRecommender,
)
from albedo_tpu_torch.utils.device import resolve_device
from albedo_tpu_torch.utils.params import explain_params
from albedo_tpu_torch.utils.profiling import Timer
from albedo_tpu_torch.utils.watchdog import guarded_fit

TOP_K = 30
ALS_REG = ImplicitALS.reg_param
ALS_ALPHA = ImplicitALS.alpha
# The grid the JAX cv_als job takes with ``--tables`` (13 iterations, 2
# folds). ``cv_als_job`` has no table sources yet; ``chip_smoke.py`` and
# ``kernels/als_partials_bench.py wide`` run it on the train_als tables.
CV_ALS_TABLES_GRID = {"rank": [50, 100], "reg_param": [0.01, 0.5], "alpha": [0.01, 40.0]}


def shared_als_init(n_users: int, n_items: int, rank: int, seed: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """ALS factors of the shared numpy init (``jax_reference_ndcg.py
    --shared``), users' then items': ``default_rng(seed)`` Gaussians scaled
    by 1 / sqrt(rank), so both packages' fits start from the same values."""
    rng = np.random.default_rng(seed)
    s = np.float32(1 / np.sqrt(rank))
    return ((rng.standard_normal((n_users, rank)) * s).astype(np.float32),
            (rng.standard_normal((n_items, rank)) * s).astype(np.float32))


class JobContext:
    """Shared lazily-built products for one CLI invocation."""

    def __init__(self, args: argparse.Namespace, tables: RawTables | None = None):
        self.args = args
        self.small = bool(getattr(args, "small", False))
        now = getattr(args, "now", None)
        self.now = float(now) if now is not None else time.time()
        self.device = resolve_device(getattr(args, "device", None) or "cuda")
        # Wall-clock of the job's stages (model fits, ranker stages).
        self.timer = Timer()
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
            with self.timer.section("als_fit", sync=self.device):
                model, trips = guarded_fit(est, self.matrix())
            self._cache["als"] = model
            self._cache["als_report"] = dict(est.last_fit_report, watchdog_trips=trips)
        return self._cache["als"]  # type: ignore[return-value]

    def curators(self) -> tuple[int, ...]:
        """The ranker's curation source: the five most active users (the
        reference's hard-coded curator ids do not exist in synthetic data)."""
        star = self.tables().starring
        return tuple(star["user_id"].value_counts().index[:5].tolist())

    def star_range(self) -> tuple[int, int]:
        """Popular/profile star windows (the reference's GitHub-scale window
        applies only to real tables, which the port does not load yet)."""
        return (1, 10**9)

    def profiles(self):
        """``(user_profile, user_cols, repo_profile, repo_cols)``."""
        if "profiles" not in self._cache:
            lo, hi = self.star_range()
            up, uc = build_user_profile(self.tables(), now=self.now)
            rp, rc = build_repo_profile(
                self.tables(), now=self.now, min_stars=max(1, lo // 30), max_stars=hi,
                language_bin_threshold=3,
            )
            self._cache["profiles"] = (up, uc, rp, rc)
        return self._cache["profiles"]

    def word2vec_corpus(self) -> list[list[str]]:
        """The reference's W2V corpus (``Word2VecCorpusBuilder.scala:47-69``):
        ``concat_ws(", ", login/name/bio/company/location)`` per user union
        ``concat_ws(", ", owner/name/language/description/topics)`` per repo,
        through the same Tokenizer -> StopWordsRemover stages as the ranker's
        feature pipeline."""
        tables = self.tables()

        def concat_ws(df, cols: list[str]):
            parts = [df[c].fillna("").astype(str) for c in cols]
            out = parts[0]
            for p in parts[1:]:
                out = out + ", " + p
            return out

        user_text = concat_ws(
            tables.user_info,
            ["user_login", "user_name", "user_bio", "user_company", "user_location"],
        )
        repo_text = concat_ws(
            tables.repo_info,
            ["repo_owner_username", "repo_name", "repo_language", "repo_description", "repo_topics"],
        )
        corpus_df = pd.DataFrame({"text": list(user_text) + list(repo_text)})
        staged = StopWordsRemover("text__words", "text__filtered").transform(
            Tokenizer("text", "text__words", remove_stop_words=False).transform(corpus_df)
        )
        return list(staged["text__filtered"])

    def word2vec_estimator(self) -> Word2Vec:
        """The configured (untrained) Word2Vec: the reference config (dim
        200, 30 epochs, ``Word2VecCorpusBuilder.scala:74-83``) when
        ``args.w2v_full`` is set, else dim 16 x 3 epochs."""
        full = bool(getattr(self.args, "w2v_full", False))
        dim, iters = (200, 30) if full else (16, 3)
        return Word2Vec(
            dim=dim, min_count=3 if self.small else 10, max_iter=iters, subsample=0.0,
            device=self.device,
        )

    def word2vec(self) -> Word2VecModel:
        """The fitted Word2Vec, trained in process once per context."""
        if "w2v" not in self._cache:
            est = self.word2vec_estimator()
            corpus = self.word2vec_corpus()
            with self.timer.section("w2v_fit", sync=self.device):
                self._cache["w2v"] = est.fit_corpus(corpus)
            self._cache["w2v_report"] = getattr(est, "last_fit_report", None)
        return self._cache["w2v"]  # type: ignore[return-value]

    def ranker_model(self):
        """The trained LR :class:`~albedo_tpu_torch.builders.ranker.RankerModel`
        for online re-ranking (``serve --two-stage``), trained in process on
        the context's device once per context (the JAX context memoizes it
        the same way: the model holds live pipeline stages)."""
        if "ranker" not in self._cache:
            up, uc, rp, rc = self.profiles()
            lo, hi = self.star_range()
            config = RankerConfig(
                popular_min_stars=lo, popular_max_stars=hi,
                min_df=3 if self.small else 10,
            )
            if self.small:
                config = config.small()
            result = train_ranker(
                self.tables(), up, uc, rp, rc, self.als_model(), self.matrix(),
                self.word2vec(), now=self.now, config=config, timer=self.timer,
                device=self.device,
            )
            print(f"[serve] ranker trained: AUC = {result.auc:.4f}", flush=True)
            self._cache["ranker"] = result.model
            self._cache["ranker_auc"] = float(result.auc)
        return self._cache["ranker"]

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


def train_word2vec_job(args) -> None:
    """``Word2VecCorpusBuilder`` (explainParams dump parity, :85)."""
    t0 = time.time()
    ctx = JobContext(args)
    print(f"[train_word2vec] {explain_params(ctx.word2vec_estimator())}")
    model = ctx.word2vec()
    report = ctx._cache.get("w2v_report")
    if report:
        print(f"[train_word2vec] pairs = {report['pairs']}, steps = {report['steps']}, "
              f"final epoch loss = {report['epoch_loss'][-1]}, compile = {report['compile_s']:.4f}s")
    _report("train_word2vec", "vocab", float(len(model.vocab)), t0)


def train_lr_job(args) -> None:
    """``LogisticRegressionRanker`` (AUC gate 0.9425, NDCG@30 gate 0.0211)."""
    t0 = time.time()
    ctx = JobContext(args)
    up, uc, rp, rc = ctx.profiles()
    als = ctx.als_model()
    lo, hi = ctx.star_range()
    config = RankerConfig(popular_min_stars=lo, popular_max_stars=hi, min_df=3 if ctx.small else 10)
    if ctx.small:
        config = config.small()
    star = ctx.tables().starring
    recs = [
        ALSRecommender(als, ctx.matrix(), top_k=60),
        CurationRecommender(star, curator_ids=ctx.curators(), top_k=TOP_K),
        PopularityRecommender(popular_repos(ctx.tables().repo_info, lo, hi), top_k=TOP_K),
    ]
    result = train_ranker(
        ctx.tables(), up, uc, rp, rc, als, ctx.matrix(), ctx.word2vec(),
        now=ctx.now, config=config, recommenders=recs, timer=ctx.timer, device=ctx.device,
    )
    lr_model = result.model.lr_model
    print(f"[train_lr] lbfgs iterations = {lr_model.n_iter_run}, final loss = {lr_model.train_loss}")
    print(f"[train_lr] stages = {json.dumps({k: round(v, 4) for k, v in ctx.timer.totals.items()})}")
    print(f"[train_lr] areaUnderROC = {result.auc}")
    _report("train_lr", "NDCG@30", result.ndcg or 0.0, t0)


def cv_als_job(args) -> None:
    """``ALSRecommenderCV`` — 2-fold grid over rank x regParam x alpha.

    The grid the JAX job takes without ``--tables`` (the port has no table
    sources yet): rank [8, 16] x regParam [0.1, 0.5] x alpha [1, 40], 6
    iterations under ``--small`` and 13 otherwise; each fold scored by the
    NDCG@30 of 150 sampled test users' top 30 against the fold's test stars,
    as the JAX job scores it. No fit is checkpointed (no ``--checkpoint-every``
    in this CLI)."""
    from albedo_tpu_torch.cv import cross_validate, param_grid

    t0 = time.time()
    ctx = JobContext(args)
    grid = param_grid(rank=[8, 16], reg_param=[0.1, 0.5], alpha=[1.0, 40.0])
    iters = 6 if ctx.small else 13
    solver, cg_steps = ctx.als_solver()

    def fit(params, train):
        est = ImplicitALS(max_iter=iters, solver=solver, cg_steps=cg_steps, device=ctx.device, **params)
        return est.fit(train)

    results = cross_validate(fit, cv_als_evaluate, ctx.matrix(), grid, n_folds=2, verbose=True)
    best = results[0]
    print(f"[cv_als] best params = {best.params}")
    _report("cv_als", "NDCG@30", best.mean_metric, t0)


def cv_als_evaluate(model: ALSModel, train, test) -> float:
    """``cv_als``'s fold metric: NDCG@30 of 150 test users sampled from the
    fold's test stars, their top 30 from ``model`` (seen items kept, as the
    JAX job's ``ALSRecommender``) against their 30 most recent test stars."""
    users = sample_test_users(test, n=150)
    rec_frame = ALSRecommender(model, train, top_k=TOP_K).recommend_for_users(train.user_ids[users])
    predicted = user_items_from_pairs(
        train.users_of(rec_frame["user_id"].to_numpy(np.int64)),
        train.items_of(rec_frame["repo_id"].to_numpy(np.int64)),
        order_key=rec_frame["score"].to_numpy(np.float64),
        k=TOP_K,
    )
    return RankingEvaluator(metric_name="ndcg@k", k=TOP_K).evaluate(
        predicted, user_actual_items(test, k=TOP_K)
    )


def cv_lr_job(args) -> None:
    """``LogisticRegressionRankerCV`` — grid over instance-weight columns.

    The featurized set is built once and the five weight-column LR fits run
    as one batched L-BFGS solve (``LogisticRegression.fit_many``), the
    reference CV's materialize-once-then-grid structure
    (``LogisticRegressionRankerCV.scala:275-288,326-332``)."""
    from albedo_tpu_torch.features.weights import WEIGHT_COLUMNS

    t0 = time.time()
    ctx = JobContext(args)
    up, uc, rp, rc = ctx.profiles()
    als = ctx.als_model()
    lo, hi = ctx.star_range()
    config = RankerConfig(
        popular_min_stars=lo, popular_max_stars=hi,
        min_df=3 if ctx.small else 10, lr_max_iter=60 if ctx.small else 300,
    )
    if ctx.small:
        config = config.small()
    r = train_ranker(
        ctx.tables(), up, uc, rp, rc, als, ctx.matrix(), ctx.word2vec(),
        now=ctx.now, config=config, weight_cols=WEIGHT_COLUMNS, timer=ctx.timer, device=ctx.device,
    )
    for weight_col, auc in r.grid:
        print(f"[cv_lr] {weight_col} -> AUC {auc:.6f}")
    best = r.grid[0]
    print(f"[cv_lr] best weight column = {best[0]}")
    _report("cv_lr", "AUC", best[1], t0)


def popularity_job(args) -> None:
    """``PopularityRecommenderBuilder`` (NDCG@30 gate 0.00202)."""
    t0 = time.time()
    ctx = JobContext(args)
    lo, hi = ctx.star_range()
    rec = PopularityRecommender(popular_repos(ctx.tables().repo_info, lo, hi), top_k=TOP_K)
    users = ctx.matrix().user_ids[ctx.test_user_dense()]
    ndcg = ctx.evaluate_topk(rec.recommend_for_users(users))
    _report("popularity", "NDCG@30", ndcg, t0)


def curation_job(args) -> None:
    """``CurationRecommenderBuilder`` (NDCG@30 gate 0.00319)."""
    t0 = time.time()
    ctx = JobContext(args)
    rec = CurationRecommender(ctx.tables().starring, curator_ids=ctx.curators(), top_k=TOP_K)
    users = ctx.matrix().user_ids[ctx.test_user_dense()]
    ndcg = ctx.evaluate_topk(rec.recommend_for_users(users))
    _report("curation", "NDCG@30", ndcg, t0)


def content_job(args) -> None:
    """``ContentRecommenderBuilder`` — the embedding MLT backend (K5 at the
    Word2Vec width)."""
    t0 = time.time()
    ctx = JobContext(args)
    backend = EmbeddingSearchBackend(ctx.tables().repo_info, ctx.word2vec(), device=ctx.device)
    rec = ContentRecommender(
        backend, ctx.tables().starring, top_k=TOP_K, enable_evaluation_mode=True
    )
    users = ctx.matrix().user_ids[ctx.test_user_dense(100)]
    ndcg = ctx.evaluate_topk(rec.recommend_for_users(users))
    _report("content", "NDCG@30", ndcg, t0)


def _holdout_cf_ndcg(ctx: JobContext, rec_cls) -> float:
    """NDCG@30 for the memory-based CFs under a held-out split.

    The CF recommenders drop the user's own stars from the ranked list
    (``train_item_cf.py:38`` behavior), so the full-matrix protocol the other
    builders use would score an exact 0 by construction; they are evaluated
    on held-out stars instead: fit on the train split, recommend with train
    stars excluded, score against each user's held-out items."""
    matrix = ctx.matrix()
    train, test = random_split_by_user(matrix, test_ratio=0.1, seed=42)
    rec = rec_cls(train, top_k=TOP_K, device=ctx.device)
    users_dense = sample_test_users(test, n=250, seed=42)
    frame = rec.recommend_for_users(matrix.user_ids[users_dense])
    predicted = user_items_from_pairs(
        matrix.users_of(frame["user_id"].to_numpy(np.int64)),
        matrix.items_of(frame["repo_id"].to_numpy(np.int64)),
        order_key=frame["score"].to_numpy(np.float64),
        k=TOP_K,
    )
    actual = user_actual_items(test, k=TOP_K)
    return RankingEvaluator(metric_name="ndcg@k", k=TOP_K).evaluate(predicted, actual)


def item_cf_job(args) -> None:
    """``train_item_cf`` legacy-trainer parity: item-item cosine CF, NDCG@30
    on a held-out split (K11)."""
    t0 = time.time()
    ndcg = _holdout_cf_ndcg(JobContext(args), ItemCFRecommender)
    _report("item_cf", "NDCG@30", ndcg, t0)


def user_cf_job(args) -> None:
    """``train_user_cf`` legacy-trainer parity: user-user dice CF, NDCG@30 on
    a held-out split (K11)."""
    t0 = time.time()
    ndcg = _holdout_cf_ndcg(JobContext(args), UserCFRecommender)
    _report("user_cf", "NDCG@30", ndcg, t0)


def item_side_features(ctx: JobContext, matrix) -> np.ndarray:
    """Per-repo activity side features, standardized: log1p of the star and
    fork counts, in ``matrix.item_ids`` order (I, 2) float32."""
    repo = ctx.tables().repo_info.set_index("repo_id").reindex(matrix.item_ids)
    side = np.stack(
        [
            np.log1p(repo["repo_stargazers_count"].fillna(0).to_numpy(np.float64)),
            np.log1p(repo["repo_forks_count"].fillna(0).to_numpy(np.float64)),
        ],
        axis=1,
    )
    side = (side - side.mean(axis=0)) / np.maximum(side.std(axis=0), 1e-9)
    return side.astype(np.float32)


def ranking_mf_job(args) -> None:
    """``train_graphlab`` legacy-trainer parity: ranking factorization on the
    binary star matrix (binary_target=True, split by user, top-k with known
    items excluded — ``train_graphlab.py:23-34``), with repo side features
    (log-stars/forks) as the linear side-data term; NDCG@30 on the held-out
    split (K10 to train, K5 at rank + 1 to retrieve)."""
    t0 = time.time()
    ctx = JobContext(args)
    matrix = ctx.matrix()
    train, test = random_split_by_user(matrix, test_ratio=0.2, seed=42)
    mf = RankingFactorization(
        rank=16 if ctx.small else 32, epochs=5 if ctx.small else 10,
        batch_size=1024 if ctx.small else 8192, device=ctx.device,
    )
    with ctx.timer.section("ranking_mf_fit", sync=ctx.device):
        model = mf.fit(train, item_side=item_side_features(ctx, matrix))
    report = mf.last_fit_report
    print(f"[ranking_mf] steps = {report['steps']}, final epoch loss = {report['epoch_loss'][-1]}, "
          f"fit = {ctx.timer.totals['ranking_mf_fit']:.4f}s, compile = {report['compile_s']:.4f}s")
    users_dense = sample_test_users(test, n=250, seed=42)
    indptr, cols_arr, _ = train.csr()
    excl = padded_rows(indptr, cols_arr, users_dense)
    _, idx = model.recommend(users_dense, k=TOP_K, exclude_idx=excl)
    predicted = UserItems(users=users_dense, items=idx.astype(np.int32))
    ndcg = RankingEvaluator(metric_name="ndcg@k", k=TOP_K).evaluate(
        predicted, user_actual_items(test, k=TOP_K)
    )
    _report("ranking_mf", "NDCG@30", ndcg, t0)


def tfidf_content_job(args) -> None:
    """``train_content_based`` legacy-trainer parity: tf-idf similar-repo
    search (K5 at the vocabulary's width). Prints the most-similar repos for
    the most-starred repo and reports the indexed-corpus size."""
    t0 = time.time()
    ctx = JobContext(args)
    repo = ctx.tables().repo_info
    search = TfidfSimilaritySearch(min_df=2, device=ctx.device).fit(repo)
    top_repo = repo.sort_values("repo_stargazers_count", ascending=False).iloc[0]
    for score, name in search.similar(str(top_repo["repo_full_name"]), k=10):
        print(f"[tfidf_content] {score:.4f} {name}")
    _report("tfidf_content", "indexed_repos", float(len(search.doc_ids)), t0)


def serve_job(args) -> int | None:
    """The online inference engine over the in-process ALS fit: micro-batched
    top-k (K6), the direct path (K5) under ``--no-batch``, the optional
    two-stage candidate fan-out + LR re-rank, the TTL result cache, overload
    control and the ``/metrics`` plane (``albedo_tpu_torch.serving``), until
    ``--duration`` seconds pass (0 = forever) or SIGTERM/SIGINT, which drain
    it as the JAX job does.

    Extra flags: --port N (default 8080), --host ADDR (default 127.0.0.1),
    --duration SECONDS, --no-batch, --no-warm (skip launching the batch-shape
    ladder at startup), --two-stage (register the popularity + curation
    candidate sources and train the LR ranker in process for online
    re-ranking; the ALS source rides the batcher), --cache-ttl SECONDS
    (default 30; 0 disables), --max-batch N (default 64), --window-ms MS
    (default 2). Not ported yet, each an error (exit 2): --bank,
    --reload-watch (and its --reload-interval, --reload-require-stamp), and
    the SIGHUP reload, on which the server drains and exits 2.
    """
    import signal
    import sys
    import threading

    from albedo_tpu_torch.serving import RecommendationService, serve

    extra = argparse.ArgumentParser(prog="albedo-tpu-torch serve")
    extra.add_argument("--port", type=int, default=8080)
    extra.add_argument("--host", default="127.0.0.1")
    extra.add_argument("--duration", type=float, default=0.0)
    extra.add_argument("--no-batch", action="store_true")
    extra.add_argument("--no-warm", action="store_true")
    extra.add_argument("--cache-ttl", type=float, default=30.0)
    extra.add_argument("--max-batch", type=int, default=64)
    extra.add_argument("--window-ms", type=float, default=2.0)
    extra.add_argument("--two-stage", action="store_true")
    for flag in ("--bank", "--reload-watch", "--reload-require-stamp"):
        extra.add_argument(flag, action="store_true")
    extra.add_argument("--reload-interval", type=float, default=None)
    ns = extra.parse_args(getattr(args, "_rest", []))
    missing = [f for f, on in (("--bank", ns.bank),
                               ("--reload-watch", ns.reload_watch),
                               ("--reload-interval", ns.reload_interval is not None),
                               ("--reload-require-stamp", ns.reload_require_stamp)) if on]
    if missing:
        extra.error(f"{', '.join(missing)}: not ported yet (the port serves the ALS and "
                    "two-stage paths)")

    ctx = JobContext(args)
    recommenders = ranker = None
    if ns.two_stage:
        lo, hi = ctx.star_range()
        curators = ctx.curators()
        recommenders = {
            "popularity": PopularityRecommender(
                popular_repos(ctx.tables().repo_info, lo, hi), top_k=TOP_K
            ),
            "curation": CurationRecommender(
                ctx.tables().starring, **({"curator_ids": curators} if curators else {}),
                top_k=TOP_K,
            ),
        }
        ranker = ctx.ranker_model()
    service = RecommendationService(
        ctx.als_model(), ctx.matrix(),
        repo_info=ctx.tables().repo_info, user_info=ctx.tables().user_info,
        recommenders=recommenders, ranker=ranker,
        batching=not ns.no_batch, warm=not ns.no_batch and not ns.no_warm,
        cache_ttl=ns.cache_ttl, max_batch=ns.max_batch, batch_window_ms=ns.window_ms,
    )
    server = serve(service, host=ns.host, port=ns.port)
    host, port = server.server_address[:2]
    print(f"[serve] listening on http://{host}:{port}/ "
          f"(/recommend/<user_id>, /admin/repos, /admin/users, /metrics, /healthz/ready) "
          f"[{'two-stage' if ns.two_stage else 'als'}, batching={'off' if ns.no_batch else 'on'}, "
          f"cache_ttl={ns.cache_ttl:g}s, "
          f"device={ctx.device}]", flush=True)
    # Signal-interruptible foreground wait: SIGTERM/SIGINT set the stop event
    # and the finally block drains (batcher drained, server thread joined).
    stop = threading.Event()
    status = {"rc": None}

    def _sigstop(_sig, _frame):
        stop.set()
        # A second signal can still kill a wedged shutdown.
        for s in (signal.SIGTERM, signal.SIGINT):
            signal.signal(s, signal.SIG_DFL)

    def _sighup(_sig, _frame):
        print("[serve] SIGHUP reload is not ported yet; draining and exiting", file=sys.stderr, flush=True)
        status["rc"] = 2
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, _sigstop)
    if hasattr(signal, "SIGHUP"):
        signal.signal(signal.SIGHUP, _sighup)
    try:
        stop.wait(ns.duration if ns.duration > 0 else None)
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return status["rc"]


JOBS = {
    "train_als": train_als_job, "train_word2vec": train_word2vec_job, "train_lr": train_lr_job,
    "popularity": popularity_job, "curation": curation_job, "content": content_job,
    "item_cf": item_cf_job, "user_cf": user_cf_job, "ranking_mf": ranking_mf_job,
    "tfidf_content": tfidf_content_job, "serve": serve_job, "cv_als": cv_als_job, "cv_lr": cv_lr_job,
}
