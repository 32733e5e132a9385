"""The second-stage logistic-regression ranker: feature pipeline, negative
sampling, weighted LR, candidate fusion, re-ranking.

Reference parity: ``LogisticRegressionRanker.scala:21-447`` (call stack traced
in SURVEY.md §3.2):

1. reduced starring (users with <= maxStarredReposCount stars, :137-149)
2. profile joins (:151-154)
3. ~30-stage feature pipeline (:161-235): cross features, ALS score column,
   StringIndexer per categorical INCLUDING user_id/repo_id, CountVectorizer per
   list column, tokenizer+stopwords+Word2Vec per text column, vector assembly
4. NegativeBalancer on popular-minus-positives (:244-267)
5. weight SQL + weighted LR maxIter=300 regParam=0.7 (:316-350)
6. AUC (:354-364); candidate fusion from ALS+curation+popularity (:368-404);
   re-rank by P(star); NDCG@30 (:430-444)

The feature target is the block ``FeatureMatrix`` (gathers + K8 segment
sums on the card) rather than million-wide one-hot vectors — same math.

Port of ``albedo_tpu/builders/ranker.py``. The LR fit and the scoring run on
the device of the ALS model unless ``device`` says otherwise. The CV weight
grid (``weight_cols``) fits every column in one batched L-BFGS solve
(``LogisticRegression.fit_many``). Not ported: the grid over several devices
(``grid_mesh``) and the row-sharded LR (``lr_mesh``), which raise
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import pandas as pd
import torch

from albedo_tpu_torch.builders.profiles import FeatureColumns
from albedo_tpu_torch.datasets.star_matrix import StarMatrix
from albedo_tpu_torch.datasets.tables import RawTables, popular_repos
from albedo_tpu_torch.evaluators import RankingEvaluator, area_under_roc, user_actual_items, user_items_from_pairs
from albedo_tpu_torch.features import (
    CountVectorizer,
    FeatureAssembler,
    InstanceWeigher,
    NegativeBalancer,
    Pipeline,
    StringIndexer,
    StopWordsRemover,
    Tokenizer,
    Transformer,
    UserRepoTransformer,
)
from albedo_tpu_torch.features.assembler import FeatureAssemblerModel
from albedo_tpu_torch.features.pipeline import PipelineModel
from albedo_tpu_torch.models.als import ALSModel
from albedo_tpu_torch.models.logistic_regression import LogisticRegression, LogisticRegressionModel
from albedo_tpu_torch.models.word2vec import Word2VecModel
from albedo_tpu_torch.recommenders.base import Recommender, fuse_candidates
from albedo_tpu_torch.utils.device import resolve_device
from albedo_tpu_torch.utils.profiling import Timer


class ALSScorer(Transformer):
    """ALSModel as a feature stage: adds ``als_score`` = user.item factor dot.

    Parity: the loaded ``ALSModel`` with ``setPredictionCol("als_score")`` and
    ``coldStartStrategy="drop"`` inside the feature pipeline
    (``LogisticRegressionRanker.scala:167-174``) — rows whose user or repo the
    factorization never saw are DROPPED (both here and at re-rank time).
    """

    def __init__(
        self,
        model: ALSModel,
        matrix: StarMatrix,
        user_col: str = "user_id",
        item_col: str = "repo_id",
        output_col: str = "als_score",
        cold_start: str = "drop",
    ):
        self.model = model
        self.matrix = matrix
        self.user_col = user_col
        self.item_col = item_col
        self.output_col = output_col
        self.cold_start = cold_start

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        self.require_cols(df, [self.user_col, self.item_col])
        rows = self.matrix.users_of(df[self.user_col].to_numpy(np.int64))
        cols = self.matrix.items_of(df[self.item_col].to_numpy(np.int64))
        known = (rows >= 0) & (cols >= 0)
        score = np.zeros(len(df), dtype=np.float32)
        score[known] = self.model.predict(rows[known], cols[known])
        out = df.copy()
        out[self.output_col] = score
        if self.cold_start == "drop":
            out = out[known].reset_index(drop=True)
        return out


@dataclasses.dataclass
class RankerConfig:
    """Hyperparameters, reference defaults in comments."""

    max_starred_repos_count: int = 4000   # :132 (30 in laptop mode)
    negative_positive_ratio: float = 1.0  # :246
    lr_max_iter: int = 300                # :331
    lr_reg_param: float = 0.7             # :332
    weight_col: str = "positive_starred_weight"  # :336
    test_ratio: float = 0.05              # :297 (0.3 in laptop mode)
    n_test_users: int = 200               # :309
    top_k: int = 30                       # :430
    min_df: int = 10                      # CountVectorizer minDF, :195
    max_bag_pad: int = 256
    popular_min_stars: int = 1000         # loadPopularRepoDF range
    popular_max_stars: int = 290_000
    seed: int = 42

    def small(self) -> "RankerConfig":
        """Laptop-mode shrink (the RUN_WITH_INTELLIJ switch, :24-34,133,297)."""
        return dataclasses.replace(
            self, max_starred_repos_count=30, test_ratio=0.3, lr_max_iter=50
        )


@dataclasses.dataclass
class RankerModel:
    """Everything needed to score (user, repo) candidates."""

    feature_pipeline: PipelineModel
    assembler: FeatureAssemblerModel
    lr_model: LogisticRegressionModel
    user_profile: pd.DataFrame
    repo_profile: pd.DataFrame
    auc: float

    def score(self, candidates: pd.DataFrame) -> pd.DataFrame:
        """Join profiles, run the feature pipeline, return candidates with a
        ``probability`` column (cold pairs dropped, as coldStartStrategy)."""
        df = candidates.merge(self.user_profile, on="user_id").merge(
            self.repo_profile, on="repo_id"
        )
        df = self.feature_pipeline.transform(df)
        fm = self.assembler.assemble(df)
        out = df[[c for c in ("user_id", "repo_id", "score", "source") if c in df.columns]].copy()
        out["probability"] = self.lr_model.predict_proba(fm)
        return out


@dataclasses.dataclass
class RankerResult:
    model: RankerModel
    auc: float
    ndcg: float | None
    n_rows: int = 0  # balanced (positive + sampled-negative) training rows
    # Weight-column CV grid results [(weight_col, auc)], best first, when
    # train_ranker ran with weight_cols (LogisticRegressionRankerCV parity).
    grid: list | None = None


def reduce_starring(starring: pd.DataFrame, max_count: int) -> pd.DataFrame:
    """Drop hyperactive users (> max starred repos), :137-149."""
    counts = starring.groupby("user_id")["repo_id"].transform("size")
    return starring[counts <= max_count].reset_index(drop=True)


def build_feature_pipeline(
    als_scorer: ALSScorer,
    user_cols: FeatureColumns,
    repo_cols: FeatureColumns,
    w2v: Word2VecModel,
    min_df: int,
) -> tuple[Pipeline, dict]:
    """The ~30-stage feature pipeline (:161-235). Returns (pipeline, assembler
    column spec): categorical -> StringIndexer; list -> CountVectorizer;
    text -> Tokenizer -> StopWordsRemover -> Word2Vec vector."""
    stages: list = [UserRepoTransformer(), als_scorer]

    categorical = [*user_cols.categorical, *repo_cols.categorical, "user_id", "repo_id"]
    cat_out = []
    for col in categorical:
        stages.append(StringIndexer(col, f"{col}__idx"))
        cat_out.append(f"{col}__idx")

    bag_out = []
    for col in [*user_cols.list_, *repo_cols.list_]:
        stages.append(CountVectorizer(col, f"{col}__cv", min_df=min_df))
        bag_out.append(f"{col}__cv")

    vec_out = []
    for col in [*user_cols.text, *repo_cols.text]:
        # Tokenizer -> StopWordsRemover staging as the reference (:200-216);
        # stop-word removal happens in the remover stage, not both.
        stages.append(Tokenizer(col, f"{col}__words", remove_stop_words=False))
        stages.append(StopWordsRemover(f"{col}__words", f"{col}__filtered"))
        w2v_stage = dataclasses.replace(
            w2v, input_col=f"{col}__filtered", output_col=f"{col}__w2v"
        )
        stages.append(w2v_stage)
        vec_out.append(f"{col}__w2v")

    dense = [
        *user_cols.boolean, *repo_cols.boolean,
        *user_cols.continuous, *repo_cols.continuous,
        "repo_language_index_in_user_recent_repo_languages",
        "repo_language_count_in_user_recent_repo_languages",
        "als_score",
    ]
    spec = {
        "dense_cols": dense,
        "vector_cols": vec_out,
        "cat_cols": {c: None for c in cat_out},
        "bag_cols": {c: None for c in bag_out},
    }
    return Pipeline(stages), spec


def train_ranker(
    tables: RawTables,
    user_profile: pd.DataFrame,
    user_cols: FeatureColumns,
    repo_profile: pd.DataFrame,
    repo_cols: FeatureColumns,
    als_model: ALSModel,
    matrix: StarMatrix,
    w2v: Word2VecModel,
    now: float,
    config: RankerConfig = RankerConfig(),
    recommenders: Sequence[Recommender] | None = None,
    eval_actual: "UserItems | None" = None,
    timer=None,
    weight_cols: Sequence[str] | None = None,
    grid_mesh=None,
    lr_mesh=None,
    device: str | torch.device | None = None,
) -> RankerResult:
    """End-to-end ranker training + evaluation (SURVEY.md §3.2).

    ``timer`` (``albedo_tpu_torch.utils.profiling.Timer``) if given records
    per-stage wall-clock; device stages stop their clock after a device
    synchronize. ``device`` is where the LR trains and scores (default: the
    ALS model's device).

    ``weight_cols`` switches the LR stage into CV-grid mode
    (``LogisticRegressionRankerCV.scala:326-332``): the shared featurized set
    is fit once per weight column in one batched L-BFGS solve, each model
    scored by AUC; the best column's model continues into fusion and NDCG@30
    and the grid is returned best first."""
    if grid_mesh is not None:
        raise NotImplementedError("train_ranker(grid_mesh=...): the multi-GPU CV grid is not ported yet")
    if lr_mesh is not None:
        raise NotImplementedError("train_ranker(lr_mesh=...): the row-sharded LR is not ported yet")
    dev = resolve_device(device if device is not None else als_model.device)
    rng = np.random.default_rng(config.seed)
    if timer is None:
        timer = Timer()

    # 1-2. Reduce + negative-sample + profile joins. The reference featurizes
    # the positives first to FIT the pipeline (:237-240), then transforms the
    # balanced set; vocab-fitting on positives only is preserved here.
    with timer.section("reduce_join"):
        reduced = reduce_starring(tables.starring, config.max_starred_repos_count)
        profile_starring = reduced.merge(user_profile, on="user_id").merge(
            repo_profile, on="repo_id"
        )

    with timer.section("pipeline_fit"):
        als_scorer = ALSScorer(als_model, matrix)
        pipeline, spec = build_feature_pipeline(
            als_scorer, user_cols, repo_cols, w2v, config.min_df
        )
        feature_model = pipeline.fit(profile_starring)

    # 4. Negative balancing on the reduced starring, then profile join +
    # featurize (:244-291).
    with timer.section("negative_balance"):
        pop = popular_repos(
            tables.repo_info, config.popular_min_stars, config.popular_max_stars
        )
        balancer = NegativeBalancer(
            pop["repo_id"].to_numpy(np.int64),
            negative_positive_ratio=config.negative_positive_ratio,
        )
        balanced = balancer.transform(reduced)
        profile_balanced = balanced.merge(user_profile, on="user_id").merge(
            repo_profile, on="repo_id"
        )
    with timer.section("featurize"):
        featured = feature_model.transform(profile_balanced)

    with timer.section("assembler_fit"):
        assembler = FeatureAssembler(**spec, max_bag_pad=config.max_bag_pad).fit(featured)

    # 5. Split, weigh, train LR (:297-350).
    with timer.section("weigh_assemble"):
        is_test = rng.random(len(featured)) < config.test_ratio
        train_df = featured[~is_test].reset_index(drop=True)
        test_df = featured[is_test].reset_index(drop=True)

        weigher = InstanceWeigher(now=now)
        train_w = weigher.transform(train_df)
        fm_train = assembler.assemble(train_w)
    grid = None
    with timer.section("lr_fit", sync=dev):
        lr = LogisticRegression(
            max_iter=config.lr_max_iter, reg_param=config.lr_reg_param, device=dev,
        )
        labels = train_w["starring"].to_numpy(np.float32)
        if not weight_cols:
            lr_model = lr.fit(
                fm_train, labels, sample_weight=train_w[config.weight_col].to_numpy(np.float32),
            )
            first_model = lr_model
        else:
            ws = np.stack([train_w[c].to_numpy(np.float32) for c in weight_cols])
            grid_models = lr.fit_many(fm_train, labels, ws)
            first_model = grid_models[0]
    # The host part of the fit (batch layout, standardization moments,
    # upload) is its own stage, lr_prepare; lr_fit keeps the solve. In grid
    # mode the preparation is shared by the whole solve: it comes from the
    # first model, once.
    timer.totals["lr_fit"] = max(0.0, timer.totals["lr_fit"] - first_model.prep_s)
    timer.totals["lr_prepare"] = timer.totals.get("lr_prepare", 0.0) + first_model.prep_s
    timer.counts["lr_prepare"] = timer.counts.get("lr_prepare", 0) + 1

    # 6a. AUC on the held-out split (:354-364).
    with timer.section("auc_eval", sync=dev):
        fm_test = assembler.assemble(test_df)
        test_labels = test_df["starring"].to_numpy(np.float32)
        if not weight_cols:
            auc = area_under_roc(test_labels, lr_model.predict_proba(fm_test))
        else:
            scored = [
                (col, float(area_under_roc(test_labels, m.predict_proba(fm_test))), m)
                for col, m in zip(weight_cols, grid_models)
            ]
            scored.sort(key=lambda t: -t[1])  # stable: ties keep the column order
            grid = [(col, auc_g) for col, auc_g, _ in scored]
            _, auc, lr_model = scored[0]

    model = RankerModel(
        feature_pipeline=feature_model,
        assembler=assembler,
        lr_model=lr_model,
        user_profile=user_profile,
        repo_profile=repo_profile,
        auc=float(auc),
    )

    # 6b. Candidate fusion + re-rank + NDCG@30 (:368-444).
    ndcg = None
    if recommenders:
        with timer.section("fuse_rerank_ndcg", sync=dev):
            test_users = test_df["user_id"].unique()
            take = min(config.n_test_users, len(test_users))
            sampled = rng.choice(test_users, size=take, replace=False)
            candidates = fuse_candidates(
                [r.recommend_for_users(sampled) for r in recommenders]
            )
            scored = model.score(candidates)
            dense_users = matrix.users_of(scored["user_id"].to_numpy(np.int64))
            predicted = user_items_from_pairs(
                dense_users,
                matrix.items_of(scored["repo_id"].to_numpy(np.int64)),
                order_key=scored["probability"].to_numpy(np.float64),
                k=config.top_k,
            )
            actual = eval_actual if eval_actual is not None else user_actual_items(matrix, k=config.top_k)
            ndcg = RankingEvaluator(metric_name="ndcg@k", k=config.top_k, device=dev).evaluate(
                predicted, actual
            )

    return RankerResult(model=model, auc=float(auc), ndcg=ndcg, n_rows=len(train_df), grid=grid)
