"""Estimator/Transformer protocol and Pipeline composition.

Reference parity: Spark ML's ``Estimator.fit -> Model`` / ``Transformer.transform``
contract that every albedo stage implements (``recommenders/Recommender.scala:9``
extends ``Transformer``; pipelines assembled at
``LogisticRegressionRanker.scala:227-235``), plus the generic UDF wrapper
``org/apache/spark/ml/feature/FuncTransformer.scala:45-140``.

Tables are pandas DataFrames on the host; fitted state is numpy/python and
picklable.

Host code, copied from ``albedo_tpu/features/pipeline.py`` with its imports
pointed at the port. Left out: ``load_or_create_model`` (the date-keyed
artifact cache, ``ModelUtils.loadOrCreateModel``), because the port has no
artifact cache yet; the port's jobs train in process.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence, TypeVar

import pandas as pd

T = TypeVar("T")


class Transformer:
    """A fitted, stateless-or-fitted-state stage: ``transform(df) -> df``."""

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        raise NotImplementedError

    def __call__(self, df: pd.DataFrame) -> pd.DataFrame:
        return self.transform(df)

    def require_cols(self, df: pd.DataFrame, cols: Sequence[str]) -> None:
        """Runtime schema assertion (the reference's ``transformSchema``
        ``require`` checks, e.g. ``Recommender.scala:46-56``)."""
        missing = [c for c in cols if c not in df.columns]
        if missing:
            raise ValueError(f"{type(self).__name__}: missing input columns {missing}")


class Estimator:
    """An unfitted stage: ``fit(df) -> Transformer``."""

    def fit(self, df: pd.DataFrame) -> Transformer:
        raise NotImplementedError


class FuncTransformer(Transformer):
    """Wrap a per-value function as a column transformer
    (``FuncTransformer.scala:45-140``)."""

    def __init__(self, func: Callable[[Any], Any], input_col: str, output_col: str):
        self.func = func
        self.input_col = input_col
        self.output_col = output_col

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        self.require_cols(df, [self.input_col])
        out = df.copy()
        out[self.output_col] = [self.func(v) for v in col_values(df[self.input_col])]
        return out


def col_values(values):
    """A pandas column as a plain object ndarray for Python-speed iteration.

    Arrow-backed columns box every element on ``Series.__iter__`` (measured
    ~45 s of a 115 s ranker run at profile scale); one vectorized
    ``to_numpy`` conversion up front makes the downstream per-row loops
    cheap. Non-Series inputs pass through unchanged.
    """
    return values.to_numpy(dtype=object) if isinstance(values, pd.Series) else values


def memo_map(values, func: Callable[[Any], T], key: Callable[[Any], Any] | None = None) -> list[T]:
    """Apply ``func`` once per distinct value and map results back by key.

    The ranker's joined row sets repeat each user/repo document once per
    (user, repo) pair, so per-row tokenize/filter/embed work is ~100x
    redundant; memoizing by document collapses it to once per distinct text.
    Repeated rows share the SAME result object — downstream stages treat
    columns as read-only (Spark DataFrame semantics), so aliasing is safe.

    ``key`` maps unhashable values (token lists) to a hashable key (tuple).
    """
    vals = col_values(values)
    # Identity fast path: repeated rows usually ALIAS the same object (pandas
    # merges copy references; upstream memo_map stages return the same result
    # object per distinct input), so id() resolves most rows without
    # building/hashing a semantic key (tuple() over token lists was ~6 s of a
    # 19 s featurize at bench scale). ONLY safe when the container keeps every
    # element alive for the whole loop (a materialized array): for generator
    # inputs CPython recycles freed ids — zip() literally reuses its result
    # tuple — which would alias different rows to one cache slot.
    use_id = getattr(vals, "dtype", None) == object
    cache: dict = {}
    id_cache: dict = {}
    out = []
    sentinel = object()
    for v in vals:
        got = id_cache.get(id(v), sentinel) if use_id else sentinel
        if got is sentinel:
            k = v if key is None else key(v)
            got = cache.get(k, sentinel)
            if got is sentinel:
                got = func(v)
                cache[k] = got
            if use_id:
                id_cache[id(v)] = got
        out.append(got)
    return out


class IntermediateCacher(Transformer):
    """Pipeline stage that snapshots (and optionally column-prunes) the frame
    flowing through it (``transformers/IntermediateCacher.scala:10-40``).

    Spark's ``.cache()`` materializes a lazy plan so later stages don't
    recompute it; pandas frames are already materialized, so the load-bearing
    parts here are the column pruning (``intermediateColumns``) and the
    retained ``.cached`` snapshot — inspectable mid-pipeline for debugging,
    and a cut point that drops columns downstream stages don't need.
    """

    def __init__(self, columns: Sequence[str] | None = None):
        self.columns = list(columns) if columns else None
        self.cached: pd.DataFrame | None = None

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        if self.columns:
            self.require_cols(df, self.columns)
            df = df[self.columns]
        self.cached = df
        return df


class PipelineModel(Transformer):
    """A fitted pipeline: transformers applied in sequence."""

    def __init__(self, stages: list[Transformer]):
        self.stages = stages

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        for stage in self.stages:
            df = stage.transform(df)
        return df

    def __getitem__(self, i: int) -> Transformer:
        return self.stages[i]


class Pipeline(Estimator):
    """Fit stages in order, each transforming the frame the next one sees —
    Spark ``Pipeline.fit`` semantics."""

    def __init__(self, stages: Sequence[Estimator | Transformer]):
        self.stages = list(stages)

    def fit(self, df: pd.DataFrame) -> PipelineModel:
        fitted: list[Transformer] = []
        for stage in self.stages:
            if isinstance(stage, Estimator):
                model = stage.fit(df)
            elif isinstance(stage, Transformer):
                model = stage
            else:
                raise TypeError(f"pipeline stage {stage!r} is neither Estimator nor Transformer")
            df = model.transform(df)
            fitted.append(model)
        return PipelineModel(fitted)

