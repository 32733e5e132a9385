"""Categorical indexing: StringIndexer and frequency binning.

Reference parity: the per-categorical ``StringIndexer().setHandleInvalid("keep")``
+ ``OneHotEncoder`` pairs built for every categorical column INCLUDING
``user_id``/``repo_id`` (``LogisticRegressionRanker.scala:176-188``), and the
frequency-binned company/location categoricals
(``UserProfileBuilder.scala:177-200``). The one-hot step is deliberately
absorbed downstream: an indexed column is consumed by the assembler as an
embedding-style index field, which on TPU is a weight-row gather — numerically
identical to a one-hot dot product without materializing million-wide vectors.

Host code, copied from ``albedo_tpu/features/indexers.py`` with its imports pointed at
the port; the port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pandas as pd

from albedo_tpu_torch.features.assembler import set_vocab_size
from albedo_tpu_torch.features.pipeline import Estimator, Transformer, col_values


class StringIndexerModel(Transformer):
    def __init__(self, input_col: str, output_col: str, labels: list, handle_invalid: str = "keep"):
        self.input_col = input_col
        self.output_col = output_col
        self.labels = list(labels)
        self.handle_invalid = handle_invalid
        self._index = {v: i for i, v in enumerate(self.labels)}

    @property
    def vocab_size(self) -> int:
        """Number of distinct output indices (+1 unknown slot under "keep",
        matching Spark's OneHotEncoder dropLast=false width)."""
        return len(self.labels) + (1 if self.handle_invalid == "keep" else 0)

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        self.require_cols(df, [self.input_col])
        unknown = len(self.labels)
        idx = np.fromiter(
            (self._index.get(v, unknown) for v in col_values(df[self.input_col])),
            dtype=np.int64,
            count=len(df),
        )
        if self.handle_invalid == "error" and (idx == unknown).any():
            bad = df[self.input_col][idx == unknown].iloc[0]
            raise ValueError(f"StringIndexer({self.input_col}): unseen label {bad!r}")
        if self.handle_invalid == "skip":
            out = df[idx != unknown].copy()
            out[self.output_col] = idx[idx != unknown]
        else:
            out = df.copy()
            out[self.output_col] = idx
        set_vocab_size(out, self.output_col, self.vocab_size)
        return out


class StringIndexer(Estimator):
    """Fit labels ordered by frequency desc (ties: value asc), Spark's
    ``frequencyDesc`` default."""

    def __init__(self, input_col: str, output_col: str | None = None, handle_invalid: str = "keep"):
        self.input_col = input_col
        self.output_col = output_col or f"{input_col}__idx"
        self.handle_invalid = handle_invalid

    def fit(self, df: pd.DataFrame) -> StringIndexerModel:
        counts = Counter(df[self.input_col])
        labels = [v for v, _ in sorted(counts.items(), key=lambda kv: (-kv[1], str(kv[0])))]
        return StringIndexerModel(self.input_col, self.output_col, labels, self.handle_invalid)


class FrequencyBinner(Estimator):
    """Replace values seen <= ``threshold`` times with ``__other``
    (``user_binned_company`` / ``user_binned_location``,
    ``UserProfileBuilder.scala:188-195``)."""

    def __init__(self, input_col: str, output_col: str, threshold: int, other: str = "__other"):
        self.input_col = input_col
        self.output_col = output_col
        self.threshold = threshold
        self.other = other

    def fit(self, df: pd.DataFrame) -> "FrequencyBinnerModel":
        counts = Counter(df[self.input_col])
        keep = {v for v, c in counts.items() if c > self.threshold}
        return FrequencyBinnerModel(self.input_col, self.output_col, keep, self.other)


class FrequencyBinnerModel(Transformer):
    def __init__(self, input_col: str, output_col: str, keep: set, other: str):
        self.input_col = input_col
        self.output_col = output_col
        self.keep = keep
        self.other = other

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        self.require_cols(df, [self.input_col])
        out = df.copy()
        out[self.output_col] = [
            v if v in self.keep else self.other
            for v in col_values(df[self.input_col])
        ]
        return out
