"""Instance-weight columns for the weighted LR.

Reference parity: the ``SQLTransformer`` weight SQL at
``LogisticRegressionRanker.scala:316-328`` — five variants:

- ``default_weight``                 1.0
- ``positive_weight``                0.9 if starred else 0.1
- ``positive_starred_weight``        0.9 if starred within the last 365 days
- ``positive_created_weight``        0.9 if starred and repo created within 730 days
- ``positive_created_week_weight``   repo-created week number if starred else 1.0

``now`` is injected (the SQL uses ``current_date()``) so tests are
deterministic.

Host code, copied from ``albedo_tpu/features/weights.py`` with its imports pointed at
the port; the port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from albedo_tpu_torch.features.pipeline import Transformer

_DAY = 86400.0
_WEEK = 7 * _DAY

WEIGHT_COLUMNS = (
    "default_weight",
    "positive_weight",
    "positive_starred_weight",
    "positive_created_weight",
    "positive_created_week_weight",
)


class InstanceWeigher(Transformer):
    def __init__(
        self,
        now: float,
        label_col: str = "starring",
        time_col: str = "starred_at",
        repo_created_col: str = "repo_created_at",
    ):
        self.now = float(now)
        self.label_col = label_col
        self.time_col = time_col
        self.repo_created_col = repo_created_col

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        self.require_cols(df, [self.label_col, self.time_col, self.repo_created_col])
        pos = df[self.label_col].to_numpy(np.float64) == 1.0
        starred_days = (self.now - df[self.time_col].to_numpy(np.float64)) / _DAY
        created = df[self.repo_created_col].to_numpy(np.float64)
        created_days = (self.now - created) / _DAY

        out = df.copy()
        out["default_weight"] = 1.0
        out["positive_weight"] = np.where(pos, 0.9, 0.1)
        out["positive_starred_weight"] = np.where(pos & (starred_days <= 365), 0.9, 0.1)
        out["positive_created_weight"] = np.where(pos & (created_days <= 730), 0.9, 0.1)
        out["positive_created_week_weight"] = np.where(pos, np.round(created / _WEEK), 1.0)
        return out
