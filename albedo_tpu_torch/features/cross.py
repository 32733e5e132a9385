"""User x repo cross features.

Reference parity: ``transformers/UserRepoTransformer.scala:10-50`` +
``closures/UDFs.scala:80-87`` — position and count of the repo's language
within the user's recent-repo-language list.

Host code, copied from ``albedo_tpu/features/cross.py`` with its imports pointed at
the port; the port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from albedo_tpu_torch.features.pipeline import Transformer, col_values, memo_map


class UserRepoTransformer(Transformer):
    def __init__(
        self,
        repo_language_col: str = "repo_language",
        user_languages_col: str = "user_recent_repo_languages",
        not_found_offset: int = 50,
    ):
        self.repo_language_col = repo_language_col
        self.user_languages_col = user_languages_col
        # Miss value = len(list) + 50, as repoLanguageIndexInUserRecentRepoLanguagesUDF.
        self.not_found_offset = not_found_offset

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        self.require_cols(df, [self.repo_language_col, self.user_languages_col])

        def compute(pair) -> tuple[int, int]:
            lang, recent = pair
            lang = (lang or "").lower()
            recent = list(recent) if recent is not None else []
            try:
                index = recent.index(lang)
            except ValueError:
                index = len(recent) + self.not_found_offset
            return index, sum(1 for x in recent if x == lang)

        # (language, recent-list) pairs repeat once per (user, repo) row;
        # memoize per distinct pair like the other per-document transforms.
        results = memo_map(
            zip(
                col_values(df[self.repo_language_col]),
                col_values(df[self.user_languages_col]),
            ),
            compute,
            key=lambda p: (p[0], tuple(p[1]) if p[1] is not None else ()),
        )
        out = df.copy()
        out["repo_language_index_in_user_recent_repo_languages"] = np.fromiter(
            (r[0] for r in results), dtype=np.int32, count=len(results)
        )
        out["repo_language_count_in_user_recent_repo_languages"] = np.fromiter(
            (r[1] for r in results), dtype=np.int32, count=len(results)
        )
        return out
