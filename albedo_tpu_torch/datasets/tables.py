"""Raw entity tables: schemas, conforming, and the star-matrix build.

Reference parity: the typed case-class schemas (``schemas/package.scala:4-70``).
This port carries the synthetic-table path of the ``train_als`` job: the
schemas, :func:`conform`, and :class:`RawTables` with the ``policy="off"``
star-matrix build (recency sort, then ``StarMatrix.from_interactions``), and
:func:`popular_repos` for the ranker. The file/sqlite loaders and the
validation firewall are still to be ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pandas as pd

from albedo_tpu_torch.datasets.star_matrix import StarMatrix

# Column -> pandas dtype, mirroring schemas/package.scala. Timestamps are
# float64 epoch seconds (XLA-friendly; formatted only at the display edge).
USER_INFO_SCHEMA: dict[str, str] = {
    "user_id": "int64",
    "user_login": "string",
    "user_account_type": "string",
    "user_name": "string",
    "user_company": "string",
    "user_blog": "string",
    "user_location": "string",
    "user_email": "string",
    "user_bio": "string",
    "user_public_repos_count": "int64",
    "user_public_gists_count": "int64",
    "user_followers_count": "int64",
    "user_following_count": "int64",
    "user_created_at": "float64",
    "user_updated_at": "float64",
}

REPO_INFO_SCHEMA: dict[str, str] = {
    "repo_id": "int64",
    "repo_owner_id": "int64",
    "repo_owner_username": "string",
    "repo_owner_type": "string",
    "repo_name": "string",
    "repo_full_name": "string",
    "repo_description": "string",
    "repo_language": "string",
    "repo_created_at": "float64",
    "repo_updated_at": "float64",
    "repo_pushed_at": "float64",
    "repo_homepage": "string",
    "repo_size": "int64",
    "repo_stargazers_count": "int64",
    "repo_forks_count": "int64",
    "repo_subscribers_count": "int64",
    "repo_is_fork": "bool",
    "repo_has_issues": "bool",
    "repo_has_projects": "bool",
    "repo_has_downloads": "bool",
    "repo_has_wiki": "bool",
    "repo_has_pages": "bool",
    "repo_open_issues_count": "int64",
    "repo_topics": "string",  # comma-separated, as the Django ListTextField stores it
}

STARRING_SCHEMA: dict[str, str] = {
    "user_id": "int64",
    "repo_id": "int64",
    "starred_at": "float64",
    "starring": "float64",
}

RELATION_SCHEMA: dict[str, str] = {
    "from_user_id": "int64",
    "to_user_id": "int64",
    "relation": "string",
}

_FALSY_STRINGS = {"", "0", "false", "f", "no", "n", "none", "null", "nan"}


def _to_bool(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() not in _FALSY_STRINGS
    if v is None or v is pd.NA or (isinstance(v, float) and np.isnan(v)):
        return False
    return bool(v)


def conform(df: pd.DataFrame, schema: dict[str, str], renames: dict[str, str] | None = None) -> pd.DataFrame:
    """Rename + select + cast a raw frame to a schema; missing string columns
    become empty, missing numerics 0 (the builders impute anyway)."""
    if renames:
        df = df.rename(columns={k: v for k, v in renames.items() if k in df.columns})
    out = {}
    for col, dtype in schema.items():
        if col in df.columns:
            s = df[col]
        elif dtype == "string":
            s = pd.Series([""] * len(df))
        elif dtype == "bool":
            s = pd.Series([False] * len(df))
        else:
            s = pd.Series(np.zeros(len(df)))
        if dtype == "string":
            s = s.astype("string").fillna("")
        elif dtype == "bool":
            # CSV/sqlite ingest may carry booleans as strings, 0/1 ints, or
            # nullable dtypes; a bare astype(bool) would turn "false" into True.
            s = pd.Series([_to_bool(v) for v in s], dtype=bool)
        else:
            s = pd.to_numeric(s, errors="coerce").fillna(0).astype(dtype)
        out[col] = s.reset_index(drop=True)
    return pd.DataFrame(out)


@dataclasses.dataclass
class RawTables:
    """The four entity tables every builder consumes (L1 of SURVEY.md §1)."""

    user_info: pd.DataFrame
    repo_info: pd.DataFrame
    starring: pd.DataFrame
    relation: pd.DataFrame

    def conformed(self) -> "RawTables":
        return RawTables(
            user_info=conform(self.user_info, USER_INFO_SCHEMA),
            repo_info=conform(self.repo_info, REPO_INFO_SCHEMA),
            starring=conform(self.starring, STARRING_SCHEMA),
            relation=conform(self.relation, RELATION_SCHEMA),
        )

    def star_matrix(self, policy: str | None = None) -> StarMatrix:
        """The implicit-rating matrix (``loadRawStarringDS`` adds
        ``starring = 1.0``; ``DatasetUtils.scala:111-121``), interactions kept
        in starred_at order so truncation keeps the most recent.

        Only ``policy`` ``None``/``"off"`` (the bare path, no firewall) is
        ported; ``"strict"``/``"repair"`` raise ``NotImplementedError``.
        """
        if policy not in (None, "off"):
            raise NotImplementedError(
                f"data policy {policy!r}: the validation firewall is not ported yet"
            )
        s = self.starring.sort_values("starred_at", kind="stable")
        return StarMatrix.from_interactions(
            raw_users=s["user_id"].to_numpy(np.int64),
            raw_items=s["repo_id"].to_numpy(np.int64),
            vals=np.ones(len(s), dtype=np.float32),
        )


def popular_repos(
    repo_info: pd.DataFrame, min_stars: int = 1000, max_stars: int = 290000
) -> pd.DataFrame:
    """``loadPopularRepoDF`` parity: repos with stars in [1000, 290000], most
    starred first (``utils/DatasetUtils.scala:148-160``)."""
    sel = repo_info[
        repo_info["repo_stargazers_count"].between(min_stars, max_stars)
    ]
    return (
        sel[["repo_id", "repo_stargazers_count", "repo_created_at"]]
        .sort_values("repo_stargazers_count", ascending=False, kind="stable")
        .reset_index(drop=True)
    )
