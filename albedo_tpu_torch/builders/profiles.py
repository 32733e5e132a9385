"""User and repo profile ETL.

Reference parity: ``UserProfileBuilder.scala:12-230`` and
``RepoProfileBuilder.scala:10-179`` — impute, clean, keyword flags, ratios,
date diffs, per-user recent top-50 lists, frequency binning. Host-side
pandas/numpy (the reference runs this on Spark executors; it is dataframe ETL,
not device compute — SURVEY.md §7 step 7). Each profile also returns its
feature-bucket column lists (boolean/continuous/categorical/list/text), the
five buckets the builders track (``UserProfileBuilder.scala:45-49``) and the
ranker's feature pipeline consumes.

``now`` is an explicit epoch-seconds argument everywhere the reference calls
``current_date()``, keeping artifacts and tests deterministic.

Host code, copied from ``albedo_tpu/builders/profiles.py`` with its imports pointed at
the port; the port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pandas as pd

from albedo_tpu_torch.datasets.tables import RawTables
from albedo_tpu_torch.features.indexers import FrequencyBinner
from albedo_tpu_torch.text import clean_company, clean_location

_DAY = 86400.0

# Bio keyword groups (UserProfileBuilder.scala:84-98). The reference matches
# with SQL LIKE '%kw%' via Column.like.
_USER_KEYWORD_FLAGS = {
    "user_knows_web": ["web", "fullstack", "full stack"],
    "user_knows_backend": ["backend", "back end", "back-end"],
    "user_knows_frontend": ["frontend", "front end", "front-end"],
    "user_knows_mobile": ["mobile", "ios", "android"],
    "user_knows_devops": ["devops", "sre", "admin", "infrastructure"],
    "user_knows_data": ["machine learning", "deep learning", "data scien", "data analy"],
    "user_knows_recsys": ["data mining", "recommend", "information retrieval"],
    "user_is_lead": ["team lead", "architect", "creator", "director", "cto", "vp of engineering"],
    "user_is_scholar": ["researcher", "scientist", "phd", "professor"],
    "user_is_freelancer": ["freelance"],
    "user_is_junior": ["junior", "beginner", "newbie"],
    "user_is_pm": ["product manager"],
}

# Repo description filters (RepoProfileBuilder.scala:80-98).
_UNMAINTAINED_WORDS = [
    "unmaintained", "no longer maintained", "no longer actively maintained",
    "not maintained", "not actively maintained", "deprecated", "moved to",
]
_ASSIGNMENT_WORDS = ["assignment", "作業", "作业"]
_DEMO_WORDS_EXACT = ["test"]   # LIKE 'test' (no wildcards) = exact match
_DEMO_WORDS = ["demo project"]
_BLOG_WORDS_EXACT = ["my blog"]

VINTA_USER_ID = 652070  # the smoke-canary user (ALSRecommenderBuilder.scala:68)


@dataclasses.dataclass
class FeatureColumns:
    """The five feature buckets a profile contributes."""

    boolean: list[str]
    continuous: list[str]
    categorical: list[str]
    list_: list[str]
    text: list[str]

    def all(self) -> list[str]:
        return self.boolean + self.continuous + self.categorical + self.list_ + self.text


def plain_columns(df: pd.DataFrame) -> pd.DataFrame:
    """Materialize extension-backed columns as plain numpy-dtype columns.

    Arrow-backed columns pay a boxed per-element cost in every downstream
    merge ``take`` and Python iteration; the ranker merges each profile into
    the row set several times (measured 3x faster merges with plain object
    columns at bench scale). Numeric/bool extension columns become their
    numpy equivalents; everything else becomes object.
    """
    out = df.copy()
    for c in out.columns:
        dt = out[c].dtype
        if isinstance(dt, np.dtype):
            continue
        if pd.api.types.is_bool_dtype(dt):
            # NA -> False is intended for the profile flag columns: the
            # reference imputes nulls to "" BEFORE computing its LIKE-based
            # keyword flags (UserProfileBuilder.scala:60-66), so a missing
            # source value is a False flag, not a missing flag.
            out[c] = out[c].to_numpy(dtype=bool, na_value=False)
        elif pd.api.types.is_integer_dtype(dt):
            # Preserve missingness: nullable ints with NAs become float64/NaN
            # (pandas' classic promotion) rather than a fake 0.
            if out[c].isna().any():
                out[c] = out[c].to_numpy(dtype=np.float64, na_value=np.nan)
            else:
                out[c] = out[c].to_numpy(dtype=np.int64)
        elif pd.api.types.is_float_dtype(dt):
            out[c] = out[c].to_numpy(dtype=np.float64, na_value=np.nan)
        else:
            arr = out[c].to_numpy(dtype=object)
            # Arrow LIST columns box each element as an ndarray; keep the
            # list-of-str semantics downstream code (and Spark parity) expects.
            # Full scan, not a first-element sniff: a leading null must not
            # skip conversion for the rest of the column.
            if any(isinstance(v, np.ndarray) for v in arr):
                fixed = np.empty(len(arr), dtype=object)
                fixed[:] = [
                    v.tolist() if isinstance(v, np.ndarray) else v for v in arr
                ]
                arr = fixed
            out[c] = arr
    return out


def _contains_any(series: pd.Series, words: list[str]) -> np.ndarray:
    low = series.str.lower()
    hit = np.zeros(len(series), dtype=bool)
    for w in words:
        hit |= low.str.contains(w, regex=False).to_numpy(dtype=bool)
    return hit


def build_user_profile(
    tables: RawTables,
    now: float,
    recent_k: int = 50,
    company_bin_threshold: int = 5,
    location_bin_threshold: int = 50,
) -> tuple[pd.DataFrame, FeatureColumns]:
    """``UserProfileBuilder`` parity; returns (profile frame, feature buckets).

    Users with no starrings are dropped by the inner joins on the
    starred-count/recent-list aggregations, exactly like the reference's
    ``join(..., Seq("user_id"))`` chain (:146-152).
    """
    u = tables.user_info.copy()
    s = tables.starring
    r = tables.repo_info

    # Impute (the conformed schema already coerces null strings to "", so the
    # has-null flag keys off emptiness of the nullable columns).
    nullable = ["user_name", "user_company", "user_blog", "user_location", "user_bio"]
    u["user_has_null"] = (u[nullable] == "").any(axis=1)

    # Clean.
    u["user_clean_company"] = [clean_company(x) for x in u["user_company"]]
    u["user_clean_location"] = [clean_location(x) for x in u["user_location"]]
    u["user_clean_bio"] = u["user_bio"].str.lower()

    # Keyword flags.
    for col, words in _USER_KEYWORD_FLAGS.items():
        u[col] = _contains_any(u["user_clean_bio"], words)

    # Ratios / datediffs.
    u["user_followers_following_ratio"] = np.round(
        u["user_followers_count"] / (u["user_following_count"] + 1.0), 3
    )
    u["user_days_between_created_at_today"] = np.floor(
        (now - u["user_created_at"]) / _DAY
    )
    u["user_days_between_updated_at_today"] = np.floor(
        (now - u["user_updated_at"]) / _DAY
    )

    # Starred-repos count + per-user recent top-k lists over starred repos
    # (rank() over starred_at desc <= 50; UserProfileBuilder.scala:104-125).
    sr = s.merge(r, on="repo_id", how="inner")
    sr = sr.sort_values(["user_id", "starred_at"], ascending=[True, False], kind="stable")
    counts = s.groupby("user_id").size().rename("user_starred_repos_count")

    recent = sr.groupby("user_id", sort=False).head(recent_k)
    langs = recent.groupby("user_id")["repo_language"].agg(
        lambda col: [x.lower() for x in col]
    ).rename("user_recent_repo_languages")

    with_topics = recent[recent["repo_topics"] != ""]
    topics = with_topics.groupby("user_id")["repo_topics"].agg(
        lambda col: ",".join(x.lower() for x in col).split(",")
    ).rename("user_recent_repo_topics")

    with_desc = recent[recent["repo_description"] != ""]
    descs = with_desc.groupby("user_id")["repo_description"].agg(
        lambda col: " ".join(x.lower() for x in col)
    ).rename("user_recent_repo_descriptions")

    u = (
        u.merge(counts, on="user_id", how="inner")
        .merge(descs, on="user_id", how="inner")
        .merge(topics, on="user_id", how="inner")
        .merge(langs, on="user_id", how="inner")
    )
    u["user_avg_daily_starred_repos_count"] = np.round(
        u["user_starred_repos_count"] / (u["user_days_between_created_at_today"] + 1.0), 3
    )

    # Frequency binning + blog flag (UserProfileBuilder.scala:177-200).
    u = FrequencyBinner(
        "user_clean_company", "user_binned_company", company_bin_threshold
    ).fit(u).transform(u)
    u = FrequencyBinner(
        "user_clean_location", "user_binned_location", location_bin_threshold
    ).fit(u).transform(u)
    u["user_has_blog"] = u["user_blog"] != ""

    cols = FeatureColumns(
        boolean=["user_has_null", *(_USER_KEYWORD_FLAGS.keys()), "user_has_blog"],
        continuous=[
            "user_public_repos_count", "user_public_gists_count",
            "user_followers_count", "user_following_count",
            "user_followers_following_ratio",
            "user_days_between_created_at_today",
            "user_days_between_updated_at_today",
            "user_starred_repos_count", "user_avg_daily_starred_repos_count",
        ],
        categorical=["user_account_type", "user_binned_company", "user_binned_location"],
        list_=["user_recent_repo_languages", "user_recent_repo_topics"],
        text=["user_clean_bio", "user_recent_repo_descriptions"],
    )
    profile = plain_columns(
        u[["user_id", "user_login", *cols.all()]].reset_index(drop=True)
    )
    return profile, cols


def build_repo_profile(
    tables: RawTables,
    now: float,
    min_stars: int = 30,
    max_stars: int = 100_000,
    max_forks: int = 90_000,
    language_bin_threshold: int = 30,
    canary_user_id: int = VINTA_USER_ID,
) -> tuple[pd.DataFrame, FeatureColumns]:
    """``RepoProfileBuilder`` parity; returns (profile frame, feature buckets)."""
    r = tables.repo_info.copy()
    s = tables.starring

    nullable = ["repo_description", "repo_homepage"]
    r["repo_has_null"] = (r[nullable] == "").any(axis=1)

    # Reduce: no forks, bounded stars/forks (RepoProfileBuilder.scala:73-77).
    r = r[
        (~r["repo_is_fork"])
        & (r["repo_forks_count"] <= max_forks)
        & r["repo_stargazers_count"].between(min_stars, max_stars)
    ].copy()

    r["repo_clean_description"] = r["repo_description"].str.lower()
    low_stars = r["repo_stargazers_count"] <= 40
    r["repo_is_unmaintained"] = _contains_any(r["repo_clean_description"], _UNMAINTAINED_WORDS)
    r["repo_is_assignment"] = _contains_any(r["repo_clean_description"], _ASSIGNMENT_WORDS)
    r["repo_is_demo"] = (
        r["repo_clean_description"].isin(_DEMO_WORDS_EXACT)
        | _contains_any(r["repo_clean_description"], _DEMO_WORDS)
    ) & low_stars
    r["repo_is_blog"] = r["repo_clean_description"].isin(_BLOG_WORDS_EXACT) & low_stars
    r = r[
        ~(r["repo_is_unmaintained"] | r["repo_is_assignment"] | r["repo_is_demo"] | r["repo_is_blog"])
    ].copy()

    r["repo_clean_language"] = r["repo_language"].str.lower()

    # Constructed features (RepoProfileBuilder.scala:108-124).
    canary_repos = set(s[s["user_id"] == canary_user_id]["repo_id"].tolist())
    r["repo_has_activities_in_60days"] = (now - r["repo_pushed_at"]) / _DAY <= 60
    r["repo_has_homepage"] = r["repo_homepage"] != ""
    r["repo_is_vinta_starred"] = r["repo_id"].isin(canary_repos)
    r["repo_days_between_created_at_today"] = np.floor((now - r["repo_created_at"]) / _DAY)
    r["repo_days_between_updated_at_today"] = np.floor((now - r["repo_updated_at"]) / _DAY)
    r["repo_days_between_pushed_at_today"] = np.floor((now - r["repo_pushed_at"]) / _DAY)
    r["repo_subscribers_stargazers_ratio"] = np.round(
        r["repo_subscribers_count"] / (r["repo_stargazers_count"] + 1.0), 3
    )
    r["repo_forks_stargazers_ratio"] = np.round(
        r["repo_forks_count"] / (r["repo_stargazers_count"] + 1.0), 3
    )
    r["repo_open_issues_stargazers_ratio"] = np.round(
        r["repo_open_issues_count"] / (r["repo_stargazers_count"] + 1.0), 3
    )
    r["repo_text"] = (
        r["repo_owner_username"].astype(str)
        + " " + r["repo_name"].astype(str)
        + " " + r["repo_language"].astype(str)
        + " " + r["repo_description"].astype(str)
    ).str.lower()

    # Binned language + topics list (RepoProfileBuilder.scala:135-148).
    r = FrequencyBinner(
        "repo_clean_language", "repo_binned_language", language_bin_threshold
    ).fit(r).transform(r)
    r["repo_clean_topics"] = [
        [t for t in str(x).lower().split(",") if t] for x in r["repo_topics"]
    ]

    cols = FeatureColumns(
        boolean=[
            "repo_has_issues", "repo_has_projects", "repo_has_downloads",
            "repo_has_wiki", "repo_has_pages", "repo_has_null",
            "repo_has_activities_in_60days", "repo_has_homepage",
            "repo_is_vinta_starred",
        ],
        continuous=[
            "repo_size", "repo_stargazers_count", "repo_forks_count",
            "repo_subscribers_count", "repo_open_issues_count",
            "repo_days_between_created_at_today",
            "repo_days_between_updated_at_today",
            "repo_days_between_pushed_at_today",
            "repo_subscribers_stargazers_ratio",
            "repo_forks_stargazers_ratio",
            "repo_open_issues_stargazers_ratio",
        ],
        categorical=["repo_owner_type", "repo_language", "repo_binned_language"],
        list_=["repo_clean_topics"],
        text=["repo_text"],
    )
    profile = plain_columns(
        r[
            ["repo_id", "repo_full_name", "repo_owner_id", "repo_created_at",
             "repo_updated_at", "repo_pushed_at", *cols.all()]
        ].reset_index(drop=True)
    )
    return profile, cols
