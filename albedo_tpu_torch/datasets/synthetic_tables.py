"""Synthetic raw entity tables with albedo-like shape and messiness.

Extends ``synthetic_stars`` (the star matrix) with the metadata the profile
builders and ranker consume: user bios/companies/locations with the noise the
cleaning UDFs target, repo languages/topics/descriptions with realistic
co-occurrence (a repo's topics and description words correlate with its
language; users star mostly within a taste cluster), timestamps, counts. The
reference's crawled ``albedo.sql`` is not distributable; this generates the
same table schemas (``schemas/package.scala``) deterministically.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from albedo_tpu_torch.datasets.star_matrix import StarMatrix
from albedo_tpu_torch.datasets.synthetic import synthetic_stars
from albedo_tpu_torch.datasets.tables import RawTables

_LANGUAGES = [
    "Python", "JavaScript", "Go", "Rust", "Java", "C++", "Ruby", "Swift",
    "TypeScript", "Scala", "Haskell", "PHP", "C", "Kotlin", "Elixir", "",
]
_TOPIC_POOL = [
    "machine-learning", "deep-learning", "web", "framework", "cli", "database",
    "api", "frontend", "backend", "devops", "kubernetes", "docker", "android",
    "ios", "react", "vue", "compiler", "parser", "graphql", "security",
    "crypto", "game", "emulator", "editor", "terminal", "http", "json",
    "testing", "linter", "orm", "recommendation", "search", "nlp", "vision",
]
_DESC_POOL = [
    "fast", "simple", "lightweight", "modern", "minimal", "powerful", "tiny",
    "async", "distributed", "scalable", "library", "framework", "toolkit",
    "server", "client", "engine", "runtime", "bindings", "wrapper", "awesome",
    "collection", "curated", "list", "examples", "tutorial", "starter",
    "boilerplate", "plugin", "extension", "implementation", "written", "in",
    "for", "with", "the", "a", "of", "and",
]
_BIO_PHRASES = [
    "full stack developer", "backend engineer", "frontend developer",
    "mobile developer ios android", "devops sre infrastructure",
    "machine learning engineer", "data scientist deep learning",
    "recommender systems data mining", "team lead architect", "cto",
    "researcher phd", "freelance developer", "junior developer", "",
    "product manager", "open source enthusiast", "",
]
_COMPANIES = [
    "@BigCorp Inc.", "tinystartup.io", "Formerly @MegaSoft", "ACME Co Ltd",
    "self-employed", "", "", "Google", "microsoft.com", "Ex-Facebook",
    "大学", "freelance", "",
]
_LOCATIONS = [
    "Taipei, Taiwan", "San Francisco, CA", "Berlin, Germany", "Tokyo, Japan",
    "New York City", "London", "", "", "Paris, France", "東京", "Beijing, China",
    "Remote", "Amsterdam, Netherlands",
]
_ACCOUNT_TYPES = ["User", "User", "User", "User", "Organization"]


def synthetic_tables(
    n_users: int = 800,
    n_items: int = 500,
    rank: int = 8,
    mean_stars: float = 25.0,
    seed: int = 42,
    matrix: StarMatrix | None = None,
) -> RawTables:
    """Generate a coherent ``RawTables`` (reuses ``matrix`` if given so the
    tables align with a star matrix built elsewhere)."""
    if matrix is None:
        matrix = synthetic_stars(
            n_users=n_users, n_items=n_items, rank=rank, mean_stars=mean_stars, seed=seed
        )
    rng = np.random.default_rng(seed + 1)
    n_users, n_items = matrix.n_users, matrix.n_items

    t0 = 1.3e9  # ~2011, epoch seconds
    t_now = 1.51e9  # the reference was crawled ~late 2017

    # --- repos ---------------------------------------------------------------
    lang_idx = rng.integers(0, len(_LANGUAGES), size=n_items)
    stars = matrix.item_counts().astype(np.int64)
    # Scale raw star counts into a GitHub-like range so popular-repo filters
    # (1000..290000) select a meaningful subset.
    scaled_stars = (stars.astype(np.float64) / max(1, stars.max()) * 50_000).astype(np.int64)
    created = t0 + rng.random(n_items) * (t_now - t0 - 1e7)
    pushed = created + rng.random(n_items) * (t_now - created)

    topics = []
    descriptions = []
    names = []
    for j in range(n_items):
        r = np.random.default_rng(seed + 10_000 + j)
        # topic choice biased by language id => language/topic co-occurrence
        base = (lang_idx[j] * 3) % len(_TOPIC_POOL)
        k_t = int(r.integers(0, 5))
        tpick = (base + r.choice(12, size=k_t, replace=False)) % len(_TOPIC_POOL) if k_t else []
        topics.append(",".join(_TOPIC_POOL[t] for t in np.sort(np.asarray(tpick, dtype=np.int64))))
        k_d = int(r.integers(2, 9))
        words = r.choice(len(_DESC_POOL), size=k_d)
        lang_word = _LANGUAGES[lang_idx[j]].lower()
        desc = " ".join(_DESC_POOL[w] for w in words)
        if lang_word and r.random() < 0.7:
            desc += f" {lang_word}"
        if r.random() < 0.04:
            desc = "this is my course assignment homework"
        descriptions.append(desc)
        names.append(f"repo-{int(matrix.item_ids[j])}")

    owner = rng.integers(0, n_users, size=n_items)
    repo_info = pd.DataFrame(
        {
            "repo_id": matrix.item_ids,
            "repo_owner_id": matrix.user_ids[owner],
            "repo_owner_username": [f"user{int(u)}" for u in matrix.user_ids[owner]],
            "repo_owner_type": rng.choice(_ACCOUNT_TYPES, size=n_items),
            "repo_name": names,
            "repo_full_name": [f"user{int(matrix.user_ids[owner[j]])}/{names[j]}" for j in range(n_items)],
            "repo_description": descriptions,
            "repo_language": [_LANGUAGES[i] for i in lang_idx],
            "repo_created_at": created,
            "repo_updated_at": pushed,
            "repo_pushed_at": pushed,
            "repo_homepage": ["" if r % 3 else "https://example.com" for r in range(n_items)],
            "repo_size": rng.integers(10, 200_000, size=n_items),
            "repo_stargazers_count": scaled_stars,
            "repo_forks_count": (scaled_stars * rng.random(n_items) * 0.3).astype(np.int64),
            "repo_subscribers_count": (scaled_stars * rng.random(n_items) * 0.1).astype(np.int64),
            "repo_is_fork": rng.random(n_items) < 0.08,
            "repo_has_issues": rng.random(n_items) < 0.95,
            "repo_has_projects": rng.random(n_items) < 0.5,
            "repo_has_downloads": rng.random(n_items) < 0.9,
            "repo_has_wiki": rng.random(n_items) < 0.7,
            "repo_has_pages": rng.random(n_items) < 0.2,
            "repo_open_issues_count": rng.integers(0, 500, size=n_items),
            "repo_topics": topics,
        }
    )

    # --- users ---------------------------------------------------------------
    u_created = t0 + rng.random(n_users) * (t_now - t0 - 1e7)
    followers = rng.zipf(1.8, size=n_users).clip(0, 50_000) - 1
    user_info = pd.DataFrame(
        {
            "user_id": matrix.user_ids,
            "user_login": [f"user{int(u)}" for u in matrix.user_ids],
            "user_account_type": rng.choice(_ACCOUNT_TYPES, size=n_users),
            "user_name": [f"Name {int(u)}" if r % 4 else "" for r, u in enumerate(matrix.user_ids)],
            "user_company": rng.choice(_COMPANIES, size=n_users),
            "user_blog": ["" if r % 3 else "https://blog.example.com" for r in range(n_users)],
            "user_location": rng.choice(_LOCATIONS, size=n_users),
            "user_email": [f"u{int(u)}@example.com" if r % 2 else "" for r, u in enumerate(matrix.user_ids)],
            "user_bio": rng.choice(_BIO_PHRASES, size=n_users),
            "user_public_repos_count": rng.integers(0, 300, size=n_users),
            "user_public_gists_count": rng.integers(0, 100, size=n_users),
            "user_followers_count": followers,
            "user_following_count": rng.integers(0, 500, size=n_users),
            "user_created_at": u_created,
            "user_updated_at": u_created + rng.random(n_users) * (t_now - u_created),
        }
    )

    # --- starring ------------------------------------------------------------
    # starred_at increases with position in each user's interaction list, so
    # "most recent" slices are deterministic.
    indptr, cols, _ = matrix.csr()
    rows_sorted = np.repeat(np.arange(n_users), np.diff(indptr))
    base_t = u_created[rows_sorted]
    within = np.concatenate(
        [np.sort(rng.random(int(n))) for n in np.diff(indptr)]
    ) if matrix.nnz else np.zeros(0)
    starred_at = base_t + within * (t_now - base_t)
    starring = pd.DataFrame(
        {
            "user_id": matrix.user_ids[rows_sorted],
            "repo_id": matrix.item_ids[cols],
            "starred_at": starred_at,
            "starring": np.ones(matrix.nnz),
        }
    )

    # --- relations (follow graph; BFS shape like the crawler's) --------------
    n_rel = min(n_users * 4, 20_000)
    src = rng.integers(0, n_users, size=n_rel)
    dst = rng.zipf(1.5, size=n_rel).clip(1, n_users) - 1  # popular users followed more
    keep = src != dst
    relation = pd.DataFrame(
        {
            "from_user_id": matrix.user_ids[src[keep]],
            "to_user_id": matrix.user_ids[dst[keep]],
            "relation": np.where(rng.random(int(keep.sum())) < 0.9, "follow", "star"),
        }
    ).drop_duplicates(["from_user_id", "to_user_id", "relation"])

    return RawTables(
        user_info=user_info, repo_info=repo_info, starring=starring, relation=relation
    ).conformed()
