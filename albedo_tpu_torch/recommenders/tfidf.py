"""TF-IDF content-based similar-repo search (legacy trainer parity), scored
on the card (PyTorch + CUDA).

Port of ``albedo_tpu/recommenders/tfidf.py``. Reference parity:
``app/management/commands/train_content_based.py:52-56`` — sklearn
``TfidfVectorizer(tokenizer=LemmaTokenizer(), stop_words='english',
ngram_range=(1, 2), min_df=2)`` over ``repo_full_name + repo_language +
repo_description``, then ``linear_kernel`` similarities and the top-50 most
similar repos for a query repo. The WordNet lemmatizer is replaced by the
Porter stemmer, and sklearn's ``\\b\\w\\w+\\b`` token regex is kept.

The vectorizer (vocab + idf) is host ETL, byte-equal to the JAX module's.
Every similarity query is K5 (``ops/topk.py topk_scores``) over the
L2-normalized tf-idf rows, at the vocabulary's width (about 3000 at the
job's tables: K14, the kernel's wide path): ``similar`` with one query row
and no exclusion (the JAX module's matvec + ``lax.top_k``),
``similar_to_repos`` with the query rows excluded. The matrix stays a host
array; its device copy is made once and kept on the object.
"""

from __future__ import annotations

import re
from collections import Counter

import numpy as np
import pandas as pd
import torch

from albedo_tpu_torch.features.text import ENGLISH_STOP_WORDS, porter_stem
from albedo_tpu_torch.ops.topk import topk_scores
from albedo_tpu_torch.recommenders.base import Recommender, recent_starred_provider
from albedo_tpu_torch.utils.device import resolve_device

_RE_SK_TOKEN = re.compile(r"(?u)\b\w\w+\b")  # sklearn's default token_pattern


def _analyze(text: str, ngram_range: tuple[int, int]) -> list[str]:
    """Tokenize -> stem -> stop-word filter -> n-grams (sklearn order:
    tokenizer first, stop words applied to unigram tokens, then n-grams)."""
    tokens = [porter_stem(t) for t in _RE_SK_TOKEN.findall(text.lower())]
    tokens = [t for t in tokens if t not in ENGLISH_STOP_WORDS]
    lo, hi = ngram_range
    grams: list[str] = []
    for n in range(lo, hi + 1):
        if n == 1:
            grams.extend(tokens)
        else:
            grams.extend(
                " ".join(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
            )
    return grams


def mlt_queries(vectors: np.ndarray, row_of: dict[int, int], query_items: list[np.ndarray]):
    """More-Like-This query rows: per query, the L2-normalized mean of the
    rows of its known item ids, and those rows as a -1-padded exclusion
    list. Returns (queries (Q, d) f32, exclude (Q, max(1, longest)) int32,
    has_query (Q,) bool)."""
    n_q = len(query_items)
    queries = np.zeros((n_q, vectors.shape[1]), dtype=np.float32)
    max_q = max((len(q) for q in query_items), default=1)
    exclude = np.full((n_q, max(1, max_q)), -1, dtype=np.int32)
    has_query = np.zeros(n_q, dtype=bool)
    for qi, items in enumerate(query_items):
        rows = [row_of[int(i)] for i in items if int(i) in row_of]
        if rows:
            v = vectors[rows].mean(axis=0)
            queries[qi] = v / max(float(np.linalg.norm(v)), 1e-9)
            exclude[qi, : len(rows)] = rows
            has_query[qi] = True
    return queries, exclude, has_query


def mlt_search(vectors_dev: torch.Tensor, ids: np.ndarray, queries: np.ndarray, exclude: np.ndarray,
               has_query: np.ndarray, k: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """K5 over the device table for :func:`mlt_queries`' rows: per query,
    (item ids, float64 scores) of its finite top-k, and empty arrays for a
    query with no known item (ES MLT with an empty item list)."""
    dev = vectors_dev.device
    vals, idx = topk_scores(torch.as_tensor(queries).to(dev), vectors_dev, k=k,
                            exclude_idx=torch.as_tensor(exclude).to(dev))
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    empty = (np.zeros(0, dtype=np.int64), np.zeros(0))
    out = []
    for qi in range(len(queries)):
        if not has_query[qi]:
            out.append(empty)
            continue
        ok = (idx[qi] >= 0) & np.isfinite(vals[qi])
        out.append((ids[idx[qi][ok]], vals[qi][ok].astype(np.float64)))
    return out


class TfidfSimilaritySearch:
    """Fit a tf-idf index over repo text; query top-k similar repos."""

    def __init__(self, ngram_range: tuple[int, int] = (1, 2), min_df: int = 2,
                 device: str | torch.device = "cuda"):
        self.ngram_range = ngram_range
        self.min_df = min_df
        self.device = resolve_device(device)
        self.vocab: dict[str, int] = {}
        self.idf: np.ndarray | None = None
        self.doc_ids: np.ndarray | None = None
        self.matrix = None  # (D, V) L2-normalized tf-idf, HOST float32
        self._dev_matrix: torch.Tensor | None = None

    def fit(self, repo_df: pd.DataFrame) -> "TfidfSimilaritySearch":
        """``repo_df``: repo_id, repo_full_name, repo_language,
        repo_description (the reference's query columns)."""
        texts = (
            repo_df["repo_full_name"].fillna("").str.replace("/", " ", regex=False)
            + " "
            + repo_df["repo_language"].fillna("")
            + " "
            + repo_df["repo_description"].fillna("")
        )
        docs = [_analyze(t, self.ngram_range) for t in texts]

        df_counts: Counter = Counter()
        for d in docs:
            df_counts.update(set(d))
        terms = sorted(w for w, c in df_counts.items() if c >= self.min_df)
        self.vocab = {w: i for i, w in enumerate(terms)}
        n_docs = len(docs)
        v = len(terms)
        # sklearn smooth idf: ln((1 + n) / (1 + df)) + 1.
        df_arr = np.array([df_counts[w] for w in terms], dtype=np.float64)
        self.idf = (np.log((1.0 + n_docs) / (1.0 + df_arr)) + 1.0).astype(np.float32)

        mat = np.zeros((n_docs, v), dtype=np.float32)
        for r, d in enumerate(docs):
            counts = Counter(i for w in d if (i := self.vocab.get(w)) is not None)
            if counts:
                idx = np.fromiter(counts.keys(), dtype=np.int64, count=len(counts))
                val = np.fromiter(counts.values(), dtype=np.float32, count=len(counts))
                mat[r, idx] = val * self.idf[idx]
        norms = np.linalg.norm(mat, axis=1, keepdims=True)
        mat = np.where(norms > 0, mat / np.maximum(norms, 1e-12), 0.0)

        self.doc_ids = repo_df["repo_id"].to_numpy(np.int64)
        self._names = repo_df["repo_full_name"].astype(str).to_list()
        self.matrix = mat.astype(np.float32)
        self._doc_row = {int(i): r for r, i in enumerate(self.doc_ids)}
        self._dev_matrix = None
        return self

    def _device_matrix(self) -> torch.Tensor:
        """The matrix on the device, copied once per fit."""
        if self._dev_matrix is None:
            self._dev_matrix = torch.as_tensor(self.matrix).to(self.device)
        return self._dev_matrix

    def similar(self, repo_full_name: str, k: int = 49) -> list[tuple[float, str]]:
        """Top-k most similar repos to the named repo (the reference prints
        the query's top 49, ``train_content_based.py:62-66``)."""
        try:
            q = self._names.index(repo_full_name)
        except ValueError:
            return []
        k = min(k + 1, len(self._names))
        dev = self._device_matrix()
        vals, idx = topk_scores(dev[q : q + 1], dev, k)
        out = [
            (float(v), self._names[int(i)])
            for v, i in zip(vals[0].cpu().numpy(), idx[0].cpu().numpy())
            if int(i) != q and int(i) >= 0
        ]
        return out[: k - 1]

    def similar_to_repos(
        self, query_items: list[np.ndarray], k: int
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Batched More-Like-This over raw repo ids: per query, the cosine
        top-k against the L2-normalized mean of the query rows, query rows
        excluded — the same contract as
        ``content.EmbeddingSearchBackend.more_like_this``."""
        if len(query_items) == 0:
            return []
        queries, exclude, has_query = mlt_queries(self.matrix, self._doc_row, query_items)
        return mlt_search(self._device_matrix(), self.doc_ids, queries, exclude, has_query,
                          min(k, len(self.doc_ids)))


    def bank_registration(self, query_items=None, name: str = "tfidf"):
        """This projection as a retrieval-bank ``item_mean`` source over the
        same host matrix the query paths score."""
        from albedo_tpu_torch.retrieval.bank import BankSourceSpec

        if self.matrix is None:
            raise RuntimeError("fit() the tf-idf index before registering it")
        return BankSourceSpec(
            name=name, kind="item_mean", vectors=self.matrix,
            item_ids=self.doc_ids, query_items=query_items,
        )


class TfidfRecommender(Recommender):
    """The TF-IDF projection as a stage-1 candidate source: per user, More-
    Like-This over their most recent stars."""

    source = "tfidf"

    def __init__(self, search: TfidfSimilaritySearch, starring_df: pd.DataFrame, **kwargs):
        super().__init__(**kwargs)
        self.search = search
        self._user_recent_repos = recent_starred_provider(starring_df, top_k=self.top_k)

    def bank_registration(self):
        return self.search.bank_registration(query_items=self._user_recent_repos)

    def recommend_for_users(self, user_ids: np.ndarray) -> pd.DataFrame:
        users = np.asarray(user_ids, dtype=np.int64)
        queries = [self._user_recent_repos(int(u)) for u in users]
        results = self.search.similar_to_repos(queries, self.top_k)
        if not results:
            return self._frame(np.zeros(0), np.zeros(0), np.zeros(0))
        return self._frame(
            np.concatenate([
                np.full(items.shape[0], u, dtype=np.int64)
                for u, (items, _) in zip(users, results)
            ]),
            np.concatenate([items for items, _ in results]),
            np.concatenate([scores for _, scores in results]),
        )
