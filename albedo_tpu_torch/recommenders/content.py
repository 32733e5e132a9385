"""Content-based recommender behind a pluggable similarity-search interface,
scored on the card (PyTorch + CUDA).

Port of ``albedo_tpu/recommenders/content.py``. Reference parity:
``recommenders/ContentRecommender.scala:16-87`` — per user, fetch recently
starred repos and issue an Elasticsearch More-Like-This query over
(description, full_name, language, topics); in evaluation mode the query
repos are offset by ``topK`` so the candidates aren't the query items
themselves (:44-46).

The default backend embeds repo text once (tokenizer -> Word2Vec document
vectors over description/name/language/topics), L2-normalizes it, and
answers a whole batch of users with one K5 call (``ops/topk.py
topk_scores``) at the embedding width (200 under ``--w2v-full``: K14, the
kernel's wide path), the query rows excluded. An external search service
can still be plugged in via the ``SearchBackend`` protocol.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from albedo_tpu_torch.features.text import Tokenizer
from albedo_tpu_torch.recommenders.base import Recommender, recent_starred_provider
from albedo_tpu_torch.recommenders.tfidf import mlt_queries, mlt_search
from albedo_tpu_torch.utils.device import resolve_device


class SearchBackend:
    """More-Like-This contract: batched similar-item lookup by example items."""

    def more_like_this(
        self, query_items: list[np.ndarray], k: int
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """For each query (an array of raw item ids), return (item_ids, scores)
        of the k most similar items, excluding the query items themselves."""
        raise NotImplementedError


class EmbeddingSearchBackend(SearchBackend):
    """Embed repo text once; answer MLT queries with K5 on the device."""

    def __init__(self, repo_info: pd.DataFrame, word2vec_model, tokenizer=None,
                 device: str | torch.device = "cuda"):
        tok = tokenizer or Tokenizer("_", remove_stop_words=True)
        text = (
            repo_info["repo_description"].fillna("").astype(str)
            + " " + repo_info["repo_name"].fillna("").astype(str)
            + " " + repo_info["repo_language"].fillna("").astype(str)
            + " " + repo_info["repo_topics"].fillna("").astype(str).str.replace(",", " ")
        )
        self.item_ids = repo_info["repo_id"].to_numpy(np.int64)
        self._row = {int(i): r for r, i in enumerate(self.item_ids)}
        vecs = np.stack([word2vec_model.document_vector(tok.tokenize(t)) for t in text])
        norms = np.linalg.norm(vecs, axis=1, keepdims=True)
        self.vectors = (vecs / np.maximum(norms, 1e-9)).astype(np.float32)
        # The table's device copy, made once (the JAX module caches it per
        # backend identity).
        self.vectors_dev = torch.as_tensor(self.vectors).to(resolve_device(device))

    def more_like_this(
        self, query_items: list[np.ndarray], k: int
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        if len(query_items) == 0:
            return []
        queries, exclude, has_query = mlt_queries(self.vectors, self._row, query_items)
        return mlt_search(self.vectors_dev, self.item_ids, queries, exclude, has_query, k)


class ContentRecommender(Recommender):
    source = "content"

    def __init__(
        self,
        backend: SearchBackend,
        starring_df: pd.DataFrame,
        enable_evaluation_mode: bool = False,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.backend = backend
        # Eval mode: query with the NEXT topK starred repos so candidates are
        # not the held-out query items (ContentRecommender.scala:44-46).
        self.enable_evaluation_mode = enable_evaluation_mode
        self._user_recent_repos = recent_starred_provider(
            starring_df,
            top_k=self.top_k,
            offset=self.top_k if enable_evaluation_mode else 0,
        )

    def bank_registration(self):
        """This source as a retrieval-bank ``item_mean`` registration. Needs
        an embedding-backed backend (the table IS the source); an external
        search service has no rows to register."""
        from albedo_tpu_torch.retrieval.bank import BankSourceSpec

        backend = self.backend
        if not hasattr(backend, "vectors") or not hasattr(backend, "item_ids"):
            raise TypeError(
                "external search backends are not bank-registrable; keep "
                "this source on the host fan-out path"
            )
        return BankSourceSpec(
            name=self.source, kind="item_mean", vectors=backend.vectors,
            item_ids=backend.item_ids, query_items=self._user_recent_repos,
        )

    def recommend_for_users(self, user_ids: np.ndarray) -> pd.DataFrame:
        users = np.asarray(user_ids, dtype=np.int64)
        queries = [self._user_recent_repos(int(u)) for u in users]
        results = self.backend.more_like_this(queries, self.top_k)
        frames_u, frames_i, frames_s = [], [], []
        for u, (items, scores) in zip(users, results):
            frames_u.append(np.full(items.shape[0], u, dtype=np.int64))
            frames_i.append(items)
            frames_s.append(scores)
        if not frames_u:
            return self._frame(np.zeros(0), np.zeros(0), np.zeros(0))
        return self._frame(
            np.concatenate(frames_u), np.concatenate(frames_i), np.concatenate(frames_s)
        )
