"""Assemble the default bank from a job's trained models.

Port of ``albedo_tpu/retrieval/build.py``: the flagship ALS factors
(user-row top-k + the exclusion contract), the Word2Vec content
embeddings, the TF-IDF projection, and the user-similarity table
(user-to-user retrieval — extra rows in the bank).
"""

from __future__ import annotations

import numpy as np

from albedo_tpu_torch.recommenders.base import recent_starred_provider
from albedo_tpu_torch.retrieval.bank import BankSourceSpec, RetrievalBank


def default_bank_specs(
    model,
    matrix,
    starring_df=None,
    content_backend=None,
    tfidf_search=None,
    with_user_sim: bool = False,
    with_als: bool = True,
    top_k: int = 30,
) -> list[BankSourceSpec]:
    """Registration specs for everything embedding-backed this deployment
    has trained. ``content_backend``/``tfidf_search`` are optional — a
    deployment without them gets an ALS-only bank. ``with_als=False`` skips
    the factor tables."""
    specs = []
    if with_als:
        specs.append(BankSourceSpec(
            name="als",
            kind="user_rows",
            vectors=model.item_factors,
            item_ids=matrix.item_ids,
            user_vectors=model.user_factors,
            exclude_seen=True,
        ))
    query_items = (
        recent_starred_provider(starring_df, top_k=top_k)
        if starring_df is not None else None
    )
    if content_backend is not None:
        specs.append(BankSourceSpec(
            name="content",
            kind="item_mean",
            vectors=content_backend.vectors,
            item_ids=content_backend.item_ids,
            query_items=query_items,
        ))
    if tfidf_search is not None:
        specs.append(tfidf_search.bank_registration(query_items=query_items))
    if with_user_sim:
        # User-to-user similarity: the user table scored against itself.
        uf = np.asarray(model.user_factors, dtype=np.float32)
        specs.append(BankSourceSpec(
            name="user_sim",
            kind="user_rows",
            vectors=uf,
            item_ids=matrix.user_ids,
            user_vectors=uf,
        ))
    return specs


def build_default_bank(
    model,
    matrix,
    starring_df=None,
    content_backend=None,
    tfidf_search=None,
    with_user_sim: bool = False,
    with_als: bool = True,
    exclude_table: np.ndarray | None = None,
    mesh=None,
    top_k: int = 30,
    max_batch: int = 64,
    device="cuda",
) -> RetrievalBank:
    """Register :func:`default_bank_specs` and build the bank on ``device``
    (``mesh`` is not ported yet and raises)."""
    bank = RetrievalBank(max_batch=max_batch, device=device)
    for spec in default_bank_specs(
        model, matrix, starring_df=starring_df,
        content_backend=content_backend, tfidf_search=tfidf_search,
        with_user_sim=with_user_sim, with_als=with_als, top_k=top_k,
    ):
        bank.register(spec)
    bank.build(matrix=matrix, exclude_table=exclude_table, mesh=mesh)
    return bank
