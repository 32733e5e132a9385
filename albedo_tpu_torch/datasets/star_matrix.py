"""Sparse user x item star matrix with bijective id reindexing.

The reference feeds raw GitHub ids straight into Spark MLlib ALS (which tolerates
arbitrary ints); the device kernels want dense 0..n-1 indices, so this class
owns the bijective raw-id <-> dense-index maps (SURVEY.md section 7 hard part (d))
and the CSR/CSC views that the ALS sweeps consume.

Reference parity: the ``Starring`` schema (``schemas/package.scala``) and
``DatasetUtils.loadRawStarringDS`` (``utils/DatasetUtils.scala:111-121``) which
adds the implicit ``starring = 1.0`` rating column.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StarMatrix:
    """COO interactions over dense indices, plus the raw-id vocabularies.

    ``user_ids[d] == raw_user_id`` for dense index ``d`` (and likewise
    ``item_ids``); ``rows/cols/vals`` are the nonzeros. ``vals`` is the implicit
    rating (1.0 for a star, or a confidence weight).
    """

    user_ids: np.ndarray  # (n_users,) raw ids, int64
    item_ids: np.ndarray  # (n_items,) raw ids, int64
    rows: np.ndarray      # (nnz,) dense user indices, int32
    cols: np.ndarray      # (nnz,) dense item indices, int32
    vals: np.ndarray      # (nnz,) float32

    @property
    def n_users(self) -> int:
        return int(self.user_ids.shape[0])

    @property
    def n_items(self) -> int:
        return int(self.item_ids.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @staticmethod
    def from_interactions(
        raw_users: np.ndarray,
        raw_items: np.ndarray,
        vals: np.ndarray | None = None,
    ) -> "StarMatrix":
        """Build from raw-id interaction lists, deduplicating and reindexing.

        Duplicate (user, item) pairs keep the last value, mirroring the unique
        (user_id, repo_id) constraint on the reference's ratings table
        (``app/models.py:167``).
        """
        raw_users = np.asarray(raw_users, dtype=np.int64)
        raw_items = np.asarray(raw_items, dtype=np.int64)
        if vals is None:
            vals = np.ones(raw_users.shape[0], dtype=np.float32)
        vals = np.asarray(vals, dtype=np.float32)

        user_ids, rows = np.unique(raw_users, return_inverse=True)
        item_ids, cols = np.unique(raw_items, return_inverse=True)
        rows = rows.astype(np.int32)
        cols = cols.astype(np.int32)

        # Dedup (row, col), keeping the last occurrence.
        key = rows.astype(np.int64) * item_ids.shape[0] + cols
        order = np.arange(key.shape[0])
        # np.unique keeps the first occurrence; scanning the reversed array makes
        # that the last-written value -> keep-last semantics.
        _, first_idx = np.unique(key[::-1], return_index=True)
        keep = order[::-1][first_idx]
        keep.sort()
        return StarMatrix(user_ids, item_ids, rows[keep], cols[keep], vals[keep])

    @staticmethod
    def from_codes(
        user_vocab: np.ndarray,
        item_vocab: np.ndarray,
        user_codes: np.ndarray,
        item_codes: np.ndarray,
        vals: np.ndarray | None = None,
    ) -> "StarMatrix":
        """Build from a pre-computed factorization: dense codes into SORTED
        raw-id vocabularies (the ingest validator's ``Factorization``).

        Skips :meth:`from_interactions`' unique/dedup sorts — the caller
        guarantees every code is in-range and (user, item) pairs are unique
        (the validator's dangling and duplicate rules under strict/repair).
        Vocabularies are compacted to the ids actually present, so the
        result is byte-identical to ``from_interactions`` over the same
        rows; only bincount/cumsum/gather passes remain, which is why the
        validated ingest path costs no more than the bare one.
        """
        user_vocab = np.asarray(user_vocab, dtype=np.int64)
        item_vocab = np.asarray(item_vocab, dtype=np.int64)
        user_codes = np.asarray(user_codes, dtype=np.int64)
        item_codes = np.asarray(item_codes, dtype=np.int64)
        if vals is None:
            vals = np.ones(user_codes.shape[0], dtype=np.float32)
        present_u = np.bincount(user_codes, minlength=user_vocab.shape[0]) > 0
        present_i = np.bincount(item_codes, minlength=item_vocab.shape[0]) > 0
        remap_u = np.cumsum(present_u) - 1
        remap_i = np.cumsum(present_i) - 1
        return StarMatrix(
            user_ids=user_vocab[present_u],
            item_ids=item_vocab[present_i],
            rows=remap_u[user_codes].astype(np.int32),
            cols=remap_i[item_codes].astype(np.int32),
            vals=np.asarray(vals, dtype=np.float32),
        )

    def users_of(self, raw_user_ids: np.ndarray) -> np.ndarray:
        """Map raw user ids to dense indices (-1 for unknown)."""
        return _lookup(self.user_ids, raw_user_ids)

    def items_of(self, raw_item_ids: np.ndarray) -> np.ndarray:
        return _lookup(self.item_ids, raw_item_ids)

    def csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Row-sorted view: (indptr (n_users+1,), cols, vals)."""
        order = np.argsort(self.rows, kind="stable")
        counts = np.bincount(self.rows, minlength=self.n_users)
        indptr = np.zeros(self.n_users + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return indptr, self.cols[order], self.vals[order]

    def csc(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Column-sorted view: (indptr (n_items+1,), rows, vals)."""
        order = np.argsort(self.cols, kind="stable")
        counts = np.bincount(self.cols, minlength=self.n_items)
        indptr = np.zeros(self.n_items + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return indptr, self.rows[order], self.vals[order]

    def transpose(self) -> "StarMatrix":
        return StarMatrix(self.item_ids, self.user_ids, self.cols, self.rows, self.vals)

    def select(self, mask: np.ndarray) -> "StarMatrix":
        """Subset of nonzeros (same vocabularies), e.g. a train/test split."""
        return StarMatrix(
            self.user_ids, self.item_ids, self.rows[mask], self.cols[mask], self.vals[mask]
        )

    def user_counts(self) -> np.ndarray:
        return np.bincount(self.rows, minlength=self.n_users)

    def item_counts(self) -> np.ndarray:
        return np.bincount(self.cols, minlength=self.n_items)

    def dense(self) -> np.ndarray:
        """Materialize as a dense array. Tests/small data only."""
        out = np.zeros((self.n_users, self.n_items), dtype=np.float32)
        out[self.rows, self.cols] = self.vals
        return out

    def sparsity(self) -> float:
        """Fraction of EMPTY cells, as the PySpark toolkit reports it
        (``albedo_toolkit/common.py`` ``calculate_sparsity``)."""
        cells = self.n_users * self.n_items
        return 1.0 - self.nnz / cells if cells else 0.0


def clean_by_counts(
    matrix: "StarMatrix",
    min_item_stargazers: int = 1,
    max_item_stargazers: int = 50_000,
    min_user_starred: int = 1,
    max_user_starred: int = 50_000,
) -> "StarMatrix":
    """``DataCleaner`` parity (``albedo_toolkit/transformers.py:23-92``):
    drop interactions of items whose stargazer count is outside
    [min, max], THEN of users whose starred count (after the item filter) is
    outside [min, max] — the same two chained inner joins, as vectorized
    mask selects. The returned matrix is re-indexed over the SURVIVING
    users/items only (cleaning must shrink the factor tables downstream
    models allocate, not leave ghost vocabulary rows)."""
    ic = matrix.item_counts()
    keep = (ic >= min_item_stargazers) & (ic <= max_item_stargazers)
    m1 = matrix.select(keep[matrix.cols])
    uc = m1.user_counts()
    keep_u = (uc >= min_user_starred) & (uc <= max_user_starred)
    m2 = m1.select(keep_u[m1.rows])
    return StarMatrix.from_interactions(
        raw_users=m2.user_ids[m2.rows],
        raw_items=m2.item_ids[m2.cols],
        vals=m2.vals,
    )


def _lookup(vocab: np.ndarray, raw: np.ndarray) -> np.ndarray:
    raw = np.asarray(raw, dtype=np.int64)
    if vocab.shape[0] == 0:
        return np.full(raw.shape, -1, dtype=np.int32)
    pos = np.searchsorted(vocab, raw)
    pos = np.clip(pos, 0, vocab.shape[0] - 1)
    found = vocab[pos] == raw
    return np.where(found, pos, -1).astype(np.int32)
