"""Feature assembly into TPU-consumable blocks.

Reference parity: ``org/apache/spark/ml/feature/SimpleVectorAssembler.scala:35-115``
concatenates boolean/continuous/one-hot/count-vector/word2vec columns into one
sparse ``features`` vector per row. A literal port would make million-wide
one-hots over ``user_id``/``repo_id`` (``LogisticRegressionRanker.scala:156-157``)
— hostile to the MXU. Instead assembly produces a ``FeatureMatrix``:

- ``dense``  (N, D) float32 — booleans, continuous scalars, and fixed-dim
  vector columns (word2vec embeddings), MXU-friendly;
- ``cat``    per-field (N,) int32 index arrays — consumed as weight-row
  gathers (mathematically identical to one-hot x weight);
- ``bags``   per-field padded (N, L) index/value arrays — consumed as gather +
  masked segment-sum (the count-vector fields).

Total feature dimensionality (``num_features``) matches what the one-hot
assembler would have produced, and ``to_dense()`` materializes that exact
layout for small-data equivalence tests.

Host code, copied from ``albedo_tpu/features/assembler.py`` with its imports pointed at
the port; the port keeps its own copy so that it never imports the JAX
package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pandas as pd

from albedo_tpu_torch.datasets.ragged import segment_positions
from albedo_tpu_torch.features.pipeline import Estimator, Transformer, col_values

VOCAB_ATTR = "albedo_vocab_size"  # df.attrs[VOCAB_ATTR][col] = size hint


def _dedup_rows(*cols):
    """(repr_index (N,), [distinct values per col]) keyed by object identity.

    The memoized per-document transforms (``memo_map``) alias repeated
    documents to the SAME result objects, so identity-dedup collapses a
    row-set that repeats each user/repo document ~100x down to the distinct
    documents; padding/stacking then runs once per distinct value and rows
    are materialized by one vectorized gather. Non-aliased inputs still work
    — every row is simply its own representative.
    """
    n = len(cols[0])
    slot: dict = {}
    rep = np.empty(n, dtype=np.int64)
    uniq = tuple([] for _ in cols)
    for r in range(n):
        key = tuple(id(c[r]) for c in cols)
        j = slot.get(key)
        if j is None:
            j = len(uniq[0])
            slot[key] = j
            for u, c in zip(uniq, cols):
                u.append(c[r])
        rep[r] = j
    return rep, uniq


def set_vocab_size(df: pd.DataFrame, col: str, size: int) -> None:
    df.attrs.setdefault(VOCAB_ATTR, {})[col] = int(size)


@dataclasses.dataclass
class FeatureMatrix:
    """Assembled features for N rows, in blocks (see module docstring).

    The logical dense block is ``[scalar columns | vector columns]``;
    vector columns (fixed-dim embeddings, e.g. word2vec documents) are
    stored FACTORED as ``vec[f]`` (U_f, D_f) distinct vectors plus
    ``vec_rep[f]`` (N,) representative indices: each user/repo document
    repeats across ~100s of (user, repo) rows, so the expanded copy is
    ~30-50x larger than the distinct set (657 MB vs ~20 MB at r5 ranker
    bench scale — dominating the host->device upload). Device code gathers
    ``vec[rep]`` instead; ``expanded_dense()`` materializes the flat layout
    for compatibility paths."""

    dense: np.ndarray                    # (N, D_scalar) float32
    dense_names: list[str]               # scalar names then vec[f][i] names
    cat: dict[str, np.ndarray]           # field -> (N,) int32
    cat_sizes: dict[str, int]
    bag_idx: dict[str, np.ndarray]       # field -> (U_f|N, L) int32, -1 on padding
    bag_val: dict[str, np.ndarray]       # field -> (U_f|N, L) float32, 0 on padding
    bag_sizes: dict[str, int]
    vec: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    vec_rep: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # Optional per-field (N,) rep indices into FACTORED bag rows: bag columns
    # are per-user/per-repo documents repeated across ~50-80 (user, repo)
    # rows, so the distinct-document representation shrinks the flat entry
    # streams (and their per-linesearch-eval TPU gathers) by that factor.
    # A field absent here keeps per-row (N, L) semantics.
    bag_rep: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def n_rows(self) -> int:
        return int(self.dense.shape[0])

    @property
    def dense_width(self) -> int:
        """Width of the LOGICAL dense block: scalars + factored vec columns."""
        return int(self.dense.shape[1]) + sum(int(v.shape[1]) for v in self.vec.values())

    def vec_fields(self) -> list[str]:
        """Vec field names in the CANONICAL (sorted) order — the order of
        their slices within the logical dense block. Sorted because jax
        reconstructs dict pytrees in sorted-key order inside jit, so offset
        pairing must not depend on insertion order."""
        return sorted(self.vec)

    @property
    def num_features(self) -> int:
        """Width of the equivalent flat one-hot feature vector."""
        return (
            self.dense_width
            + sum(self.cat_sizes.values())
            + sum(self.bag_sizes.values())
        )

    def expanded_dense(self) -> np.ndarray:
        """The (N, dense_width) dense block with vec fields expanded — the
        pre-r5 layout, used by the row-sharded mesh path and to_dense."""
        if not self.vec:
            return self.dense
        return np.concatenate(
            [self.dense] + [self.vec[f][self.vec_rep[f]] for f in self.vec_fields()],
            axis=1,
        )

    def select(self, rows: np.ndarray) -> "FeatureMatrix":
        return FeatureMatrix(
            dense=self.dense[rows],
            dense_names=self.dense_names,
            cat={k: v[rows] for k, v in self.cat.items()},
            cat_sizes=self.cat_sizes,
            bag_idx={
                k: (v if k in self.bag_rep else v[rows])
                for k, v in self.bag_idx.items()
            },
            bag_val={
                k: (v if k in self.bag_rep else v[rows])
                for k, v in self.bag_val.items()
            },
            bag_sizes=self.bag_sizes,
            vec=self.vec,
            vec_rep={k: v[rows] for k, v in self.vec_rep.items()},
            bag_rep={k: v[rows] for k, v in self.bag_rep.items()},
        )

    def expanded_bag(self, f: str) -> tuple[np.ndarray, np.ndarray]:
        """The per-row (N, L) ``(idx, val)`` view of a bag field, whether it
        is stored factored or per-row."""
        idx, val = self.bag_idx[f], self.bag_val[f]
        rep = self.bag_rep.get(f)
        if rep is None:
            return idx, val
        return idx[rep], val[rep]

    def flat_bags(self) -> dict[str, tuple]:
        """Per bag field, the row-major flat entries ``(rows, vocab, vals)``
        of the STORED arrays — distinct-document rows for factored fields
        (``bag_rep``), per-data rows otherwise. Memoized, because both the
        device batch layout and the standardization moments need it (two
        full passes over ~100M-element masks at bench scale otherwise)."""
        cached = self.__dict__.get("_flat_bag_cache")
        if cached is None:
            cached = {}
            for f in self.bag_idx:
                idx, val = self.bag_idx[f], self.bag_val[f]
                ok = idx >= 0
                rows = np.broadcast_to(
                    np.arange(idx.shape[0], dtype=np.int64)[:, None], idx.shape
                )[ok]
                cached[f] = (rows, idx[ok].astype(np.int32), val[ok].astype(np.float32))
            self.__dict__["_flat_bag_cache"] = cached
        return cached

    def to_dense(self) -> np.ndarray:
        """Materialize the flat one-hot layout (tests / small data only):
        [dense | one-hot(cat fields) | multi-hot(bag fields)]."""
        n = self.n_rows
        out = [self.expanded_dense()]
        for name in self.cat:
            block = np.zeros((n, self.cat_sizes[name]), dtype=np.float32)
            idx = self.cat[name]
            ok = (idx >= 0) & (idx < self.cat_sizes[name])
            block[np.nonzero(ok)[0], idx[ok]] = 1.0
            out.append(block)
        for name in self.bag_idx:
            block = np.zeros((n, self.bag_sizes[name]), dtype=np.float32)
            idx, val = self.expanded_bag(name)
            rows = np.repeat(np.arange(n), idx.shape[1]).reshape(idx.shape)
            ok = idx >= 0
            np.add.at(block, (rows[ok], idx[ok]), val[ok])
            out.append(block)
        return np.concatenate(out, axis=1)


from albedo_tpu_torch.utils import pow2_at_least as _pow2_at_least


class FeatureAssemblerModel(Transformer):
    def __init__(
        self,
        dense_cols: list[str],
        vector_cols: list[str],
        cat_sizes: dict[str, int],
        bag_sizes: dict[str, int],
        bag_pad: dict[str, int],
    ):
        self.dense_cols = dense_cols
        self.vector_cols = vector_cols
        self.cat_sizes = cat_sizes
        self.bag_sizes = bag_sizes
        self.bag_pad = bag_pad

    def transform(self, df: pd.DataFrame) -> pd.DataFrame:
        return df  # assembly happens via assemble(); frame passes through

    def assemble(self, df: pd.DataFrame) -> FeatureMatrix:
        n = len(df)
        blocks, names = [], []
        for c in self.dense_cols:
            self.require_cols(df, [c])
            blocks.append(
                pd.to_numeric(df[c], errors="coerce")
                .fillna(0.0)
                .to_numpy(np.float32)
                .reshape(n, 1)
            )
            names.append(c)
        vec, vec_rep = {}, {}
        # CANONICAL vec-field order is sorted(name): jax flattens dict
        # pytrees in sorted-key order, so everything that pairs per-field
        # slices of the flat dense coefficient vector (block_logits offsets,
        # scales, center, dense_names) must agree on sorted order — insertion
        # order is unrecoverable inside jit.
        for c in sorted(self.vector_cols):
            self.require_cols(df, [c])
            if n:
                rep, (uniq,) = _dedup_rows(col_values(df[c]))
                vec[c] = np.stack([np.asarray(v, dtype=np.float32) for v in uniq])
                vec_rep[c] = rep.astype(np.int32)
            else:
                vec[c] = np.zeros((0, 0), np.float32)
                vec_rep[c] = np.zeros((0,), np.int32)
            # Stored factored (distinct vectors + rep), not expanded — the
            # expanded copy is what made the r4 LR batch 657 MB.
            names.extend(f"{c}[{i}]" for i in range(vec[c].shape[1]))
        dense = (
            np.concatenate(blocks, axis=1)
            if blocks
            else np.zeros((n, 0), dtype=np.float32)
        )

        cat = {}
        for c, size in self.cat_sizes.items():
            self.require_cols(df, [c])
            idx = df[c].to_numpy(np.int64)
            # Unknown slot (= size - 1 under StringIndexer "keep") already
            # encoded; clip runaway values defensively.
            cat[c] = np.clip(idx, 0, size - 1).astype(np.int32)

        bag_idx, bag_val, bag_rep = {}, {}, {}
        for c, size in self.bag_sizes.items():
            ic, vc = f"{c}__bag_idx", f"{c}__bag_val"
            self.require_cols(df, [ic, vc])
            pad = self.bag_pad[c]
            # Pad each DISTINCT bag once (identity dedup over the memoized
            # per-document arrays) and KEEP the factored (distinct, rep)
            # form: the expanded copy repeats each user/repo document across
            # ~50-80 rows, multiplying every downstream host pass and device
            # gather by that factor.
            rep, (u_i, u_v) = _dedup_rows(col_values(df[ic]), col_values(df[vc]))
            u = len(u_i)
            lens = np.fromiter((min(len(a), pad) for a in u_i), np.int64, count=u)
            idx = np.full((u, pad), -1, dtype=np.int32)
            val = np.zeros((u, pad), dtype=np.float32)
            if u and int(lens.sum()):
                pos = segment_positions(lens)
                rows = np.repeat(np.arange(u), lens)
                idx[rows, pos] = np.concatenate(
                    [np.asarray(a[:t], dtype=np.int32) for a, t in zip(u_i, lens)]
                )
                val[rows, pos] = np.concatenate(
                    [np.asarray(a[:t], dtype=np.float32) for a, t in zip(u_v, lens)]
                )
            # -1 rows stay fully masked; real gathers happen on device.
            bag_idx[c] = idx
            bag_val[c] = val
            bag_rep[c] = rep.astype(np.int32)

        return FeatureMatrix(
            dense=dense,
            dense_names=names,
            cat=cat,
            cat_sizes=dict(self.cat_sizes),
            bag_idx=bag_idx,
            bag_val=bag_val,
            bag_sizes=dict(self.bag_sizes),
            vec=vec,
            vec_rep=vec_rep,
            bag_rep=bag_rep,
        )


class FeatureAssembler(Estimator):
    """Resolve block layout from a fitted frame.

    ``cat_cols`` / ``bag_cols`` may map to an explicit vocab size or ``None``
    to resolve from ``df.attrs`` hints (written by StringIndexerModel /
    CountVectorizerModel) or, failing that, ``max+1`` over the fit data.
    Bag pad length = max fit-data bag length rounded up to a power of two
    (bounded shapes for XLA), capped at ``max_bag_pad``.
    """

    def __init__(
        self,
        dense_cols: list[str] | None = None,
        vector_cols: list[str] | None = None,
        cat_cols: dict[str, int | None] | None = None,
        bag_cols: dict[str, int | None] | None = None,
        max_bag_pad: int = 256,
    ):
        self.dense_cols = list(dense_cols or [])
        self.vector_cols = list(vector_cols or [])
        self.cat_cols = dict(cat_cols or {})
        self.bag_cols = dict(bag_cols or {})
        self.max_bag_pad = max_bag_pad

    def fit(self, df: pd.DataFrame) -> FeatureAssemblerModel:
        hints = df.attrs.get(VOCAB_ATTR, {})
        cat_sizes = {}
        for c, size in self.cat_cols.items():
            if size is None:
                size = hints.get(c)
            if size is None:
                size = int(df[c].max()) + 1 if len(df) else 1
            cat_sizes[c] = int(size)
        bag_sizes, bag_pad = {}, {}
        for c, size in self.bag_cols.items():
            if size is None:
                size = hints.get(c)
            if size is None:
                mx = max(
                    (int(np.max(iv)) for iv in col_values(df[f"{c}__bag_idx"]) if len(iv)),
                    default=-1,
                )
                size = mx + 1
            bag_sizes[c] = int(size)
            longest = max((len(iv) for iv in col_values(df[f"{c}__bag_idx"])), default=1)
            bag_pad[c] = min(self.max_bag_pad, _pow2_at_least(max(1, longest)))
        return FeatureAssemblerModel(
            self.dense_cols, self.vector_cols, cat_sizes, bag_sizes, bag_pad
        )
