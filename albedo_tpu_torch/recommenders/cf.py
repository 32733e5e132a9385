"""Memory-based collaborative-filtering recommenders (item-item and
user-user) on the card (PyTorch + CUDA).

Port of ``albedo_tpu/recommenders/cf.py``. Reference parity: the Django
legacy trainers — ``train_item_cf.py:38`` (item-item CF, cosine similarity
over the binary user x item matrix, predictions ``R @ S / |S|.sum(axis=1)``)
and ``train_user_cf.py:37`` (user-user CF, dice similarity, predictions
``S @ R / |S|.sum(axis=1)``).

Nothing quadratic is materialized: the utility matrix stays sparse, and each
prediction factorizes into two sparse passes per block of requested users:

  item-CF:  P_B = (R_B @ Rhat^T) @ Rhat,  Rhat = R / sqrt(item_counts)
  user-CF:  P_B = S_B @ R,  S_B = 2 (R_B @ R^T) / (n_B + n), renormalized

Both passes are K11's ``spmm_rows`` (``ops/spmm.py``): the first on the CSR
of the matrix, the second on its transpose, with the dense blocks held as
(n, B) so that one user's column is a stride and one item's row of B values
is contiguous. The cosine normalizer ``|S|.sum(axis=1)`` is two B = 1
passes (exact: similarities of binary vectors are non-negative). K11's
``masked_topk`` divides by it, drops the user's own stars and keeps the top
k. The JAX module's padded row groups are a TPU layout; the port holds the
CSR and CSC arrays directly.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from albedo_tpu_torch.datasets.ragged import _pad_len, padded_rows
from albedo_tpu_torch.datasets.star_matrix import StarMatrix
from albedo_tpu_torch.ops.spmm import CSR, masked_topk, spmm_rows
from albedo_tpu_torch.recommenders.base import Recommender
from albedo_tpu_torch.utils.device import resolve_device


def dense_user_block(star_idx: torch.Tensor, n_items: int) -> torch.Tensor:
    """(n_items, B) binary columns from (B, L) padded star lists (-1 = pad):
    the transpose of the JAX module's ``_dense_user_block``."""
    b = star_idx.shape[0]
    r = torch.zeros((n_items + 1, b), dtype=torch.float32, device=star_idx.device)
    safe = torch.where(star_idx < 0, n_items, star_idx.long())
    r[safe, torch.arange(b, device=star_idx.device)[:, None]] = 1.0
    return r[:n_items]


class _SparseCFRecommender(Recommender):
    """Shared blocked recommend loop for both memory-based CFs."""

    def __init__(self, matrix: StarMatrix, user_block: int = 256,
                 device: str | torch.device = "cuda", **kwargs):
        super().__init__(**kwargs)
        self.matrix = matrix
        self.user_block = user_block
        self.device = resolve_device(device)
        self._indptr, self._cols, _ = matrix.csr()

    def _score_block(self, star_idx: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def recommend_for_users(self, user_ids: np.ndarray) -> pd.DataFrame:
        dense = self.matrix.users_of(np.asarray(user_ids, dtype=np.int64))
        known = dense >= 0
        rows = dense[known]
        req_users = np.asarray(user_ids, dtype=np.int64)[known]
        k = min(self.top_k, self.matrix.n_items)
        # One (user_block, width) shape per call, as the JAX module pads it.
        lens = self._indptr[rows + 1] - self._indptr[rows]
        width = _pad_len(max(1, int(lens.max())) if rows.size else 1, 8)

        out_users, out_items, out_scores = [], [], []
        for start in range(0, len(rows), self.user_block):
            block = rows[start : start + self.user_block]
            raw = padded_rows(self._indptr, self._cols, block)
            star_idx = np.full((self.user_block, width), -1, dtype=np.int32)
            star_idx[: raw.shape[0], : raw.shape[1]] = raw
            vals, idx = self._score_block(torch.as_tensor(star_idx).to(self.device), k)
            vals = vals.cpu().numpy()[: len(block)]
            idx = idx.cpu().numpy()[: len(block)]
            ok = np.isfinite(vals)
            b_users = np.repeat(req_users[start : start + self.user_block], k).reshape(-1, k)
            out_users.append(b_users[ok])
            out_items.append(self.matrix.item_ids[idx[ok]])
            out_scores.append(vals[ok])

        if not out_users:
            return self._frame(np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))
        return self._frame(
            np.concatenate(out_users),
            np.concatenate(out_items),
            np.concatenate(out_scores),
        )


class ItemCFRecommender(_SparseCFRecommender):
    """Item-item CF with cosine similarity (``train_item_cf.py:38``)."""

    source = "item_cf"

    def __init__(self, matrix: StarMatrix, **kwargs):
        super().__init__(matrix, **kwargs)
        counts = matrix.item_counts().astype(np.float64)
        inv_norm = np.where(counts > 0, 1.0 / np.sqrt(np.maximum(counts, 1e-12)), 0.0)
        self._hat = CSR.from_host(self._indptr, self._cols, inv_norm[self._cols].astype(np.float32),
                                  matrix.n_items, self.device)
        self._hat_t = self._hat.transpose()
        # |S|.sum(axis=1) = Rhat^T (Rhat @ 1): two sparse matvecs, never the
        # I x I similarity matrix.
        ones = torch.ones((matrix.n_items, 1), dtype=torch.float32, device=self.device)
        t = spmm_rows(self._hat, ones)
        self._rowsum_s = spmm_rows(self._hat_t, t)[:, 0].contiguous()

    def _score_block(self, star_idx, k):
        r_block = dense_user_block(star_idx, self.matrix.n_items)   # (I, B)
        m1 = spmm_rows(self._hat, r_block)                           # (R_B @ Rhat^T)^T
        p = spmm_rows(self._hat_t, m1)                               # (... @ Rhat)^T
        return masked_topk(p.t(), star_idx, k, self._rowsum_s)


class UserCFRecommender(_SparseCFRecommender):
    """User-user CF with dice similarity (``train_user_cf.py:37``)."""

    source = "user_cf"

    def __init__(self, matrix: StarMatrix, **kwargs):
        super().__init__(matrix, **kwargs)
        self._r = CSR.from_host(self._indptr, self._cols, None, matrix.n_items, self.device)
        self._r_t = self._r.transpose()
        self._n_all = torch.as_tensor(np.diff(self._indptr).astype(np.float32)).to(self.device)

    def _score_block(self, star_idx, k):
        r_block = dense_user_block(star_idx, self.matrix.n_items)   # (I, B)
        inter = spmm_rows(self._r, r_block)                          # (U, B)
        n_block = r_block.sum(dim=0)
        sims = 2.0 * inter / torch.clamp_min(n_block[None, :] + self._n_all[:, None], 1e-12)
        denom = torch.clamp_min(sims.sum(dim=0, keepdim=True), 1e-12)
        p = spmm_rows(self._r_t, sims / denom)                       # (I, B)
        return masked_topk(p.t(), star_idx, k)
