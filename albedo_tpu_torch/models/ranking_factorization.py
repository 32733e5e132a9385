"""Ranking matrix factorization with optional side features, trained on the
card (PyTorch + CUDA).

Port of ``albedo_tpu/models/ranking_factorization.py``. Reference parity:
``app/management/commands/train_graphlab.py:25-31`` — graphlab's
``ranking_factorization_recommender`` (num_factors=32, binary target) over
the binary star matrix, then ``recommend(users, k=50, exclude_known=True)``.

The objective is BPR: for each observed (user, item) pair,
``-log sigmoid(s(u, i+) - s(u, i-))`` against N sampled negatives, with item
scores ``x_u . y_i + b_i + w . g_i`` (user-constant terms cancel in a
pairwise loss). Each minibatch is one K10 ``bpr_step`` (``ops/bpr.py``) and
one ``adam_dense`` launch over a flat buffer that holds x, y, b and w, as
``optax.adam`` updates every element of every leaf. Retrieval folds the
item bias and side terms into an augmented factor column, so K5 serves it
at rank + 1.

Torch cannot reproduce ``jax.random``: :meth:`RankingFactorization.fit`
takes the initial factors (``init``) and, per epoch, the permutation and the
negatives (``schedule``) as arguments, so a test can hand it the JAX
module's own draws. When they are absent, they are drawn from one
``torch.Generator`` on the fit's device seeded with ``seed``; seeded fits
are then compared by metric.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from albedo_tpu_torch.datasets.star_matrix import StarMatrix
from albedo_tpu_torch.ops.bpr import bpr_step
from albedo_tpu_torch.ops.sgns import adam_dense
from albedo_tpu_torch.ops.topk import topk_scores
from albedo_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class RankingFactorizationModel:
    """Trained factors + item bias (side contributions folded in), host
    arrays; :meth:`recommend` scores on ``device``."""

    user_factors: np.ndarray   # (U, k)
    item_factors: np.ndarray   # (I, k)
    item_bias: np.ndarray      # (I,) = b_i + w_i . g_i
    rank: int
    device: str | torch.device = "cuda"

    def score(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        u = self.user_factors[np.asarray(rows)]
        v = self.item_factors[np.asarray(cols)]
        return np.sum(u * v, axis=1) + self.item_bias[np.asarray(cols)]

    def recommend(
        self,
        user_indices: np.ndarray,
        k: int = 50,
        exclude_idx: np.ndarray | None = None,
        item_block: int = 4096,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k by K5 over factors augmented with a constant-1 column
        against the item-bias column: ``(scores (U, k), item_idx (U, k))``."""
        dev = resolve_device(self.device)
        uf = np.concatenate(
            [self.user_factors[np.asarray(user_indices)],
             np.ones((len(user_indices), 1), np.float32)], axis=1,
        )
        vf = np.concatenate([self.item_factors, self.item_bias[:, None].astype(np.float32)], axis=1)

        def to(a, dtype=np.float32):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype)).to(dev)

        excl = None if exclude_idx is None else to(exclude_idx, np.int32)
        vals, idx = topk_scores(to(uf), to(vf), k=k, exclude_idx=excl, item_block=item_block)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def to_arrays(self) -> dict[str, np.ndarray]:
        return {
            "user_factors": self.user_factors,
            "item_factors": self.item_factors,
            "item_bias": self.item_bias,
            "rank": np.int64(self.rank),
        }

    @staticmethod
    def from_arrays(arrays: dict[str, np.ndarray], device: str | torch.device = "cuda") -> "RankingFactorizationModel":
        """Load the dict ``to_arrays`` returns — of this package or of the
        JAX package's model."""
        return RankingFactorizationModel(
            user_factors=np.asarray(arrays["user_factors"], np.float32),
            item_factors=np.asarray(arrays["item_factors"], np.float32),
            item_bias=np.asarray(arrays["item_bias"], np.float32),
            rank=int(arrays["rank"]),
            device=device,
        )


@dataclasses.dataclass
class RankingFactorization:
    """BPR-trained implicit ranking factorization. Defaults mirror
    graphlab's ``ranking_factorization_recommender``: num_factors=32,
    binary target, implicit ranking objective."""

    rank: int = 32
    reg: float = 1e-4
    learning_rate: float = 0.05
    epochs: int = 10
    batch_size: int = 8192
    negatives: int = 4
    seed: int = 42
    device: str | torch.device = "cuda"

    def fit(
        self,
        matrix: StarMatrix,
        user_side: np.ndarray | None = None,
        item_side: np.ndarray | None = None,
        init: tuple[np.ndarray, np.ndarray] | None = None,
        schedule: list[tuple[np.ndarray, np.ndarray]] | None = None,
    ) -> RankingFactorizationModel:
        """Train on the binary star matrix. ``item_side`` (I, d) features
        enter as a learned linear term per item; ``user_side`` is accepted
        and cancels in the pairwise objective. ``init`` is the initial
        (x (U, rank), y (I, rank)); ``schedule`` holds, per epoch, the
        permutation of the matrix's nonzeros (at least ``n_batches *
        batch_size`` long) and the negatives (n_batches, batch_size,
        negatives). Either, when absent, is drawn from the seeded generator.
        The per-epoch mean loss is in ``last_fit_report``."""
        del user_side  # user-constant terms cancel in pairwise ranking
        dev = resolve_device(self.device)
        n_users, n_items, r = matrix.n_users, matrix.n_items, self.rank
        n_pairs = int(matrix.nnz)
        n_batches = max(1, n_pairs // self.batch_size)
        pad = n_batches * self.batch_size
        rows = torch.as_tensor(matrix.rows.astype(np.int32)).to(dev)
        cols = torch.as_tensor(matrix.cols.astype(np.int32)).to(dev)
        side = item_side if item_side is not None else np.zeros((n_items, 1), np.float32)
        g = torch.as_tensor(np.ascontiguousarray(side, dtype=np.float32)).to(dev)
        d = g.shape[1]

        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        # One flat buffer x | y | b | w, its gradient and Adam moments.
        sizes = [n_users * r, n_items * r, n_items, d]
        params = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
        x, y, bias, w = (t.view(s) for t, s in zip(
            params.split(sizes), ((n_users, r), (n_items, r), (n_items,), (d,))))
        if init is None:
            scale = 0.1 / np.sqrt(r)
            x.normal_(generator=gen).mul_(scale)
            y.normal_(generator=gen).mul_(scale)
        else:
            x.copy_(torch.as_tensor(np.array(init[0], np.float32)))
            y.copy_(torch.as_tensor(np.array(init[1], np.float32)))
        grads = torch.zeros_like(params)
        gx, gy, gb, gw = (t.view(s) for t, s in zip(
            grads.split(sizes), ((n_users, r), (n_items, r), (n_items,), (d,))))
        moments = (torch.zeros_like(params), torch.zeros_like(params))
        loss_acc = torch.zeros(1, dtype=torch.float32, device=dev)
        count = 0
        epoch_loss = []
        for epoch in range(self.epochs):
            if schedule is None:
                perm = torch.randperm(n_pairs, generator=gen, device=dev)[:pad]
                negs = torch.randint(0, n_items, (n_batches, self.batch_size, self.negatives),
                                     generator=gen, device=dev, dtype=torch.int32)
            else:
                perm = torch.as_tensor(np.array(schedule[epoch][0][:pad], np.int64)).to(dev)
                negs = torch.as_tensor(np.array(schedule[epoch][1], np.int32)).to(dev)
            u_all = rows[perm].view(n_batches, self.batch_size)
            i_all = cols[perm].view(n_batches, self.batch_size)
            loss_acc.zero_()
            for s in range(n_batches):
                bpr_step(x, y, bias, w, g, u_all[s], i_all[s], negs[s], gx, gy, gb, gw, loss_acc, self.reg)
                count += 1
                adam_dense(params, grads, *moments, count, self.learning_rate)
            epoch_loss.append(loss_acc / n_batches)
        self.last_fit_report = {
            "pairs": n_pairs, "batches": n_batches, "steps": count,
            "epoch_loss": [float(v) for v in torch.cat(epoch_loss).cpu()] if epoch_loss else [],
        }
        item_bias = (bias + g @ w).cpu().numpy()
        return RankingFactorizationModel(
            user_factors=x.cpu().numpy(),
            item_factors=y.cpu().numpy(),
            item_bias=item_bias.astype(np.float32),
            rank=r,
            device=dev,
        )
