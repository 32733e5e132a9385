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

On the card the epochs run as K18, the JAX ``run_jit``: epoch 0 eagerly,
then one epoch captured as a CUDA graph and replayed
(:meth:`RankingFactorization.fit`, ``utils/graphs.py``);
:meth:`RankingFactorization.fit_reference` is the eager loop.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from albedo_tpu_torch.datasets.star_matrix import StarMatrix
from albedo_tpu_torch.ops.bpr import bpr_step
from albedo_tpu_torch.ops.sgns import adam_dense, bias_table
from albedo_tpu_torch.ops.topk import topk_scores
from albedo_tpu_torch.utils.device import resolve_device
from albedo_tpu_torch.utils.graphs import replay_epochs


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
class _Fit:
    """A BPR fit's device state (:meth:`RankingFactorization.fit`)."""

    params: torch.Tensor            # flat x | y | b | w
    views: list[torch.Tensor]       # x (U, r), y (I, r), b (I,), w (d,) over params
    grads: torch.Tensor             # flat, zeroed by each Adam step
    grad_views: list[torch.Tensor]
    moments: tuple[torch.Tensor, torch.Tensor]
    g: torch.Tensor                 # (I, d) item side features
    rows: torch.Tensor              # (nnz,) users of the matrix's pairs
    cols: torch.Tensor              # (nnz,) their items
    loss_acc: torch.Tensor          # (1,) an epoch's summed step losses
    losses: torch.Tensor            # (epochs,) per-epoch mean loss
    bias: torch.Tensor              # (epochs * n_batches, 2) Adam's corrections (ops.sgns.bias_table)
    gen: torch.Generator
    n_batches: int
    # The schedule on the device: (epochs, n_batches * batch) permutations
    # and (epochs, n_batches, batch, negatives) negatives.
    schedule: tuple[torch.Tensor, torch.Tensor] | None
    report: dict


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
        """The fit of :meth:`fit_reference`, on the card as one CUDA graph
        of an epoch replayed (K18, the JAX ``run_jit``); on the CPU it is
        :meth:`fit_reference`.

        Epoch 0 runs eagerly; one epoch (the permutation and negatives, the
        gathers, K10 and Adam a batch, Adam reading its bias pair from the
        fit's table) is captured and replayed ``epochs - 1`` times
        (``utils.graphs.replay_epochs``); a ``schedule`` is uploaded once.
        K10's atomics add in an order that changes from run to run, so a
        graph fit equals an eager fit bit for bit only where no two pairs
        of a batch add into one element; the fit's generator ends where the
        eager loop leaves it. ``last_fit_report`` adds ``compile_s`` and
        ``compile_source``, 0.0 and None where nothing is captured (on the
        CPU, or one epoch)."""
        del user_side  # user-constant terms cancel in pairwise ranking
        dev = resolve_device(self.device)
        if dev.type == "cpu":
            return self.fit_reference(matrix, item_side=item_side, init=init, schedule=schedule)
        return self._fit_graph(self._start(matrix, item_side, init, schedule, dev))

    def _fit_graph(self, fit: _Fit) -> RankingFactorizationModel:
        """:meth:`fit`'s loop on the card: the epochs of ``fit`` through
        ``utils.graphs.replay_epochs``."""
        name = (f"BPR fit (rank {self.rank}, side width {fit.g.shape[1]}, batch {self.batch_size}, "
                f"{fit.n_batches} batches an epoch, {self.epochs} epochs)")
        t0 = time.perf_counter()
        replay_epochs(name, lambda *a: self._epoch(fit, *a), self.epochs, fit.bias, fit.losses, fit.schedule,
                      fit.gen, fit.report, "bpr.replays")
        return self._finish(fit, t0)

    def fit_reference(
        self,
        matrix: StarMatrix,
        user_side: np.ndarray | None = None,
        item_side: np.ndarray | None = None,
        init: tuple[np.ndarray, np.ndarray] | None = None,
        schedule: list[tuple[np.ndarray, np.ndarray]] | None = None,
    ) -> RankingFactorizationModel:
        """Train on the binary star matrix, each batch enqueued from Python
        (the plain version of :meth:`fit`). ``item_side`` (I, d) features
        enter as a learned linear term per item; ``user_side`` is accepted
        and cancels in the pairwise objective. ``init`` is the initial
        (x (U, rank), y (I, rank)); ``schedule`` holds, per epoch, the
        permutation of the matrix's nonzeros (at least ``n_batches *
        batch_size`` long) and the negatives (n_batches, batch_size,
        negatives). Either, when absent, is drawn from the seeded generator.
        The per-epoch mean loss, the step count and ``device_s`` (the
        loop's seconds, synchronized by the loss read, less ``compile_s``)
        are in ``last_fit_report``; the final flat parameters, Adam's
        moments and the fit's generator in ``last_fit_state``."""
        del user_side  # user-constant terms cancel in pairwise ranking
        fit = self._start(matrix, item_side, init, schedule, resolve_device(self.device))
        t0 = time.perf_counter()
        n = fit.n_batches
        for e in range(self.epochs):
            self._epoch(fit, fit.bias[e * n:(e + 1) * n], fit.losses[e:e + 1],
                        None if fit.schedule is None else tuple(t[e] for t in fit.schedule))
        return self._finish(fit, t0)

    def _start(self, matrix: StarMatrix, item_side, init, schedule, dev: torch.device) -> _Fit:
        """A fit's device state before its first epoch."""
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
        shapes = ((n_users, r), (n_items, r), (n_items,), (d,))
        params = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
        views = [t.view(s) for t, s in zip(params.split(sizes), shapes)]
        x, y = views[:2]
        if init is None:
            scale = 0.1 / np.sqrt(r)
            x.normal_(generator=gen).mul_(scale)
            y.normal_(generator=gen).mul_(scale)
        else:
            x.copy_(torch.as_tensor(np.array(init[0], np.float32)))
            y.copy_(torch.as_tensor(np.array(init[1], np.float32)))
        grads = torch.zeros_like(params)
        draws = None
        if schedule is not None:  # uploaded once; an epoch's slice is read on the device
            draws = (torch.as_tensor(np.stack([np.asarray(pm)[:pad] for pm, _ in schedule[: self.epochs]])
                                     .astype(np.int64)).to(dev),
                     torch.as_tensor(np.stack([np.asarray(ng, np.int32) for _, ng in schedule[: self.epochs]])).to(dev))
        return _Fit(
            params=params, views=views,
            grad_views=[t.view(s) for t, s in zip(grads.split(sizes), shapes)], grads=grads,
            moments=(torch.zeros_like(params), torch.zeros_like(params)), g=g, rows=rows, cols=cols,
            loss_acc=torch.zeros(1, dtype=torch.float32, device=dev),
            losses=torch.zeros(self.epochs, dtype=torch.float32, device=dev),
            bias=bias_table(self.epochs * n_batches, dev), gen=gen, n_batches=n_batches, schedule=draws,
            report={"pairs": n_pairs, "batches": n_batches, "steps": self.epochs * n_batches, "compile_s": 0.0,
                    "compile_source": None},
        )

    def _epoch(self, fit: _Fit, bias: torch.Tensor, loss_out: torch.Tensor,
               draws: tuple[torch.Tensor, torch.Tensor] | None) -> None:
        """One epoch of the eager loop, the unit both loops run: ``bias``
        (n_batches, 2) holds Adam's corrections of its steps, ``loss_out``
        (1,) gets its mean loss. Its permutation and negatives are
        ``draws`` (one epoch of the schedule), else drawn from the fit's
        generator."""
        dev, n, bs = fit.params.device, fit.n_batches, self.batch_size
        if draws is None:
            perm = torch.randperm(int(fit.rows.shape[0]), generator=fit.gen, device=dev)[: n * bs]
            negs = torch.randint(0, fit.g.shape[0], (n, bs, self.negatives), generator=fit.gen, device=dev,
                                 dtype=torch.int32)
        else:
            perm, negs = draws
        u_all = fit.rows[perm].view(n, bs)
        i_all = fit.cols[perm].view(n, bs)
        fit.loss_acc.zero_()
        for s in range(n):
            bpr_step(*fit.views, fit.g, u_all[s], i_all[s], negs[s], *fit.grad_views, fit.loss_acc, self.reg)
            adam_dense(fit.params, fit.grads, *fit.moments, bias[s], self.learning_rate)
        torch.div(fit.loss_acc, n, out=loss_out)

    def _finish(self, fit: _Fit, t0: float) -> RankingFactorizationModel:
        report = self.last_fit_report = fit.report
        report["epoch_loss"] = [float(v) for v in fit.losses.cpu()]
        report["device_s"] = time.perf_counter() - t0 - report["compile_s"]
        self.last_fit_state = {"params": fit.params, "moments": fit.moments, "generator": fit.gen}
        x, y, bias, w = fit.views
        item_bias = (bias + fit.g @ w).cpu().numpy()
        return RankingFactorizationModel(
            user_factors=x.cpu().numpy(),
            item_factors=y.cpu().numpy(),
            item_bias=item_bias.astype(np.float32),
            rank=self.rank,
            device=fit.params.device,
        )
