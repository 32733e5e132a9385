"""Implicit-feedback ALS estimator and model (PyTorch + CUDA).

Reference parity: Spark MLlib ``ALS`` as configured by
``ALSRecommenderBuilder.scala:46-58`` — implicitPrefs=true, rank=50,
regParam=0.5, alpha=40, maxIter=26, seed=42.

Port of the single-device resident fit of ``albedo_tpu/models/als.py``: the
ratings are uploaded once as tier-packed bucket groups, and each iteration is
two half-sweeps of bucket solves (``ops.als``: K1+K2 for Cholesky, K3 for
CG) on the device. Iteration order matches MLlib: item factors update first,
then user factors. ``gather_dtype="bfloat16"`` reads the fixed side's
table through a bf16 copy in both solvers (K1-bf16, K3-bf16); the factor
tables stay float32. Not ported yet (they raise ``NotImplementedError``):
the mesh, sharded and chunked fits, capacity admission and the
compiled-program cache.
"""

from __future__ import annotations

import dataclasses
import os
import time
import weakref
from typing import Any

import numpy as np
import torch

from albedo_tpu_torch.datasets.ragged import Bucket, grouped_bucket_rows, to_device
from albedo_tpu_torch.datasets.star_matrix import StarMatrix
from albedo_tpu_torch.ops.als import GATHER_DTYPES, fit_loop
from albedo_tpu_torch.ops.topk import topk_scores
from albedo_tpu_torch.utils.device import resolve_device


class ALSModel:
    """Trained factor tables on one device, indexed by dense user/item index.

    ``user_factors``/``item_factors`` are host (numpy) copies made on first
    access; scoring (:meth:`recommend`) stays on the device."""

    def __init__(self, user_factors: torch.Tensor, item_factors: torch.Tensor, rank: int):
        if user_factors.device != item_factors.device:
            raise ValueError("user and item factors must be on one device")
        self.user_table = user_factors
        self.item_table = item_factors
        self.rank = int(rank)
        self._uf_np: np.ndarray | None = None
        self._vf_np: np.ndarray | None = None

    @property
    def device(self) -> torch.device:
        return self.user_table.device

    @property
    def user_factors(self) -> np.ndarray:  # (n_users, rank) float32
        if self._uf_np is None:
            self._uf_np = self.user_table.cpu().numpy()
        return self._uf_np

    @property
    def item_factors(self) -> np.ndarray:  # (n_items, rank) float32
        if self._vf_np is None:
            self._vf_np = self.item_table.cpu().numpy()
        return self._vf_np

    def device_factors(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The resident ``(user_factors, item_factors)`` tables on the model's
        device, contiguous float32: what the serving batcher scores every
        request against (JAX ``models/als.py:78-105``; here the fit already
        leaves both tables on the device, so nothing is uploaded)."""
        self.user_table = self.user_table.contiguous()
        self.item_table = self.item_table.contiguous()
        return self.user_table, self.item_table

    def predict(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        u = self.user_factors[np.asarray(rows)]
        v = self.item_factors[np.asarray(cols)]
        return np.sum(u * v, axis=1)

    def recommend(
        self,
        user_indices: np.ndarray,
        k: int = 30,
        exclude_idx: np.ndarray | None = None,
        item_block: int = 4096,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k items for the given users: (scores (U, k), item_idx (U, k)),
        scored on the model's device (K5)."""
        ui = np.asarray(user_indices)
        n = self.user_table.shape[0]
        if ui.size and (int(ui.min()) < 0 or int(ui.max()) >= n):
            raise IndexError(f"user index out of range [0, {n}): {ui.min()}..{ui.max()}")
        rows = torch.as_tensor(ui, dtype=torch.int64).to(self.device)
        uf = self.user_table[rows].contiguous()
        excl = None
        if exclude_idx is not None:
            excl = torch.as_tensor(np.ascontiguousarray(exclude_idx, dtype=np.int32)).to(self.device)
        vals, idx = topk_scores(uf, self.item_table, k=k, exclude_idx=excl, item_block=item_block)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def to_arrays(self) -> dict[str, np.ndarray]:
        return {
            "user_factors": self.user_factors,
            "item_factors": self.item_factors,
            "rank": np.int64(self.rank),
        }

    @staticmethod
    def from_arrays(arrays: dict[str, np.ndarray], device: str | torch.device = "cuda") -> "ALSModel":
        """Load the dict ``to_arrays`` returns — of this package or of the
        JAX package's ``ALSModel`` (the payload of its pickled artifact)."""
        dev = resolve_device(device)
        return ALSModel(
            user_factors=torch.as_tensor(np.asarray(arrays["user_factors"], dtype=np.float32)).to(dev),
            item_factors=torch.as_tensor(np.asarray(arrays["item_factors"], dtype=np.float32)).to(dev),
            rank=int(arrays["rank"]),
        )


def _landing_perm(buckets: list[Bucket], n_target: int) -> np.ndarray:
    """Host-side inverse permutation for the gather-based landing
    (``ops.als.half_sweep``): position of each target row in the flattened
    solved blocks (group order, then bucket, then slot), with
    ``n_slots + r`` for rows in no bucket (keep the old factor)."""
    n_slots = sum(int(np.prod(b.row_ids.shape)) for b in buckets)
    landing = np.arange(n_slots, n_slots + n_target, dtype=np.int32)
    offset = 0
    for b in buckets:
        rid = b.row_ids.reshape(-1)
        pos = np.arange(rid.size, dtype=np.int32) + offset
        valid = rid >= 0
        landing[rid[valid]] = pos[valid]
        offset += rid.size
    return landing


# Per-matrix caches of the uploaded bucket groups, keyed by id() with a
# finalizer that drops the entry when the matrix is collected (the frozen
# dataclass cannot be a WeakKeyDictionary key: its __hash__ hashes arrays).
_LAYOUT_CACHES: dict[int, tuple[Any, dict]] = {}


def _matrix_cache(matrix: StarMatrix) -> dict:
    """Memo of the device layouts of one (immutable) matrix, living exactly as
    long as the matrix: a second fit on it skips bucketing and upload."""
    key = id(matrix)
    entry = _LAYOUT_CACHES.get(key)
    if entry is not None and entry[0]() is matrix:
        return entry[1]
    cache: dict = {}
    _LAYOUT_CACHES[key] = (weakref.ref(matrix), cache)
    weakref.finalize(matrix, _LAYOUT_CACHES.pop, key, None)
    return cache


@dataclasses.dataclass
class ImplicitALS:
    """Alternating least squares for implicit feedback on one device.

    Defaults mirror the reference's flagship config
    (``ALSRecommenderBuilder.scala:46-58``).
    """

    rank: int = 50
    reg_param: float = 0.5
    alpha: float = 40.0
    max_iter: int = 26
    seed: int = 42
    # "cholesky" = exact per-row solve, MLlib's algorithm (K1 + K2);
    # "cg" = matrix-free Jacobi-PCG warm-started from the previous sweep (K3).
    solver: str = "cholesky"
    cg_steps: int = 3
    # None = float32 gathers; "bfloat16" halves the gathered bytes (K1-bf16, K3-bf16).
    gather_dtype: str | None = None
    batch_size: int = 8192
    max_entries: int = 1 << 21  # B*L budget per bucket
    max_len: int | None = None
    # Optional (user_factors, item_factors) numpy warm start instead of the
    # seeded init.
    init_factors: tuple | None = None
    device: str | torch.device = "cuda"
    # Fields of the JAX estimator whose paths are not ported yet: any value
    # other than the default raises NotImplementedError in fit.
    mesh: Any | None = None
    chunked: bool | None = None
    sharded: Any | None = None

    def _layout_kwargs(self) -> dict:
        return dict(
            batch_size=self.batch_size,
            max_entries=self.max_entries,
            max_len=self.max_len,
        )

    def _groups_key(self, dev: torch.device) -> tuple:
        return ("device", self.batch_size, self.max_entries, self.max_len, str(dev))

    def device_groups(self, matrix: StarMatrix) -> tuple[list[Bucket], list[Bucket], torch.Tensor, torch.Tensor]:
        """(user_groups, item_groups, user_landing, item_landing) on the
        device, built and uploaded once per (matrix, layout, device)."""
        dev = resolve_device(self.device)
        key = self._groups_key(dev)
        cache = _matrix_cache(matrix)
        if key not in cache:
            workers = os.cpu_count() or 1
            sides = []
            for csx, n_target in ((matrix.csr(), matrix.n_users), (matrix.csc(), matrix.n_items)):
                grouped = grouped_bucket_rows(
                    *csx, **self._layout_kwargs(), workers=workers if workers > 1 else None
                )
                landing = torch.as_tensor(_landing_perm(grouped, n_target), dtype=torch.int64)
                sides.append(([to_device(g, dev) for g in grouped], landing.to(dev)))
            (ug, u_land), (ig, i_land) = sides
            cache[key] = (ug, ig, u_land, i_land)
        return cache[key]

    def _check_ported(self) -> None:
        if self.gather_dtype not in GATHER_DTYPES:
            raise ValueError(f"unknown gather_dtype {self.gather_dtype!r} (expected None or 'bfloat16')")
        if self.mesh is not None or self.sharded:
            raise NotImplementedError("mesh and sharded ALS fits are not ported yet")
        if self.chunked:
            raise NotImplementedError("the chunked host-streamed ALS fit is not ported yet")

    def fit(self, matrix: StarMatrix, callback: Any | None = None) -> ALSModel:
        """Train factors on ``self.device``.

        ``callback(iteration, user_factors, item_factors)`` if given is
        invoked after each full sweep with host (numpy) copies.

        ``self.last_fit_report`` records ``prep_s`` (bucket layout + upload;
        ~0 when this matrix's layout is cached), ``device_s`` (init and the
        sweeps, synchronized by the health read), ``prep_cached``,
        ``health`` (``utils.watchdog.health_dict`` of the final factors) and
        ``gather_dtype``.
        """
        self._check_ported()
        dev = resolve_device(self.device)
        t0 = time.perf_counter()
        cache_warm = self._groups_key(dev) in _matrix_cache(matrix)
        ug, ig, u_land, i_land = self.device_groups(matrix)
        t1 = time.perf_counter()

        if self.init_factors is not None:
            user_f = torch.as_tensor(np.asarray(self.init_factors[0], dtype=np.float32)).to(dev)
            item_f = torch.as_tensor(np.asarray(self.init_factors[1], dtype=np.float32)).to(dev)
        else:
            # torch's generator cannot reproduce jax.random: seeded fits of the
            # two packages agree in quality (NDCG), not in factors.
            gen = torch.Generator(device=dev).manual_seed(self.seed)
            scale = 1.0 / np.sqrt(self.rank)
            user_f = torch.randn((matrix.n_users, self.rank), generator=gen, device=dev) * scale
            item_f = torch.randn((matrix.n_items, self.rank), generator=gen, device=dev) * scale

        host_callback = None
        if callback is not None:
            def host_callback(it, uf, vf):
                callback(it, uf.cpu().numpy(), vf.cpu().numpy())

        user_f, item_f = fit_loop(
            user_f, item_f, ug, ig, u_land, i_land,
            float(self.reg_param), float(self.alpha), int(self.max_iter),
            solver=self.solver, cg_steps=self.cg_steps, callback=host_callback,
            gather_dtype=self.gather_dtype,
        )
        # The health vector depends on every factor element, so reading it
        # to the host is also the fit's completion barrier.
        from albedo_tpu_torch.utils.watchdog import factor_health, health_dict

        health = health_dict(factor_health(user_f, item_f))
        t2 = time.perf_counter()
        self.last_fit_report = {
            "prep_s": round(t1 - t0, 4),
            "device_s": round(t2 - t1, 4),
            "prep_cached": bool(cache_warm),
            "health": health,
            "mode": "resident",
            "gather_dtype": self.gather_dtype,
        }
        return ALSModel(user_factors=user_f, item_factors=item_f, rank=self.rank)
