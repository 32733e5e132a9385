"""User x item scoring with a streaming top-k (PyTorch + CUDA).

Port of ``albedo_tpu/ops/topk.py``, the retrieval hot loop of the
reference's ``recommenders/ALSRecommender.scala:21-61``. K5
:func:`topk_scores` runs the CUDA kernel ``topk_scores``: one CTA per query
row streams the item table, masks the row's excluded items and keeps a
running top-k, so no U x I score matrix is ever written. It takes any rank:
factor tables (r <= 64) and the wide rows of the content sources (K14:
tf-idf rows, r ~ 3000; Word2Vec document vectors, r = 200), which it
streams through shared memory in chunks. The plain PyTorch version
(:func:`topk_scores_reference`) builds the score matrix and sorts it.

Both return exactly the JAX program's answer: the k admissible items ordered
by score descending, then item index ascending, with the remaining slots
``(-inf, -1)``.
"""

from __future__ import annotations

import torch

from albedo_tpu_torch.kernels.build import call, check_operand, on_cpu

RMAX = 64            # widest rank of the narrow path; wider rows take the wide path
KMAX = 128           # largest k the kernel keeps
EXCLUDE_MAX = 32768  # longest exclusion row the kernel sorts in shared memory


def _scores(user_factors: torch.Tensor, item_factors: torch.Tensor) -> torch.Tensor:
    """(U, I) dot products accumulated one rank term at a time, each multiply
    and add rounded separately, in the kernel's order (so the two agree bit
    for bit, and duplicated item rows score exactly equal)."""
    scores = torch.zeros(
        (user_factors.shape[0], item_factors.shape[0]),
        dtype=torch.float32, device=user_factors.device,
    )
    for c in range(user_factors.shape[1]):
        scores = scores + user_factors[:, c, None] * item_factors[None, :, c]
    return scores


def topk_scores_reference(
    user_factors: torch.Tensor,               # (U, r) f32
    item_factors: torch.Tensor,               # (I, r) f32
    k: int,
    exclude_idx: torch.Tensor | None = None,  # (U, E) int32, -1 = none
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: score everything, then :func:`exclude_and_rank`."""
    return exclude_and_rank(_scores(user_factors, item_factors), k, exclude_idx)


def exclude_and_rank(
    scores: torch.Tensor, k: int, exclude_idx: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The top-k of each row of a dense (U, I) score block: mask each row's
    excluded items (-1-padded, any order, duplicates allowed) to -inf, then
    order by (score desc, index asc) with two stable steps (the items are
    already in index order; a stable descending sort keeps it among equal
    scores); slots past the admissible items are ``(-inf, -1)``."""
    n_users, n_items = scores.shape
    dev = scores.device
    if exclude_idx is not None and exclude_idx.numel():
        ex = exclude_idx.long()
        ex = torch.where((ex < 0) | (ex >= n_items), n_items, ex)
        hit = torch.zeros((n_users, n_items + 1), dtype=torch.bool, device=dev)
        hit.scatter_(1, ex, True)
        scores = scores.masked_fill(hit[:, :n_items], float("-inf"))
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k].to(torch.int32)
    if n_items < k:
        pad = k - n_items
        vals = torch.cat([vals, torch.full((n_users, pad), float("-inf"), device=dev)], dim=1)
        idx = torch.cat([idx, torch.full((n_users, pad), -1, dtype=torch.int32, device=dev)], dim=1)
    idx = torch.where(vals == float("-inf"), -1, idx).to(torch.int32)
    return vals, idx


def topk_scores(
    user_factors: torch.Tensor,
    item_factors: torch.Tensor,
    k: int,
    exclude_idx: torch.Tensor | None = None,
    item_block: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5: ``(scores (U, k) f32, item_indices (U, k) int32)`` of the top-k
    items per user (CUDA kernel ``topk_scores``). ``exclude_idx`` rows list
    per-user items to drop (-1-padded, any order, duplicates allowed).
    ``item_block`` is accepted for the JAX signature and not used: the
    kernel picks its own tile."""
    del item_block
    operands = [user_factors, item_factors] + ([] if exclude_idx is None else [exclude_idx])
    if on_cpu("topk_scores", *operands):
        return topk_scores_reference(user_factors, item_factors, k, exclude_idx)
    n_users, r = user_factors.shape
    n_items = item_factors.shape[0]
    if r < 1:
        raise ValueError(f"topk_scores: the CUDA kernel takes ranks >= 1, got {r}")
    if not 1 <= k <= KMAX:
        raise ValueError(f"topk_scores: the CUDA kernel takes k in 1..{KMAX}, got {k}")
    dev = user_factors.device
    check_operand("topk_scores", "user_factors", user_factors, torch.float32, (n_users, r), dev)
    check_operand("topk_scores", "item_factors", item_factors, torch.float32, (n_items, r), dev)
    n_excl, excl_pad, excl_ptr = 0, 0, None
    if exclude_idx is not None and exclude_idx.shape[1] > 0:
        n_excl = int(exclude_idx.shape[1])
        if n_excl > EXCLUDE_MAX:
            raise ValueError(f"topk_scores: exclusion rows longer than {EXCLUDE_MAX} are not supported, got {n_excl}")
        check_operand("topk_scores", "exclude_idx", exclude_idx, torch.int32, (n_users, n_excl), dev)
        excl_pad = 1 << (n_excl - 1).bit_length()
        excl_ptr = exclude_idx.data_ptr()
    vals = torch.empty((n_users, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n_users, k), dtype=torch.int32, device=dev)
    call(
        "topk_scores", dev, user_factors.data_ptr(), item_factors.data_ptr(), excl_ptr,
        vals.data_ptr(), idx.data_ptr(), n_users, n_items, r, k, n_excl,
        excl_pad, count="topk_scores_wide" if r > RMAX else None,
    )
    return vals, idx
