"""User x item scoring with a top-k (PyTorch + CUDA).

Port of ``albedo_tpu/ops/topk.py``, the retrieval hot loop of the
reference's ``recommenders/ALSRecommender.scala:21-61``. K5
:func:`topk_scores` runs the CUDA kernel ``topk_scores``
(``csrc/topk_scores.cu``): a grid of (32-row tile) x (item split) scores the
rows against the item table through shared memory, each (row, split) keeps
its best k (above k = 32, only the keys at or above a floor that a first
pass at k <= 32 finds), and one CTA per row merges its splits' keys, so no
U x I score matrix is ever written and one query row spreads over the card.
It takes any rank: factor tables (r <= 64) and the wide rows of the content
sources (K14: tf-idf rows, r ~ 3000; Word2Vec document vectors, r = 200);
any exclusion width (the exclusions become a bitmask); and any k. Up to
k = 512 (the serving path's ``max_k`` = 500, rounded up to a power of two)
it runs that kernel; beyond (or above k = 32 with fewer 32-item tiles than
the first pass needs), the same wrapper runs the select path
(``csrc/topk_select.cu``): the masked scores of a chunk of rows are written
to a scratch buffer and each row's top k is found by a radix select, in the
same order and with the same scores.

Two kernels run the streaming body K5 ran before its split design
(``csrc/topk_body.cuh``: one CTA per query row) with another prologue:

- K6 :func:`gather_topk`, the serving micro-batcher's batch program
  (``albedo_tpu/serving/batcher.py`` ``_gather_topk``,
  ``_gather_topk_device_excl``): the query rows and the exclusion rows are
  gathered by the kernel from the resident tables;
- K7 :func:`bank_query`, one source of the retrieval bank's query program
  (``albedo_tpu/retrieval/bank.py`` ``_make_query_program``): a user-table
  row, or the L2-normalized mean of example rows built in the kernel.

The plain PyTorch versions (``*_reference``) build the score matrix and sort
it. All return exactly the JAX program's answer: the k admissible items
ordered by score descending, then item index ascending, with the remaining
slots ``(-inf, -1)``. (K5 also follows JAX on NaN scores: +NaN ranks first,
-NaN is never admitted; K6, K7 and the select path never admit a NaN.)
"""

from __future__ import annotations

import torch

from albedo_tpu_torch.kernels.build import call, check_operand, on_cpu
from albedo_tpu_torch.utils import pow2_at_least

RMAX = 64            # widest rank of K5's narrow count; wider rows count as topk_scores_wide (K14)
KMAX = 512           # largest k of K5's kernel and K6/K7's streaming body; larger k takes the select path
EXCLUDE_MAX = 32768  # longest exclusion row the streaming body (K6, K7) sorts in shared memory
# Dynamic shared memory the streaming kernels may ask for: the card's 227 KB
# per block less their static running list (at most 16.4 KB at k > 128).
SMEM_MAX = 232448 - 17 * 1024
SELECT_SCRATCH = 256 << 20  # bytes of select-path scratch per launch (rows are chunked to fit)
SORT_SMEM_MAX = 64 * 1024   # the select path sorts in shared memory up to this many bytes
MAX_GRID_Y = 65535          # the select path's score grid spans a chunk's rows in y
# K5's plan (csrc/topk_scores.cu): a CTA scores 32 rows; its item tile is
# 32 or 128 items; the workspace (each (row, split)'s keys, the first pass's
# keys and the exclusion bitmask) of one pass of rows stays under
# K5_WORKSPACE bytes, and the merge kernel's shared memory under
# K5_MERGE_SMEM.
K5_ROWS = 32
K5_WORKSPACE = 64 << 20
K5_MERGE_SMEM = 96 * 1024
K5_MAX_SPLITS = 1024        # splits of a row the merge kernel takes
SM_SHARED = 233472          # shared memory of one SM (228 KB), for the CTAs an SM holds


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
    scores); slots past the admissible items are ``(-inf, -1)``. NaN scores
    follow ``lax.top_k``'s total order: a NaN with the sign bit clear ranks
    above +inf, one with it set below -inf (never admitted)."""
    n_users, n_items = scores.shape
    dev = scores.device
    scores = scores.masked_fill(torch.isnan(scores) & torch.signbit(scores), float("-inf"))
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
    _check_k("topk_scores", k)
    n_users, r = user_factors.shape
    n_items = item_factors.shape[0]
    dev = user_factors.device
    _check_rank("topk_scores", r)
    check_operand("topk_scores", "user_factors", user_factors, torch.float32, (n_users, r), dev)
    check_operand("topk_scores", "item_factors", item_factors, torch.float32, (n_items, r), dev)
    excl_ptr, n_excl, _ = _exclusion("topk_scores", "exclude_idx", exclude_idx, n_users, dev)
    vals, idx = _outputs(n_users, k, dev)
    if not _k5_takes(n_items, k):
        _select("topk_scores", dev, vals, idx, users=user_factors, items=item_factors,
                excl=exclude_idx, n_rows=n_users, k=k, n_excl=n_excl)
        return vals, idx
    tile, split, split1, rows = _k5_plan(n_users, n_items, k, n_excl > 0,
                                         torch.cuda.get_device_properties(dev).multi_processor_count)
    # One workspace: the lists (rows x splits x pow2(k) keys; with a first
    # pass, then a count of each), the first pass's keys (rows x its splits)
    # and the exclusion bits (rows x I/32).
    n_splits = max(1, -(-n_items // split))
    n_ws = rows * n_splits * pow2_at_least(k) + (-(-rows * n_splits // 2) if k > 32 else 0)
    n_bws = rows * -(-n_items // split1) if k > 32 else 0
    n_mask = max(1, -(-rows * -(-n_items // 32) // 2)) if n_excl else 0
    ws = torch.empty(n_ws + n_bws + n_mask, dtype=torch.int64, device=dev)
    base = ws.data_ptr()
    call(
        "topk_scores", dev, user_factors.data_ptr(), item_factors.data_ptr(), excl_ptr,
        vals.data_ptr(), idx.data_ptr(), n_users, n_items, r, k, n_excl, tile, split, split1, rows,
        base, base + 8 * n_ws if k > 32 else None, base + 8 * (n_ws + n_bws) if n_excl else None,
        count="topk_scores_wide" if r > RMAX else None,
    )
    return vals, idx


def _k5_takes(n_items: int, k: int) -> bool:
    """K5's kernel takes k <= KMAX, and above k = 32 needs the ceil(k / 32)
    first-pass splits of at least 32 items each; other calls take the select
    path."""
    return k <= 32 or (k <= KMAX and -(-n_items // 32) >= -(-k // 32))


def _k5_smem(tile: int, k: int) -> int:
    """Dynamic shared memory of K5's score kernel (``score_smem`` in
    ``csrc/topk_scores.cu``): its staging stages of 64 columns and, above
    k = 32, the warps' candidate buffers."""
    stages = 2 if tile == 128 else 4
    return 4 * stages * (K5_ROWS + tile) * 68 + (8 * 8 * tile if k > 32 else 0)


def _k5_splits(row_tiles: int, n_tiles: int, tile: int, k: int, n_sm: int, cap: int) -> int:
    """Tiles per split so that row tiles x splits fill one wave of the CTAs
    the card holds at this k (at most ``cap`` splits)."""
    per_sm = max(1, min(4, SM_SHARED // (_k5_smem(tile, k) + 1024)))
    n_splits = max(1, min(n_tiles, cap, n_sm * per_sm // row_tiles))
    return -(-n_tiles // n_splits)


def _k5_plan(n_users: int, n_items: int, k: int, excl: bool, n_sm: int,
             tile: int | None = None) -> tuple[int, int, int, int]:
    """(item tile, items per split, items per first-pass split, rows per
    pass) of a K5 launch: the 128-item tile where the grid has enough CTAs
    with it, else 32 (or ``tile``); above k = 32 a first pass at k1 <= 32
    over at least ceil(k / 32) splits (the caller sends a call with fewer
    32-item tiles than that to the select path) gives each row its floor;
    splits that fill one wave of the CTAs ``n_sm`` SMs hold (each pass), no
    more than the merge kernel takes; rows cut so that a pass's workspace
    stays under K5_WORKSPACE."""
    lp = pow2_at_least(k)
    need = -(-k // 32)
    row_tiles = max(1, -(-n_users // K5_ROWS))
    if tile is None:
        n_tiles = max(1, -(-n_items // 128))
        tile = 128 if row_tiles * n_tiles >= 2 * n_sm and (k <= 32 or n_tiles >= need) else 32
    n_tiles = max(1, -(-n_items // tile))
    split1 = n_bound = 0
    if k > 32:
        tiles1 = _k5_splits(row_tiles, n_tiles, tile, 32, n_sm, n_tiles)
        if -(-n_tiles // tiles1) < need:
            tiles1 = n_tiles // need
        split1 = tiles1 * tile
        n_bound = -(-n_items // split1)
    # Above k = 32 the merge kernel gathers a row's keys into pow2(splits)
    # slots of lp keys in shared memory.
    cap = K5_MAX_SPLITS
    if k > 32:
        cap = max(1, K5_MERGE_SMEM // (8 * lp))
        cap = 1 << (cap.bit_length() - 1)
    split = _k5_splits(row_tiles, n_tiles, tile, k, n_sm, cap) * tile
    n_splits = max(1, -(-n_items // split))
    per_row = 8 * n_splits * lp + (4 * n_splits + 8 * n_bound if k > 32 else 0) + (
        4 * -(-n_items // 32) if excl else 0)
    rows = max(K5_ROWS, K5_WORKSPACE // per_row // K5_ROWS * K5_ROWS)
    return tile, split, split1, min(rows, row_tiles * K5_ROWS)


def _check_k(kernel: str, k: int) -> None:
    if k < 1:
        raise ValueError(f"{kernel}: takes k >= 1, got {k}")


def _check_rank(kernel: str, r: int) -> None:
    if r < 1:
        raise ValueError(f"{kernel}: the CUDA kernel takes ranks >= 1, got {r}")


def _exclusion(kernel: str, name: str, table, n_rows: int, dev) -> tuple[int | None, int, int]:
    """(pointer, width, width rounded up to a power of two) of a -1-padded
    int32 exclusion table of ``n_rows`` rows, or (None, 0, 0)."""
    if table is None or table.shape[1] == 0:
        return None, 0, 0
    width = int(table.shape[1])
    check_operand(kernel, name, table, torch.int32, (n_rows, width), dev)
    return table.data_ptr(), width, pow2_at_least(width)


def _select_path(k: int, r: int, n_excl: int, excl_pad: int, dpad: int = 0) -> bool:
    """True when a K6 or K7 launch exceeds the streaming body (topk_body.cuh): k above
    KMAX, an exclusion row longer than EXCLUDE_MAX, or more dynamic shared
    memory (the sorted exclusion row, the wide path's tile, the mean query)
    than the card gives a block."""
    smem = 4 * excl_pad + (4 * (256 * 33 + 32) if r > RMAX else 0) + 8 * dpad
    return k > KMAX or n_excl > EXCLUDE_MAX or smem > SMEM_MAX


def _select(
    kernel: str, dev, vals: torch.Tensor, idx: torch.Tensor, *, items: torch.Tensor,
    n_rows: int, k: int, n_excl: int, users: torch.Tensor | None = None,
    user_idx: torch.Tensor | None = None, excl: torch.Tensor | None = None,
    excl_by_user: bool = False, excl_map: torch.Tensor | None = None,
    mean_rows: bool = False, dpad: int = 0,
) -> None:
    """Run the select path (``csrc/topk_select.cu``) into ``vals``/``idx``
    over row chunks whose scratch (the masked score rows, the query rows and,
    for a large k, the sort buffers) stays under SELECT_SCRATCH bytes;
    counted as ``<kernel>_select``. The operands are checked by the caller."""
    n_items, r = items.shape
    sort_pad = pow2_at_least(max(1, min(k, n_items)))
    sort_global = 8 * sort_pad > SORT_SMEM_MAX
    qstride = 2 * dpad if mean_rows else r
    per_row = 4 * n_items + 4 * qstride + 4 + (8 * sort_pad if sort_global else 0)
    rows = max(1, min(n_rows, MAX_GRID_Y, SELECT_SCRATCH // per_row))
    qbuf = torch.empty(rows * qstride, dtype=torch.float32, device=dev)
    has = torch.empty(rows, dtype=torch.int32, device=dev)
    scratch = torch.empty(rows * n_items, dtype=torch.float32, device=dev)
    sortbuf = torch.empty(rows * sort_pad, dtype=torch.int64, device=dev) if sort_global else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    for row0 in range(0, n_rows, rows):
        call(
            "topk_select", dev, ptr(users), items.data_ptr(), ptr(user_idx),
            ptr(excl) if n_excl else None, int(excl_by_user), ptr(excl_map), int(mean_rows),
            vals.data_ptr(), idx.data_ptr(), row0, min(rows, n_rows - row0), n_items, r, k,
            n_excl, dpad, qbuf.data_ptr(), has.data_ptr(), scratch.data_ptr(), ptr(sortbuf),
            sort_pad, count=f"{kernel}_select",
        )


def _outputs(n_rows: int, k: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty((n_rows, k), dtype=torch.float32, device=dev),
            torch.empty((n_rows, k), dtype=torch.int32, device=dev))


def gather_topk_reference(
    uf_all: torch.Tensor,                      # (N, r) f32 user table
    item_factors: torch.Tensor,                # (I, r) f32
    user_idx: torch.Tensor,                    # (B,) int32 rows of uf_all
    k: int,
    exclude: torch.Tensor | None = None,       # (B, E) int32, row b for query b
    exclude_table: torch.Tensor | None = None,  # (N, E) int32, gathered by user_idx
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6: gather, then :func:`topk_scores_reference`."""
    rows = user_idx.long()
    excl = exclude if exclude_table is None else exclude_table[rows]
    return topk_scores_reference(uf_all[rows], item_factors, k, excl)


def gather_topk(
    uf_all: torch.Tensor,
    item_factors: torch.Tensor,
    user_idx: torch.Tensor,
    k: int,
    exclude: torch.Tensor | None = None,
    exclude_table: torch.Tensor | None = None,
    out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6: ``(scores (B, k) f32, item_indices (B, k) int32)``, the top-k
    items of users ``user_idx`` (CUDA kernel ``gather_topk``). Exclusion is
    none, the batch's own -1-padded rows ``exclude`` (B, E), or the device
    table of every user's history ``exclude_table`` (N, E), whose row
    ``user_idx[b]`` query b excludes; at most one of the two. Each row is
    bit-identical to :func:`topk_scores` of that user's factor row with
    that user's exclusion row, whatever else the batch holds. The caller
    keeps ``user_idx`` in range (the plain version raises, the kernel cannot).
    ``out``, a (2, B, k) float32 buffer, receives the scores and the index
    bits (the returned tensors are its two halves), so one copy fetches both."""
    if exclude is not None and exclude_table is not None:
        raise ValueError("gather_topk: pass exclude or exclude_table, not both")
    operands = [uf_all, item_factors, user_idx] + [t for t in (exclude, exclude_table, out) if t is not None]
    if on_cpu("gather_topk", *operands):
        vals, idx = gather_topk_reference(uf_all, item_factors, user_idx, k, exclude, exclude_table)
        if out is None:
            return vals, idx
        out[0].copy_(vals)
        out[1].view(torch.int32).copy_(idx)
        return out[0], out[1].view(torch.int32)
    _check_k("gather_topk", k)
    n_users, r = uf_all.shape
    n_items, b = item_factors.shape[0], user_idx.shape[0]
    dev = uf_all.device
    _check_rank("gather_topk", r)
    check_operand("gather_topk", "uf_all", uf_all, torch.float32, (n_users, r), dev)
    check_operand("gather_topk", "item_factors", item_factors, torch.float32, (n_items, r), dev)
    check_operand("gather_topk", "user_idx", user_idx, torch.int32, (b,), dev)
    by_user = exclude_table is not None
    excl_ptr, n_excl, excl_pad = _exclusion(
        "gather_topk", "exclude_table" if by_user else "exclude",
        exclude_table if by_user else exclude, n_users if by_user else b, dev,
    )
    if out is None:
        vals, idx = _outputs(b, k, dev)
    else:
        check_operand("gather_topk", "out", out, torch.float32, (2, b, k), dev)
        vals, idx = out[0], out[1].view(torch.int32)
    if _select_path(k, r, n_excl, excl_pad):
        _select("gather_topk", dev, vals, idx, users=uf_all, items=item_factors, user_idx=user_idx,
                excl=exclude_table if by_user else exclude, excl_by_user=by_user, n_rows=b, k=k,
                n_excl=n_excl)
        return vals, idx
    call(
        "gather_topk", dev, uf_all.data_ptr(), item_factors.data_ptr(), user_idx.data_ptr(),
        excl_ptr, int(by_user), vals.data_ptr(), idx.data_ptr(), b, n_items, r, k, n_excl, excl_pad,
    )
    return vals, idx


def mean_query_reference(vectors: torch.Tensor, q_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(queries (B, d) f32, has_query (B,) bool)``: per row of ``q_idx``
    (-1-padded rows of ``vectors``), the masked mean of the listed rows,
    divided by max(count, 1) and then by max(||q||_2, 1e-9). The steps and
    their order are K7's: the rows summed in list order, the squares by a
    pairwise tree over d rounded up to a power of two, zero-padded."""
    valid = q_idx >= 0
    rows = vectors[q_idx.clamp(min=0).long()]          # (B, Q, d)
    acc = torch.zeros((q_idx.shape[0], vectors.shape[1]), dtype=torch.float32, device=vectors.device)
    for j in range(q_idx.shape[1]):
        acc = acc + torch.where(valid[:, j, None], rows[:, j], 0.0)
    acc = acc / valid.sum(dim=1, dtype=torch.float32).clamp_min(1.0)[:, None]
    sq = acc * acc
    sq = torch.nn.functional.pad(sq, (0, pow2_at_least(sq.shape[1]) - sq.shape[1]))
    while sq.shape[1] > 1:
        half = sq.shape[1] // 2
        sq = sq[:, :half] + sq[:, half:]
    return acc / torch.sqrt(sq[:, 0]).clamp_min(1e-9)[:, None], valid.any(dim=1)


def bank_query_reference(
    vectors: torch.Tensor,
    k: int,
    users: torch.Tensor | None = None,
    user_idx: torch.Tensor | None = None,
    exclude_table: torch.Tensor | None = None,
    excl_map: torch.Tensor | None = None,
    q_idx: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7 (see :func:`bank_query`)."""
    if q_idx is None:
        rows = user_idx.long()
        excl = None
        if exclude_table is not None:
            excl = exclude_table[rows]
            if excl_map is not None:
                excl = torch.where(excl < 0, -1, excl_map[excl.clamp(min=0).long()])
        return topk_scores_reference(users[rows], vectors, k, excl)
    qv, has_q = mean_query_reference(vectors, q_idx)
    vals, idx = topk_scores_reference(qv, vectors, k, q_idx)
    return (torch.where(has_q[:, None], vals, float("-inf")),
            torch.where(has_q[:, None], idx, -1).to(torch.int32))


def bank_query(
    vectors: torch.Tensor,
    k: int,
    users: torch.Tensor | None = None,
    user_idx: torch.Tensor | None = None,
    exclude_table: torch.Tensor | None = None,
    excl_map: torch.Tensor | None = None,
    q_idx: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K7: one source of the retrieval bank, ``(scores (B, k) f32, rows
    (B, k) int32)`` against the source table ``vectors`` (I, d) (CUDA kernel
    ``bank_query``). Two kinds:

    - ``user_rows``: ``users`` (N, d) and ``user_idx`` (B,) int32; query b is
      row ``user_idx[b]`` of ``users``. With ``exclude_table`` (M, E) it
      excludes that table's row ``user_idx[b]``, each entry first mapped
      through ``excl_map`` (M_items,) where given (a negative entry, or a
      negative map value, drops it).
    - ``item_mean``: ``q_idx`` (B, Q) int32, -1-padded rows of ``vectors``;
      query b is their L2-normalized masked mean (:func:`mean_query_reference`)
      and they are its exclusion list. A row with no valid entry gets
      ``(-inf, -1)`` in every slot.
    """
    mean_rows = q_idx is not None
    if mean_rows == (users is not None):
        raise ValueError("bank_query: pass users and user_idx (user_rows) or q_idx (item_mean)")
    operands = [t for t in (vectors, users, user_idx, exclude_table, excl_map, q_idx) if t is not None]
    if on_cpu("bank_query", *operands):
        return bank_query_reference(vectors, k, users, user_idx, exclude_table, excl_map, q_idx)
    _check_k("bank_query", k)
    n_items, d = vectors.shape
    dev = vectors.device
    _check_rank("bank_query", d)
    check_operand("bank_query", "vectors", vectors, torch.float32, (n_items, d), dev)
    if mean_rows:
        b = q_idx.shape[0]
        excl_ptr, n_excl, excl_pad = _exclusion("bank_query", "q_idx", q_idx, b, dev)
        if n_excl == 0:
            raise ValueError("bank_query: q_idx needs at least one column")
        dpad = pow2_at_least(d)
        users_ptr = idx_ptr = map_ptr = None
    else:
        b = user_idx.shape[0]
        check_operand("bank_query", "users", users, torch.float32, (users.shape[0], d), dev)
        check_operand("bank_query", "user_idx", user_idx, torch.int32, (b,), dev)
        excl_ptr, n_excl, excl_pad = _exclusion(
            "bank_query", "exclude_table", exclude_table,
            0 if exclude_table is None else exclude_table.shape[0], dev)
        map_ptr = None
        if excl_map is not None:
            check_operand("bank_query", "excl_map", excl_map, torch.int32, (excl_map.shape[0],), dev)
            map_ptr = excl_map.data_ptr()
        dpad, users_ptr, idx_ptr = 0, users.data_ptr(), user_idx.data_ptr()
    vals, idx = _outputs(b, k, dev)
    if _select_path(k, d, n_excl, excl_pad, dpad):
        _select("bank_query", dev, vals, idx, users=users, items=vectors, user_idx=user_idx,
                excl=q_idx if mean_rows else exclude_table, excl_by_user=not mean_rows,
                excl_map=excl_map, mean_rows=mean_rows, dpad=dpad, n_rows=b, k=k, n_excl=n_excl)
        return vals, idx
    call(
        "bank_query", dev, users_ptr, vectors.data_ptr(), idx_ptr, excl_ptr, map_ptr, int(mean_rows),
        vals.data_ptr(), idx.data_ptr(), b, n_items, d, k, n_excl, excl_pad, dpad,
    )
    return vals, idx
