"""Implicit-feedback ALS normal-equation solves (PyTorch + CUDA).

The math (Hu-Koren-Volinsky implicit ALS, with Spark MLlib's conventions):

- confidence ``c_ui = 1 + alpha * r_ui``; preference ``p_ui = 1`` where ``r > 0``
- user solve:  ``x_u = (YtY + Y_u^T diag(alpha r_u) Y_u + lambda n_u I)^-1
  Y_u^T (1 + alpha r_u)``, with ``n_u`` the user's nonzero count (ALS-WR).

Port of ``albedo_tpu/ops/als.py``. Each half-sweep walks the tier-packed
bucket groups (``datasets.ragged``) and solves every row of a group in one
kernel launch:

- K1 :func:`bucket_partial_terms` gathers the fixed side's rows and forms the
  Gramian correction and the b-vector (kernel ``als_partials``);
- K2 :func:`solve_corrected` is the batched Cholesky solve;
- K3 :func:`bucket_cg_body` is the warm-started Jacobi-PCG alternative;
- K4 :func:`land_rows` lands the solved rows in the new table (kernel
  ``land_rows``), and :func:`scatter_solved` is the same landing by row ids
  (kernel ``scatter_rows``).

K1 and K3 also take ``gather_dtype="bfloat16"``, as the JAX functions do:
the fixed side's table is read through a bf16 copy (``half_sweep`` casts it
once per half-sweep, round to nearest even as XLA's convert), which halves
the gathered bytes, and every contraction over the gathered rows sums in
float32. The bf16 entries of the kernels (``als_partials_bf16``,
``bucket_cg_bf16``) round where the JAX program rounds, and nowhere else:

- K1: ``corr = sum_l y b(c1) y^T`` and ``b = sum_l w y`` with ``w = 1 + c1``
  unrounded (``b(.)`` a round to bf16, ``y`` a bf16 row widened exactly). Each
  product ``y_k b(c1) y_m`` holds at most 24 significant bits, so it is exact
  in float32: only the order of the sums differs from JAX.
- K3: the Jacobi diagonal sums ``b(y * y) b(c1)``; each matvec contracts the
  rows with ``b(p)``, forms ``t = c1 q`` in float32 and contracts the rows
  with ``b(t)``; ``YtY p``, ``reg n p``, the residuals and the updates stay
  float32 on the unrounded iterate. (Compiled for the CPU, XLA may keep the
  diagonal's ``y * y`` in float32, as excess precision allows; op by op the
  JAX function rounds it, and so does the port.)

Each has a plain PyTorch version beside it (``*_reference``). A wrapper runs
the plain version only for tensors on the CPU; for CUDA tensors it launches
its kernel or raises. Every rank runs on the card: ranks up to ``KMAX`` take
each kernel's narrow path (a row's system in registers or static shared
memory), wider ranks its wide path (K1 tiles the correction over CTAs; K2
and K3 keep their system in dynamic shared memory while it fits, else in a
global-memory workspace the wrapper allocates). :func:`half_sweep` lands the
solved rows through the precomputed landing permutation, as the JAX sweep
does: K2/K3 write each group's block into one solved pool and K4 reads the
pool and the old table where they lie (no concatenated copy). K4 is a kernel of its own rather than an epilogue of K2
and K3, which keep their measured times; :func:`gramian` stays a matmul, as
the JAX package leaves it to XLA.
"""

from __future__ import annotations

import torch

from albedo_tpu_torch.datasets.ragged import Bucket
from albedo_tpu_torch.kernels.build import call, check_operand, on_cpu

KMAX = 64  # the widest rank of the K1-K3 narrow paths; wider ranks take the wide paths
# Dynamic shared memory a block may opt into (227 KB), less a margin for the
# wide kernels' static variables.
SMEM_MAX = 232448 - 1024
TILE = 32  # entries per shared-memory tile of K3 (bucket_cg.cu)
WORKSPACE_MAX = 256 << 20  # bytes of global workspace per launch (rows are chunked to fit)


GATHER_DTYPES = {None: torch.float32, "bfloat16": torch.bfloat16}


def gramian(factors: torch.Tensor) -> torch.Tensor:
    """``F^T F`` in float32 — the shared ``YtY`` term of every implicit solve."""
    return factors.T @ factors


def gather_table(source: torch.Tensor, gather_dtype: str | None) -> torch.Tensor:
    """The table the gathers read: ``source`` itself (float32), or its bf16
    copy (round to nearest even; ``source`` is returned as it is when it is
    bf16 already, so a half-sweep casts once)."""
    if gather_dtype not in GATHER_DTYPES:
        raise ValueError(f"unknown gather_dtype {gather_dtype!r} (expected None or 'bfloat16')")
    return source.to(GATHER_DTYPES[gather_dtype])


def _round(x: torch.Tensor, gather_dtype: str | None) -> torch.Tensor:
    """``x`` rounded to the gather dtype and widened back to float32 (the
    identity under float32 gathers)."""
    return x if gather_dtype is None else x.to(torch.bfloat16).float()


def scatter_solved_reference(target: torch.Tensor, row_ids: torch.Tensor, solved: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`scatter_solved`: a copy of ``target`` with
    ``out[row_ids[i]] = solved[i]``, the slots whose id lies outside
    ``[0, n_target)`` (the -1 padding) dropped, as the JAX scatter's
    ``mode="drop"``."""
    out = target.clone()
    ids = row_ids.reshape(-1).long()
    keep = (ids >= 0) & (ids < target.shape[0])
    out[ids[keep]] = solved.reshape(-1, target.shape[1])[keep]
    return out


def scatter_solved(target: torch.Tensor, row_ids: torch.Tensor, solved: torch.Tensor) -> torch.Tensor:
    """K4's ``scatter_solved``: land a solved block into a new table, padding
    slots (``row_ids == -1``) dropped (CUDA kernel ``scatter_rows``, after a
    copy of ``target``). ``target`` (n_target, k) f32; ``row_ids`` (n_slots,)
    or (..., B) int32, unique where in range; ``solved`` (n_slots, k) f32
    (or shaped as ``row_ids`` plus k). ``target`` is not modified."""
    if on_cpu("scatter_rows", target, row_ids, solved):
        return scatter_solved_reference(target, row_ids, solved)
    n_target, k = target.shape
    dev = target.device
    ids = row_ids.reshape(-1)
    rows = solved.reshape(-1, k)
    n_slots = ids.shape[0]
    check_operand("scatter_rows", "target", target, torch.float32, (n_target, k), dev)
    check_operand("scatter_rows", "row_ids", ids, torch.int32, (n_slots,), dev)
    check_operand("scatter_rows", "solved", rows, torch.float32, (n_slots, k), dev)
    out = torch.empty_like(target)
    call("scatter_rows", dev, target.data_ptr(), ids.data_ptr(), rows.data_ptr(), out.data_ptr(),
         n_slots, n_target, k)
    return out


def land_rows_reference(target: torch.Tensor, pool: torch.Tensor, landing: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`land_rows`: ``cat(pool, target)[landing]``."""
    return torch.cat([pool, target])[landing]


def land_rows(target: torch.Tensor, pool: torch.Tensor, landing: torch.Tensor) -> torch.Tensor:
    """K4: the new (n_target, k) table ``cat(pool, target)[landing]`` (CUDA
    kernel ``land_rows``), written from ``pool`` and ``target`` where they
    lie. ``pool`` (n_slots, k) f32 holds the solved blocks of every group in
    order; ``landing`` (n_target,) int64 is row r's slot in it, or
    ``n_slots + r`` to keep its old row."""
    if on_cpu("land_rows", target, pool, landing):
        return land_rows_reference(target, pool, landing)
    n_target, k = target.shape
    n_slots = pool.shape[0]
    dev = target.device
    check_operand("land_rows", "target", target, torch.float32, (n_target, k), dev)
    check_operand("land_rows", "pool", pool, torch.float32, (n_slots, k), dev)
    check_operand("land_rows", "landing", landing, torch.int64, (n_target,), dev)
    out = torch.empty_like(target)
    call("land_rows", dev, pool.data_ptr(), n_slots, target.data_ptr(), landing.data_ptr(), out.data_ptr(),
         n_target, k)
    return out


def _solved_into(out: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor:
    """A plain version's result, written into ``out`` when one is given."""
    return x if out is None else out.copy_(x)


def _output(kernel: str, out: torch.Tensor | None, b: int, k: int, dev) -> torch.Tensor:
    """A kernel's (b, k) result: ``out`` once checked, else a new tensor."""
    if out is None:
        return torch.empty((b, k), dtype=torch.float32, device=dev)
    check_operand(kernel, "out", out, torch.float32, (b, k), dev)
    return out


def _check_rank(kernel: str, k: int) -> None:
    if k < 1:
        raise ValueError(f"{kernel}: the CUDA kernel takes ranks >= 1, got {k}")


def _path(kernel: str, k: int) -> str:
    """The launch-count key of the path rank ``k`` takes."""
    return kernel if k <= KMAX else f"{kernel}_wide"


def _workspace_chunks(per_row: int, b: int, dev):
    """``[(row0, rows, workspace or None)]``: one launch over all ``b`` rows
    when a row's ``per_row`` floats fit in shared memory (no workspace),
    else row chunks with a global workspace of at most WORKSPACE_MAX bytes."""
    if 4 * per_row <= SMEM_MAX:
        return [(0, b, None)]
    rows = max(1, min(b, WORKSPACE_MAX // (4 * per_row)))
    ws = torch.empty(rows * per_row, dtype=torch.float32, device=dev)
    return [(r0, min(rows, b - r0), ws) for r0 in range(0, b, rows)]


# --------------------------------------------------------------------- K1


def bucket_partial_terms_reference(
    source: torch.Tensor,  # (n_source, k) f32 fixed side's factors
    idx: torch.Tensor,     # (B, L) int32 indices into `source`
    val: torch.Tensor,     # (B, L) f32 ratings, 0 on padding
    mask: torch.Tensor,    # (B, L) bool
    alpha: float,
    gather_dtype: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: ``corr = sum_l c1 y y^T`` (B, k, k) and
    ``b = sum_l w y`` (B, k), through the materialized (B, L, k) gather;
    under bf16 gathers ``y`` and the ``c1`` of ``corr`` are rounded to bf16
    and widened back, so every contraction runs in float32."""
    gathered = gather_table(source, gather_dtype)[idx.long()].float()
    c1 = alpha * val
    w = torch.where(mask, 1.0 + c1, torch.zeros_like(c1))
    corr = torch.einsum("blk,bl,blm->bkm", gathered, _round(c1, gather_dtype), gathered)
    b_vec = torch.einsum("blk,bl->bk", gathered, w)
    return corr, b_vec


def _entry(kernel: str, gather_dtype: str | None) -> str:
    """The entry point of ``kernel`` for the gather dtype."""
    return kernel if gather_dtype is None else f"{kernel}_bf16"


def bucket_partial_terms(
    source: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
    mask: torch.Tensor, alpha: float, gather_dtype: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: the Gramian correction and b-vector of a padded bucket, with the
    row gather fused in (CUDA kernel ``als_partials``, or ``als_partials_bf16``
    reading the bf16 table; the (B, L, k) block is never materialized)."""
    if on_cpu("als_partials", source, idx, val, mask):
        return bucket_partial_terms_reference(source, idx, val, mask, alpha, gather_dtype)
    table = gather_table(source, gather_dtype)
    kernel = _entry("als_partials", gather_dtype)
    n, k = source.shape
    b, length = idx.shape
    _check_rank(kernel, k)
    dev = source.device
    check_operand(kernel, "source", table, GATHER_DTYPES[gather_dtype], (n, k), dev)
    check_operand(kernel, "idx", idx, torch.int32, (b, length), dev)
    check_operand(kernel, "val", val, torch.float32, (b, length), dev)
    check_operand(kernel, "mask", mask, torch.bool, (b, length), dev)
    corr = torch.empty((b, k, k), dtype=torch.float32, device=dev)
    b_vec = torch.empty((b, k), dtype=torch.float32, device=dev)
    call(
        kernel, dev, table.data_ptr(), idx.data_ptr(), val.data_ptr(),
        mask.data_ptr(), corr.data_ptr(), b_vec.data_ptr(), b, length, k,
        float(alpha), count=_path(kernel, k),
    )
    return corr, b_vec


# --------------------------------------------------------------------- K2


def solve_corrected_reference(
    yty: torch.Tensor,    # (k, k)
    corr: torch.Tensor,   # (B, k, k)
    b_vec: torch.Tensor,  # (B, k)
    n_b: torch.Tensor,    # (B,) f32 per-row nonzero counts
    reg: float,
) -> torch.Tensor:
    """Plain version of K2: batched Cholesky solve of
    ``(YtY + corr + reg n_b I) x = b``. ``cholesky_ex`` does not raise on a
    padding slot whose ``YtY`` is singular; that row's result is dropped."""
    k = yty.shape[0]
    eye = torch.eye(k, dtype=torch.float32, device=yty.device)
    a_mat = yty[None] + corr + (reg * n_b)[:, None, None] * eye
    chol = torch.linalg.cholesky_ex(a_mat).L
    return torch.cholesky_solve(b_vec[..., None], chol)[..., 0]


def solve_corrected(
    yty: torch.Tensor, corr: torch.Tensor, b_vec: torch.Tensor,
    n_b: torch.Tensor, reg: float, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """K2: one k x k Cholesky solve per bucket row (CUDA kernel
    ``solve_corrected``), into ``out`` (B, k) when given (a half-sweep's
    slice of its solved pool)."""
    if on_cpu("solve_corrected", yty, corr, b_vec, n_b, *([] if out is None else [out])):
        return _solved_into(out, solve_corrected_reference(yty, corr, b_vec, n_b, reg))
    k = yty.shape[0]
    b = b_vec.shape[0]
    _check_rank("solve_corrected", k)
    dev = yty.device
    check_operand("solve_corrected", "yty", yty, torch.float32, (k, k), dev)
    check_operand("solve_corrected", "corr", corr, torch.float32, (b, k, k), dev)
    check_operand("solve_corrected", "b_vec", b_vec, torch.float32, (b, k), dev)
    check_operand("solve_corrected", "n_b", n_b, torch.float32, (b,), dev)
    x = _output("solve_corrected", out, b, k, dev)
    chunks = [(0, b, None)] if k <= KMAX else _workspace_chunks(k * (k + 1) + k, b, dev)
    for r0, rows, ws in chunks:
        call(
            "solve_corrected", dev, yty.data_ptr(), corr.data_ptr() + 4 * r0 * k * k,
            b_vec.data_ptr() + 4 * r0 * k, n_b.data_ptr() + 4 * r0, float(reg),
            x.data_ptr() + 4 * r0 * k, rows, k, None if ws is None else ws.data_ptr(),
            count=_path("solve_corrected", k),
        )
    return x


def bucket_solve_body(
    source: torch.Tensor, yty: torch.Tensor, idx: torch.Tensor,
    val: torch.Tensor, mask: torch.Tensor, reg: float, alpha: float,
    out: torch.Tensor | None = None, gather_dtype: str | None = None,
) -> torch.Tensor:
    """The exact normal-equation solve of a padded bucket: K1 then K2
    (into ``out`` when given). ``yty`` is the float32 Gramian of the float32
    table, under bf16 gathers too, as in JAX."""
    corr, b_vec = bucket_partial_terms(source, idx, val, mask, alpha, gather_dtype)
    n_b = mask.sum(dim=1, dtype=torch.float32)
    return solve_corrected(yty, corr, b_vec, n_b, reg, out=out)


# --------------------------------------------------------------------- K3


def bucket_cg_reference(
    source: torch.Tensor,  # (n_source, k)
    yty: torch.Tensor,     # (k, k)
    idx: torch.Tensor,     # (B, L) int32
    val: torch.Tensor,     # (B, L) f32, 0 on padding
    mask: torch.Tensor,    # (B, L) bool
    x0: torch.Tensor,      # (B, k) warm start
    reg: float,
    alpha: float,
    cg_steps: int,
    gather_dtype: str | None = None,
) -> torch.Tensor:
    """Plain version of K3, line for line the JAX ``bucket_cg_body``, with
    its bf16 rounding sites (``_round``) under bf16 gathers."""
    def rnd(x):
        return _round(x, gather_dtype)

    gathered = gather_table(source, gather_dtype)[idx.long()].float()
    c1 = alpha * val
    w = torch.where(mask, 1.0 + c1, torch.zeros_like(c1))
    n_b = mask.sum(dim=1, dtype=torch.float32)
    b_vec = torch.einsum("blk,bl->bk", gathered, w)
    diag = (
        torch.diagonal(yty)[None]
        + torch.einsum("blk,bl->bk", rnd(gathered * gathered), rnd(c1))
        + (reg * n_b)[:, None]
    )
    diag = torch.clamp(diag, min=1e-12)

    def matvec(p):
        t = c1 * torch.einsum("blk,bk->bl", gathered, rnd(p))
        return p @ yty + torch.einsum("blk,bl->bk", gathered, rnd(t)) + (reg * n_b)[:, None] * p

    tiny = 1e-30
    x = x0
    r = b_vec - matvec(x)
    z = r / diag
    p = z
    rz = torch.sum(r * z, dim=1)
    for _ in range(cg_steps):
        ap = matvec(p)
        step = rz / (torch.sum(p * ap, dim=1) + tiny)
        x = x + step[:, None] * p
        r = r - step[:, None] * ap
        z = r / diag
        rz_new = torch.sum(r * z, dim=1)
        beta = rz_new / (rz + tiny)
        p = z + beta[:, None] * p
        rz = rz_new
    return x


def bucket_cg_body(
    source: torch.Tensor, yty: torch.Tensor, idx: torch.Tensor,
    val: torch.Tensor, mask: torch.Tensor, x0: torch.Tensor,
    reg: float, alpha: float, cg_steps: int, out: torch.Tensor | None = None,
    gather_dtype: str | None = None,
) -> torch.Tensor:
    """K3: matrix-free warm-started Jacobi-PCG on the implicit normal
    equations, ``cg_steps`` steps (CUDA kernel ``bucket_cg``, or
    ``bucket_cg_bf16`` reading the bf16 table), into ``out`` (B, k) when
    given."""
    if on_cpu("bucket_cg", source, yty, idx, val, mask, x0, *([] if out is None else [out])):
        return _solved_into(out, bucket_cg_reference(source, yty, idx, val, mask, x0, reg, alpha, cg_steps,
                                                     gather_dtype))
    table = gather_table(source, gather_dtype)
    kernel = _entry("bucket_cg", gather_dtype)
    n, k = source.shape
    b, length = idx.shape
    _check_rank(kernel, k)
    dev = source.device
    check_operand(kernel, "source", table, GATHER_DTYPES[gather_dtype], (n, k), dev)
    check_operand(kernel, "yty", yty, torch.float32, (k, k), dev)
    check_operand(kernel, "idx", idx, torch.int32, (b, length), dev)
    check_operand(kernel, "val", val, torch.float32, (b, length), dev)
    check_operand(kernel, "mask", mask, torch.bool, (b, length), dev)
    check_operand(kernel, "x0", x0, torch.float32, (b, k), dev)
    x = _output(kernel, out, b, k, dev)
    chunks = [(0, b, None)] if k <= KMAX else _workspace_chunks((TILE + 7) * k + 3 * TILE, b, dev)
    for r0, rows, ws in chunks:
        call(
            kernel, dev, table.data_ptr(), yty.data_ptr(),
            idx.data_ptr() + 4 * r0 * length, val.data_ptr() + 4 * r0 * length,
            mask.data_ptr() + r0 * length, x0.data_ptr() + 4 * r0 * k,
            x.data_ptr() + 4 * r0 * k, rows, length, k, float(reg), float(alpha),
            int(cg_steps), None if ws is None else ws.data_ptr(),
            count=_path(kernel, k),
        )
    return x


# ------------------------------------------------------------ half-sweeps


def half_sweep(
    source: torch.Tensor,      # (n_source, k) fixed side's factors
    target: torch.Tensor,      # (n_target, k) factors being updated
    groups: list[Bucket],      # stacked (N, B, L) groups, torch tensors
    landing: torch.Tensor,     # (n_target,) int64 landing permutation
    reg: float,
    alpha: float,
    solver: str = "cholesky",
    cg_steps: int = 3,
    gather_dtype: str | None = None,
) -> torch.Tensor:
    """Update every row of ``target`` that appears in a bucket; returns a new
    table (``target`` is not modified). Under ``gather_dtype="bfloat16"``
    the fixed side's table is cast to bf16 once here; ``YtY`` stays the
    float32 Gramian of the float32 table.

    Every target row appears in at most one bucket, so all groups are solved
    against the PRE-SWEEP ``target`` (CG warm starts read it), each group's
    N*B rows in one launch written into its slice of one solved pool (group
    order, the JAX sweep's ``concatenate(all_solved)`` built in place), and
    the pool lands once through K4: ``cat(pool, target)[landing]``, where
    ``landing[r]`` is row r's slot, or ``n_slots + r`` to keep its old
    factor.
    """
    if solver not in ("cholesky", "cg"):
        raise ValueError(f"unknown solver {solver!r} (expected 'cholesky' or 'cg')")
    yty = gramian(source)
    table = gather_table(source, gather_dtype)
    pool = torch.empty((sum(g.row_ids.numel() for g in groups), target.shape[1]),
                       dtype=torch.float32, device=target.device)
    off = 0
    for g in groups:
        n, b, length = g.idx.shape
        idx = g.idx.reshape(n * b, length)
        val = g.val.reshape(n * b, length)
        mask = g.mask.reshape(n * b, length)
        out = pool[off:off + n * b]
        if solver == "cg":
            rows = g.row_ids.reshape(-1).clamp(min=0).long()
            x0 = target[rows]
            bucket_cg_body(table, yty, idx, val, mask, x0, reg, alpha, cg_steps, out=out,
                           gather_dtype=gather_dtype)
        else:
            bucket_solve_body(table, yty, idx, val, mask, reg, alpha, out=out, gather_dtype=gather_dtype)
        off += n * b
    return land_rows(target, pool, landing)


def fit_loop(
    user_f: torch.Tensor,
    item_f: torch.Tensor,
    user_groups: list[Bucket],
    item_groups: list[Bucket],
    user_landing: torch.Tensor,
    item_landing: torch.Tensor,
    reg: float,
    alpha: float,
    n_iter: int,
    solver: str = "cholesky",
    cg_steps: int = 3,
    callback=None,
    gather_dtype: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_iter`` alternating sweeps in MLlib order: item factors first (from
    the user factors), then user factors. ``callback(it, user_f, item_f)``,
    if given, runs after each sweep with the device tensors. The factor
    tables stay float32 under bf16 gathers."""
    for it in range(n_iter):
        item_f = half_sweep(user_f, item_f, item_groups, item_landing, reg, alpha, solver, cg_steps,
                            gather_dtype)
        user_f = half_sweep(item_f, user_f, user_groups, user_landing, reg, alpha, solver, cg_steps,
                            gather_dtype)
        if callback is not None:
            callback(it, user_f, item_f)
    return user_f, item_f


def implicit_loss(
    user_factors: torch.Tensor,
    item_factors: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    reg: float,
    alpha: float,
) -> torch.Tensor:
    """The exact implicit-ALS objective (tests/monitoring; O(U*I) — small
    data only).

    ``sum_ui c_ui (p_ui - x_u . y_i)^2 + reg * (sum_u n_u |x_u|^2 + sum_i n_i |y_i|^2)``
    """
    rows = rows.long()
    cols = cols.long()
    scores = user_factors @ item_factors.T
    conf = torch.ones_like(scores)
    pref = torch.zeros_like(scores)
    conf.index_put_((rows, cols), alpha * vals, accumulate=True)
    pref[rows, cols] = torch.where(vals > 0, 1.0, 0.0).to(pref.dtype)
    data_term = (conf * (pref - scores) ** 2).sum()
    n_u = torch.zeros(user_factors.shape[0], dtype=scores.dtype, device=scores.device)
    n_u.index_add_(0, rows, torch.ones_like(vals, dtype=scores.dtype))
    n_i = torch.zeros(item_factors.shape[0], dtype=scores.dtype, device=scores.device)
    n_i.index_add_(0, cols, torch.ones_like(vals, dtype=scores.dtype))
    reg_term = (n_u * (user_factors**2).sum(dim=1)).sum() + (
        n_i * (item_factors**2).sum(dim=1)
    ).sum()
    return data_term + reg * reg_term
