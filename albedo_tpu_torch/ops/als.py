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
each kernel's narrow path (K1 and K3 split long rows across CTAs by a plan
computed here, :func:`_k1_plan` and :func:`_k3_plan`; K2 solves a system a
warp), wider ranks its wide path (K1 and K3 the split design widened to
rank 512, their old tiled kernels above; K2 a blocked Cholesky a CTA; K2
and K3's tiled kernel keep their system in dynamic shared memory while it
fits, else in a global-memory workspace the wrapper allocates). :func:`half_sweep` lands the
solved rows through the precomputed landing permutation, as the JAX sweep
does: K2/K3 write each group's block into one solved pool and K4 reads the
pool and the old table where they lie (no concatenated copy). K4 is a kernel of its own rather than an epilogue of K2
and K3, which keep their measured times; :func:`gramian` stays a matmul, as
the JAX package leaves it to XLA. :func:`fit_loop`, JAX's fused fit, runs
the sweeps on the card as one CUDA graph of an iteration, replayed;
:func:`fit_loop_reference` is the same loop enqueued from Python.
"""

from __future__ import annotations

import functools
import threading

import torch

from albedo_tpu_torch.datasets.ragged import Bucket
from albedo_tpu_torch.kernels.build import call, check_operand, on_cpu
from albedo_tpu_torch.utils.graphs import replay_loop

KMAX = 64  # the widest rank of the K1-K3 narrow paths; wider ranks take the wide paths
# Dynamic shared memory a block may opt into (227 KB), less a margin for the
# wide kernels' static variables.
SMEM_MAX = 232448 - 1024
TILE = 32  # entries per shared-memory tile of K3's tiled path (bucket_cg.cu, ranks above K3_SPLIT_KMAX)
WORKSPACE_MAX = 256 << 20  # bytes of global workspace per launch (rows are chunked to fit)
_U32 = 2.0**-24  # float32's unit round-off (F9's round-off model, bucket_cg_bf16_limits)
# K1's split plan (csrc/als_partials.cu, ranks up to K1_SPLIT_KMAX; :func:`_k1_plan`).
K1_TILE = 32          # entries a staged tile; a chunk is whole tiles
K1_MIN_CHUNK = 64     # the shortest chunk a row is cut into
K1_UNITS_PER_SM = 8   # units a split group aims for, per SM
K1_CTAS_PER_SM = 16   # CTAs an unsplit group's grid aims for, per SM: two waves of the 8 an SM holds
                      # (27 KB of shared memory each); both measured by als_partials_bench variants
K1_SPLIT_KMAX = 512   # the widest rank of K1's split design (narrow up to KMAX, then wide); tiled above
_K1_WORKSPACE: dict[tuple[int, int], torch.Tensor] = {}
_K1_WORKSPACE_LOCK = threading.Lock()
_K1_OWNED = threading.local()  # .store: the workspaces of a graph fit running in this thread, else None
# K3's plan (csrc/bucket_cg.cu, ranks up to K3_SPLIT_KMAX; :func:`_k3_plan`).
# The first two mirror the source's PW and CW; :func:`k3_cols`,
# :func:`k3_window` and :func:`k3_cpart` its column classes, windows and
# exchanged partials.
K3_PACK_WARPS = 4     # rows (warps) of a warp-mode CTA
K3_CTA_WARPS = 8      # warps of a cluster-mode CTA
K3_PACK_L = 64        # up to rank KMAX, rows of at most this many slots take warp mode (the source takes up to 128)
K3_WIDE_PACK_SMEM = 113 * 1024  # above KMAX, warp mode takes rows whose float32 warp-mode CTA fits this
K3_CLUSTERS = (1, 2, 4, 8, 16)  # cluster sizes a plan picks; 16 only where the card holds such a cluster
K3_SPREAD = 16        # up to KMAX, a group of few rows is spread over clusters of at most this many CTAs
K3_WIDE_SPREAD = 4    # above KMAX, the same (both wider only for a slice to fit); measured by
                      # als_partials_bench variants k3 and k3w, as K3_PACK_L and K3_WIDE_PACK_SMEM
K3_SMEM = 232448      # dynamic shared memory a block may opt into (227 KB)
K3_SPLIT_KMAX = 512   # the widest rank of K3's split design; the tiled kernel above
K3_YTY_COLS = 4       # YtY staged in shared memory up to 32 x this rank (128), read from L2 above
K3_REG_COLS = 8       # a row's CG vectors in registers up to 32 x this rank (256), in shared memory above
_K3_CLUSTER16: dict[tuple, bool] = {}


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
    """The launch-count key of the path rank ``k`` takes: the narrow path up
    to KMAX, the wide one above, and K1's and K3's tiled kernels above
    their split designs (K1_SPLIT_KMAX, K3_SPLIT_KMAX)."""
    if k <= KMAX:
        return kernel
    tiled_above = {"als_partials": K1_SPLIT_KMAX, "bucket_cg": K3_SPLIT_KMAX}.get(kernel.removesuffix("_bf16"))
    return f"{kernel}_tiled" if tiled_above is not None and k > tiled_above else f"{kernel}_wide"


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


def k1_blocks(k: int) -> int:
    """The 4 x 4 blocks (I, J), I <= J, of the upper triangle of K1's
    (k, k + 1) matrix ``[corr | b]`` (the split design's threads, and the
    floats / 16 of one unit's partial)."""
    kbi, kbj = -(-k // 4), (k + 4) // 4
    return kbi * kbj - kbi * (kbi - 1) // 2


def _k1_plan(b: int, length: int, n_sm: int, unit_floats: int = 0) -> tuple[int, int, int]:
    """(chunk, n_chunks, per_cta) of a K1 launch at rank <= K1_SPLIT_KMAX
    (``csrc/als_partials.cu``): each of the ``b`` rows' ``length`` slots cut
    into ``n_chunks`` chunks of ``chunk`` slots (whole 32-entry tiles), a
    unit being one (row, chunk), and ``per_cta`` units a CTA. A group with
    fewer rows than half of K1_UNITS_PER_SM x ``n_sm`` has its rows split,
    chunks no shorter than K1_MIN_CHUNK, toward that many units, one a CTA,
    as far as the split units' partials (``unit_floats`` floats each) fit in
    WORKSPACE_MAX bytes; other groups keep one chunk a row and give each CTA
    enough rows that the grid has about K1_CTAS_PER_SM CTAs an SM."""
    want = n_sm * K1_UNITS_PER_SM
    n_chunks = 1
    if 2 * b < want and length > K1_MIN_CHUNK:
        n_chunks = min(-(-want // max(b, 1)), -(-length // K1_MIN_CHUNK))
        if unit_floats:
            n_chunks = min(n_chunks, WORKSPACE_MAX // (4 * unit_floats * max(b, 1)))
        n_chunks = max(1, n_chunks)
    chunk = max(K1_TILE, -(-(-(-length // n_chunks)) // K1_TILE) * K1_TILE)
    n_chunks = max(1, -(-length // chunk))
    per_cta = 1 if n_chunks > 1 else max(1, -(-b // (n_sm * K1_CTAS_PER_SM)))
    return chunk, n_chunks, per_cta


def k1_units(b: int, length: int, plan: tuple[int, int, int]) -> list[tuple[int, int, int, int, int]]:
    """Every unit of a K1 plan as the kernel walks it: (CTA, row, chunk
    index, first slot, one past the last slot). A split row's partials are
    added in chunk index order."""
    chunk, n_chunks, per_cta = plan
    return [(u // per_cta, u // n_chunks, u % n_chunks, (u % n_chunks) * chunk,
             min(length, (u % n_chunks) * chunk + chunk)) for u in range(b * n_chunks)]


def _k1_workspace(n: int, dev: torch.device) -> torch.Tensor:
    """At least ``n`` floats of the (device, current stream)'s K1 workspace
    (split rows' partials), grown as calls need: launches on one stream run
    in order, so they share it, and a fit's 74 calls an iteration allocate
    nothing. Inside a graph fit (:func:`fit_loop`) the workspace is the
    fit's own instead: a graph keeps the pointers it captured, so no other
    call may replace or free what it writes through."""
    store = getattr(_K1_OWNED, "store", None)
    if store is not None:
        if not store or store[-1].numel() < n:
            store.append(torch.empty(n, dtype=torch.float32, device=dev))  # earlier ones stay alive
        return store[-1]
    key = (dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    ws = _K1_WORKSPACE.get(key)
    if ws is None or ws.numel() < n:
        with _K1_WORKSPACE_LOCK:
            ws = _K1_WORKSPACE.get(key)
            if ws is None or ws.numel() < n:
                grown = min(2 * (0 if ws is None else ws.numel()), WORKSPACE_MAX // 4)
                ws = torch.empty(max(n, grown), dtype=torch.float32, device=dev)
                _K1_WORKSPACE[key] = ws
    return ws


def bucket_partial_terms(
    source: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
    mask: torch.Tensor, alpha: float, gather_dtype: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: the Gramian correction and b-vector of a padded bucket, with the
    row gather fused in (CUDA kernel ``als_partials``, or ``als_partials_bf16``
    reading the bf16 table; the (B, L, k) block is never materialized). Up
    to rank K1_SPLIT_KMAX one call is one launch of the split design
    (:func:`_k1_plan`; a split row's partials are closed by a second kernel
    of the launch), its wide kernel above KMAX; wider ranks take the tiled
    kernel."""
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
    chunk, n_chunks, per_cta = K1_TILE, 1, 1
    ws = None
    if k <= K1_SPLIT_KMAX:
        unit = 16 * k1_blocks(k)
        chunk, n_chunks, per_cta = _k1_plan(b, length, torch.cuda.get_device_properties(dev).multi_processor_count, unit)
        if n_chunks > 1:
            ws = _k1_workspace(b * n_chunks * unit, dev).data_ptr()
    call(
        kernel, dev, table.data_ptr(), idx.data_ptr(), val.data_ptr(),
        mask.data_ptr(), corr.data_ptr(), b_vec.data_ptr(), b, length, k,
        float(alpha), chunk, n_chunks, per_cta, ws, count=_path(kernel, k),
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


def k2_wide_floats(k: int) -> int:
    """Floats of one system of K2's wide path (``csrc/solve_corrected.cu
    WideLayout``): the bordered matrix's rows (k + 1 rows of an odd stride
    of at least k + 1), the transposed panel (32 rows of k + 1 rounded up to
    4) and the pivots' reciprocals, each part rounded up to 4 floats."""
    lda = (k + 1) | 1
    return -(-(k + 1) * lda // 4) * 4 + 32 * ((k + 4) & ~3) + -(-k // 4) * 4


def solve_corrected(
    yty: torch.Tensor, corr: torch.Tensor, b_vec: torch.Tensor,
    n_b: torch.Tensor, reg: float, out: torch.Tensor | None = None,
) -> torch.Tensor:
    """K2: one k x k Cholesky solve per bucket row (CUDA kernel
    ``solve_corrected``), into ``out`` (B, k) when given (a half-sweep's
    slice of its solved pool). Above rank KMAX a blocked Cholesky a CTA
    (``solve_corrected_wide``), in shared memory while a system of
    :func:`k2_wide_floats` fits, else in a global workspace a slice a CTA
    (at most WORKSPACE_MAX bytes of slices; the persistent grid runs no more
    CTAs than there are slices). One launch a call."""
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
    per_system = k2_wide_floats(k)
    ws, slices = None, 0
    if k > KMAX and 4 * per_system > SMEM_MAX:
        slices = max(1, min(b, WORKSPACE_MAX // (4 * per_system)))
        ws = torch.empty(slices * per_system, dtype=torch.float32, device=dev)
    call(
        "solve_corrected", dev, yty.data_ptr(), corr.data_ptr(), b_vec.data_ptr(), n_b.data_ptr(), float(reg),
        x.data_ptr(), b, k, None if ws is None else ws.data_ptr(), slices, count=_path("solve_corrected", k),
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
    *, sites: dict | None = None, pinned: dict | None = None, deltas: dict | None = None,
    noise: torch.Generator | None = None,
) -> torch.Tensor:
    """Plain version of K3, line for line the JAX ``bucket_cg_body``, with
    its bf16 rounding sites (``_round``) under bf16 gathers.

    The keywords open those sites for F9's limits
    (:func:`bucket_cg_bf16_limits`): matvec m (0 forms the first residual
    from x0, m = 1..cg_steps the steps) rounds p (B, k) at (m, "p") and t =
    c1 q (B, L) at (m, "t"). ``sites`` receives the value each site rounds;
    ``pinned`` gives the rounded values to use in place of rounding;
    ``deltas`` adds to a site's rounded values (a rounding taken the other
    way); ``noise`` perturbs every float32 sum and update by a draw of its
    round-off. Without them the function is the plain version itself."""
    def rnd(x):
        return _round(x, gather_dtype)

    def draw(v, sd):
        return v if noise is None else v + sd * torch.randn(v.shape, generator=noise, device=v.device)

    def summed(eq, a, b, n):
        s = torch.einsum(eq, a, b)
        if noise is None:
            return s
        return draw(s, _U32 * torch.sqrt(2 * n * (s * s / 3 + torch.einsum(eq, a * a, b * b) / 6)))

    def upd(v):
        return draw(v, _U32 * v.abs())

    def site(m, kind, v):
        if sites is not None:
            sites[(m, kind)] = v
        out = rnd(v) if pinned is None else pinned[(m, kind)]
        return out + deltas[(m, kind)] if deltas is not None and (m, kind) in deltas else out

    gathered = gather_table(source, gather_dtype)[idx.long()].float()
    _, length, k = gathered.shape
    c1 = alpha * val
    w = torch.where(mask, 1.0 + c1, torch.zeros_like(c1))
    n_b = mask.sum(dim=1, dtype=torch.float32)
    b_vec = summed("blk,bl->bk", gathered, w, length)
    diag = (
        torch.diagonal(yty)[None]
        + summed("blk,bl->bk", rnd(gathered * gathered), rnd(c1), length)
        + (reg * n_b)[:, None]
    )
    diag = torch.clamp(upd(diag), min=1e-12)

    def matvec(p, m):
        t = c1 * summed("blk,bk->bl", gathered, site(m, "p", p), k)
        py = p @ yty
        if noise is not None:
            py = draw(py, _U32 * torch.sqrt(2 * k * (py * py / 3 + (p * p) @ (yty * yty) / 6)))
        return upd(py + summed("blk,bl->bk", gathered, site(m, "t", upd(t)), length) + (reg * n_b)[:, None] * p)

    tiny = 1e-30
    x = x0
    r = upd(b_vec - matvec(x, 0))
    z = upd(r / diag)
    p = z
    rz = upd(torch.sum(r * z, dim=1))
    for m in range(1, cg_steps + 1):
        ap = matvec(p, m)
        step = upd(rz / (upd(torch.sum(p * ap, dim=1)) + tiny))
        x = upd(x + step[:, None] * p)
        r = upd(r - step[:, None] * ap)
        z = upd(r / diag)
        rz_new = upd(torch.sum(r * z, dim=1))
        beta = upd(rz_new / (rz + tiny))
        p = upd(z + beta[:, None] * p)
        rz = rz_new
    return x


# K3-bf16 against its plain version (F9): each row to the effects of the bf16
# roundings its float32 round-off could flip plus that round-off itself, at
# least rel 5e-4 of max |x| of its group (below).
K3_BF16_REL = 5e-4
K3_BF16_LAMBDA = 10.0  # standard deviations of the round-off model a site's window spans
K3_BF16_DRAWS = 16     # draws of the round-off model that measure each site's standard deviation


def bucket_cg_bf16_limits(
    source: torch.Tensor, yty: torch.Tensor, idx: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
    x0: torch.Tensor, reg: float, alpha: float, cg_steps: int, rows: torch.Tensor | None = None,
) -> torch.Tensor:
    """Each row's limit on ``|K3-bf16 - plain|`` (max over the row), (B,).

    K3-bf16 differs from its plain version only in the order of its float32
    sums, but it rounds the iterate p and t = c1 q to bf16 at every matvec,
    and a value that lies near a bf16 rounding boundary can land on its
    other side: one step of 2^-8, which the later CG steps carry (F9). So
    the limit bounds what a flip can do, site by site, in three steps on
    the plain version (:func:`bucket_cg_reference` with its sites open):

    - the round-off: every float32 sum and update of the plain version is
      perturbed by a draw of its own round-off, each sum of n terms a_l with
      sum S by the standard deviation of the difference of two summation
      orders that do not follow the terms' values, u sqrt(2 n (S^2 / 3 +
      sum a_l^2 / 6)) (the mean square of a random order's partial sums),
      each update by u |v|, with every bf16 rounding kept at the plain
      version's value; ``K3_BF16_DRAWS`` draws give each rounding site's
      standard deviation before it rounds, and that of x;
    - the sites: a site whose value lies within ``K3_BF16_LAMBDA`` (10)
      standard deviations (and 2 ulp) of a bf16 rounding boundary could
      flip; its flip is the rounding at the far end of that window;
    - the effects: the plain version re-run with one flip a row (rows are
      independent, so one run takes a site of every row), the row's max
      |x - plain| being that flip's effect.

    A row is held to the sum of its sites' effects plus ten standard
    deviations of its x, at least ``K3_BF16_REL`` (5e-4) of the group's max
    |x| (over ``rows``, the rows held). No order of the sums is sampled: a
    flip that no reordering of a sample made is bounded all the same (on
    the CPU, ``kernels/als_partials_bench.py orders``: no row over these
    limits in 23 040 row trials of further random orders, two seeds), and a
    wrong site (a rounding left out, an entry dropped) still moves rows
    past them (``tests/test_torch_ops_als.py::
    test_k3_bf16_row_limits_refuse_a_wrong_site``)."""
    call = (source, yty, idx, val, mask, x0, reg, alpha, cg_steps, "bfloat16")
    values: dict = {}
    x = bucket_cg_reference(*call, sites=values)
    pinned = {key: _round(v, "bfloat16") for key, v in values.items()}
    gen = torch.Generator(device=x.device).manual_seed(idx.shape[1])
    var = {key: torch.zeros_like(v) for key, v in values.items()}
    var_x = torch.zeros_like(x)
    for _ in range(K3_BF16_DRAWS):
        drawn: dict = {}
        var_x += (bucket_cg_reference(*call, noise=gen, pinned=pinned, sites=drawn) - x) ** 2
        for key in var:
            var[key] += (drawn[key] - values[key]) ** 2
    flips = {}
    for key, v in values.items():
        if key == (0, "p"):
            continue  # the warm start x0, an input
        window = K3_BF16_LAMBDA * torch.sqrt(var[key] / K3_BF16_DRAWS) + 2 * _U32 * v.abs()
        lo, hi = (_round(v + s * window, "bfloat16") - pinned[key] for s in (-1, 1))
        flips[key] = torch.where(lo.abs() >= hi.abs(), lo, hi)
    # Each row's sites in a fixed order; run j flips the j-th site of every row that has one.
    keys = list(flips)
    near = torch.cat([flips[key] != 0 for key in keys], dim=1)
    rank = torch.where(near, torch.cumsum(near, dim=1) - 1, -1)
    effects = torch.zeros_like(x[:, 0])
    for j in range(int(rank.max()) + 1 if rank.numel() else 0):
        at, deltas, col = rank == j, {}, 0
        for key in keys:
            width = flips[key].shape[1]
            deltas[key] = torch.where(at[:, col:col + width], flips[key], 0.0)
            col += width
        effects += (bucket_cg_reference(*call, deltas=deltas) - x).abs().amax(dim=1)
    bound = effects + K3_BF16_LAMBDA * torch.sqrt(var_x / K3_BF16_DRAWS).amax(dim=1)
    held = x if rows is None else x[rows]
    return bucket_cg_bf16_limit(bound, float(held.abs().max()) if held.numel() else 0.0)


def bucket_cg_bf16_limit(bound: torch.Tensor, scale: float) -> torch.Tensor:
    """The rows' limits from their bound (flip effects plus round-off) and
    the group's max |x|: the bound, at least ``K3_BF16_REL`` of the scale."""
    return torch.clamp_min(bound, K3_BF16_REL * scale)


def bucket_cg_bf16_reordered(
    source: torch.Tensor, yty: torch.Tensor, idx: torch.Tensor, val: torch.Tensor, mask: torch.Tensor,
    x0: torch.Tensor, reg: float, alpha: float, cg_steps: int, src_pos: torch.Tensor | None = None,
    cols: torch.Tensor | None = None,
) -> torch.Tensor:
    """K3-bf16's plain version with its sums in another order: the slots
    gathered at ``src_pos`` (B, L) and the rank's columns permuted by
    ``cols`` (k,), the result's columns put back (one of
    :func:`_k3_reorders`; both None: the plain version itself)."""
    i, v = (idx, val) if src_pos is None else (idx.gather(1, src_pos), val.gather(1, src_pos))
    s, y, x = (source, yty, x0) if cols is None else (source[:, cols], yty[cols][:, cols], x0[:, cols])
    out = bucket_cg_reference(s, y, i, v, mask, x, reg, alpha, cg_steps, "bfloat16")
    return out if cols is None else out[:, torch.argsort(cols)]


def _k3_reorders(mask: torch.Tensor, k: int, gen: torch.Generator, n: int):
    """``n`` reorderings of a K3 call's sums, as (source positions of the
    slots (B, L) or None, a permutation of the k columns or None): the live
    entries reversed, the columns reversed, then both shuffled (the further
    orders ``kernels/als_partials_bench.py orders`` holds F9's limits
    against). Each keeps
    every slot's liveness: a row's live entries move among its live slots
    and the padding stays where it is, so only the order of the sums
    changes."""
    n_live = mask.sum(dim=1, keepdim=True)
    rank = torch.arange(mask.shape[1], device=mask.device).expand_as(mask)
    live_pos = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)  # live slots in order, then padding

    def gather(order):  # the slot live_pos[i] takes the entry at order[i]
        return torch.empty_like(order).scatter_(1, live_pos, order)

    yield gather(torch.where(rank < n_live, live_pos.gather(1, (n_live - 1 - rank).clamp_min(0)), live_pos)), None
    yield None, torch.arange(k - 1, -1, -1, device=mask.device)
    for _ in range(n - 2):
        keys = torch.rand(mask.shape, generator=gen).to(mask.device).masked_fill(~mask, 2.0)
        yield (gather(torch.where(rank < n_live, torch.argsort(keys, dim=1), live_pos)),
               torch.randperm(k, generator=gen).to(mask.device))


def bucket_cg_bf16_over(got: torch.Tensor, want: torch.Tensor, limits: torch.Tensor) -> torch.Tensor:
    """Each row's max ``|got - want|`` over its limit (the check holds where
    it is at most 1; a row of limit 0 must match exactly)."""
    err = (got - want).abs().amax(dim=1)
    return torch.where(limits > 0, err / torch.clamp_min(limits, 1e-30), torch.where(err > 0, torch.inf, 0.0))


# ------------------------------------------------------------ K3's plan


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def k3_region_bytes(n: int, k: int, bf16: bool) -> int:
    """Shared bytes of a K3 region of ``n`` slots (``bucket_cg.cu
    region_bytes``): the gathered rows, stride k rounded up to whole
    16-byte words, then c1 and w, then each 32-slot chunk's end and count."""
    size = 2 if bf16 else 4
    q = 16 // size
    kp = -(-k // q) * q
    chunks = -(-n // 32)
    return _r16(n * kp * size) + 2 * _r16(4 * n) + 2 * _r16(4 * chunks)


def k3_cols(k: int) -> int:
    """Columns a lane owns at rank ``k`` (``bucket_cg.cu cols_of``: lane l
    the columns l + 32 j, j < this): 2 up to rank 64, then 4, 8, 16."""
    return 2 if k <= 64 else 4 if k <= 128 else 8 if k <= 256 else 16


def k3_window(k: int) -> int:
    """Slots of a streamed window (``bucket_cg.cu win_slots``)."""
    return 64 if k3_cols(k) <= 8 else 32


def k3_cpart(k: int) -> int:
    """Floats of one exchanged partial, b | diag | count (``bucket_cg.cu
    cpart_floats``)."""
    return 64 * k3_cols(k) + 16


def k3_smem(plan: tuple[int, int, int, int], k: int, bf16: bool) -> int:
    """Dynamic shared bytes of a K3 launch under ``plan`` (``bucket_cg.cu
    split_smem``): YtY with rows of 32 NC floats up to K3_YTY_COLS columns
    a lane (none above, it is read from L2); warp mode K3_PACK_WARPS regions
    of ``slice`` slots, each with its p vector (and its CG vectors above
    K3_REG_COLS); cluster mode one resident region of ``slice`` slots or two
    streamed windows, beside YtY, p (and the CG vectors), the warps'
    partials and the two exchanged partials."""
    mode, _, slice_, resident = plan
    nc = k3_cols(k)
    yty = _r16(4 * k * 32 * nc) if nc <= K3_YTY_COLS else 0
    vec = 4 * 32 * nc * (1 if nc <= K3_REG_COLS else 7)
    if mode == 0:
        return yty + K3_PACK_WARPS * (k3_region_bytes(slice_, k, bf16) + vec)
    region = k3_region_bytes(slice_, k, bf16) if resident else 2 * k3_region_bytes(k3_window(k), k, bf16)
    return region + yty + vec + 4 * K3_CTA_WARPS * 64 * nc + 4 * 2 * k3_cpart(k)


def k3_smem_card(plan: tuple[int, int, int, int], k: int, bf16: bool) -> int:
    """:func:`k3_smem` as the kernel's library counts it (``bucket_cg.cu
    bucket_cg_smem``; on a card only). The plans the wrapper launches are
    made with this, so the launch never disagrees with its plan; the CPU
    mirror :func:`k3_smem` is held to it by a card test."""
    import ctypes

    from albedo_tpu_torch.kernels import build

    fn = build.library("bucket_cg").bucket_cg_smem
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int
    mode, _, slice_, resident = plan
    n = fn(int(bf16), k, mode, slice_, resident)
    if n < 0:
        raise ValueError(f"bucket_cg: no split-design plan {plan} at rank {k}")
    return n


def k3_pack_l(k: int, smem=k3_smem) -> int:
    """The longest row K3's warp mode takes at rank ``k``: K3_PACK_L up to
    KMAX; above, the longest (a multiple of 4, at most the source's 128)
    whose warp-mode CTA of float32 rows fits K3_WIDE_PACK_SMEM bytes by
    ``smem``, at least 4 (bf16 rows take the same lengths: in half the
    bytes, measured faster than twice the slots, ``als_partials_bench
    variants k3w``)."""
    return K3_PACK_L if k <= KMAX else _k3_pack_l(k, K3_WIDE_PACK_SMEM, smem)


@functools.lru_cache(maxsize=None)
def _k3_pack_l(k: int, budget: int, smem) -> int:
    pack = 128
    while pack > 4 and smem((0, 1, pack, 1), k, False) > budget:
        pack -= 4
    return pack


def _k3_plan(b: int, length: int, k: int, bf16: bool, n_sm: int, c_max: int = 16,
             smem=k3_smem) -> tuple[int, int, int, int]:
    """(mode, c, slice, resident) of a K3 launch at rank <= K3_SPLIT_KMAX
    (``csrc/bucket_cg.cu``), shared bytes counted by ``smem``. Rows of at
    most :func:`k3_pack_l` slots take warp mode (mode 0: one warp a row,
    its ``slice`` = the length rounded up to 4 slots, resident). Longer rows
    take cluster mode (mode 1): the row's slots cut into ``c`` slices of
    ``slice`` slots (whole 32-slot chunks), one CTA each, a cluster a row;
    ``c`` doubles from 1 while the group has fewer CTAs than the card has
    SMs and ``c`` is below K3_SPREAD (K3_WIDE_SPREAD above KMAX), or while a
    slice does not fit shared memory, up to ``c_max`` (16 only where the
    card holds such a cluster, else 8). ``resident`` is 1 when the slice
    fits K3_SMEM, else the slice is streamed through windows of
    :func:`k3_window` slots."""
    if length <= k3_pack_l(k, smem):
        return 0, 1, max(4, -(-length // 4) * 4), 1

    def plan_at(c: int) -> tuple[int, int, int, int]:
        slice_ = -(-(-(-length // c)) // 32) * 32
        return 1, c, slice_, int(smem((1, c, slice_, 1), k, bf16) <= K3_SMEM)

    spread = min(c_max, K3_SPREAD if k <= KMAX else K3_WIDE_SPREAD)
    c = 1
    while c < c_max and ((b * c < n_sm and c < spread) or not plan_at(c)[3]):
        c *= 2
    return plan_at(c)


def k3_units(b: int, length: int, plan: tuple[int, int, int, int]) -> list[tuple[int, int, int, int, int]]:
    """Every unit of a K3 plan as the kernels walk it: (CTA, row, rank,
    first slot, one past the last slot). Warp mode: row r is warp r % 4 of
    CTA r // 4, rank 0, all its slots. Cluster mode: CTA g is rank g % c of
    row g // c and holds slots [rank slice, (rank + 1) slice) cut at the row's
    end (possibly none); a row's partials are added in rank order."""
    mode, c, slice_, _ = plan
    if mode == 0:
        return [(r // K3_PACK_WARPS, r, 0, 0, length) for r in range(b)]
    return [(g, g // c, g % c, min(length, (g % c) * slice_), min(length, (g % c + 1) * slice_))
            for g in range(b * c)]


def _k3_cluster16(dev: torch.device, bf16: bool, k: int, smem: int) -> bool:
    """Whether the card holds a cluster of 16 cluster-mode CTAs of ``smem``
    bytes each at rank ``k`` (``bucket_cg.cu bucket_cg_clusters``), cached
    per column class and size."""
    key = (dev.index, bf16, k3_cols(k), smem)
    if key not in _K3_CLUSTER16:
        import ctypes

        from albedo_tpu_torch.kernels import build

        fn = build.library("bucket_cg").bucket_cg_clusters
        fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
        with torch.cuda.device(dev):
            n = fn(int(bf16), k, 16, smem)
        if n < 0:
            raise RuntimeError(f"bucket_cg: the cluster occupancy query failed: cudaError {-n}")
        _K3_CLUSTER16[key] = n > 0
    return _K3_CLUSTER16[key]


def k3_plan_for(b: int, length: int, k: int, gather_dtype: str | None, dev: torch.device) -> tuple[int, int, int, int]:
    """The plan K3 launches a (b, length) group with on ``dev``: clusters of
    16 where the card holds them, else at most 8; shared bytes as the
    kernel's library counts them (:func:`k3_smem_card`)."""
    bf16 = gather_dtype is not None
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = _k3_plan(b, length, k, bf16, n_sm, smem=k3_smem_card)
    if plan[1] == 16 and not _k3_cluster16(dev, bf16, k, k3_smem_card(plan, k, bf16)):
        plan = _k3_plan(b, length, k, bf16, n_sm, c_max=8, smem=k3_smem_card)
    return plan


def bucket_cg_body(
    source: torch.Tensor, yty: torch.Tensor, idx: torch.Tensor,
    val: torch.Tensor, mask: torch.Tensor, x0: torch.Tensor,
    reg: float, alpha: float, cg_steps: int, out: torch.Tensor | None = None,
    gather_dtype: str | None = None,
) -> torch.Tensor:
    """K3: matrix-free warm-started Jacobi-PCG on the implicit normal
    equations, ``cg_steps`` steps (CUDA kernel ``bucket_cg``, or
    ``bucket_cg_bf16`` reading the bf16 table), into ``out`` (B, k) when
    given. Up to rank K3_SPLIT_KMAX one call is one launch of the split
    design under :func:`k3_plan_for`'s plan (counted ``bucket_cg`` up to
    KMAX, ``bucket_cg_wide`` above); a plan the kernel or the card refuses
    raises. Wider ranks take the tiled kernel (``bucket_cg_tiled``), in
    row chunks when its global workspace is needed."""
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
    if k <= K3_SPLIT_KMAX:
        plan, chunks = k3_plan_for(b, length, k, gather_dtype, dev), [(0, b, None)]
    else:  # the plan is ignored above K3_SPLIT_KMAX
        plan, chunks = (0, 1, 4, 1), _workspace_chunks((TILE + 7) * k + 3 * TILE, b, dev)
    for r0, rows, ws in chunks:
        call(
            kernel, dev, table.data_ptr(), yty.data_ptr(),
            idx.data_ptr() + 4 * r0 * length, val.data_ptr() + 4 * r0 * length,
            mask.data_ptr() + r0 * length, x0.data_ptr() + 4 * r0 * k,
            x.data_ptr() + 4 * r0 * k, rows, length, k, float(reg), float(alpha),
            int(cg_steps), *plan, None if ws is None else ws.data_ptr(),
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
    if solver == "cg" and groups:  # every group's warm starts in one gather (padding slots read row 0)
        x0_pool = target[torch.cat([g.row_ids.reshape(-1) for g in groups]).clamp(min=0).long()]
    off = 0
    for g in groups:
        n, b, length = g.idx.shape
        idx = g.idx.reshape(n * b, length)
        val = g.val.reshape(n * b, length)
        mask = g.mask.reshape(n * b, length)
        out = pool[off:off + n * b]
        if solver == "cg":
            bucket_cg_body(table, yty, idx, val, mask, x0_pool[off:off + n * b], reg, alpha, cg_steps, out=out,
                           gather_dtype=gather_dtype)
        else:
            bucket_solve_body(table, yty, idx, val, mask, reg, alpha, out=out, gather_dtype=gather_dtype)
        off += n * b
    return land_rows(target, pool, landing)


def fit_loop_reference(
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
    """Plain version of :func:`fit_loop`: ``n_iter`` alternating sweeps in
    MLlib order, item factors first (from the user factors), then user
    factors, each half-sweep enqueued from Python. ``callback(it, user_f,
    item_f)``, if given, runs after each sweep with the device tensors. The
    factor tables stay float32 under bf16 gathers."""
    for it in range(n_iter):
        item_f = half_sweep(user_f, item_f, item_groups, item_landing, reg, alpha, solver, cg_steps,
                            gather_dtype)
        user_f = half_sweep(item_f, user_f, user_groups, user_landing, reg, alpha, solver, cg_steps,
                            gather_dtype)
        if callback is not None:
            callback(it, user_f, item_f)
    return user_f, item_f


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
    report: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused fit (JAX ``als_fit_fused``, ``als_init_fit_fused``): the
    sweeps of :func:`fit_loop_reference`, on the card as one CUDA graph of an
    iteration replayed. On CPU tensors it is :func:`fit_loop_reference`.

    On the card, iteration 0 runs eagerly on the thread's capture stream: it
    is the fit's first iteration and the warm-up (cuBLAS's workspace, the
    kernels' attributes and plans, K1's workspace). Then one iteration (both
    half-sweeps, items first, ending in copies of the new tables into the
    static ``user_f``/``item_f`` it read) is captured and replayed ``n_iter -
    1`` times, so the host enqueues a replay, not ~80-150 calls, an
    iteration; the bits are the eager loop's. ``reg``, ``alpha``,
    ``cg_steps``, the plans and every pointer are fixed in the graph, so a
    graph serves one fit and is released when the fit returns. The graph
    owns every buffer it reads or writes: K1's workspace is the fit's own
    (:func:`_k1_workspace`), the rest lives in the static tables or in the
    thread's graph pool (``utils.graphs.graph_pool``), whose blocks the next fit's
    capture reuses once this fit's graph is gone (``utils.graphs.replay_loop``). The capture starts while
    iteration 0 still runs on the card. ``callback(it, user_f, item_f)``, if
    given, runs after iteration 0 and after each replay with copies of that
    iteration's tables (the next replay overwrites the static ones). ``report``, if
    given, gets ``compile_s`` (the seconds spent capturing and
    instantiating) and ``compile_source`` (``"capture"``); both stay 0.0 and
    None where nothing is captured: on the CPU, and at ``n_iter`` 0 or 1.

    The capture runs in ``thread_local`` mode: it refuses a host sync in
    this thread (a hidden sync in a half-sweep raises), and ignores other
    threads' CUDA calls, which go to their own streams, so serving threads
    neither fail the fit nor land in its graph. A capture or
    replay that fails raises ``RuntimeError`` naming the fit: there is no
    eager fallback."""
    if report is not None:
        report.update(compile_s=0.0, compile_source=None)
    if on_cpu("fit_loop", user_f, item_f, user_landing, item_landing):
        return fit_loop_reference(user_f, item_f, user_groups, item_groups, user_landing, item_landing, reg, alpha,
                                  n_iter, solver, cg_steps, callback, gather_dtype)
    if n_iter <= 0:
        return user_f, item_f
    name = (f"ALS fit ({solver}, rank {user_f.shape[1]}, {len(item_groups)} item and {len(user_groups)} user "
            f"groups, {n_iter} iterations)")

    tables = [user_f, item_f]

    def unit(it):  # iteration 0 replaces the tables; the captured one writes into them
        uf, vf = fit_loop_reference(tables[0], tables[1], user_groups, item_groups, user_landing, item_landing,
                                    reg, alpha, 1, solver, cg_steps, gather_dtype=gather_dtype)
        if it == 0:
            tables[:] = uf, vf
        else:
            tables[0].copy_(uf)
            tables[1].copy_(vf)

    def after(it):
        callback(it, tables[0].clone(), tables[1].clone())

    outer, _K1_OWNED.store = getattr(_K1_OWNED, "store", None), []
    try:
        replay_loop(name, user_f.device, unit, n_iter, after=None if callback is None else after, report=report,
                    span="fit_loop.replays")
    finally:
        _K1_OWNED.store = outer
    caller = torch.cuda.current_stream(user_f.device)
    for t in tables:
        t.record_stream(caller)  # allocated on the capture stream, used on the caller's
    return tables[0], tables[1]


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
