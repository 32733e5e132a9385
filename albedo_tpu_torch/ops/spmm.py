"""The sparse passes and the masked top-k of the memory-based CFs (K11)
(PyTorch + CUDA).

Port of the device half of ``albedo_tpu/recommenders/cf.py``:
``gather_matmul_t`` (:74), ``scatter_matmul`` (:90), ``row_sums`` (:106),
``col_weighted_sums`` (:120) and the tail of the two ``score`` functions
(:212-218, :240-249).

- :func:`spmm_rows` runs the CUDA kernel ``spmm_rows``: a CSR matrix (held
  as :class:`CSR`, the arrays directly, not JAX's padded row groups) times a
  dense (n, B) block. ``x @ W^T`` is ``spmm_rows(W, x^T)`` and ``m @ W`` is
  the same kernel on ``W``'s transpose (:meth:`CSR.transpose`, built on the
  host), so the scatter of the JAX program becomes a gather with no atomics;
  ``W @ 1`` and ``W^T t`` are the B = 1 cases. A warp walks each unit of
  :func:`spmm_plan` (a row, or a chunk of a long row whose partials a
  second kernel adds in chunk order), built on the host once per matrix and
  cached on it.
- :func:`masked_topk` runs the CUDA kernel ``masked_topk``: divide each
  column of a (B, n) block by an optional norm, mask each row's starred
  columns, keep the top k in ``lax.top_k``'s order. Above k = 128, or with
  a starred row longer than 32768 columns, it runs the select path's
  ``masked_select`` entry (``csrc/topk_select.cu``: the normalized block
  written to a scratch buffer, starred columns to -inf, a radix select), so
  it takes any k and any starred width, as ``lax.top_k`` does.

The plain versions (:func:`spmm_rows_reference`, :func:`masked_topk_reference`)
run for CPU tensors and are what ``chip_smoke.py`` holds the kernels against.
Both ``spmm_rows`` versions sum in float64 and round once to float32, so
they agree to about one float32 rounding whatever their order (held against
the L1 mass of each sum, :func:`spmm_rows_mass`); ``masked_topk`` matches
bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from albedo_tpu_torch.kernels.build import call, check_operand, on_cpu
from albedo_tpu_torch.ops.topk import EXCLUDE_MAX, exclude_and_rank, select_scratch

KMAX_STREAM = 128  # largest k of the streaming masked_topk kernel; larger k takes the select path


@dataclasses.dataclass
class CSR:
    """A sparse (n_rows, n_cols) matrix in CSR form on one device:
    ``indptr`` (n_rows + 1,) int32, ``idx`` (nnz,) int32 column indices,
    ``val`` (nnz,) float32 or None for a binary matrix."""

    indptr: torch.Tensor
    idx: torch.Tensor
    val: torch.Tensor | None
    n_cols: int
    plan: "SpmmPlan | None" = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def n_rows(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @staticmethod
    def from_host(indptr: np.ndarray, idx: np.ndarray, val: np.ndarray | None, n_cols: int,
                  device) -> "CSR":
        def to(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype)).to(device)

        return CSR(to(indptr, np.int32), to(idx, np.int32),
                   None if val is None else to(val, np.float32), int(n_cols))

    def transpose(self) -> "CSR":
        """The transpose, in CSR form (the CSC of this matrix), on the same
        device: entries sorted stably by column, so each transposed row keeps
        the row order of the entries."""
        indptr = self.indptr.cpu().numpy()
        cols = self.idx.cpu().numpy()
        rows = np.repeat(np.arange(self.n_rows, dtype=np.int32), np.diff(indptr))
        order = np.argsort(cols, kind="stable")
        t_indptr = np.concatenate([[0], np.cumsum(np.bincount(cols, minlength=self.n_cols))])
        val = None if self.val is None else self.val.cpu().numpy()[order]
        return CSR.from_host(t_indptr, rows[order], val, self.n_rows, self.indptr.device)


# Entries of a unit of spmm_rows (csrc/spmm_rows.cu): a row of at most this
# many entries is one unit, a longer row is cut into units of this many.
SPMM_CHUNK = 128


@dataclasses.dataclass
class SpmmPlan:
    """``spmm_rows``' work list for one matrix, on its device: ``units``
    (n_units, 4) int32 rows ``(row, lo, hi, slot)``, entries [lo, hi) of
    ``row`` (slot -1: the whole row, written to the output; else the chunk's
    float64 partial goes to workspace row ``slot``), and ``long_rows``
    (n_long, 3) int32 rows ``(row, first slot, slots)``, the rows cut into
    chunks, whose ``n_slots`` partials are added in chunk order."""

    units: torch.Tensor
    long_rows: torch.Tensor
    n_units: int
    n_long: int
    n_slots: int


def spmm_units(indptr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The host half of :func:`spmm_plan`: ``(units, long_rows)`` as int32
    arrays for a CSR row pointer and units of ``SPMM_CHUNK`` entries. Every
    row, empty ones included, is one unit or the consecutive chunks of one
    long row; chunks of a row take consecutive slots in entry order."""
    chunk = SPMM_CHUNK
    indptr = np.asarray(indptr, dtype=np.int64)
    lens = np.diff(indptr)
    n_units = np.where(lens > chunk, -(-lens // chunk), 1)
    rows = np.repeat(np.arange(len(lens), dtype=np.int64), n_units)
    first_unit = np.concatenate([[0], np.cumsum(n_units)])[:-1]
    within = np.arange(len(rows), dtype=np.int64) - np.repeat(first_unit, n_units)
    lo = indptr[rows] + within * chunk
    hi = np.minimum(lo + chunk, indptr[rows + 1])
    split = lens[rows] > chunk
    slot = np.full(len(rows), -1, dtype=np.int64)
    slot[split] = np.arange(int(split.sum()))
    long = np.flatnonzero(lens > chunk)
    first_slot = np.concatenate([[0], np.cumsum(n_units[long])])[:-1]
    units = np.stack([rows, lo, hi, slot], axis=1).astype(np.int32)
    long_rows = np.stack([long, first_slot, n_units[long]], axis=1).astype(np.int32).reshape(-1, 3)
    return units, long_rows


def spmm_plan(w: CSR) -> SpmmPlan:
    """:func:`spmm_units` of ``w``'s row pointer on ``w``'s device, built
    once and cached on ``w`` (the matrix is fixed once a recommender is
    built)."""
    if w.plan is None:
        units, long_rows = spmm_units(w.indptr.cpu().numpy())
        dev = w.indptr.device
        w.plan = SpmmPlan(torch.as_tensor(units).to(dev), torch.as_tensor(long_rows).to(dev), len(units),
                          len(long_rows), int(long_rows[:, 2].sum()))
    return w.plan


def spmm_rows_reference(w: CSR, x: torch.Tensor) -> torch.Tensor:
    """Plain version of ``spmm_rows``: gather the rows of ``x`` each entry
    reads, scale them, and add them into their sparse row with
    ``index_add_``, in float64 (the float32 products are exact there),
    rounded once to ``x``'s type."""
    rows = torch.repeat_interleave(
        torch.arange(w.n_rows, device=x.device), (w.indptr[1:] - w.indptr[:-1]).long()
    )
    terms = x[w.idx.long()].double()
    if w.val is not None:
        terms = terms * w.val[:, None].double()
    out = torch.zeros((w.n_rows, x.shape[1]), dtype=torch.float64, device=x.device)
    return out.index_add_(0, rows, terms).to(x.dtype)


def spmm_rows_mass(w: CSR, x: torch.Tensor) -> torch.Tensor:
    """The L1 mass of each output element of ``spmm_rows``: the sum of the
    absolute values of its terms. Round-off of any order of those sums is a
    small multiple of it, so the kernel is held against its plain version
    relative to it; an element with no terms has mass 0 and is exactly 0."""
    val = None if w.val is None else w.val.abs()
    return spmm_rows_reference(CSR(w.indptr, w.idx, val, w.n_cols), x.abs())


def spmm_rows(w: CSR, x: torch.Tensor) -> torch.Tensor:
    """K11's sparse pass: ``W @ x``, (n_rows, B) f32, for a CSR ``W``
    (n_rows, n_cols) and a dense ``x`` (n_cols, B) (CUDA kernel
    ``spmm_rows``, on the plan cached on ``W``). The same inputs give the
    same bits."""
    operands = [w.indptr, w.idx, x] + ([] if w.val is None else [w.val])
    if on_cpu("spmm_rows", *operands):
        return spmm_rows_reference(w, x)
    dev = x.device
    nnz = int(w.idx.shape[0])
    n_b = int(x.shape[1])
    check_operand("spmm_rows", "x", x, torch.float32, (w.n_cols, n_b), dev)
    check_operand("spmm_rows", "indptr", w.indptr, torch.int32, (w.n_rows + 1,), dev)
    check_operand("spmm_rows", "idx", w.idx, torch.int32, (nnz,), dev)
    if w.val is not None:
        check_operand("spmm_rows", "val", w.val, torch.float32, (nnz,), dev)
    plan = spmm_plan(w)
    out = torch.empty((w.n_rows, n_b), dtype=torch.float32, device=dev)
    # the chunks' float64 partials; B = 1 and a plan with no long row need none
    ws = torch.empty((plan.n_slots, n_b), dtype=torch.float64, device=dev) if n_b > 1 and plan.n_slots else None
    call("spmm_rows", dev, x.data_ptr(), w.indptr.data_ptr(), w.idx.data_ptr(),
         None if w.val is None else w.val.data_ptr(), out.data_ptr(), plan.units.data_ptr(), plan.n_units,
         plan.long_rows.data_ptr(), plan.n_long, None if ws is None else ws.data_ptr(), w.n_rows, n_b)
    return out


def masked_topk_reference(
    scores: torch.Tensor, starred: torch.Tensor | None, k: int, col_norm: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``masked_topk``: ``scores / max(col_norm, 1e-12)``,
    starred columns to -inf, then the K5 ordering
    (:func:`~albedo_tpu_torch.ops.topk.exclude_and_rank`)."""
    if col_norm is not None:
        scores = scores / torch.clamp_min(col_norm, 1e-12)[None, :]
    return exclude_and_rank(scores, k, starred)


def masked_topk(
    scores: torch.Tensor, starred: torch.Tensor | None, k: int, col_norm: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K11's tail: ``(scores (B, k) f32, columns (B, k) int32)`` of the top-k
    columns of each row of the (B, n) block ``scores`` (any strides), after
    dividing column i by ``max(col_norm[i], 1e-12)`` (when given) and
    dropping the row's ``starred`` columns ((B, L) int32, -1-padded); ordered
    by score descending, then column ascending, ``(-inf, -1)`` past the
    admissible columns (CUDA kernel ``masked_topk``)."""
    operands = [scores] + [t for t in (starred, col_norm) if t is not None]
    if on_cpu("masked_topk", *operands):
        return masked_topk_reference(scores, starred, k, col_norm)
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(f"masked_topk: scores must be a 2-D float32 block, got {scores.dtype} {tuple(scores.shape)}")
    if k < 1:
        raise ValueError(f"masked_topk: takes k >= 1, got {k}")
    n_rows, n = scores.shape
    dev = scores.device
    n_star, star_ptr = 0, None
    if starred is not None and starred.shape[1] > 0:
        n_star = int(starred.shape[1])
        check_operand("masked_topk", "starred", starred, torch.int32, (n_rows, n_star), dev)
        star_ptr = starred.data_ptr()
    if col_norm is not None:
        check_operand("masked_topk", "col_norm", col_norm, torch.float32, (n,), dev)
    norm_ptr = None if col_norm is None else col_norm.data_ptr()
    vals = torch.empty((n_rows, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n_rows, k), dtype=torch.int32, device=dev)
    if k <= KMAX_STREAM and n_star <= EXCLUDE_MAX:
        call("masked_topk", dev, scores.data_ptr(), scores.stride(0), scores.stride(1), star_ptr, norm_ptr,
             vals.data_ptr(), idx.data_ptr(), n_rows, n, k, n_star, 1 << (n_star - 1).bit_length() if n_star else 0)
        return vals, idx
    rows, sort_pad, scratch, sortbuf = select_scratch(n_rows, n, k, 0, dev)
    for row0 in range(0, n_rows, rows):
        call("masked_select", dev, scores.data_ptr(), scores.stride(0), scores.stride(1), star_ptr, norm_ptr,
             vals.data_ptr(), idx.data_ptr(), row0, min(rows, n_rows - row0), n, k, n_star, scratch.data_ptr(),
             None if sortbuf is None else sortbuf.data_ptr(), sort_pad, count="masked_topk_select")
    return vals, idx
