"""Block-sparse linear model over a ``FeatureMatrix`` (PyTorch + CUDA).

Port of ``albedo_tpu/ops/sparse_linear.py``. The ranker's logistic
regression reads its features as blocks (``features/assembler.py``):

``logit = b + dense @ w_dense + sum_f W_cat[f][idx_f] + sum_f <bag_val, W_bag[f][bag_idx]>``

which is the one-hot dot product computed as weight-row gathers and segment
sums. K8 :func:`segment_dot` runs the CUDA kernel ``segment_dot``: the CSR
segmented gather-multiply-sum behind the bag-field logits (forward over the
row-sorted flats, backward over the vocab-sorted copy) and the backward of
every gather. K8c :func:`gather_sum` runs the CUDA kernel ``gather_sum``: all
the gather terms of the logits (each ``cat:`` field's ``w[arr]`` and each rep
expansion's ``lu[rep]``) added to the rest in one pass; its autograd
Function takes each table's gradient as K8 over a row order sorted by that
table's index (``feature_batch(..., grad_layout=True)`` builds the ``cat:``
fields' orders; the rep fields always carry theirs). :class:`_BagTerm` is
the JAX module's ``_bag_term`` custom VJP as a ``torch.autograd.Function``;
its ``_rep_term`` (the rep expansion and its segment-sum VJP) is a term of
:class:`_GatherSum`. The JAX module
reduces by cumsum differences (a TPU workaround); the port sums each segment
directly, which computes the same function with less round-off, so the two
agree to a tolerance, not bit for bit.

The CV weight grid (``LogisticRegression.fit_many``) solves G models on one
batch at once: parameters with a leading grid axis give (G, N) logits and
(G,) losses, each row the single-model function of its own parameters (the
JAX module's functions under ``jax.vmap``). K8g (``segment_dot`` with x of
shape (G, n)) and K8c-g (``gather_sum`` with base of shape (G, N)) read each
index once for all G rows; the dense block stays one matmul, (N, D) @ (D, G).

Standardization (Spark ``setStandardization(true)``): features are scaled by
``1/std`` (no centering of the sparse blocks, as MLlib); the L2 penalty
applies to the scaled coefficients; ``fold_scales`` converts back to raw
space. Not ported: the padded ``bag_idx:`` layout of the mesh path
(``parallel/lr.py``).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from albedo_tpu_torch.features.assembler import FeatureMatrix
from albedo_tpu_torch.kernels.build import call, check_operand, on_cpu

Params = dict[str, torch.Tensor]


def feature_batch(
    fm: FeatureMatrix, device: str | torch.device = "cuda", grad_layout: bool = False,
) -> dict[str, torch.Tensor]:
    """A FeatureMatrix's arrays on ``device`` as a flat dict of tensors.

    Bag fields are laid out DUAL-SORTED: a row-sorted copy (+ row indptr) for
    the forward segment sums and a vocab-sorted copy (+ vocab indptr spanning
    the whole weight table) for the weight gradient, so both directions are
    K8 over the real entries only. Vector fields upload factored: the (U, D)
    distinct vectors, the (N,) rep gather, and a rep-sorted order + indptr
    whose segment sums are the gather's backward (K8c's). Factored
    bag fields carry the same rep layout (``bagrep:``). ``grad_layout`` adds
    each ``cat:`` field's row order sorted by category and its indptr over
    the field's vocabulary (``catgrad:<f>:order``/``:indptr``), which K8c's
    backward reads: a fit builds it once here, a prediction never needs it."""
    dev = torch.device(device)

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a)).to(dev)

    batch: dict[str, torch.Tensor] = {"dense": t(fm.dense.astype(np.float32, copy=False))}
    for f in fm.vec_fields():  # canonical sorted order (see vec_fields)
        rep, order, indptr = _rep_layout(fm.vec_rep[f], fm.vec[f].shape[0])
        batch[f"vecflat:{f}:vec"] = t(fm.vec[f].astype(np.float32, copy=False))
        batch[f"vecflat:{f}:rep"] = t(rep)
        batch[f"vecflat:{f}:order"] = t(order)
        batch[f"vecflat:{f}:indptr"] = t(indptr)
    for f, v in fm.cat.items():
        batch[f"cat:{f}"] = t(np.asarray(v).astype(np.int32))
        if grad_layout:
            _, order, indptr = _rep_layout(v, fm.cat_sizes[f])
            batch[f"catgrad:{f}:order"] = t(order)
            batch[f"catgrad:{f}:indptr"] = t(indptr)
    flat = fm.flat_bags()
    for f in fm.bag_idx:
        rows, vocab, vals = flat[f]
        n = fm.bag_idx[f].shape[0]
        order = np.argsort(vocab, kind="stable")
        v_size = fm.bag_sizes[f]
        r_indptr = np.zeros(n + 1, np.int32)
        np.cumsum(np.bincount(rows, minlength=n), out=r_indptr[1:])
        v_indptr = np.zeros(v_size + 1, np.int32)
        np.cumsum(np.bincount(vocab, minlength=v_size), out=v_indptr[1:])
        batch[f"bagflat:{f}:r_vocab"] = t(vocab)              # row-sorted
        batch[f"bagflat:{f}:r_val"] = t(vals)
        batch[f"bagflat:{f}:r_indptr"] = t(r_indptr)
        batch[f"bagflat:{f}:v_rows"] = t(rows[order].astype(np.int32))
        batch[f"bagflat:{f}:v_val"] = t(vals[order])          # vocab-sorted
        batch[f"bagflat:{f}:v_indptr"] = t(v_indptr)
        bag_rep = fm.bag_rep.get(f)
        if bag_rep is not None:
            rep, rorder, rindptr = _rep_layout(bag_rep, n)
            batch[f"bagrep:{f}:rep"] = t(rep)
            batch[f"bagrep:{f}:order"] = t(rorder)
            batch[f"bagrep:{f}:indptr"] = t(rindptr)
    return batch


def _rep_layout(rep: np.ndarray, n_distinct: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The rep-expansion layout for a (N,) rep vector: ``(rep int32,
    rep-sorted row order, (n_distinct+1,) segment indptr)``."""
    rep = np.asarray(rep).astype(np.int32)
    order = np.argsort(rep, kind="stable").astype(np.int32)
    indptr = np.zeros(n_distinct + 1, np.int32)
    np.cumsum(np.bincount(rep, minlength=n_distinct), out=indptr[1:])
    return rep, order, indptr


def init_params(fm: FeatureMatrix) -> dict[str, np.ndarray]:
    """Zero coefficients in the params structure (host numpy)."""
    p: dict[str, np.ndarray] = {
        "bias": np.float32(0.0),
        "dense": np.zeros((fm.dense_width,), np.float32),
    }
    for f, size in fm.cat_sizes.items():
        p[f"cat:{f}"] = np.zeros((size,), np.float32)
    for f, size in fm.bag_sizes.items():
        p[f"bag:{f}"] = np.zeros((size,), np.float32)
    return p


def inverse_std_scales(fm: FeatureMatrix) -> dict[str, np.ndarray]:
    """Per-feature ``1/std`` in the params structure (host numpy, the JAX
    module's code): the unbiased sample std of each expanded column, as
    MLlib's summarizer; constant features get scale 0."""
    n = max(1, fm.n_rows)
    bessel = n / (n - 1) if n > 1 else 1.0

    def inv(std: np.ndarray) -> np.ndarray:
        return np.where(std > 0, 1.0 / np.maximum(std, 1e-12), 0.0).astype(np.float32)

    scales: dict[str, np.ndarray] = {"bias": np.float32(1.0)}
    ddof = 1 if n > 1 else 0
    std_parts = [fm.dense.std(axis=0, dtype=np.float64, ddof=ddof)]
    for f in fm.vec_fields():
        # Factored vec field: moments of the EXPANDED column are count-
        # weighted moments over the distinct vectors.
        v = fm.vec[f].astype(np.float64)
        counts = np.bincount(fm.vec_rep[f], minlength=v.shape[0]).astype(np.float64)
        mean = counts @ v / n
        var = counts @ (v**2) / n - mean**2
        if ddof:
            var = var * (n / (n - 1))
        std_parts.append(np.sqrt(np.maximum(var, 0)))
    scales["dense"] = inv(np.concatenate(std_parts) if len(std_parts) > 1 else std_parts[0])
    for f, size in fm.cat_sizes.items():
        p = np.bincount(fm.cat[f], minlength=size) / n
        scales[f"cat:{f}"] = inv(np.sqrt(p * (1 - p) * bessel))
    flat = fm.flat_bags()
    for f, size in fm.bag_sizes.items():
        rows, cols, vals64 = flat[f]
        cols = cols.astype(np.int64)
        vals = vals64.astype(np.float64)
        rep = fm.bag_rep.get(f)
        mult = None if rep is None else np.bincount(rep, minlength=fm.bag_idx[f].shape[0]).astype(np.float64)
        # The expanded column value is the SUM of a row's entries for that
        # index; when indices are sorted-unique within each row there is
        # nothing to aggregate.
        same_row = rows[1:] == rows[:-1]
        within_sorted = not np.any(same_row & (cols[1:] < cols[:-1]))
        has_dup = within_sorted and bool(np.any(same_row & (cols[1:] == cols[:-1])))
        if within_sorted and not has_dup:
            w1 = vals if mult is None else vals * mult[rows]
            w2 = vals**2 if mult is None else vals**2 * mult[rows]
            s1 = np.bincount(cols, weights=w1, minlength=size)
            s2 = np.bincount(cols, weights=w2, minlength=size)
        else:
            key = rows.astype(np.int64) * size + cols
            order = np.argsort(key, kind="stable")
            key_s, vals_s = key[order], vals[order]
            uniq, start = np.unique(key_s, return_index=True)
            agg = np.add.reduceat(vals_s, start) if start.size else np.zeros(0)
            col_of = uniq % size
            m_of = 1.0 if mult is None else mult[uniq // size]
            s1 = np.bincount(col_of, weights=agg * m_of, minlength=size)
            s2 = np.bincount(col_of, weights=agg**2 * m_of, minlength=size)
        mean = s1 / n
        var = (s2 / n - mean**2) * bessel
        scales[f"bag:{f}"] = inv(np.sqrt(np.maximum(var, 0)))
    return scales


def dense_center(fm: FeatureMatrix) -> np.ndarray:
    """Per-column means of the logical dense block (host numpy). Centering
    the dense block keeps float32 conditioning when a column is near
    constant at large magnitude; the bias absorbs the shift."""
    n = max(1, fm.n_rows)
    parts = [fm.dense.mean(axis=0, dtype=np.float64)]
    for f in fm.vec_fields():
        counts = np.bincount(fm.vec_rep[f], minlength=fm.vec[f].shape[0])
        parts.append(counts.astype(np.float64) @ fm.vec[f].astype(np.float64) / n)
    out = np.concatenate(parts) if len(parts) > 1 else parts[0]
    return out.astype(np.float32)


# ----------------------------------------------------------------------- K8


def segment_dot_reference(
    x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor | None, indptr: torch.Tensor
) -> torch.Tensor:
    """Plain version of K8: ``out[s] = sum_{j in segment s} x[idx[j]] * val[j]``
    (``val`` None reads as ones) by ``index_add_`` over each entry's
    segment id; empty segments give 0. With x (G, n) (K8g), each row's sums:
    out (G, S)."""
    n_seg = indptr.shape[0] - 1
    counts = (indptr[1:] - indptr[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(n_seg, device=x.device), counts)
    terms = x[..., idx.long()]
    if val is not None:
        terms = terms * val
    out = torch.zeros(x.shape[:-1] + (n_seg,), dtype=x.dtype, device=x.device)
    return out.index_add_(x.dim() - 1, seg, terms)


# segment_dot.cu's partition: merge steps (segment ends + entries) a CTA
# and a thread, and K8g's grid rows a pass. Its workspace holds, for a
# capacity of ``cap`` CTAs, ``cap`` flags (0 between launches: each launch
# lowers the flags it raised) and ``SEGMENT_DOT_ROWS * cap`` partials.
SEGMENT_DOT_STEPS = 256
SEGMENT_DOT_IPT = 2
SEGMENT_DOT_ROWS = 8
# One zeroed workspace per (device, stream), grown as calls need: launches
# on one stream run in order, so they can share it, and K8 saves an
# allocation and a zeroing in each of its thousands of calls a fit.
_K8_WORKSPACE: dict[tuple[int, int], torch.Tensor] = {}
_K8_WORKSPACE_LOCK = threading.Lock()


def _segment_dot_workspace(n_seg: int, nnz: int, dev: torch.device) -> tuple[torch.Tensor, int]:
    """The (device, current stream)'s workspace and its capacity in CTAs."""
    n_cta = -(-(n_seg + nnz) // SEGMENT_DOT_STEPS)
    key = (dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    ws = _K8_WORKSPACE.get(key)
    if ws is None or ws.numel() < n_cta * (1 + SEGMENT_DOT_ROWS):
        with _K8_WORKSPACE_LOCK:
            ws = _K8_WORKSPACE.get(key)
            cap = 0 if ws is None else ws.numel() // (1 + SEGMENT_DOT_ROWS)
            if cap < n_cta:
                cap = max(n_cta, 1024, 2 * cap)
                ws = torch.zeros(cap * (1 + SEGMENT_DOT_ROWS), dtype=torch.int32, device=dev)
                _K8_WORKSPACE[key] = ws
    return ws, ws.numel() // (1 + SEGMENT_DOT_ROWS)


def segment_dot(
    x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor | None, indptr: torch.Tensor
) -> torch.Tensor:
    """K8: (S,) CSR segment sums of ``x[idx] * val`` over ``indptr`` (S + 1,)
    (CUDA kernel ``segment_dot``). ``x`` (n,) f32; ``idx`` (nnz,) int32 in
    [0, n); ``val`` (nnz,) f32 or None for ones; ``indptr`` int32,
    nondecreasing, ``indptr[0] == 0``, ``indptr[-1] == nnz``. With ``x``
    (G, n), K8g: (G, S), the sums of each row (CUDA kernel
    ``segment_dot_grid``, counted apart). On the card the kernel splits the
    work by a merge path over segment ends and entries, not by segments, and
    passes its carries between CTAs through a workspace kept per device and
    stream; one launch is counted a call."""
    if not _kernel_layout(x, idx, val, indptr):
        operands = [x, idx, indptr] + ([] if val is None else [val])
        if on_cpu("segment_dot_grid" if x.dim() == 2 else "segment_dot", *operands):
            return segment_dot_reference(x, idx, val, indptr)
        _raise_on_layout(x, idx, val, indptr)
    dev = x.device
    nnz = idx.shape[0]
    n_seg = indptr.shape[0] - 1
    ws, cap = _segment_dot_workspace(n_seg, nnz, dev)
    val_ptr = None if val is None else val.data_ptr()
    if x.dim() == 2:
        g, n_x = x.shape
        out = torch.empty((g, n_seg), dtype=torch.float32, device=dev)
        call("segment_dot_grid", dev, x.data_ptr(), n_x, idx.data_ptr(), val_ptr, indptr.data_ptr(), out.data_ptr(),
             n_seg, g, nnz, ws.data_ptr(), cap)
    else:
        out = torch.empty(n_seg, dtype=torch.float32, device=dev)
        call("segment_dot", dev, x.data_ptr(), idx.data_ptr(), val_ptr, indptr.data_ptr(), out.data_ptr(), n_seg,
             nnz, ws.data_ptr(), cap)
    return out


def _kernel_layout(x, idx, val, indptr) -> bool:
    """True when every operand lies on one CUDA device in the layout K8 (or
    K8g) reads: checked in one expression, as K8 runs thousands of times a
    fit and each check costs host time the card waits for."""
    d = x.get_device()
    return (x.is_cuda and x.dtype == torch.float32 and x.is_contiguous()
            and (x.dim() == 1 or (x.dim() == 2 and x.shape[0] >= 1))
            and idx.get_device() == d and idx.dtype == torch.int32 and idx.dim() == 1 and idx.is_contiguous()
            and indptr.get_device() == d and indptr.dtype == torch.int32 and indptr.dim() == 1
            and indptr.is_contiguous()
            and (val is None or (val.get_device() == d and val.dtype == torch.float32 and val.shape == idx.shape
                                 and val.is_contiguous())))


def _raise_on_layout(x, idx, val, indptr) -> None:
    """Raise ``ValueError`` naming what K8 (or K8g) cannot read."""
    kernel = "segment_dot_grid" if x.dim() == 2 else "segment_dot"
    dev = x.device
    nnz = idx.shape[0]
    check_operand(kernel, "x", x, torch.float32, (x.shape[0], x.shape[1]) if x.dim() == 2 else (x.shape[0],), dev)
    check_operand(kernel, "idx", idx, torch.int32, (nnz,), dev)
    check_operand(kernel, "indptr", indptr, torch.int32, (indptr.shape[0],), dev)
    if val is not None:
        check_operand(kernel, "val", val, torch.float32, (nnz,), dev)
    if x.dim() == 2:
        raise ValueError(f"{kernel}: x needs at least one grid row")
    raise ValueError(f"{kernel}: operands not in the layout the kernel reads")


class _BagTerm(torch.autograd.Function):
    """Per-row bag logit contribution: forward K8 over the row-sorted flats,
    backward (wrt ``w``) K8 over the vocab-sorted copy (K8g for a (G, V)
    ``w``: (G, N) out, (G, N) cotangent)."""

    @staticmethod
    def forward(ctx, w, r_vocab, r_val, r_indptr, v_rows, v_val, v_indptr):
        ctx.save_for_backward(v_rows, v_val, v_indptr)
        return segment_dot(w.contiguous(), r_vocab, r_val, r_indptr)

    @staticmethod
    def backward(ctx, g):
        v_rows, v_val, v_indptr = ctx.saved_tensors
        return segment_dot(g.contiguous(), v_rows, v_val, v_indptr), None, None, None, None, None, None


# ---------------------------------------------------------------------- K8c


def gather_sum_reference(
    base: torch.Tensor, tables: list[torch.Tensor], idxs: list[torch.Tensor]
) -> torch.Tensor:
    """Plain version of K8c: ``base + tables[0][idxs[0]] + ...``, added left
    to right (the kernel's order, so the two agree bit for bit). With base
    (G, N) and tables (G, size_j) (K8c-g), each row's sums."""
    out = base
    for table, idx in zip(tables, idxs):
        out = out + table[..., idx.long()]
    return out


GATHER_MAXJ = 32  # terms per gather_sum launch (gather_sum.cu MAXJ)


def gather_sum(
    base: torch.Tensor, tables: list[torch.Tensor], idxs: list[torch.Tensor]
) -> torch.Tensor:
    """K8c: (N,) ``base[n] + sum_j tables[j][idxs[j][n]]`` (CUDA kernel
    ``gather_sum``). ``base`` (N,) f32; ``tables[j]`` (size_j,) f32;
    ``idxs[j]`` (N,) int32 in [0, size_j) (the plain version raises on an
    index out of range, the kernel cannot). With ``base`` (G, N) and
    ``tables[j]`` (G, size_j), K8c-g: (G, N), each row's sums (CUDA kernel
    ``gather_sum_grid``, counted apart)."""
    kernel = "gather_sum_grid" if base.dim() == 2 else "gather_sum"
    if on_cpu(kernel, base, *tables, *idxs):
        return gather_sum_reference(base, tables, idxs)
    if base.dim() == 2:
        return _gather_sum_grid(base, tables, idxs)
    import ctypes

    dev = base.device
    n = base.shape[0]
    check_operand("gather_sum", "base", base, torch.float32, (n,), dev)
    for j, (table, idx) in enumerate(zip(tables, idxs)):
        check_operand("gather_sum", f"tables[{j}]", table, torch.float32, (table.shape[0],), dev)
        check_operand("gather_sum", f"idxs[{j}]", idx, torch.int32, (n,), dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    src = base
    for j0 in range(0, max(len(tables), 1), GATHER_MAXJ):
        chunk = range(j0, min(j0 + GATHER_MAXJ, len(tables)))
        t_ptrs = (ctypes.c_void_p * max(len(chunk), 1))(*(tables[j].data_ptr() for j in chunk))
        i_ptrs = (ctypes.c_void_p * max(len(chunk), 1))(*(idxs[j].data_ptr() for j in chunk))
        call("gather_sum", dev, src.data_ptr(), ctypes.addressof(t_ptrs), ctypes.addressof(i_ptrs),
             len(chunk), n, out.data_ptr())
        src = out
    return out


def _gather_sum_grid(base, tables, idxs) -> torch.Tensor:
    import ctypes

    dev = base.device
    g, n = base.shape
    check_operand("gather_sum_grid", "base", base, torch.float32, (g, n), dev)
    if g < 1:
        raise ValueError("gather_sum_grid: base needs at least one grid row")
    for j, (table, idx) in enumerate(zip(tables, idxs)):
        check_operand("gather_sum_grid", f"tables[{j}]", table, torch.float32, (g, table.shape[-1]), dev)
        check_operand("gather_sum_grid", f"idxs[{j}]", idx, torch.int32, (n,), dev)
    out = torch.empty((g, n), dtype=torch.float32, device=dev)
    src = base
    for j0 in range(0, max(len(tables), 1), GATHER_MAXJ):
        chunk = range(j0, min(j0 + GATHER_MAXJ, len(tables)))
        width = max(len(chunk), 1)
        t_ptrs = (ctypes.c_void_p * width)(*(tables[j].data_ptr() for j in chunk))
        i_ptrs = (ctypes.c_void_p * width)(*(idxs[j].data_ptr() for j in chunk))
        sizes = (ctypes.c_longlong * width)(*(tables[j].shape[-1] for j in chunk))
        call("gather_sum_grid", dev, src.data_ptr(), ctypes.addressof(t_ptrs), ctypes.addressof(i_ptrs),
             ctypes.addressof(sizes), len(chunk), n, g, out.data_ptr())
        src = out
    return out


class _GatherSum(torch.autograd.Function):
    """K8c with its backward: the gradient wrt ``base`` is ``g``, and wrt
    table j it is K8 (``val`` null) over ``orders[j]``, the rows sorted by
    ``idxs[j]``, with ``indptrs[j]`` spanning table j: a segment sum per
    table entry, no atomics. A table whose layout the batch does not carry
    (a ``cat:`` field of a batch built without ``grad_layout``) gets it
    sorted on its device when its gradient is first needed. On the grid
    (base (G, N), tables (G, size_j)) the forward is K8c-g and each table's
    gradient K8g over the (G, N) cotangent."""

    @staticmethod
    def forward(ctx, base, layout, *tables):
        idxs, orders, indptrs = layout
        ctx.layout = (idxs, orders, indptrs, [t.shape[-1] for t in tables])
        return gather_sum(base.contiguous(), [t.contiguous() for t in tables], idxs)

    @staticmethod
    def backward(ctx, g):
        idxs, orders, indptrs, sizes = ctx.layout
        g = g.contiguous()
        grads = []
        for j, need in enumerate(ctx.needs_input_grad[2:]):
            if not need:
                grads.append(None)
                continue
            order, indptr = orders[j], indptrs[j]
            if order is None:
                order, indptr = _sorted_layout(idxs[j], sizes[j])
            grads.append(segment_dot(g, order, None, indptr))
        return (g if ctx.needs_input_grad[0] else None), None, *grads


def _sorted_layout(idx: torch.Tensor, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``_rep_layout`` on the device: the rows sorted (stably) by ``idx`` and
    the (size + 1,) indptr of each value's run."""
    key = idx.long()
    order = torch.argsort(key, stable=True).to(torch.int32)
    indptr = torch.zeros(size + 1, dtype=torch.int32, device=idx.device)
    indptr[1:] = torch.cumsum(torch.bincount(key, minlength=size), 0)
    return order, indptr


def _bag_term(w, r_vocab, r_val, r_indptr, v_rows, v_val, v_indptr) -> torch.Tensor:
    return _BagTerm.apply(w, r_vocab, r_val, r_indptr, v_rows, v_val, v_indptr)


def block_logits(
    params: Params,
    scales: Params,
    batch: dict[str, torch.Tensor],
    center: torch.Tensor | None = None,
) -> torch.Tensor:
    """(N,) logits; ``params`` are standardized-space coefficients and
    ``scales`` the per-feature 1/std factors (all-ones for raw space).
    Parameters with a leading grid axis (``bias`` (G,), every other leaf
    (G, size)) give (G, N) logits, row g those of model g.
    ``center`` (optional) is subtracted from the dense block before scaling.
    The terms (:func:`logit_terms`) are summed by K8c in one pass
    (:class:`_GatherSum`)."""
    base, tables, idxs, orders, indptrs = logit_terms(params, scales, batch, center)
    return _GatherSum.apply(base, (idxs, orders, indptrs), *tables)


def logit_terms(
    params: Params,
    scales: Params,
    batch: dict[str, torch.Tensor],
    center: torch.Tensor | None = None,
) -> tuple[torch.Tensor, list, list, list, list]:
    """``(base, tables, idxs, orders, indptrs)``: the logits before their
    gathers, and each gather term's table, row indices and backward layout
    (None where the batch carries none).

    The logical dense block is [scalars | vec fields in sorted order]; each
    vec field's term is computed per DISTINCT vector and each bag field's
    through ``_bag_term``. The bias, the dense product and the bag terms of
    unfactored bag fields form the base; the gather terms are the vec
    fields' rep expansions, then, in batch order, each ``cat:`` field's
    weights and each factored bag field's rep expansion. On the grid every
    term gains the leading G axis; the dense products are (N, D) @ (D, G)."""
    grid = params["bias"].dim() == 1
    w_dense = params["dense"] * scales["dense"]
    d_scalar = batch["dense"].shape[1]
    dense = batch["dense"] if center is None else batch["dense"] - center[:d_scalar]
    if grid:
        base = params["bias"][:, None] + (dense @ w_dense[:, :d_scalar].T).T
    else:
        base = params["bias"] + dense @ w_dense[:d_scalar]
    tables: list[torch.Tensor] = []
    idxs: list[torch.Tensor] = []
    orders: list[torch.Tensor | None] = []
    indptrs: list[torch.Tensor | None] = []

    def gather(table, idx, order, indptr) -> None:
        tables.append(table)
        idxs.append(idx)
        orders.append(order)
        indptrs.append(indptr)

    off = d_scalar
    vec_fields = sorted(
        key[len("vecflat:"):-len(":vec")]
        for key in batch
        if key.startswith("vecflat:") and key.endswith(":vec")
    )
    for f in vec_fields:
        arr = batch[f"vecflat:{f}:vec"]
        d = arr.shape[1]
        w_f = w_dense[..., off:off + d]
        # Center BEFORE the contraction (no cancellation of two large
        # near-equal dots per distinct vector).
        vals = arr if center is None else arr - center[off:off + d]
        p = f"vecflat:{f}:"
        term = (vals @ w_f.T).T if grid else vals @ w_f
        gather(term, batch[p + "rep"], batch[p + "order"], batch[p + "indptr"])
        off += d
    for key, arr in batch.items():
        if key.startswith("cat:"):
            f = key[len("cat:"):]
            g = f"catgrad:{f}:"
            gather(params[f"cat:{f}"] * scales[f"cat:{f}"], arr, batch.get(g + "order"),
                   batch.get(g + "indptr"))
        elif key.startswith("bagflat:") and key.endswith(":r_vocab"):
            f = key[len("bagflat:"):-len(":r_vocab")]
            w = params[f"bag:{f}"] * scales[f"bag:{f}"]
            p = f"bagflat:{f}:"
            term = _bag_term(
                w,
                batch[p + "r_vocab"], batch[p + "r_val"], batch[p + "r_indptr"],
                batch[p + "v_rows"], batch[p + "v_val"], batch[p + "v_indptr"],
            )
            rp = f"bagrep:{f}:"
            if rp + "rep" in batch:
                gather(term, batch[rp + "rep"], batch[rp + "order"], batch[rp + "indptr"])
            else:
                base = base + term
    return base, tables, idxs, orders, indptrs


def weighted_logloss(
    params: Params,
    scales: Params,
    batch: dict[str, torch.Tensor],
    labels: torch.Tensor,
    weights: torch.Tensor,
    reg: float,
    center: torch.Tensor | None = None,
) -> torch.Tensor:
    """MLlib objective: (sum_i w_i * ce_i) / sum_i w_i + 0.5 * reg * ||beta_std||^2
    (bias unpenalized). On the grid (parameters with a leading G axis,
    ``weights`` (G, N)): the (G,) losses, row g the objective of model g
    under weight row g."""
    logits = block_logits(params, scales, batch, center=center)
    # Pre-clip to a finite range so the straight-through correction below
    # can never be inf - inf; 1e6 is exact in float32.
    logits = logits.clamp(-1e6, 1e6)
    # Straight-through clip: the CE value is capped at |logit| 35 while the
    # gradient of badly misclassified samples stays alive.
    logits = logits + (logits.clamp(-35.0, 35.0) - logits).detach()
    # The first iterate has every logit exactly 0, where the JAX program's
    # gradient follows jnp.maximum (0.5 at a tie, as torch.maximum) and
    # jnp.abs (slope +1 at 0, where torch's abs has 0): the where() below
    # has JAX's slope, so the two solvers start from the same gradient.
    abs_logits = torch.where(logits >= 0, logits, -logits)
    ce = torch.maximum(logits, torch.zeros_like(logits)) - logits * labels + torch.log1p(torch.exp(-abs_logits))
    if params["bias"].dim() == 1:
        data = torch.sum(weights * ce, dim=1) / torch.sum(weights, dim=1)
        pen = sum(torch.sum(v**2, dim=1) for k, v in params.items() if k != "bias")
    else:
        data = torch.sum(weights * ce) / torch.sum(weights)
        pen = sum(torch.sum(v**2) for k, v in params.items() if k != "bias")
    return data + 0.5 * reg * pen


def fold_scales(params: Params, scales: Params) -> Params:
    """Standardized-space coefficients to raw space (beta = beta_std / std)."""
    return {k: params[k] * scales[k] for k in params}
