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

The fits evaluate the objective on their flat parameter vector with
:class:`LogisticObjective`: the same terms, K8 and K8c launched as often as
under autograd, the elementwise loss and its reductions in the ``logloss``
kernel (:func:`logloss`), and each gradient written into its slice of one
buffer; :func:`weighted_logloss` (autograd) stays the plain version of the
whole objective, and scoring (:func:`block_logits`) is unchanged.

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
    x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor | None, indptr: torch.Tensor,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """K8: (S,) CSR segment sums of ``x[idx] * val`` over ``indptr`` (S + 1,)
    (CUDA kernel ``segment_dot``). ``x`` (n,) f32; ``idx`` (nnz,) int32 in
    [0, n); ``val`` (nnz,) f32 or None for ones; ``indptr`` int32,
    nondecreasing, ``indptr[0] == 0``, ``indptr[-1] == nnz``. With ``x``
    (G, n), K8g: (G, S), the sums of each row (CUDA kernel
    ``segment_dot_grid``, counted apart). ``out``, if given, is the
    contiguous f32 tensor of the result's shape the sums are written to (a
    slice of a larger buffer), and is returned. On the card the kernel
    splits the work by a merge path over segment ends and entries, not by
    segments, and passes its carries between CTAs through a workspace kept
    per device and stream; one launch is counted a call."""
    if not _kernel_layout(x, idx, val, indptr):
        operands = [x, idx, indptr] + ([] if val is None else [val])
        if on_cpu("segment_dot_grid" if x.dim() == 2 else "segment_dot", *operands):
            sums = segment_dot_reference(x, idx, val, indptr)
            return sums if out is None else out.copy_(sums)
        _raise_on_layout(x, idx, val, indptr)
    dev = x.device
    nnz = idx.shape[0]
    n_seg = indptr.shape[0] - 1
    ws, cap = _segment_dot_workspace(n_seg, nnz, dev)
    val_ptr = None if val is None else val.data_ptr()
    shape = (x.shape[0], n_seg) if x.dim() == 2 else (n_seg,)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    else:
        check_operand("segment_dot_grid" if x.dim() == 2 else "segment_dot", "out", out, torch.float32, shape, dev)
    if x.dim() == 2:
        g, n_x = x.shape
        call("segment_dot_grid", dev, x.data_ptr(), n_x, idx.data_ptr(), val_ptr, indptr.data_ptr(), out.data_ptr(),
             n_seg, g, nnz, ws.data_ptr(), cap)
    else:
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


def logit_layout(batch: dict[str, torch.Tensor]) -> tuple[int, list[tuple[str, str, tuple]]]:
    """The logits' terms in a feature batch, in the order they are summed:
    ``(d_scalar, terms)``, the dense block's scalar columns and each term as
    ``(kind, leaf, part)``. First each vec field ``f`` (sorted), ``("vec",
    "vec:f", (col, d, vec, rep, order, indptr))``: its ``d`` columns from
    ``col`` of the dense leaf, its distinct vectors and their rep expansion;
    then, in batch order, each ``cat:`` field ``("cat", "cat:f", (idx,
    order, indptr))`` (the backward layout None where the batch carries none)
    and each bag field ``("bag", "bag:f", (r, v, rep))``: ``r`` =
    (r_vocab, r_val, r_indptr) and ``v`` = (v_rows, v_val, v_indptr) its
    forward and backward layouts, ``rep`` (rep, order, indptr) its rep
    expansion, or None for an unfactored bag, whose term joins the base."""
    d_scalar = batch["dense"].shape[1]
    terms: list[tuple[str, str, tuple]] = []
    col = d_scalar
    for f in sorted(key[len("vecflat:"):-len(":vec")] for key in batch
                    if key.startswith("vecflat:") and key.endswith(":vec")):
        arr, p = batch[f"vecflat:{f}:vec"], f"vecflat:{f}:"
        terms.append(("vec", f"vec:{f}", (col, arr.shape[1], arr, batch[p + "rep"], batch[p + "order"],
                                          batch[p + "indptr"])))
        col += arr.shape[1]
    for key, arr in batch.items():
        if key.startswith("cat:"):
            g = f"catgrad:{key[len('cat:'):]}:"
            terms.append(("cat", key, (arr, batch.get(g + "order"), batch.get(g + "indptr"))))
        elif key.startswith("bagflat:") and key.endswith(":r_vocab"):
            f = key[len("bagflat:"):-len(":r_vocab")]
            p, rp = f"bagflat:{f}:", f"bagrep:{f}:"
            rep = (batch[rp + "rep"], batch[rp + "order"], batch[rp + "indptr"]) if rp + "rep" in batch else None
            terms.append(("bag", f"bag:{f}", (tuple(batch[p + k] for k in ("r_vocab", "r_val", "r_indptr")),
                                               tuple(batch[p + k] for k in ("v_rows", "v_val", "v_indptr")), rep)))
    return d_scalar, terms


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
    unfactored bag fields form the base; the gather terms follow
    :func:`logit_layout`'s order. On the grid every term gains the leading
    G axis; the dense products are (N, D) @ (D, G)."""
    grid = params["bias"].dim() == 1
    w_dense = params["dense"] * scales["dense"]
    d_scalar, layout = logit_layout(batch)
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

    for kind, leaf, part in layout:
        if kind == "vec":
            col, d, arr, rep, order, indptr = part
            w_f = w_dense[..., col:col + d]
            # Center BEFORE the contraction (no cancellation of two large
            # near-equal dots per distinct vector).
            vals = arr if center is None else arr - center[col:col + d]
            gather((vals @ w_f.T).T if grid else vals @ w_f, rep, order, indptr)
        elif kind == "cat":
            gather(params[leaf] * scales[leaf], *part)
        else:
            r, v, rep = part
            term = _bag_term(params[leaf] * scales[leaf], *r, *v)
            if rep is None:
                base = base + term
            else:
                gather(term, *rep)
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


# ------------------------------------------------- the objective's kernel (K19)

PRE_CLIP = 1e6  # logloss.cu's clips
CE_CLIP = 35.0
LOGLOSS_CHUNK = 256 * 8  # logloss.cu's rows (and parameters) a CTA: THREADS x ITEMS


def logloss_ctas(n: int, p: int) -> int:
    """``logloss.cu``'s CTAs a grid row: a chunk of rows and of parameters each."""
    return max(-(-n // LOGLOSS_CHUNK), -(-p // LOGLOSS_CHUNK), 1)


def logloss_reference(
    z: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor, wsum: torch.Tensor, theta: torch.Tensor,
    reg: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of :func:`logloss`: the objective's per-row arithmetic
    in torch, the sums by ``torch.sum``. Returns ``(loss, dz, bias, pen)``."""
    reg32, half32 = float(np.float32(reg)), float(np.float32(0.5 * reg))
    wsum = wsum.reshape(z.shape[:-1])
    inside = (z >= -PRE_CLIP) & (z <= PRE_CLIP)
    z1 = z.clamp(-PRE_CLIP, PRE_CLIP)
    z2 = z1 + (z1.clamp(-CE_CLIP, CE_CLIP) - z1)  # the straight-through clip's value
    e = torch.exp(-torch.where(z2 >= 0, z2, -z2))
    ce = torch.maximum(z2, torch.zeros_like(z2)) - z2 * labels + torch.log1p(e)
    # The slopes of max(z, 0) (0.5 at a tie) and |z| (+1 at 0), as JAX's.
    dm = torch.where(z2 > 0, 1.0, torch.where(z2 == 0, 0.5, 0.0))
    sign = torch.where(z2 >= 0, 1.0, -1.0)
    dce = (dm - labels) - sign * (e / (1.0 + e))
    inv = (1.0 / wsum)[..., None]
    dz = torch.where(inside, (inv * weights) * dce, torch.zeros_like(z))
    data = torch.sum(weights * ce, dim=-1) / wsum
    rest = theta[..., 1:]
    loss = data + half32 * torch.sum(rest * rest, dim=-1)
    pen = theta * reg32
    pen[..., 0] = 0.0
    return loss, dz, torch.sum(dz, dim=-1), pen


# One workspace per (device, stream), grown as calls need: a ticket a grid
# row, 0 between launches (each launch's last CTAs reset theirs), and the
# CTAs' partials.
_LOGLOSS_WORKSPACE: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _logloss_workspace(g: int, nb: int, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    key = (dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    ws = _LOGLOSS_WORKSPACE.get(key)
    if ws is None or ws[0].numel() < g or ws[1].numel() < 3 * g * nb:
        with _K8_WORKSPACE_LOCK:
            ws = _LOGLOSS_WORKSPACE.get(key)
            if ws is None or ws[0].numel() < g or ws[1].numel() < 3 * g * nb:
                tickets = ws[0] if ws is not None and ws[0].numel() >= g else torch.zeros(
                    max(g, 64), dtype=torch.int32, device=dev)
                partials = ws[1] if ws is not None and ws[1].numel() >= 3 * g * nb else torch.empty(
                    max(3 * g * nb, 2 * (0 if ws is None else ws[1].numel())), dtype=torch.float32, device=dev)
                ws = _LOGLOSS_WORKSPACE[key] = (tickets, partials)
    return ws


def logloss(
    z: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor, wsum: torch.Tensor, theta: torch.Tensor,
    reg: float, bias: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The LR objective at its logits and its gradient wrt them (CUDA kernel
    ``logloss``, one launch): for (N,) logits ``z`` (or (G, N), a row a
    model), (N,) ``labels``, ``weights`` shaped as ``z``, their sums
    ``wsum`` ((G,), once a fit) and the flat parameters ``theta`` ((P,) or
    (G, P), bias first), returns ``(loss, dz, bias, pen)``: the values
    ``sum(w ce) / sum(w) + 0.5 reg sum_{k>0} theta_k^2`` (0-d, or (G,)),
    the logits' cotangent ``w ce' / sum(w)``, the bias gradient ``sum(dz)``
    (shaped as the values; written into ``bias`` where given, a contiguous
    (G,) slice of a gradient buffer) and
    ``reg theta`` with 0 in the bias slot. ``ce`` is ``weighted_logloss``'s
    (clipped at +-1e6, then straight-through at +-35) and ``ce'`` its
    gradient rule; a zero weight row gives NaN, as there."""
    if on_cpu("logloss", z, labels, weights, wsum, theta):
        loss, dz, bsum, pen = logloss_reference(z, labels, weights, wsum, theta, reg)
        if bias is not None:
            bsum = bias.copy_(bsum.reshape(bias.shape)).reshape(bsum.shape)
        return loss, dz, bsum, pen
    dev = z.device
    g = 1 if z.dim() == 1 else z.shape[0]
    n, p = z.shape[-1], theta.shape[-1]
    check_operand("logloss", "z", z, torch.float32, (n,) if z.dim() == 1 else (g, n), dev)
    check_operand("logloss", "labels", labels, torch.float32, (n,), dev)
    check_operand("logloss", "weights", weights, torch.float32, tuple(z.shape), dev)
    check_operand("logloss", "wsum", wsum, torch.float32, (g,), dev)
    check_operand("logloss", "theta", theta, torch.float32, (p,) if z.dim() == 1 else (g, p), dev)
    if bias is None:
        bias = torch.empty(g, dtype=torch.float32, device=dev)
    check_operand("logloss", "bias", bias, torch.float32, (g,), dev)
    nb = logloss_ctas(n, p)
    tickets, partials = _logloss_workspace(g, nb, dev)
    loss = torch.empty(g, dtype=torch.float32, device=dev)
    dz, pen = torch.empty_like(z), torch.empty_like(theta)
    call("logloss", dev, z.data_ptr(), labels.data_ptr(), weights.data_ptr(), wsum.data_ptr(), theta.data_ptr(), g, n,
         p, float(np.float32(reg)), float(np.float32(0.5 * reg)), loss.data_ptr(), dz.data_ptr(), bias.data_ptr(),
         pen.data_ptr(), partials.data_ptr(), tickets.data_ptr(), nb)
    return loss.reshape(z.shape[:-1]), dz, bias.reshape(z.shape[:-1]), pen


class LogisticObjective:
    """``weighted_logloss`` and its gradient on the flat parameter vector
    (bias first, then each leaf in the params' order; a (G, P) matrix, a row
    a model, on the CV grid), without autograd: the fits' objective.

    Built once a fit, from a batch made with ``feature_batch(...,
    grad_layout=True)``: the centered dense block and Word2Vec tables, the
    weights' sums, the flat scales, each term's backward layout. An
    evaluation, :meth:`value_and_grad`, is one ``theta * scales``, the dense
    and Word2Vec products (``torch.matmul``, as JAX leaves them to XLA), the
    bag terms' K8, K8c over the gather terms, the ``logloss`` kernel, each
    gather table's and bag's gradient by K8 (K8g on the grid) straight into
    its slice of a raw gradient buffer, the transposed products into the
    ``dense`` slice, and one fold ``grad = raw * scales + pen``: K8, K8g,
    K8c and K8c-g launch as often as under autograd (:meth:`value`, the
    objective alone, as often as its forward). No host sync and no
    allocation whose size depends on a device value, so it captures into a
    CUDA graph. On the grid the scaled parameters and the raw gradient are
    kept leaf-major (each leaf a contiguous (G, size) block, as K8g and
    K8c-g read and write them; one gather in, one out); for G = 1 that is the
    flat order. On the CPU the same function runs the plain pieces."""

    def __init__(self, sizes: dict[str, int], scales: dict[str, np.ndarray], batch: dict[str, torch.Tensor],
                 labels: torch.Tensor, weights: torch.Tensor, reg: float, center: torch.Tensor | None = None):
        dev = labels.device
        self.grid = weights.dim() == 2
        self.rows = weights.shape[0] if self.grid else 1
        self.labels, self.weights, self.reg = labels, weights, float(reg)
        self.wsum = torch.sum(weights, dim=-1).reshape(self.rows)
        offsets, off = {}, 0
        for k, n in sizes.items():
            offsets[k] = off
            off += n
        self.size = off
        d_scalar, layout = logit_layout(batch)
        dense = batch["dense"] if center is None else batch["dense"] - center[:d_scalar]
        self.dense = dense.contiguous()
        # Blocks in theta's order: the dense leaf's scalar columns, then each
        # vec field's columns, then every other leaf.
        self.blocks = {"bias": (0, 1), "dense": (offsets["dense"], d_scalar)}
        self.vec: list[tuple[str, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]] = []
        self.terms: list[tuple[str, str, tuple]] = []  # the cat and bag terms, as logit_layout gives them
        for kind, leaf, part in layout:
            if kind == "vec":
                col, d, arr, rep, order, indptr = part
                vals = arr if center is None else arr - center[col:col + d]
                self.blocks[leaf] = (offsets["dense"] + col, d)
                self.vec.append((leaf, vals.contiguous(), rep, order, indptr))
                continue
            if kind == "cat" and part[1] is None:
                raise ValueError("LogisticObjective: the batch needs feature_batch(..., grad_layout=True)")
            self.blocks[leaf] = (offsets[leaf], sizes[leaf])
            self.terms.append((kind, leaf, part))
        flat = np.ones(self.size, np.float32)
        for k, o in offsets.items():
            flat[o:o + sizes[k]] = np.asarray(scales[k], np.float32).reshape(-1)
        self.scales = torch.as_tensor(flat).to(dev)
        if self.grid:
            g, size = self.rows, self.size
            lm = np.concatenate([(np.arange(g)[:, None] * size + o + np.arange(n)[None, :]).reshape(-1)
                                 for o, n in sorted(self.blocks.values())])
            inv = np.empty_like(lm)
            inv[lm] = np.arange(lm.size)
            self.lm_index = torch.as_tensor(lm).to(dev)
            self.inv_index = torch.as_tensor(inv).to(dev)
            self.scales_lm = torch.as_tensor(flat[lm % size]).to(dev)
        if sum(n for _, n in self.blocks.values()) != self.size:
            raise ValueError("LogisticObjective: the batch's fields do not cover the parameters")

    def _block(self, buf: torch.Tensor, name: str) -> torch.Tensor:
        """Leaf block ``name`` of a leaf-major buffer: (size,), or (G, size)."""
        off, n = self.blocks[name]
        if not self.grid:
            return buf[off:off + n]
        return buf[self.rows * off:self.rows * (off + n)].view(self.rows, n)

    def value(self, theta: torch.Tensor) -> torch.Tensor:
        """The objective at ``theta`` alone (the forward's launches and
        ``logloss``): 0-d for a (P,) ``theta``, (G,) for (G, P)."""
        return logloss(self._logits(theta), self.labels, self.weights, self.wsum, theta, self.reg)[0]

    def value_and_grad(self, theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The objective at ``theta`` ((P,): a 0-d value; (G, P): (G,)
        values) and its (P,) or (G, P) gradient."""
        grid, g = self.grid, self.rows
        z = self._logits(theta)
        raw = torch.empty(g * self.size, dtype=torch.float32, device=theta.device)
        loss, dz, _, pen = logloss(z, self.labels, self.weights, self.wsum, theta, self.reg,
                                   bias=self._block(raw, "bias").reshape(g))
        for name, vals, _, order, indptr in self.vec:
            d_term = segment_dot(dz, order, None, indptr)
            if grid:
                torch.mm(d_term, vals, out=self._block(raw, name))
            else:
                torch.mv(vals.T, d_term, out=self._block(raw, name))
        for kind, name, part in self.terms:
            if kind == "cat":
                segment_dot(dz, part[1], None, part[2], out=self._block(raw, name))
                continue
            _, v, rep = part
            d_doc = dz if rep is None else segment_dot(dz, rep[1], None, rep[2])
            segment_dot(d_doc, *v, out=self._block(raw, name))
        if grid:
            torch.mm(dz, self.dense, out=self._block(raw, "dense"))
            grad = torch.addcmul(pen, torch.take(raw, self.inv_index).view(g, self.size), self.scales)
        else:
            torch.mv(self.dense.T, dz, out=self._block(raw, "dense"))
            grad = torch.addcmul(pen, raw, self.scales)
        return loss, grad

    def _logits(self, theta: torch.Tensor) -> torch.Tensor:
        """The (N,) or (G, N) logits at ``theta``."""
        grid = self.grid
        ws = torch.take(theta, self.lm_index) * self.scales_lm if grid else theta * self.scales
        w_dense = self._block(ws, "dense")
        if grid:
            base = torch.addmm(self._block(ws, "bias"), w_dense, self.dense.T)
        else:
            base = torch.addmv(self._block(ws, "bias"), self.dense, w_dense)
        tables, idxs = [], []
        for name, vals, rep, _, _ in self.vec:
            w_f = self._block(ws, name)
            tables.append(torch.mm(w_f, vals.T) if grid else torch.mv(vals, w_f))
            idxs.append(rep)
        for kind, name, part in self.terms:
            if kind == "cat":
                tables.append(self._block(ws, name))
                idxs.append(part[0])
                continue
            r, _, rep = part
            term = segment_dot(self._block(ws, name), *r)
            if rep is None:
                base = base + term
            else:
                tables.append(term)
                idxs.append(rep[0])
        return gather_sum(base, tables, idxs)


def fold_scales(params: Params, scales: Params) -> Params:
    """Standardized-space coefficients to raw space (beta = beta_std / std)."""
    return {k: params[k] * scales[k] for k in params}
