"""Block-sparse linear model over a ``FeatureMatrix`` (PyTorch + CUDA).

Port of ``albedo_tpu/ops/sparse_linear.py``. The ranker's logistic
regression reads its features as blocks (``features/assembler.py``):

``logit = b + dense @ w_dense + sum_f W_cat[f][idx_f] + sum_f <bag_val, W_bag[f][bag_idx]>``

which is the one-hot dot product computed as weight-row gathers and segment
sums. K8 :func:`segment_dot` runs the CUDA kernel ``segment_dot``: the CSR
segmented gather-multiply-sum behind the bag-field logits (forward over the
row-sorted flats, backward over the vocab-sorted copy) and the backward of
the factored rep expansion. :class:`_BagTerm` and :class:`_RepTerm` are the
JAX module's two custom VJPs as ``torch.autograd.Function``s. The JAX module
reduces by cumsum differences (a TPU workaround); the port sums each segment
directly, which computes the same function with less round-off, so the two
agree to a tolerance, not bit for bit.

Standardization (Spark ``setStandardization(true)``): features are scaled by
``1/std`` (no centering of the sparse blocks, as MLlib); the L2 penalty
applies to the scaled coefficients; ``fold_scales`` converts back to raw
space. Not ported: the padded ``bag_idx:`` layout of the mesh path
(``parallel/lr.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from albedo_tpu_torch.features.assembler import FeatureMatrix
from albedo_tpu_torch.kernels.build import call, check_operand, on_cpu

Params = dict[str, torch.Tensor]


def feature_batch(fm: FeatureMatrix, device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """A FeatureMatrix's arrays on ``device`` as a flat dict of tensors.

    Bag fields are laid out DUAL-SORTED: a row-sorted copy (+ row indptr) for
    the forward segment sums and a vocab-sorted copy (+ vocab indptr spanning
    the whole weight table) for the weight gradient, so both directions are
    K8 over the real entries only. Vector fields upload factored: the (U, D)
    distinct vectors, the (N,) rep gather, and a rep-sorted order + indptr
    whose segment sums are the gather's backward (``_rep_term``). Factored
    bag fields carry the same rep layout (``bagrep:``)."""
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
    """The ``_rep_term`` input layout for a (N,) rep vector: ``(rep int32,
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
    segment id; empty segments give 0."""
    n_seg = indptr.shape[0] - 1
    counts = (indptr[1:] - indptr[:-1]).long()
    seg = torch.repeat_interleave(torch.arange(n_seg, device=x.device), counts)
    terms = x[idx.long()]
    if val is not None:
        terms = terms * val
    return torch.zeros(n_seg, dtype=x.dtype, device=x.device).index_add_(0, seg, terms)


def segment_dot(
    x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor | None, indptr: torch.Tensor
) -> torch.Tensor:
    """K8: (S,) CSR segment sums of ``x[idx] * val`` over ``indptr`` (S + 1,)
    (CUDA kernel ``segment_dot``). ``x`` (n,) f32; ``idx`` (nnz,) int32 in
    [0, n); ``val`` (nnz,) f32 or None for ones; ``indptr`` int32,
    nondecreasing, ``indptr[-1] == nnz``."""
    operands = [x, idx, indptr] + ([] if val is None else [val])
    if on_cpu("segment_dot", *operands):
        return segment_dot_reference(x, idx, val, indptr)
    dev = x.device
    nnz = idx.shape[0]
    n_seg = indptr.shape[0] - 1
    check_operand("segment_dot", "x", x, torch.float32, (x.shape[0],), dev)
    check_operand("segment_dot", "idx", idx, torch.int32, (nnz,), dev)
    check_operand("segment_dot", "indptr", indptr, torch.int32, (n_seg + 1,), dev)
    if val is not None:
        check_operand("segment_dot", "val", val, torch.float32, (nnz,), dev)
    out = torch.empty(n_seg, dtype=torch.float32, device=dev)
    call("segment_dot", dev, x.data_ptr(), idx.data_ptr(),
         None if val is None else val.data_ptr(), indptr.data_ptr(), out.data_ptr(), n_seg)
    return out


class _BagTerm(torch.autograd.Function):
    """Per-row bag logit contribution: forward K8 over the row-sorted flats,
    backward (wrt ``w``) K8 over the vocab-sorted copy."""

    @staticmethod
    def forward(ctx, w, r_vocab, r_val, r_indptr, v_rows, v_val, v_indptr):
        ctx.save_for_backward(v_rows, v_val, v_indptr)
        return segment_dot(w.contiguous(), r_vocab, r_val, r_indptr)

    @staticmethod
    def backward(ctx, g):
        v_rows, v_val, v_indptr = ctx.saved_tensors
        return segment_dot(g.contiguous(), v_rows, v_val, v_indptr), None, None, None, None, None, None


class _RepTerm(torch.autograd.Function):
    """Per-distinct values expanded to rows: forward the gather ``lu[rep]``,
    backward (wrt ``lu``) K8 with ``val`` null over the rep-sorted order."""

    @staticmethod
    def forward(ctx, lu, rep, order, indptr):
        ctx.save_for_backward(order, indptr)
        return lu[rep.long()]

    @staticmethod
    def backward(ctx, g):
        order, indptr = ctx.saved_tensors
        return segment_dot(g.contiguous(), order, None, indptr), None, None, None


def _bag_term(w, r_vocab, r_val, r_indptr, v_rows, v_val, v_indptr) -> torch.Tensor:
    return _BagTerm.apply(w, r_vocab, r_val, r_indptr, v_rows, v_val, v_indptr)


def _rep_term(lu, rep, order, indptr) -> torch.Tensor:
    return _RepTerm.apply(lu, rep, order, indptr)


def block_logits(
    params: Params,
    scales: Params,
    batch: dict[str, torch.Tensor],
    center: torch.Tensor | None = None,
) -> torch.Tensor:
    """(N,) logits; ``params`` are standardized-space coefficients and
    ``scales`` the per-feature 1/std factors (all-ones for raw space).
    ``center`` (optional) is subtracted from the dense block before scaling.

    The logical dense block is [scalars | vec fields in sorted order]; each
    vec field's term is computed per DISTINCT vector, then expanded by
    ``_rep_term``; bag fields go through ``_bag_term`` (and ``_rep_term``
    when factored)."""
    w_dense = params["dense"] * scales["dense"]
    d_scalar = batch["dense"].shape[1]
    dense = batch["dense"] if center is None else batch["dense"] - center[:d_scalar]
    logits = params["bias"] + dense @ w_dense[:d_scalar]
    off = d_scalar
    vec_fields = sorted(
        key[len("vecflat:"):-len(":vec")]
        for key in batch
        if key.startswith("vecflat:") and key.endswith(":vec")
    )
    for f in vec_fields:
        arr = batch[f"vecflat:{f}:vec"]
        d = arr.shape[1]
        w_f = w_dense[off:off + d]
        # Center BEFORE the contraction (no cancellation of two large
        # near-equal dots per distinct vector).
        vals = arr if center is None else arr - center[off:off + d]
        lu = vals @ w_f
        p = f"vecflat:{f}:"
        logits = logits + _rep_term(lu, batch[p + "rep"], batch[p + "order"], batch[p + "indptr"])
        off += d
    for key, arr in batch.items():
        if key.startswith("cat:"):
            f = key[len("cat:"):]
            w = params[f"cat:{f}"] * scales[f"cat:{f}"]
            logits = logits + w[arr.long()]
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
                term = _rep_term(term, batch[rp + "rep"], batch[rp + "order"], batch[rp + "indptr"])
            logits = logits + term
    return logits


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
    (bias unpenalized)."""
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
    data = torch.sum(weights * ce) / torch.sum(weights)
    pen = sum(torch.sum(v**2) for k, v in params.items() if k != "bias")
    return data + 0.5 * reg * pen


def fold_scales(params: Params, scales: Params) -> Params:
    """Standardized-space coefficients to raw space (beta = beta_std / std)."""
    return {k: params[k] * scales[k] for k in params}
