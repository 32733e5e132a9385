"""The Word2Vec training step: SGNS loss and gradients (K9, and K9s with a
shared negative pool) and the dense Adam update (PyTorch + CUDA).

Port of the device half of ``albedo_tpu/models/word2vec.py fit_corpus``
(``loss_fn`` :241, ``step`` :303, ``epoch`` :291).
K9 :func:`sgns_step` (per-pair negatives) runs the CUDA kernel ``sgns_step``: one warp per
(center, context) pair gathers the rows, forms the 1 + K logits and the
sigmoid cross-entropy gradient scalars, and adds the row gradients into
dense (V, d) tables with atomics (above d = 512 a wide path keeps no row in
registers, so any width runs). :func:`adam_dense` runs the CUDA kernel
``adam_dense``: ``optax.adam``'s update on every element of a table, fused
with zeroing the gradient for the next step. K9s :func:`sgns_shared_step`
(``shared_negatives = K > 0``: one (K,) pool of negatives for the whole
minibatch) runs the CUDA kernel ``sgns_shared``: K9's per-pair warp for the
positive term, then three tiled FP32 GEMMs with the row gathers fused in
for the (B, K) logits and their two backward products. The plain versions
(:func:`sgns_step_reference` and :func:`sgns_shared_step_reference`,
autograd over the JAX formulas, and :func:`adam_dense_reference`, optax's
formula in torch) run for CPU tensors and are what ``chip_smoke.py`` holds
the kernels against.

Duplicate rows in a batch (frequent words as centers and as negatives)
make the kernel's atomic sums run in an order that changes between runs,
so the kernel matches its plain version to float32 round-off, not bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from albedo_tpu_torch.kernels.build import call, check_operand, on_cpu

DMAX = 512  # widest embedding of K9's narrow path; wider ones take its wide path (sgns_step_wide)


def sgns_step_reference(
    in_t: torch.Tensor, out_t: torch.Tensor, centers: torch.Tensor, contexts: torch.Tensor,
    negs: torch.Tensor, grad_in: torch.Tensor, grad_out: torch.Tensor, loss_acc: torch.Tensor,
) -> None:
    """Plain version of K9: autograd over ``loss_fn`` of the JAX module —
    the (B, 1 + K) logits of each center against its context and negatives,
    binary cross-entropy summed over 1 + K and averaged over B — with the
    table gradients added into ``grad_in``/``grad_out`` and the loss into
    ``loss_acc`` (1,)."""
    with torch.enable_grad():
        vin = in_t.detach().requires_grad_(True)
        vout = out_t.detach().requires_grad_(True)
        vc = vin[centers.long()]
        rows = torch.cat([contexts.long()[:, None], negs.long()], dim=1)
        logits = torch.einsum("bd,bkd->bk", vc, vout[rows])
        labels = torch.zeros_like(logits)
        labels[:, 0] = 1.0
        loss = F.binary_cross_entropy_with_logits(logits, labels, reduction="none").sum(dim=1).mean()
        g_in, g_out = torch.autograd.grad(loss, (vin, vout))
    grad_in.add_(g_in)
    grad_out.add_(g_out)
    loss_acc.add_(loss.detach())


def sgns_grad_mass(
    in_t: torch.Tensor, out_t: torch.Tensor, centers: torch.Tensor, contexts: torch.Tensor,
    negs: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The L1 mass of each element of K9's gradient tables, (V, d) each: the
    sum, over the terms one minibatch adds into it, of their absolute
    values (``|g_k| |out[row_k]|`` into ``grad_in``, ``|g_k| |in[c]|`` into
    ``grad_out``). Float32 round-off in any order of those sums is a small
    multiple of it, so K9 is held against its plain version relative to it;
    an element no term reaches has mass 0 and stays exactly 0."""
    rows = torch.cat([contexts.long()[:, None], negs.long()], dim=1)
    vc = in_t[centers.long()]
    vo = out_t[rows]
    labels = torch.zeros(rows.shape, dtype=in_t.dtype, device=in_t.device)
    labels[:, 0] = 1.0
    g = ((torch.sigmoid(torch.einsum("bd,bkd->bk", vc, vo)) - labels) / rows.shape[0]).abs()
    mass_in = torch.zeros_like(in_t).index_add_(0, centers.long(), torch.einsum("bk,bkd->bd", g, vo.abs()))
    terms_out = (g[..., None] * vc.abs()[:, None, :]).reshape(-1, in_t.shape[1])
    return mass_in, torch.zeros_like(out_t).index_add_(0, rows.reshape(-1), terms_out)


def sgns_step(
    in_t: torch.Tensor, out_t: torch.Tensor, centers: torch.Tensor, contexts: torch.Tensor,
    negs: torch.Tensor, grad_in: torch.Tensor, grad_out: torch.Tensor, loss_acc: torch.Tensor,
) -> None:
    """K9: add one SGNS minibatch's table gradients into ``grad_in`` and
    ``grad_out`` (V, d) and its mean loss into ``loss_acc`` (1,) (CUDA
    kernel ``sgns_step``). ``centers``/``contexts`` (B,) and ``negs`` (B, K)
    are int32 row ids in [0, V)."""
    if on_cpu("sgns_step", in_t, out_t, centers, contexts, negs, grad_in, grad_out, loss_acc):
        sgns_step_reference(in_t, out_t, centers, contexts, negs, grad_in, grad_out, loss_acc)
        return
    v_size, d = in_t.shape
    b, k = negs.shape
    if d < 1:
        raise ValueError(f"sgns_step: the CUDA kernel takes dims >= 1, got {d}")
    dev = in_t.device
    for name, t, dtype, shape in (
        ("in_t", in_t, torch.float32, (v_size, d)), ("out_t", out_t, torch.float32, (v_size, d)),
        ("centers", centers, torch.int32, (b,)), ("contexts", contexts, torch.int32, (b,)),
        ("negs", negs, torch.int32, (b, k)), ("grad_in", grad_in, torch.float32, (v_size, d)),
        ("grad_out", grad_out, torch.float32, (v_size, d)), ("loss_acc", loss_acc, torch.float32, (1,)),
    ):
        check_operand("sgns_step", name, t, dtype, shape, dev)
    call("sgns_step", dev, in_t.data_ptr(), out_t.data_ptr(), centers.data_ptr(),
         contexts.data_ptr(), negs.data_ptr(), grad_in.data_ptr(), grad_out.data_ptr(),
         loss_acc.data_ptr(), b, d, k, count="sgns_step_wide" if d > DMAX else None)


def _bce(x: torch.Tensor, label: float) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(x, torch.full_like(x, label), reduction="none")


def sgns_shared_step_reference(
    in_t: torch.Tensor, out_t: torch.Tensor, centers: torch.Tensor, contexts: torch.Tensor,
    pool: torch.Tensor, grad_in: torch.Tensor, grad_out: torch.Tensor, loss_acc: torch.Tensor,
    neg_scale: float,
) -> None:
    """Plain version of K9s: autograd over the shared branch of the JAX
    ``loss_fn`` — the positive logit of each pair, the (B, K) logits of the
    centers against the pool, ``mean_b(BCE(pos, 1) + neg_scale * sum_k
    BCE(L, 0))`` — with the table gradients added into ``grad_in``/
    ``grad_out`` and the loss into ``loss_acc`` (1,)."""
    with torch.enable_grad():
        vin = in_t.detach().requires_grad_(True)
        vout = out_t.detach().requires_grad_(True)
        vc = vin[centers.long()]
        pos = torch.sum(vc * vout[contexts.long()], dim=1)
        neg = vc @ vout[pool.long()].T
        scale = torch.tensor(neg_scale, dtype=torch.float32, device=in_t.device)
        loss = (_bce(pos, 1.0) + _bce(neg, 0.0).sum(dim=1) * scale).mean()
        g_in, g_out = torch.autograd.grad(loss, (vin, vout))
    grad_in.add_(g_in)
    grad_out.add_(g_out)
    loss_acc.add_(loss.detach())


def sgns_shared_grad_mass(
    in_t: torch.Tensor, out_t: torch.Tensor, centers: torch.Tensor, contexts: torch.Tensor,
    pool: torch.Tensor, neg_scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The L1 mass of each element of K9s's gradient tables, (V, d) each, as
    :func:`sgns_grad_mass` for K9: the sum of the absolute values of the
    terms one minibatch adds into it (``|g_b| |out[o_b]| + sum_k |G_bk|
    |out[pool_k]|`` into ``grad_in[c_b]``; ``|g_b| |in[c_b]|`` into
    ``grad_out[o_b]`` and ``sum_b |G_bk| |in[c_b]|`` into
    ``grad_out[pool_k]``). K9s is held against its plain version relative to
    it; an element no term reaches has mass 0 and stays exactly 0."""
    b = centers.shape[0]
    vc = in_t[centers.long()]
    vo = out_t[contexts.long()]
    vn = out_t[pool.long()]
    g = ((torch.sigmoid(torch.sum(vc * vo, dim=1)) - 1.0) / b).abs()
    gn = torch.sigmoid(vc @ vn.T) * (neg_scale / b)
    mass_in = torch.zeros_like(in_t).index_add_(0, centers.long(), g[:, None] * vo.abs() + gn @ vn.abs())
    mass_out = torch.zeros_like(out_t).index_add_(0, contexts.long(), g[:, None] * vc.abs())
    return mass_in, mass_out.index_add_(0, pool.long(), gn.T @ vc.abs())


def sgns_shared_step(
    in_t: torch.Tensor, out_t: torch.Tensor, centers: torch.Tensor, contexts: torch.Tensor,
    pool: torch.Tensor, grad_in: torch.Tensor, grad_out: torch.Tensor, loss_acc: torch.Tensor,
    neg_scale: float, workspace: torch.Tensor | None = None,
) -> None:
    """K9s: add one shared-negative SGNS minibatch's table gradients into
    ``grad_in`` and ``grad_out`` (V, d) and its mean loss into ``loss_acc``
    (1,) (CUDA kernel ``sgns_shared``). ``centers``/``contexts`` (B,) and
    ``pool`` (K,) are int32 row ids in [0, V), the pool's may repeat;
    ``neg_scale`` is ``negatives / K``. ``workspace`` (B * K,) float32 holds
    the (B, K) logit gradients between the kernel's passes (allocated here
    when not given; a fit passes one, allocated once)."""
    if on_cpu("sgns_shared", in_t, out_t, centers, contexts, pool, grad_in, grad_out, loss_acc):
        sgns_shared_step_reference(in_t, out_t, centers, contexts, pool, grad_in, grad_out, loss_acc, neg_scale)
        return
    v_size, d = in_t.shape
    b, k = centers.shape[0], pool.shape[0]
    dev = in_t.device
    if workspace is None:
        workspace = torch.empty(b * k, dtype=torch.float32, device=dev)
    for name, t, dtype, shape in (
        ("in_t", in_t, torch.float32, (v_size, d)), ("out_t", out_t, torch.float32, (v_size, d)),
        ("centers", centers, torch.int32, (b,)), ("contexts", contexts, torch.int32, (b,)),
        ("pool", pool, torch.int32, (k,)), ("grad_in", grad_in, torch.float32, (v_size, d)),
        ("grad_out", grad_out, torch.float32, (v_size, d)), ("loss_acc", loss_acc, torch.float32, (1,)),
        ("workspace", workspace, torch.float32, (b * k,)),
    ):
        check_operand("sgns_shared", name, t, dtype, shape, dev)
    call("sgns_shared", dev, in_t.data_ptr(), out_t.data_ptr(), centers.data_ptr(),
         contexts.data_ptr(), pool.data_ptr(), grad_in.data_ptr(), grad_out.data_ptr(),
         loss_acc.data_ptr(), workspace.data_ptr(), b, d, k, float(np.float32(neg_scale)))


def bias_corrections(count: int, b1: float, b2: float) -> tuple[float, float]:
    """optax's ``1 - b**t`` for step ``t`` (after the increment), in float32."""
    return float(np.float32(1.0 - b1**count)), float(np.float32(1.0 - b2**count))


def adam_dense_reference(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, count: int,
    lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
) -> None:
    """Plain version of the Adam kernel: optax ``adam`` on one table in
    place, step ``count`` (1 on the first step); zeroes ``g`` after."""
    bc1, bc2 = bias_corrections(count, b1, b2)
    m.copy_((1 - b1) * g + b1 * m)
    v.copy_((1 - b2) * (g * g) + b2 * v)
    p.add_(-lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)))
    g.zero_()


def adam_dense(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, count: int,
    lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
) -> None:
    """One dense Adam step on table ``p`` with gradient ``g`` and moments
    ``m``/``v`` (all the same shape, f32, updated in place; ``g`` zeroed)
    (CUDA kernel ``adam_dense``)."""
    if on_cpu("adam_dense", p, g, m, v):
        adam_dense_reference(p, g, m, v, count, lr, b1, b2, eps)
        return
    dev = p.device
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        check_operand("adam_dense", name, t, torch.float32, tuple(p.shape), dev)
    if count < 1:
        raise ValueError(f"adam_dense: step count starts at 1, got {count}")
    bc1, bc2 = bias_corrections(count, b1, b2)
    call("adam_dense", dev, p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
         p.numel(), lr, b1, b2, float(np.float32(1 - b1)), float(np.float32(1 - b2)),
         eps, bc1, bc2)
