"""The ranking factorization's training step: BPR loss and gradients (K10)
(PyTorch + CUDA).

Port of the device half of ``albedo_tpu/models/ranking_factorization.py``
``run`` (:167): ``jax.value_and_grad`` of ``loss_fn`` (:152, with
``item_score`` :145) for one minibatch of (user, positive item, N negative
items). :func:`bpr_step` runs the CUDA kernel ``bpr_step``: one warp per
pair gathers x_u, y_pos, the negatives' rows, the item biases and the side
terms ``g_i . w``, forms the N pairwise differences, and adds the
gradients of x, y, the item bias and w into dense tables with atomics
(above rank 128 or side width 32 a wide path keeps no row in registers, so
any width runs). The plain version (:func:`bpr_step_reference`, autograd over :func:`bpr_loss`)
runs for CPU tensors and is what ``chip_smoke.py`` holds the kernel
against. The Adam update is ``ops.sgns.adam_dense`` over the flat buffer
that holds all four parameters.

Hot users and items repeat within a batch and negatives are drawn with
replacement, so the kernel's atomic sums run in an order that changes
between runs: it matches its plain version to float32 round-off, held per
element against the L1 mass of its terms (:func:`bpr_grad_mass`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from albedo_tpu_torch.kernels.build import call, check_operand, on_cpu

RMAX = 128  # widest factor rank of the narrow path; wider ranks take the wide path (bpr_step_wide)
DMAX = 32   # widest item side-feature vector of the narrow path; wider ones take the wide path


def bpr_loss(
    x: torch.Tensor, y: torch.Tensor, bias: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
    users: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor, reg: float,
) -> torch.Tensor:
    """``loss_fn`` of the JAX module: the mean of ``-log sigmoid(s_pos -
    s_neg)`` over the (B, N) pairs plus ``reg`` times the batch means of
    ``|x_u|^2``, ``|y_pos|^2`` and ``sum_n |y_neg|^2``, with item scores
    ``x_u . y_i + bias_i + g_i . w``."""
    u_vec = x[users.long()]
    y_pos, y_neg = y[pos.long()], y[neg.long()]
    s_pos = (u_vec * y_pos).sum(dim=1) + bias[pos.long()] + g[pos.long()] @ w
    s_neg = torch.einsum("bk,bnk->bn", u_vec, y_neg) + bias[neg.long()] + g[neg.long()] @ w
    loss = -F.logsigmoid(s_pos[:, None] - s_neg).mean()
    return loss + reg * (
        (u_vec**2).sum(dim=1).mean() + (y_pos**2).sum(dim=1).mean() + (y_neg**2).sum(dim=(1, 2)).mean()
    )


def bpr_step_reference(
    x, y, bias, w, g, users, pos, neg, gx, gy, gbias, gw, loss_acc, reg: float,
) -> None:
    """Plain version of K10: autograd over :func:`bpr_loss`, the gradients
    added into ``gx``, ``gy``, ``gbias``, ``gw`` and the loss into
    ``loss_acc`` (1,)."""
    with torch.enable_grad():
        params = [t.detach().requires_grad_(True) for t in (x, y, bias, w)]
        loss = bpr_loss(*params, g, users, pos, neg, reg)
        grads = torch.autograd.grad(loss, params)
    for acc, grad in zip((gx, gy, gbias, gw), grads):
        acc.add_(grad)
    loss_acc.add_(loss.detach())


def bpr_grad_mass(
    x, y, bias, w, g, users, pos, neg, reg: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The L1 mass of each element of K10's gradient tables (those of x, y,
    bias and w): the sum, over the terms one minibatch adds into it, of
    their absolute values. Float32 round-off in any order of those sums is
    a small multiple of it, so K10 is held against its plain version
    relative to it; an element no term reaches has mass 0 and stays 0."""
    u, p, n = users.long(), pos.long(), neg.long()
    b_size, n_neg = neg.shape
    xu, yp, yn = x[u], y[p], y[n]
    s_pos = (xu * yp).sum(dim=1) + bias[p] + g[p] @ w
    s_neg = torch.einsum("bk,bnk->bn", xu, yn) + bias[n] + g[n] @ w
    c = torch.sigmoid(s_neg - s_pos[:, None]) / (b_size * n_neg)   # |c_bn|
    r2 = 2.0 * abs(reg) / b_size
    m_x = torch.zeros_like(x).index_add_(
        0, u, torch.einsum("bn,bnk->bk", c, yp.abs()[:, None, :] + yn.abs()) + r2 * xu.abs())
    terms_y = torch.cat([
        c.sum(dim=1)[:, None] * xu.abs() + r2 * yp.abs(),
        (c[..., None] * xu.abs()[:, None, :] + r2 * yn.abs()).reshape(-1, x.shape[1]),
    ])
    m_y = torch.zeros_like(y).index_add_(0, torch.cat([p, n.reshape(-1)]), terms_y)
    m_b = torch.zeros_like(bias).index_add_(0, torch.cat([p, n.reshape(-1)]),
                                            torch.cat([c.sum(dim=1), c.reshape(-1)]))
    m_w = torch.einsum("bn,bnj->j", c, g[p].abs()[:, None, :] + g[n].abs())
    return m_x, m_y, m_b, m_w


def bpr_step(
    x, y, bias, w, g, users, pos, neg, gx, gy, gbias, gw, loss_acc, reg: float,
) -> None:
    """K10: add one BPR minibatch's gradients of the user table ``x`` (U, r),
    the item table ``y`` (I, r), the item bias (I,) and the side weights
    ``w`` (d,) into ``gx``, ``gy``, ``gbias``, ``gw``, and its loss into
    ``loss_acc`` (1,) (CUDA kernel ``bpr_step``). ``g`` (I, d) holds the
    item side features; ``users``/``pos`` (B,) and ``neg`` (B, N) are int32
    row ids."""
    tensors = (x, y, bias, w, g, users, pos, neg, gx, gy, gbias, gw, loss_acc)
    if on_cpu("bpr_step", *tensors):
        bpr_step_reference(*tensors, reg)
        return
    n_users, r = x.shape
    n_items, d = g.shape
    b, n_neg = neg.shape
    if r < 1 or d < 1:
        raise ValueError(f"bpr_step: the CUDA kernel takes ranks and side widths >= 1, got {r} and {d}")
    if n_neg < 1:
        raise ValueError("bpr_step: needs at least one negative per pair")
    dev = x.device
    for name, t, dtype, shape in (
        ("x", x, torch.float32, (n_users, r)), ("y", y, torch.float32, (n_items, r)),
        ("bias", bias, torch.float32, (n_items,)), ("w", w, torch.float32, (d,)),
        ("g", g, torch.float32, (n_items, d)), ("users", users, torch.int32, (b,)),
        ("pos", pos, torch.int32, (b,)), ("neg", neg, torch.int32, (b, n_neg)),
        ("gx", gx, torch.float32, (n_users, r)), ("gy", gy, torch.float32, (n_items, r)),
        ("gbias", gbias, torch.float32, (n_items,)), ("gw", gw, torch.float32, (d,)),
        ("loss_acc", loss_acc, torch.float32, (1,)),
    ):
        check_operand("bpr_step", name, t, dtype, shape, dev)
    call("bpr_step", dev, *(t.data_ptr() for t in tensors), b, n_neg, r, d, float(reg),
         count="bpr_step_wide" if r > RMAX or d > DMAX else None)
