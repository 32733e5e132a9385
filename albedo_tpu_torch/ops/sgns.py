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
minibatch) runs the CUDA kernel ``sgns_shared``: a per-pair warp for the
positive term, three tiled FP32 GEMMs with the row gathers fused in for the
(B, K) logits and their two backward products, then sums into the tables in
an order fixed by the inputs (:func:`k9s_plan`, :func:`k9s_pieces`), so it
gives the same bits on the same inputs. The plain versions
(:func:`sgns_step_reference` and :func:`sgns_shared_step_reference`,
autograd over the JAX formulas, and :func:`adam_dense_reference`, optax's
formula in torch) run for CPU tensors and are what ``chip_smoke.py`` holds
the kernels against.

Duplicate rows in a batch (frequent words as centers and as negatives)
make K9's atomic sums run in an order that changes between runs, so K9
matches its plain version to float32 round-off, not bit for bit.
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
    """``optax.sigmoid_binary_cross_entropy`` at a label of 0 or 1, as the
    JAX ``loss_fn`` writes it: ``-log_sigmoid(x)`` or ``-log_sigmoid(-x)``,
    whose gradients autograd forms as ``-sigmoid(-x)`` and ``sigmoid(x)``
    with no cancellation (``sigmoid(x) - 1`` loses every digit of a
    positive logit above ~17 in float32, ~37 in float64)."""
    return -F.logsigmoid(x if label == 1.0 else -x)


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
    g = torch.sigmoid(-torch.sum(vc * vo, dim=1)) / b  # |sigmoid(pos) - 1| / b, with no cancellation
    gn = torch.sigmoid(vc @ vn.T) * (neg_scale / b)
    mass_in = torch.zeros_like(in_t).index_add_(0, centers.long(), g[:, None] * vo.abs() + gn @ vn.abs())
    mass_out = torch.zeros_like(out_t).index_add_(0, contexts.long(), g[:, None] * vc.abs())
    return mass_in, mass_out.index_add_(0, pool.long(), gn.T @ vc.abs())


# Sorted positions a CTA of K9s's word_sum_kernel walks (csrc/sgns_shared.cu
# RANGE), for the CPU mirror of that walk (:func:`k9s_pieces`).
K9S_RANGE = 64
_K9S_PLANS: dict[tuple[int, int, int, int], dict] = {}


def k9s_plan(b: int, d: int, k: int) -> dict:
    """K9s's plan for a batch of ``b`` pairs, width ``d`` and ``k`` pool
    slots, as the kernel's library lays it out (``sgns_shared_plan``; on a
    card only): the float32 workspace's length ``numel``, G^T Vc's pair
    split (``chunk`` pairs in ``splits`` parts), the sorted list's
    ``ranges`` and the loss slots ``n_pos`` and ``n_neg``."""
    import ctypes

    from albedo_tpu_torch.kernels import build

    lib = build.library("sgns_shared")
    key = (lib._handle, b, d, k)  # per library: the bench builds variants of the source
    if key not in _K9S_PLANS:
        fn = lib.sgns_shared_plan
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
        out = (ctypes.c_longlong * 6)()
        rc = fn(b, d, k, out)
        if rc:
            raise ValueError(f"sgns_shared: no plan for B {b}, d {d}, K {k}: cudaError {rc}")
        _K9S_PLANS[key] = dict(zip(("numel", "chunk", "splits", "ranges", "n_pos", "n_neg"), out))
    return _K9S_PLANS[key]


def sgns_shared_workspace(b: int, d: int, k: int, device) -> torch.Tensor | None:
    """K9s's float32 workspace for a batch of ``b`` pairs, width ``d`` and
    ``k`` pool slots (:func:`k9s_plan`); a fit allocates it once. None on
    the CPU, where the plain version needs none."""
    if torch.device(device).type == "cpu":
        return None
    return torch.empty(k9s_plan(b, d, k)["numel"], dtype=torch.float32, device=device)


def k9s_keys(centers: torch.Tensor, contexts: torch.Tensor, v_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The 2B keys ``(c_b, V + o_b)`` sorted stably, and the position each
    came from (b for a center, B + b for a context), int32: each word's
    pairs form one run of the sorted list, in pair order."""
    keys, perm = torch.sort(torch.cat((centers, contexts + v_size)), stable=True)
    return keys, perm.to(torch.int32)


def k9s_pieces(keys: np.ndarray) -> tuple[list[tuple[int, int, int, str]], list[tuple[int, int, int]]]:
    """The kernel's walk of the sorted keys, in Python: ranges of
    ``K9S_RANGE`` positions, each cut into pieces ``(range, lo, hi, kind)``
    at the runs' edges. ``kind`` is ``"whole"`` for a run wholly inside the
    range (added into its table row by the range), ``"head"`` for a piece of
    a run that began in an earlier range (also a range inside one run) and
    ``"tail"`` for the first piece of a run that goes on past the range.
    The second list has ``(range, key, first_range)`` for each run that
    crosses a range edge: the range holding its last position adds its
    pieces, ``first_range``'s tail then each later range's head, in range
    order."""
    n = len(keys)
    pieces, finishers = [], []
    for r, p0 in enumerate(range(0, n, K9S_RANGE)):
        p1 = min(n, p0 + K9S_RANGE)
        lo = p0
        for p in range(p0, p1):
            if p + 1 < p1 and keys[p + 1] == keys[p]:
                continue
            head = lo == p0 and p0 > 0 and keys[p0 - 1] == keys[p0]
            tail = p == p1 - 1 and p1 < n and keys[p1] == keys[p]
            pieces.append((r, lo, p + 1, "head" if head else "tail" if tail else "whole"))
            if head and not tail:
                first = int(np.searchsorted(keys, keys[p0], side="left"))
                finishers.append((r, int(keys[p0]), first // K9S_RANGE))
            lo = p + 1
    return pieces, finishers


def sgns_shared_cap(b: int) -> float:
    """The cap on K9s's limit at a batch of ``b`` pairs: K9's 5e-5 of each
    element's mass up to its batch of 4096, scaled with the batch beyond it,
    as the float32 round-off bound of a sum grows with its terms (the fixed
    limit K9s was held to before its order was fixed)."""
    return 5e-5 * max(1.0, b / 4096)


def sgns_shared_depths(plan: dict, k: int, max_run: int, max_slots: int) -> tuple[int, int, int]:
    """The most float32 roundings of sums a term of K9s passes through on
    its way into an element of ``grad_in``, of ``grad_out`` and into the
    loss, for a batch of :func:`k9s_plan` ``plan``, ``k`` pool slots, whose
    longest run of one key in the sorted list is ``max_run`` positions and
    whose most pool slots of one word is ``max_slots``:
    - into ``grad_in``: the FMA chain of G Vn over the k slots, the add of
      g_b vo_b, a range's walk (``K9S_RANGE``), the pieces of the longest
      run, the add into the table;
    - into ``grad_out``: a split's chain (``chunk`` pairs), the sum of a
      slot's ``splits``, the sum of the word's slots, the add after the
      contexts' sum; or a context's walk and pieces as above;
    - the loss: a thread's 8 x 8 logits, its CTA's butterfly and warps,
      then the slots, 256 threads each walking its share, and their tree."""
    pieces = -(-max_run // K9S_RANGE) + 1
    depth_in = k + 1 + K9S_RANGE + pieces + 1
    depth_out = max(plan["chunk"] + plan["splits"] + max_slots, K9S_RANGE + pieces) + 2
    depth_loss = 64 + -(-plan["n_pos"] // 256) + -(-plan["n_neg"] // 256) + 32
    return depth_in, depth_out, depth_loss


# F8's check holds K9s to lambda standard deviations of its round-off (below):
# a bound that fails with probability at most 2 exp(-lambda^2 / 2), 4e-22, an
# element.
K9S_LAMBDA = 10.0


def sgns_shared_limits(
    in_t: torch.Tensor, out_t: torch.Tensor, centers: torch.Tensor, contexts: torch.Tensor, pool: torch.Tensor,
    neg_scale: float, plan: dict,
) -> tuple[torch.Tensor, torch.Tensor, float]:
    """Each element's limit on ``|K9s - plain|``, the plain version in
    float64 on the float32 tables (the exact gradients of K9s's inputs):
    (V, d) float64 for ``grad_in`` and ``grad_out``, and one for the loss,
    on a batch of :func:`k9s_plan` ``plan``.

    The first-order error of an element is a sum over every float32
    rounding r on the way to it of c_r delta_r, |delta_r| <= u = 2^-24:
    - a rounding of a sum into the element: c_r is that partial sum, at most
      the element's mass (:func:`sgns_shared_grad_mass`); over the
      roundings sum c_r^2 <= depth mass^2 (:func:`sgns_shared_depths`);
    - a rounding of the logit of a term x (a d-term FMA chain and a shuffle
      tree, d + 5 roundings of partial sums at most A = sum_i |vc_i vn_i|)
      moves x by x rho dL, rho = sigmoid(-L) for G = sigmoid(L) s / B and
      sigmoid(pos) for g_b (the derivative of log sigmoid): sum c_r^2 <=
      x^2 (d + 5) (A rho)^2;
    - the sigmoid's own (expf within 2 ulp, the add, the division and the
      scale): sum c_r^2 <= 16 x^2;
    - the batch's shared scale 1/B and s / B (and the plain version's s
      rounded to float32 as the kernel's): 3 u of the element's mass, the
      same sign for every term, added outright.
    Treating the roundings as independent with mean 0 (Higham and Mary, "A
    new approach to probabilistic rounding error analysis", SIAM J. Sci.
    Comput. 41(5), 2019), Azuma-Hoeffding bounds the sum by ``K9S_LAMBDA``
    u sqrt(sum c_r^2) but with probability 2 exp(-lambda^2 / 2). The loss
    the same way, its terms the BCE values (nonnegative, so its mass is the
    loss), dBCE/dL = sigmoid(L) or -sigmoid(-pos). Times 1 + 1e-3 for the
    second-order terms. Below float32's normal range a rounding errs by up
    to 2^-150 whatever the value (a trained positive logit of 100 makes
    g_b = sigmoid(-100) / B underflow to 0): 2^-149 (1 + max |table|) a
    term and 2^-150 a partial sum are added outright. Never above
    :func:`sgns_shared_cap` of max(mass, 2^-126), the form of the fixed
    check it replaced. An element no term reaches has limit 0 and must be
    exactly 0.

    The model does not hold for a sum of equal terms (a pool of one word,
    a hot center's equal (G Vn)_b): their roundings correlate, and only the
    first-order bound, sqrt(depth) / lambda times this one, holds for sure.
    On an H100 such sums read at most 0.42 of these limits (PERF.md §6,
    ``chip_smoke.py trainer_kernels``), and faults planted at the refscale
    fit's final state 4.26 or more (``kernels/spmm_sgns_bench.py
    k9s_faults``)."""
    b, d, k, v = centers.shape[0], in_t.shape[1], pool.shape[0], in_t.shape[0]
    dd = [t.double() for t in (in_t, out_t)]
    c, o, pl = centers.long(), contexts.long(), pool.long()
    depth_in, depth_out, depth_loss = sgns_shared_depths(
        plan, k, int(torch.bincount(torch.cat([c, o + v])).max()), int(torch.bincount(pl).max()) if k else 0)
    vc, vo = dd[0][c], dd[1][o]
    pos = (vc * vo).sum(dim=1)
    a_pos = (vc.abs() * vo.abs()).sum(dim=1)
    g = torch.sigmoid(-pos) / b
    w_pos = g * g * ((d + 5) * (a_pos * torch.sigmoid(pos)) ** 2 + 16)
    s_in = torch.zeros_like(dd[0]).index_add_(0, c, w_pos[:, None] * vo * vo)
    s_out = torch.zeros_like(dd[1]).index_add_(0, o, w_pos[:, None] * vc * vc)
    bce_pos = -F.logsigmoid(pos)
    s_loss = float((((d + 5) * (a_pos * torch.sigmoid(-pos)) ** 2 + 16 * bce_pos**2) / b**2).sum())
    loss = float(bce_pos.sum()) / b
    if k:
        scale = float(np.float32(neg_scale))
        vn = dd[1][pl]
        logits = vc @ vn.T
        a_neg = vc.abs() @ vn.abs().T
        gn = torch.sigmoid(logits) * (scale / b)
        w_neg = gn * gn * ((d + 5) * (a_neg * torch.sigmoid(-logits)) ** 2 + 16)
        s_in.index_add_(0, c, w_neg @ (vn * vn))
        s_out.index_add_(0, pl, w_neg.T @ (vc * vc))
        bce_neg = -F.logsigmoid(-logits)
        s_loss += float((((d + 5) * (a_neg * torch.sigmoid(logits)) ** 2 + 16 * bce_neg**2)).sum()) * (scale / b) ** 2
        loss += float(bce_neg.sum()) * scale / b
        del logits, a_neg, gn, w_neg, bce_neg
    mass_in, mass_out = sgns_shared_grad_mass(*dd, centers, contexts, pool, neg_scale)
    u, cap, sub, normal = 2.0**-24, sgns_shared_cap(b), 2.0**-150, 2.0**-126
    top = 1.0 + max(float(in_t.abs().max()), float(out_t.abs().max()))
    terms_in = torch.bincount(c, minlength=v).double() * (k + 1)  # terms into each row
    terms_out = torch.bincount(o, minlength=v).double() + torch.bincount(pl, minlength=v).double() * b

    def limit(depth, mass, s2, terms):
        bound = (K9S_LAMBDA * u * (depth * mass * mass + s2).sqrt() + 3 * u * mass) * (1.0 + 1e-3)
        floor = torch.where(terms > 0, sub * (2 * top * terms + depth), 0.0)[:, None]
        return torch.minimum(bound + floor, cap * torch.clamp_min(mass, normal))

    lim_loss = min((K9S_LAMBDA * u * (depth_loss * loss * loss + s_loss) ** 0.5 + 3 * u * loss) * (1.0 + 1e-3)
                   + sub * (2 * top * b * (k + 1) + depth_loss), cap * max(loss, normal))
    return (limit(depth_in, mass_in, s_in, terms_in), limit(depth_out, mass_out, s_out, terms_out), lim_loss)


def sgns_shared_over(got: tuple, want: tuple, limits: tuple) -> float:
    """The worst ``|got - want|`` over its limit among the elements of
    K9s's two gradient tables and its loss (:func:`sgns_shared_limits`):
    the check holds where it is at most 1; an element of limit 0 must match
    exactly (inf otherwise)."""
    worst = 0.0
    for a, e, lim in zip(got, want, limits):
        err = (a.double() - e).abs()
        lim = torch.as_tensor(lim, dtype=torch.float64, device=err.device)
        over = torch.where(lim > 0, err / torch.clamp_min(lim, 1e-300), torch.where(err > 0, torch.inf, 0.0))
        worst = max(worst, float(over.max()) if over.numel() else 0.0)
    return worst


def sgns_shared_step(
    in_t: torch.Tensor, out_t: torch.Tensor, centers: torch.Tensor, contexts: torch.Tensor,
    pool: torch.Tensor, grad_in: torch.Tensor, grad_out: torch.Tensor, loss_acc: torch.Tensor,
    neg_scale: float, workspace: torch.Tensor | None = None,
) -> None:
    """K9s: add one shared-negative SGNS minibatch's table gradients into
    ``grad_in`` and ``grad_out`` (V, d) and its mean loss into ``loss_acc``
    (1,) (CUDA kernel ``sgns_shared``). ``centers``/``contexts`` (B,) and
    ``pool`` (K,) are int32 row ids in [0, V), the pool's may repeat;
    ``neg_scale`` is ``negatives / K``. ``workspace`` is K9s's float32
    workspace (:func:`sgns_shared_workspace`, allocated here when not given;
    a fit passes one, allocated once; the launch refuses one shorter than
    its plan). The same inputs give the same bits."""
    if on_cpu("sgns_shared", in_t, out_t, centers, contexts, pool, grad_in, grad_out, loss_acc):
        sgns_shared_step_reference(in_t, out_t, centers, contexts, pool, grad_in, grad_out, loss_acc, neg_scale)
        return
    v_size, d = in_t.shape
    b, k = centers.shape[0], pool.shape[0]
    dev = in_t.device
    if workspace is None:
        workspace = sgns_shared_workspace(b, d, k, dev)
    for name, t, dtype, shape in (
        ("in_t", in_t, torch.float32, (v_size, d)), ("out_t", out_t, torch.float32, (v_size, d)),
        ("centers", centers, torch.int32, (b,)), ("contexts", contexts, torch.int32, (b,)),
        ("pool", pool, torch.int32, (k,)), ("grad_in", grad_in, torch.float32, (v_size, d)),
        ("grad_out", grad_out, torch.float32, (v_size, d)), ("loss_acc", loss_acc, torch.float32, (1,)),
        ("workspace", workspace, torch.float32, (workspace.numel(),)),
    ):
        check_operand("sgns_shared", name, t, dtype, shape, dev)
    if 2 * v_size >= 2**31:
        raise ValueError(f"sgns_shared: the sorted keys are int32 and take V < 2^30, got {v_size}")
    keys, perm = k9s_keys(centers, contexts, v_size)
    call("sgns_shared", dev, in_t.data_ptr(), out_t.data_ptr(), centers.data_ptr(),
         contexts.data_ptr(), pool.data_ptr(), grad_in.data_ptr(), grad_out.data_ptr(),
         loss_acc.data_ptr(), keys.data_ptr(), perm.data_ptr(), workspace.data_ptr(), workspace.numel(), b,
         v_size, d, k, float(np.float32(neg_scale)))


def bias_corrections(count: int, b1: float, b2: float) -> tuple[float, float]:
    """optax's ``1 - b**t`` for step ``t`` (after the increment), in float32."""
    return float(np.float32(1.0 - b1**count)), float(np.float32(1.0 - b2**count))


def bias_table(steps: int, device, b1: float = 0.9, b2: float = 0.999) -> torch.Tensor:
    """Adam's bias corrections of a fit's steps on ``device``: float32
    ``(steps, 2)``, row ``t - 1`` the pair :func:`bias_corrections` gives
    step ``t``, the same bits. A fit builds it once; each step hands its row
    to :func:`adam_dense`, which the kernel reads from device memory."""
    rows = [bias_corrections(t, b1, b2) for t in range(1, steps + 1)]
    return torch.tensor(rows, dtype=torch.float32).reshape(steps, 2).to(device)


def adam_dense_reference(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, count: int | torch.Tensor,
    lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
) -> None:
    """Plain version of the Adam kernel: optax ``adam`` on one table in
    place, step ``count`` (1 on the first step), or with the bias pair of a
    row of :func:`bias_table` in its place; zeroes ``g`` after."""
    bc1, bc2 = (count[0], count[1]) if isinstance(count, torch.Tensor) else bias_corrections(count, b1, b2)
    m.copy_((1 - b1) * g + b1 * m)
    v.copy_((1 - b2) * (g * g) + b2 * v)
    p.add_(-lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)))
    g.zero_()


def adam_dense(
    p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, count: int | torch.Tensor,
    lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
) -> None:
    """One dense Adam step on table ``p`` with gradient ``g`` and moments
    ``m``/``v`` (all the same shape, f32, updated in place; ``g`` zeroed)
    (CUDA kernel ``adam_dense``). ``count`` is the step (1 on the first),
    whose bias corrections are passed by value, or a float32 ``(2,)`` pair
    on ``p``'s device (a row of :func:`bias_table`), which the kernel reads
    when it runs: a step captured in a CUDA graph then takes whatever the
    pair holds at each replay."""
    tensors = (p, g, m, v, count) if isinstance(count, torch.Tensor) else (p, g, m, v)
    if on_cpu("adam_dense", *tensors):
        adam_dense_reference(p, g, m, v, count, lr, b1, b2, eps)
        return
    dev = p.device
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        check_operand("adam_dense", name, t, torch.float32, tuple(p.shape), dev)
    if isinstance(count, torch.Tensor):
        check_operand("adam_dense", "bias", count, torch.float32, (2,), dev)
        bc1 = bc2 = 0.0
        bias = count.data_ptr()
    elif count < 1:
        raise ValueError(f"adam_dense: step count starts at 1, got {count}")
    else:
        bc1, bc2 = bias_corrections(count, b1, b2)
        bias = None
    call("adam_dense", dev, p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
         p.numel(), lr, b1, b2, float(np.float32(1 - b1)), float(np.float32(1 - b2)),
         eps, bc1, bc2, bias)
