"""The port's ``ops/sparse_linear.py`` (K8 and the LR objective) against the
JAX package's, on the same numpy inputs, on the CPU.

Tolerances (float32):

- K8 and the terms built on it: the JAX program reduces by cumsum
  differences, whose error grows with the running prefix of the whole
  entry stream (about eps x |prefix| per rounding), while the port sums
  each segment directly. So the port is held against float64 at atol 1e-6,
  and against the JAX program at atol 1e-6 + 32 eps max|prefix|
  (``_cumsum_atol``), the JAX error bound with room for its accumulated
  roundings; a wrong index or segment would be off by O(1). At scale (2M
  entries, 300k segments) the port is held against float64 at atol 1e-7,
  ten times tighter than the JAX module's own gate (1e-6).
- ``block_logits``: rtol 1e-5, atol 1e-4 (logits of magnitude ~10 whose bag
  terms carry the JAX cumsum error above).
- ``weighted_logloss`` value rtol 1e-6 and gradient atol 1e-6, at the zero
  init (every logit exactly 0, where the gradient of the JAX formula's ties
  must be reproduced) and at random coefficients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albedo_tpu.ops.sparse_linear as J
import albedo_tpu_torch.ops.sparse_linear as T
from albedo_tpu.features.assembler import FeatureMatrix as JFM
from albedo_tpu_torch.features.assembler import FeatureMatrix as TFM



def _fm(rng, n=300, factored=True):
    """A FeatureMatrix with every block kind: scalars, a factored vec field,
    a categorical, a per-row bag and (optionally) a factored bag; some bag
    vocab entries never occur (zero-count tail of the vocab indptr)."""
    dense = rng.normal(size=(n, 3)).astype(np.float32)
    vec = rng.normal(size=(9, 4)).astype(np.float32)
    bag_idx = rng.integers(0, 7, size=(n, 4)).astype(np.int32)
    bag_idx[rng.random((n, 4)) < 0.4] = -1
    bag_val = np.where(bag_idx >= 0, rng.integers(1, 3, size=(n, 4)), 0).astype(np.float32)
    kw = dict(
        dense=dense,
        dense_names=[f"d{i}" for i in range(3)] + [f"v[{i}]" for i in range(4)],
        cat={"c": rng.integers(0, 5, size=n).astype(np.int32)}, cat_sizes={"c": 5},
        bag_idx={"b": bag_idx}, bag_val={"b": bag_val}, bag_sizes={"b": 10},
        vec={"v": vec}, vec_rep={"v": rng.integers(0, 9, size=n).astype(np.int32)},
    )
    if factored:
        docs = rng.integers(0, 6, size=(11, 3)).astype(np.int32)
        docs[rng.random((11, 3)) < 0.3] = -1
        kw["bag_idx"]["f"] = docs
        kw["bag_val"]["f"] = np.where(docs >= 0, 1.0, 0.0).astype(np.float32)
        kw["bag_sizes"]["f"] = 6
        kw["bag_rep"] = {"f": rng.integers(0, 11, size=n).astype(np.int32)}
    return JFM(**kw), TFM(**kw)


def _cumsum_atol(stream: np.ndarray) -> float:
    """The JAX cumsum-difference error bound for a reduction over ``stream``."""
    prefix = np.abs(np.cumsum(np.asarray(stream, np.float64))).max(initial=0.0)
    return 1e-6 + 32 * float(np.finfo(np.float32).eps) * float(prefix)


def _params(fm, rng):
    return {k: np.asarray(rng.normal(size=np.shape(v)), np.float32) for k, v in J.init_params(fm).items()}


def _t(tree):
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in tree.items()}


def _csr(rng, n_seg, nnz, n_x, empty_share=0.3):
    counts = rng.integers(0, 6, size=n_seg)
    counts[rng.random(n_seg) < empty_share] = 0
    counts[0] = 0  # an empty first segment
    counts[-1] = nnz  # one long segment at the end
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    total = int(indptr[-1])
    idx = rng.integers(0, n_x, size=total).astype(np.int32)
    val = rng.normal(size=total).astype(np.float32)
    x = rng.normal(size=n_x).astype(np.float32)
    return x, idx, val, indptr


@pytest.mark.parametrize("with_val", [True, False])
def test_segment_dot_plain_matches_jax_segment_sums(with_val):
    rng = np.random.default_rng(1)
    x, idx, val, indptr = _csr(rng, 400, 500, 50)
    data = x[idx] * (val if with_val else 1.0)
    want = np.asarray(J._segment_sums(jnp.asarray(data), jnp.asarray(indptr)))
    got = T.segment_dot(torch.as_tensor(x), torch.as_tensor(idx),
                        torch.as_tensor(val) if with_val else None, torch.as_tensor(indptr))
    assert got.shape == (400,)
    exact = np.zeros(400)
    np.add.at(exact, np.repeat(np.arange(400), np.diff(indptr)), data.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=_cumsum_atol(data))
    assert float(got[0]) == 0.0  # empty segments give 0


def test_segment_dot_precision_at_scale():
    """The direct sum against float64 at the JAX precision gate's scale."""
    rng = np.random.default_rng(0)
    m, n_seg = 2_000_000, 300_000
    data = (rng.standard_normal(m) / m).astype(np.float32)
    bounds = np.sort(rng.integers(0, m, n_seg - 1))
    indptr = np.concatenate([[0], bounds, [m]]).astype(np.int32)
    got = T.segment_dot(torch.as_tensor(data), torch.arange(m, dtype=torch.int32), None,
                        torch.as_tensor(indptr)).numpy()
    exact = np.add.reduceat(data.astype(np.float64), indptr[:-1].astype(np.int64))
    exact[np.diff(indptr) == 0] = 0.0
    assert float(np.abs(got - exact).max()) < 1e-7


def test_feature_batch_layout_matches_jax():
    jfm, tfm = _fm(np.random.default_rng(2))
    jb = J.feature_batch(jfm)
    tb = T.feature_batch(tfm, "cpu")
    assert set(jb) == set(tb)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)


def test_scales_center_and_init_match_jax():
    jfm, tfm = _fm(np.random.default_rng(3))
    for fn in ("inverse_std_scales", "init_params"):
        a, b = getattr(J, fn)(jfm), getattr(T, fn)(tfm)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=f"{fn}:{k}")
    np.testing.assert_array_equal(T.dense_center(tfm), J.dense_center(jfm))


def test_bag_and_rep_terms_forward_and_vjp_match_jax():
    rng = np.random.default_rng(4)
    jfm, tfm = _fm(rng)
    jb, tb = J.feature_batch(jfm), T.feature_batch(tfm, "cpu")
    p = "bagflat:b:"
    keys = [p + k for k in ("r_vocab", "r_val", "r_indptr", "v_rows", "v_val", "v_indptr")]
    w = rng.normal(size=10).astype(np.float32)
    g = rng.normal(size=tfm.n_rows).astype(np.float32)
    out_j, vjp_j = jax.vjp(lambda ww: J._bag_term(ww, *(jb[k] for k in keys)), jnp.asarray(w))
    wt = torch.as_tensor(w).requires_grad_(True)
    out_t = T._bag_term(wt, *(tb[k] for k in keys))
    out_t.backward(torch.as_tensor(g))
    fwd_stream = w[np.asarray(tb[p + "r_vocab"])] * tb[p + "r_val"].numpy()
    bwd_stream = g[np.asarray(tb[p + "v_rows"])] * tb[p + "v_val"].numpy()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=_cumsum_atol(fwd_stream))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(vjp_j(jnp.asarray(g))[0]),
                               atol=_cumsum_atol(bwd_stream))
    assert wt.grad.shape == (10,)  # the vocab indptr spans the whole table

    r = "vecflat:v:"
    lu = rng.normal(size=9).astype(np.float32)
    out_j, vjp_j = jax.vjp(lambda x: J._rep_term(x, jb[r + "rep"], jb[r + "order"], jb[r + "indptr"]),
                           jnp.asarray(lu))
    lt = torch.as_tensor(lu).requires_grad_(True)
    # The port's rep expansion is a term of K8c's autograd Function.
    layout = ([tb[r + "rep"]], [tb[r + "order"]], [tb[r + "indptr"]])
    out_t = T._GatherSum.apply(torch.zeros(tfm.n_rows), layout, lt)
    out_t.backward(torch.as_tensor(g))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(vjp_j(jnp.asarray(g))[0]),
                               atol=_cumsum_atol(g[np.asarray(tb[r + "order"])]))


@pytest.mark.parametrize("centered", [False, True])
def test_block_logits_match_jax(centered):
    rng = np.random.default_rng(5)
    jfm, tfm = _fm(rng)
    params = _params(jfm, rng)
    scales = J.inverse_std_scales(jfm)
    center = J.dense_center(jfm) if centered else None
    want = np.asarray(J.block_logits(params, scales, J.feature_batch(jfm), center))
    got = T.block_logits(_t(params), _t(scales), T.feature_batch(tfm, "cpu"),
                         None if center is None else torch.as_tensor(center))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@jax.jit
def _jax_value_and_grad(params, scales, batch, y, w, center):
    return jax.value_and_grad(
        lambda p: J.weighted_logloss(p, scales, batch, y, w, 0.7, center=center)
    )(params)


@pytest.mark.parametrize("at", ["zero", "random", "overshoot"])
def test_weighted_logloss_value_and_grad_match_jax(at):
    rng = np.random.default_rng(6)
    jfm, tfm = _fm(rng)
    n = jfm.n_rows
    y = (rng.random(n) < 0.4).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    scales, center = J.inverse_std_scales(jfm), J.dense_center(jfm)
    if at == "zero":
        params = J.init_params(jfm)
    else:
        params = _params(jfm, rng)
        if at == "overshoot":  # logits far past the +-35 straight-through clip
            params = {k: v * np.float32(40.0) for k, v in params.items()}
    jb = J.feature_batch(jfm)
    v_j, g_j = _jax_value_and_grad(params, scales, jb, jnp.asarray(y), jnp.asarray(w), center)
    pt = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    v_t = T.weighted_logloss(pt, _t(scales), T.feature_batch(tfm, "cpu"), torch.as_tensor(y),
                             torch.as_tensor(w), 0.7, center=torch.as_tensor(center))
    v_t.backward()
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(g_j[k]), atol=1e-6, err_msg=k)


def test_fold_scales_matches_jax():
    rng = np.random.default_rng(7)
    jfm, _ = _fm(rng)
    params, scales = _params(jfm, rng), J.inverse_std_scales(jfm)
    want = J.fold_scales(params, scales)
    got = T.fold_scales(_t(params), _t(scales))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------- K8c


def test_gather_sum_plain_matches_jax_gathers():
    """K8c's plain version: ``base + sum_j T_j[idx_j]`` left to right, as
    ``block_logits`` adds its gathers (``logits + w[arr]``)."""
    rng = np.random.default_rng(8)
    n, sizes = 500, (1, 5, 300)
    base = rng.normal(size=n).astype(np.float32)
    tables = [rng.normal(size=s).astype(np.float32) for s in sizes]
    idxs = [rng.integers(0, s, size=n).astype(np.int32) for s in sizes]
    want = jnp.asarray(base)
    for tab, idx in zip(tables, idxs):
        want = want + jnp.asarray(tab)[jnp.asarray(idx)]
    got = T.gather_sum(torch.as_tensor(base), [torch.as_tensor(x) for x in tables],
                       [torch.as_tensor(i) for i in idxs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_grad_layout_sorts_each_categorical_field():
    _, tfm = _fm(np.random.default_rng(9))
    plain = T.feature_batch(tfm, "cpu")
    fit = T.feature_batch(tfm, "cpu", grad_layout=True)
    assert set(fit) - set(plain) == {"catgrad:c:order", "catgrad:c:indptr"}
    cat = fit["cat:c"].numpy()
    order = fit["catgrad:c:order"].numpy()
    np.testing.assert_array_equal(order, np.argsort(cat, kind="stable"))
    np.testing.assert_array_equal(fit["catgrad:c:indptr"].numpy(),
                                  np.concatenate([[0], np.cumsum(np.bincount(cat, minlength=5))]))
    dev_order, dev_indptr = T._sorted_layout(fit["cat:c"], 5)
    np.testing.assert_array_equal(dev_order.numpy(), order)
    np.testing.assert_array_equal(dev_indptr.numpy(), fit["catgrad:c:indptr"].numpy())


@pytest.mark.parametrize("grad_layout", [False, True])
def test_fit_batch_logloss_gradients_match_jax(grad_layout):
    """The fit's path (K8c forward, its K8 backward over the batch's
    category-sorted rows, or rows sorted on demand) against ``jax.grad``."""
    rng = np.random.default_rng(10)
    jfm, tfm = _fm(rng)
    n = jfm.n_rows
    y = (rng.random(n) < 0.4).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    scales, center = J.inverse_std_scales(jfm), J.dense_center(jfm)
    params = _params(jfm, rng)
    v_j, g_j = _jax_value_and_grad(params, scales, J.feature_batch(jfm), jnp.asarray(y), jnp.asarray(w), center)
    pt = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    v_t = T.weighted_logloss(pt, _t(scales), T.feature_batch(tfm, "cpu", grad_layout=grad_layout),
                             torch.as_tensor(y), torch.as_tensor(w), 0.7, center=torch.as_tensor(center))
    v_t.backward()
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(g_j[k]), atol=1e-6, err_msg=k)


def test_gather_sum_backward_is_each_tables_segment_sums():
    rng = np.random.default_rng(11)
    n, sizes = 400, (3, 50, 1)
    base = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    idxs = [torch.as_tensor(rng.integers(0, max(1, s // 2), size=n).astype(np.int32)) for s in sizes]
    g = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    tabs = [torch.as_tensor(rng.normal(size=s).astype(np.float32)).requires_grad_(True) for s in sizes]
    layouts = [T._sorted_layout(i, s) for i, s in zip(idxs, sizes)]
    T._GatherSum.apply(base, (idxs, [lay[0] for lay in layouts], [lay[1] for lay in layouts]), *tabs).backward(g)
    for tab, idx, s in zip(tabs, idxs, sizes):
        want = np.zeros(s)
        np.add.at(want, idx.numpy(), g.numpy().astype(np.float64))
        np.testing.assert_allclose(tab.grad.numpy(), want, atol=1e-5)
        assert (tab.grad.numpy()[s // 2 + 1:] == 0).all()  # categories no row reads


# ------------------------------------------------------- the grid (K8g, K8c-g)


def _stack(trees):
    return {k: np.stack([np.asarray(t[k], np.float32) for t in trees]) for k in trees[0]}


@jax.jit
def _jax_grid_value_and_grad(params, scales, batch, y, ws, center):
    """JAX's objective under ``jax.vmap`` over (params, weights) rows, as
    ``_lbfgs_fit_many_impl`` batches it."""
    def one(p, w):
        return jax.value_and_grad(lambda q: J.weighted_logloss(q, scales, batch, y, w, 0.7, center=center))(p)

    return jax.vmap(one)(params, ws)


@pytest.mark.parametrize("n_grid", [1, 3])
def test_grid_logits_loss_and_grads_match_vmapped_jax(n_grid):
    """Parameters with a leading grid axis (K8g and K8c-g's plain versions)
    against the JAX functions under ``jax.vmap``: logits rtol 1e-5 atol 1e-4,
    losses rtol 1e-6, gradients atol 1e-6 (the single-model tolerances)."""
    rng = np.random.default_rng(12)
    jfm, tfm = _fm(rng)
    n = jfm.n_rows
    y = (rng.random(n) < 0.4).astype(np.float32)
    ws = rng.uniform(0.1, 1.0, size=(n_grid, n)).astype(np.float32)
    scales, center = J.inverse_std_scales(jfm), J.dense_center(jfm)
    params = _stack([_params(jfm, rng) for _ in range(n_grid)])
    jb = J.feature_batch(jfm)
    want_logits = np.asarray(jax.vmap(lambda p: J.block_logits(p, scales, jb, center))(params))
    v_j, g_j = _jax_grid_value_and_grad(params, scales, jb, jnp.asarray(y), jnp.asarray(ws), center)
    tb = T.feature_batch(tfm, "cpu", grad_layout=True)
    pt = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    logits = T.block_logits(pt, _t(scales), tb, torch.as_tensor(center))
    assert logits.shape == (n_grid, n)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=1e-5, atol=1e-4)
    v_t = T.weighted_logloss(pt, _t(scales), tb, torch.as_tensor(y), torch.as_tensor(ws), 0.7,
                             center=torch.as_tensor(center))
    assert v_t.shape == (n_grid,)
    v_t.sum().backward()
    np.testing.assert_allclose(v_t.detach().numpy(), np.asarray(v_j), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(g_j[k]), atol=1e-6, err_msg=k)


def test_grid_plain_versions_are_each_rows_single_version():
    """K8g's and K8c-g's plain versions: row g of the grid call equals the
    one-row call on row g exactly (the kernels' contract, G = 1 included)."""
    rng = np.random.default_rng(13)
    x, idx, val, indptr = _csr(rng, 200, 300, 40)
    xs = torch.as_tensor(rng.normal(size=(3, 40)).astype(np.float32))
    t_idx, t_val, t_ptr = torch.as_tensor(idx), torch.as_tensor(val), torch.as_tensor(indptr)
    for v in (t_val, None):
        grid = T.segment_dot(xs, t_idx, v, t_ptr)
        assert grid.shape == (3, 200)
        for g in range(3):
            torch.testing.assert_close(grid[g], T.segment_dot(xs[g], t_idx, v, t_ptr), rtol=0, atol=0)
    n, sizes = 250, (4, 30)
    base = torch.as_tensor(rng.normal(size=(3, n)).astype(np.float32))
    tables = [torch.as_tensor(rng.normal(size=(3, s)).astype(np.float32)) for s in sizes]
    idxs = [torch.as_tensor(rng.integers(0, s, size=n).astype(np.int32)) for s in sizes]
    grid = T.gather_sum(base, tables, idxs)
    for g in range(3):
        torch.testing.assert_close(grid[g], T.gather_sum(base[g], [t[g] for t in tables], idxs), rtol=0, atol=0)


@pytest.mark.parametrize("at", ["zero", "random"])
def test_logloss_at_the_ranker_skew_matches_jax(at):
    """The objective and its gradient at the ranker fit's skew
    (``test_torch_cuda.ranker_skew_features``: 3 categories holding 80/15/5%
    of the rows, bag head tokens in 90% of the rows), the generator the card
    test of K8/K8g reuses at the fit's 257 023 rows, here at the parity
    tolerances above (value rtol 1e-6, gradient atol 1e-6) and the other
    parity tests' 300 rows: the JAX program's cumsum-difference error grows
    with the head token's running prefix and reaches 1.0e-6 on a bag weight
    at 600 rows (the port sums each segment directly)."""
    from test_torch_cuda import ranker_skew_features

    rng = np.random.default_rng(14)
    arrays = ranker_skew_features(rng, 300)
    jfm, tfm = JFM(**arrays), TFM(**arrays)
    n = jfm.n_rows
    assert np.bincount(arrays["cat"]["c3"]).max() > 0.75 * n
    y = (rng.random(n) < 0.3).astype(np.float32)
    w = rng.uniform(0.1, 1.0, size=n).astype(np.float32)
    scales, center = J.inverse_std_scales(jfm), J.dense_center(jfm)
    params = J.init_params(jfm) if at == "zero" else _params(jfm, rng)
    v_j, g_j = _jax_value_and_grad(params, scales, J.feature_batch(jfm), jnp.asarray(y), jnp.asarray(w), center)
    pt = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    v_t = T.weighted_logloss(pt, _t(scales), T.feature_batch(tfm, "cpu", grad_layout=True), torch.as_tensor(y),
                             torch.as_tensor(w), 0.7, center=torch.as_tensor(center))
    v_t.backward()
    np.testing.assert_allclose(float(v_t.detach()), float(v_j), rtol=1e-6)
    for k in params:
        np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(g_j[k]), atol=1e-6, err_msg=k)
