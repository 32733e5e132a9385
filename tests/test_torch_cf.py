"""K11 in the port against the JAX package on the CPU: the four sparse passes
of ``recommenders/cf.py`` as ``spmm_rows``, the masked top-k, and the
item-CF and user-CF recommenders end to end.

Inputs: ``synthetic_stars(150, 90, 10, seed=17)`` built by each package
(byte-equal, ``tests/test_torch_datasets.py``) and numpy arrays from seeds.

Tolerances: scores within rtol 2e-4, atol 2e-5, the JAX package's own
tolerance against float64 (``tests/test_cf.py:67``): the two packages sum
the sparse passes in other orders (JAX's second pass is a scatter-add over
padded row groups, the port's a gather over the transposed CSR). Returned
sets are compared with the near-tie rule: an item returned by one package
and not the other must score within that tolerance of the lowest score the
JAX package kept. The plain versions against numpy: ``spmm_rows_reference``
within 1e-6 of float64, ``masked_topk_reference`` exactly (it divides and
compares, it does not sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from albedo_tpu.datasets import synthetic_stars as jax_stars
from albedo_tpu.recommenders import cf as jax_cf
from albedo_tpu_torch.datasets.synthetic import synthetic_stars
from albedo_tpu_torch.ops.spmm import CSR, masked_topk, masked_topk_reference, spmm_rows, spmm_rows_reference
from albedo_tpu_torch.recommenders.cf import ItemCFRecommender, UserCFRecommender, dense_user_block

RTOL, ATOL = 2e-4, 2e-5


def _close(a, b) -> bool:
    return abs(a - b) <= ATOL + RTOL * abs(b)


def _lists(df) -> dict[int, dict[int, float]]:
    out: dict[int, dict[int, float]] = {}
    for u, i, s in zip(df["user_id"], df["repo_id"], df["score"]):
        out.setdefault(int(u), {})[int(i)] = float(s)
    return out


def assert_same_topk(port_df, jax_df) -> None:
    """Per user: equal list lengths, scores of common items within the
    tolerance, and any item in only one list within the tolerance of the
    lowest score the JAX package kept (a near-tie at the cut)."""
    port, ref = _lists(port_df), _lists(jax_df)
    assert port.keys() == ref.keys()
    for u, want in ref.items():
        got = port[u]
        assert len(got) == len(want), u
        for i in got.keys() & want.keys():
            assert _close(got[i], want[i]), (u, i, got[i], want[i])
        floor = min(want.values())
        for i in got.keys() ^ want.keys():
            assert _close(got.get(i, want.get(i)), floor), (u, i, floor)


@pytest.fixture(scope="module")
def matrices():
    return (synthetic_stars(n_users=150, n_items=90, mean_stars=10, seed=17),
            jax_stars(n_users=150, n_items=90, mean_stars=10, seed=17))


@pytest.mark.parametrize("port_cls, jax_cls", [
    (ItemCFRecommender, jax_cf.ItemCFRecommender), (UserCFRecommender, jax_cf.UserCFRecommender),
], ids=["item_cf", "user_cf"])
def test_cf_recommenders_match_jax(matrices, port_cls, jax_cls):
    m, jm = matrices
    users = np.concatenate([m.user_ids, [10**9]])  # one unknown user: no rows
    port = port_cls(m, top_k=12, user_block=64, device="cpu").recommend_for_users(users)
    ref = jax_cls(jm, top_k=12, user_block=64).recommend_for_users(users)
    assert set(port["source"]) == {port_cls.source}
    assert_same_topk(port, ref)
    starred = {(int(m.user_ids[u]), int(m.item_ids[i])) for u, i in zip(m.rows, m.cols)}
    assert not starred & set(zip(port["user_id"], port["repo_id"])), "a starred item leaked"


@pytest.fixture(scope="module")
def wide_matrices():
    return (synthetic_stars(n_users=60, n_items=1300, mean_stars=25, seed=23),
            jax_stars(n_users=60, n_items=1300, mean_stars=25, seed=23))


@pytest.mark.parametrize("top_k", [200, 600])
@pytest.mark.parametrize("port_cls, jax_cls", [
    (ItemCFRecommender, jax_cf.ItemCFRecommender), (UserCFRecommender, jax_cf.UserCFRecommender),
], ids=["item_cf", "user_cf"])
def test_cf_recommenders_match_jax_at_large_k(wide_matrices, port_cls, jax_cls, top_k):
    # k above the streaming masked_topk kernel's 128 (and above 512): on the
    # card these run its select path. The lists are held with the near-tie
    # rule: the sparse passes sum in other orders (scores part by ~1e-7),
    # which can swap items that tie at the cut.
    m, jm = wide_matrices
    port = port_cls(m, top_k=top_k, user_block=64, device="cpu").recommend_for_users(m.user_ids)
    ref = jax_cls(jm, top_k=top_k, user_block=64).recommend_for_users(m.user_ids)
    assert len(port) == len(ref) == top_k * m.n_users
    assert_same_topk(port, ref)


def _random_csr(rng, n_rows, n_cols, with_val):
    counts = rng.integers(0, 9, size=n_rows)
    counts[::4] = 0                                   # empty rows
    indptr = np.concatenate([[0], np.cumsum(counts)])
    idx = rng.integers(0, n_cols, size=int(indptr[-1]))
    val = rng.uniform(0.1, 2.0, size=idx.size).astype(np.float32) if with_val else None
    dense = np.zeros((n_rows, n_cols))
    np.add.at(dense, (np.repeat(np.arange(n_rows), counts), idx), 1.0 if val is None else val)
    return CSR.from_host(indptr, idx, val, n_cols, "cpu"), dense


@pytest.mark.parametrize("with_val", [True, False])
@pytest.mark.parametrize("b", [1, 7])
def test_spmm_rows_reference_matches_numpy(with_val, b):
    rng = np.random.default_rng(b)
    w, dense = _random_csr(rng, 40, 25, with_val)
    x = rng.normal(size=(25, b)).astype(np.float32)
    got = spmm_rows(w, torch.as_tensor(x))
    assert got.shape == (40, b)
    np.testing.assert_allclose(got.numpy(), dense @ x.astype(np.float64), rtol=1e-6, atol=1e-6)
    y = rng.normal(size=(40, b)).astype(np.float32)     # the transpose: W^T @ y
    np.testing.assert_allclose(spmm_rows_reference(w.transpose(), torch.as_tensor(y)).numpy(),
                               dense.T @ y.astype(np.float64), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("jax_pass", ["gather_matmul_t", "scatter_matmul", "row_sums", "col_weighted_sums"])
def test_spmm_rows_covers_the_jax_sparse_passes(matrices, jax_pass):
    m, jm = matrices
    rng = np.random.default_rng(3)
    indptr, cols, _ = m.csr()
    weights = rng.uniform(0.2, 1.0, size=m.n_items)
    groups = jax_cf.sparse_row_groups(*jm.csr()[:2], item_weights=weights)
    w = CSR.from_host(indptr, cols, weights[cols].astype(np.float32), m.n_items, "cpu")
    if jax_pass == "gather_matmul_t":            # x @ W^T = (W @ x^T)^T
        x = rng.normal(size=(5, m.n_items)).astype(np.float32)
        want = jax_cf.gather_matmul_t(jnp.asarray(x), groups, m.n_users)
        got = spmm_rows(w, torch.as_tensor(x.T.copy())).T
    elif jax_pass == "scatter_matmul":           # m @ W = (W^T @ m^T)^T
        x = rng.normal(size=(5, m.n_users)).astype(np.float32)
        want = jax_cf.scatter_matmul(jnp.asarray(x), groups, m.n_items)
        got = spmm_rows(w.transpose(), torch.as_tensor(x.T.copy())).T
    elif jax_pass == "row_sums":                 # W @ 1
        want = jax_cf.row_sums(groups, m.n_users)
        got = spmm_rows(w, torch.ones((m.n_items, 1)))[:, 0]
    else:                                        # W^T t
        t = rng.uniform(size=m.n_users).astype(np.float32)
        want = jax_cf.col_weighted_sums(groups, jnp.asarray(t), m.n_items)
        got = spmm_rows(w.transpose(), torch.as_tensor(t[:, None]))[:, 0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _numpy_masked_topk(scores, starred, k, norm):
    s = scores / np.maximum(norm, np.float32(1e-12))[None, :] if norm is not None else scores.copy()
    for b, row in enumerate(starred):
        s[b, row[(row >= 0) & (row < s.shape[1])]] = -np.inf
    vals = np.full((s.shape[0], k), -np.inf, np.float32)
    idx = np.full((s.shape[0], k), -1, np.int32)
    for b in range(s.shape[0]):
        order = np.argsort(-s[b], kind="stable")[:k]   # value desc, lower index first
        order = order[np.isfinite(s[b][order])]
        vals[b, : order.size], idx[b, : order.size] = s[b][order], order
    return vals, idx


@pytest.mark.parametrize("with_norm", [True, False])
def test_masked_topk_reference_matches_numpy(with_norm):
    rng = np.random.default_rng(5)
    scores = rng.normal(size=(6, 50)).astype(np.float32)
    scores[:, 30:40] = scores[:, :10]                  # ties: lower column first
    scores[2] = 1.5                                    # a row of ties
    norm = rng.uniform(0.0, 2.0, size=50).astype(np.float32) if with_norm else None
    if with_norm:
        norm[::9] = 0.0                                # clamped to 1e-12
    starred = np.full((6, 60), -1, np.int32)
    starred[:, :8] = rng.integers(0, 50, size=(6, 8))
    starred[:, 8] = starred[:, 0]                      # a duplicate
    starred[4, :50] = np.arange(50)                    # a row with every column starred
    for k in (5, 64):                                  # and k > n
        got = masked_topk(torch.as_tensor(scores.T.copy()).t(), torch.as_tensor(starred), k,
                          None if norm is None else torch.as_tensor(norm))
        want = _numpy_masked_topk(scores, starred, k, norm)
        np.testing.assert_array_equal(got[1].numpy(), want[1])
        np.testing.assert_array_equal(got[0].numpy(), want[0])
    assert (got[1][4] == -1).all()
    ref = masked_topk_reference(torch.as_tensor(scores), None, 3)
    assert ref[1][2].tolist() == [0, 1, 2]


def test_dense_user_block_is_the_transposed_jax_block():
    star_idx = np.array([[0, 3, -1], [2, -1, -1], [-1, -1, -1]], np.int32)
    want = np.asarray(jax_cf._dense_user_block(jnp.asarray(star_idx), 5))
    np.testing.assert_array_equal(dense_user_block(torch.as_tensor(star_idx), 5).numpy(), want.T)
