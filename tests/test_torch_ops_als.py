"""K1-K3 plain versions and the half-sweep against the JAX package's ops on
the same numpy inputs (CPU). Tolerance rtol 1e-5, atol 1e-6: float32 with
another summation order (measured max |diff| ~1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from albedo_tpu.datasets.ragged import grouped_bucket_rows
from albedo_tpu.datasets.synthetic import synthetic_stars
from albedo_tpu.models.als import _landing_perm
from albedo_tpu.ops import als as jals
from albedo_tpu_torch.datasets.ragged import Bucket, to_device
from albedo_tpu_torch.ops import als as tals

RTOL, ATOL = 1e-5, 1e-6
REG, ALPHA = 0.5, 40.0


def _bucket(k, b=12, length=19, n_source=90, n_pad=3, seed=0):
    """A padded bucket as ``datasets.ragged`` lays it out: front-packed
    entries, idx 0 / val 0 off the mask, the last slots all padding."""
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32)
    lens = rng.integers(1, length + 1, size=b)
    lens[b - n_pad:] = 0
    lens[0] = length
    mask = np.arange(length)[None, :] < lens[:, None]
    idx = np.where(mask, rng.integers(0, n_source, size=(b, length)), 0).astype(np.int32)
    val = np.where(mask, rng.uniform(0.5, 1.5, size=(b, length)), 0).astype(np.float32)
    x0 = (rng.standard_normal((b, k)) * 0.1).astype(np.float32)
    return src, idx, val, mask, x0


def _jax_partials(src, idx, val, mask):
    c1 = (ALPHA * val).astype(np.float32)
    w = np.where(mask, 1.0 + c1, 0.0).astype(np.float32)
    return jals.bucket_partial_terms(jnp.asarray(src[idx]), jnp.asarray(c1), jnp.asarray(w))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("k", [8, 50])
def test_k1_partial_terms(k):
    src, idx, val, mask, _ = _bucket(k)
    jc, jb = _jax_partials(src, idx, val, mask)
    tc, tb = tals.bucket_partial_terms(*_t(src, idx, val, mask), ALPHA)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=RTOL, atol=ATOL)
    assert not tc[-1].any() and not tb[-1].any()  # padding slot: zero terms


@pytest.mark.parametrize("k", [8, 50])
def test_k2_solve_corrected(k):
    src, idx, val, mask, _ = _bucket(k)
    jc, jb = _jax_partials(src, idx, val, mask)
    yty = src.T @ src
    n_b = mask.sum(1).astype(np.float32)
    jx = jals.solve_corrected(jnp.asarray(yty), jc, jb, jnp.asarray(n_b), jnp.float32(REG))
    tx = tals.solve_corrected(
        torch.as_tensor(yty), torch.as_tensor(np.array(jc)), torch.as_tensor(np.array(jb)),
        torch.as_tensor(n_b), REG,
    )
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [8, 50])
def test_k1_k2_bucket_solve_body(k):
    src, idx, val, mask, _ = _bucket(k, seed=1)
    yty = src.T @ src
    jx = jals.bucket_solve_body(
        jnp.asarray(src), jnp.asarray(yty), jnp.asarray(idx), jnp.asarray(val),
        jnp.asarray(mask), jnp.float32(REG), jnp.float32(ALPHA),
    )
    tx = tals.bucket_solve_body(*_t(src, yty, idx, val, mask), REG, ALPHA)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k", [8, 50])
@pytest.mark.parametrize("cg_steps", [1, 3])
def test_k3_bucket_cg(k, cg_steps):
    src, idx, val, mask, x0 = _bucket(k, seed=2)
    yty = src.T @ src
    jx = jals.bucket_cg_body(
        jnp.asarray(src), jnp.asarray(yty), jnp.asarray(idx), jnp.asarray(val),
        jnp.asarray(mask), jnp.asarray(x0), jnp.float32(REG), jnp.float32(ALPHA), cg_steps,
    )
    tx = tals.bucket_cg_body(*_t(src, yty, idx, val, mask, x0), REG, ALPHA, cg_steps)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("solver", ["cholesky", "cg"])
def test_half_sweep_with_landing(solver):
    """One item half-sweep with landing == ``scan_half_sweep`` (rows in no
    bucket keep their old factor)."""
    m = synthetic_stars(n_users=120, n_items=80, mean_stars=6, seed=4)
    k = 8
    rng = np.random.default_rng(11)
    user_f = (rng.standard_normal((m.n_users, k)) / np.sqrt(k)).astype(np.float32)
    item_f = (rng.standard_normal((m.n_items + 5, k)) / np.sqrt(k)).astype(np.float32)
    groups = grouped_bucket_rows(*m.csc(), batch_size=16, max_entries=400)
    landing = _landing_perm(groups, item_f.shape[0])
    jx = jals.scan_half_sweep(
        jnp.asarray(user_f), jnp.asarray(item_f),
        [Bucket(*(jnp.asarray(a) for a in (g.row_ids, g.idx, g.val, g.mask))) for g in groups],
        jnp.float32(REG), jnp.float32(ALPHA), solver, 3, jnp.asarray(landing),
    )
    tx = tals.half_sweep(
        torch.as_tensor(user_f), torch.as_tensor(item_f),
        [to_device(g, "cpu") for g in groups], torch.as_tensor(landing).long(),
        REG, ALPHA, solver, 3,
    )
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tx.numpy()[-5:], item_f[-5:])


def test_implicit_loss():
    m = synthetic_stars(n_users=40, n_items=30, mean_stars=5, seed=1)
    rng = np.random.default_rng(2)
    uf = rng.standard_normal((m.n_users, 6)).astype(np.float32)
    vf = rng.standard_normal((m.n_items, 6)).astype(np.float32)
    j = jals.implicit_loss(
        jnp.asarray(uf), jnp.asarray(vf), jnp.asarray(m.rows), jnp.asarray(m.cols),
        jnp.asarray(m.vals), REG, ALPHA,
    )
    t = tals.implicit_loss(*_t(uf, vf, m.rows, m.cols, m.vals), REG, ALPHA)
    np.testing.assert_allclose(float(t), float(j), rtol=RTOL)


def test_unknown_solver_and_mixed_devices_raise():
    src, idx, val, mask, _ = _bucket(8)
    with pytest.raises(ValueError, match="unknown solver"):
        tals.half_sweep(torch.as_tensor(src), torch.as_tensor(src), [], torch.zeros(0).long(),
                        REG, ALPHA, solver="lu")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        tals.bucket_partial_terms(
            torch.as_tensor(src), torch.as_tensor(idx), torch.as_tensor(val),
            torch.as_tensor(mask).to("meta"), ALPHA,
        )


# ------------------------------------------------------------------- K4


def _solved_groups(seed=5, k=7):
    """Bucket groups of an item half-sweep (with -1 padding slots and rows
    in no bucket) and random solved blocks shaped like them."""
    m = synthetic_stars(n_users=90, n_items=60, mean_stars=5, seed=seed)
    groups = grouped_bucket_rows(*m.csc(), batch_size=16, max_entries=300)
    rng = np.random.default_rng(seed)
    n_target = m.n_items + 4  # four rows in no bucket
    target = rng.standard_normal((n_target, k)).astype(np.float32)
    solved = [rng.standard_normal((g.row_ids.size, k)).astype(np.float32) for g in groups]
    return groups, target, solved


def test_k4_scatter_solved_matches_jax():
    """``scatter_solved``'s plain version equals JAX's (exactly): -1 slots
    drop, rows in no bucket keep their old factor."""
    groups, target, solved = _solved_groups()
    rows = np.concatenate([g.row_ids.reshape(-1) for g in groups])
    flat = np.concatenate(solved)
    assert (rows < 0).any()
    want = np.asarray(jals.scatter_solved(jnp.asarray(target), jnp.asarray(rows), jnp.asarray(flat)))
    got = tals.scatter_solved(torch.as_tensor(target), torch.as_tensor(rows), torch.as_tensor(flat))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[-4:], target[-4:])
    # The reference takes the row ids in their (N, B) group shape too.
    g0 = groups[0]
    want0 = np.asarray(jals.scatter_solved(jnp.asarray(target), jnp.asarray(g0.row_ids.reshape(-1)),
                                           jnp.asarray(solved[0])))
    got0 = tals.scatter_solved(torch.as_tensor(target), torch.as_tensor(g0.row_ids),
                               torch.as_tensor(solved[0]).reshape(g0.row_ids.shape + (-1,)))
    np.testing.assert_array_equal(got0.numpy(), want0)


def test_k4_land_rows_matches_jax_landing():
    """``land_rows``'s plain version on the pool of solved blocks is
    ``scan_half_sweep``'s landing gather (``concat(solved..., target)
    [landing]``) exactly, and equals the scatter of the same blocks."""
    groups, target, solved = _solved_groups(seed=6)
    landing = _landing_perm(groups, target.shape[0])
    want = np.asarray(jnp.concatenate([jnp.asarray(b) for b in solved] + [jnp.asarray(target)])[landing])
    got = tals.land_rows(torch.as_tensor(target), torch.as_tensor(np.concatenate(solved)),
                         torch.as_tensor(landing).long())
    np.testing.assert_array_equal(got.numpy(), want)
    rows = np.concatenate([g.row_ids.reshape(-1) for g in groups])
    scattered = jals.scatter_solved(jnp.asarray(target), jnp.asarray(rows), jnp.asarray(np.concatenate(solved)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(scattered))
    keep = tals.land_rows(torch.as_tensor(target), torch.zeros((0, target.shape[1])), torch.arange(target.shape[0]))
    np.testing.assert_array_equal(keep.numpy(), target)  # no blocks: every row keeps its factor
