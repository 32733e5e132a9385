"""The port's host data layer against the JAX package's: same seeds, same
inputs, byte-identical outputs (synthetic data, tables, split, buckets,
landing permutation, exclusion rows)."""

import numpy as np
import pandas as pd
import pytest
import torch

from albedo_tpu.datasets import ragged as jr
from albedo_tpu.datasets import split as jsplit
from albedo_tpu.datasets.synthetic import synthetic_stars as j_stars
from albedo_tpu.datasets.synthetic_tables import synthetic_tables as j_tables
from albedo_tpu.models.als import _landing_perm as j_landing
from albedo_tpu_torch.datasets import ragged as tr
from albedo_tpu_torch.datasets import split as tsplit
from albedo_tpu_torch.datasets.synthetic import synthetic_stars as t_stars
from albedo_tpu_torch.datasets.synthetic_tables import synthetic_tables as t_tables
from albedo_tpu_torch.models.als import _landing_perm as t_landing

FIELDS = ("user_ids", "item_ids", "rows", "cols", "vals")


def _same_matrix(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def _same_buckets(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in ("row_ids", "idx", "val", "mask"):
            assert getattr(x, f).dtype == getattr(y, f).dtype
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


@pytest.fixture(scope="module")
def matrix():
    return j_stars(n_users=300, n_items=200, mean_stars=12, seed=3)


@pytest.mark.parametrize("seed", [0, 42])
def test_synthetic_stars_identical(seed):
    _same_matrix(
        t_stars(n_users=150, n_items=90, mean_stars=8, seed=seed),
        j_stars(n_users=150, n_items=90, mean_stars=8, seed=seed),
    )


def test_synthetic_tables_and_star_matrix(tmp_path):
    """Port ``off`` policy == JAX ``repair`` policy on the synthetic tables
    (they carry no bad rows, so the firewall removes nothing)."""
    t = t_tables(n_users=120, n_items=80, mean_stars=10, seed=42)
    j = j_tables(n_users=120, n_items=80, mean_stars=10, seed=42)
    for name in ("user_info", "repo_info", "starring", "relation"):
        pd.testing.assert_frame_equal(getattr(t, name), getattr(j, name))
    jm, report = j.validated_star_matrix(policy="repair", now=1.6e9)
    assert report.rows_out == report.rows_in
    _same_matrix(t.star_matrix(policy="off"), jm)
    with pytest.raises(NotImplementedError):
        t.star_matrix(policy="repair")


def test_split_and_test_users(matrix):
    tt, te = tsplit.random_split_by_user(matrix, test_ratio=0.2, seed=5)
    jt, je = jsplit.random_split_by_user(matrix, test_ratio=0.2, seed=5)
    _same_matrix(tt, jt)
    _same_matrix(te, je)
    np.testing.assert_array_equal(
        tsplit.sample_test_users(tt, n=40, always_include=np.array([3]), seed=9),
        jsplit.sample_test_users(jt, n=40, always_include=np.array([3]), seed=9),
    )


@pytest.mark.parametrize("side", ["csr", "csc"])
@pytest.mark.parametrize("layout", [
    dict(batch_size=8192, max_entries=1 << 21),
    dict(batch_size=16, max_entries=256, max_len=20),
])
def test_grouped_buckets_and_landing(matrix, side, layout):
    csx = getattr(matrix, side)()
    n_target = matrix.n_users if side == "csr" else matrix.n_items
    tg = tr.grouped_bucket_rows(*csx, **layout, workers=3)
    jg = jr.grouped_bucket_rows(*csx, **layout)
    _same_buckets(tg, jg)
    _same_buckets(tr.bucket_rows(*csx, **layout), jr.bucket_rows(*csx, **layout))
    _same_buckets(tr.group_buckets(tr.bucket_rows(*csx, **layout)), jg)
    tl, jl = t_landing(tg, n_target), j_landing(jg, n_target)
    assert tl.dtype == jl.dtype
    np.testing.assert_array_equal(tl, jl)


def test_padded_rows_and_to_device(matrix):
    indptr, cols, _ = matrix.csr()
    rows = np.array([5, 0, 17, 5, 299])
    np.testing.assert_array_equal(
        tr.padded_rows(indptr, cols, rows), jr.padded_rows(indptr, cols, rows)
    )
    g = tr.grouped_bucket_rows(*matrix.csr())[0]
    d = tr.to_device(g, "cpu")
    assert (d.row_ids.dtype, d.idx.dtype, d.val.dtype, d.mask.dtype) == (
        torch.int32, torch.int32, torch.float32, torch.bool
    )
    np.testing.assert_array_equal(d.idx.numpy(), g.idx)
