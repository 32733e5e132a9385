"""K5 plain version against the JAX ``topk_scores`` on the same numpy inputs
(CPU): exact indices, ties included, and scores within rtol/atol 1e-6 (the
two sum the r products in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from albedo_tpu.ops.topk import topk_scores as j_topk
from albedo_tpu_torch.ops.topk import topk_scores as t_topk
from albedo_tpu_torch.ops.topk import topk_scores_reference


def _factors(n_users, n_items, r, seed):
    rng = np.random.default_rng(seed)
    uf = (rng.standard_normal((n_users, r)) / np.sqrt(r)).astype(np.float32)
    vf = (rng.standard_normal((n_items, r)) / np.sqrt(r)).astype(np.float32)
    return rng, uf, vf


def _compare(uf, vf, k, excl, item_block):
    jv, ji = j_topk(
        jnp.asarray(uf), jnp.asarray(vf), k=k,
        exclude_idx=None if excl is None else jnp.asarray(excl), item_block=item_block,
    )
    tv, ti = t_topk(
        torch.as_tensor(uf), torch.as_tensor(vf), k,
        None if excl is None else torch.as_tensor(excl), item_block=item_block,
    )
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=1e-6)
    return tv.numpy(), ti.numpy()


@pytest.mark.parametrize("item_block", [64, 4096])
def test_ragged_blocks_exclusions_and_ties(item_block):
    """I = 997 (ragged last block at 64), -1-padded unsorted exclusion rows
    with duplicates, and duplicated item rows that tie exactly."""
    rng, uf, vf = _factors(9, 997, 12, seed=0)
    vf[500:520] = vf[:20]          # exact ties across blocks
    vf[996] = vf[3]
    uf[1] = vf[3] * 5              # row 1's best items are the tied copies
    excl = np.full((9, 30), -1, dtype=np.int32)
    excl[:, :20] = rng.integers(0, 997, size=(9, 20))
    excl[:, 20] = excl[:, 0]       # duplicate exclusion
    excl[2, 0] = 3                 # row 2 excludes one copy of a tied pair
    _, ti = _compare(uf, vf, 25, excl, item_block)
    tied = [i for i in ti[1] if i in (3, 503, 996)]  # copies of item 3
    assert len(tied) >= 2 and tied == sorted(tied)  # ties: lower index first
    assert not np.isin(ti[0], excl[0][excl[0] >= 0]).any()


def test_fewer_admissible_items_than_k():
    _, uf, vf = _factors(4, 20, 8, seed=1)
    excl = np.tile(np.arange(12, dtype=np.int32), (4, 1))
    tv, ti = _compare(uf, vf, 15, excl, 8)
    assert (ti[:, 8:] == -1).all() and np.isneginf(tv[:, 8:]).all()
    tv, ti = _compare(uf, vf[:5], 9, None, 4)  # k > n_items
    assert (ti[:, 5:] == -1).all()


def test_reference_orders_by_score_then_index():
    uf = torch.ones((1, 2))
    vf = torch.tensor([[1.0, 0.0], [0.5, 0.5], [2.0, 0.0], [0.0, 1.0]])
    vals, idx = topk_scores_reference(uf, vf, 4, torch.tensor([[2, -1]], dtype=torch.int32))
    assert idx.tolist() == [[0, 1, 3, -1]]
    assert vals[0, :3].tolist() == [1.0, 1.0, 1.0] and vals[0, 3] == float("-inf")


@pytest.mark.parametrize("k", [513, 600, 1000, 1200])
def test_k_above_512_matches_jax(k):
    """JAX's ``topk_scores`` takes any k; the port took k <= 512 only and
    raised at k = 600 even on the CPU. Now every k is answered as JAX
    answers it (k = 1200 > the 1000 items pads with (-inf, -1))."""
    rng, uf, vf = _factors(2, 1000, 8, seed=4)
    vf[700:710] = vf[:10]
    excl = np.full((2, 40), -1, dtype=np.int32)
    excl[:, :30] = rng.integers(0, 1000, size=(2, 30))
    tv, ti = _compare(uf, vf, k, excl, 4096)
    assert tv.shape == (2, k)
    n_adm = [1000 - len(set(row[row >= 0])) for row in excl]
    for b in range(2):
        assert (ti[b, :min(k, n_adm[b])] >= 0).all() and (ti[b, n_adm[b]:] == -1).all()


def test_exclusion_rows_wider_than_the_streaming_body_match_jax():
    """An exclusion row longer than ``EXCLUDE_MAX`` (the rows the
    streaming body sorts in shared memory) is answered as JAX answers it."""
    from albedo_tpu_torch.ops.topk import EXCLUDE_MAX

    rng, uf, vf = _factors(2, EXCLUDE_MAX + 500, 4, seed=5)
    excl = np.full((2, EXCLUDE_MAX + 100), -1, dtype=np.int32)
    excl[0] = rng.permutation(EXCLUDE_MAX + 500)[:EXCLUDE_MAX + 100]
    excl[1, :10] = np.arange(10)
    _, ti = _compare(uf, vf, 30, excl, 4096)
    assert not np.isin(ti[0], excl[0]).any()


# K5's split design (csrc/topk_scores.cu) splits the items into tiles of 32
# or 128 and splits of several tiles, keeps k <= 32 in registers and gives
# k > 32 a floor from a first pass; the cases below hold the plain version
# (what the kernel is held to on the card) against JAX at those shapes.


@pytest.mark.parametrize("k", [11, 50])
def test_one_tfidf_row_at_rank_3010_matches_jax(k):
    """One query row against 2936 nonnegative unit rows of width 3010 (the
    tf-idf similar-repo call), with the query among the items and a
    duplicated row (an exact tie)."""
    rng = np.random.default_rng(6)
    vf = np.abs(rng.standard_normal((2936, 3010))).astype(np.float32)
    vf /= np.linalg.norm(vf, axis=1, keepdims=True)
    vf[2000] = vf[17]
    _, ti = _compare(vf[17:18].copy(), vf, k, None, 4096)
    assert ti[0, 0] in (17, 2000) and ti[0, :2].tolist() == [17, 2000]


@pytest.mark.parametrize("k", [32, 33, 512])
def test_ties_across_tile_and_split_boundaries_match_jax(k):
    """Item 32m equal to item 32m - 1 for every m (ties across any tile or
    split of the kernel), item 1024 + i equal to item i, at k on both sides
    of the register lists' 32 and at 512, with exclusions."""
    rng, uf, vf = _factors(5, 3000, 16, seed=7)
    vf[32::32] = vf[31:-1:32][: len(vf[32::32])]
    vf[1024:1124] = vf[:100]
    excl = np.full((5, 50), -1, dtype=np.int32)
    excl[:, :40] = rng.integers(0, 3000, size=(5, 40))
    tv, ti = _compare(uf, vf, k, excl, 4096)
    for b in range(5):
        ties = tv[b][:-1] == tv[b][1:]
        assert (ti[b][:-1][ties] < ti[b][1:][ties]).all()


@pytest.mark.parametrize("k", [129, 512])
def test_exclusion_rows_wider_than_32768_at_k_up_to_512_match_jax(k):
    """K5 takes any exclusion width at k <= 512 (a bitmask, no sort): a row
    excluding 33 000 of 33 500 items, one excluding ten, one excluding all."""
    rng, uf, vf = _factors(3, 33_500, 4, seed=8)
    excl = np.full((3, 33_500), -1, dtype=np.int32)
    excl[0, :33_000] = rng.permutation(33_500)[:33_000]
    excl[1, :10] = np.arange(10)
    excl[2] = np.arange(33_500)
    tv, ti = _compare(uf, vf, k, excl, 4096)
    assert (ti[0, :500] >= 0).all() and (ti[0, 500:] == -1).all()
    assert (ti[2] == -1).all() and np.isneginf(tv[2]).all()


@pytest.mark.parametrize("k", [1, 10])
def test_zero_rows_nan_and_inf_scores_match_jax(k):
    """A query of zeros (every score ties at +0), scores cancelling to 0
    beside positive and negative ones, and NaN and +-inf scores: JAX ranks
    NaN first (lax.top_k), NaNs by index, and never admits -inf; so does the
    plain version the kernel is held to."""
    rng, _, vf = _factors(1, 300, 6, seed=9)
    vf[::3, 1] = vf[::3, 0]
    vf[7, 2], vf[90, 3] = np.nan, np.nan
    vf[40, 4], vf[41, 5] = np.inf, -np.inf
    uf = np.zeros((4, 6), dtype=np.float32)
    uf[1, :2] = (1.0, -1.0)
    uf[2] = rng.standard_normal(6).astype(np.float32)
    uf[3, 4] = 1.0
    _compare(uf, vf, k, None, 4096)


@pytest.mark.parametrize("shape", [
    (500, 19991, 30), (500, 19991, 512), (1, 2936, 11), (100, 2936, 30), (250, 2936, 512),
    (30000, 20000, 30), (4, 60000, 129), (37, 600, 512), (9, 300, 512), (0, 10, 5), (3, 0, 5),
])
def test_k5_plan_keeps_the_kernel_contract(shape):
    """The launch plan the wrapper hands ``topk_scores_launch`` satisfies
    the checks the kernel makes (it refuses the launch otherwise): splits of
    whole tiles, a first pass exactly above k = 32 with k1 <= 32, rows in
    whole tiles of 32; and the workspace and the merge kernel's slots within
    their budgets. A call the kernel cannot take (above k = 32, fewer
    32-item tiles than the first pass needs) goes to the select path."""
    from albedo_tpu_torch.ops import topk

    n_users, n_items, k = shape
    if not topk._k5_takes(n_items, k):
        assert k > 32 and -(-n_items // 32) < -(-k // 32)
        return
    for excl in (False, True):
        tile, split, split1, rows = topk._k5_plan(n_users, n_items, k, excl, 132)
        assert tile in (32, 128) and split >= tile and split % tile == 0
        assert rows >= 32 and rows % 32 == 0
        n_splits = max(1, -(-n_items // split))
        lp = topk.pow2_at_least(k)
        assert n_splits <= topk.K5_MAX_SPLITS
        n_bound = 0
        if k > 32:  # a first pass; the merge kernel gathers pow2(splits) slots
            n_bound = -(-n_items // split1)
            assert split1 % tile == 0 and -(-k // n_bound) <= 32
            assert topk.pow2_at_least(n_splits) * lp * 8 <= topk.K5_MERGE_SMEM
        else:
            assert split1 == 0
        per_row = 8 * n_splits * lp + (4 * n_splits + 8 * n_bound if k > 32 else 0) + (
            4 * -(-n_items // 32) if excl else 0)
        assert rows == 32 or rows * per_row <= topk.K5_WORKSPACE
