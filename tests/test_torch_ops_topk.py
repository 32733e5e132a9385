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
