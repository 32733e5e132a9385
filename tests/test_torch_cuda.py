"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a GPU (decided in the fixture, not
at import). This file imports neither JAX nor the JAX package, so on a
machine without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: rel 1e-4 for K1-K3 (float32, another summation order); K5 is
exact, ties included (the kernel and its plain version round the same
products in the same order).
"""

import numpy as np
import pytest
import torch

from albedo_tpu_torch import kernels
from albedo_tpu_torch.ops import als as ops_als
from albedo_tpu_torch.ops import topk as ops_topk

pytestmark = pytest.mark.cuda
REL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bucket(dev, k, b=40, length=37, n_source=200, n_pad=5, seed=0):
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32)
    lens = rng.integers(1, length + 1, size=b)
    lens[b - n_pad:] = 0
    mask = np.arange(length)[None, :] < lens[:, None]
    idx = np.where(mask, rng.integers(0, n_source, size=(b, length)), 0).astype(np.int32)
    val = np.where(mask, rng.uniform(0.5, 1.5, size=(b, length)), 0).astype(np.float32)
    x0 = (rng.standard_normal((b, k)) * 0.1).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in (src, idx, val, mask, x0)]


def _close(got, want):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= REL * max(scale, 1e-30)


@pytest.mark.parametrize("k", [16, 50])
def test_k1_k2_k3_match_plain(dev, k):
    src, idx, val, mask, x0 = _bucket(dev, k)
    yty = ops_als.gramian(src)
    kernels.reset_launches()
    corr, b_vec = ops_als.bucket_partial_terms(src, idx, val, mask, 40.0)
    corr_p, b_p = ops_als.bucket_partial_terms_reference(src, idx, val, mask, 40.0)
    _close(corr, corr_p)
    _close(b_vec, b_p)
    n_b = mask.sum(dim=1, dtype=torch.float32)
    _close(ops_als.solve_corrected(yty, corr_p, b_p, n_b, 0.5),
           ops_als.solve_corrected_reference(yty, corr_p, b_p, n_b, 0.5))
    _close(ops_als.bucket_cg_body(src, yty, idx, val, mask, x0, 0.5, 40.0, 3),
           ops_als.bucket_cg_reference(src, yty, idx, val, mask, x0, 0.5, 40.0, 3))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["als_partials"] == 1
    assert kernels.LAUNCHES["solve_corrected"] == 1
    assert kernels.LAUNCHES["bucket_cg"] == 1


@pytest.mark.parametrize("with_exclusions", [True, False])
def test_k5_matches_plain_exactly(dev, with_exclusions):
    # Without exclusions the kernel takes a null list (the job's
    # ``ALSRecommender(exclude_seen=False)`` path).
    rng = np.random.default_rng(1)
    uf = torch.as_tensor((rng.standard_normal((64, 50)) / 7).astype(np.float32), device=dev)
    vf_np = (rng.standard_normal((3001, 50)) / 7).astype(np.float32)
    vf_np[2000:2100] = vf_np[:100]
    vf = torch.as_tensor(vf_np, device=dev)
    ex = None
    if with_exclusions:
        ex_np = np.full((64, 90), -1, dtype=np.int32)
        ex_np[:, :70] = rng.integers(0, 3001, size=(64, 70))
        ex = torch.as_tensor(ex_np, device=dev)
    kernels.reset_launches()
    s, i = ops_topk.topk_scores(uf, vf, 30, ex)
    s_p, i_p = ops_topk.topk_scores_reference(uf, vf, 30, ex)
    assert torch.equal(i, i_p) and torch.equal(s, s_p)
    assert kernels.LAUNCHES["topk_scores"] == 1


@pytest.mark.parametrize("solver, iters", [("cholesky", 3), ("cg", 1)])
def test_fit_on_the_card_matches_the_cpu(dev, solver, iters):
    # The whole resident fit (every bucket group, both half-sweeps, the
    # landing) from one numpy init, on the card and on the CPU, atol 1e-4.
    # CG runs one iteration: unconverged CG carries round-off from sweep to
    # sweep, so longer CG fits are compared by NDCG, not by factors.
    from albedo_tpu_torch.datasets.synthetic import synthetic_stars
    from albedo_tpu_torch.models.als import ImplicitALS

    m = synthetic_stars(400, 300, mean_stars=20, seed=3)
    rng = np.random.default_rng(7)
    init = tuple((rng.standard_normal((n, 16)) / 4).astype(np.float32) for n in (m.n_users, m.n_items))
    models = {
        d: ImplicitALS(rank=16, max_iter=iters, solver=solver, init_factors=init, device=d).fit(m)
        for d in (dev, "cpu")
    }
    np.testing.assert_allclose(models[dev].user_factors, models["cpu"].user_factors, atol=1e-4)
    np.testing.assert_allclose(models[dev].item_factors, models["cpu"].item_factors, atol=1e-4)


def test_cuda_wrappers_raise_instead_of_falling_back(dev):
    src, idx, val, mask, _ = _bucket(dev, 8)
    with pytest.raises(ValueError, match="dtype"):
        ops_als.bucket_partial_terms(src, idx.long(), val, mask, 40.0)
    with pytest.raises(ValueError, match="ranks"):
        ops_als.bucket_partial_terms(torch.zeros((5, 65), device=dev), idx, val, mask, 40.0)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        ops_als.bucket_partial_terms(src.cpu(), idx, val, mask, 40.0)
