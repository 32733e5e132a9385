"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a GPU (decided in the fixture, not
at import). This file imports neither JAX nor the JAX package, so on a
machine without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: rel 1e-4 for K1-K3 (float32, another summation order); K5 is
exact, ties included (the kernel and its plain version round the same
products in the same order); K8 1e-5 of each segment's L1 mass
sum |x[idx] val| (a warp sums in another order than ``index_add_``'s
atomics, and both round-offs grow with the segment's length and mass);
K9 5e-5 of each gradient element's L1 mass (``ops.sgns.sgns_grad_mass``;
its atomics add duplicate rows in an order that changes between runs) and
of |loss|; Adam 1e-6 of max |plain| of each table. K5's wide path (ranks
above 64) and K11's masked_topk are exact, ties included; K11's spmm_rows is
held to 1e-6 of each element's L1 mass (kernel and plain version both sum in
float64, in other orders, and round once) and K10's bpr_step to 5e-5 of
``ops.bpr.bpr_grad_mass`` and of |loss| (atomics, as K9). No tolerance has a floor, so the small gradients
are held as tightly as the tables. K5 at k > 128, K6 gather_topk and K7
bank_query are exact, ties and (-inf, -1) slots included (K5's arithmetic),
and a K6 row equals K5 on that user alone. K5's split design is exact too,
NaN scores included (``lax.top_k``'s order, which the plain version follows:
+NaN first, -NaN never). K1-K3's wide paths
(ranks above 64) are held as the narrow ones (rel 1e-4); K5-K7's select path
(k above 512, exclusion rows longer than the streaming body sorts) exactly.
K8c's forward exactly (the plain version's order) and its gradients to 1e-5
of each entry's mass (K8 sums in another order than the plain autograd);
K12's count and max exactly and its rms to 1e-6 relative (float64 sums in
another order, rounded once to float32), repeating bit for bit. K8g and
K8c-g (K8 and K8c over a leading grid axis): each row equal to K8 or K8c on
that row bit for bit (G = 1 included), and to the plain version as K8 and
K8c are. K4's land_rows and scatter_rows move rows: exact. K1-bf16 (bf16
gathers) is held as K1 (rel 1e-4: its products are exact in float32, the
order of the sums differs), K3-bf16 to rel 5e-4 (a float32 round-off in
another order can flip one rounding of its bf16 iterate; see
``chip_smoke.BF16_REL``); K9s (the shared negative pool) as K9, to 5e-5 of
``ops.sgns.sgns_shared_grad_mass`` and of |loss| at its batch of 4096.
"""

import numpy as np
import pytest
import torch

from albedo_tpu_torch import kernels
from albedo_tpu_torch.ops import als as ops_als
from albedo_tpu_torch.ops import bpr as ops_bpr
from albedo_tpu_torch.ops import sgns as ops_sgns
from albedo_tpu_torch.ops import spmm as ops_spmm
from albedo_tpu_torch.ops import sparse_linear as ops_sl
from albedo_tpu_torch.ops import topk as ops_topk

pytestmark = pytest.mark.cuda
REL = 1e-4
K3_BF16_REL = 5e-4  # a float32 round-off can flip one of K3-bf16's bf16 roundings (chip_smoke.BF16_REL)
K9_MASS, ADAM_REL = 5e-5, 1e-6


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


def _close(got, want, rel=REL):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= rel * max(scale, 1e-30)


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
    with pytest.raises(ValueError, match="ranks"):  # every rank >= 1 runs (wide path above 64)
        ops_als.bucket_partial_terms(torch.zeros((5, 0), device=dev), idx, val, mask, 40.0)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        ops_als.bucket_partial_terms(src.cpu(), idx, val, mask, 40.0)


@pytest.mark.parametrize("with_val", [True, False])
def test_k8_segment_dot_matches_plain(dev, with_val):
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 40, size=3000)
    counts[::7] = 0                # empty segments
    counts[5] = 20000              # one long (power-law head) segment
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nnz = int(indptr[-1])
    x = torch.as_tensor(rng.normal(size=500).astype(np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, 500, size=nnz).astype(np.int32), device=dev)
    val = torch.as_tensor(rng.normal(size=nnz).astype(np.float32), device=dev) if with_val else None
    ip = torch.as_tensor(indptr, device=dev)
    kernels.reset_launches()
    got = ops_sl.segment_dot(x, idx, val, ip)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["segment_dot"] == 1
    want = ops_sl.segment_dot_reference(x, idx, val, ip)
    mass = ops_sl.segment_dot_reference(x.abs(), idx, None if val is None else val.abs(), ip)
    assert bool(((got - want).abs() <= 1e-5 * mass).all())
    assert float(got[0].abs()) == 0.0  # counts[0] == 0: an empty segment


def test_k8_autograd_terms_match_plain(dev):
    # _bag_term forward and backward on the card against the same terms on the CPU.
    rng = np.random.default_rng(3)
    n, v = 400, 50
    rows = np.sort(rng.integers(0, n, size=2000))
    vocab = rng.integers(0, v - 5, size=2000).astype(np.int32)   # a zero-count vocab tail
    vals = rng.normal(size=2000).astype(np.float32)
    order = np.argsort(vocab, kind="stable")
    r_ip = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))]).astype(np.int32)
    v_ip = np.concatenate([[0], np.cumsum(np.bincount(vocab, minlength=v))]).astype(np.int32)
    arrays = [vocab, vals, r_ip, rows[order].astype(np.int32), vals[order], v_ip]
    w = rng.normal(size=v).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        wt = torch.tensor(w, device=d, requires_grad=True)
        y = ops_sl._bag_term(wt, *(torch.as_tensor(a, device=d) for a in arrays))
        y.backward(torch.as_tensor(g, device=d))
        out[d.type] = (y.detach().cpu(), wt.grad.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):  # segments of <= ~100 entries
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.parametrize("b,d", [(1, 8), (4096, 200), (300, 8)])
def test_k9_sgns_step_matches_plain(dev, b, d):
    rng = np.random.default_rng(4)
    v, k = 146, 5
    in_t = torch.as_tensor(rng.uniform(-0.5 / d, 0.5 / d, size=(v, d)).astype(np.float32), device=dev)
    out_t = torch.as_tensor(rng.normal(scale=0.1, size=(v, d)).astype(np.float32), device=dev)
    c = rng.integers(0, v, size=b).astype(np.int32)
    c[: b // 3] = 1                 # duplicate centers
    neg = rng.integers(0, v, size=(b, k)).astype(np.int32)
    neg[:, 0] = 0                   # duplicate negatives
    args = [torch.as_tensor(a, device=dev) for a in (c, rng.integers(0, v, size=b).astype(np.int32), neg)]
    res = {}
    for name, fn in (("kernel", ops_sgns.sgns_step), ("plain", ops_sgns.sgns_step_reference)):
        gi, go = torch.zeros_like(in_t), torch.zeros_like(out_t)
        loss = torch.zeros(1, device=dev)
        kernels.reset_launches()
        fn(in_t, out_t, *args, gi, go, loss)
        torch.cuda.synchronize()
        res[name] = (gi, go, loss)
        if name == "kernel":
            assert kernels.LAUNCHES["sgns_step"] == 1
    mass = ops_sgns.sgns_grad_mass(in_t, out_t, *args)
    for a, e, m in zip(res["kernel"], res["plain"], mass):
        assert bool(((a - e).abs() <= K9_MASS * m).all())
    assert float((res["kernel"][2] - res["plain"][2]).abs()) <= K9_MASS * float(res["plain"][2].abs())


@pytest.mark.parametrize("count", [1, 1000])
def test_adam_dense_matches_plain(dev, count):
    rng = np.random.default_rng(5)
    shape = (2, 146, 200)  # the "in" and "out" tables, updated by one launch
    base = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    base.append(np.abs(rng.normal(size=shape)).astype(np.float32) * 1e-3)  # v >= 0
    res = {}
    for name, fn in (("kernel", ops_sgns.adam_dense), ("plain", ops_sgns.adam_dense_reference)):
        p, g, m, v = (torch.as_tensor(a.copy(), device=dev) for a in base)
        kernels.reset_launches()
        fn(p, g, m, v, count, 0.025)
        torch.cuda.synchronize()
        res[name] = (p, g, m, v)
        if name == "kernel":
            assert kernels.LAUNCHES["adam_dense"] == 1
    for a, e in zip(res["kernel"], res["plain"]):
        assert float((a - e).abs().max()) <= ADAM_REL * float(e.abs().max())
    assert float(res["kernel"][1].abs().max()) == 0.0


def test_ranker_kernels_raise_instead_of_falling_back(dev):
    x = torch.zeros(10, device=dev)
    ip = torch.zeros(3, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        ops_sl.segment_dot(x, torch.zeros(0, dtype=torch.int64, device=dev), None, ip)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        ops_sl.segment_dot(x.cpu(), torch.zeros(0, dtype=torch.int32, device=dev), None, ip)
    t = torch.zeros((4, 600), device=dev)
    i32 = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dims"):
        ops_sgns.sgns_step(t, t, i32, i32, torch.zeros((2, 5), dtype=torch.int32, device=dev),
                           t, t, torch.zeros(1, device=dev))
    p = torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="shape"):
        ops_sgns.adam_dense(p, torch.zeros(9, device=dev), p.clone(), p.clone(), 1, 0.025)


@pytest.mark.parametrize("r", [65, 200, 3010])
def test_k5_wide_path_matches_plain_exactly(dev, r):
    rng = np.random.default_rng(r)
    uf_np = (rng.standard_normal((20, r)) / np.sqrt(r)).astype(np.float32)
    uf_np[0] = 0.0                                   # a row of ties
    vf_np = (rng.standard_normal((1300, r)) / np.sqrt(r)).astype(np.float32)
    vf_np[900:950] = vf_np[:50]                      # exact ties
    ex_np = np.full((20, 40), -1, dtype=np.int32)
    ex_np[:, :30] = rng.integers(0, 1300, size=(20, 30))
    uf, vf, ex = (torch.as_tensor(a, device=dev) for a in (uf_np, vf_np, ex_np))
    kernels.reset_launches()
    s, i = ops_topk.topk_scores(uf, vf, 30, ex)
    s_p, i_p = ops_topk.topk_scores_reference(uf, vf, 30, ex)
    assert torch.equal(i, i_p) and torch.equal(s, s_p)
    assert kernels.LAUNCHES["topk_scores_wide"] == 1 and kernels.LAUNCHES["topk_scores"] == 0


def _k5_same(got, want):
    from albedo_tpu_torch.kernels.topk_bench import same

    assert same(torch, got, want)


@pytest.mark.parametrize("n_rows", [1, 500])
@pytest.mark.parametrize("k", [1, 30, 128, 129, 512])
@pytest.mark.parametrize("r", [1, 50, 64, 65, 200, 3010])
def test_k5_split_design_matches_plain(dev, r, k, n_rows):
    """K5's split design at each rank path and list size, on one query row
    (its parallelism from the item splits alone) and on 500: exact against
    the plain version with ties planted across every 32-item boundary and
    the 1024 mark, and exclusion rows with -1, out-of-range entries and
    duplicates; one launch a call; two calls bit-identical."""
    rng = np.random.default_rng(1000 * r + k)
    n_items = 2500
    vf_np = (rng.standard_normal((n_items, r)) / np.sqrt(r)).astype(np.float32)
    vf_np[32::32] = vf_np[31:-1:32][: len(vf_np[32::32])]
    vf_np[1024:1124] = vf_np[:100]
    uf_np = (rng.standard_normal((n_rows, r)) / np.sqrt(r)).astype(np.float32)
    ex_np = rng.integers(-3, n_items + 3, size=(n_rows, 150)).astype(np.int32)
    ex_np[:, 1] = ex_np[:, 0]
    uf, vf, ex = (torch.as_tensor(a, device=dev) for a in (uf_np, vf_np, ex_np))
    kernels.reset_launches()
    got = ops_topk.topk_scores(uf, vf, k, ex)
    counts = kernels.launch_counts()
    assert counts["topk_scores" if r <= 64 else "topk_scores_wide"] == 1 and sum(counts.values()) == 1
    _k5_same(got, ops_topk.topk_scores(uf, vf, k, ex))
    _k5_same(got, ops_topk.topk_scores_reference(uf, vf, k, ex))


def test_k5_edge_cases_match_plain(dev):
    """``topk_bench.k5_edge_cases``: ties across boundaries, a row of zeros,
    cancelling, NaN and +-inf scores, odd exclusion rows, a row excluding
    every item, fewer admissible items than k, ranks 1 to 3010."""
    from albedo_tpu_torch.kernels.topk_bench import k5_edge_cases, same

    for label, u, v, k, ex in k5_edge_cases():
        q_t, v_t = torch.as_tensor(u, device=dev), torch.as_tensor(v, device=dev)
        ex_t = None if ex is None else torch.as_tensor(ex, device=dev)
        got = ops_topk.topk_scores(q_t, v_t, k, ex_t)
        assert same(torch, got, ops_topk.topk_scores_reference(q_t, v_t, k, ex_t)), label


@pytest.mark.parametrize("k", [30, 512])
def test_k5_passes_of_rows_match_plain(dev, monkeypatch, k):
    """With the workspace budget cut to nothing, 500 rows run in 16 passes
    of 32 inside the one launch call, still exact."""
    monkeypatch.setattr(ops_topk, "K5_WORKSPACE", 1)
    rng = np.random.default_rng(k)
    uf = torch.as_tensor((rng.standard_normal((500, 50)) / 7).astype(np.float32), device=dev)
    vf = torch.as_tensor((rng.standard_normal((19991, 50)) / 7).astype(np.float32), device=dev)
    ex = torch.as_tensor(rng.integers(-1, 19991, size=(500, 700)).astype(np.int32), device=dev)
    assert ops_topk._k5_plan(500, 19991, k, True, 132)[3] == 32
    kernels.reset_launches()
    got = ops_topk.topk_scores(uf, vf, k, ex)
    assert kernels.LAUNCHES["topk_scores"] == 1
    _k5_same(got, ops_topk.topk_scores_reference(uf, vf, k, ex))


@pytest.mark.parametrize("b", [1, 256, 300])
@pytest.mark.parametrize("with_val", [True, False])
def test_k11_spmm_rows_matches_plain(dev, b, with_val):
    rng = np.random.default_rng(b)
    counts = rng.integers(0, 30, size=2000)
    counts[::5] = 0                  # empty rows
    counts[3] = 1089                 # a long (power-law head) row
    indptr = np.concatenate([[0], np.cumsum(counts)])
    idx = rng.integers(0, 2936, size=int(indptr[-1]))
    val = rng.uniform(0.1, 1.0, size=idx.size).astype(np.float32) if with_val else None
    w = ops_spmm.CSR.from_host(indptr, idx, val, 2936, dev)
    x = torch.as_tensor(rng.uniform(size=(2936, b)).astype(np.float32), device=dev)
    kernels.reset_launches()
    got = ops_spmm.spmm_rows(w, x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["spmm_rows"] == 1
    want = ops_spmm.spmm_rows_reference(w, x)
    mass = ops_spmm.spmm_rows_mass(w, x)
    assert bool(((got - want).abs() <= 1e-6 * mass).all())
    assert float(got[0].abs().max()) == 0.0      # counts[0] == 0: an empty row


@pytest.mark.parametrize("with_norm", [True, False])
def test_k11_masked_topk_matches_plain_exactly(dev, with_norm):
    rng = np.random.default_rng(6)
    scores = rng.normal(size=(2936, 40)).astype(np.float32)   # (n, B): taken as a strided (B, n) view
    scores[1500:1600] = scores[:100]                          # ties
    scores[:, 2] = 0.25                                       # a row of ties
    starred = np.full((40, 64), -1, np.int32)
    starred[:, :50] = rng.integers(0, 2936, size=(40, 50))
    norm = torch.as_tensor(rng.uniform(0.0, 3.0, size=2936).astype(np.float32), device=dev) if with_norm else None
    block = torch.as_tensor(scores, device=dev).t()
    st = torch.as_tensor(starred, device=dev)
    kernels.reset_launches()
    s, i = ops_spmm.masked_topk(block, st, 30, norm)
    s_p, i_p = ops_spmm.masked_topk_reference(block, st, 30, norm)
    assert torch.equal(i, i_p) and torch.equal(s, s_p)
    assert kernels.LAUNCHES["masked_topk"] == 1


@pytest.mark.parametrize("b", [1, 8192])
def test_k10_bpr_step_matches_plain(dev, b):
    rng = np.random.default_rng(b)
    n_users, n_items, r, d = 300, 200, 32, 2
    params = [torch.as_tensor(rng.normal(scale=0.1, size=s).astype(np.float32), device=dev)
              for s in ((n_users, r), (n_items, r), (n_items,), (d,))]
    g = torch.as_tensor(rng.normal(size=(n_items, d)).astype(np.float32), device=dev)
    users = rng.integers(0, n_users, size=b).astype(np.int32)
    users[: b // 3] = 7                       # a hot user
    pos = rng.integers(0, n_items, size=b).astype(np.int32)
    neg = rng.integers(0, n_items, size=(b, 4)).astype(np.int32)
    neg[::2, 1] = pos[::2]                    # negatives equal to the positive
    batch = [torch.as_tensor(a, device=dev) for a in (users, pos, neg)]
    res = {}
    for name, fn in (("kernel", ops_bpr.bpr_step), ("plain", ops_bpr.bpr_step_reference)):
        grads = [torch.zeros_like(p) for p in params]
        loss = torch.zeros(1, device=dev)
        kernels.reset_launches()
        fn(*params, g, *batch, *grads, loss, 1e-4)
        torch.cuda.synchronize()
        res[name] = (*grads, loss)
        if name == "kernel":
            assert kernels.LAUNCHES["bpr_step"] == 1
    mass = ops_bpr.bpr_grad_mass(*params, g, *batch, 1e-4)
    for a, e, m in zip(res["kernel"], res["plain"], mass):
        assert bool(((a - e).abs() <= K9_MASS * m).all())
    assert float((res["kernel"][4] - res["plain"][4]).abs()) <= K9_MASS * float(res["plain"][4].abs())


def test_cf_on_the_card_matches_the_cpu(dev):
    # Both CFs end to end (every spmm_rows pass and masked_topk) on the card
    # and on the CPU: the same candidates, scores within rtol 2e-4, atol 2e-5.
    from albedo_tpu_torch.datasets.synthetic import synthetic_stars
    from albedo_tpu_torch.recommenders.cf import ItemCFRecommender, UserCFRecommender

    m = synthetic_stars(n_users=400, n_items=300, mean_stars=20, seed=3)
    for cls in (ItemCFRecommender, UserCFRecommender):
        frames = {d: cls(m, top_k=30, device=d).recommend_for_users(m.user_ids) for d in (dev, "cpu")}
        a, b = frames[dev], frames["cpu"]
        assert len(a) == len(b)
        merged = a.merge(b, on=["user_id", "repo_id"], suffixes=("_card", "_cpu"))
        assert len(merged) >= 0.99 * len(b)      # near-ties at the cut may swap
        np.testing.assert_allclose(merged["score_card"], merged["score_cpu"], rtol=2e-4, atol=2e-5)


def test_candidate_kernels_raise_instead_of_falling_back(dev):
    w = ops_spmm.CSR.from_host(np.array([0, 1]), np.array([0]), None, 3, dev)
    with pytest.raises(ValueError, match="shape"):
        ops_spmm.spmm_rows(w, torch.zeros((4, 2), device=dev))
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        ops_spmm.spmm_rows(w, torch.zeros((3, 2)))
    with pytest.raises(ValueError, match="k in"):  # k past the kernel's KMAX (512 since K5's k <= 512)
        ops_spmm.masked_topk(torch.zeros((2, 5), device=dev), None, ops_topk.KMAX + 1)
    p = [torch.zeros(s, device=dev) for s in ((4, 200), (5, 200), (5,), (1,))]
    i32 = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="ranks"):
        ops_bpr.bpr_step(*p, torch.zeros((5, 1), device=dev), i32, i32,
                         torch.zeros((2, 4), dtype=torch.int32, device=dev),
                         *[torch.zeros_like(t) for t in p], torch.zeros(1, device=dev), 1e-4)


@pytest.mark.parametrize("k", [129, 256, 512])
def test_k5_wide_k_matches_plain_exactly(dev, k):
    rng = np.random.default_rng(k)
    uf = torch.as_tensor((rng.standard_normal((17, 50)) / 7).astype(np.float32), device=dev)
    vf_np = (rng.standard_normal((2936, 50)) / 7).astype(np.float32)
    vf_np[2000:2100] = vf_np[:100]                   # exact ties
    vf = torch.as_tensor(vf_np, device=dev)
    ex = torch.as_tensor(rng.integers(-1, 2936, size=(17, 300)).astype(np.int32), device=dev)
    for items, excl in ((vf, ex), (vf[:600], ex.clamp(max=599))):   # fewer admissible than k
        s, i = ops_topk.topk_scores(uf, items, k, excl)
        s_p, i_p = ops_topk.topk_scores_reference(uf, items, k, excl)
        assert torch.equal(i, i_p) and torch.equal(s, s_p)


@pytest.mark.parametrize("mode", ["device", "host", "none"])
@pytest.mark.parametrize("bucket", [1, 8, 64])
def test_k6_gather_topk_matches_plain_and_k5(dev, mode, bucket):
    rng = np.random.default_rng(bucket)
    uf_all = torch.as_tensor((rng.standard_normal((300, 50)) / 7).astype(np.float32), device=dev)
    vf = torch.as_tensor((rng.standard_normal((2936, 50)) / 7).astype(np.float32), device=dev)
    table_np = np.full((300, 400), -1, dtype=np.int32)
    for u in range(300):
        n = int(rng.integers(0, 400))
        table_np[u, :n] = rng.choice(2936, size=n, replace=False)
    ui_np = rng.integers(0, 300, size=bucket).astype(np.int32)
    ui = torch.as_tensor(ui_np, device=dev)
    kw = ({"exclude_table": torch.as_tensor(table_np, device=dev)} if mode == "device"
          else {"exclude": torch.as_tensor(table_np[ui_np], device=dev)} if mode == "host" else {})
    for k in (32, 512):
        kernels.reset_launches()
        s, i = ops_topk.gather_topk(uf_all, vf, ui, k, **kw)
        assert kernels.LAUNCHES["gather_topk"] == 1
        s_p, i_p = ops_topk.gather_topk_reference(uf_all, vf, ui, k, **kw)
        assert torch.equal(i, i_p) and torch.equal(s, s_p)
        one = None if mode == "none" else torch.as_tensor(table_np[ui_np[-1:]], device=dev)
        s1, i1 = ops_topk.topk_scores(uf_all[ui[-1:].long()].contiguous(), vf, k, one)
        assert torch.equal(i[-1:], i1) and torch.equal(s[-1:], s1)


@pytest.mark.parametrize("d", [16, 50, 200, 3010])
def test_k7_bank_query_matches_plain_exactly(dev, d):
    rng = np.random.default_rng(d)
    vf = torch.as_tensor(np.abs(rng.standard_normal((2936, d))).astype(np.float32), device=dev)
    q = np.full((64, 32), -1, dtype=np.int32)
    for b in range(1, 64):
        n = int(rng.integers(1, 31))
        q[b, :n] = rng.integers(0, 2936, size=n)
    q_t = torch.as_tensor(q, device=dev)
    kernels.reset_launches()
    got = ops_topk.bank_query(vf, 30, q_idx=q_t)
    assert kernels.LAUNCHES["bank_query"] == 1
    want = ops_topk.bank_query_reference(vf, 30, q_idx=q_t)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert bool((got[1][0] == -1).all())             # the row with no query
    users = torch.as_tensor(rng.standard_normal((100, d)).astype(np.float32), device=dev)
    ui = torch.as_tensor(rng.integers(0, 100, size=64).astype(np.int32), device=dev)
    table = torch.as_tensor(rng.integers(-1, 2936, size=(100, 50)).astype(np.int32), device=dev)
    emap_np = rng.permutation(2936).astype(np.int32)
    emap_np[::5] = -1
    emap = torch.as_tensor(emap_np, device=dev)
    for kw in ({}, {"exclude_table": table}, {"exclude_table": table, "excl_map": emap}):
        got = ops_topk.bank_query(vf, 30, users=users, user_idx=ui, **kw)
        want = ops_topk.bank_query_reference(vf, 30, users=users, user_idx=ui, **kw)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


# ---- K1-K3 wide paths, the K5-K7 select path, K8c, K12 ------------------


@pytest.mark.parametrize("k", [65, 100, 256])
def test_k1_k2_k3_wide_paths_match_plain(dev, k):
    """Ranks above 64: K1 tiles the correction over CTAs, K2/K3 keep the
    system in dynamic shared memory (k 65, 100) or a global workspace (K2 at
    256); rel 1e-4 as the narrow paths."""
    src, idx, val, mask, x0 = _bucket(dev, k, length=300)
    yty = ops_als.gramian(src)
    kernels.reset_launches()
    corr, b_vec = ops_als.bucket_partial_terms(src, idx, val, mask, 40.0)
    corr_p, b_p = ops_als.bucket_partial_terms_reference(src, idx, val, mask, 40.0)
    _close(corr, corr_p)
    _close(b_vec, b_p)
    n_b = mask.sum(dim=1, dtype=torch.float32)
    live = n_b > 0
    _close(ops_als.solve_corrected(yty, corr_p, b_p, n_b, 0.5)[live],
           ops_als.solve_corrected_reference(yty, corr_p, b_p, n_b, 0.5)[live])
    _close(ops_als.bucket_cg_body(src, yty, idx, val, mask, x0, 0.5, 40.0, 3),
           ops_als.bucket_cg_reference(src, yty, idx, val, mask, x0, 0.5, 40.0, 3))
    for name in ("als_partials_wide", "solve_corrected_wide", "bucket_cg_wide"):
        assert kernels.LAUNCHES[name] >= 1


@pytest.mark.parametrize("k", [8, 50, 65, 256])
def test_k1_k3_bf16_match_plain(dev, k):
    """K1-bf16 and K3-bf16 at ranks on both sides of 64, with the plain
    versions' bf16 rounding sites; only the bf16 entries launch."""
    src, idx, val, mask, x0 = _bucket(dev, k, length=300)
    yty = ops_als.gramian(src)
    kernels.reset_launches()
    corr, b_vec = ops_als.bucket_partial_terms(src, idx, val, mask, 40.0, "bfloat16")
    corr_p, b_p = ops_als.bucket_partial_terms_reference(src, idx, val, mask, 40.0, "bfloat16")
    _close(corr, corr_p)
    _close(b_vec, b_p)
    _close(ops_als.bucket_cg_body(src, yty, idx, val, mask, x0, 0.5, 40.0, 3, gather_dtype="bfloat16"),
           ops_als.bucket_cg_reference(src, yty, idx, val, mask, x0, 0.5, 40.0, 3, "bfloat16"), K3_BF16_REL)
    torch.cuda.synchronize()
    path = "" if k <= 64 else "_wide"
    assert kernels.LAUNCHES[f"als_partials_bf16{path}"] == 1
    assert kernels.LAUNCHES[f"bucket_cg_bf16{path}"] == 1
    assert kernels.LAUNCHES["als_partials"] == kernels.LAUNCHES["bucket_cg"] == 0


@pytest.mark.parametrize("b,d,k", [(1, 8, 1), (7, 8, 32), (4096, 200, 512)])
def test_k9s_sgns_shared_matches_plain(dev, b, d, k):
    rng = np.random.default_rng(4)
    v = 146
    in_t = torch.as_tensor(rng.uniform(-0.5 / d, 0.5 / d, size=(v, d)).astype(np.float32), device=dev)
    out_t = torch.as_tensor(rng.normal(scale=0.1, size=(v, d)).astype(np.float32), device=dev)
    c = rng.integers(0, v, size=b).astype(np.int32)
    c[: b // 3] = 1                 # duplicate centers
    o = rng.integers(0, v, size=b).astype(np.int32)
    pool = rng.integers(0, v, size=k).astype(np.int32)
    pool[: k // 2] = 0              # repeated pool slots
    pool[-1] = o[0]                 # a pool word that is also a context
    args = [torch.as_tensor(a, device=dev) for a in (c, o, pool)]
    res = {}
    for name, fn in (("kernel", ops_sgns.sgns_shared_step), ("plain", ops_sgns.sgns_shared_step_reference)):
        gi, go = torch.zeros_like(in_t), torch.zeros_like(out_t)
        loss = torch.zeros(1, device=dev)
        kernels.reset_launches()
        fn(in_t, out_t, *args, gi, go, loss, 5 / k)
        torch.cuda.synchronize()
        res[name] = (gi, go, loss)
        if name == "kernel":
            assert kernels.LAUNCHES["sgns_shared"] == 1
    mass = ops_sgns.sgns_shared_grad_mass(in_t, out_t, *args, 5 / k)
    for a, e, m in zip(res["kernel"], res["plain"], mass):
        assert bool(((a - e).abs() <= K9_MASS * m).all())
    assert float((res["kernel"][2] - res["plain"][2]).abs()) <= K9_MASS * float(res["plain"][2].abs())


@pytest.mark.parametrize("k", [513, 600, 2048])
def test_k5_k6_k7_select_path_matches_plain_exactly(dev, k):
    """k above 512 takes the select path behind each wrapper, exact
    against the plain version; a K6 row equals K5 on that user alone."""
    rng = np.random.default_rng(k)
    uf_all = torch.as_tensor((rng.standard_normal((300, 50)) / 7).astype(np.float32), device=dev)
    vf_np = (rng.standard_normal((2936, 50)) / 7).astype(np.float32)
    vf_np[2000:2100] = vf_np[:100]
    vf = torch.as_tensor(vf_np, device=dev)
    table = torch.as_tensor(rng.integers(-1, 2936, size=(300, 400)).astype(np.int32), device=dev)
    ui = torch.as_tensor(rng.integers(0, 300, size=8).astype(np.int32), device=dev)
    kernels.reset_launches()
    got = ops_topk.topk_scores(uf_all[:17].contiguous(), vf, k, table[:17].contiguous())
    want = ops_topk.topk_scores_reference(uf_all[:17].contiguous(), vf, k, table[:17].contiguous())
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    s, i = ops_topk.gather_topk(uf_all, vf, ui, k, exclude_table=table)
    s_p, i_p = ops_topk.gather_topk_reference(uf_all, vf, ui, k, exclude_table=table)
    assert torch.equal(i, i_p) and torch.equal(s, s_p)
    s1, i1 = ops_topk.topk_scores(uf_all[ui[:1].long()].contiguous(), vf, k, table[ui[:1].long()].contiguous())
    assert torch.equal(i[:1], i1) and torch.equal(s[:1], s1)
    got = ops_topk.bank_query(vf, k, users=uf_all, user_idx=ui, exclude_table=table)
    want = ops_topk.bank_query_reference(vf, k, users=uf_all, user_idx=ui, exclude_table=table)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    for name in ("topk_scores_select", "gather_topk_select", "bank_query_select"):
        assert kernels.LAUNCHES[name] >= 1


def test_k5_exclusion_rows_longer_than_the_streaming_body(dev):
    """A 40 000-entry exclusion row (over EXCLUDE_MAX) is answered."""
    rng = np.random.default_rng(4)
    uf = torch.as_tensor((rng.standard_normal((3, 50)) / 7).astype(np.float32), device=dev)
    vf = torch.as_tensor((rng.standard_normal((60000, 50)) / 7).astype(np.float32), device=dev)
    ex = torch.as_tensor(np.stack([rng.choice(60000, size=40000, replace=False) for _ in range(3)])
                         .astype(np.int32), device=dev)
    got = ops_topk.topk_scores(uf, vf, 30, ex)
    want = ops_topk.topk_scores_reference(uf, vf, 30, ex)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_k8c_gather_sum_forward_and_backward_match_plain(dev):
    """K8c: the forward exactly (the plain version's order), each table's
    gradient (K8 over the category-sorted rows) to 1e-5 of its mass."""
    rng = np.random.default_rng(8)
    n, sizes = 50_000, (1, 9, 3000, 40)
    base = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=dev)
    idxs = [torch.as_tensor(rng.integers(0, s, size=n).astype(np.int32), device=dev) for s in sizes]
    tabs = [torch.as_tensor(rng.normal(size=s).astype(np.float32), device=dev) for s in sizes]
    kernels.reset_launches()
    got = ops_sl.gather_sum(base, tabs, idxs)
    assert kernels.LAUNCHES["gather_sum"] == 1
    assert torch.equal(got, ops_sl.gather_sum_reference(base, tabs, idxs))
    g = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=dev)
    ts = [t.clone().requires_grad_(True) for t in tabs]
    ps = [t.clone().requires_grad_(True) for t in tabs]
    ops_sl._GatherSum.apply(base, (idxs, [None] * 4, [None] * 4), *ts).backward(g)
    ops_sl.gather_sum_reference(base, ps, idxs).backward(g)
    for t, p, idx in zip(ts, ps, idxs):
        mass = torch.zeros_like(p).index_add_(0, idx.long(), g.abs())
        assert float(((t.grad - p.grad).abs() / mass.clamp_min(1e-30)).max()) <= 1e-5


@pytest.mark.parametrize("plant", [None, float("nan"), float("inf"), float("-inf")])
def test_k12_factor_health_matches_plain(dev, plant):
    """K12: the count and max exactly, the rms to 1e-6 relative, the same
    bits on a second run (no atomics)."""
    from albedo_tpu_torch.utils import watchdog

    rng = np.random.default_rng(12)
    uf = torch.as_tensor(rng.standard_normal((30000, 50)).astype(np.float32), device=dev)
    vf = torch.as_tensor(rng.standard_normal((19991, 50)).astype(np.float32), device=dev)
    if plant is not None:
        uf.view(-1)[torch.as_tensor(rng.integers(0, uf.numel(), size=9), device=dev)] = plant
    kernels.reset_launches()
    got = watchdog.factor_health(uf, vf)
    assert kernels.LAUNCHES["factor_health"] == 1
    want = watchdog.factor_health_reference(uf, vf)
    assert torch.equal(got[:2], want[:2])
    assert abs(float(got[2]) - float(want[2])) <= 1e-6 * float(want[2])
    assert torch.equal(got, watchdog.factor_health(uf, vf))


@pytest.mark.parametrize("n_grid", [1, 5, 7, 9])
@pytest.mark.parametrize("with_val", [True, False])
def test_k8g_segment_dot_grid_matches_k8_rows_and_plain(dev, n_grid, with_val):
    """K8g: each row bit for bit K8 on that row; against the plain version
    to 1e-5 of each segment's mass. G = 9 takes two passes of 8 rows."""
    rng = np.random.default_rng(21)
    counts = rng.integers(0, 40, size=3000)
    counts[::7] = 0
    counts[5] = 20000
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nnz = int(indptr[-1])
    x = torch.as_tensor(rng.normal(size=(n_grid, 500)).astype(np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, 500, size=nnz).astype(np.int32), device=dev)
    val = torch.as_tensor(rng.normal(size=nnz).astype(np.float32), device=dev) if with_val else None
    ip = torch.as_tensor(indptr, device=dev)
    kernels.reset_launches()
    got = ops_sl.segment_dot(x, idx, val, ip)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["segment_dot_grid"] == 1 and kernels.LAUNCHES["segment_dot"] == 0
    assert got.shape == (n_grid, 3000)
    for g in range(n_grid):
        assert torch.equal(got[g], ops_sl.segment_dot(x[g].contiguous(), idx, val, ip))
    want = ops_sl.segment_dot_reference(x, idx, val, ip)
    mass = ops_sl.segment_dot_reference(x.abs(), idx, None if val is None else val.abs(), ip)
    assert bool(((got - want).abs() <= 1e-5 * mass).all())


@pytest.mark.parametrize("n_grid", [1, 5, 7, 9])
def test_k8cg_gather_sum_grid_matches_k8c_rows_and_plain(dev, n_grid):
    """K8c-g: exactly the plain version, and each row K8c on that row."""
    rng = np.random.default_rng(22)
    n, sizes = 50_000, (1, 9, 3000, 40)
    base = torch.as_tensor(rng.normal(size=(n_grid, n)).astype(np.float32), device=dev)
    idxs = [torch.as_tensor(rng.integers(0, s, size=n).astype(np.int32), device=dev) for s in sizes]
    tabs = [torch.as_tensor(rng.normal(size=(n_grid, s)).astype(np.float32), device=dev) for s in sizes]
    kernels.reset_launches()
    got = ops_sl.gather_sum(base, tabs, idxs)
    assert kernels.LAUNCHES["gather_sum_grid"] == 1 and kernels.LAUNCHES["gather_sum"] == 0
    assert torch.equal(got, ops_sl.gather_sum_reference(base, tabs, idxs))
    for g in range(n_grid):
        assert torch.equal(got[g], ops_sl.gather_sum(base[g].contiguous(), [t[g].contiguous() for t in tabs], idxs))


@pytest.mark.parametrize("k", [16, 50, 100])
def test_k4_land_rows_and_scatter_rows_exact(dev, k):
    """K4: land_rows equals ``cat(pool, target)[landing]`` and scatter_rows
    ``scatter_solved_reference`` exactly: -1 padding slots drop, rows in no
    bucket keep their old row."""
    rng = np.random.default_rng(23)
    n_target = 5000
    sizes = rng.integers(1, 60, size=70)
    n_slots = int(sizes.sum())
    row_ids = np.full(n_slots, -1, np.int32)
    live = rng.random(n_slots) < 0.8
    rows = rng.permutation(n_target)[: int(live.sum())].astype(np.int32)  # some rows in no bucket
    row_ids[live] = rows
    landing = np.arange(n_slots, n_slots + n_target, dtype=np.int64)
    landing[row_ids[live]] = np.flatnonzero(live)
    target = torch.as_tensor(rng.normal(size=(n_target, k)).astype(np.float32), device=dev)
    flat = torch.as_tensor(rng.normal(size=(n_slots, k)).astype(np.float32), device=dev)
    land = torch.as_tensor(landing, device=dev)
    kernels.reset_launches()
    got = ops_als.land_rows(target, flat, land)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["land_rows"] == 1
    assert torch.equal(got, ops_als.land_rows_reference(target, flat, land))
    ids = torch.as_tensor(row_ids, device=dev)
    sc = ops_als.scatter_solved(target, ids, flat)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scatter_rows"] == 1
    assert torch.equal(sc, ops_als.scatter_solved_reference(target, ids, flat))
    assert torch.equal(sc, got)


def test_grid_and_landing_kernels_raise_instead_of_falling_back(dev):
    x = torch.ones((2, 4), device=dev)
    with pytest.raises(ValueError, match="int32"):
        ops_sl.segment_dot(x, torch.zeros(3, dtype=torch.int64, device=dev), None,
                           torch.tensor([0, 3], dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="shape"):
        ops_sl.gather_sum(x, [torch.ones((3, 5), device=dev)], [torch.zeros(4, dtype=torch.int32, device=dev)])
    with pytest.raises(ValueError, match="int64"):
        ops_als.land_rows(torch.ones((3, 2), device=dev), torch.ones((1, 2), device=dev),
                          torch.zeros(3, dtype=torch.int32, device=dev))


# ------------------------------------------ K8/K8g: the merge-path partition

_STEPS = ops_sl.SEGMENT_DOT_STEPS


def ranker_skew_features(rng, n: int) -> dict:
    """FeatureMatrix arrays (keyword arguments) skewed as the ranker fit's
    batch: a ``cat:`` field whose 3 categories hold 80%, 15% and 5% of the
    rows (the category gradient's 3 segments, the longest 80% of the rows),
    one of 16 Zipf-sized categories, a per-row bag whose head token sits in
    90% of the rows, a factored bag whose head token is in most documents,
    and a factored vector field over Zipf-repeated distinct vectors. Shared
    with the CPU parity test (``test_torch_ops_sparse_linear.py``), so the
    card is held on the inputs the CPU suite holds against JAX."""
    def zipf(size, count, a=1.1):
        p = 1.0 / np.arange(1, size + 1) ** a
        return rng.choice(size, size=count, p=p / p.sum()).astype(np.int32)

    bag = np.where(rng.random((n, 4)) < 0.4, -1, zipf(30, 4 * n).reshape(n, 4)).astype(np.int32)
    bag[:, 0] = np.where(rng.random(n) < 0.9, 0, bag[:, 0])
    docs = np.where(rng.random((400, 6)) < 0.3, -1, zipf(25, 2400).reshape(400, 6)).astype(np.int32)
    docs[:, 0] = np.where(rng.random(400) < 0.85, 0, docs[:, 0])
    return dict(
        dense=rng.normal(size=(n, 3)).astype(np.float32),
        dense_names=["d0", "d1", "d2"] + [f"v[{i}]" for i in range(4)],
        cat={"c3": rng.choice(3, size=n, p=[0.8, 0.15, 0.05]).astype(np.int32), "c16": zipf(16, n)},
        cat_sizes={"c3": 3, "c16": 16},
        bag_idx={"b": bag, "f": docs},
        bag_val={"b": np.where(bag >= 0, rng.integers(1, 3, size=bag.shape), 0).astype(np.float32),
                 "f": np.where(docs >= 0, 1.0, 0.0).astype(np.float32)},
        bag_sizes={"b": 30, "f": 25},
        vec={"v": rng.normal(size=(500, 4)).astype(np.float32)},
        vec_rep={"v": zipf(500, n, a=0.8)},
        bag_rep={"f": zipf(400, n, a=0.8)},
    )


def _merge_counts(case: str) -> np.ndarray:
    """Segment lengths that put the partition's edges where they hurt."""
    rng = np.random.default_rng(41)
    if case == "one segment of 250000":
        return np.array([250_000])
    if case == "three segments over 250000":
        return np.array([206_705, 38_000, 5_295])
    if case == "a segment over many chunks":
        counts = rng.integers(0, 30, size=400)
        counts[200] = 40 * _STEPS + 17
        return counts
    if case == "lengths E-1, E, E+1 at chunk edges":
        # The first segment ends one step before the first chunk edge; the
        # others start and end at, before and after later edges.
        return np.array([_STEPS - 1, _STEPS - 1, _STEPS, _STEPS + 1, 0, _STEPS - 1, _STEPS, _STEPS + 1, 3, _STEPS])
    if case == "runs of empty segments across an edge":
        return np.array([_STEPS - 5] + [0] * 50 + [3] + [0] * 3000 + [2] + [0] * 700)
    if case == "no entries":
        return np.zeros(3000, np.int64)
    if case == "no segments":
        return np.zeros(0, np.int64)
    raise KeyError(case)


def _hold_merge(x, idx, val, ip) -> torch.Tensor:
    """K8 (1-D ``x``) or K8g (2-D): one counted launch; the same bits on a
    second call; within 1e-5 of each segment's mass of the plain version
    (computed in float64, so the plain version's own float32 atomics do not
    count) and within the kernel's order bound
    ``(min(L, 2) + 9 + [C > 1](ceil((C - 1) / 32) + 6)) 2^-24`` of it
    (``segment_dot.cu``); a K8g row equal to K8 on that row bit for bit."""
    name = "segment_dot_grid" if x.dim() == 2 else "segment_dot"
    kernels.reset_launches()
    got = ops_sl.segment_dot(x, idx, val, ip)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == 1 and sum(kernels.LAUNCHES.values()) == 1
    assert torch.equal(got, ops_sl.segment_dot(x, idx, val, ip))
    v64 = None if val is None else val.double()
    want = ops_sl.segment_dot_reference(x.double(), idx, v64, ip)
    mass = ops_sl.segment_dot_reference(x.double().abs(), idx, None if v64 is None else v64.abs(), ip)
    diff = (got.double() - want).abs()
    assert bool((diff <= 1e-5 * mass).all())
    seg = torch.arange(ip.shape[0] - 1, device=ip.device, dtype=torch.float64)
    lo, hi = ip[:-1].double(), ip[1:].double()
    chunks = torch.floor((seg + hi) / _STEPS) - torch.floor((seg + lo) / _STEPS) + 1
    depth = torch.clamp(hi - lo, max=ops_sl.SEGMENT_DOT_IPT) + 9 + (chunks > 1) * (torch.ceil((chunks - 1) / 32) + 6)
    assert bool((diff <= depth * 2.0**-24 * mass).all())
    if x.dim() == 2:
        for g in range(x.shape[0]):
            assert torch.equal(got[g], ops_sl.segment_dot(x[g].contiguous(), idx, val, ip))
    return got


@pytest.mark.parametrize("case", ["one segment of 250000", "three segments over 250000",
                                  "a segment over many chunks", "lengths E-1, E, E+1 at chunk edges",
                                  "runs of empty segments across an edge", "no entries", "no segments"])
@pytest.mark.parametrize("n_grid", [None, 1, 5, 7, 9])  # None: K8 on a 1-D x
@pytest.mark.parametrize("with_val", [True, False])
def test_k8_k8g_merge_partition_edges(dev, case, n_grid, with_val):
    rng = np.random.default_rng(42)
    counts = _merge_counts(case)
    ip = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32), device=dev)
    nnz, n_x = int(counts.sum()), 700
    x = torch.as_tensor(rng.normal(size=(n_x,) if n_grid is None else (n_grid, n_x)).astype(np.float32),
                        device=dev)
    idx = torch.as_tensor(rng.integers(0, n_x, size=nnz).astype(np.int32), device=dev)
    val = torch.as_tensor(rng.normal(size=nnz).astype(np.float32), device=dev) if with_val else None
    got = _hold_merge(x, idx, val, ip)
    assert got.shape == x.shape[:-1] + (counts.size,)
    assert bool((got[..., torch.as_tensor(counts == 0, device=dev)] == 0).all())


@pytest.mark.parametrize("n_grid", [None, 5])
def test_k8_k8g_on_the_ranker_skew(dev, n_grid):
    """Every K8 (or K8g) call of one forward and backward of the LR objective
    on ``ranker_skew_features`` at the fit's batch size (257 023 rows):
    each held as in ``_hold_merge``."""
    from albedo_tpu_torch.features.assembler import FeatureMatrix

    rng = np.random.default_rng(43)
    fm = FeatureMatrix(**ranker_skew_features(rng, 257_023))
    batch = ops_sl.feature_batch(fm, dev, grad_layout=True)
    scales = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
              for k, v in ops_sl.inverse_std_scales(fm).items()}
    shape = () if n_grid is None else (n_grid,)
    params = {k: torch.as_tensor(rng.normal(size=shape + np.shape(v)).astype(np.float32), device=dev)
              .requires_grad_(True) for k, v in ops_sl.init_params(fm).items()}
    y = torch.as_tensor((rng.random(fm.n_rows) < 0.3).astype(np.float32), device=dev)
    w = torch.as_tensor(rng.uniform(0.1, 1.0, size=shape + (fm.n_rows,)).astype(np.float32), device=dev)
    calls, orig = [], ops_sl.segment_dot

    def recording(x, idx, val, indptr):
        calls.append((x.detach().clone(), idx, val, indptr))
        return orig(x, idx, val, indptr)

    ops_sl.segment_dot = recording
    try:
        ops_sl.weighted_logloss(params, scales, batch, y, w, 0.7).sum().backward()
    finally:
        ops_sl.segment_dot = orig
    assert max(int((ip[1:] - ip[:-1]).max()) for _, _, _, ip in calls) > 0.75 * fm.n_rows
    for call in calls:
        _hold_merge(*call)
