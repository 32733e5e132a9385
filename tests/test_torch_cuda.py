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
(ranks above 64: K1's split design in its wide kernel, K2's blocked
Cholesky, the tiled K1 above 512) are held as the narrow ones (rel 1e-4), K1
and K2 also for the same bits over ten calls; K5-K7's select path
(k above 512, exclusion rows longer than the streaming body sorts) exactly.
K8c's forward exactly (the plain version's order) and its gradients to 1e-5
of each entry's mass (K8 sums in another order than the plain autograd);
K12's count and max exactly and its rms to 1e-6 relative (float64 sums in
another order, rounded once to float32), repeating bit for bit. K8g and
K8c-g (K8 and K8c over a leading grid axis): each row equal to K8 or K8c on
that row bit for bit (G = 1 included), and to the plain version as K8 and
K8c are. K4's land_rows and scatter_rows move rows: exact. K1-bf16 (bf16
gathers) is held as K1 (rel 1e-4: its products are exact in float32, the
order of the sums differs), K3-bf16 row by row to the effects of the bf16
roundings its float32 round-off could flip plus that round-off, at least
rel 5e-4 of max |x| (a float32 round-off in another order can flip one
rounding of its bf16 iterate; ``ops.als.bucket_cg_bf16_limits``, F9); K9s (the shared negative
pool) as K9, to 5e-5 of ``ops.sgns.sgns_shared_grad_mass`` and of |loss| at
its batch of 4096, and against its plain version in float64, element by
element, to ten standard deviations of the round-off of its own summation
order and logits (``ops.sgns.sgns_shared_limits``, never above 5e-5 x
max(1, B / 4096) of the mass), the same bits on every call, and faults
planted at the refscale batch refused (F8);
K11's spmm_rows at its plan's edges the same bits twice.
K1's split design (rows cut into chunks across CTAs) at every bucket group
shape of the bench fit, both gather dtypes: rel 1e-4, exactly symmetric,
the same bits on a second call, one count a call. K6, K7, the select path
and K11's masked_topk on ``topk_bench.k5_edge_cases`` (NaN, +-inf, +-0,
ties): exact, NaN where NaN (``topk_bench.same``); masked_topk at any k and
starred width exactly; K9's and K10's wide paths (d above 512; rank above
128 or side width above 32) at K9's and K10's tolerances. The fused fit
(``ops.als.fit_loop``: an iteration captured as a CUDA graph, replayed)
equals the eager loop (``fit_loop_reference``) bit for bit at the bench's
and the rank-100 fit's groups, both solvers and gather dtypes, with and
without a callback, and beside a thread that launches K5, and launches what
it launches. The whole-loop fits K17 and K18 (``Word2Vec.train``,
``RankingFactorization.fit``: an epoch captured as a CUDA graph, replayed)
equal their eager loops bit for bit in tables, moments and per-epoch
losses, with and without a schedule, launch what they launch and leave
their generators where the eager loops do; K9 and K10 run at a batch of
one pair there (one warp adds every term, in program order: at larger
batches their atomics add in an order that changes from run to run), K9s
at 256. Adam with its bias pair read from device memory gives the bits of
the pair passed by value.
"""

import threading

import numpy as np
import pytest
import torch

from albedo_tpu_torch import kernels
from albedo_tpu_torch.kernels import topk_bench
from albedo_tpu_torch.kernels.als_partials_bench import BENCH_GROUPS, WIDE_GROUPS
from albedo_tpu_torch.ops import als as ops_als
from albedo_tpu_torch.ops import bpr as ops_bpr
from albedo_tpu_torch.ops import sgns as ops_sgns
from albedo_tpu_torch.ops import spmm as ops_spmm
from albedo_tpu_torch.ops import sparse_linear as ops_sl
from albedo_tpu_torch.ops import topk as ops_topk

pytestmark = pytest.mark.cuda
REL = 1e-4
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


def _hold_bf16(got, want, src, idx, val, mask, x0, steps=3):
    """K3-bf16 row by row against ``ops.als.bucket_cg_bf16_limits`` (F9)."""
    limits = ops_als.bucket_cg_bf16_limits(src, ops_als.gramian(src), idx, val, mask, x0, 0.5, 40.0, steps)
    assert float(ops_als.bucket_cg_bf16_over(got, want, limits).max()) <= 1.0


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
    with pytest.raises(ValueError, match="shape"):  # d 600 runs (wide path); a mis-shaped table does not
        ops_sgns.sgns_step(t, torch.zeros((4, 601), device=dev), i32, i32,
                           torch.zeros((2, 5), dtype=torch.int32, device=dev), t, t, torch.zeros(1, device=dev))
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
    # k past K5's KMAX: masked_topk takes it on the card (its select path),
    # equal to the plain version.
    block = torch.as_tensor(np.random.default_rng(0).normal(size=(2, 5)).astype(np.float32), device=dev)
    kernels.reset_launches()
    got = ops_spmm.masked_topk(block, None, ops_topk.KMAX + 1)
    assert topk_bench.same(torch, got, ops_spmm.masked_topk_reference(block, None, ops_topk.KMAX + 1))
    assert kernels.LAUNCHES["masked_topk_select"] == 1
    # Rank 200: bpr_step takes it on the card (its wide path), equal to the
    # plain version at K10's tolerance.
    p = [torch.full(s, 0.01, device=dev) for s in ((4, 200), (5, 200), (5,), (1,))]
    g = torch.ones((5, 1), device=dev)
    i32 = torch.zeros(2, dtype=torch.int32, device=dev)
    batch = (i32, i32 + 1, torch.full((2, 4), 2, dtype=torch.int32, device=dev))
    res = {}
    for name, fn in (("kernel", ops_bpr.bpr_step), ("plain", ops_bpr.bpr_step_reference)):
        grads = [torch.zeros_like(t) for t in p]
        loss = torch.zeros(1, device=dev)
        fn(*p, g, *batch, *grads, loss, 1e-4)
        res[name] = (*grads, loss)
    assert kernels.LAUNCHES["bpr_step_wide"] == 1
    for a, e, m in zip(res["kernel"], res["plain"], ops_bpr.bpr_grad_mass(*p, g, *batch, 1e-4)):
        assert bool(((a - e).abs() <= K9_MASS * m).all())


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


def _wide_bucket(dev, k, b, length, seed=0):
    """A bucket for the wide paths: rows of 0 to ``length`` entries (the
    first full, the last all padding when there are several), from a table
    of 2k + 40 rows (a padding slot's YtY stays positive definite)."""
    rng = np.random.default_rng(seed)
    n_source = 2 * k + 40
    src = (rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32)
    lens = rng.integers(0, length + 1, size=b)
    lens[0] = length
    if b > 1:
        lens[-1] = 0
    mask = np.arange(length)[None, :] < lens[:, None]
    idx = np.where(mask, rng.integers(0, n_source, size=(b, length)), 0).astype(np.int32)
    val = np.where(mask, rng.uniform(0.5, 3.0, size=(b, length)), 0).astype(np.float32)
    x0 = (rng.standard_normal((b, k)) * 0.1).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in (src, idx, val, mask, x0)]


@pytest.mark.parametrize("b, length", [(1, 7624), (40, 300), (2048, 16)], ids=["one-row-7624", "padding-slots", "B2048"])
@pytest.mark.parametrize("k", [65, 96, 100, 128, 129, 200, 256])
def test_k1_k2_k3_wide_paths_match_plain(dev, k, b, length):
    """Ranks above 64: K1 and K1-bf16 in the split design's wide kernel
    (the one-row group split across CTAs), K2's blocked Cholesky (the next
    system staged up to k 110, one system in shared memory up to 223, a
    global workspace at 256, one launch whatever B), K3's wide path; rel
    1e-4 as the narrow paths (K2 over the rows that are not padding); ten
    calls of K1 and of K2 give the same bits; one count a call of each."""
    src, idx, val, mask, x0 = _wide_bucket(dev, k, b, length, seed=k + b)
    yty = ops_als.gramian(src)
    for dtype in (None, "bfloat16"):
        kernels.reset_launches()
        got = ops_als.bucket_partial_terms(src, idx, val, mask, 40.0, dtype)
        assert kernels.LAUNCHES[ops_als._path(ops_als._entry("als_partials", dtype), k)] == 1
        corr_p, b_p = ops_als.bucket_partial_terms_reference(src, idx, val, mask, 40.0, dtype)
        _close(got[0], corr_p)
        _close(got[1], b_p)
        assert torch.equal(got[0], got[0].transpose(1, 2))
        for _ in range(10):
            again = ops_als.bucket_partial_terms(src, idx, val, mask, 40.0, dtype)
            assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    corr_p, b_p = ops_als.bucket_partial_terms_reference(src, idx, val, mask, 40.0)
    n_b = mask.sum(dim=1, dtype=torch.float32)
    live = n_b > 0
    kernels.reset_launches()
    x = ops_als.solve_corrected(yty, corr_p, b_p, n_b, 0.5)
    assert kernels.LAUNCHES["solve_corrected_wide"] == 1
    assert x[live].isfinite().all()
    _close(x[live], ops_als.solve_corrected_reference(yty, corr_p, b_p, n_b, 0.5)[live])
    for _ in range(10):
        assert torch.equal(x, ops_als.solve_corrected(yty, corr_p, b_p, n_b, 0.5))
    kernels.reset_launches()
    _close(ops_als.bucket_cg_body(src, yty, idx, val, mask, x0, 0.5, 40.0, 3),
           ops_als.bucket_cg_reference(src, yty, idx, val, mask, x0, 0.5, 40.0, 3))
    assert kernels.LAUNCHES["bucket_cg_wide"] == 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
def test_k1_split_workspace_is_capped_at_512(dev, gather_dtype):
    """At rank 512, the widest of K1's split design, a narrow tall group
    (131 rows of 700 entries) splits no further than its partials fit in
    WORKSPACE_MAX bytes, and is held as every K1 path (rel 1e-4, exactly
    symmetric, the same bits)."""
    ops_als._K1_WORKSPACE.clear()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    unit = 16 * ops_als.k1_blocks(512)
    _, n_chunks, _ = ops_als._k1_plan(131, 700, n_sm, unit)
    assert n_chunks > 1 and 4 * 131 * n_chunks * unit <= ops_als.WORKSPACE_MAX
    _hold_k1(dev, *_bench_bucket(dev, 131, 700, 512, n_source=2000, seed=512), gather_dtype)
    assert all(4 * w.numel() <= ops_als.WORKSPACE_MAX for w in ops_als._K1_WORKSPACE.values())


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("k", [513, 600])
def test_k1_tiled_path_above_512(dev, k, gather_dtype):
    """Above rank 512 K1 takes its tiled kernel (counted
    ``als_partials_tiled``): rel 1e-4, exactly symmetric, the same bits."""
    _hold_k1(dev, *_bench_bucket(dev, 5, 300, k, n_source=2000, seed=k), gather_dtype)


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
    _hold_bf16(ops_als.bucket_cg_body(src, yty, idx, val, mask, x0, 0.5, 40.0, 3, gather_dtype="bfloat16"),
               ops_als.bucket_cg_reference(src, yty, idx, val, mask, x0, 0.5, 40.0, 3, "bfloat16"),
               src, idx, val, mask, x0)
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


# ---- K1's split design, the NaN order (F5), masked_topk's select path (F6),
# ---- K9's and K10's wide paths (F7) -------------------------------------


def _bench_bucket(dev, b, length, k, n_source=20000, gaps=False, seed=0):
    """A bucket at a bench group's shape: rows of L/2 to L front-packed
    entries (a quarter of them all padding, as the bench groups' padding
    slots), optional masked gaps inside rows; idx 0 / val 0 off the mask."""
    rng = np.random.default_rng(seed)
    src = (rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32)
    lens = rng.integers(length // 2, length + 1, size=b)
    lens[rng.random(b) < 0.25] = 0
    mask = np.arange(length)[None, :] < lens[:, None]
    if gaps:
        mask &= rng.random((b, length)) > 0.3
    idx = np.where(mask, rng.integers(0, n_source, size=(b, length)), 0).astype(np.int32)
    val = np.where(mask, rng.uniform(0.5, 3.0, size=(b, length)), 0).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in (src, idx, val, mask)]


def _hold_k1(dev, src, idx, val, mask, gather_dtype):
    entry = ops_als._path(ops_als._entry("als_partials", gather_dtype), src.shape[1])
    kernels.reset_launches()
    corr, b_vec = ops_als.bucket_partial_terms(src, idx, val, mask, 40.0, gather_dtype)
    assert kernels.LAUNCHES[entry] == 1
    again = ops_als.bucket_partial_terms(src, idx, val, mask, 40.0, gather_dtype)
    torch.cuda.synchronize()
    corr_p, b_p = ops_als.bucket_partial_terms_reference(src, idx, val, mask, 40.0, gather_dtype)
    _close(corr, corr_p)
    _close(b_vec, b_p)
    assert torch.equal(corr, again[0]) and torch.equal(b_vec, again[1])    # no atomics: the same bits
    assert torch.equal(corr, corr.transpose(1, 2))                         # mirrored on write


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("b, length", BENCH_GROUPS)
def test_k1_split_design_at_the_bench_groups(dev, b, length, gather_dtype):
    _hold_k1(dev, *_bench_bucket(dev, b, length, 50, seed=b + length), gather_dtype)


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("k", [1, 7, 50, 64, 65, 100])
@pytest.mark.parametrize("b, length, gaps", [(4, 1, False), (1, 7624, False), (9, 300, False),
                                             (5, 700, True), (3, 0, False)],
                         ids=["L1", "one-row-7624", "padding-slots", "masked-gaps", "L0"])
def test_k1_split_design_edges(dev, b, length, gaps, k, gather_dtype):
    _hold_k1(dev, *_bench_bucket(dev, b, length, k, n_source=500, gaps=gaps, seed=k), gather_dtype)


def _edge_calls(dev):
    for label, u, v, k, ex in topk_bench.k5_edge_cases():
        yield label, (torch.as_tensor(u, device=dev), torch.as_tensor(v, device=dev), k,
                      None if ex is None else torch.as_tensor(ex, device=dev))


@pytest.mark.parametrize("kernel", ["gather_topk", "bank_query", "select", "masked_topk"])
def test_f5_nan_order_matches_plain_on_the_edge_cases(dev, kernel):
    """lax.top_k's order (+NaN first, NaNs by index; -NaN and -inf never;
    -0.0 ties +0.0) in K6, K7, the select path and masked_topk, on K5's edge
    cases (NaN and +-inf scores, zeros that cancel, ties across tiles)."""
    for label, (u, v, k, ex) in _edge_calls(dev):
        rows = torch.arange(u.shape[0], dtype=torch.int32, device=dev)
        if kernel == "gather_topk":
            got = ops_topk.gather_topk(u, v, rows, k, exclude=ex)
            want = ops_topk.gather_topk_reference(u, v, rows, k, exclude=ex)
        elif kernel == "bank_query":
            got = ops_topk.bank_query(v, k, users=u, user_idx=rows, exclude_table=ex)
            want = ops_topk.bank_query_reference(v, k, users=u, user_idx=rows, exclude_table=ex)
        elif kernel == "select":
            got = ops_topk.gather_topk(u, v, rows, 600, exclude=ex)
            want = ops_topk.gather_topk_reference(u, v, rows, 600, exclude=ex)
        else:
            scores = ops_topk._scores(u, v)
            norm = torch.linspace(0.5, 2.0, v.shape[0], device=dev)
            got = ops_spmm.masked_topk(scores, ex, k, norm)
            want = ops_spmm.masked_topk_reference(scores, ex, k, norm)
            assert topk_bench.same(torch, ops_spmm.masked_topk(scores, ex, k),
                                   ops_spmm.masked_topk_reference(scores, ex, k)), label
        assert topk_bench.same(torch, got, want), label


@pytest.mark.parametrize("k", [129, 512, 513, 1200])
@pytest.mark.parametrize("with_norm", [True, False])
def test_f6_masked_topk_at_any_k(dev, k, with_norm):
    rng = np.random.default_rng(k)
    scores = rng.normal(size=(2936, 40)).astype(np.float32)   # (n, B): a strided (B, n) view
    scores[1500:1600] = scores[:100]                          # ties
    scores[:, 2] = 0.25                                       # a row of ties
    scores[7, 5], scores[8, 5], scores[9, 6] = np.nan, -np.nan, np.inf
    starred = np.full((40, 64), -1, np.int32)
    starred[:, :50] = rng.integers(0, 2936, size=(40, 50))
    starred[3] = np.arange(64)
    norm = torch.as_tensor(rng.uniform(0.0, 3.0, size=2936).astype(np.float32), device=dev) if with_norm else None
    block = torch.as_tensor(scores, device=dev).t()
    st = torch.as_tensor(starred, device=dev)
    kernels.reset_launches()
    got = ops_spmm.masked_topk(block, st, k, norm)
    assert kernels.LAUNCHES["masked_topk_select"] == 1 and kernels.LAUNCHES["masked_topk"] == 0
    assert topk_bench.same(torch, got, ops_spmm.masked_topk_reference(block, st, k, norm))


def test_f6_masked_topk_starred_rows_longer_than_the_streaming_kernel(dev):
    """A 40 000-wide starred row (over EXCLUDE_MAX), at k 30 and 600."""
    rng = np.random.default_rng(40)
    block = torch.as_tensor(rng.normal(size=(3, 60000)).astype(np.float32), device=dev)
    st = torch.as_tensor(np.stack([rng.choice(60000, size=40000, replace=False) for _ in range(3)])
                         .astype(np.int32), device=dev)
    for k in (30, 600):
        got = ops_spmm.masked_topk(block, st, k)
        assert topk_bench.same(torch, got, ops_spmm.masked_topk_reference(block, st, k))


@pytest.mark.parametrize("d", [513, 1024])
def test_f7_k9_sgns_step_wide_matches_plain(dev, d):
    rng = np.random.default_rng(d)
    v, k, b = 146, 5, 300
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
            assert kernels.LAUNCHES["sgns_step_wide"] == 1 and kernels.LAUNCHES["sgns_step"] == 0
    mass = ops_sgns.sgns_grad_mass(in_t, out_t, *args)
    for a, e, m in zip(res["kernel"], res["plain"], mass):
        assert bool(((a - e).abs() <= K9_MASS * m).all())
    assert float((res["kernel"][2] - res["plain"][2]).abs()) <= K9_MASS * float(res["plain"][2].abs())


@pytest.mark.parametrize("r, d", [(129, 2), (200, 2), (32, 33), (200, 33)])
def test_f7_k10_bpr_step_wide_matches_plain(dev, r, d):
    rng = np.random.default_rng(r + d)
    n_users, n_items, b = 300, 200, 8192
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
            assert kernels.LAUNCHES["bpr_step_wide"] == 1 and kernels.LAUNCHES["bpr_step"] == 0
    mass = ops_bpr.bpr_grad_mass(*params, g, *batch, 1e-4)
    for a, e, m in zip(res["kernel"], res["plain"], mass):
        assert bool(((a - e).abs() <= K9_MASS * m).all())
    assert float((res["kernel"][4] - res["plain"][4]).abs()) <= K9_MASS * float(res["plain"][4].abs())


@pytest.mark.parametrize("k", [30, 512])
def test_k6_k7_streaming_body_above_the_48kb_default(dev, k):
    """Launches whose static running list and dynamic shared memory pass
    the 48 KB a block gets by default: K7's item-mean query at d 200 (the
    wide body's tile and the mean, 36 KB) and K6 with 7000-wide exclusion
    rows (28 KB), at k 30 and 512 (the 512-entry list: 22.8 KB static)."""
    rng = np.random.default_rng(k)
    vf = torch.as_tensor(np.abs(rng.standard_normal((2936, 200))).astype(np.float32), device=dev)
    q = torch.as_tensor(rng.integers(-1, 2936, size=(64, 32)).astype(np.int32), device=dev)
    got = ops_topk.bank_query(vf, k, q_idx=q)
    assert topk_bench.same(torch, got, ops_topk.bank_query_reference(vf, k, q_idx=q))
    uf = torch.as_tensor(rng.standard_normal((300, 50)).astype(np.float32), device=dev)
    items = torch.as_tensor(rng.standard_normal((20000, 50)).astype(np.float32), device=dev)
    table = torch.as_tensor(rng.integers(-1, 20000, size=(300, 7000)).astype(np.int32), device=dev)
    ui = torch.as_tensor(rng.integers(0, 300, size=16).astype(np.int32), device=dev)
    got = ops_topk.gather_topk(uf, items, ui, k, exclude_table=table)
    assert topk_bench.same(torch, got, ops_topk.gather_topk_reference(uf, items, ui, k, exclude_table=table))


# ---- K2's warp design, K3's split design ---------------------------------


def _k2_inputs(dev, k, b, seed=0, n_pad=None):
    """A (b, k) system batch from a bucket's plain K1 terms (symmetric up to
    round-off, as K1's own output is exactly), the Gramian of a table of
    2k + 40 rows (positive definite) and the rows' counts; the last rows are
    padding slots (n_b = 0) when the batch has more than one."""
    n_pad = (0 if b == 1 else min(5, b - 1)) if n_pad is None else n_pad
    src, idx, val, mask, _ = _bucket(dev, k, b=b, length=37, n_source=2 * k + 40, n_pad=n_pad, seed=seed)
    corr, b_vec = ops_als.bucket_partial_terms_reference(src, idx, val, mask, 40.0)
    corr = (corr + corr.transpose(1, 2)) / 2
    return ops_als.gramian(src), corr.contiguous(), b_vec, mask.sum(dim=1, dtype=torch.float32)


@pytest.mark.parametrize("b", [1, 37])
@pytest.mark.parametrize("k", [1, 7, 8, 16, 31, 32, 33, 50, 63, 64])
def test_k2_warp_design_matches_plain(dev, k, b):
    """One warp a system at every rank class (16, 32, 64) and its edges,
    one system and a batch that is not a multiple of a CTA's 4 warps: rel
    1e-4 of the plain version, the same bits on a second call, one count a
    call."""
    yty, corr, b_vec, n_b = _k2_inputs(dev, k, b, seed=k)
    kernels.reset_launches()
    x = ops_als.solve_corrected(yty, corr, b_vec, n_b, 0.5)
    assert kernels.LAUNCHES["solve_corrected"] == 1
    again = ops_als.solve_corrected(yty, corr, b_vec, n_b, 0.5)
    torch.cuda.synchronize()
    _close(x, ops_als.solve_corrected_reference(yty, corr, b_vec, n_b, 0.5))
    assert torch.equal(x, again)


@pytest.mark.parametrize("k", [8, 50, 64, 65, 100, 200])
def test_k2_padding_rows_are_nan_only_there(dev, k):
    """With a YtY that is not positive definite (here -1e-3 I), a padding
    slot (n_b = 0) factors A = YtY and every value of its row is NaN; the
    live rows, positive definite through reg n_b, stay finite and within
    rel 1e-4 of the plain version."""
    _, corr, b_vec, n_b = _k2_inputs(dev, k, 37, seed=3)
    yty = -1e-3 * torch.eye(k, device=dev)
    x = ops_als.solve_corrected(yty, corr, b_vec, n_b, 0.5)
    torch.cuda.synchronize()
    pad = n_b == 0
    assert pad.sum() == 5
    assert x[pad].isnan().all() and x[~pad].isfinite().all()
    _close(x[~pad], ops_als.solve_corrected_reference(yty, corr, b_vec, n_b, 0.5)[~pad])


def _force_k3_plan(monkeypatch, plan):
    """Make every K3 launch take ``plan`` (mode, c, slice, resident) in place
    of the one ``ops_als.k3_plan_for`` would pick."""
    monkeypatch.setattr(ops_als, "k3_plan_for", lambda *args: plan)


def _hold_k3(dev, src, idx, val, mask, x0, gather_dtype, steps=3):
    """K3 (or K3-bf16) under the plan ``ops_als.k3_plan_for`` gives against
    the plain version: rel 1e-4 (bf16 row by row to F9's limits), the same
    bits on a second call, one count of the path the rank takes."""
    yty = ops_als.gramian(src)
    entry = ops_als._path(ops_als._entry("bucket_cg", gather_dtype), src.shape[1])
    kernels.reset_launches()
    x = ops_als.bucket_cg_body(src, yty, idx, val, mask, x0, 0.5, 40.0, steps, gather_dtype=gather_dtype)
    assert kernels.LAUNCHES[entry] == 1
    again = ops_als.bucket_cg_body(src, yty, idx, val, mask, x0, 0.5, 40.0, steps, gather_dtype=gather_dtype)
    torch.cuda.synchronize()
    want = ops_als.bucket_cg_reference(src, yty, idx, val, mask, x0, 0.5, 40.0, steps, gather_dtype)
    if gather_dtype is None:
        _close(x, want)
    else:
        _hold_bf16(x, want, src, idx, val, mask, x0, steps)
    assert torch.equal(x, again)


def _k3_bucket(dev, b, length, k, n_source=500, gaps=False, empty_row=False, seed=0):
    src, idx, val, mask = _bench_bucket(dev, b, length, k, n_source=n_source, gaps=gaps, seed=seed)
    if empty_row:
        mask[0] = False
        idx[0] = 0
        val[0] = 0.0
    x0 = torch.as_tensor((np.random.default_rng(seed).standard_normal((b, k)) * 0.1).astype(np.float32), device=dev)
    return src, idx, val, mask, x0


def _slice(length, c):
    return max(32, -(-(-(-length // c)) // 32) * 32)


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("k", [1, 16, 49, 50, 64])
@pytest.mark.parametrize("case", ["warp", "warp-L1", "warp-L0", "cta", "c2", "c4", "c8", "c16", "streamed-c1",
                                  "streamed-c4", "masked-gaps", "all-masked-row"])
def test_k3_modes_match_plain(dev, monkeypatch, case, k, gather_dtype):
    """Each mode of K3's split design under a forced plan: warp mode (one
    warp a row), one CTA a row, clusters of 2, 4, 8 and 16 (each size the
    plan can pick), the streamed path (windows of 64 slots through a ring)
    at c = 1 and 4, rows with masked gaps and a row with no entry at all."""
    b, length, plan, gaps, empty = {
        "warp": (37, 64, (0, 1, 64, 1), False, False),
        "warp-L1": (9, 1, (0, 1, 4, 1), False, False),
        "warp-L0": (3, 0, (0, 1, 4, 1), False, False),
        "cta": (5, 300, (1, 1, _slice(300, 1), 1), False, False),
        "c2": (3, 700, (1, 2, _slice(700, 2), 1), False, False),
        "c4": (3, 700, (1, 4, _slice(700, 4), 1), False, False),
        "c8": (3, 700, (1, 8, _slice(700, 8), 1), False, False),
        "c16": (2, 1500, (1, 16, _slice(1500, 16), 1), False, False),
        "streamed-c1": (3, 300, (1, 1, _slice(300, 1), 0), False, False),
        "streamed-c4": (3, 700, (1, 4, _slice(700, 4), 0), False, False),
        "masked-gaps": (6, 700, None, True, False),
        "all-masked-row": (6, 300, None, False, True),
    }[case]
    if plan is not None:
        _force_k3_plan(monkeypatch, plan)
    _hold_k3(dev, *_k3_bucket(dev, b, length, k, gaps=gaps, empty_row=empty, seed=k + length), gather_dtype)


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("length, c", [(31, 0), (32, 0), (33, 0), (63, 0), (64, 0), (65, 1), (96, 1), (97, 1),
                                       (128, 4), (129, 4), (191, 2), (192, 2), (193, 2), (257, 8)])
def test_k3_tile_and_slice_edges(dev, monkeypatch, length, c, gather_dtype):
    """Slot counts at the 32-slot chunk edges and at slice edges (a last
    slice of one slot, empty last ranks): warp mode for c = 0, else clusters
    of c with the shortest slices that cover the row."""
    _force_k3_plan(monkeypatch, (0, 1, -(-length // 4) * 4, 1) if c == 0 else (1, c, _slice(length, c), 1))
    _hold_k3(dev, *_k3_bucket(dev, 7, length, 50, seed=length), gather_dtype)


@pytest.mark.parametrize("b, length", BENCH_GROUPS)
def test_k3_split_design_at_the_bench_groups(dev, b, length):
    """K3 under its default plan at every bench group shape, rank 50. In
    float32 only: at rows of hundreds to thousands of entries a float32
    round-off in another summation order flips bf16 roundings of p and t,
    and the plain bf16 version alone moves past 5e-4 when each row's entries
    are merely reversed (``tests/test_torch_ops_als.py::
    test_k3_bf16_long_rows_flip_under_reordering``), so
    K3-bf16's rounding sites are held on shorter rows
    (:func:`test_k3_modes_match_plain`, :func:`test_k3_tile_and_slice_edges`)
    and at the bench by ``chip_smoke.py``."""
    _hold_k3(dev, *_k3_bucket(dev, b, length, 50, n_source=20000, seed=b + length), None)


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
def test_k3_streams_a_slice_longer_than_shared_memory(dev, gather_dtype):
    """A 30 000-slot row at rank 64 does not fit shared memory even in a
    cluster of 16, so its default plan streams it."""
    plan = ops_als.k3_plan_for(1, 30000, 64, gather_dtype, dev)
    assert plan[0] == 1 and plan[3] == 0
    _hold_k3(dev, *_k3_bucket(dev, 1, 30000, 64, n_source=20000, seed=5), gather_dtype)


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
def test_k3_one_cta_rows_repeat_the_same_bits(dev, gather_dtype):
    """Rows of one CTA a row (c = 1, the plan of every group with at least
    an SM's worth of rows) whose 8 warps each hold one to three live entries
    at the head of their 64-slot block and padding after them, so a warp
    reaches the first matvec's partial within a few entries of the b / diag
    exchange: 200 calls give the same bits and the plain result (a warp
    that stored its matvec partial before warp 0 had added its b partial
    would change both)."""
    b, length, k = 264, 512, 50
    rng = np.random.default_rng(7)
    src = torch.as_tensor((rng.standard_normal((20000, k)) / np.sqrt(k)).astype(np.float32), device=dev)
    live = np.arange(length)[None, :] % 64 < rng.integers(1, 4, size=(b, 8)).repeat(64, axis=1)
    live[rng.random(b) < 0.1] = False
    idx = torch.as_tensor(np.where(live, rng.integers(0, 20000, size=(b, length)), 0).astype(np.int32), device=dev)
    val = torch.as_tensor(np.where(live, rng.uniform(0.5, 3.0, size=(b, length)), 0).astype(np.float32),
                          device=dev)
    mask = torch.as_tensor(live, device=dev)
    x0 = torch.as_tensor((rng.standard_normal((b, k)) * 0.1).astype(np.float32), device=dev)
    assert ops_als.k3_plan_for(b, length, k, gather_dtype, dev) == (1, 1, length, 1)
    yty = ops_als.gramian(src)
    first = ops_als.bucket_cg_body(src, yty, idx, val, mask, x0, 0.5, 40.0, 3, gather_dtype=gather_dtype)
    for _ in range(200):
        again = ops_als.bucket_cg_body(src, yty, idx, val, mask, x0, 0.5, 40.0, 3, gather_dtype=gather_dtype)
        assert torch.equal(first, again)
    want = ops_als.bucket_cg_reference(src, yty, idx, val, mask, x0, 0.5, 40.0, 3, gather_dtype)
    if gather_dtype is None:
        _close(first, want)
    else:
        _hold_bf16(first, want, src, idx, val, mask, x0)


def test_k3_refused_plans_raise(dev, monkeypatch):
    """A cluster the card cannot hold (32 CTAs) and a plan that does not
    cover the row are refused by the launch, and the wrapper raises: no
    smaller plan, no plain version."""
    src, idx, val, mask, x0 = _k3_bucket(dev, 2, 700, 50)
    yty = ops_als.gramian(src)
    for plan in ((1, 32, 32, 1), (1, 4, 96, 1), (0, 1, 4, 1), (1, 1, 7000, 1)):
        _force_k3_plan(monkeypatch, plan)
        with pytest.raises(RuntimeError, match="failed to launch"):
            ops_als.bucket_cg_body(src, yty, idx, val, mask, x0, 0.5, 40.0, 3)


# ---- K3's split design above rank 64, and its tiled path above 512 --------


WIDE_K3_RANKS = [65, 96, 100, 128, 129, 200, 256, 512]


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("k", WIDE_K3_RANKS)
@pytest.mark.parametrize("b, length", [(1, 1224), (40, 300), (256, 16), (2048, 16)],
                         ids=["one-row-1224", "padding-slots", "warp-mode", "B2048"])
def test_k3_wide_split_design_matches_plain(dev, b, length, k, gather_dtype):
    """K3 and K3-bf16 at ranks 65-512 under their default plans (the
    rank-100 fit's longest row over a cluster, rows with padding slots, the
    warp mode of short rows): K3 at rel 1e-4, K3-bf16 row by row to F9's
    limits, the same bits on a second call, one ``bucket_cg_wide`` count."""
    _hold_k3(dev, *_k3_bucket(dev, b, length, k, n_source=2000, seed=k + length), gather_dtype)


def _wide_k3_plan(k, bf16, case, length):
    """The forced plan of a case of :func:`test_k3_wide_modes_match_plain`:
    warp mode at the rank's pack length, or clusters of c whose slices stay
    in shared memory where they fit (else streamed), or streamed."""
    if case.startswith("warp"):
        return 0, 1, max(4, -(-length // 4) * 4), 1
    c = {"cta": 1, "c2": 2, "c4": 4, "c8": 8, "c16": 16, "streamed-c1": 1, "streamed-c4": 4}[case]
    resident = (1, c, _slice(length, c), 1)
    fits = ops_als.k3_smem(resident, k, bf16) <= ops_als.K3_SMEM
    return (1, c, _slice(length, c), int(fits and not case.startswith("streamed")))


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("k", [65, 100, 129, 256, 257, 512])
@pytest.mark.parametrize("case", ["warp", "warp-L1", "warp-L0", "cta", "c2", "c4", "c8", "c16", "streamed-c1",
                                  "streamed-c4", "masked-gaps", "all-masked-row"])
def test_k3_wide_modes_match_plain(dev, monkeypatch, case, k, gather_dtype):
    """Each mode of the split design above rank 64 under a forced plan, in
    every column class (4, 8, 16 columns a lane; YtY from shared memory and
    from L2; the CG vectors in registers and in shared memory): warp mode at
    the rank's longest packed row, one slot and none, one CTA a row,
    clusters of 2 to 16, streamed slices (windows of 64, or 32 above rank
    256) at c = 1 and 4, rows with masked gaps and a row with no entry."""
    bf16 = gather_dtype is not None
    pack = ops_als.k3_pack_l(k)
    b, length = {"warp": (37, pack), "warp-L1": (9, 1), "warp-L0": (3, 0), "cta": (5, 300), "c2": (3, 700),
                 "c4": (3, 700), "c8": (3, 700), "c16": (2, 1500), "streamed-c1": (3, 300),
                 "streamed-c4": (3, 700), "masked-gaps": (6, 700), "all-masked-row": (6, 300)}[case]
    if case not in ("masked-gaps", "all-masked-row"):
        _force_k3_plan(monkeypatch, _wide_k3_plan(k, bf16, case, length))
    _hold_k3(dev, *_k3_bucket(dev, b, length, k, n_source=2000, gaps=case == "masked-gaps",
                              empty_row=case == "all-masked-row", seed=k + length), gather_dtype)


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("b, length", WIDE_GROUPS)
def test_k3_wide_at_the_rank_100_groups(dev, b, length, gather_dtype):
    """K3 and K3-bf16 under their default plans at every group shape of the
    rank-100 fit, rank 100: K3 at rel 1e-4, K3-bf16 row by row to F9's
    limits (``ops.als.bucket_cg_bf16_limits``, worst share under 1), the
    same bits on a second call, one ``bucket_cg_wide`` count a call."""
    _hold_k3(dev, *_k3_bucket(dev, b, length, 100, n_source=3000, seed=b + length), gather_dtype)


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("k", [513, 600])
@pytest.mark.parametrize("case", ["5x300", "256x16"])
def test_k3_tiled_path_above_512(dev, case, k, gather_dtype):
    """Above rank 512 K3 takes its tiled kernel, counted ``bucket_cg_tiled``
    (``bucket_cg_bf16_tiled``): held as the split design, one count. The
    256 x 16 bucket at rank 513 is F10's input: with thread 0 summing the
    CG dots over all k columns, K3-bf16 was 2.3 times over F9's limits
    there (``tests/test_torch_ops_als.py::test_f10_k3_tiled_dots``)."""
    bucket = (_k3_bucket(dev, 5, 300, k, n_source=2000, seed=k) if case == "5x300"
              else _wide_bucket(dev, k, 256, 16, seed=k + 256))
    _hold_k3(dev, *bucket, gather_dtype)
    assert kernels.LAUNCHES["bucket_cg_wide"] == kernels.LAUNCHES["bucket_cg_bf16_wide"] == 0


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
def test_k3_smem_mirror_is_the_library(dev, gather_dtype):
    """The CPU mirror of K3's shared-memory layout (``ops.als.k3_smem``,
    which the CPU plan tests use) counts the bytes ``bucket_cg.cu
    bucket_cg_smem`` counts (with which the wrapper plans) at every rank
    1-512: warp mode at every slice length, cluster mode resident and
    streamed; so the warp-mode lengths and every plan of the rank-100 fit's
    and the bench's groups agree, and the library refuses ranks above 512."""
    bf16 = gather_dtype is not None
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = ([(0, 1, s, 1) for s in range(4, 129, 4)]
             + [(1, 1, s, r) for s in (32, 64, 96, 320, 1248, 7648) for r in (0, 1)])
    for k in range(1, 513):
        for plan in plans:
            assert ops_als.k3_smem_card(plan, k, bf16) == ops_als.k3_smem(plan, k, bf16), (k, plan)
        assert ops_als.k3_pack_l(k, ops_als.k3_smem_card) == ops_als.k3_pack_l(k)
    for k in (50, 65, 100, 128, 129, 256, 257, 512):
        for b, length in WIDE_GROUPS + BENCH_GROUPS:
            want = ops_als._k3_plan(b, length, k, bf16, n_sm)
            if want[1] == 16 and not ops_als._k3_cluster16(dev, bf16, k, ops_als.k3_smem(want, k, bf16)):
                want = ops_als._k3_plan(b, length, k, bf16, n_sm, c_max=8)
            assert ops_als.k3_plan_for(b, length, k, gather_dtype, dev) == want, (k, b, length)
    with pytest.raises(ValueError, match="no split-design plan"):
        ops_als.k3_smem_card((0, 1, 4, 1), 513, bf16)


def test_k3_wide_refused_plans_raise(dev, monkeypatch):
    """Above rank 64 as below: a cluster the card cannot hold, a plan that
    does not cover the row, warp mode past 128 slots and a resident slice
    past shared memory are refused, and the wrapper raises."""
    src, idx, val, mask, x0 = _k3_bucket(dev, 2, 700, 100)
    yty = ops_als.gramian(src)
    for plan in ((1, 32, 32, 1), (1, 4, 96, 1), (0, 1, 700, 1), (1, 1, 704, 1)):
        _force_k3_plan(monkeypatch, plan)
        with pytest.raises(RuntimeError, match="failed to launch"):
            ops_als.bucket_cg_body(src, yty, idx, val, mask, x0, 0.5, 40.0, 3)


# ---- F9, F8 and the redesigned K11 spmm_rows and K9s ----------------------


@pytest.mark.parametrize("b, length", [(1, 7624), (2, 5760), (4, 3288), (16, 2152), (64, 1224), (256, 600)])
def test_f9_k3_bf16_at_the_bench_groups(dev, b, length):
    """K3-bf16 under its default plan at the bench's longest groups, rank
    50, row by row against F9's limits (``ops.als.bucket_cg_bf16_limits``),
    the same bits on a second call."""
    _hold_k3(dev, *_k3_bucket(dev, b, length, 50, n_source=20000, seed=b + length), "bfloat16")


def _plan_edge_csr(dev, with_val, n_cols=2936, seed=0):
    """Rows at the edges of spmm_rows' plan: empty rows, one of a chunk and
    one of a chunk and an entry, the bench's 6690-entry head row, one row
    that spans every column, short rows."""
    rng = np.random.default_rng(seed)
    chunk = ops_spmm.SPMM_CHUNK
    counts = rng.integers(0, 30, size=400)
    counts[::7] = 0
    counts[[3, 4, 5]] = (chunk, chunk + 1, 6690)
    counts[-1] = 0
    idx = [rng.integers(0, n_cols, size=n) for n in counts]
    idx[9] = rng.permutation(n_cols)
    counts[9] = n_cols
    indptr = np.concatenate([[0], np.cumsum(counts)])
    flat = np.concatenate(idx).astype(np.int32)
    val = rng.uniform(0.1, 1.0, size=flat.size).astype(np.float32) if with_val else None
    return ops_spmm.CSR.from_host(indptr, flat, val, n_cols, dev)


@pytest.mark.parametrize("b", [1, 7, 256, 300])
@pytest.mark.parametrize("with_val", [True, False])
def test_k11_spmm_rows_plan_edges_same_bits(dev, b, with_val):
    """spmm_rows at its plan's edges, at B = 1 (a lane an entry), 7 (no
    16-byte loads), 256 (one pass) and 300 (two): 1e-6 of each element's
    L1 mass, one count a call, the same bits twice, empty rows exactly 0."""
    w = _plan_edge_csr(dev, with_val, seed=b)
    x = torch.as_tensor(np.random.default_rng(b).uniform(size=(2936, b)).astype(np.float32), device=dev)
    kernels.reset_launches()
    got = ops_spmm.spmm_rows(w, x)
    assert kernels.LAUNCHES["spmm_rows"] == 1
    again = ops_spmm.spmm_rows(w, x)
    torch.cuda.synchronize()
    want, mass = ops_spmm.spmm_rows_reference(w, x), ops_spmm.spmm_rows_mass(w, x)
    assert bool(((got - want).abs() <= 1e-6 * mass).all())
    assert torch.equal(got, again)
    assert float(got[0].abs().max()) == 0.0 and float(got[-1].abs().max()) == 0.0


def _k9s_inputs(dev, b, d, k, v, case, seed=0):
    rng = np.random.default_rng(seed)
    in_t = rng.uniform(-0.5 / d, 0.5 / d, size=(v, d)).astype(np.float32)
    out_t = rng.normal(scale=0.1, size=(v, d)).astype(np.float32)
    c = rng.integers(0, v, size=b).astype(np.int32)
    o = rng.integers(0, v, size=b).astype(np.int32)
    pool = rng.integers(0, v, size=k).astype(np.int32)
    if case == "one-word-pool":
        pool[:] = 5
    elif case == "one-center":
        c[:] = 2                       # a center that fills the whole batch
    elif case == "context-in-pool":
        pool[::2] = o[0]               # a word that is both a context and a pool slot
        o[: b // 2] = o[0]
    return [torch.as_tensor(a, device=dev) for a in (in_t, out_t, c, o, pool)]


def _hold_k9s_f64(in_t, out_t, c, o, pool, scale, calls):
    """K9s ``calls`` times against its plain version in float64 to
    ``ops.sgns.sgns_shared_limits`` (ten standard deviations of the
    round-off of its own order and logits, capped at 5e-5 x max(1, B /
    4096) of each element's mass), every call the same bits, one count a
    call. Returns the first call's result, the plain version's, the limits
    and the plan."""
    runs = []
    kernels.reset_launches()
    for _ in range(calls):
        g = (torch.zeros_like(in_t), torch.zeros_like(out_t), torch.zeros(1, device=in_t.device))
        ops_sgns.sgns_shared_step(in_t, out_t, c, o, pool, *g, scale)
        runs.append(g)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sgns_shared"] == calls
    for r in runs[1:]:
        assert all(torch.equal(a, e) for a, e in zip(runs[0], r))
    dd = [t.double() for t in (in_t, out_t)]
    want = (torch.zeros_like(dd[0]), torch.zeros_like(dd[1]), torch.zeros(1, dtype=torch.float64, device=in_t.device))
    ops_sgns.sgns_shared_step_reference(*dd, c, o, pool, *want, scale)
    plan = ops_sgns.k9s_plan(c.shape[0], in_t.shape[1], pool.shape[0])
    limits = ops_sgns.sgns_shared_limits(in_t, out_t, c, o, pool, scale, plan)
    assert ops_sgns.sgns_shared_over(runs[0], want, limits) <= 1.0
    return runs[0], want, limits, plan


@pytest.mark.parametrize("k", [1, 32, 512])
@pytest.mark.parametrize("d", [8, 200])
@pytest.mark.parametrize("case", ["plain", "one-word-pool", "one-center", "context-in-pool"])
def test_k9s_fixed_order_cases(dev, case, d, k):
    """K9s at B = 1000 (a multiple of no tile), d 8 and 200, K 1, 32 and
    512: a pool of one repeated word, a center that fills the whole batch, a
    word that is both a context and pool slots; against float64 to the
    round-off bound of its own order, the same bits over 20 calls."""
    args = _k9s_inputs(dev, 1000, d, k, 997, case, seed=d + k)
    _hold_k9s_f64(*args, 5 / k, calls=20)


def test_f8_k9s_at_the_refscale_batch(dev):
    """F8: K9s at a refscale-shaped step (B 65 536, K 512, d 200, Zipf
    centers and pool, ``kernels.spmm_sgns_bench.refscale_batch``) against
    its plain version in float64, ten calls the same bits."""
    from albedo_tpu_torch.kernels.spmm_sgns_bench import refscale_batch

    _hold_k9s_f64(*refscale_batch(torch, dev), 5 / 512, calls=10)


@pytest.mark.parametrize("centers", ["zipf", "a third one word"])
def test_f8_check_refuses_faults_at_the_refscale_batch(dev, centers):
    """F8's check at the refscale batch (``refscale_batch``; or with a
    third of the centers one word, a run of 21 845 pairs) refuses faults
    planted in the kernel's result (``spmm_sgns_bench.k9s_faults``): the
    first pair of the most frequent center dropped, G^T Vc's first split
    left out, the tables rounded to TF32."""
    from albedo_tpu_torch.kernels.spmm_sgns_bench import k9s_faults, refscale_batch

    in_t, out_t, c, o, pool = refscale_batch(torch, dev)
    if centers != "zipf":
        c = c.clone()
        c[: c.shape[0] // 3] = 1
    got, want, limits, plan = _hold_k9s_f64(in_t, out_t, c, o, pool, 5 / 512, calls=2)
    faults = k9s_faults(in_t, out_t, c, o, pool, 5 / 512, got, want, limits, plan)
    for name in ("dropped pair", "split left out", "tf32 operands"):
        assert faults[name] > 1.0, (name, faults)


@pytest.mark.parametrize("b, d, k", [(1, 8, 1), (300, 8, 16), (1000, 200, 512), (65536, 200, 512)])
def test_k9s_plan_fits_the_batch(dev, b, d, k):
    """K9s's plan as its library reports it (``sgns_shared_plan``): G^T
    Vc's split covers the batch in chunks of whole 8-pair slices, its
    workspace holds every region, the CPU tests' copies of two plans
    (``test_torch_ops_plans.K9S_PLANS``) are the library's, and the launch
    refuses a workspace one float short."""
    import ast
    from pathlib import Path

    cpu_tests = ast.parse((Path(__file__).parent / "test_torch_ops_plans.py").read_text())  # it imports JAX
    K9S_PLANS = next(ast.literal_eval(n.value) for n in cpu_tests.body
                     if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "K9S_PLANS")
    plan = ops_sgns.k9s_plan(b, d, k)
    assert plan["chunk"] % 8 == 0 and plan["splits"] == -(-b // plan["chunk"])
    assert plan["ranges"] * ops_sgns.K9S_RANGE >= 2 * b
    sizes = [b * k, b, b * d, plan["ranges"] * 2 * d, plan["splits"] * k * d, plan["n_pos"] + plan["n_neg"]]
    assert plan["numel"] == sum(sizes)
    if (b, d, k) in K9S_PLANS:
        assert {key: plan[key] for key in K9S_PLANS[(b, d, k)]} == K9S_PLANS[(b, d, k)]
    rng = np.random.default_rng(b)
    t = [torch.as_tensor(rng.normal(scale=0.1, size=(50, d)).astype(np.float32), device=dev) for _ in range(2)]
    ids = [torch.as_tensor(rng.integers(0, 50, size=n).astype(np.int32), device=dev) for n in (b, b, k)]
    g = (torch.zeros_like(t[0]), torch.zeros_like(t[1]), torch.zeros(1, device=dev))
    short = torch.empty(plan["numel"] - 1, device=dev)
    with pytest.raises(RuntimeError, match="cudaError"):
        ops_sgns.sgns_shared_step(*t, *ids, *g, 5 / max(k, 1), short)


# ------------------------------------------------------------ the fused fit


@pytest.fixture(scope="module")
def fit_layouts():
    """The bench fit's groups (rank 50, the bench split of 30000 x 20000)
    and the rank-100 fit's (the ``train_als`` job's tables), on the card,
    each with its shared numpy init."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from albedo_tpu_torch import cli
    from albedo_tpu_torch.builders.jobs import JobContext, shared_als_init
    from albedo_tpu_torch.datasets import random_split_by_user
    from albedo_tpu_torch.datasets.synthetic import synthetic_stars
    from albedo_tpu_torch.models.als import ImplicitALS

    bench, _ = random_split_by_user(synthetic_stars(30000, 20000, rank=24, mean_stars=60, seed=42),
                                    test_ratio=0.1, seed=42)
    job = JobContext(cli.parse_args(["train_als", "--device", "cpu"])).matrix()
    return {name: (ImplicitALS(rank=rank, device="cuda").device_groups(m),
                   shared_als_init(m.n_users, m.n_items, rank, 1))
            for name, m, rank in (("bench", bench, 50), ("wide", job, 100))}


def _fit(layout, n_iter, solver="cholesky", gather_dtype=None, graph=True, callback=False):
    """(user_f, item_f, host copies of each iteration's tables when
    ``callback``) of ``fit_loop`` (``graph``) or ``fit_loop_reference``."""
    (ug, ig, u_land, i_land), (u0, v0) = layout
    seen = []
    hook = (lambda it, u, v: seen.append((it, u.cpu(), v.cpu()))) if callback else None
    fit = ops_als.fit_loop if graph else ops_als.fit_loop_reference
    u, v = fit(torch.as_tensor(u0, device="cuda"), torch.as_tensor(v0, device="cuda"), ug, ig, u_land, i_land,
               0.5, 40.0, n_iter, solver=solver, cg_steps=3, callback=hook, gather_dtype=gather_dtype)
    torch.cuda.synchronize()
    return u, v, seen


@pytest.mark.parametrize("callback", [False, True])
@pytest.mark.parametrize("n_iter", [1, 2, 26])
@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("solver", ["cholesky", "cg"])
@pytest.mark.parametrize("layout", ["bench", "wide"])
def test_fused_fit_same_bits_as_eager_loop(fit_layouts, layout, solver, gather_dtype, n_iter, callback):
    """The graph fit equals the eager loop bit for bit, and its callback
    sees every iteration's tables."""
    want_u, want_v, want_seen = _fit(fit_layouts[layout], n_iter, solver, gather_dtype, graph=False,
                                     callback=callback)
    got_u, got_v, got_seen = _fit(fit_layouts[layout], n_iter, solver, gather_dtype, callback=callback)
    assert torch.equal(got_u, want_u) and torch.equal(got_v, want_v)
    assert [it for it, _, _ in got_seen] == ([*range(n_iter)] if callback else [])
    for (_, gu, gv), (_, wu, wv) in zip(got_seen, want_seen, strict=True):
        assert torch.equal(gu, wu) and torch.equal(gv, wv)


def test_fused_fits_of_two_layouts_back_to_back(fit_layouts):
    """Graphs of two layouts and ranks, captured one after the other in one
    process (K1's workspace grows between them), each equal to the eager
    loop bit for bit."""
    got = [_fit(fit_layouts[name], 4, solver) for name, solver in
           (("bench", "cholesky"), ("wide", "cholesky"), ("bench", "cg"), ("wide", "cg"))]
    want = [_fit(fit_layouts[name], 4, solver, graph=False) for name, solver in
            (("bench", "cholesky"), ("wide", "cholesky"), ("bench", "cg"), ("wide", "cg"))]
    for (gu, gv, _), (wu, wv, _) in zip(got, want):
        assert torch.equal(gu, wu) and torch.equal(gv, wv)


def test_fused_fit_capture_that_syncs_raises(fit_layouts, monkeypatch):
    """A host sync in a half-sweep fails the capture: the fit raises, names
    itself, and runs no eager iteration after iteration 0; a later fit
    captures and replays as usual."""
    land, landed = ops_als.land_rows, []

    def syncing(target, pool, landing):
        out = land(target, pool, landing)
        landed.append(float(out[0, 0]))  # a host sync: allowed eagerly, refused in a capture
        return out

    monkeypatch.setattr(ops_als, "land_rows", syncing)
    with pytest.raises(RuntimeError, match=r"ALS fit \(cholesky, rank 50.*CUDA graph capture failed"):
        _fit(fit_layouts["bench"], 5)
    assert len(landed) == 2  # iteration 0's two half-sweeps only
    monkeypatch.undo()
    got, want = _fit(fit_layouts["bench"], 3), _fit(fit_layouts["bench"], 3, graph=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fused_fit_beside_a_serving_thread(fit_layouts):
    """Another thread that launches K5, allocates and copies to the host
    during graph fits (as serving threads do) neither fails the fits nor
    lands in their graphs, and each of its launches counts once."""
    want = _fit(fit_layouts["bench"], 6, graph=False)
    rng = np.random.default_rng(5)
    q, items = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device="cuda")
                for shape in ((64, 50), (20000, 50)))
    stop, errors, calls = threading.Event(), [], [0]

    def serve():
        try:
            while not stop.is_set():
                _, idx = ops_topk.topk_scores(q, items, 30)
                idx.cpu()
                calls[0] += 1
        except Exception as exc:  # noqa: BLE001 - the test reports it
            errors.append(exc)

    kernels.reset_launches()
    worker = threading.Thread(target=serve)
    worker.start()
    try:
        got = [_fit(fit_layouts["bench"], 6) for _ in range(3)]
    finally:
        stop.set()
        worker.join(timeout=60)
    assert not worker.is_alive() and not errors and calls[0] > 0
    assert all(torch.equal(g[0], want[0]) and torch.equal(g[1], want[1]) for g in got)
    assert kernels.LAUNCHES["topk_scores"] == calls[0]


@pytest.mark.parametrize("solver", ["cholesky", "cg"])
def test_fused_fit_counts_the_eager_launches(fit_layouts, solver):
    kernels.reset_launches()
    _fit(fit_layouts["wide"], 26, solver, graph=False)
    eager = kernels.launch_counts()
    kernels.reset_launches()
    _fit(fit_layouts["wide"], 26, solver)
    graph = kernels.launch_counts()
    assert graph == eager and sum(graph.values()) > 0


def test_fused_fits_share_one_pool(fit_layouts):
    """Three graph fits in a row hold no more than one fit's memory pool: a
    fit's graph goes when it returns, and the next fit's capture reuses the
    thread's pool."""
    _fit(fit_layouts["bench"], 3)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    _fit(fit_layouts["bench"], 3)
    one = torch.cuda.memory_reserved()
    _fit(fit_layouts["bench"], 3)
    _fit(fit_layouts["bench"], 3)
    assert torch.cuda.memory_reserved() - one <= one - before


@pytest.mark.parametrize("count", [1, 2, 1000, 1441])
def test_adam_dense_device_pair_same_bits_as_values(dev, count):
    """Adam with its bias pair read from device memory (a row of
    ``ops.sgns.bias_table``) gives the bits of the pair passed by value."""
    rng = np.random.default_rng(count)
    shape = (2, 146, 200)
    base = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    base.append(np.abs(rng.normal(size=shape)).astype(np.float32) * 1e-3)
    table = ops_sgns.bias_table(1441, dev)
    res = []
    for arg in (count, table[count - 1]):
        p, g, m, v = (torch.as_tensor(a.copy(), device=dev) for a in base)
        kernels.reset_launches()
        ops_sgns.adam_dense(p, g, m, v, arg, 0.025)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["adam_dense"] == 1
        res.append((p, g, m, v))
    assert all(torch.equal(a, b) for a, b in zip(*res))


def _w2v_corpus(n=400):
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(60)]
    p = 1.0 / np.arange(1, 61) ** 1.1
    p /= p.sum()
    return [[words[i] for i in rng.choice(60, size=rng.integers(2, 12), p=p)] for _ in range(n)]


# K9 at a batch of one pair: one warp adds every term, in program order, so
# its sums have one order and a graph fit can be held to the eager loop bit
# for bit; at larger batches its atomics add in an order that changes from
# run to run. K9s sums in a fixed order at any batch.
W2V_LOOPS = {"K9": dict(dim=16, batch_size=1, shared_negatives=0),
             "K9s": dict(dim=16, batch_size=256, shared_negatives=32)}


def _w2v_fit(kind, epochs, graph, schedule=False):
    from albedo_tpu_torch.models.word2vec import Word2Vec

    est = Word2Vec(window=3, min_count=3, max_iter=epochs, subsample=0.0, seed=5, device="cuda", **W2V_LOOPS[kind])
    plan = est.plan(_w2v_corpus(60 if kind == "K9" else 400))
    draws = (None, None)
    if schedule:
        rng = np.random.default_rng(1)
        bs = min(est.batch_size, len(plan.centers))
        steps = len(plan.centers) // bs
        shape = (steps, est.shared_negatives) if est.shared_negatives else (steps, bs, est.negatives)
        draws = (None, [(rng.permutation(len(plan.centers)), rng.random(shape, dtype=np.float32))
                        for _ in range(epochs)])
    kernels.reset_launches()
    state, report = (est.train if graph else est.train_reference)(plan, torch.device("cuda"), *draws)
    torch.cuda.synchronize()
    return state, report, kernels.launch_counts()


@pytest.mark.parametrize("schedule", [False, True], ids=["drawn", "schedule"])
@pytest.mark.parametrize("epochs", [1, 2, 3])
@pytest.mark.parametrize("kind", ["K9", "K9s"])
def test_word2vec_graph_fit_same_bits_as_eager_loop(dev, kind, epochs, schedule):
    """K17: the Word2Vec fit replaying one captured epoch equals the eager
    loop (``train_reference``) bit for bit in tables, moments and per-epoch
    losses, launches what it launches, and leaves its generator where the
    eager loop does."""
    got, got_report, got_counts = _w2v_fit(kind, epochs, graph=True, schedule=schedule)
    want, want_report, want_counts = _w2v_fit(kind, epochs, graph=False, schedule=schedule)
    assert torch.equal(got["tables"], want["tables"])
    assert all(torch.equal(a, b) for a, b in zip(got["moments"], want["moments"]))
    assert got_report["epoch_loss"] == want_report["epoch_loss"] and len(got_report["epoch_loss"]) == epochs
    assert got_counts == want_counts and got_counts["adam_dense"] == got_report["steps"]
    assert (got_report["compile_source"] == "capture") == (epochs > 1) and got_report["compile_s"] >= 0.0
    assert torch.equal(torch.rand(8, generator=got["generator"], device=dev),
                       torch.rand(8, generator=want["generator"], device=dev))


def _bpr_data():
    from albedo_tpu_torch.datasets.synthetic import synthetic_stars

    m = synthetic_stars(n_users=60, n_items=40, mean_stars=8, seed=1)
    side = np.random.default_rng(0).normal(size=(m.n_items, 3)).astype(np.float32)
    return m, side


def _bpr_fit(epochs, graph, schedule):
    from albedo_tpu_torch.models.ranking_factorization import RankingFactorization

    m, side = _bpr_data()
    # A batch of one pair: K10's atomics then add in program order (one warp).
    est = RankingFactorization(rank=8, epochs=epochs, batch_size=1, device="cuda")
    sched = None
    if schedule:
        rng = np.random.default_rng(2)
        sched = [(rng.permutation(m.nnz), rng.integers(0, m.n_items, size=(m.nnz, 1, 4)).astype(np.int32))
                 for _ in range(epochs)]
    kernels.reset_launches()
    model = (est.fit if graph else est.fit_reference)(m, item_side=side, schedule=sched)
    torch.cuda.synchronize()
    return model, dict(est.last_fit_report), kernels.launch_counts(), est.last_fit_state


@pytest.mark.parametrize("schedule", [False, True], ids=["drawn", "schedule"])
@pytest.mark.parametrize("epochs", [1, 2, 10])
def test_bpr_graph_fit_same_bits_as_eager_loop(dev, epochs, schedule):
    """K18: the BPR fit replaying one captured epoch equals the eager loop
    (``fit_reference``) bit for bit, launches what it launches, and leaves
    its generator where the eager loop does."""
    got, got_report, got_counts, got_state = _bpr_fit(epochs, True, schedule)
    want, want_report, want_counts, want_state = _bpr_fit(epochs, False, schedule)
    for name in ("user_factors", "item_factors", "item_bias"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got_state["params"], want_state["params"])
    assert all(torch.equal(a, b) for a, b in zip(got_state["moments"], want_state["moments"]))
    assert got_report["epoch_loss"] == want_report["epoch_loss"] and len(got_report["epoch_loss"]) == epochs
    assert got_counts == want_counts and got_counts["bpr_step"] == got_report["steps"]
    assert (got_report["compile_source"] == "capture") == (epochs > 1)
    assert torch.equal(torch.rand(8, generator=got_state["generator"], device=dev),
                       torch.rand(8, generator=want_state["generator"], device=dev))


def test_graph_loop_captures_that_sync_raise(dev, monkeypatch):
    """A host sync in an epoch fails the capture: the Word2Vec and BPR fits
    raise ``RuntimeError`` naming themselves after their eager epoch 0; a
    later fit captures and replays as usual."""
    from albedo_tpu_torch.models import ranking_factorization as rf_mod
    from albedo_tpu_torch.models import word2vec as w2v_mod

    adam, seen = ops_sgns.adam_dense, []

    def syncing(p, *args):
        seen.append(float(p.reshape(-1)[0]))  # a host sync: allowed eagerly, refused in a capture
        return adam(p, *args)

    monkeypatch.setattr(w2v_mod, "adam_dense", syncing)
    with pytest.raises(RuntimeError, match=r"Word2Vec fit \(K9s, a pool of 32.*CUDA graph capture failed"):
        _w2v_fit("K9s", 2, graph=True)
    monkeypatch.setattr(rf_mod, "adam_dense", syncing)
    with pytest.raises(RuntimeError, match=r"BPR fit \(rank 8.*CUDA graph capture failed"):
        _bpr_fit(2, True, False)
    assert seen
    monkeypatch.undo()
    got, want = _w2v_fit("K9s", 3, graph=True), _w2v_fit("K9s", 3, graph=False)
    assert torch.equal(got[0]["tables"], want[0]["tables"])
