"""The port's fused fit (``ops.als.fit_loop``) against the JAX package's
``als_fit_fused``, called directly on the same matrix's groups and landings
(each package's ``device_groups``) from one numpy init, on the CPU, where
``fit_loop`` is the eager loop; the launch record that counts a CUDA
graph's launches once a replay; and the fit report's compile fields.

Tolerances are those of ``tests/test_torch_models_als.py``'s docstring:
Cholesky atol 1e-4 (float32 round-off over the sweeps), one CG iteration
atol 1e-5, and one Cholesky iteration under bf16 gathers atol 1e-5
(measured 6.6e-7). One CG iteration under bf16 gathers is held, as that
docstring holds bf16 CG fits, by held-out NDCG@30 within 3e-3: its factors
cannot meet 1e-5. Compiled for the CPU, XLA keeps the CG diagonal's ``y *
y`` in float32 (excess precision), which moves JAX's first half-sweep by
4.8e-3; op by op JAX's first half-sweep (the item table) is 8e-7 from the
port's, but the user table 1.5e-3, and 3.8e-4 when the port's sweep reads
JAX's own item table: a float32 round-off in another order flips bf16
roundings of the CG iterate (F9)."""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from albedo_tpu.datasets.synthetic import synthetic_stars
from albedo_tpu.models.als import ImplicitALS as JALS
from albedo_tpu.ops.als import als_fit_fused
from albedo_tpu_torch.datasets import random_split_by_user, sample_test_users
from albedo_tpu_torch.datasets.ragged import padded_rows
from albedo_tpu_torch.evaluators import RankingEvaluator, UserItems, user_actual_items
from albedo_tpu_torch.kernels import build
from albedo_tpu_torch.models.als import ALSModel, ImplicitALS
from albedo_tpu_torch.ops import als as tals

RANK, REG, ALPHA = 16, 0.5, 40.0


@pytest.fixture(scope="module")
def matrix():
    return synthetic_stars(n_users=400, n_items=300, mean_stars=20, seed=42)


@pytest.fixture
def one_thread():
    """Torch's CPU ops on one thread: a fit runs many small ops, which a pool
    of threads contending with other test processes for the cores slows."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _init(m, seed=7):
    rng = np.random.default_rng(seed)
    s = np.float32(1 / np.sqrt(RANK))
    return ((rng.standard_normal((m.n_users, RANK)) * s).astype(np.float32),
            (rng.standard_normal((m.n_items, RANK)) * s).astype(np.float32))


def _both(m, n_iter, solver, gather_dtype=None):
    """(port, JAX) (user_f, item_f) after ``n_iter`` fused iterations."""
    u0, v0 = _init(m)
    ug, ig, u_land, i_land = JALS(rank=RANK, chunked=False).device_groups(m)
    ju, jv = als_fit_fused(jnp.asarray(u0), jnp.asarray(v0), ug, ig, jnp.float32(REG), jnp.float32(ALPHA),
                           jnp.int32(n_iter), solver=solver, cg_steps=3, user_landing=u_land, item_landing=i_land,
                           gather_dtype=gather_dtype)
    tug, tig, tu_land, ti_land = ImplicitALS(rank=RANK, device="cpu").device_groups(m)
    tu, tv = tals.fit_loop(torch.as_tensor(u0), torch.as_tensor(v0), tug, tig, tu_land, ti_land, REG, ALPHA, n_iter,
                           solver=solver, cg_steps=3, gather_dtype=gather_dtype)
    return (tu.numpy(), tv.numpy()), (np.asarray(ju), np.asarray(jv))


@pytest.mark.parametrize("solver,n_iter,atol,gather_dtype", [
    ("cholesky", 1, 1e-4, None), ("cholesky", 2, 1e-4, None), ("cholesky", 8, 1e-4, None),
    ("cg", 1, 1e-5, None), ("cholesky", 1, 1e-5, "bfloat16"),
])
def test_fit_loop_matches_als_fit_fused(matrix, one_thread, solver, n_iter, atol, gather_dtype):
    (tu, tv), (ju, jv) = _both(matrix, n_iter, solver, gather_dtype)
    np.testing.assert_allclose(tu, ju, atol=atol)
    np.testing.assert_allclose(tv, jv, atol=atol)


def test_bf16_cg_fit_loop_ndcg_matches_als_fit_fused(matrix, one_thread):
    """One CG iteration under bf16 gathers: the held-out NDCG@30 of each
    package's tables, both scored by the port, within 3e-3."""
    train, test = random_split_by_user(matrix, test_ratio=0.2, seed=42)
    (tu, tv), (ju, jv) = _both(train, 1, "cg", "bfloat16")
    users = sample_test_users(train, n=200, seed=42)
    indptr, cols, _ = train.csr()
    excl = padded_rows(indptr, cols, users)
    actual = user_actual_items(test, k=30)

    def ndcg(u, v):
        _, idx = ALSModel(torch.tensor(u), torch.tensor(v), RANK).recommend(users, k=30, exclude_idx=excl)
        return RankingEvaluator(metric_name="ndcg@k", k=30, device="cpu").evaluate(
            UserItems(users, idx.astype(np.int32)), actual)

    t_ndcg, j_ndcg = ndcg(tu, tv), ndcg(ju, jv)
    assert abs(t_ndcg - j_ndcg) <= 3e-3, (t_ndcg, j_ndcg)


def test_fit_loop_is_the_reference_on_the_cpu(matrix, one_thread):
    """On CPU tensors ``fit_loop`` is ``fit_loop_reference``: the same bits,
    the callback after every iteration, and nothing captured."""
    u0, v0 = _init(matrix)
    ug, ig, u_land, i_land = ImplicitALS(rank=RANK, device="cpu").device_groups(matrix)
    args = (ug, ig, u_land, i_land, REG, ALPHA, 3)
    seen, report = [], {}
    got = tals.fit_loop(torch.as_tensor(u0), torch.as_tensor(v0), *args,
                        callback=lambda it, u, v: seen.append((it, u.clone(), v.clone())), report=report)
    want = tals.fit_loop_reference(torch.as_tensor(u0), torch.as_tensor(v0), *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [it for it, _, _ in seen] == [0, 1, 2]
    assert torch.equal(seen[-1][1], got[0]) and torch.equal(seen[-1][2], got[1])
    assert report == {"compile_s": 0.0, "compile_source": None}


@pytest.fixture
def counts():
    """``LAUNCHES`` set to 0 for the test and restored after it."""
    saved = dict(build.LAUNCHES)
    for name in build.LAUNCHES:
        build.LAUNCHES[name] = 0
    yield build.LAUNCHES
    build.LAUNCHES.update(saved)


CAPTURE_STREAM = 0x5EED  # a raw stream handle standing for a capture's


def test_launch_record_counts_replays_not_captures(counts):
    record = build.LaunchRecord(CAPTURE_STREAM)
    with record:  # a "capture": K1 + K2 for two groups, then K4
        for name in ("als_partials", "solve_corrected", "als_partials_wide", "solve_corrected_wide", "land_rows"):
            build.count_launch(name, CAPTURE_STREAM)
        build.count_launch("land_rows", CAPTURE_STREAM)
    assert sum(counts.values()) == 0
    assert record.counts == {"als_partials": 1, "solve_corrected": 1, "als_partials_wide": 1,
                             "solve_corrected_wide": 1, "land_rows": 2}
    record.replayed()
    record.replayed(times=3)
    assert counts["als_partials"] == counts["solve_corrected_wide"] == 4 and counts["land_rows"] == 8
    build.count_launch("bucket_cg", CAPTURE_STREAM)  # the record is closed: counted at once
    assert counts["bucket_cg"] == 1 and "bucket_cg" not in record.counts


def test_launch_record_leaves_other_threads_alone(counts):
    """Launches of other threads onto their own streams during a capture
    count at once, in ``LAUNCHES``, and never in the capture's record: 16
    threads count 500 launches each while one thread records 500 onto the
    capture's stream, with thread switches forced often, and no count is
    lost."""
    record, start = build.LaunchRecord(CAPTURE_STREAM), threading.Barrier(17)

    def other():
        start.wait(timeout=30)
        for _ in range(500):
            build.count_launch("gather_topk", threading.get_ident())

    def capture():
        with record:
            start.wait(timeout=30)
            for _ in range(500):
                build.count_launch("bucket_cg", CAPTURE_STREAM)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=other) for _ in range(16)]
        for t in threads:
            t.start()
        capture()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counts["gather_topk"] == 16 * 500 and counts["bucket_cg"] == 0
    assert record.counts == {"bucket_cg": 500}
    with record, pytest.raises(RuntimeError, match="already open"):
        build.LaunchRecord(CAPTURE_STREAM).__enter__()


@pytest.mark.parametrize("max_iter", [0, 1, 3])
def test_fit_report_carries_compile_fields(matrix, one_thread, max_iter):
    est = ImplicitALS(rank=8, max_iter=max_iter, init_factors=None, device="cpu")
    est.fit(matrix)
    report = est.last_fit_report
    assert report["compile_s"] == 0.0 and report["compile_source"] is None
    assert report["device_s"] >= 0.0 and report["health"]["nonfinite"] == 0
