"""The port's serving path (K6, the micro-batcher, the service) against the
JAX package's on the CPU, and against its own direct path.

Both packages serve the same factor tables (seeded numpy, loaded into each
package's ``ALSModel``) over the same synthetic star matrix. Tolerances:

- port batched against port direct: byte-identical (the same arithmetic on
  each user's row, whatever batch it rides in);
- port against JAX (``ALSModel.recommend``, the JAX service's direct path,
  ``_gather_topk``): the same item lists up to near-ties, scores within
  1e-5 of the largest score (XLA's dot and the port's ordered multiply-adds
  round differently, by ~1e-7 here).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from albedo_tpu.datasets import synthetic_tables as j_tables
from albedo_tpu.models.als import ALSModel as JaxModel
from albedo_tpu.serving import RecommendationService as JaxService
from albedo_tpu.serving.batcher import _gather_topk, _gather_topk_device_excl
from albedo_tpu_torch.datasets import synthetic_tables
from albedo_tpu_torch.datasets.ragged import padded_rows
from albedo_tpu_torch.models.als import ALSModel
from albedo_tpu_torch.ops import topk as ops_topk
from albedo_tpu_torch.retrieval.parity import candidate_parity
from albedo_tpu_torch.serving import (
    BatcherClosed,
    DeadlineExceeded,
    MicroBatcher,
    QueueOverflow,
    RecommendationService,
)

RANK = 8
TOL = 1e-5


@pytest.fixture(scope="module")
def world():
    tables = synthetic_tables(n_users=150, n_items=700, mean_stars=10, seed=5)
    matrix = tables.star_matrix(policy="off")
    rng = np.random.default_rng(3)
    uf = (rng.standard_normal((matrix.n_users, RANK)) / np.sqrt(RANK)).astype(np.float32)
    vf = (rng.standard_normal((matrix.n_items, RANK)) / np.sqrt(RANK)).astype(np.float32)
    vf[300:320] = vf[:20]  # exact ties
    model = ALSModel.from_arrays({"user_factors": uf, "item_factors": vf, "rank": RANK}, device="cpu")
    j_matrix = j_tables(n_users=150, n_items=700, mean_stars=10, seed=5).star_matrix(policy="off")
    assert np.array_equal(j_matrix.user_ids, matrix.user_ids) and j_matrix.nnz == matrix.nnz
    return tables, matrix, model, j_matrix, JaxModel(uf, vf, RANK)


def _pairs(body):
    return [(i["repo_id"], i["score"]) for i in body["items"]]


def _assert_near(got_ids, got_scores, want_ids, want_scores):
    """Port against JAX: equal lists up to near-ties, scores within TOL of
    the largest score."""
    scale = max(1.0, float(np.max(np.abs(want_scores))) if len(want_scores) else 1.0)
    report = candidate_parity((np.asarray(want_ids), np.asarray(want_scores, np.float64)),
                              (np.asarray(got_ids), np.asarray(got_scores, np.float64)), atol=TOL * scale)
    assert report["ok"], report


@pytest.mark.parametrize("mode", ["none", "host", "device"])
def test_gather_topk_reference_matches_jax(world, mode):
    _, matrix, model, _, _ = world
    uf, vf = model.device_factors()
    indptr, cols, _ = matrix.csr()
    table = padded_rows(indptr, cols, np.arange(matrix.n_users))
    user_idx = np.array([5, 0, 149, 5, 77, 3, 3, 120], dtype=np.int32)
    if mode == "device":
        jv, ji = _gather_topk_device_excl(jnp.asarray(uf.numpy()), jnp.asarray(vf.numpy()),
                                          jnp.asarray(table), jnp.asarray(user_idx), k=32, item_block=256)
        tv, ti = ops_topk.gather_topk_reference(uf, vf, torch.as_tensor(user_idx), 32,
                                                exclude_table=torch.as_tensor(table))
    else:
        excl = table[user_idx] if mode == "host" else None
        jv, ji = _gather_topk(jnp.asarray(uf.numpy()), jnp.asarray(vf.numpy()), jnp.asarray(user_idx),
                              None if excl is None else jnp.asarray(excl), k=32, item_block=256)
        tv, ti = ops_topk.gather_topk_reference(uf, vf, torch.as_tensor(user_idx), 32,
                                                exclude=None if excl is None else torch.as_tensor(excl))
    for b in range(len(user_idx)):
        _assert_near(ti[b].numpy(), tv[b].numpy(), np.asarray(ji[b]), np.asarray(jv[b]))
    # The wrapper on CPU tensors is the plain version; with a packed output
    # buffer it fills both halves.
    out = torch.empty((2, len(user_idx), 32))
    kw = ({"exclude_table": torch.as_tensor(table)} if mode == "device"
          else {"exclude": torch.as_tensor(table[user_idx])} if mode == "host" else {})
    gv, gi = ops_topk.gather_topk(uf, vf, torch.as_tensor(user_idx), 32, out=out, **kw)
    assert torch.equal(gi, ti) and torch.equal(gv, tv) and torch.equal(out[0], tv)


def test_recommend_at_the_service_max_k(world):
    """K5 keeps k up to 512, the service's max_k = 500 rounded up to a power
    of two (it stopped at 128 before, so ``recommend(k=500)`` raised on the
    card): the port answers k = 500 and 512 as JAX does, and k > 512 raises
    on the CPU as on the card."""
    _, matrix, model, _, j_model = world
    users = np.array([0, 7, 42], dtype=np.int64)
    indptr, cols, _ = matrix.csr()
    excl = padded_rows(indptr, cols, users)
    for k in (500, 512):
        tv, ti = model.recommend(users, k=k, exclude_idx=excl)
        jv, ji = j_model.recommend(users, k=k, exclude_idx=excl)
        assert tv.shape == (3, k)
        for b in range(3):
            real = ti[b] >= 0
            np.testing.assert_array_equal(real, np.asarray(ji[b]) >= 0)
            _assert_near(ti[b][real], tv[b][real], np.asarray(ji[b])[real], np.asarray(jv[b])[real])
    assert ops_topk.KMAX == 512
    with pytest.raises(ValueError, match="k in 1..512"):
        model.recommend(users, k=513)


def _mixes(matrix, n=40, seed=0):
    """n requests over 10 users (so the JAX direct path compiles for few
    exclusion widths)."""
    rng = np.random.default_rng(seed)
    users = rng.choice(matrix.user_ids, size=10, replace=False)
    return [int(u) for u in rng.choice(users, size=n)]


def _fire(service, uids, k, exclude_seen):
    """40 requests from 4 threads, each a handle_recommend call."""
    results: list = [None] * len(uids)

    def worker(lo: int, hi: int) -> None:
        for i in range(lo, hi):
            results[i] = service.handle_recommend(uids[i], k=k, exclude_seen=exclude_seen)

    threads = [threading.Thread(target=worker, args=(i * 10, (i + 1) * 10)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return results


@pytest.mark.parametrize("mode", ["device", "host", "none"])
@pytest.mark.parametrize("k", [3, 7, 30, 500])
def test_batched_byte_identical_to_direct_and_near_jax(world, monkeypatch, k, mode):
    tables, matrix, model, j_matrix, j_model = world
    if mode == "host":
        monkeypatch.setenv("ALBEDO_SERVE_EXCL_TABLE_MAX", "0")  # too wide: host rows
    exclude_seen = mode != "none"
    uids = _mixes(matrix, seed=k)
    with RecommendationService(model, matrix, batching=False) as direct, \
         RecommendationService(model, matrix, batching=True, batch_window_ms=5.0) as batched, \
         JaxService(j_model, j_matrix, batching=False) as jax_direct:
        assert batched.batcher.device_exclusion == (mode != "host")
        results = _fire(batched, uids, k, exclude_seen)
        for uid, (status, body) in zip(uids, results):
            assert status == 200 and body["k"] == k and body["generation"] == 1
            base = direct.recommend(uid, k=k, exclude_seen=exclude_seen)
            assert _pairs(body) == _pairs(base)  # byte-identical, ties included
            ref = jax_direct.recommend(uid, k=k, exclude_seen=exclude_seen)
            got = np.array([i["repo_id"] for i in body["items"]]), np.array([i["score"] for i in body["items"]])
            want = np.array([i["repo_id"] for i in ref["items"]]), np.array([i["score"] for i in ref["items"]])
            _assert_near(*got, *want)
            if exclude_seen:
                indptr, cols, _ = matrix.csr()
                row = matrix.users_of(np.array([uid]))[0]
                assert not set(got[0]) & set(matrix.item_ids[cols[indptr[row]:indptr[row + 1]]])
        assert batched.batcher.requests_served == len(uids)


def test_warm_launches_the_ladder(world):
    _, matrix, model, _, _ = world
    with RecommendationService(model, matrix, max_batch=8, warm=True) as svc:
        assert svc.batcher.warmed
        again = svc.batcher.warm(ks=(30,))
        assert set(again) == {(b, 32, m) for b in (1, 2, 4, 8) for m in ("device", "none")}
        assert set(again.values()) == {"memory"}


def test_batcher_rows_equal_recommend_exactly(world):
    _, _, model, _, _ = world
    batcher = MicroBatcher(model, window_ms=5.0)
    try:
        users = np.arange(16, dtype=np.int64)
        base_vals, base_idx = model.recommend(users, k=10)
        futs = [batcher.submit(int(u), 10) for u in users]
        got = [f.result(timeout=30) for f in futs]
        np.testing.assert_array_equal(np.stack([v for v, _ in got]), base_vals)
        np.testing.assert_array_equal(np.stack([i for _, i in got]), base_idx)
    finally:
        batcher.stop()


def _wedged(model, **kw):
    """A batcher whose worker blocks in its first batch until released."""
    batcher = MicroBatcher(model, window_ms=0.0, **kw)
    release, entered = threading.Event(), threading.Event()
    real = batcher._execute

    def slow_execute(k, mode, reqs):
        entered.set()
        release.wait(timeout=30)
        real(k, mode, reqs)

    batcher._execute = slow_execute
    return batcher, release, entered


def test_queue_overflow_raises_with_retry_after(world):
    _, _, model, _, _ = world
    batcher, release, entered = _wedged(model, max_queue=2)
    try:
        first = batcher.submit(0, 5)
        assert entered.wait(timeout=10)
        batcher.submit(1, 5)
        batcher.submit(2, 5)
        with pytest.raises(QueueOverflow) as err:
            batcher.submit(3, 5)
        assert 1.0 <= err.value.retry_after_s <= 30.0
        release.set()
        assert first.result(timeout=30)[1].shape == (5,)
    finally:
        release.set()
        batcher.stop()


def test_deadline_shed_before_compute(world):
    _, _, model, _, _ = world
    batcher, release, entered = _wedged(model)
    try:
        batcher.submit(0, 5)
        assert entered.wait(timeout=10)
        late = batcher.submit(1, 5, deadline=time.monotonic() + 0.01)
        time.sleep(0.05)
        release.set()
        with pytest.raises(DeadlineExceeded):
            late.result(timeout=30)
    finally:
        release.set()
        batcher.stop()


def test_stop_drains_queued_work_then_refuses(world):
    _, _, model, _, _ = world
    batcher, release, entered = _wedged(model)
    futs = [batcher.submit(u, 5) for u in range(3)]
    assert entered.wait(timeout=10)
    release.set()
    batcher.stop(drain=True)
    assert all(f.result(timeout=30)[1].shape == (5,) for f in futs)
    with pytest.raises(BatcherClosed):
        batcher.submit(0, 5)
    assert not batcher._worker.is_alive()


def test_stop_without_drain_fails_queued_futures(world):
    _, _, model, _, _ = world
    batcher, release, entered = _wedged(model)
    batcher.submit(0, 5)
    assert entered.wait(timeout=10)
    queued = batcher.submit(1, 5)
    stopper = threading.Thread(target=batcher.stop, kwargs={"drain": False})
    stopper.start()
    time.sleep(0.05)
    release.set()
    stopper.join(timeout=30)
    with pytest.raises(BatcherClosed):
        queued.result(timeout=30)


def test_out_of_range_and_unknown_users(world):
    _, matrix, model, _, _ = world
    batcher = MicroBatcher(model)
    try:
        with pytest.raises(IndexError):
            batcher.submit(matrix.n_users, 5)
        with pytest.raises(IndexError):
            batcher.submit(-1, 5)
        with pytest.raises(ValueError, match="exclude_table"):
            batcher.submit(0, 5, exclude=True)
    finally:
        batcher.stop()
    with RecommendationService(model, matrix) as svc:
        status, body = svc.handle_recommend(-12345, k=5)
        assert status == 404 and body == {"user_id": -12345, "error": "unknown user", "items": []}


def test_exclusion_wider_than_the_kernels_take_raises(world):
    _, matrix, model, _, _ = world
    wide = np.full((matrix.n_users, ops_topk.EXCLUDE_MAX + 1), -1, dtype=np.int32)
    with pytest.raises(ValueError, match="already-seen"):
        MicroBatcher(model, exclude_table=wide)


def test_two_stage_options_are_not_ported(world):
    _, matrix, model, _, _ = world
    for kw in ({"recommenders": {"popularity": object()}}, {"ranker": object()},
               {"bank_stage": object()}):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            RecommendationService(model, matrix, **kw)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        RecommendationService(None, matrix)
