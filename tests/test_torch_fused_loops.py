"""The port's whole-loop fits, K17 (the Word2Vec epoch) and K18 (the BPR
fit), on the CPU: against the JAX package with its own draws, and their
graph loops' bookkeeping against the eager loops.

- The whole Word2Vec fit against JAX ``Word2Vec.fit_corpus``: a corpus of 30
  words, dim 8, batch 16 (4 steps an epoch), 3 epochs, with per-pair
  negatives (K9) and a shared pool of 4 (K9s). The test draws what the JAX
  fit draws (``albedo_tpu/models/word2vec.py``: the init from ``k_in``; per
  epoch ``key, k_perm``; per step ``k, k_neg``) and hands it to
  ``Word2Vec.train(init=, schedule=)``. The "in" table is held to atol 1e-5
  on 99% of its elements and 1e-4 on every one. Measured: largest gap
  5.3e-6 with per-pair negatives and 3.4e-5 with the pool, 99th percentile
  1.6e-6 and 1.7e-6 (float32 sums in another order, through 12 Adam
  steps). Adam divides each gradient element by its own running scale, so
  an element whose gradient is a near-cancellation moves by a visible
  fraction of its round-off's relative size: the pool's worst element, (12,
  1), moves 1.5e-6 to 4.2e-6 when the port's own init is perturbed by one
  float32 unit in the last place, the most of any element.
- Adam's device form (``ops.sgns.bias_table``, a row a step): each row is
  ``bias_corrections(t)``, and the plain version with the row equals the
  scalar form bit for bit.
- On the CPU ``Word2Vec.train`` is ``train_reference`` and
  ``RankingFactorization.fit`` is ``fit_reference``, bit for bit, with
  ``compile_s`` 0.0.
- The graph loops' bookkeeping (the static slice of Adam's corrections, the
  schedule's buffers, the loss slot, the generator handed to the graph),
  with ``utils.graphs.replay_loop`` replaced by a stand-in that runs the
  captured unit eagerly in place of each replay: equal to the eager loop
  bit for bit, generator state included. The graph itself runs only on the
  card (``tests/test_torch_cuda.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albedo_tpu.models.word2vec as jw2v
from albedo_tpu_torch.datasets.synthetic import synthetic_stars
from albedo_tpu_torch.models import ranking_factorization as rf_mod
from albedo_tpu_torch.models import word2vec as w2v_mod
from albedo_tpu_torch.ops.sgns import adam_dense, adam_dense_reference, bias_corrections, bias_table
from albedo_tpu_torch.utils import graphs

DIM, BATCH, EPOCHS, SEED = 8, 16, 3, 42


@pytest.fixture
def one_thread():
    """Torch's CPU ops on one thread: the fits run many small ops, which a
    pool of threads contending with other test processes for the cores
    slows."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _corpus():
    """30 words, each at least once, in 7 sentences of 6: 70 pairs at window 1."""
    rng = np.random.default_rng(3)
    ids = np.concatenate([rng.permutation(30), rng.integers(0, 30, size=12)])
    return [[f"w{i}" for i in ids[j:j + 6]] for j in range(0, 42, 6)]


def _estimator(shared, **kw):
    return dict(dim=DIM, window=1, min_count=1, max_iter=EPOCHS, batch_size=BATCH, subsample=0.0, seed=SEED,
                shared_negatives=shared, **kw)


def jax_w2v_draws(v_size, n_pairs, shared, negatives=5):
    """The JAX fit's init ("in" table) and, per epoch, its permutation and
    each step's uniforms, drawn as ``Word2Vec.fit_corpus`` draws them."""
    key = jax.random.PRNGKey(SEED)
    k_in, _ = jax.random.split(key)
    scale = 0.5 / DIM
    init = np.asarray(jax.random.uniform(k_in, (v_size, DIM), jnp.float32, -scale, scale))
    steps = n_pairs // BATCH
    neg_shape = (shared,) if shared else (BATCH, negatives)
    schedule = []
    for _ in range(EPOCHS):
        key, k_perm = jax.random.split(key)
        perm = np.asarray(jax.random.permutation(k_perm, n_pairs))
        uniforms = []
        for _ in range(steps):  # the scan's carried key
            key, k_neg = jax.random.split(key)
            uniforms.append(np.asarray(jax.random.uniform(k_neg, neg_shape, jnp.float32)))
        schedule.append((perm, np.stack(uniforms)))
    return init, schedule


@pytest.mark.parametrize("shared", [0, 4], ids=["K9", "K9s"])
def test_word2vec_fit_with_jax_draws_matches_jax(one_thread, shared):
    corpus = _corpus()
    want = jw2v.Word2Vec(**_estimator(shared)).fit_corpus(corpus)
    est = w2v_mod.Word2Vec(**_estimator(shared), device="cpu")
    plan = est.plan(corpus)
    assert plan.vocab == want.vocab and len(plan.vocab) == 30
    init, schedule = jax_w2v_draws(len(plan.vocab), len(plan.centers), shared)
    state, report = est.train(plan, torch.device("cpu"), init=init, schedule=schedule)
    assert report["steps"] == EPOCHS * 4 and report["compile_s"] == 0.0 and report["compile_source"] is None
    got = state["tables"][0].numpy()
    gap = np.abs(got - want.vectors)
    assert gap.max() <= 1e-4 and np.quantile(gap, 0.99) <= 1e-5, (gap.max(), np.quantile(gap, 0.99))
    assert not np.allclose(got, init, atol=1e-3)  # it trained


@pytest.mark.parametrize("count", [1, 2, 1000, 1441])
def test_adam_device_pair_equals_the_scalar_form(count):
    table = bias_table(1441, "cpu")
    assert table.shape == (1441, 2) and table.dtype == torch.float32
    assert tuple(table[count - 1].tolist()) == bias_corrections(count, 0.9, 0.999)
    rng = np.random.default_rng(count)
    base = [rng.normal(size=(2, 13, 7)).astype(np.float32) for _ in range(3)]
    base.append(np.abs(rng.normal(size=(2, 13, 7))).astype(np.float32) * 1e-3)  # v >= 0
    runs = []
    for fn, arg in ((adam_dense_reference, count), (adam_dense_reference, table[count - 1]),
                    (adam_dense, table[count - 1])):
        p, g, m, v = (torch.as_tensor(a.copy()) for a in base)
        fn(p, g, m, v, arg, 0.025)
        runs.append((p, g, m, v))
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _w2v_state(state, report):
    return (state["tables"], state["moments"], state["count"], report["epoch_loss"],
            state["generator"].get_state())


@pytest.mark.parametrize("scheduled", [False, True], ids=["drawn", "schedule"])
@pytest.mark.parametrize("shared", [0, 4], ids=["K9", "K9s"])
def test_word2vec_train_on_the_cpu_is_train_reference(one_thread, shared, scheduled):
    est = w2v_mod.Word2Vec(**_estimator(shared), device="cpu")
    plan = est.plan(_corpus())
    draws = jax_w2v_draws(len(plan.vocab), len(plan.centers), shared) if scheduled else (None, None)
    got = est.train(plan, torch.device("cpu"), *draws)
    want = est.train_reference(plan, torch.device("cpu"), *draws)
    assert _same(_w2v_state(*got), _w2v_state(*want))
    assert got[1]["compile_s"] == 0.0 and got[1]["compile_source"] is None


def _replay_eagerly(calls):
    """A stand-in for ``utils.graphs.replay_loop`` that runs the captured
    unit eagerly in place of each replay, recording what it was handed."""
    def replay_loop(name, dev, unit, n, *, refill=None, after=None, generators=(), report=None, span=""):
        calls.append({"name": name, "n": n, "generators": tuple(generators), "span": span})
        for i in range(n):
            if i and refill is not None:
                refill(i)
            unit(min(i, 1))
            if after is not None:
                after(i)
    return replay_loop


@pytest.mark.parametrize("epochs", [1, 2, 3])
@pytest.mark.parametrize("scheduled", [False, True], ids=["drawn", "schedule"])
@pytest.mark.parametrize("shared", [0, 4], ids=["K9", "K9s"])
def test_word2vec_graph_loop_bookkeeping_equals_the_eager_loop(one_thread, monkeypatch, shared, scheduled, epochs):
    calls = []
    monkeypatch.setattr(graphs, "replay_loop", _replay_eagerly(calls))
    est = w2v_mod.Word2Vec(**_estimator(shared), device="cpu")
    est = dataclasses.replace(est, max_iter=epochs)
    plan = est.plan(_corpus())
    draws = jax_w2v_draws(len(plan.vocab), len(plan.centers), shared) if scheduled else (None, None)
    fit = est._start(plan, torch.device("cpu"), *draws)
    got = est._train_graph(fit)
    want = est.train_reference(plan, torch.device("cpu"), *draws)
    assert _same(_w2v_state(*got), _w2v_state(*want))
    assert [c["n"] for c in calls] == [epochs] and calls[0]["generators"] == (fit.gen,)
    assert calls[0]["name"].startswith("Word2Vec fit (K9")


@pytest.fixture(scope="module")
def bpr_world():
    m = synthetic_stars(n_users=60, n_items=40, mean_stars=8, seed=1)
    side = np.random.default_rng(0).normal(size=(m.n_items, 2)).astype(np.float32)
    rng = np.random.default_rng(5)
    n_batches = m.nnz // 64
    schedule = [(rng.permutation(m.nnz), rng.integers(0, m.n_items, size=(n_batches, 64, 4)).astype(np.int32))
                for _ in range(3)]
    return m, side, schedule


def _bpr(est, model):
    return (model.user_factors, model.item_factors, model.item_bias, est.last_fit_report["epoch_loss"],
            est.last_fit_report["steps"], est.last_fit_state["params"], est.last_fit_state["moments"],
            est.last_fit_state["generator"].get_state())


@pytest.mark.parametrize("scheduled", [False, True], ids=["drawn", "schedule"])
def test_bpr_fit_on_the_cpu_is_fit_reference(bpr_world, one_thread, scheduled):
    m, side, schedule = bpr_world
    est = rf_mod.RankingFactorization(rank=8, epochs=3, batch_size=64, device="cpu")
    sched = schedule if scheduled else None
    got = _bpr(est, est.fit(m, item_side=side, schedule=sched))
    assert est.last_fit_report["compile_s"] == 0.0 and est.last_fit_report["compile_source"] is None
    want = _bpr(est, est.fit_reference(m, item_side=side, schedule=sched))
    assert _same(got, want)


@pytest.mark.parametrize("epochs", [1, 2, 3])
@pytest.mark.parametrize("scheduled", [False, True], ids=["drawn", "schedule"])
def test_bpr_graph_loop_bookkeeping_equals_the_eager_loop(bpr_world, one_thread, monkeypatch, scheduled, epochs):
    m, side, schedule = bpr_world
    calls = []
    monkeypatch.setattr(graphs, "replay_loop", _replay_eagerly(calls))
    est = rf_mod.RankingFactorization(rank=8, epochs=epochs, batch_size=64, device="cpu")
    sched = schedule if scheduled else None
    fit = est._start(m, side, None, sched, torch.device("cpu"))
    got = _bpr(est, est._fit_graph(fit))
    want = _bpr(est, est.fit_reference(m, item_side=side, schedule=sched))
    assert _same(got, want)
    assert [c["n"] for c in calls] == [epochs] and calls[0]["generators"] == (fit.gen,)
    assert calls[0]["name"].startswith("BPR fit (rank 8")
