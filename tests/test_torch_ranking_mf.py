"""K10 and the ranking factorization in the port against the JAX package on
the CPU.

Torch cannot reproduce ``jax.random``, so the JAX module's own draws — the
initial factors (``ranking_factorization.py:134-142``) and, per epoch, the
permutation and the negatives (``:172-178``, keys split as at ``:192``) — are
made here with ``jax.random`` and handed to the port's ``fit`` as ``init``
and ``schedule``. Tolerances:

- one step's loss and gradients (``bpr_step_reference`` against
  ``jax.value_and_grad`` of the JAX loss): rtol 1e-5, atol 1e-8 (float32,
  another summation order of the batch means);
- factors and item bias after 2 epochs of 7 Adam steps: every element within
  2e-4 and 99% of them within 5e-5 (measured on this configuration: largest
  gap 6.9e-5 on the factors and 4.5e-6 on the bias, 99th percentile 2.2e-5).
  The gradients agree to 1e-8 after one step; Adam then divides each
  gradient element by its own running scale, so the round-off of an element
  that is a near-cancellation of larger terms (x_u's (y_pos - y_neg) sums)
  moves its parameter by a visible fraction of the learning rate, 0.05;
- ``recommend`` on the JAX model's arrays (``from_arrays``): the same item
  indices, ties included, and scores within 1e-6 (K5's plain version sums the
  33 products in index order, XLA in its own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from albedo_tpu.datasets import synthetic_stars as jax_stars
from albedo_tpu.models import ranking_factorization as jax_rf
from albedo_tpu_torch.datasets.synthetic import synthetic_stars
from albedo_tpu_torch.models.ranking_factorization import RankingFactorization, RankingFactorizationModel
from albedo_tpu_torch.ops.bpr import bpr_grad_mass, bpr_loss, bpr_step, bpr_step_reference

RANK, EPOCHS, BATCH, NEG, SEED = 8, 2, 256, 4, 42


def jax_draws(n_users, n_items, n_pairs, rank=RANK, epochs=EPOCHS, batch=BATCH, negatives=NEG, seed=SEED):
    """The JAX fit's init and per-epoch (permutation, negatives), drawn as
    ``RankingFactorization.fit`` draws them."""
    kx, ky, kshuf = jax.random.split(jax.random.PRNGKey(seed), 3)
    scale = 0.1 / np.sqrt(rank)
    init = (np.asarray(jax.random.normal(kx, (n_users, rank), jnp.float32) * scale),
            np.asarray(jax.random.normal(ky, (n_items, rank), jnp.float32) * scale))
    n_batches = max(1, n_pairs // batch)
    schedule = []
    for ekey in jax.random.split(kshuf, epochs):
        pkey, nkey = jax.random.split(ekey)
        perm = jax.random.permutation(pkey, n_pairs)[: n_batches * batch]
        negs = jax.random.randint(nkey, (n_batches, batch, negatives), 0, n_items)
        schedule.append((np.asarray(perm), np.asarray(negs)))
    return init, schedule


@pytest.fixture(scope="module")
def world():
    m = synthetic_stars(n_users=150, n_items=90, mean_stars=10, seed=17)
    side = np.random.default_rng(0).normal(size=(m.n_items, 2)).astype(np.float32)
    return m, jax_stars(n_users=150, n_items=90, mean_stars=10, seed=17), side


def test_fit_with_jax_draws_matches_jax(world):
    m, jm, side = world
    kw = dict(rank=RANK, epochs=EPOCHS, batch_size=BATCH, negatives=NEG, seed=SEED)
    want = jax_rf.RankingFactorization(**kw).fit(jm, item_side=side)
    init, schedule = jax_draws(m.n_users, m.n_items, m.nnz)
    est = RankingFactorization(**kw, device="cpu")
    got = est.fit(m, item_side=side, init=init, schedule=schedule)
    assert est.last_fit_report["steps"] == EPOCHS * (m.nnz // BATCH)
    for a, b in ((got.user_factors, want.user_factors), (got.item_factors, want.item_factors),
                 (got.item_bias, want.item_bias)):
        gap = np.abs(a - b)
        assert gap.max() <= 2e-4 and np.quantile(gap, 0.99) <= 5e-5, (gap.max(), np.quantile(gap, 0.99))
    assert not np.allclose(got.item_factors, init[1], atol=1e-3)  # it trained


def _jax_loss(p, g, u, i_pos, i_neg, reg):
    """``loss_fn`` of ``albedo_tpu/models/ranking_factorization.py:145-163``."""
    def item_score(u_vec, items):
        return jnp.einsum("bk,b...k->b...", u_vec, p["y"][items]) + p["b"][items] + g[items] @ p["w"]

    u_vec = p["x"][u]
    diff = item_score(u_vec, i_pos)[:, None] - item_score(u_vec, i_neg)
    return -jax.nn.log_sigmoid(diff).mean() + reg * (
        (u_vec**2).sum(axis=1).mean() + (p["y"][i_pos] ** 2).sum(axis=1).mean()
        + (p["y"][i_neg] ** 2).sum(axis=(1, 2)).mean()
    )


def _batch(rng, n_users=30, n_items=20, r=8, d=2, b=64):
    arrays = [rng.normal(scale=0.3, size=s).astype(np.float32)
              for s in ((n_users, r), (n_items, r), (n_items,), (d,), (n_items, d))]
    users = rng.integers(0, n_users, size=b).astype(np.int32)
    users[:20] = 3                                   # a hot user
    pos = rng.integers(0, n_items, size=b).astype(np.int32)
    neg = rng.integers(0, n_items, size=(b, NEG)).astype(np.int32)
    neg[::4, 0] = pos[::4]                           # negatives equal to the positive
    return arrays, (users, pos, neg)


@pytest.mark.parametrize("reg", [1e-4, 0.1])
def test_bpr_step_reference_matches_jax_value_and_grad(reg):
    (x, y, b, w, g), (users, pos, neg) = _batch(np.random.default_rng(1))
    p = {"x": jnp.asarray(x), "y": jnp.asarray(y), "b": jnp.asarray(b), "w": jnp.asarray(w)}
    loss, grads = jax.value_and_grad(_jax_loss)(p, jnp.asarray(g), users, pos, neg, reg)
    t = [torch.as_tensor(a) for a in (x, y, b, w)]
    acc = [torch.zeros_like(a) for a in t]
    loss_acc = torch.zeros(1)
    batch = [torch.as_tensor(a) for a in (users, pos, neg)]
    bpr_step(*t, torch.as_tensor(g), *batch, *acc, loss_acc, reg)   # CPU: the plain version
    np.testing.assert_allclose(loss_acc.item(), float(loss), rtol=1e-5)
    for got, name in zip(acc, "xybw"):
        np.testing.assert_allclose(got.numpy(), np.asarray(grads[name]), rtol=1e-5, atol=1e-8)
    assert float(bpr_loss(*t, torch.as_tensor(g), *batch, reg)) == pytest.approx(float(loss), rel=1e-5)


def test_grad_mass_bounds_the_gradient_and_catches_a_fault():
    (x, y, b, w, g), (users, pos, neg) = _batch(np.random.default_rng(2))
    t = [torch.as_tensor(a, dtype=torch.float64) for a in (x, y, b, w, g)]
    batch = [torch.as_tensor(a) for a in (users, pos, neg)]
    acc = [torch.zeros_like(a) for a in t[:4]]
    bpr_step_reference(*t, *batch, *acc, torch.zeros(1, dtype=torch.float64), 0.1)
    mass = bpr_grad_mass(*t, *batch, 0.1)
    for grad, m in zip(acc, mass):
        assert bool((grad.abs() <= m * (1 + 1e-12)).all())
        assert bool((grad[m == 0] == 0).all())
    # A wrong row in one negative slot (an indexing fault a kernel can make)
    # errs by far more than the 5e-5 of mass that chip_smoke.py allows the
    # kernel's atomics.
    faulty = [torch.zeros_like(a) for a in t[:4]]
    neg2 = batch[2].clone()
    neg2[:, 1] = (neg2[:, 1] + 1) % 20
    bpr_step_reference(*t, batch[0], batch[1], neg2, *faulty, torch.zeros(1, dtype=torch.float64), 0.1)
    assert float(((faulty[1] - acc[1]).abs() / mass[1].clamp_min(1e-300)).max()) > 1e-2


def test_recommend_from_jax_arrays_matches_jax():
    rng = np.random.default_rng(4)
    arrays = {"user_factors": rng.normal(size=(40, 32)).astype(np.float32),
              "item_factors": rng.normal(size=(300, 32)).astype(np.float32),
              "item_bias": rng.normal(size=300).astype(np.float32), "rank": np.int64(32)}
    arrays["item_factors"][200:220] = arrays["item_factors"][:20]   # exact ties
    arrays["item_bias"][200:220] = arrays["item_bias"][:20]
    users = np.arange(0, 40, 3)
    excl = np.full((users.size, 12), -1, np.int32)
    excl[:, :10] = rng.integers(0, 300, size=(users.size, 10))
    want = jax_rf.RankingFactorizationModel.from_arrays(arrays).recommend(users, k=30, exclude_idx=excl)
    model = RankingFactorizationModel.from_arrays(arrays, device="cpu")
    got = model.recommend(users, k=30, exclude_idx=excl)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    assert model.to_arrays()["rank"] == 32
    np.testing.assert_allclose(model.score(users[:3], np.array([0, 1, 2])),
                               jax_rf.RankingFactorizationModel.from_arrays(arrays).score(users[:3], np.array([0, 1, 2])))


def test_seeded_fit_is_deterministic_and_trains(world):
    m, _, side = world
    fits = [RankingFactorization(rank=RANK, epochs=EPOCHS, batch_size=BATCH, device="cpu").fit(m, item_side=side)
            for _ in range(2)]
    np.testing.assert_array_equal(fits[0].item_factors, fits[1].item_factors)
    assert np.isfinite(fits[0].user_factors).all() and fits[0].item_bias.shape == (m.n_items,)
