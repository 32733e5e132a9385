"""The port's Word2Vec against the JAX package's, on the CPU.

- The host half (vocab, subsampling, dynamic windows, skip-gram pairs) is
  byte-identical: both draw from ``np.random.default_rng(seed)``.
- One to three SGNS + Adam steps on injected (center, context, negatives)
  and tables match the JAX formula (``loss_fn`` of the JAX module, autodiff,
  ``optax.adam(0.025)``): loss rtol 1e-6, gradients and tables atol 1e-6
  (float32 sums in another order; duplicate rows in the batch exercise the
  accumulation). The same with a shared negative pool (K9s, the shared
  branch of ``loss_fn``), with repeated pool slots.
- Seeded fits cannot match (torch's generator is not ``jax.random``), so the
  fitted model is held to the JAX package's own cluster test, with per-pair
  negatives and with a shared pool of 32.
- ``sgns_grad_mass`` and ``sgns_shared_grad_mass``, the scales the K9 and
  K9s kernels are held to on the card (5e-5 of each gradient element's L1
  mass): the float32 step lies within it of the float64 step, and a step
  whose last negative slot is scaled by 1.001 does not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import albedo_tpu.models.word2vec as jw2v
from albedo_tpu_torch.models.word2vec import Word2Vec, Word2VecModel, skipgram_pairs
from albedo_tpu_torch.ops.sgns import (
    adam_dense,
    sgns_grad_mass,
    sgns_shared_grad_mass,
    sgns_shared_step,
    sgns_shared_step_reference,
    sgns_step,
    sgns_step_reference,
)


def _corpus(seed=0, n=400):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(60)]
    p = 1.0 / np.arange(1, 61) ** 1.1
    p /= p.sum()
    return [[words[i] for i in rng.choice(60, size=rng.integers(0, 12), p=p)] for _ in range(n)]


@pytest.mark.parametrize("subsample", [0.0, 1e-3])
def test_vocab_and_pairs_byte_identical(monkeypatch, subsample):
    captured = {}
    orig = jw2v.skipgram_pairs

    def capture(ids, lengths, b):
        captured["pairs"] = orig(ids, lengths, b)
        return captured["pairs"]

    monkeypatch.setattr(jw2v, "skipgram_pairs", capture)
    corpus = _corpus()
    kw = dict(dim=4, window=5, min_count=3, max_iter=1, subsample=subsample, seed=11, batch_size=256)
    jm = jw2v.Word2Vec(**kw).fit_corpus(corpus)
    plan = Word2Vec(**kw, device="cpu").plan(corpus)
    assert plan.vocab == jm.vocab
    assert plan.centers.dtype == captured["pairs"][0].dtype
    np.testing.assert_array_equal(plan.centers, captured["pairs"][0])
    np.testing.assert_array_equal(plan.contexts, captured["pairs"][1])


def test_skipgram_pairs_match_jax():
    rng = np.random.default_rng(3)
    lengths = rng.integers(0, 9, size=50)
    ids = rng.integers(0, 30, size=int(lengths.sum())).astype(np.int32)
    b = rng.integers(1, 6, size=ids.size)
    for a, e in zip(skipgram_pairs(ids, lengths, b), jw2v.skipgram_pairs(ids, lengths, b)):
        np.testing.assert_array_equal(a, e)


def _jax_loss(p, c_idx, o_idx, neg_idx, neg=5):
    """``loss_fn`` of albedo_tpu/models/word2vec.py: per-pair negatives for
    a (B, K) ``neg_idx``; the shared branch for a (K,) pool, whose negative
    term is scaled by ``neg / K``."""
    vc = p["in"][c_idx]
    if neg_idx.ndim == 1:
        shared = neg_idx.shape[0]
        pos_logit = jnp.sum(vc * p["out"][o_idx], axis=1)
        neg_logits = vc @ p["out"][neg_idx].T
        pos_loss = optax.sigmoid_binary_cross_entropy(pos_logit, jnp.ones_like(pos_logit))
        neg_loss = optax.sigmoid_binary_cross_entropy(
            neg_logits, jnp.zeros_like(neg_logits)
        ).sum(axis=1) * (neg / shared)
        return (pos_loss + neg_loss).mean()
    rows = jnp.concatenate([o_idx[:, None], neg_idx], axis=1)
    logits = jnp.einsum("bd,bkd->bk", vc, p["out"][rows])
    labels = jnp.zeros_like(logits).at[:, 0].set(1.0)
    return optax.sigmoid_binary_cross_entropy(logits, labels).sum(axis=1).mean()


@pytest.mark.parametrize("shared", [0, 7])
def test_sgns_adam_steps_match_jax_formula(shared):
    """K9's (``shared = 0``) or K9s's (a pool of ``shared`` slots) plain
    version and Adam, three steps, against the JAX formula."""
    rng = np.random.default_rng(5)
    v_size, d, b, k = 13, 8, 40, 5
    tables = {
        "in": rng.uniform(-0.3, 0.3, size=(v_size, d)).astype(np.float32),
        "out": rng.normal(scale=0.2, size=(v_size, d)).astype(np.float32),
    }
    batches = []
    for _ in range(3):
        c = rng.integers(0, v_size, size=b).astype(np.int32)
        c[:6] = 2  # duplicate centers
        o = rng.integers(0, v_size, size=b).astype(np.int32)
        neg = rng.integers(0, v_size, size=(b, k)).astype(np.int32)
        neg[:, :2] = 0  # duplicate negatives
        if shared:
            neg = rng.integers(0, v_size, size=shared).astype(np.int32)
            neg[:3] = 4  # repeated pool slots
            neg[3] = o[0]  # a pool word that is also a context
        batches.append((c, o, neg))

    opt = optax.adam(0.025)
    params = {key: jnp.asarray(v) for key, v in tables.items()}
    state = opt.init(params)
    t = {key: torch.tensor(v) for key, v in tables.items()}
    grads = {key: torch.zeros_like(v) for key, v in t.items()}
    moments = {key: (torch.zeros_like(v), torch.zeros_like(v)) for key, v in t.items()}
    for step, (c, o, neg) in enumerate(batches, start=1):
        loss_j, g = jax.value_and_grad(_jax_loss)(params, jnp.asarray(c), jnp.asarray(o), jnp.asarray(neg))
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)

        loss_t = torch.zeros(1)
        step_args = (t["in"], t["out"], torch.as_tensor(c), torch.as_tensor(o), torch.as_tensor(neg),
                     grads["in"], grads["out"], loss_t)
        if shared:
            sgns_shared_step(*step_args, k / shared)
        else:
            sgns_step(*step_args)
        np.testing.assert_allclose(grads["in"].numpy(), np.asarray(g["in"]), atol=1e-6)
        np.testing.assert_allclose(grads["out"].numpy(), np.asarray(g["out"]), atol=1e-6)
        for key in ("in", "out"):
            adam_dense(t[key], grads[key], *moments[key], step, 0.025)
            assert float(grads[key].abs().max()) == 0.0  # zeroed for the next step
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
        for key in ("in", "out"):
            np.testing.assert_allclose(t[key].numpy(), np.asarray(params[key]), atol=1e-6, err_msg=key)


@pytest.fixture(scope="module", params=[0, 32], ids=["per_pair", "shared_32"])
def w2v_clusters(request):
    """The JAX package's cluster world (tests/test_models.py), fit by the
    port with per-pair negatives and with a shared pool of 32."""
    rng = np.random.default_rng(0)
    a = ["apple", "banana", "cherry", "grape"]
    b = ["python", "jax", "compiler", "kernel"]
    sentences = []
    for _ in range(500):
        pool = a if rng.random() < 0.5 else b
        sentences.append([pool[i] for i in rng.integers(0, 4, size=6)])
    model = Word2Vec(
        dim=16, window=3, min_count=1, max_iter=25, batch_size=512, subsample=0.0, seed=1,
        shared_negatives=request.param, device="cpu",
    ).fit_corpus(sentences)
    return a, b, model


def test_w2v_clusters_separate(w2v_clusters):
    a, b, model = w2v_clusters
    v = model.vectors / (np.linalg.norm(model.vectors, axis=1, keepdims=True) + 1e-9)
    idx = {w: i for i, w in enumerate(model.vocab)}
    within = np.mean([v[idx[x]] @ v[idx[y]] for x in a for y in a if x != y])
    across = np.mean([v[idx[x]] @ v[idx[y]] for x in a for y in b])
    assert within > 0.8
    assert across < 0.5
    syn = [w for w, _ in model.find_synonyms("apple", k=3)]
    assert set(syn) <= set(a) - {"apple"}


def test_model_from_jax_arrays_transforms_like_jax():
    import pandas as pd

    rng = np.random.default_rng(8)
    vocab = [f"t{i}" for i in range(20)]
    vectors = rng.normal(size=(20, 6)).astype(np.float32)
    jm = jw2v.Word2VecModel(vocab=vocab, vectors=vectors)
    tm = Word2VecModel.from_arrays(jm.to_arrays())
    docs = [["t1", "t3", "oov"], [], ["oov"], ["t19", "t19", "t0"]]
    df = pd.DataFrame({"words": docs})
    got = np.stack(tm.transform(df)["words__w2v"])
    want = np.stack(jm.transform(df)["words__w2v"])
    np.testing.assert_array_equal(got, want)
    assert tm.find_synonyms("t4", k=5) == jm.find_synonyms("t4", k=5)


def test_unported_options_raise():
    est = Word2Vec(dim=4, min_count=1, max_iter=2, batch_size=16, shared_negatives=8, device="cpu")
    model = est.fit_corpus(_corpus(n=20))  # shared negatives are ported
    assert np.isfinite(model.vectors).all() and np.isfinite(est.last_fit_report["epoch_loss"]).all()
    with pytest.raises(NotImplementedError):
        Word2Vec(mesh=object(), device="cpu").fit_corpus(_corpus(n=20))


def _grad_out_scaled(in_t, out_t, c, o, neg, last_slot_scale):
    """grad_out of one SGNS step with the last negative slot's terms scaled."""
    rows = torch.cat([o.long()[:, None], neg.long()], dim=1)
    vc = in_t[c.long()]
    logits = torch.einsum("bd,bkd->bk", vc, out_t[rows])
    labels = torch.zeros_like(logits)
    labels[:, 0] = 1.0
    w = torch.ones(rows.shape[1], dtype=in_t.dtype)
    w[-1] = last_slot_scale
    g = (torch.sigmoid(logits) - labels) / rows.shape[0] * w
    terms = (g[..., None] * vc[:, None, :]).reshape(-1, in_t.shape[1])
    return torch.zeros_like(out_t).index_add_(0, rows.reshape(-1), terms)


def test_grad_mass_bounds_round_off_and_catches_a_slot_fault():
    rng = np.random.default_rng(11)
    v, d, b, k = 146, 200, 4096, 5
    in_t = torch.tensor(rng.uniform(-0.5 / d, 0.5 / d, size=(v, d)).astype(np.float32))
    out_t = torch.tensor(rng.normal(scale=0.1, size=(v, d)).astype(np.float32))
    c = rng.integers(0, v, size=b).astype(np.int32)
    c[: b // 3] = 1   # one center row takes a third of the batch
    neg = rng.integers(0, v, size=(b, k)).astype(np.int32)
    neg[:, 0] = 0     # one negative row takes every pair
    args = [torch.as_tensor(a) for a in (c, rng.integers(0, v, size=b).astype(np.int32), neg)]
    res = {}
    for dt in (torch.float32, torch.float64):
        g = (torch.zeros(v, d, dtype=dt), torch.zeros(v, d, dtype=dt), torch.zeros(1, dtype=dt))
        sgns_step_reference(in_t.to(dt), out_t.to(dt), *args, *g)
        res[dt] = g
    mass = [m.double() for m in sgns_grad_mass(in_t, out_t, *args)]
    for got, exact, m in zip(res[torch.float32], res[torch.float64], mass):
        assert bool(((got.double() - exact).abs() <= 5e-5 * m).all())
    faulty = _grad_out_scaled(in_t.double(), out_t.double(), *args, 1.001)
    assert float(((faulty - res[torch.float64][1]).abs() / mass[1].clamp_min(1e-300)).max()) > 5e-5


@pytest.mark.parametrize("b", [2048, 65536])
def test_shared_grad_mass_bounds_round_off_and_catches_a_slot_fault(b):
    """K9s's mass at the reference scale's d and K: the float32 step within
    5e-5 x max(1, B / 4096) of the float64 step's mass (the bound the card
    holds K9s to: K9's, scaled with the terms a sum adds beyond K9's batch),
    and a step whose last pool slot's terms are scaled by 1 + 0.001 x
    max(1, B / 4096) outside it."""
    rng = np.random.default_rng(12)
    v, d, k, neg = 146, 200, 512, 5
    tol = 5e-5 * max(1.0, b / 4096)
    in_t = torch.tensor(rng.uniform(-0.5 / d, 0.5 / d, size=(v, d)).astype(np.float32))
    out_t = torch.tensor(rng.normal(scale=0.1, size=(v, d)).astype(np.float32))
    c = rng.integers(0, v, size=b).astype(np.int32)
    c[: b // 3] = 1   # one center row takes a third of the batch
    pool = rng.integers(0, v, size=k).astype(np.int32)
    pool[: k // 4] = 0  # one word takes a quarter of the pool
    args = [torch.as_tensor(a) for a in (c, rng.integers(0, v, size=b).astype(np.int32), pool)]
    res = {}
    for dt in (torch.float32, torch.float64):
        g = (torch.zeros(v, d, dtype=dt), torch.zeros(v, d, dtype=dt), torch.zeros(1, dtype=dt))
        sgns_shared_step_reference(in_t.to(dt), out_t.to(dt), *args, *g, neg / k)
        res[dt] = g
    mass = [m.double() for m in sgns_shared_grad_mass(in_t, out_t, *args, neg / k)]
    for got, exact, m in zip(res[torch.float32], res[torch.float64], mass):
        assert bool(((got.double() - exact).abs() <= tol * m).all())
    vc = in_t.double()[args[0].long()]
    gn = torch.sigmoid(vc @ out_t.double()[pool].T) * (neg / k / b)
    fault = 0.001 * max(1.0, b / 4096) * gn[:, -1:].T @ vc
    last = torch.zeros_like(out_t, dtype=torch.float64).index_add_(0, args[2][-1:].long(), fault)
    assert float((last.abs() / mass[1].clamp_min(1e-300)).max()) > tol
