"""The host plans of K11 ``spmm_rows`` and K9s ``sgns_shared`` in Python, on
the CPU: which entries each unit of work sums and in what order.

- ``ops.spmm.spmm_units``: every entry of a CSR in exactly one unit, whole
  rows up to ``SPMM_CHUNK`` entries, longer rows in consecutive chunks whose
  partial slots the finishing pass adds in chunk order; a model of the
  kernel's sums on that plan (float64, rounded once) matches the plain
  version to 1e-6 of each element's L1 mass (as the card holds the kernel).
- ``ops.sgns.k9s_pieces``: the sorted (word, pair) keys cut into ranges of
  ``K9S_RANGE``, every position in exactly one piece, each run of a word
  either whole in one range or a tail, heads in range order and one
  finisher.
- A model of K9s's fixed order (float32: the pair rows, the range walk, the
  pieces in range order, the pool's split partials in split order then its
  slots in slot order, the loss slots) against the gradient and loss of the
  JAX module's ``loss_fn`` (shared branch): atol 1e-6 and rtol 1e-6, as the
  plain version is held in ``test_torch_models_word2vec.py``.
- F8's check (``ops.sgns.sgns_shared_limits``): that model passes it, and
  faults planted in its result (``kernels.spmm_sgns_bench.k9s_faults``: a
  dropped pair of the hot center, a split of G^T Vc left out, TF32
  operands) are refused; the limits stay under their cap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from albedo_tpu_torch.ops import sgns, spmm

CHUNK = spmm.SPMM_CHUNK


def _indptr(counts):
    return np.concatenate([[0], np.cumsum(np.asarray(counts, dtype=np.int64))])


SPMM_CASES = {
    "short rows": np.random.default_rng(0).integers(0, 30, size=200),
    "chunk edges": [CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK, 2 * CHUNK + 1, 0, 1],
    "power-law head": [6690, 0, 3, 1089, 0, 0, 5],
    "all empty": [0, 0, 0],
    "one long row": [3 * CHUNK + 7],
}


@pytest.mark.parametrize("case", list(SPMM_CASES))
def test_spmm_units_cover_every_entry_once(case):
    indptr = _indptr(SPMM_CASES[case])
    units, long_rows = spmm.spmm_units(indptr)
    lens = np.diff(indptr)
    covered = np.zeros(int(indptr[-1]), dtype=np.int64)
    for row, lo, hi, _ in units:
        assert indptr[row] <= lo <= hi <= indptr[row + 1] and hi - lo <= CHUNK
        covered[lo:hi] += 1
    assert (covered == 1).all()
    assert sorted(set(units[:, 0].tolist())) == list(range(len(lens)))  # every row, empty ones too
    assert (np.diff(units[:, 0]) >= 0).all() and (np.diff(units[:, 1]) >= 0).all()  # rows, then entries, in order
    split = lens[units[:, 0]] > CHUNK
    assert (units[~split, 3] == -1).all()
    assert units[split, 3].tolist() == list(range(int(split.sum())))  # slots in chunk order
    assert long_rows[:, 0].tolist() == np.flatnonzero(lens > CHUNK).tolist()
    for row, first, n in long_rows:
        mine = units[units[:, 0] == row]
        assert mine[:, 3].tolist() == list(range(first, first + n))
        assert mine[0, 1] == indptr[row] and mine[-1, 2] == indptr[row + 1]


def _spmm_plan_model(w, x):
    """spmm_rows as its plan sums: each unit in float64 in entry order, a
    long row's chunk partials added in chunk order, rounded once."""
    indptr, idx = w.indptr.numpy(), w.idx.numpy()
    val = np.ones(len(idx)) if w.val is None else w.val.numpy().astype(np.float64)
    units, long_rows = spmm.spmm_units(indptr)
    xd = x.numpy().astype(np.float64)
    out = np.zeros((w.n_rows, x.shape[1]))
    part = {}
    for row, lo, hi, slot in units:
        acc = np.zeros(x.shape[1])
        for e in range(lo, hi):
            acc = acc + val[e] * xd[idx[e]]
        if slot < 0:
            out[row] = acc
        else:
            part[slot] = acc
    for row, first, n in long_rows:
        total = np.zeros(x.shape[1])
        for s in range(first, first + n):
            total = total + part[s]
        out[row] = total
    return torch.as_tensor(out.astype(np.float32))


@pytest.mark.parametrize("with_val", [True, False])
def test_spmm_plan_model_matches_plain(with_val):
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 20, size=60)
    counts[[4, 9]] = (CHUNK + 1, 3 * CHUNK + 5)
    indptr = _indptr(counts)
    idx = rng.integers(0, 50, size=int(indptr[-1])).astype(np.int32)
    val = rng.uniform(0.1, 1.0, size=idx.size).astype(np.float32) if with_val else None
    w = spmm.CSR.from_host(indptr, idx, val, 50, "cpu")
    x = torch.as_tensor(rng.uniform(size=(50, 9)).astype(np.float32))
    got, want, mass = _spmm_plan_model(w, x), spmm.spmm_rows_reference(w, x), spmm.spmm_rows_mass(w, x)
    assert bool(((got - want).abs() <= 1e-6 * mass).all())


def _runs(lengths, v_offset=0):
    return np.repeat(np.arange(len(lengths)) + v_offset, lengths)


R = sgns.K9S_RANGE
PIECE_CASES = {
    "short runs": _runs(np.random.default_rng(1).integers(1, 9, size=80)),
    "range edges": _runs([R, R, 1, R - 1, R + 1, 2 * R, 3]),
    "a run across many ranges": _runs([5, 7 * R + 3, 2]),
    "one run": _runs([4 * R]),
    "one position": _runs([1]),
}


@pytest.mark.parametrize("case", list(PIECE_CASES))
def test_k9s_pieces_cover_every_position_once(case):
    keys = PIECE_CASES[case]
    n = len(keys)
    pieces, finishers = sgns.k9s_pieces(keys)
    covered = np.zeros(n, dtype=np.int64)
    for r, lo, hi, _ in pieces:
        assert r * R <= lo < hi <= min(n, (r + 1) * R) and (keys[lo:hi] == keys[lo]).all()
        covered[lo:hi] += 1
    assert (covered == 1).all()
    finished = {key for _, key, _ in finishers}
    for key in np.unique(keys):
        at = np.flatnonzero(keys == key)
        first_r, last_r = at[0] // R, at[-1] // R
        kinds = [kind for r, lo, hi, kind in pieces if keys[lo] == key]
        if first_r == last_r:
            assert kinds == ["whole"] and int(key) not in finished
        else:
            assert kinds == ["tail"] + ["head"] * (last_r - first_r)
            assert [(r, f) for r, k, f in finishers if k == key] == [(last_r, first_r)]


# K9s's plan (csrc/sgns_shared.cu sgns_shared_plan) at the model's batch of
# 300 pairs, d 8, K 16: G^T Vc in 38 splits of one 8-pair slice; and at the
# refscale step (B 65 536, d 200, K 512). The card test
# ``tests/test_torch_cuda.py::test_k9s_plan_fits_the_batch`` reads both from
# the library.
K9S_PLANS = {(300, 8, 16): {"chunk": 8, "splits": 38, "ranges": 10, "n_pos": 38, "n_neg": 3},
             (65536, 200, 512): {"chunk": 1000, "splits": 66, "ranges": 2048, "n_pos": 8192, "n_neg": 2048}}


def _k9s_order_model(in_t, out_t, c, o, pool, neg_scale):
    """K9s in its own order, float32 on the CPU (the products as torch
    sums them; the sums into the tables as the kernel adds them)."""
    b, d, k, v = c.shape[0], in_t.shape[1], pool.shape[0], in_t.shape[0]
    plan = K9S_PLANS[(b, d, k)]
    inv_b = np.float32(1.0 / b)
    gs = np.float32(np.float32(neg_scale) * inv_b)
    vc, vo, vn = in_t[c.long()], out_t[o.long()], out_t[pool.long()]
    pos = (vc * vo).sum(dim=1)
    g = -torch.sigmoid(-pos) * inv_b
    logits = vc @ vn.T
    G = torch.sigmoid(logits) * gs
    H = G @ vn + g[:, None] * vo
    grads = [torch.zeros_like(in_t), torch.zeros_like(out_t)]
    keys, perm = sgns.k9s_keys(c, o, v)
    keys, perm = keys.numpy(), perm.numpy()

    def value(p):
        q = int(perm[p])
        return H[q] if q < b else g[q - b] * in_t[int(c[q - b])]

    def add(key, total):
        table, row = (0, key) if key < v else (1, key - v)
        grads[table][row] += total

    pieces, finishers = sgns.k9s_pieces(keys)
    part = {}
    for r, lo, hi, kind in pieces:
        acc = torch.zeros(d)
        for p in range(lo, hi):
            acc = acc + value(p)
        if kind == "whole":
            add(int(keys[lo]), acc)
        else:
            part[(r, 0 if kind == "head" else 1)] = acc
    for r, key, first in finishers:
        total = part[(first, 1)]
        for i in range(first + 1, r + 1):
            total = total + part[(i, 0)]
        add(key, total)
    chunk = plan["chunk"]
    splits = [G[s:s + chunk].T @ vc[s:s + chunk] for s in range(0, b, chunk)]
    P = splits[0]
    for s in splits[1:]:
        P = P + s
    seen = set()
    for slot in range(k):
        w = int(pool[slot])
        if w in seen:
            continue
        seen.add(w)
        total = P[slot]
        for later in range(slot + 1, k):
            if int(pool[later]) == w:
                total = total + P[later]
        grads[1][w] += total
    bce_pos = F.binary_cross_entropy_with_logits(pos, torch.ones_like(pos), reduction="sum")
    bce_neg = F.binary_cross_entropy_with_logits(logits, torch.zeros_like(logits), reduction="sum")
    return grads[0], grads[1], bce_pos * inv_b + bce_neg * gs


def _k9s_small(case):
    """The order model's batch: B 300 (the hot center's run crosses ranges),
    d 8, K 16, V 50; a hot center and a pool word that is also a context,
    or a pool of one word."""
    rng = np.random.default_rng(9)
    v, d, b, k = 50, 8, 300, 16
    tables = {"in": rng.uniform(-0.3, 0.3, size=(v, d)).astype(np.float32),
              "out": rng.normal(scale=0.2, size=(v, d)).astype(np.float32)}
    c = rng.integers(0, v, size=b).astype(np.int32)
    o = rng.integers(0, v, size=b).astype(np.int32)
    pool = rng.integers(0, v, size=k).astype(np.int32)
    if case == "a hot center":
        c[: 2 * R + 9] = 2
        pool[:5] = o[0]
    else:
        pool[:] = 7
    return tables, c, o, pool


@pytest.mark.parametrize("case", ["a hot center", "a pool of one word"])
def test_k9s_order_model_matches_jax(case):
    """K9s's fixed order at a small size (B 300, so the hot center's run
    crosses ranges; d 8, K 16, V 50) against the JAX ``loss_fn``'s gradient
    and loss."""
    neg = 5
    tables, c, o, pool = _k9s_small(case)
    loss_j, grad_j = jax.value_and_grad(_jax_shared_loss)(
        {key: jnp.asarray(t) for key, t in tables.items()}, jnp.asarray(c), jnp.asarray(o), jnp.asarray(pool), neg)
    gi, go, loss = _k9s_order_model(torch.as_tensor(tables["in"]), torch.as_tensor(tables["out"]),
                                    *(torch.as_tensor(a) for a in (c, o, pool)), neg / len(pool))
    np.testing.assert_allclose(gi.numpy(), np.asarray(grad_j["in"]), atol=1e-6)
    np.testing.assert_allclose(go.numpy(), np.asarray(grad_j["out"]), atol=1e-6)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-6)


@pytest.mark.parametrize("case", ["a hot center", "a pool of one word"])
def test_k9s_limits_pass_the_order_model_and_refuse_faults(case):
    """F8's check at the order model's batch: the model (K9s's own order in
    float32) against the plain version in float64 is within
    ``sgns_shared_limits``; a dropped pair of the hot center, G^T Vc's
    first split left out and TF32-rounded tables are each refused."""
    from albedo_tpu_torch.kernels.spmm_sgns_bench import k9s_faults

    tables, c, o, pool = _k9s_small(case)
    in_t, out_t = torch.as_tensor(tables["in"]), torch.as_tensor(tables["out"])
    ids = [torch.as_tensor(a) for a in (c, o, pool)]
    scale = 5 / len(pool)
    got = _k9s_order_model(in_t, out_t, *ids, scale)
    got = (got[0], got[1], got[2].reshape(1))
    dd = [t.double() for t in (in_t, out_t)]
    want = (torch.zeros_like(dd[0]), torch.zeros_like(dd[1]), torch.zeros(1, dtype=torch.float64))
    sgns.sgns_shared_step_reference(*dd, *ids, *want, scale)
    plan = K9S_PLANS[(len(c), in_t.shape[1], len(pool))]
    limits = sgns.sgns_shared_limits(in_t, out_t, *ids, scale, plan)
    assert sgns.sgns_shared_over(got, want, limits) <= 1.0
    faults = k9s_faults(in_t, out_t, *ids, scale, got, want, limits, plan)
    for name in ("dropped pair", "split left out", "tf32 operands"):
        assert faults[name] > 1.0, name


def _jax_shared_loss(p, c_idx, o_idx, pool, neg):
    """The shared branch of albedo_tpu/models/word2vec.py ``loss_fn``."""
    vc = p["in"][c_idx]
    pos_logit = jnp.sum(vc * p["out"][o_idx], axis=1)
    neg_logits = vc @ p["out"][pool].T
    pos_loss = optax.sigmoid_binary_cross_entropy(pos_logit, jnp.ones_like(pos_logit))
    neg_loss = optax.sigmoid_binary_cross_entropy(neg_logits, jnp.zeros_like(neg_logits)).sum(axis=1)
    return (pos_loss + neg_loss * (neg / pool.shape[0])).mean()


def test_k9s_limits_cover_an_underflowed_term():
    """A positive logit of 100, as a trained refscale table gives: g_b =
    -sigmoid(-100) / B is below float32's range, so K9s's term into the
    context's row is 0 where the plain version in float64 has ~1e-46. The
    limits' underflow floor admits it, and still refuse a dropped pair."""
    from albedo_tpu_torch.kernels.spmm_sgns_bench import k9s_faults

    tables, c, o, pool = _k9s_small("a hot center")
    d = tables["in"].shape[1]
    tables = {"in": np.vstack([tables["in"], np.full((2, d), 5.0, np.float32)]),  # words 50 and 51
              "out": np.vstack([tables["out"], np.full((2, d), 2.5, np.float32)])}
    c[-1], o[-1] = 50, 51  # <vc, vo> = 8 x 12.5; word 51 is no other pair's context nor in the pool
    in_t, out_t = torch.as_tensor(tables["in"]), torch.as_tensor(tables["out"])
    ids = [torch.as_tensor(a) for a in (c, o, pool)]
    got = _k9s_order_model(in_t, out_t, *ids, 5 / len(pool))
    got = (got[0], got[1], got[2].reshape(1))
    dd = [t.double() for t in (in_t, out_t)]
    want = (torch.zeros_like(dd[0]), torch.zeros_like(dd[1]), torch.zeros(1, dtype=torch.float64))
    sgns.sgns_shared_step_reference(*dd, *ids, *want, 5 / len(pool))
    assert float(got[1][51].abs().max()) == 0.0 < float(want[1][51].abs().max()) < 2.0**-149
    limits = sgns.sgns_shared_limits(in_t, out_t, *ids, 5 / len(pool), K9S_PLANS[(300, 8, 16)])
    assert sgns.sgns_shared_over(got, want, limits) <= 1.0
    faults = k9s_faults(in_t, out_t, *ids, 5 / len(pool), got, want, limits, K9S_PLANS[(300, 8, 16)])
    assert faults["dropped pair"] > 1.0


def test_k9s_tol_stays_under_the_cap():
    """F8's limits, at the refscale step's depths (a center in a third of
    the batch, a tenth of the pool one word), for a term whose logit is
    exact, stay far under the cap they are held to (5e-5 x max(1, B /
    4096) of each element's mass), and ``sgns_shared_limits`` on small
    batches is positive where an element has mass and at most the cap (of
    the mass, or of float32's smallest normal where the mass is less)."""
    depths = sgns.sgns_shared_depths(K9S_PLANS[(65536, 200, 512)], 512, 21845, 52)
    assert max(sgns.K9S_LAMBDA * 2.0**-24 * np.sqrt(dep) for dep in depths) < sgns.sgns_shared_cap(65536) / 10
    rng = np.random.default_rng(2)
    plan = {"chunk": 8, "splits": 125, "ranges": 32, "n_pos": 125, "n_neg": 32}
    for b in (1, 7, 1000):
        in_t = torch.as_tensor(rng.uniform(-0.5, 0.5, size=(97, 200)).astype(np.float32))
        out_t = torch.as_tensor(rng.normal(size=(97, 200)).astype(np.float32))
        ids = [torch.as_tensor(rng.integers(0, 97, size=n).astype(np.int32)) for n in (b, b, 512)]
        lim_in, lim_out, lim_loss = sgns.sgns_shared_limits(in_t, out_t, *ids, 5 / 512, plan)
        mass = sgns.sgns_shared_grad_mass(in_t.double(), out_t.double(), *ids, 5 / 512)
        for lim, m in zip((lim_in, lim_out), mass):
            assert bool(((lim > 0) == (m > 0)).all())
            assert bool((lim <= sgns.sgns_shared_cap(b) * m.clamp_min(2.0**-126)).all())
        assert 0 < lim_loss


def test_k9s_plain_version_keeps_large_positive_logits():
    """F8's reference, the plain version in float64, forms sigmoid(pos) - 1
    as -sigmoid(-pos), as the JAX ``loss_fn``'s log_sigmoid does: at a
    positive logit of 40 the gradient into the context's row is
    -sigmoid(-40) vc / B (the kernel's form), not 0, and that element's
    mass is not 0."""
    in_t = torch.zeros((3, 4), dtype=torch.float64)
    out_t = torch.zeros((3, 4), dtype=torch.float64)
    in_t[0], out_t[1], out_t[2] = 2.0, 5.0, -0.1  # pos = 40; the pool word's logit -0.8
    c, o, pool = (torch.tensor(a, dtype=torch.int32) for a in ([0], [1], [2]))
    grads = (torch.zeros_like(in_t), torch.zeros_like(out_t), torch.zeros(1, dtype=torch.float64))
    sgns.sgns_shared_step_reference(in_t, out_t, c, o, pool, *grads, 5.0)
    want = -torch.sigmoid(torch.tensor(-40.0, dtype=torch.float64)) * in_t[0]
    torch.testing.assert_close(grads[1][1], want, rtol=1e-12, atol=0.0)
    assert bool((sgns.sgns_shared_grad_mass(in_t, out_t, c, o, pool, 5.0)[1][1] > 0).all())
