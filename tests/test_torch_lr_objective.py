"""K19's redesign on the CPU: the LR objective on the flat parameter vector
(``ops.sparse_linear.LogisticObjective``, with the ``logloss`` kernel's
plain version ``logloss_reference``) and the L-BFGS direction
(``ops.lbfgs.lbfgs_direction``'s plain version), against the JAX package.

- The objective's value and gradient against
  ``jax.value_and_grad(weighted_logloss)`` of the JAX package, for one model
  and under ``jax.vmap`` for a 4-row weight grid, at the zero init (every
  logit 0: the tie slopes), at a small point, at a point whose logits pass
  +-35 and +-1e6 (driven there by the unpenalized bias and by two
  categories whose rows all pass +-1e6, so their gradient is the penalty's
  alone), and with a zero weight row. Loss rtol 1e-6, gradient atol 1e-6,
  NaN where NaN. The logits' cotangent of ``logloss_reference`` against
  JAX's at the same edge logits (one category a row, no penalty), atol
  1e-6; not at exactly +-1e6, where torch's clamp has slope 1 (the
  autograd objective's rule) and JAX's clip 0.5.
- The same objective against the port's autograd ``weighted_logloss`` (its
  plain version as a whole), and a grid row against the one-model
  objective on that row: the same bands.
- The plain direction against optax ``scale_by_lbfgs(10,
  scale_init_precond=True)`` followed by ``scale(-1)`` over 25 iterates of
  a quadratic (the memory wraps twice), for one row and vmapped over 4:
  each direction within 1e-5 of its max-norm, and its slope.
- The device loop, its one direction piece reading the count from the
  state (``utils.graphs.replay_while`` replaced by an eager stand-in),
  against the plain loops bit for bit at ``max_iter`` 1, 10, 11 and 25, and
  its pieces: the stale re-evaluation, one direction, 8 trials, the step.
- The fits against JAX at ``test_torch_models_lr.py``'s bands.

Many small torch ops: one thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from albedo_tpu.features.assembler import FeatureMatrix as JFM
from albedo_tpu.models.logistic_regression import LogisticRegression as JLR
from albedo_tpu.ops import sparse_linear as jsl
from albedo_tpu_torch.features.assembler import FeatureMatrix as TFM
from albedo_tpu_torch.models import logistic_regression as lr
from albedo_tpu_torch.ops import lbfgs
from albedo_tpu_torch.ops import sparse_linear as sl
from albedo_tpu_torch.utils import graphs
from test_torch_cuda import lr_problem
from test_torch_fused_lr import _replay_while_eagerly

F = np.float32
REG = 0.7


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    kw, y, w, ws = lr_problem(n=300)
    tfm = TFM(**kw)
    scales, center = sl.inverse_std_scales(tfm), sl.dense_center(tfm)
    layout = lr._Layout(sl.init_params(tfm))
    return dict(kw=kw, tfm=tfm, jfm=JFM(**kw), y=y, w=w, ws=ws, scales=scales, center=center, layout=layout)


def _points(pb) -> dict[str, np.ndarray]:
    """Flat parameter vectors: the zero init, a small point, and the edge
    point (bias 20, category 1 at +5e5 and 3 at -5e5 standardized: their
    rows' logits pass +-1e6, category 2's rows pass 35)."""
    layout, rng = pb["layout"], np.random.default_rng(1)
    size = layout.size
    small = (rng.normal(size=size) * 0.05).astype(F)
    edge = (rng.normal(size=size) * 0.01).astype(F)
    off = dict((k, o) for k, o, _ in layout.parts)
    edge[off["bias"]] = 20.0
    edge[off["cat:c"]:off["cat:c"] + 4] = [0.0, 5e5, 8.0, -5e5]
    return {"zero": np.zeros(size, F), "small": small, "edge": edge}


def _jax_params(pb, theta: np.ndarray) -> dict:
    out = {}
    for k, off, shape in pb["layout"].parts:
        n = int(np.prod(shape, dtype=np.int64))
        out[k] = jnp.asarray(theta[..., off:off + n].reshape(theta.shape[:-1] + shape))
    return out


def _jax_value_and_grad(pb, theta: np.ndarray, weights: np.ndarray):
    """JAX's value and flat gradient (vmapped over a leading grid axis)."""
    batch = jsl.feature_batch(pb["jfm"])
    scales = {k: jnp.asarray(v) for k, v in pb["scales"].items()}
    center = jnp.asarray(pb["center"])
    y = jnp.asarray(pb["y"])

    def one(params, w):
        return jax.value_and_grad(jsl.weighted_logloss)(params, scales, batch, y, w, REG, center=center)

    fn = jax.vmap(one) if theta.ndim == 2 else one
    value, grad = fn(_jax_params(pb, theta), jnp.asarray(weights))
    flat = np.concatenate([np.asarray(grad[k]).reshape(theta.shape[:-1] + (-1,)) for k, _, _ in pb["layout"].parts],
                          axis=-1)
    return np.asarray(value), flat


def _objective(pb, weights: np.ndarray) -> sl.LogisticObjective:
    batch = sl.feature_batch(pb["tfm"], "cpu", grad_layout=True)
    return sl.LogisticObjective(pb["layout"].sizes, pb["scales"], batch, torch.as_tensor(pb["y"]),
                                torch.as_tensor(weights), REG, torch.as_tensor(pb["center"]))


def _close(value, grad, want_value, want_grad):
    value, grad = np.asarray(value), np.asarray(grad)
    assert np.array_equal(np.isnan(value), np.isnan(want_value))
    assert np.array_equal(np.isnan(grad), np.isnan(want_grad))
    np.testing.assert_allclose(value, want_value, rtol=1e-6)
    np.testing.assert_allclose(grad, want_grad, rtol=0, atol=1e-6)


def _logits(pb, theta: np.ndarray) -> np.ndarray:
    batch = jsl.feature_batch(pb["jfm"])
    scales = {k: jnp.asarray(v) for k, v in pb["scales"].items()}
    return np.asarray(jsl.block_logits(_jax_params(pb, theta), scales, batch, center=jnp.asarray(pb["center"])))


def test_the_edge_point_reaches_both_clips(problem):
    z = _logits(problem, _points(problem)["edge"])
    assert (z > 1e6).any() and (z < -1e6).any() and ((z > 35) & (z < 1e6)).any()


@pytest.mark.parametrize("point", ["zero", "small", "edge"])
def test_objective_matches_jax_for_one_model(problem, one_thread, point):
    theta = _points(problem)[point]
    value, grad = _objective(problem, problem["w"]).value_and_grad(torch.as_tensor(theta))
    assert value.shape == () and grad.shape == theta.shape
    _close(value, grad, *_jax_value_and_grad(problem, theta, problem["w"]))
    if point == "zero":  # the tie: the bias gradient is -sum(w y) / sum(w)
        w, y = problem["w"].astype(np.float64), problem["y"]
        np.testing.assert_allclose(float(grad[0]), -np.sum(w * y) / np.sum(w), rtol=1e-6)


def test_objective_matches_jax_on_the_grid(problem, one_thread):
    """The four points (zero, small, edge, small) under the four weight
    rows; the last row's weights are all 0: NaN loss and gradient."""
    pts = _points(problem)
    theta = np.stack([pts["zero"], pts["small"], pts["edge"], pts["small"]])
    value, grad = _objective(problem, problem["ws"]).value_and_grad(torch.as_tensor(theta))
    assert value.shape == (4,) and grad.shape == theta.shape
    want_value, want_grad = _jax_value_and_grad(problem, theta, problem["ws"])
    assert np.isnan(want_value[3]) and np.isnan(want_grad[3]).any()
    _close(value, grad, want_value, want_grad)


@pytest.mark.parametrize("point", ["zero", "small", "edge"])
def test_objective_matches_the_autograd_objective(problem, one_thread, point):
    pb = problem
    theta = torch.as_tensor(_points(pb)[point])
    value, grad = _objective(pb, pb["w"]).value_and_grad(theta)
    batch = sl.feature_batch(pb["tfm"], "cpu", grad_layout=True)
    x = theta.clone().requires_grad_(True)
    scales = lr._to_device(pb["scales"], torch.device("cpu"))
    want = sl.weighted_logloss(pb["layout"].views(x), scales, batch, torch.as_tensor(pb["y"]),
                               torch.as_tensor(pb["w"]), REG, center=torch.as_tensor(pb["center"]))
    (want_grad,) = torch.autograd.grad(want, x)
    _close(value, grad, want.detach().numpy(), want_grad.numpy())


def test_a_grid_row_is_the_one_model_objective(problem, one_thread):
    pb = problem
    pts = _points(pb)
    theta = np.stack([pts["small"], pts["edge"], pts["zero"]])
    ws = pb["ws"][:3]
    value, grad = _objective(pb, ws).value_and_grad(torch.as_tensor(theta))
    for g in range(3):
        v, gr = _objective(pb, ws[g]).value_and_grad(torch.as_tensor(theta[g]))
        _close(value[g], grad[g], v.numpy(), gr.numpy())


@pytest.mark.parametrize("many", [False, True], ids=["one", "grid"])
def test_logloss_cotangent_matches_jax_at_the_edges(one_thread, many):
    """``logloss_reference``'s dz against JAX's gradient wrt each row's own
    category weight (one category a row, unit scales, no penalty): the
    logits -2e6, -1e6 (the edge: torch's clamp has slope 1 there, JAX's
    clip 0.5), -40, -35, -1, 0, 1, 35, 40, 1e6, 2e6 and random ones; the
    loss and the bias gradient too."""
    rng = np.random.default_rng(3)
    z = np.concatenate([[-2e6, -40.0, -35.0, -1.0, 0.0, 1.0, 35.0, 40.0, 2e6], rng.normal(size=55) * 20]).astype(F)
    n = z.size
    y = (rng.random(n) < 0.5).astype(F)
    w = rng.uniform(0.1, 2.0, size=(3, n) if many else n).astype(F)
    kw = dict(dense=np.zeros((n, 0), F), dense_names=[], cat={"r": np.arange(n, dtype=np.int32)},
              cat_sizes={"r": n}, bag_idx={}, bag_val={}, bag_sizes={})
    jfm = JFM(**kw)
    batch = jsl.feature_batch(jfm)
    ones = {"bias": jnp.float32(1.0), "dense": jnp.zeros(0), "cat:r": jnp.ones(n)}

    def one(w_row):
        params = {"bias": jnp.float32(0.0), "dense": jnp.zeros(0), "cat:r": jnp.asarray(z)}
        return jax.value_and_grad(jsl.weighted_logloss)(params, ones, batch, jnp.asarray(y), w_row, 0.0)

    value, grads = (jax.vmap(one) if many else one)(jnp.asarray(w))
    want_dz = np.asarray(grads["cat:r"])
    theta = torch.zeros((3, 1) if many else (1,))
    zt = torch.as_tensor(np.broadcast_to(z, w.shape).copy())
    loss, dz, bias, pen = sl.logloss_reference(zt, torch.as_tensor(y), torch.as_tensor(w),
                                               torch.as_tensor(w).sum(-1), theta, 0.0)
    np.testing.assert_allclose(loss.numpy(), np.asarray(value), rtol=1e-6)
    np.testing.assert_allclose(bias.numpy(), np.asarray(grads["bias"]), rtol=0, atol=1e-6)
    assert not pen.any()
    np.testing.assert_allclose(dz.numpy(), want_dz, rtol=0, atol=1e-6)
    # The zero weight case gives NaN in both.
    nan_loss, nan_dz, _, _ = sl.logloss_reference(zt[..., :5], torch.as_tensor(y[:5]), torch.zeros_like(zt[..., :5]),
                                                 torch.zeros(w.shape[:-1]), theta, 0.0)
    assert torch.isnan(nan_loss).all() and torch.isnan(nan_dz[..., 1:]).all()


# ---------------------------------------------------------------- direction


def _quadratic_iterates(rows: int, p: int = 40, steps: int = 25, seed: int = 0):
    """25 iterates and gradients of a convex quadratic per row (positive
    curvature, as a line search keeps), one repeated iterate (a zero secant
    pair: rho 0)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(p, p))
    hess = (a @ a.T / p + np.eye(p)).astype(F)
    x = rng.normal(size=(rows, p)).astype(F)
    xs, gs = [], []
    for k in range(steps):
        if k != 7:
            x = (x + rng.normal(size=(rows, p)) * 0.3).astype(F)
        xs.append(x.copy())
        gs.append((x @ hess + 0.1).astype(F))
    return xs, gs


@pytest.mark.parametrize("rows", [1, 4])
def test_plain_direction_matches_optax(one_thread, rows):
    xs, gs = _quadratic_iterates(rows)
    tx = optax.chain(optax.scale_by_lbfgs(10, scale_init_precond=True), optax.scale(-1.0))
    one = rows == 1
    opt = lr._LBFGS(torch.as_tensor(xs[0][0] if one else xs[0]))
    state = jax.vmap(tx.init)(jnp.asarray(xs[0]))
    update = jax.vmap(lambda g, s, x: tx.update(g, s, x))
    for k, (x, g) in enumerate(zip(xs, gs)):
        want, state = update(jnp.asarray(g), state, jnp.asarray(x))
        want = np.asarray(want)
        got, slope = opt.direction(torch.as_tensor(g[0] if one else g), torch.as_tensor(x[0] if one else x))
        got = got.numpy().reshape(rows, -1)
        assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want)), k
        np.testing.assert_allclose(np.asarray(slope).reshape(rows), np.sum(want * g, axis=1), rtol=1e-5)
    assert opt.count == len(xs)


def test_direction_wrapper_reads_its_count_from_a_tensor(one_thread):
    """``lbfgs_direction`` takes the largest count of ``iters`` (a grid's
    rows that stopped keep a smaller ``i``) and writes into ``out``."""
    xs, gs = _quadratic_iterates(3, steps=13)
    a, b = lbfgs.new_memory(torch.as_tensor(xs[0]), 10), lbfgs.new_memory(torch.as_tensor(xs[0]), 10)
    for k, (x, g) in enumerate(zip(xs, gs)):
        want_u, want_s = lbfgs.lbfgs_direction_reference(torch.as_tensor(g), torch.as_tensor(x), a, k)
        out = (torch.empty(x.shape), torch.empty(3))
        got = lbfgs.lbfgs_direction(torch.as_tensor(g), torch.as_tensor(x), b,
                                    torch.tensor([k, max(k - 3, 0), k], dtype=torch.int32), out=out)
        assert got is out and torch.equal(out[0], want_u) and torch.equal(out[1], want_s)


# ---------------------------------------------------------------- the loops


def _fit(tfm, y, w, max_iter, many):
    est = lr.LogisticRegression(max_iter=max_iter, reg_param=REG, device="cpu")
    return est.fit_many(tfm, y, w) if many else [est.fit(tfm, y, w)]


@pytest.mark.parametrize("max_iter", [1, 10, 11, 25])
@pytest.mark.parametrize("many", [False, True], ids=["fit", "fit_many"])
def test_one_direction_piece_gives_the_plain_loops_bits(problem, one_thread, monkeypatch, many, max_iter):
    pb = problem
    weights = pb["ws"] if many else pb["w"]
    want = _fit(pb["tfm"], pb["y"], weights, max_iter, many)
    keys = []
    eager = _replay_while_eagerly([])

    def recording(name, dev, first, unit, *args, **kw):
        unit(lambda pred, key, fn: keys.append(key))
        return eager(name, dev, first, unit, *args, **kw)

    monkeypatch.setattr(graphs, "replay_while", recording)
    for name in ("_lbfgs_loop_reference", "_lbfgs_loop_many_reference"):
        monkeypatch.setattr(lr, name, lambda obj, theta, m, tol: lr._lbfgs_loop_graph(obj, theta, m, tol, "test", {}))
    got = _fit(pb["tfm"], pb["y"], weights, max_iter, many)
    assert keys == [("stale",), ("direction",)] + [("trial", j) for j in range(lr.MAX_LINESEARCH_STEPS)] + [("finish",)]
    for a, b in zip(got, want):
        assert a.n_iter_run == b.n_iter_run
        assert np.array_equal(F(a.train_loss), F(b.train_loss), equal_nan=True)
        assert all(np.array_equal(a.params[k], b.params[k]) for k in a.params)


@pytest.mark.parametrize("many", [False, True], ids=["fit", "fit_many"])
def test_fits_match_jax(problem, one_thread, many):
    """``test_torch_models_lr.py``'s bands: loss rtol 1e-6, standardized
    coefficients atol 1e-5, iterations within 2; the zero row's loss NaN in
    both, its coefficients the zero init."""
    pb = problem
    jest = JLR(max_iter=100, reg_param=REG)
    want = jest.fit_many(pb["jfm"], pb["y"], pb["ws"]) if many else [jest.fit(pb["jfm"], pb["y"], pb["w"])]
    got = _fit(pb["tfm"], pb["y"], pb["ws"] if many else pb["w"], 100, many)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=1e-6)
        assert abs(a.n_iter_run - b.n_iter_run) <= 2, (a.n_iter_run, b.n_iter_run)
        for k in b.params:
            np.testing.assert_allclose(a.params[k], np.asarray(b.params[k]), atol=1e-5, err_msg=k)
