"""K19, the L-BFGS fits with their loop state on the device, and LR's Adam
as a graph, on the CPU.

- The state kernels' plain versions (``ops.lbfgs.zoom_trial_reference``,
  ``lbfgs_stop_reference``, what ``lbfgs_state`` and ``lbfgs_stop`` compute
  on the card) against the plain loops' numpy float32 logic: the grid's
  ``_search_update`` / ``_zoom_update`` / ``_zoom_middle`` and safe-step
  rule, and for one row the scalar ``_search_step`` / ``_zoom_step``, bit
  for bit on hypothesis-drawn states (NaN and inf values, zero intervals,
  negative cubic radicals, the last trial), the gradient selections
  included.
- The device-state loop (``models.logistic_regression._lbfgs_loop_graph``)
  with ``utils.graphs.replay_while`` replaced by an eager stand-in (each
  piece runs where its flag holds) against the plain loops, bit for bit:
  coefficients, ``train_loss`` and ``n_iter_run`` of ``fit`` and of each
  row of ``fit_many`` (a row that stops after 2 steps, one after 1), at
  ``max_iter`` 1, 10, 11 and 25 (the edges of a block of 10).
- The same loop against the JAX package's ``_lbfgs_fit_jit`` and
  ``_lbfgs_fit_many_jit`` (through its ``fit`` and ``fit_many``) at
  ``test_torch_models_lr.py``'s bands: loss rtol 1e-6, standardized
  coefficients atol 1e-5, iterations within 2.
- LR's Adam graph (``_adam_graph``) with ``replay_loop`` replaced by an
  eager stand-in against ``_adam_loop``, bit for bit.
- A launch made onto a capture's stream from another thread (autograd's
  backward runs on its device thread) lands in the capture's record.

The graphs themselves run only on the card (``tests/test_torch_cuda.py -k
lbfgs``). Many small torch ops: one thread.
"""

import threading

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from albedo_tpu.features.assembler import FeatureMatrix as JFM
from albedo_tpu.models.logistic_regression import LogisticRegression as JLR
from albedo_tpu_torch.features.assembler import FeatureMatrix as TFM
from albedo_tpu_torch.kernels import build
from albedo_tpu_torch.models import logistic_regression as lr
from albedo_tpu_torch.ops import lbfgs
from albedo_tpu_torch.utils import graphs
from test_torch_cuda import lr_problem

F = np.float32
MAX_STEPS = lr.MAX_LINESEARCH_STEPS
# The zoom state's float fields: the plain loops' names -> rows of fs.
FIELDS = {
    "value_init": lbfgs.F_VALUE_INIT, "slope_init": lbfgs.F_SLOPE_INIT, "stepsize": lbfgs.F_STEP,
    "value": lbfgs.F_VALUE, "slope": lbfgs.F_SLOPE, "dec": lbfgs.F_DEC, "curv": lbfgs.F_CURV,
    "low": lbfgs.F_LOW, "value_low": lbfgs.F_VALUE_LOW, "slope_low": lbfgs.F_SLOPE_LOW, "high": lbfgs.F_HIGH,
    "value_high": lbfgs.F_VALUE_HIGH, "slope_high": lbfgs.F_SLOPE_HIGH, "cubic_ref": lbfgs.F_CUBIC_REF,
    "value_cubic_ref": lbfgs.F_VALUE_CUBIC_REF, "safe_stepsize": lbfgs.F_SAFE_STEP,
    "safe_value": lbfgs.F_SAFE_VALUE,
}
FLAGS = {"interval_found": lbfgs.I_INTERVAL, "done": lbfgs.I_DONE, "failed": lbfgs.I_FAILED}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(a, b) -> bool:
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


# ---------------------------------------------------------- the state kernels

ODD = [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-30, 1.0, -1.0, 2.0]
values = st.one_of(st.floats(-1e3, 1e3, width=32), st.sampled_from(ODD))
steps = st.one_of(st.sampled_from([0.0, 0.5, 1.0, 2.0, 4.0, 1e-6]), st.floats(0.0, 8.0, width=32))


@st.composite
def zoom_states(draw):
    """A grid line-search state as the plain loop keeps it (G rows), the
    rows running, the trial's index and each row's trial value and slope."""
    g = draw(st.integers(1, 4))
    count = draw(st.integers(0, MAX_STEPS - 1))

    def col(strategy):
        return np.array([draw(strategy) for _ in range(g)], F)

    state = {k: col(steps if k in ("stepsize", "low", "high", "cubic_ref", "safe_stepsize") else values)
             for k in FIELDS}
    if draw(st.booleans()):  # a zero interval
        state["high"] = state["low"].copy()
    for k in FLAGS:
        state[k] = col(st.booleans()).astype(bool)
    if count == 0:  # a new search, as _zoom_linesearch_many starts it
        vi, si = state["value_init"], state["slope_init"]
        state.update(stepsize=np.zeros(g, F), value=vi, slope=si, dec=np.full(g, np.inf, F),
                     curv=np.full(g, np.inf, F), low=np.zeros(g, F), value_low=vi, slope_low=si,
                     high=np.zeros(g, F), value_high=vi, slope_high=si, cubic_ref=np.zeros(g, F),
                     value_cubic_ref=vi, safe_stepsize=np.zeros(g, F), safe_value=vi,
                     interval_found=np.zeros(g, bool), done=np.zeros(g, bool), failed=np.zeros(g, bool))
    running = col(st.booleans()).astype(bool)
    return state, running, count, col(values), col(values)


def _trial_steps(state, running, count):
    """The step each running row tries (``_zoom_linesearch_many``'s)."""
    with np.errstate(all="ignore"):
        middle = lr._zoom_middle(state)
    trial = np.where(state["interval_found"], middle, F(1.0) if count == 0 else lr._INCREASE * state["stepsize"])
    return np.where(running, trial, F(0.0)).astype(F)


def _numpy_trial(state, running, count, new_value, new_slope):
    """One pass of ``_zoom_linesearch_many``'s loop, the trial's value and
    slope given; gradients are markers: 0 the current, 1 the safe one, 2
    the trial's. Returns the state, the rows still running, the next
    trial steps."""
    st_ = dict(state, grad=np.zeros_like(new_value), safe_grad=np.ones_like(new_value))
    trial = _trial_steps(state, running, count)
    zoom, search = running & st_["interval_found"], running & ~st_["interval_found"]
    new_grad = np.full_like(new_value, 2.0)
    with np.errstate(all="ignore"):
        found = lr._search_update(st_, count, MAX_STEPS, trial, new_value, new_grad, new_slope)
        zoomed = lr._zoom_update(st_, count, MAX_STEPS, trial, new_value, new_grad, new_slope)
        for key in st_:
            st_[key] = lr._select(search, found[key], lr._select(zoom, zoomed[key], st_[key]))
        safe = running & st_["failed"] & ((st_["safe_stepsize"] > 0.0) | np.isinf(st_["dec"]))
        st_["stepsize"] = np.where(safe, st_["safe_stepsize"], st_["stepsize"])
        st_["value"] = np.where(safe, st_["safe_value"], st_["value"])
        st_["grad"] = lr._select(safe, st_["safe_grad"], st_["grad"])
        running = running & ~(st_["done"] | st_["failed"])
        nxt = _trial_steps(st_, running, 1)
    return st_, running, nxt


def _packed(state, running, count):
    """The plain loop's state as an ``ops.lbfgs.LoopState``."""
    g = len(running)
    ls = lbfgs.new_state(g, "cpu", 25)
    for k, row in FIELDS.items():
        ls.fs[row] = torch.as_tensor(state[k])
    for k, row in FLAGS.items():
        ls.is_[row] = torch.as_tensor(state[k].astype(np.int32))
    ls.fs[lbfgs.F_LS_VALUE] = torch.as_tensor(state["value_init"])  # where a new search starts
    ls.fs[lbfgs.F_TRIAL] = torch.as_tensor(_trial_steps(state, running, count))
    ls.ms[lbfgs.M_RUNNING] = torch.as_tensor(running)
    return ls


def _glue_markers(ls):
    """The torch glue's gradient selections applied to the markers."""
    ms = ls.ms.numpy()
    safe = np.where(ms[lbfgs.M_SAFE_NEW], 2.0, 1.0)
    grad = np.where(ms[lbfgs.M_TOOK], 2.0, 0.0)
    return np.where(ms[lbfgs.M_SAFE_TAKE], safe, grad), safe


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(zoom_states())
def test_zoom_trial_plain_equals_the_numpy_grid_logic(drawn):
    state, running, count, new_value, new_slope = drawn
    want, still, nxt = _numpy_trial(state, running, count, new_value, new_slope)
    ls = _packed(state, running, count)
    lbfgs.zoom_trial(ls, torch.as_tensor(new_value), torch.as_tensor(new_slope),
                     torch.as_tensor(state["slope_init"]), count, MAX_STEPS)
    for k, row in FIELDS.items():
        assert _same(ls.fs[row].numpy(), want[k]), k
    for k, row in FLAGS.items():
        assert _same(ls.is_[row].numpy().astype(bool), want[k]), k
    assert _same(ls.ms[lbfgs.M_RUNNING].numpy(), still)
    assert _same(ls.fs[lbfgs.F_TRIAL].numpy(), nxt)
    assert bool(ls.flags[lbfgs.FLAG_RUNNING]) == bool(still.any())
    grad, safe = _glue_markers(ls)
    assert _same(grad, want["grad"]) and _same(safe, want["safe_grad"])


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(zoom_states())
def test_zoom_trial_plain_equals_the_scalar_steps(drawn):
    """One row that runs: ``_search_step`` or ``_zoom_step`` (which pick
    their own trial step) and the safe-step rule of ``_zoom_linesearch``."""
    state, _, count, new_value, new_slope = drawn
    row = {k: (F(v[0]) if v.dtype == F else bool(v[0])) for k, v in state.items()}
    running = np.ones(1, bool)
    tried = []

    def on_line(step):
        tried.append(step)
        return F(new_value[0]), F(2.0), F(new_slope[0])

    st_ = dict(row, count=count, grad=F(0.0), safe_grad=F(1.0))
    with np.errstate(all="ignore"):
        (lr._zoom_step if st_["interval_found"] else lr._search_step)(st_, on_line, MAX_STEPS)
        if st_["failed"] and (st_["safe_stepsize"] > 0.0 or np.isinf(st_["dec"])):
            st_["stepsize"], st_["value"], st_["grad"] = st_["safe_stepsize"], st_["safe_value"], st_["safe_grad"]
    ls = _packed({k: v[:1] for k, v in state.items()}, running, count)
    assert _same(ls.fs[lbfgs.F_TRIAL].numpy(), np.array(tried, F))  # the step both try
    lbfgs.zoom_trial(ls, torch.as_tensor(new_value[:1]), torch.as_tensor(new_slope[:1]),
                     torch.as_tensor(state["slope_init"][:1]), count, MAX_STEPS)
    for k, r in FIELDS.items():
        assert _same(ls.fs[r].numpy(), [st_[k]]), k
    for k, r in FLAGS.items():
        assert bool(ls.is_[r, 0]) == bool(st_[k]), k
    grad, safe = _glue_markers(ls)
    assert _same(grad, [st_["grad"]]) and _same(safe, [st_["safe_grad"]])


@st.composite
def loop_states(draw):
    g = draw(st.integers(1, 4))

    def col(strategy):
        return np.array([draw(strategy) for _ in range(g)])

    return dict(value=col(values).astype(F), new_value=col(values).astype(F), prev=col(values).astype(F),
                ls_value=col(values).astype(F), finite=col(st.booleans()).astype(bool),
                gnorm=col(st.one_of(st.floats(0.0, float(F(1e-5)), width=32), st.sampled_from([0.0, 1e-6, 1.0, np.nan])))
                .astype(F), active=col(st.booleans()).astype(bool), i=col(st.integers(0, 12)),
                flat=col(st.integers(0, 4)), bad=col(st.booleans()).astype(bool), max_iter=draw(st.integers(1, 12)))


@settings(max_examples=300, deadline=None)
@given(loop_states())
def test_lbfgs_stop_plain_equals_the_numpy_bookkeeping(s):
    """``_lbfgs_loop_many_reference``'s bookkeeping after a step and its
    stop test at the next iteration's top."""
    tol32 = F(1e-6)
    active, value = s["active"], s["value"]
    ok = np.isfinite(value) & s["finite"]
    with np.errstate(invalid="ignore"):
        plateau = abs(s["prev"] - value) <= tol32 * np.maximum(abs(value), F(1e-12))
    ls_value = np.where(active, s["new_value"], s["ls_value"])
    flat = np.where(active, np.where(plateau, s["flat"] + 1, 0), s["flat"])
    prev = np.where(active, value, s["prev"])
    i = np.where(active, s["i"] + 1, s["i"])
    bad = np.where(active, ~ok, s["bad"])
    with np.errstate(invalid="ignore"):
        nxt = ~bad & (i < s["max_iter"]) & ((i < 2) | ((flat < 3) & (s["gnorm"] > tol32)))

    g = len(value)
    ls = lbfgs.new_state(g, "cpu", 25)
    ls.fs[lbfgs.F_VALUE_INIT] = torch.as_tensor(value)
    ls.fs[lbfgs.F_VALUE] = torch.as_tensor(s["new_value"])
    ls.fs[lbfgs.F_PREV] = torch.as_tensor(s["prev"])
    ls.fs[lbfgs.F_LS_VALUE] = torch.as_tensor(s["ls_value"])
    ls.is_[lbfgs.I_ITER] = torch.as_tensor(s["i"], dtype=torch.int32)
    ls.is_[lbfgs.I_FLAT] = torch.as_tensor(s["flat"], dtype=torch.int32)
    ls.is_[lbfgs.I_BAD] = torch.as_tensor(s["bad"], dtype=torch.int32)
    ls.ms[lbfgs.M_ACTIVE] = torch.as_tensor(active)
    lbfgs.lbfgs_stop(ls, torch.as_tensor(s["finite"]), torch.as_tensor(s["gnorm"]), s["max_iter"], 1e-6)
    assert _same(ls.ms[lbfgs.M_OK].numpy(), active & ok)
    assert _same(ls.fs[lbfgs.F_LS_VALUE].numpy(), ls_value) and _same(ls.fs[lbfgs.F_PREV].numpy(), prev)
    assert _same(ls.is_[lbfgs.I_FLAT].numpy(), flat) and _same(ls.is_[lbfgs.I_ITER].numpy(), i)
    assert _same(ls.is_[lbfgs.I_BAD].numpy().astype(bool), bad)
    assert _same(ls.ms[lbfgs.M_ACTIVE].numpy(), nxt) and _same(ls.ms[lbfgs.M_RUNNING].numpy(), nxt)
    assert _same(ls.ms[lbfgs.M_STALE].numpy(), nxt & ~np.isfinite(ls_value))
    assert _same(ls.fs[lbfgs.F_TRIAL].numpy(), nxt.astype(F))
    assert bool(ls.flags[lbfgs.FLAG_ACTIVE]) == bool(nxt.any()) == bool(ls.flags[lbfgs.FLAG_RUNNING])
    assert bool(ls.flags[lbfgs.FLAG_STALE]) == bool((nxt & ~np.isfinite(ls_value)).any())


def test_the_cubic_interpolant_multiplies_out_its_powers():
    """``_cubicmin`` spells ``x**2`` and ``x**3`` as JAX lowers them, so
    the scalar path, the grid path and the card agree: on 4096 drawn
    arguments the scalar and array evaluations give the same bits."""
    rng = np.random.default_rng(0)
    args = [(rng.normal(size=4096) * 10.0 ** rng.integers(-3, 3, size=4096)).astype(F) for _ in range(7)]
    with np.errstate(all="ignore"):
        arrays = lr._cubicmin(*args)
        scalars = np.array([lr._cubicmin(*(a[i] for a in args)) for i in range(4096)], F)
        plain = lbfgs._cubicmin(*(torch.as_tensor(a) for a in args)).numpy()
    assert _same(arrays, scalars) and _same(arrays, plain)


def _cubic_args(n: int, seed: int):
    """Drawn float32 arguments of a zoom step's cubic: interval ends a, b,
    c, values of either sign, a descent slope at a."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 2.0, n)
    return [x.astype(F) for x in (a, rng.normal(size=n) * 10, -np.abs(rng.normal(size=n)),
                                  a + rng.uniform(0.01, 3.0, n), rng.normal(size=n) * 10,
                                  a + rng.uniform(0.01, 3.0, n), rng.normal(size=n) * 10)]


def test_jax_lowers_the_cubics_powers_to_products():
    """Under jit, JAX's float32 ``x**2`` and ``x**3`` are ``x * x`` and
    ``x * (x * x)`` bit for bit (what ``_cubicmin`` now spells out), which
    numpy's ``**`` is not on every draw."""
    import jax
    import jax.numpy as jnp

    x = (np.random.default_rng(3).normal(size=4096) * 3).astype(F)
    square = np.asarray(jax.jit(lambda t: t ** 2)(jnp.asarray(x)))
    cube = np.asarray(jax.jit(lambda t: t ** 3)(jnp.asarray(x)))
    assert _same(square, x * x) and _same(cube, x * (x * x))
    assert not _same(cube, np.array([c ** 3 for c in x], F))  # the scalar ``**`` the loop spelled before


def test_cubicmin_tracks_optaxs_cubic():
    """The plain loops' ``_cubicmin`` against optax's own zoom-linesearch
    cubic (``optax._src.linesearch._cubicmin``, vmapped, float32) on 1024
    drawn arguments. Op by op: with optax's 2x2 ``jnp.dot`` written out as
    XLA's CPU dot rounds it (the second product fused into the first, one
    rounding), the same bits on every draw, so that dot is the only
    difference left. Jitted, as the JAX loop runs it (XLA may fuse more):
    NaN exactly where optax's is NaN, within rel 2e-5 elsewhere (a rounding
    or two, magnified where the radical cancels), and equal on at least as
    many draws as the ``**`` spelling."""
    import jax
    import jax.numpy as jnp
    from optax._src import linesearch

    args = _cubic_args(1024, 5)
    op_by_op = np.asarray(jax.vmap(linesearch._cubicmin)(*(jnp.asarray(x) for x in args)))
    want = np.asarray(jax.jit(jax.vmap(linesearch._cubicmin))(*(jnp.asarray(x) for x in args)))

    def spelled(a, fa, fpa, b, fb, c, fc, fused: bool, powers: bool):
        db, dc = b - a, c - a
        r0, r1 = fb - fa - fpa * db, fc - fa - fpa * dc
        if powers:
            denom = (db * dc) ** 2 * (db - dc)
            rows = ((dc ** 2, -(db ** 2)), (-(dc ** 3), db ** 3))
        else:
            dbdc = db * dc
            denom = (dbdc * dbdc) * (db - dc)
            rows = ((dc * dc, -(db * db)), (-(dc * (dc * dc)), db * (db * db)))

        def dot(m0, m1):
            if fused:  # fma(m1, r1, m0 * r0): the float64 sum of an exact product and a float32, rounded once
                return F(np.float64(m1) * np.float64(r1) + np.float64(F(m0 * r0)))
            return m0 * r0 + m1 * r1
        A, B = dot(*rows[0]) / denom, dot(*rows[1]) / denom
        return F(a + (-B + np.sqrt(B * B - F(3.0) * A * fpa)) / (F(3.0) * A))

    with np.errstate(all="ignore"):
        got = np.array([lr._cubicmin(*(x[i] for x in args)) for i in range(1024)], F)
        fused = np.array([spelled(*(x[i] for x in args), fused=True, powers=False) for i in range(1024)], F)
        assert _same(got, np.array([spelled(*(x[i] for x in args), fused=False, powers=False)
                                    for i in range(1024)], F))  # the transcription is _cubicmin's
        powers = np.array([spelled(*(x[i] for x in args), fused=False, powers=True) for i in range(1024)], F)
    assert _same(fused, op_by_op)
    finite = np.isfinite(want)
    assert np.array_equal(finite, np.isfinite(got))
    assert np.all(np.abs(got - want)[finite] <= 2e-5 * np.abs(want)[finite])
    assert np.sum(got == want) >= np.sum(powers == want)


# ---------------------------------------------------------------- the loops


def _replay_while_eagerly(calls):
    """A stand-in for ``utils.graphs.replay_while``: each piece runs eagerly
    where its flag holds (the first unit's from ``resume`` on), the flag
    read after every unit."""
    def replay_while(name, dev, first, unit, flag, max_units, resume, per_read, *, report=None, span=""):
        calls.append({"name": name, "max_units": max_units, "resume": resume, "per_read": per_read, "span": span})
        first()
        started = False

        def rest(pred, key, fn):
            nonlocal started
            started = started or key == resume
            if started and bool(pred):
                fn()
        unit(rest)
        n = 0
        while n < max_units and bool(flag):
            unit(lambda pred, key, fn: fn() if bool(pred) else None)
            n += 1
        return -(-n // per_read)
    return replay_while


@pytest.fixture(scope="module")
def problem():
    kw, y, w, ws = lr_problem(n=300)
    return kw, TFM(**kw), y, w, ws


def _fit(tfm, y, w, max_iter, many):
    est = lr.LogisticRegression(max_iter=max_iter, reg_param=0.7, device="cpu")
    return est, (est.fit_many(tfm, y, w) if many else [est.fit(tfm, y, w)])


def _on_the_device_loop(monkeypatch, calls):
    """``fit`` and ``fit_many`` on the CPU through the device-state loop
    (with an eager stand-in for the graphs) in place of the plain loops."""
    monkeypatch.setattr(graphs, "replay_while", _replay_while_eagerly(calls))
    for name in ("_lbfgs_loop_reference", "_lbfgs_loop_many_reference"):
        monkeypatch.setattr(lr, name, lambda loss_fn, theta, m, tol: lr._lbfgs_loop_graph(
            loss_fn, theta, m, tol, "LogisticRegression (test)", {}))


@pytest.mark.parametrize("max_iter", [1, 10, 11, 25])
@pytest.mark.parametrize("many", [False, True], ids=["fit", "fit_many"])
def test_device_loop_equals_the_plain_loop(problem, one_thread, monkeypatch, many, max_iter):
    _, tfm, y, w, ws = problem
    weights = ws if many else w
    _, want = _fit(tfm, y, weights, max_iter, many)
    calls = []
    _on_the_device_loop(monkeypatch, calls)
    _, got = _fit(tfm, y, weights, max_iter, many)
    for a, b in zip(got, want):
        assert a.n_iter_run == b.n_iter_run and _same(F(a.train_loss), F(b.train_loss))
        assert all(_same(a.params[k], b.params[k]) for k in a.params)
    assert [(c["max_units"], c["resume"], c["per_read"]) for c in calls] == [(max_iter - 1, ("trial", 1), lr.BLOCK)]
    if many and max_iter > 2:
        assert [m.n_iter_run for m in got[2:]] == [2, 1]  # the negatives' row, the zero row
    if max_iter == 25:
        assert max(m.n_iter_run for m in got) > 11  # iterations ran in a second block


@pytest.mark.parametrize("many", [False, True], ids=["fit", "fit_many"])
def test_device_loop_matches_jax(problem, one_thread, monkeypatch, many):
    """At ``test_torch_models_lr.py``'s bands; the zero row's loss is NaN in
    both, its coefficients the zero init."""
    kw, tfm, y, w, ws = problem
    jest = JLR(max_iter=100, reg_param=0.7)
    want = jest.fit_many(JFM(**kw), y, ws) if many else [jest.fit(JFM(**kw), y, w)]
    _on_the_device_loop(monkeypatch, [])
    _, got = _fit(tfm, y, ws if many else w, 100, many)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=1e-6)
        assert abs(a.n_iter_run - b.n_iter_run) <= 2, (a.n_iter_run, b.n_iter_run)
        for k in b.params:
            np.testing.assert_allclose(a.params[k], np.asarray(b.params[k]), atol=1e-5, err_msg=k)


def _replay_eagerly(calls):
    """A stand-in for ``utils.graphs.replay_loop``: the captured unit runs
    eagerly in place of each replay."""
    def replay_loop(name, dev, unit, n, *, refill=None, after=None, generators=(), report=None, span=""):
        calls.append({"name": name, "n": n, "span": span})
        for i in range(n):
            if i and refill is not None:
                refill(i)
            unit(min(i, 1))
            if after is not None:
                after(i)
    return replay_loop


@pytest.mark.parametrize("steps", [1, 2, 7])
def test_adam_graph_bookkeeping_equals_the_eager_loop(problem, one_thread, monkeypatch, steps):
    _, tfm, y, w, _ = problem
    est = lr.LogisticRegression(max_iter=steps, reg_param=0.7, solver="adam", learning_rate=0.05, device="cpu")
    want = est.fit(tfm, y, w)
    calls = []
    monkeypatch.setattr(graphs, "replay_loop", _replay_eagerly(calls))
    monkeypatch.setattr(lr, "_adam_loop", lambda loss_fn, theta, m, rate: lr._adam_graph(
        loss_fn, theta, m, rate, "LogisticRegression.fit (Adam, test)", {}))
    got = est.fit(tfm, y, w)
    assert got.n_iter_run is None and _same(F(got.train_loss), F(want.train_loss))
    assert all(_same(got.params[k], want.params[k]) for k in got.params)
    assert [c["n"] for c in calls] == [steps] and calls[0]["span"] == "lr_adam.replays"


def test_fits_on_the_cpu_capture_nothing(problem, one_thread):
    _, tfm, y, w, ws = problem
    for solver in ("lbfgs", "adam"):
        est = lr.LogisticRegression(max_iter=3, reg_param=0.7, solver=solver, device="cpu")
        model = est.fit(tfm, y, w)
        assert model.compile_s is None and est.last_fit_report["compile_s"] is None
        assert model.run_s > 0 and est.last_fit_report["device_s"] == model.run_s
    est = lr.LogisticRegression(max_iter=3, reg_param=0.7, device="cpu")
    assert all(m.compile_s is None for m in est.fit_many(tfm, y, ws))


def test_launch_record_sees_launches_onto_its_stream_from_another_thread():
    """A record opened on a stream collects that stream's launches from any
    thread (autograd's backward runs on its device thread); another
    stream's launches, or any launch after the record closes, count at
    once."""
    saved = dict(build.LAUNCHES)
    try:
        build.LAUNCHES.update(dict.fromkeys(build.LAUNCHES, 0))
        record = build.LaunchRecord(stream=1234)

        def backward():
            build.count_launch("segment_dot", 1234)
            build.count_launch("gather_sum", 5678)

        with record:
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        build.count_launch("segment_dot", 1234)
        assert record.counts == {"segment_dot": 1}
        assert build.LAUNCHES["segment_dot"] == 1 and build.LAUNCHES["gather_sum"] == 1
        record.replayed(3)
        assert build.LAUNCHES["segment_dot"] == 4
    finally:
        build.LAUNCHES.update(saved)
