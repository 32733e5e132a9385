"""Weighted logistic regression on block-sparse features (PyTorch).

Port of ``albedo_tpu/models/logistic_regression.py``: the ranker's MLlib
``LogisticRegression`` stage — maxIter=300, regParam=0.7, pure L2,
standardization, instance weights (``LogisticRegressionRanker.scala:330-337``)
— solved full-batch by L-BFGS.

The solver is the JAX module's ``_lbfgs_loop`` written out, without optax
(the machine with the card has none) and without ``torch.optim.LBFGS``
(whose strong-Wolfe search takes other steps):

- :class:`_LBFGS` is optax 0.2.6's ``scale_by_lbfgs`` (memory 10, the
  initial preconditioner scaled by the capped reciprocal gradient norm,
  then by the last secant pair) chained with ``scale(-1)``;
- :func:`_zoom_linesearch` is optax's ``scale_by_zoom_linesearch`` with
  ``max_linesearch_steps=MAX_LINESEARCH_STEPS`` (8) and
  ``initial_guess_strategy="one"``, its defaults otherwise; its final value
  and gradient are reused by the next iteration, as
  ``optax.value_and_grad_from_state`` does;
- :func:`_lbfgs_loop` keeps the last finite point and stops after at least
  2 steps on 3 consecutive plateaus or a gradient norm at ``tol``.

The parameters live in one flat float32 vector on the device; the line
search's scalar logic runs on the host in float32 (one device read per
function evaluation), where the JAX loop runs in a device ``while_loop``.
Not ported: ``fit_many`` (the CV grid), ``solver="adam"`` and ``mesh``
(all raise ``NotImplementedError``), and the persistent executable cache.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from albedo_tpu_torch.features.assembler import FeatureMatrix
from albedo_tpu_torch.ops.sparse_linear import (
    block_logits,
    dense_center,
    feature_batch,
    init_params,
    inverse_std_scales,
    weighted_logloss,
)
from albedo_tpu_torch.utils.device import resolve_device
from albedo_tpu_torch.utils.watchdog import TrainingDiverged, check_lr_loss

# Zoom line-search evaluations per L-BFGS step (the JAX module's cap).
MAX_LINESEARCH_STEPS = 8
MEMORY_SIZE = 10

F = np.float32


def _to_device(tree: dict[str, Any], device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=device) for k, v in tree.items()}


@dataclasses.dataclass
class LogisticRegressionModel:
    params: dict[str, np.ndarray]   # standardized-space coefficients
    scales: dict[str, np.ndarray]   # 1/std per feature
    train_loss: float
    center: np.ndarray | None = None
    n_iter_run: int | None = None
    prep_s: float | None = None  # host batch layout, moments and upload
    device: str | torch.device = "cuda"

    @staticmethod
    def from_arrays(
        params: dict[str, Any], scales: dict[str, Any], center: Any | None = None,
        device: str | torch.device = "cuda",
    ) -> "LogisticRegressionModel":
        """A model from host arrays (e.g. the JAX model's params, scales and
        center as numpy), for scoring on ``device``."""
        return LogisticRegressionModel(
            params={k: np.asarray(v, np.float32) for k, v in params.items()},
            scales={k: np.asarray(v, np.float32) for k, v in scales.items()},
            train_loss=float("nan"),
            center=None if center is None else np.asarray(center, np.float32),
            device=device,
        )

    def decision_function(self, fm: FeatureMatrix) -> np.ndarray:
        dev = resolve_device(self.device)
        with torch.no_grad():
            out = block_logits(
                _to_device(self.params, dev), _to_device(self.scales, dev),
                feature_batch(fm, dev),
                None if self.center is None else torch.as_tensor(self.center).to(dev),
            )
        return out.cpu().numpy()

    def predict_proba(self, fm: FeatureMatrix) -> np.ndarray:
        """P(label=1), the ``probability[1]`` the ranker sorts by
        (``LogisticRegressionRanker.scala:434``)."""
        return 1.0 / (1.0 + np.exp(-self.decision_function(fm)))

    @property
    def coefficients(self) -> dict[str, np.ndarray]:
        """Raw-space coefficients; the dense-centering shift folds into the
        bias: ``b_raw = b_std - sum(beta_std * center / std)``."""
        folded = {k: np.asarray(self.params[k]) * np.asarray(self.scales[k]) for k in self.params}
        if self.center is not None:
            shift = float(np.sum(folded["dense"] * np.asarray(self.center)))
            folded["bias"] = np.float32(folded["bias"] - shift)
        return folded


@dataclasses.dataclass
class LogisticRegression:
    max_iter: int = 300
    reg_param: float = 0.7
    standardization: bool = True
    solver: str = "lbfgs"
    tol: float = 1e-6
    mesh: Any | None = None
    device: str | torch.device = "cuda"

    def _prepare_scales(self, fm: FeatureMatrix):
        if self.standardization:
            return inverse_std_scales(fm), dense_center(fm)
        scales = {k: np.ones_like(v) for k, v in init_params(fm).items()}
        scales["bias"] = np.float32(1.0)
        return scales, None

    def fit(
        self,
        fm: FeatureMatrix,
        labels: np.ndarray,
        sample_weight: np.ndarray | None = None,
        _damped_retry: bool = False,
    ) -> LogisticRegressionModel:
        if self.mesh is not None:
            raise NotImplementedError("LogisticRegression(mesh=...): the row-sharded fit is not ported yet")
        if self.solver == "adam":
            raise NotImplementedError("LogisticRegression(solver='adam') is not ported yet")
        if self.solver != "lbfgs":
            raise ValueError(f"unknown solver {self.solver!r}")
        dev = resolve_device(self.device)
        t_prep = time.perf_counter()
        n = fm.n_rows
        if sample_weight is None:
            sample_weight = np.ones(n, dtype=np.float32)
        batch = feature_batch(fm, dev, grad_layout=True)
        y = torch.as_tensor(np.asarray(labels, np.float32)).to(dev)
        w = torch.as_tensor(np.asarray(sample_weight, np.float32)).to(dev)
        scales_np, center_np = self._prepare_scales(fm)
        params_np = init_params(fm)
        scales = _to_device(scales_np, dev)
        center = None if center_np is None else torch.as_tensor(center_np).to(dev)
        layout = _Layout(params_np)
        theta0 = layout.flatten(params_np, dev)
        reg = float(self.reg_param)
        prep_s = time.perf_counter() - t_prep

        def loss_fn(theta: torch.Tensor) -> torch.Tensor:
            return weighted_logloss(layout.views(theta), scales, batch, y, w, reg, center=center)

        theta, loss_t, n_done = _lbfgs_loop(loss_fn, theta0, self.max_iter, self.tol)
        loss = float(loss_t)  # device read: the completion barrier

        if not check_lr_loss(loss):
            if _damped_retry:
                raise TrainingDiverged(self.max_iter, ["lr"])
            retry = dataclasses.replace(self, reg_param=max(float(self.reg_param) * 10.0, 1e-2))
            return retry.fit(fm, labels, sample_weight, _damped_retry=True)

        return LogisticRegressionModel(
            params=layout.unflatten(theta), scales=scales_np, train_loss=loss,
            center=center_np, n_iter_run=n_done, prep_s=prep_s, device=self.device,
        )

    def fit_many(self, fm, labels, sample_weights, grid_mesh=None):
        raise NotImplementedError("LogisticRegression.fit_many (the CV weight grid) is not ported yet")


class _Layout:
    """The params dict as one flat vector: key -> (offset, shape), in the
    dict's order (bias first)."""

    def __init__(self, params: dict[str, np.ndarray]):
        self.parts: list[tuple[str, int, tuple]] = []
        off = 0
        for k, v in params.items():
            shape = tuple(np.shape(v))
            self.parts.append((k, off, shape))
            off += int(np.prod(shape, dtype=np.int64))
        self.size = off

    def flatten(self, params: dict[str, np.ndarray], device) -> torch.Tensor:
        flat = np.concatenate([np.asarray(params[k], np.float32).reshape(-1) for k, _, _ in self.parts])
        return torch.as_tensor(flat).to(device)

    def views(self, theta: torch.Tensor) -> dict[str, torch.Tensor]:
        return {
            k: theta[off:off + int(np.prod(shape, dtype=np.int64))].reshape(shape)
            for k, off, shape in self.parts
        }

    def unflatten(self, theta: torch.Tensor) -> dict[str, np.ndarray]:
        host = theta.detach().cpu().numpy()
        out = {}
        for k, off, shape in self.parts:
            size = int(np.prod(shape, dtype=np.int64))
            out[k] = host[off:off + size].reshape(shape).copy()
        out["bias"] = np.float32(out["bias"])
        return out


def _lbfgs_loop(loss_fn: Callable[[torch.Tensor], torch.Tensor], theta: torch.Tensor,
                max_iter: int, tol: float) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The JAX module's ``_lbfgs_loop``: L-BFGS steps with the zoom line
    search until at least 2 steps are done and then 3 consecutive plateaus
    (``|prev - value| <= tol * max(|value|, 1e-12)`` in float32) or a
    gradient norm at ``tol``; ``max_iter`` caps the steps. A non-finite
    value or iterate keeps the last finite point and stops. Returns
    ``(theta, loss at theta, steps run)``."""
    tol32 = F(tol)

    def value_and_grad(x):
        return _value_and_grad(loss_fn, x)

    opt = _LBFGS(theta)
    ls_value, ls_grad = F(np.inf), torch.zeros_like(theta)  # the line search's state
    prev, i, bad, flat = F(np.inf), 0, False, 0
    while True:
        gnorm = F(float(torch.linalg.vector_norm(ls_grad)))
        if bad or i >= max_iter or not (i < 2 or (flat < 3 and gnorm > tol32)):
            break
        if np.isfinite(ls_value):
            value, grad = ls_value, ls_grad
        else:
            v, grad = value_and_grad(theta)
            value = F(float(v))
        updates = opt.direction(grad, theta)
        stepsize, ls_value, ls_grad = _zoom_linesearch(value_and_grad, theta, updates, value, grad)
        new_theta = theta + float(stepsize) * updates
        ok = bool(np.isfinite(value)) and bool(torch.isfinite(new_theta).all())
        if ok:
            theta = new_theta
        # Count CONSECUTIVE no-progress steps: float32 L-BFGS can sit on a
        # plateau for a step or two while the line search rescales.
        plateau = bool(abs(prev - value) <= tol32 * max(abs(value), F(1e-12)))
        flat = flat + 1 if plateau else 0
        prev, i, bad = value, i + 1, not ok
    with torch.no_grad():
        loss = loss_fn(theta)
    return theta, loss, i


def _value_and_grad(loss_fn: Callable[[torch.Tensor], torch.Tensor], theta: torch.Tensor):
    x = theta.detach().requires_grad_(True)
    value = loss_fn(x)
    (grad,) = torch.autograd.grad(value, x)
    return value.detach(), grad


class _LBFGS:
    """optax ``scale_by_lbfgs(memory_size, scale_init_precond=True)``
    followed by ``scale(-1)``: the descent direction ``-P_k g_k``."""

    def __init__(self, theta: torch.Tensor, memory_size: int = MEMORY_SIZE):
        p = theta.shape[0]
        self.m = memory_size
        self.count = 0
        self.params = torch.zeros_like(theta)
        self.updates = torch.zeros_like(theta)
        self.dw = torch.zeros((memory_size, p), dtype=theta.dtype, device=theta.device)
        self.du = torch.zeros((memory_size, p), dtype=theta.dtype, device=theta.device)
        self.rho = torch.zeros(memory_size, dtype=theta.dtype, device=theta.device)

    def direction(self, grad: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        m = self.m
        memory_idx = self.count % m
        prev_idx = (self.count - 1) % m
        if self.count > 0:
            dw = params - self.params
            du = grad - self.updates
            vdot = torch.dot(du, dw)
            self.dw[prev_idx] = dw
            self.du[prev_idx] = du
            self.rho[prev_idx] = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
            denom = torch.dot(du, du)
            scale = torch.where(denom > 0.0, vdot / denom, torch.ones_like(vdot))
        else:
            # First step: the capped reciprocal of the gradient norm (the
            # zero secant pair optax stores here is a no-op and is skipped).
            scale = torch.clamp_max(1.0 / torch.linalg.vector_norm(grad), 1.0)
        # Two-loop recursion, oldest slot to newest starting at memory_idx;
        # unwritten slots have rho 0 and change nothing, as in optax.
        order = [(memory_idx + j) % m for j in range(m)]
        vec = grad
        alphas = {}
        for i in reversed(order):
            alpha = self.rho[i] * torch.dot(self.dw[i], vec)
            vec = vec - alpha * self.du[i]
            alphas[i] = alpha
        vec = scale * vec
        for i in order:
            beta = self.rho[i] * torch.dot(self.du[i], vec)
            vec = vec + (alphas[i] - beta) * self.dw[i]
        self.count += 1
        self.params = params
        self.updates = grad
        return -vec


# --------------------------------------------------------------- zoom search
# optax.scale_by_zoom_linesearch defaults: tol 0, increase factor 2,
# slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6, stepsize_precision
# 1e-5, no maximal step. Scalars are float32, as in the JAX program.
_TOL = F(0.0)
_INCREASE = F(2.0)
_SLOPE_RTOL = F(1e-4)
_CURV_RTOL = F(0.9)
_APPROX_DEC_RTOL = F(1e-6)
_INTERVAL_THRESHOLD = F(1e-5)
_TWO_SLOPE_RTOL_M1 = F(2 * 1e-4 - 1.0)


def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
    dec = value_step - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - _TWO_SLOPE_RTOL_M1 * slope_init
    delta_values = value_step - value_init - _APPROX_DEC_RTOL * abs(value_init)
    approx = max(approx, delta_values) if not (np.isnan(approx) or np.isnan(delta_values)) else F(np.nan)
    dec = min(approx, dec) if not (np.isnan(approx) or np.isnan(dec)) else F(np.nan)
    dec = F(np.inf) if np.isnan(dec) else max(dec, F(0.0))
    return F(dec)


def _curvature_error(slope_step, slope_init):
    curv = abs(slope_step) - _CURV_RTOL * abs(slope_init)
    return F(np.inf) if np.isnan(curv) else F(max(curv, F(0.0)))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc**2 * r0 + -(db**2) * r1) / denom
    B = (-(dc**3) * r0 + db**3 * r1) / denom
    radical = B * B - F(3.0) * A * C
    return F(a + (-B + np.sqrt(radical)) / (F(3.0) * A))


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db**2)
    return F(a - fpa / (F(2.0) * B))


def _zoom_linesearch(value_and_grad, params, updates, value, grad, max_steps=MAX_LINESEARCH_STEPS):
    """optax's zoom line search along ``updates`` from ``params`` (value
    ``value``, gradient ``grad``). Returns ``(stepsize, value, grad)`` at the
    accepted step; value and gradient are reused by the next iteration."""

    def on_line(stepsize):
        step = params + float(stepsize) * updates
        v, g = value_and_grad(step)
        s = torch.dot(g, updates)
        host = torch.stack([v, s]).cpu().numpy().astype(np.float32)
        return F(host[0]), g, F(host[1])

    value_init = F(float(value))
    slope_init = F(float(torch.dot(updates, grad)))
    st = dict(
        value_init=value_init, slope_init=slope_init,
        count=0, stepsize=F(0.0), value=value_init, grad=grad, slope=slope_init,
        dec=F(np.inf), curv=F(np.inf), interval_found=False, done=False, failed=False,
        low=F(0.0), value_low=value_init, slope_low=slope_init,
        high=F(0.0), value_high=value_init, slope_high=slope_init,
        cubic_ref=F(0.0), value_cubic_ref=value_init,
        safe_stepsize=F(0.0), safe_value=value_init, safe_grad=grad,
    )
    with np.errstate(all="ignore"):
        while not (st["done"] or st["failed"]):
            if st["interval_found"]:
                _zoom_step(st, on_line, max_steps)
            else:
                _search_step(st, on_line, max_steps)
            if st["failed"]:
                # Try a safe step: the best point with sufficient decrease.
                if st["safe_stepsize"] > 0.0 or np.isinf(st["dec"]):
                    st["stepsize"], st["value"], st["grad"] = (
                        st["safe_stepsize"], st["safe_value"], st["safe_grad"])
    return st["stepsize"], st["value"], st["grad"]


def _search_step(st: dict, on_line, max_steps: int) -> None:
    """Search the initial interval (Algorithm 3.5, Nocedal and Wright)."""
    prev_stepsize, prev_value, prev_slope = st["stepsize"], st["value"], st["slope"]
    new_stepsize = F(1.0) if st["count"] == 0 else _INCREASE * prev_stepsize
    new_value, new_grad, new_slope = on_line(new_stepsize)
    dec = _decrease_error(new_stepsize, new_value, new_slope, st["value_init"], st["slope_init"])
    curv = _curvature_error(new_slope, st["slope_init"])
    new_error = max(dec, curv)
    if dec <= _TOL:
        st["safe_stepsize"], st["safe_value"], st["safe_grad"] = new_stepsize, new_value, new_grad
    set_high_to_new = bool(dec > 0.0) or (bool(new_value >= prev_value) and st["count"] > 0)
    set_low_to_new = bool(new_slope >= 0.0) and not set_high_to_new
    if set_low_to_new:
        low, value_low, slope_low = new_stepsize, new_value, new_slope
        high, value_high, slope_high = prev_stepsize, prev_value, prev_slope
    else:
        low, value_low, slope_low = prev_stepsize, prev_value, prev_slope
        high, value_high, slope_high = new_stepsize, new_value, new_slope
    done = bool(new_error <= _TOL)
    st.update(
        interval_found=set_high_to_new or set_low_to_new or done, done=done,
        failed=(st["count"] + 1 >= max_steps) and not done,
        count=st["count"] + 1, stepsize=new_stepsize, value=new_value, grad=new_grad,
        slope=new_slope, dec=dec, curv=curv,
        low=low, value_low=value_low, slope_low=slope_low,
        high=high, value_high=value_high, slope_high=slope_high,
        cubic_ref=low, value_cubic_ref=value_low,
    )


def _zoom_step(st: dict, on_line, max_steps: int) -> None:
    """Zoom into the interval (Algorithm 3.6, Nocedal and Wright): cubic,
    then quadratic interpolation, then bisection."""
    low, value_low, slope_low = st["low"], st["value_low"], st["slope_low"]
    high, value_high, slope_high = st["high"], st["value_high"], st["slope_high"]
    delta = abs(high - low)
    left, right = min(high, low), max(high, low)
    cubic_chk, quad_chk = F(0.2) * delta, F(0.1) * delta
    too_small_int = bool(delta <= _INTERVAL_THRESHOLD)
    mc = _cubicmin(low, value_low, slope_low, high, value_high, st["cubic_ref"], st["value_cubic_ref"])
    use_cubic = bool(mc > left + cubic_chk) and bool(mc < right - cubic_chk)
    mq = _quadmin(low, value_low, slope_low, high, value_high)
    use_quad = not use_cubic and bool(mq > left + quad_chk) and bool(mq < right - quad_chk)
    if use_cubic:
        middle = mc
    elif use_quad:
        middle = mq
    else:
        middle = F((low + high) / F(2.0))
    value_m, grad_m, slope_m = on_line(middle)
    dec = _decrease_error(middle, value_m, slope_m, st["value_init"], st["slope_init"])
    curv = _curvature_error(slope_m, st["slope_init"])
    new_error = max(dec, curv)
    if dec <= _TOL and bool(value_m < st["safe_value"]):
        st["safe_stepsize"], st["safe_value"], st["safe_grad"] = middle, value_m, grad_m
    done = bool(new_error <= _TOL)
    set_high_to_middle = bool(dec > 0.0) or bool(value_m >= value_low)
    set_high_to_low = bool(slope_m * (high - low) >= 0.0) and not set_high_to_middle
    new_high, new_value_high, new_slope_high = high, value_high, slope_high
    if set_high_to_middle:
        new_high, new_value_high, new_slope_high = middle, value_m, slope_m
    if set_high_to_low:
        new_high, new_value_high, new_slope_high = low, value_low, slope_low
    new_low, new_value_low, new_slope_low = low, value_low, slope_low
    if not set_high_to_middle:
        new_low, new_value_low, new_slope_low = middle, value_m, slope_m
    if set_high_to_middle or set_high_to_low:
        cubic_ref, value_cubic_ref = high, value_high
    else:
        cubic_ref, value_cubic_ref = low, value_low
    presumably_failed = (st["count"] + 1 >= max_steps) or (too_small_int and st["safe_stepsize"] > 0.0)
    st.update(
        done=done, failed=presumably_failed and not done,
        count=st["count"] + 1, stepsize=middle, value=value_m, grad=grad_m, slope=slope_m,
        dec=dec, curv=curv,
        low=new_low, value_low=new_value_low, slope_low=new_slope_low,
        high=new_high, value_high=new_value_high, slope_high=new_slope_high,
        cubic_ref=cubic_ref, value_cubic_ref=value_cubic_ref,
    )
