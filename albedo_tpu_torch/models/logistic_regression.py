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
  then by the last secant pair) chained with ``scale(-1)``: the
  ``lbfgs_direction`` kernel on the card, one launch an iteration
  (``ops/lbfgs.py``; on the CPU its plain version, torch ops);
- :func:`_zoom_linesearch` is optax's ``scale_by_zoom_linesearch`` with
  ``max_linesearch_steps=MAX_LINESEARCH_STEPS`` (8) and
  ``initial_guess_strategy="one"``, its defaults otherwise; its final value
  and gradient are reused by the next iteration, as
  ``optax.value_and_grad_from_state`` does;
- :func:`_lbfgs_loop_reference` keeps the last finite point and stops after
  at least 2 steps on 3 consecutive plateaus or a gradient norm at ``tol``.

The parameters live in one flat float32 vector on the device, and the
objective and its gradient are ``ops.sparse_linear.LogisticObjective`` on
that vector (K8, K8c and the ``logloss`` kernel around the dense products,
no autograd: about 35 graph nodes an evaluation). In the plain
loop (:func:`_lbfgs_loop_reference`, what ``fit`` runs on the CPU) the line
search's scalar logic runs on the host in numpy float32, one device read per
function evaluation, where the JAX loop runs in a device ``while_loop``. On
the card ``fit`` runs K19, the port's ``_lbfgs_fit_jit``
(:func:`_lbfgs_loop_graph`): the loop's state in device tensors, its logic in
the ``lbfgs_state`` and ``lbfgs_stop`` kernels (``ops/lbfgs.py``), iteration
0 up to its first trial eager, then one iteration captured once as a CUDA
graph whose pieces (the stale re-evaluation, the direction, each of the 8
trials, the step) sit under conditional nodes, launched in blocks of 10 while
some row is active: the plain loop's bits, with the host reading one flag a
block (``utils/graphs.py replay_while``).

``fit_many`` (the CV instance-weight grid) is the JAX module's ``jax.vmap``
of that loop written out: :func:`_lbfgs_loop_many_reference` keeps a (G, P)
parameter matrix, and each row its own L-BFGS memory, line-search state,
step count and stop rule, with the host logic on (G,) float32 vectors (the
device reads per step do not grow with G); on the card the same device loop
runs it, a row a thread in the state kernels. Every line-search trial
evaluates the loss and gradient of all G rows in one pass (K8g and K8c-g,
``ops.sparse_linear``). As under ``vmap``, a row whose loop or line search
has stopped keeps its state while the others go on; a row that stopped never
runs again, so the rows still running share one step count.

``solver="adam"`` is the JAX module's ``_run_adam``: ``max_iter`` steps,
each the loss and gradient at the current parameters (K8, K8c) followed by
one ``optax.adam`` update of the flat vector (the ``adam_dense`` kernel;
optax's update is elementwise, so over the flat vector it equals its
per-leaf update). As in JAX there is no stop rule, ``train_loss`` is the loss
of the last step, at the parameters before its update, and ``n_iter_run`` is
None. On the card the steps run as one captured step replayed
(:func:`_adam_graph`, the JAX scan's counterpart); on the CPU
:func:`_adam_loop`.

A fit's ``compile_s`` (the model's and ``last_fit_report``'s) is the time of
capturing its graph, None on the CPU; ``run_s`` the solve less it.

Not ported: ``mesh`` and ``fit_many(grid_mesh=...)`` (multi-GPU; both raise
``NotImplementedError``), and the persistent executable cache.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from albedo_tpu_torch.features.assembler import FeatureMatrix
from albedo_tpu_torch.ops import lbfgs as lbfgs_ops
from albedo_tpu_torch.ops.sgns import adam_dense, bias_table
from albedo_tpu_torch.ops.sparse_linear import (
    LogisticObjective,
    block_logits,
    dense_center,
    feature_batch,
    init_params,
    inverse_std_scales,
)
from albedo_tpu_torch.utils import graphs
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
    compile_s: float | None = None  # capturing the solve's CUDA graph (None on the CPU)
    run_s: float | None = None  # the solve less compile_s (shared by the models of one fit_many)
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
    solver: str = "lbfgs"  # "lbfgs" (MLlib parity) or "adam"
    learning_rate: float = 0.05  # adam only
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
        if self.solver not in ("lbfgs", "adam"):
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
        center = None if center_np is None else torch.as_tensor(center_np).to(dev)
        layout = _Layout(params_np)
        theta0 = layout.flatten(params_np, dev)
        objective = LogisticObjective(layout.sizes, scales_np, batch, y, w, float(self.reg_param), center)
        prep_s = time.perf_counter() - t_prep

        report = self.last_fit_report = _new_report(dev)
        t0 = time.perf_counter()
        if self.solver == "lbfgs":
            if dev.type == "cpu":
                theta, loss_t, n_done = _lbfgs_loop_reference(objective, theta0, self.max_iter, self.tol)
            else:
                name = f"LogisticRegression.fit (L-BFGS, {layout.size} parameters)"
                theta, loss_t, n_done = _lbfgs_loop_graph(objective, theta0, self.max_iter, self.tol, name, report)
        elif dev.type == "cpu":
            theta, loss_t = _adam_loop(objective, theta0, self.max_iter, self.learning_rate)
        else:
            name = f"LogisticRegression.fit (Adam, {layout.size} parameters, {self.max_iter} steps)"
            theta, loss_t = _adam_graph(objective, theta0, self.max_iter, self.learning_rate, name, report)
        loss = float(loss_t)  # device read: the completion barrier
        n_done = None if self.solver == "adam" else int(n_done)
        compile_s = report["compile_s"]
        run_s = time.perf_counter() - t0 - (compile_s or 0.0)
        report["device_s"] = run_s

        if not check_lr_loss(loss):
            if _damped_retry:
                raise TrainingDiverged(self.max_iter, ["lr"])
            retry = dataclasses.replace(self, reg_param=max(float(self.reg_param) * 10.0, 1e-2))
            return retry.fit(fm, labels, sample_weight, _damped_retry=True)

        return LogisticRegressionModel(
            params=layout.unflatten(theta), scales=scales_np, train_loss=loss,
            center=center_np, n_iter_run=n_done, prep_s=prep_s, compile_s=compile_s, run_s=run_s,
            device=self.device,
        )

    def fit_many(
        self,
        fm: FeatureMatrix,
        labels: np.ndarray,
        sample_weights: np.ndarray,   # (G, N): one row per grid point
        grid_mesh: Any | None = None,
    ) -> list[LogisticRegressionModel]:
        """One model per row of ``sample_weights`` in a single batched L-BFGS
        solve: the ``LogisticRegressionRankerCV`` instance-weight grid
        (``LogisticRegressionRankerCV.scala:326-332``), which refits the SAME
        featurized set under different weight columns. Features, labels,
        scales and the zero init are shared; the models share ``prep_s`` and
        ``run_s``. There is no damped retry (the JAX ``fit_many`` has none).
        ``grid_mesh`` (the grid over several devices) is not ported."""
        if self.solver != "lbfgs":
            raise ValueError(f"fit_many supports solver='lbfgs' only, not {self.solver!r}")
        if self.mesh is not None:
            raise ValueError(
                "fit_many shards the GRID axis via grid_mesh; combining it with "
                "a row-sharded batch (self.mesh) is not supported"
            )
        if grid_mesh is not None:
            raise NotImplementedError("LogisticRegression.fit_many(grid_mesh=...): the multi-GPU grid is not ported yet")
        ws = np.asarray(sample_weights, dtype=np.float32)
        if ws.ndim != 2 or ws.shape[0] == 0:
            raise ValueError("sample_weights must have at least one grid row")
        dev = resolve_device(self.device)
        t_prep = time.perf_counter()
        batch = feature_batch(fm, dev, grad_layout=True)
        y = torch.as_tensor(np.asarray(labels, np.float32)).to(dev)
        w = torch.as_tensor(ws).to(dev)
        scales_np, center_np = self._prepare_scales(fm)
        params_np = init_params(fm)
        center = None if center_np is None else torch.as_tensor(center_np).to(dev)
        layout = _Layout(params_np)
        theta0 = layout.flatten(params_np, dev).expand(ws.shape[0], -1).contiguous()
        objective = LogisticObjective(layout.sizes, scales_np, batch, y, w, float(self.reg_param), center)
        prep_s = time.perf_counter() - t_prep

        report = self.last_fit_report = _new_report(dev)
        t0 = time.perf_counter()
        if dev.type == "cpu":
            theta, losses_t, n_done = _lbfgs_loop_many_reference(objective, theta0, self.max_iter, self.tol)
        else:
            name = f"LogisticRegression.fit_many (L-BFGS, {ws.shape[0]} rows of {layout.size} parameters)"
            theta, losses_t, n_done = _lbfgs_loop_graph(objective, theta0, self.max_iter, self.tol, name, report)
            n_done = n_done.cpu().numpy()
        losses = losses_t.cpu().numpy()  # device read: the completion barrier
        compile_s = report["compile_s"]
        run_s = time.perf_counter() - t0 - (compile_s or 0.0)
        report["device_s"] = run_s
        return [
            LogisticRegressionModel(
                params=layout.unflatten(theta[g]), scales=scales_np, train_loss=float(losses[g]),
                center=center_np, n_iter_run=int(n_done[g]), prep_s=prep_s, compile_s=compile_s, run_s=run_s,
                device=self.device,
            )
            for g in range(ws.shape[0])
        ]


def _new_report(dev: torch.device) -> dict:
    """A fit's ``last_fit_report`` before its solve: ``compile_s`` None on
    the CPU (no graph), 0.0 on the card until a graph is captured."""
    return {"compile_s": None if dev.type == "cpu" else 0.0, "compile_source": None, "blocks": 0,
            "host_reads": None, "evaluations": None}


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

    @property
    def sizes(self) -> dict[str, int]:
        """Each leaf's number of entries, in the flat order."""
        return {k: int(np.prod(shape, dtype=np.int64)) for k, _, shape in self.parts}

    def flatten(self, params: dict[str, np.ndarray], device) -> torch.Tensor:
        flat = np.concatenate([np.asarray(params[k], np.float32).reshape(-1) for k, _, _ in self.parts])
        return torch.as_tensor(flat).to(device)

    def views(self, theta: torch.Tensor) -> dict[str, torch.Tensor]:
        """The params of a (P,) vector, or of each row of a (G, P) matrix
        with a leading G axis on every leaf."""
        lead = tuple(theta.shape[:-1])
        return {
            k: theta[..., off:off + int(np.prod(shape, dtype=np.int64))].reshape(lead + shape)
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


def _lbfgs_loop_reference(objective: LogisticObjective, theta: torch.Tensor,
                max_iter: int, tol: float) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The JAX module's ``_lbfgs_loop``: L-BFGS steps with the zoom line
    search until at least 2 steps are done and then 3 consecutive plateaus
    (``|prev - value| <= tol * max(|value|, 1e-12)`` in float32) or a
    gradient norm at ``tol``; ``max_iter`` caps the steps. A non-finite
    value or iterate keeps the last finite point and stops. Returns
    ``(theta, loss at theta, steps run)``. ``objective``'s
    ``value_and_grad`` returns a fresh gradient each call."""
    tol32 = F(tol)
    value_and_grad = objective.value_and_grad
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
        updates, slope = opt.direction(grad, theta)
        stepsize, ls_value, ls_grad = _zoom_linesearch(value_and_grad, theta, updates, value, grad, slope)
        new_theta = theta + float(stepsize) * updates
        ok = bool(np.isfinite(value)) and bool(torch.isfinite(new_theta).all())
        if ok:
            theta = new_theta
        # Count CONSECUTIVE no-progress steps: float32 L-BFGS can sit on a
        # plateau for a step or two while the line search rescales.
        plateau = bool(abs(prev - value) <= tol32 * max(abs(value), F(1e-12)))
        flat = flat + 1 if plateau else 0
        prev, i, bad = value, i + 1, not ok
    return theta, objective.value(theta), i


def _adam_loop(objective: LogisticObjective, theta: torch.Tensor,
               max_iter: int, lr: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX module's ``_run_adam``: ``max_iter`` steps of the loss and
    gradient at ``theta`` followed by one Adam update (``adam_dense``, in
    place on a copy of ``theta``). Returns ``(theta, loss of the last
    step)``: the loss at the parameters before the last update, the JAX
    scan's ``losses[-1]``."""
    if max_iter < 1:
        raise ValueError(f"solver='adam' runs max_iter >= 1 steps, got {max_iter}")
    theta = theta.clone()
    m, v = torch.zeros_like(theta), torch.zeros_like(theta)
    for count in range(1, max_iter + 1):
        loss, grad = objective.value_and_grad(theta)
        adam_dense(theta, grad, m, v, count, lr)
    return theta, loss


def _adam_graph(objective: LogisticObjective, theta: torch.Tensor, max_iter: int, lr: float,
                name: str, report: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`_adam_loop` on the card, the JAX scan's counterpart: step 0
    eagerly, then one step captured as a CUDA graph and replayed ``max_iter
    - 1`` times (``utils.graphs.replay_loop``). Adam reads each step's bias
    pair from a row of ``ops.sgns.bias_table`` (the captured step from a
    static row refilled before each replay), and the loss goes into a slot:
    the same bits as :func:`_adam_loop`."""
    if max_iter < 1:
        raise ValueError(f"solver='adam' runs max_iter >= 1 steps, got {max_iter}")
    theta = theta.clone()
    m, v = torch.zeros_like(theta), torch.zeros_like(theta)
    bias = bias_table(max_iter, theta.device)
    row = bias[0].clone()  # the captured step's pair
    loss = torch.zeros((), dtype=theta.dtype, device=theta.device)

    def step(i):
        value, grad = objective.value_and_grad(theta)
        adam_dense(theta, grad, m, v, bias[0] if i == 0 else row, lr)
        loss.copy_(value)

    graphs.replay_loop(name, theta.device, step, max_iter, refill=lambda i: row.copy_(bias[i]), report=report,
                       span="lr_adam.replays")
    return theta, loss


# Iterations a block: the graph of one iteration is launched this many times
# between two host reads of "some row is active".
BLOCK = MEMORY_SIZE


class _DeviceLoop:
    """The L-BFGS loop with its state on the device (K19): a (P,) ``theta``
    (``fit``, one row: ``torch.dot`` and the vector norm, as
    :func:`_lbfgs_loop_reference`) or a (G, P) one (``fit_many``: row dots
    and row norms, as :func:`_lbfgs_loop_many_reference`), the same torch
    operations in the same order as those loops, with their host logic in
    ``ops.lbfgs`` (the ``lbfgs_state``, ``lbfgs_stop`` and
    ``lbfgs_direction`` kernels). Every value the loop carries lives in a
    tensor updated in place, so one iteration captured once serves every
    launch. An iteration is pieces (``utils.graphs.replay_while``), each run
    where its flag holds: the stale re-evaluation (some active row has no
    stored value), the L-BFGS direction (some row is active; its memory
    slots follow the count the kernel reads from the state's ``i``), each
    line-search trial (some row still searches), the step and stop test
    (some row is active)."""

    def __init__(self, objective: LogisticObjective, theta: torch.Tensor, max_iter: int, tol: float):
        self.grid = theta.dim() == 2
        self.objective, self.max_iter, self.tol = objective, max_iter, tol
        self.theta = theta.detach().clone()
        self.state = lbfgs_ops.new_state(theta.shape[0] if self.grid else 1, theta.device, max_iter)
        self.opt = _LBFGS(self.theta)
        self.ls_grad = torch.zeros_like(self.theta)  # the line search's stored gradient
        self.updates = torch.zeros_like(self.theta)  # this iteration's direction
        self.slope_init = torch.zeros_like(self.state.fs[0])  # its slope at the iteration's point
        self.grad = torch.zeros_like(self.theta)  # the search's current gradient
        self.safe_grad = torch.zeros_like(self.theta)
        self.host_reads = self.evaluations = self.first_evaluations = 0

    def _value_and_grad(self, x):
        self.evaluations += 1  # enqueued eagerly or captured
        return self.objective.value_and_grad(x)

    def _row(self, field: int) -> torch.Tensor:
        """A (G,) float field as a (G, 1) column ((1,) for one row)."""
        f = self.state.fs[field]
        return f[:, None] if self.grid else f

    def _mask(self, mask: int) -> torch.Tensor:
        m = self.state.ms[mask]
        return m[:, None] if self.grid else m

    def stale(self) -> None:
        """Rows without a stored value re-evaluate at their point."""
        v, g = self._value_and_grad(self.theta)
        ls_value = self.state.fs[lbfgs_ops.F_LS_VALUE]
        torch.where(self.state.ms[lbfgs_ops.M_STALE], v, ls_value, out=ls_value)
        torch.where(self._mask(lbfgs_ops.M_STALE), g, self.ls_grad, out=self.ls_grad)

    def direction(self) -> None:
        """The iteration's L-BFGS direction and its slope (the count read
        from the rows' ``i``), and the search's safe gradient."""
        self.opt.direction(self.ls_grad, self.theta, self.state.is_[lbfgs_ops.I_ITER],
                           out=(self.updates, self.slope_init))
        self.safe_grad.copy_(self.ls_grad)

    def trial(self, j: int) -> None:
        """Line-search trial ``j`` of the rows still searching."""
        x = self.theta + self._row(lbfgs_ops.F_TRIAL) * self.updates
        v, g = self._value_and_grad(x)
        lbfgs_ops.zoom_trial(self.state, v, lbfgs_ops.dot(g, self.updates), self.slope_init if j == 0 else None, j,
                             MAX_LINESEARCH_STEPS)
        torch.where(self._mask(lbfgs_ops.M_SAFE_NEW), g, self.safe_grad, out=self.safe_grad)
        torch.where(self._mask(lbfgs_ops.M_TOOK), g, self.grad, out=self.grad)
        torch.where(self._mask(lbfgs_ops.M_SAFE_TAKE), self.safe_grad, self.grad, out=self.grad)

    def finish(self) -> None:
        """The step of the active rows, kept where finite, and the stop test."""
        new_theta = self.theta + self._row(lbfgs_ops.F_STEP) * self.updates
        finite = torch.isfinite(new_theta).all(dim=1) if self.grid else torch.isfinite(new_theta).all()
        torch.where(self._mask(lbfgs_ops.M_ACTIVE), self.grad, self.ls_grad, out=self.ls_grad)
        gnorm = (torch.linalg.vector_norm(self.ls_grad, dim=1) if self.grid
                 else torch.linalg.vector_norm(self.ls_grad))
        lbfgs_ops.lbfgs_stop(self.state, finite, gnorm, self.max_iter, self.tol)
        torch.where(self._mask(lbfgs_ops.M_OK), new_theta, self.theta, out=self.theta)

    def iteration(self, when) -> None:
        """Enqueue an iteration after the first as ``when(pred, key, fn)``
        pieces."""
        flags = self.state.flags
        when(flags[lbfgs_ops.FLAG_STALE], ("stale",), self.stale)
        when(flags[lbfgs_ops.FLAG_ACTIVE], ("direction",), self.direction)
        for j in range(MAX_LINESEARCH_STEPS):
            when(flags[lbfgs_ops.FLAG_RUNNING], ("trial", j), lambda j=j: self.trial(j))
        when(flags[lbfgs_ops.FLAG_ACTIVE], ("finish",), self.finish)

    def first(self) -> None:
        """Iteration 0 up to its first trial, eagerly (every row is stale
        and active): the warm-up. Its other trials and its step run from
        the captured pieces."""
        lbfgs_ops.load(self.theta.device)  # the state kernels, before a capture launches lbfgs_stop
        self.stale()
        self.direction()
        self.trial(0)
        self.first_evaluations = self.evaluations

    def run(self, name: str, report: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The loop to its end; returns ``(theta, loss at theta, steps run
        per row)`` (0-d loss and step count for one row)."""
        if self.max_iter >= 1:
            self.host_reads = graphs.replay_while(
                name, self.theta.device, self.first, self.iteration, self.state.flags[lbfgs_ops.FLAG_ACTIVE],
                self.max_iter - 1, ("trial", 1), BLOCK, report=report, span="lbfgs.replays")
        runs = report.get("key_runs")  # the captured pieces' runs; each trial and the stale piece evaluates once
        report.update(host_reads=self.host_reads, evaluations=self.evaluations if runs is None else
                      self.first_evaluations + sum(t for key, t in runs.items() if key[0] in ("stale", "trial")))
        loss = self.objective.value(self.theta)
        steps = self.state.is_[lbfgs_ops.I_ITER]
        return self.theta, loss, (steps if self.grid else steps[0])


def _lbfgs_loop_graph(objective: LogisticObjective, theta: torch.Tensor, max_iter: int, tol: float, name: str,
                      report: dict) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_lbfgs_loop_reference` (a (P,) ``theta``) or
    :func:`_lbfgs_loop_many_reference` (a (G, P) one) with the loop's state
    on the card: iteration 0 up to its first trial eagerly, then one
    iteration captured as a CUDA graph of conditional pieces (the rest of
    iteration 0 runs from them first) and launched in blocks of ``BLOCK``
    while some row is active: the same bits. ``report`` gets
    ``compile_s``, ``blocks``, ``host_reads`` (one flag a block) and
    ``evaluations`` (of the objective and its gradient, the final loss not
    counted)."""
    return _DeviceLoop(objective, theta, max_iter, tol).run(name, report)


class _LBFGS:
    """optax ``scale_by_lbfgs(memory_size, scale_init_precond=True)``
    followed by ``scale(-1)``: the descent direction ``-P_k g_k`` and its
    slope, for a (P,) vector or, row by row, a (G, P) matrix (the grid: only
    the rows still running use the result, and they share the step count,
    since a row that stops never runs again). ``ops.lbfgs.lbfgs_direction``
    computes it: the kernel on the card, its plain version (the two-loop
    recursion in torch ops) on the CPU."""

    def __init__(self, theta: torch.Tensor, memory_size: int = MEMORY_SIZE):
        self.memory = lbfgs_ops.new_memory(theta, memory_size)
        self.count = 0  # the host loops' count; the device loop passes the state's
        self.iters = torch.zeros(1, dtype=torch.int32, device=theta.device)

    def direction(self, grad: torch.Tensor, params: torch.Tensor, iters: torch.Tensor | None = None,
                  out: tuple[torch.Tensor, torch.Tensor] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """``(updates, slope)`` at the iteration whose count is the largest
        of the device tensor ``iters``, or, without it, at this object's
        next count (written to a device tensor, no host sync)."""
        if iters is None:
            iters = self.iters.fill_(self.count)
            self.count += 1
        return lbfgs_ops.lbfgs_direction(grad, params, self.memory, iters, out)


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
    """optax's sufficient-decrease error, on float32 scalars or (G,) arrays
    (a NaN anywhere gives inf)."""
    dec = value_step - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - _TWO_SLOPE_RTOL_M1 * slope_init
    delta_values = value_step - value_init - _APPROX_DEC_RTOL * abs(value_init)
    approx = np.maximum(approx, delta_values)  # NaN if either is
    dec = np.minimum(approx, dec)
    return F(np.where(np.isnan(dec), F(np.inf), np.maximum(dec, F(0.0))))


def _curvature_error(slope_step, slope_init):
    curv = abs(slope_step) - _CURV_RTOL * abs(slope_init)
    return F(np.where(np.isnan(curv), F(np.inf), np.maximum(curv, F(0.0))))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """optax's cubic interpolant's minimizer. Its powers are products,
    ``x * x`` and ``x * (x * x)``, as JAX lowers ``x**2`` and ``x**3``:
    numpy's float32 ``**`` goes through the host's ``powf`` (scalars) or a
    vector library (arrays), which round differently from each other and
    from the card."""
    C = fpa
    db = b - a
    dc = c - a
    dbdc = db * dc
    denom = (dbdc * dbdc) * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = ((dc * dc) * r0 + -(db * db) * r1) / denom
    B = (-(dc * (dc * dc)) * r0 + (db * (db * db)) * r1) / denom
    radical = B * B - F(3.0) * A * C
    return F(a + (-B + np.sqrt(radical)) / (F(3.0) * A))


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return F(a - fpa / (F(2.0) * B))


def _zoom_linesearch(value_and_grad, params, updates, value, grad, slope, max_steps=MAX_LINESEARCH_STEPS):
    """optax's zoom line search along ``updates`` from ``params`` (value
    ``value``, gradient ``grad``, slope ``slope`` = ``<updates, grad>``).
    Returns ``(stepsize, value, grad)`` at the accepted step; value and
    gradient are reused by the next iteration."""

    def on_line(stepsize):
        step = params + float(stepsize) * updates
        v, g = value_and_grad(step)
        s = torch.dot(g, updates)
        host = torch.stack([v, s]).cpu().numpy().astype(np.float32)
        return F(host[0]), g, F(host[1])

    value_init = F(float(value))
    slope_init = F(float(slope))
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


# --------------------------------------------------------- the grid (vmap)


def _lbfgs_loop_many_reference(objective: LogisticObjective, theta: torch.Tensor,
                     max_iter: int, tol: float) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """:func:`_lbfgs_loop_reference` for each row of a (G, P) ``theta``, as
    ``jax.vmap`` runs it: the loop goes on while any row's condition holds,
    and a row whose condition fails keeps its point, value, step count and
    stop flags. ``objective`` maps (G, P) to the (G,) losses and their (G,
    P) gradients, row g a function of row g only. Returns ``(theta, losses
    at theta, steps run per row)``."""
    tol32 = F(tol)
    n_grid = theta.shape[0]
    value_and_grad = objective.value_and_grad
    opt = _LBFGS(theta)
    ls_value, ls_grad = np.full(n_grid, np.inf, F), torch.zeros_like(theta)
    prev = np.full(n_grid, np.inf, F)
    i = np.zeros(n_grid, np.int64)
    bad = np.zeros(n_grid, bool)
    flat = np.zeros(n_grid, np.int64)
    while True:
        gnorm = torch.linalg.vector_norm(ls_grad, dim=1).cpu().numpy().astype(F)
        active = ~bad & (i < max_iter) & ((i < 2) | ((flat < 3) & (gnorm > tol32)))
        if not active.any():
            break
        value, grad = ls_value, ls_grad
        stale = active & ~np.isfinite(ls_value)  # no stored line-search value to reuse
        if stale.any():
            v, g = value_and_grad(theta)
            value = np.where(stale, v.cpu().numpy().astype(F), ls_value)
            grad = torch.where(_rows(stale, theta), g, ls_grad)
        updates, slope = opt.direction(grad, theta)
        stepsize, new_value, new_grad = _zoom_linesearch_many(
            value_and_grad, theta, updates, value, grad, slope, active)
        new_theta = theta + torch.as_tensor(stepsize, device=theta.device)[:, None] * updates
        ok = np.isfinite(value) & torch.isfinite(new_theta).all(dim=1).cpu().numpy()
        theta = torch.where(_rows(active & ok, theta), new_theta, theta)
        ls_value = np.where(active, new_value, ls_value)
        ls_grad = torch.where(_rows(active, theta), new_grad, ls_grad)
        with np.errstate(invalid="ignore"):
            plateau = abs(prev - value) <= tol32 * np.maximum(abs(value), F(1e-12))
        flat = np.where(active, np.where(plateau, flat + 1, 0), flat)
        prev = np.where(active, value, prev)
        i = np.where(active, i + 1, i)
        bad = np.where(active, ~ok, bad)
    return theta, objective.value(theta), i


def _rows(mask: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A (G,) host mask as a (G, 1) device mask for ``torch.where``."""
    return torch.as_tensor(mask, device=like.device)[:, None]


def _zoom_linesearch_many(value_and_grad, params, updates, value, grad, slope, active,
                          max_steps=MAX_LINESEARCH_STEPS):
    """:func:`_zoom_linesearch` for each row of (G, P) ``params`` along its
    row of ``updates``, from (G,) ``value``, (G, P) ``grad`` and (G,)
    ``slope`` (each row's ``<updates, grad>``), for the rows
    of the (G,) mask ``active``; the others are returned as given (their
    results are not used). Each trial evaluates every row in one pass: a
    row still searching its interval at its next trial step, a row zooming
    at its interpolated point. Returns ``(stepsize, value, grad)``."""
    n_grid = params.shape[0]
    dev = params.device

    def on_line(stepsize):
        v, g = value_and_grad(params + torch.as_tensor(stepsize, device=dev)[:, None] * updates)
        host = torch.stack([v, lbfgs_ops.dot(g, updates)]).cpu().numpy().astype(F)
        return host[0], g, host[1]

    value_init = np.asarray(value, F)
    slope_init = slope.cpu().numpy().astype(F)
    zero = np.zeros(n_grid, F)
    inf = np.full(n_grid, np.inf, F)
    st = dict(
        value_init=value_init, slope_init=slope_init,
        stepsize=zero, value=value_init, grad=grad, slope=slope_init, dec=inf, curv=inf,
        interval_found=np.zeros(n_grid, bool), done=np.zeros(n_grid, bool), failed=np.zeros(n_grid, bool),
        low=zero, value_low=value_init, slope_low=slope_init,
        high=zero, value_high=value_init, slope_high=slope_init,
        cubic_ref=zero, value_cubic_ref=value_init,
        safe_stepsize=zero, safe_value=value_init, safe_grad=grad,
    )
    running = np.asarray(active, bool).copy()
    count = 0  # the rows still running have all taken the same number of trials
    with np.errstate(all="ignore"):
        while running.any():
            zoom = running & st["interval_found"]
            search = running & ~st["interval_found"]
            middle = _zoom_middle(st)
            trial = np.where(zoom, middle, F(1.0) if count == 0 else _INCREASE * st["stepsize"])
            new_value, new_grad, new_slope = on_line(np.where(running, trial, F(0.0)).astype(F))
            found = _search_update(st, count, max_steps, trial, new_value, new_grad, new_slope)
            zoomed = _zoom_update(st, count, max_steps, trial, new_value, new_grad, new_slope)
            for key in st:
                st[key] = _select(search, found[key], _select(zoom, zoomed[key], st[key]))
            failed = running & st["failed"]
            # A failed search takes the safe step: the best point with sufficient decrease.
            safe = failed & ((st["safe_stepsize"] > 0.0) | np.isinf(st["dec"]))
            st["stepsize"] = np.where(safe, st["safe_stepsize"], st["stepsize"])
            st["value"] = np.where(safe, st["safe_value"], st["value"])
            st["grad"] = _select(safe, st["safe_grad"], st["grad"])
            running = running & ~(st["done"] | st["failed"])
            count += 1
    return st["stepsize"], st["value"], st["grad"]


def _select(mask: np.ndarray, a, b):
    """Row-wise ``a if mask else b`` for (G,) host arrays and (G, P) tensors."""
    if isinstance(a, torch.Tensor):
        return torch.where(_rows(mask, a), a, b)
    return np.where(mask, a, b)


def _zoom_middle(st: dict) -> np.ndarray:
    """The next trial of a zooming row (:func:`_zoom_step`): the cubic, else
    the quadratic interpolant's minimizer if inside the interval's safe
    part, else the bisection."""
    low, high = st["low"], st["high"]
    delta = abs(high - low)
    left, right = np.minimum(high, low), np.maximum(high, low)
    mc = _cubicmin(low, st["value_low"], st["slope_low"], high, st["value_high"],
                   st["cubic_ref"], st["value_cubic_ref"])
    use_cubic = (mc > left + F(0.2) * delta) & (mc < right - F(0.2) * delta)
    mq = _quadmin(low, st["value_low"], st["slope_low"], high, st["value_high"])
    use_quad = ~use_cubic & (mq > left + F(0.1) * delta) & (mq < right - F(0.1) * delta)
    return F(np.where(use_cubic, mc, np.where(use_quad, mq, F((low + high) / F(2.0)))))


def _search_update(st, count, max_steps, new_stepsize, new_value, new_grad, new_slope) -> dict:
    """:func:`_search_step`'s new state for every row, from its trial."""
    prev_stepsize, prev_value, prev_slope = st["stepsize"], st["value"], st["slope"]
    dec = _decrease_error(new_stepsize, new_value, new_slope, st["value_init"], st["slope_init"])
    curv = _curvature_error(new_slope, st["slope_init"])
    safe = dec <= _TOL
    set_high_to_new = (dec > 0.0) | ((new_value >= prev_value) & (count > 0))
    set_low_to_new = (new_slope >= 0.0) & ~set_high_to_new
    low = np.where(set_low_to_new, new_stepsize, prev_stepsize)
    value_low = np.where(set_low_to_new, new_value, prev_value)
    done = np.maximum(dec, curv) <= _TOL
    return dict(
        st,
        safe_stepsize=np.where(safe, new_stepsize, st["safe_stepsize"]),
        safe_value=np.where(safe, new_value, st["safe_value"]),
        safe_grad=_select(safe, new_grad, st["safe_grad"]),
        interval_found=set_high_to_new | set_low_to_new | done, done=done,
        failed=(count + 1 >= max_steps) & ~done,
        stepsize=new_stepsize, value=new_value, grad=new_grad, slope=new_slope, dec=dec, curv=curv,
        low=low, value_low=value_low,
        slope_low=np.where(set_low_to_new, new_slope, prev_slope),
        high=np.where(set_low_to_new, prev_stepsize, new_stepsize),
        value_high=np.where(set_low_to_new, prev_value, new_value),
        slope_high=np.where(set_low_to_new, prev_slope, new_slope),
        cubic_ref=low, value_cubic_ref=value_low,
    )


def _zoom_update(st, count, max_steps, middle, value_m, grad_m, slope_m) -> dict:
    """:func:`_zoom_step`'s new state for every row, from its trial at
    ``middle``."""
    low, value_low, slope_low = st["low"], st["value_low"], st["slope_low"]
    high, value_high, slope_high = st["high"], st["value_high"], st["slope_high"]
    too_small_int = abs(high - low) <= _INTERVAL_THRESHOLD
    dec = _decrease_error(middle, value_m, slope_m, st["value_init"], st["slope_init"])
    curv = _curvature_error(slope_m, st["slope_init"])
    safe = (dec <= _TOL) & (value_m < st["safe_value"])
    safe_stepsize = np.where(safe, middle, st["safe_stepsize"])
    done = np.maximum(dec, curv) <= _TOL
    to_middle = (dec > 0.0) | (value_m >= value_low)
    to_low = (slope_m * (high - low) >= 0.0) & ~to_middle
    moved = to_middle | to_low
    presumably_failed = (count + 1 >= max_steps) | (too_small_int & (safe_stepsize > 0.0))
    return dict(
        st,
        safe_stepsize=safe_stepsize,
        safe_value=np.where(safe, value_m, st["safe_value"]),
        safe_grad=_select(safe, grad_m, st["safe_grad"]),
        done=done, failed=presumably_failed & ~done,
        stepsize=middle, value=value_m, grad=grad_m, slope=slope_m, dec=dec, curv=curv,
        low=np.where(to_middle, low, middle),
        value_low=np.where(to_middle, value_low, value_m),
        slope_low=np.where(to_middle, slope_low, slope_m),
        high=np.where(to_middle, middle, np.where(to_low, low, high)),
        value_high=np.where(to_middle, value_m, np.where(to_low, value_low, value_high)),
        slope_high=np.where(to_middle, slope_m, np.where(to_low, slope_low, slope_high)),
        cubic_ref=np.where(moved, high, low),
        value_cubic_ref=np.where(moved, value_high, value_low),
    )
