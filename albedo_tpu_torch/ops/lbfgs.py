"""The L-BFGS fits' loop state on the device and its kernels (K19's state
machine, ``kernels/csrc/lbfgs_state.cu``, and its direction,
``kernels/csrc/lbfgs_direction.cu``).

The loop of ``models/logistic_regression.py`` keeps every scalar it carries
in one :class:`LoopState`: per grid row (G rows, 1 for ``fit``) the zoom
line search's state and the loop's ``i``, ``bad``, ``flat``, ``prev`` and
stored line-search value, the row masks the torch glue selects gradients
and iterates by, and the device bools that switch a captured iteration's
conditional nodes: some row active, running, stale.

- :func:`zoom_trial` (CUDA kernel ``lbfgs_state``): one line-search trial
  from its (G,) value and slope; a row that is not running is left as it
  is.
- :func:`lbfgs_stop` (CUDA kernel ``lbfgs_stop``, counted apart): the
  bookkeeping after a step and the stop test on the (G,) gradient norms.
- :func:`lbfgs_direction` (CUDA kernel ``lbfgs_direction``): the whole
  L-BFGS direction of an iteration (optax's ``scale_by_lbfgs`` with
  ``scale(-1)``) and its slope, with the update of the :class:`Memory`, the
  iteration count read from a device tensor (the loop state's ``i``).

The plain versions (:func:`zoom_trial_reference`, :func:`lbfgs_stop_reference`)
apply the same float32 rules with torch on (G,) tensors; they give the
kernel's bits, and the plain loops' numpy float32 values.
:func:`lbfgs_direction_reference` is the plain loops' two-loop recursion in
torch ops (the kernel sums its dots in another order). On the CPU the
wrappers run them; on the card they launch the kernel or raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from albedo_tpu_torch.kernels.build import call, check_operand, on_cpu

# Field rows, mirrored from lbfgs_state.cu. fs (NF, G) float32:
(F_VALUE_INIT, F_SLOPE_INIT, F_STEP, F_VALUE, F_SLOPE, F_DEC, F_CURV, F_LOW, F_VALUE_LOW, F_SLOPE_LOW, F_HIGH,
 F_VALUE_HIGH, F_SLOPE_HIGH, F_CUBIC_REF, F_VALUE_CUBIC_REF, F_SAFE_STEP, F_SAFE_VALUE, F_TRIAL, F_LS_VALUE,
 F_PREV) = range(20)
NF = 20
# is (NI, G) int32:
I_INTERVAL, I_DONE, I_FAILED, I_ITER, I_BAD, I_FLAT = range(6)
NI = 6
# ms (NM, G) bool: running; took the trial's gradient; the trial is the safe
# point; the row took its safe point (failed search); active; active and its
# step kept (finite); stale (no stored value to reuse).
M_RUNNING, M_TOOK, M_SAFE_NEW, M_SAFE_TAKE, M_ACTIVE, M_OK, M_STALE = range(7)
NM = 7
# flags (NFLAGS,) bool: some row active, running, stale.
FLAG_ACTIVE, FLAG_RUNNING, FLAG_STALE = range(3)
NFLAGS = 3

F = np.float32
# optax.scale_by_zoom_linesearch's defaults as float32 (the plain loops'
# constants); a Python float of each is exact.
SLOPE_RTOL = float(F(1e-4))
CURV_RTOL = float(F(0.9))
APPROX_DEC_RTOL = float(F(1e-6))
INTERVAL_THRESHOLD = float(F(1e-5))
TWO_SLOPE_RTOL_M1 = float(F(2 * 1e-4 - 1.0))
TINY = float(F(1e-12))


@dataclasses.dataclass
class LoopState:
    fs: torch.Tensor     # (NF, G) float32
    is_: torch.Tensor    # (NI, G) int32
    ms: torch.Tensor     # (NM, G) bool
    flags: torch.Tensor  # (NFLAGS,) bool

    @property
    def rows(self) -> int:
        return self.fs.shape[1]


def new_state(rows: int, device, max_iter: int) -> LoopState:
    """The state before iteration 0: no stored value (stale), ``i`` 0, every
    row active (``max_iter`` >= 1) and about to try step 1."""
    fs = torch.zeros((NF, rows), dtype=torch.float32)
    fs[F_LS_VALUE] = np.inf
    fs[F_PREV] = np.inf
    fs[F_TRIAL] = 1.0
    ms = torch.zeros((NM, rows), dtype=torch.bool)
    on = max_iter >= 1
    ms[M_ACTIVE] = ms[M_RUNNING] = ms[M_STALE] = on
    flags = torch.tensor([on] * NFLAGS, dtype=torch.bool)
    return LoopState(fs.to(device), torch.zeros((NI, rows), dtype=torch.int32, device=device), ms.to(device),
                     flags.to(device))


def _np_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """np.maximum: NaN if either is, ``a`` where they are equal."""
    return torch.where((a >= b) | torch.isnan(a), a, b)


def _np_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where((a <= b) | torch.isnan(a), a, b)


def _decrease_error(step, vs, ss, vi, si):
    dec = (vs - vi) - (SLOPE_RTOL * step) * si
    approx = _np_max(ss - TWO_SLOPE_RTOL_M1 * si, (vs - vi) - APPROX_DEC_RTOL * vi.abs())
    dec = _np_min(approx, dec)
    return torch.where(torch.isnan(dec), torch.full_like(dec, np.inf), _np_max(dec, torch.zeros_like(dec)))


def _curvature_error(ss, si):
    curv = ss.abs() - CURV_RTOL * si.abs()
    return torch.where(torch.isnan(curv), torch.full_like(curv, np.inf), _np_max(curv, torch.zeros_like(curv)))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    db, dc = b - a, c - a
    dbdc = db * dc
    denom = (dbdc * dbdc) * (db - dc)
    r0 = (fb - fa) - fpa * db
    r1 = (fc - fa) - fpa * dc
    A = ((dc * dc) * r0 + (-(db * db)) * r1) / denom
    B = ((-(dc * (dc * dc))) * r0 + (db * (db * db)) * r1) / denom
    radical = B * B - (3.0 * A) * fpa
    # torch's float32 sqrt on the CPU can miss the nearest float by an ulp;
    # a float64 root rounded once to float32 is IEEE's float32 sqrt.
    return a + (-B + torch.sqrt(radical.double()).float()) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    return a - fpa / (2.0 * (((fb - fa) - fpa * db) / (db * db)))


def zoom_trial_reference(st: LoopState, value: torch.Tensor, slope: torch.Tensor,
                         slope_init: torch.Tensor | None, count: int, max_steps: int) -> None:
    """Plain version of :func:`zoom_trial`, in place."""
    fs, is_, ms = st.fs, st.is_, st.ms
    value, slope = value.reshape(-1), slope.reshape(-1)
    if count == 0:  # a new search from the iteration's value and slope
        vi, si = fs[F_LS_VALUE].clone(), slope_init.reshape(-1)
        for k, x in ((F_VALUE_INIT, vi), (F_SLOPE_INIT, si), (F_VALUE, vi), (F_SLOPE, si), (F_VALUE_LOW, vi),
                     (F_SLOPE_LOW, si), (F_VALUE_HIGH, vi), (F_SLOPE_HIGH, si), (F_VALUE_CUBIC_REF, vi),
                     (F_SAFE_VALUE, vi)):
            fs[k] = x
        for k in (F_STEP, F_LOW, F_HIGH, F_CUBIC_REF, F_SAFE_STEP):
            fs[k] = 0.0
        fs[F_DEC] = fs[F_CURV] = np.inf
        is_[I_INTERVAL] = is_[I_DONE] = is_[I_FAILED] = 0
    f = {k: fs[k].clone() for k in range(NF)}
    running = ms[M_RUNNING].clone()
    interval = is_[I_INTERVAL].bool()
    t, vi, si = f[F_TRIAL], f[F_VALUE_INIT], f[F_SLOPE_INIT]
    dec = _decrease_error(t, value, slope, vi, si)
    curv = _curvature_error(slope, si)
    done = _np_max(dec, curv) <= 0.0
    last = count + 1 >= max_steps
    search, zoom = running & ~interval, running & interval
    where = torch.where

    # The search step (Algorithm 3.5).
    s_safe = dec <= 0.0
    set_high = (dec > 0.0) | ((value >= f[F_VALUE]) & (count > 0))
    set_low = (slope >= 0.0) & ~set_high
    s = {F_LOW: where(set_low, t, f[F_STEP]), F_VALUE_LOW: where(set_low, value, f[F_VALUE]),
         F_SLOPE_LOW: where(set_low, slope, f[F_SLOPE]), F_HIGH: where(set_low, f[F_STEP], t),
         F_VALUE_HIGH: where(set_low, f[F_VALUE], value), F_SLOPE_HIGH: where(set_low, f[F_SLOPE], slope),
         F_SAFE_STEP: where(s_safe, t, f[F_SAFE_STEP]), F_SAFE_VALUE: where(s_safe, value, f[F_SAFE_VALUE])}
    s[F_CUBIC_REF], s[F_VALUE_CUBIC_REF] = s[F_LOW], s[F_VALUE_LOW]
    s_interval = set_high | set_low | done
    s_failed = last & ~done

    # The zoom step (Algorithm 3.6) at the interpolated point t.
    low, value_low, slope_low = f[F_LOW], f[F_VALUE_LOW], f[F_SLOPE_LOW]
    high, value_high, slope_high = f[F_HIGH], f[F_VALUE_HIGH], f[F_SLOPE_HIGH]
    too_small = (high - low).abs() <= INTERVAL_THRESHOLD
    z_safe = (dec <= 0.0) & (value < f[F_SAFE_VALUE])
    to_middle = (dec > 0.0) | (value >= value_low)
    to_low = (slope * (high - low) >= 0.0) & ~to_middle
    moved = to_middle | to_low
    z = {F_SAFE_STEP: where(z_safe, t, f[F_SAFE_STEP]), F_SAFE_VALUE: where(z_safe, value, f[F_SAFE_VALUE]),
         F_LOW: where(to_middle, low, t), F_VALUE_LOW: where(to_middle, value_low, value),
         F_SLOPE_LOW: where(to_middle, slope_low, slope),
         F_HIGH: where(to_middle, t, where(to_low, low, high)),
         F_VALUE_HIGH: where(to_middle, value, where(to_low, value_low, value_high)),
         F_SLOPE_HIGH: where(to_middle, slope, where(to_low, slope_low, slope_high)),
         F_CUBIC_REF: where(moved, high, low), F_VALUE_CUBIC_REF: where(moved, value_high, value_low)}
    z_failed = (last | (too_small & (z[F_SAFE_STEP] > 0.0))) & ~done

    for k in s:
        fs[k] = where(search, s[k], where(zoom, z[k], f[k]))
    for k, x in ((F_STEP, t), (F_VALUE, value), (F_SLOPE, slope), (F_DEC, dec), (F_CURV, curv)):
        fs[k] = where(running, x, f[k])
    failed = where(search, s_failed, where(zoom, z_failed, is_[I_FAILED].bool()))
    is_[I_INTERVAL] = where(search, s_interval, interval).int()
    is_[I_DONE] = where(running, done, is_[I_DONE].bool()).int()
    is_[I_FAILED] = failed.int()
    # A failed search takes the safe step: the best point with sufficient decrease.
    safe_take = running & failed & ((fs[F_SAFE_STEP] > 0.0) | torch.isinf(fs[F_DEC]))
    fs[F_STEP] = where(safe_take, fs[F_SAFE_STEP], fs[F_STEP])
    fs[F_VALUE] = where(safe_take, fs[F_SAFE_VALUE], fs[F_VALUE])
    still = running & ~(done | failed)
    fs[F_TRIAL] = where(still, where(is_[I_INTERVAL].bool(), _zoom_middle(fs), 2.0 * fs[F_STEP]),
                        torch.zeros_like(t))
    ms[M_RUNNING] = still
    ms[M_TOOK] = running
    ms[M_SAFE_NEW] = (search & s_safe) | (zoom & z_safe)
    ms[M_SAFE_TAKE] = safe_take
    st.flags[FLAG_RUNNING] = still.any()


def _zoom_middle(fs: torch.Tensor) -> torch.Tensor:
    """The next trial of a zooming row: the cubic, else the quadratic
    interpolant's minimizer inside the interval's safe part, else the
    bisection."""
    low, high = fs[F_LOW], fs[F_HIGH]
    delta = (high - low).abs()
    left, right = _np_min(high, low), _np_max(high, low)
    mc = _cubicmin(low, fs[F_VALUE_LOW], fs[F_SLOPE_LOW], high, fs[F_VALUE_HIGH], fs[F_CUBIC_REF],
                   fs[F_VALUE_CUBIC_REF])
    cubic_chk, quad_chk = float(F(0.2)) * delta, float(F(0.1)) * delta
    use_cubic = (mc > left + cubic_chk) & (mc < right - cubic_chk)
    mq = _quadmin(low, fs[F_VALUE_LOW], fs[F_SLOPE_LOW], high, fs[F_VALUE_HIGH])
    use_quad = ~use_cubic & (mq > left + quad_chk) & (mq < right - quad_chk)
    return torch.where(use_cubic, mc, torch.where(use_quad, mq, (low + high) / 2.0))


def lbfgs_stop_reference(st: LoopState, finite: torch.Tensor, gnorm: torch.Tensor, max_iter: int,
                         tol: float) -> None:
    """Plain version of :func:`lbfgs_stop`, in place."""
    fs, is_, ms = st.fs, st.is_, st.ms
    finite, gnorm = finite.reshape(-1), gnorm.reshape(-1)
    tol32 = float(F(tol))
    active = ms[M_ACTIVE].clone()
    value = fs[F_VALUE_INIT]
    ok = torch.isfinite(value) & finite
    fs[F_LS_VALUE] = torch.where(active, fs[F_VALUE], fs[F_LS_VALUE])
    plateau = (fs[F_PREV] - value).abs() <= tol32 * _np_max(value.abs(), torch.full_like(value, TINY))
    is_[I_FLAT] = torch.where(active, torch.where(plateau, is_[I_FLAT] + 1, 0), is_[I_FLAT])
    fs[F_PREV] = torch.where(active, value, fs[F_PREV])
    is_[I_ITER] = torch.where(active, is_[I_ITER] + 1, is_[I_ITER])
    is_[I_BAD] = torch.where(active, ~ok, is_[I_BAD].bool()).int()
    ms[M_OK] = active & ok
    i = is_[I_ITER]
    now = (is_[I_BAD] == 0) & (i < max_iter) & ((i < 2) | ((is_[I_FLAT] < 3) & (gnorm > tol32)))
    stale = now & ~torch.isfinite(fs[F_LS_VALUE])
    ms[M_ACTIVE] = ms[M_RUNNING] = now
    ms[M_STALE] = stale
    fs[F_TRIAL] = now.float()
    st.flags[FLAG_ACTIVE] = st.flags[FLAG_RUNNING] = now.any()
    st.flags[FLAG_STALE] = stale.any()


def load(device) -> None:
    """Load the state kernels on a card (CUDA loads a kernel at its first
    launch), so that a CUDA graph capture may launch them first. Nothing on
    the CPU."""
    if torch.device(device).type == "cpu":
        return
    from albedo_tpu_torch.kernels.build import library

    with torch.cuda.device(device):
        rc = library("lbfgs_state").lbfgs_state_load()
    if rc != 0:
        raise RuntimeError(f"lbfgs_state: loading the kernels failed: cudaError {rc}")


def _check_state(kernel: str, st: LoopState, dev) -> None:
    g = st.rows
    check_operand(kernel, "fs", st.fs, torch.float32, (NF, g), dev)
    check_operand(kernel, "is", st.is_, torch.int32, (NI, g), dev)
    check_operand(kernel, "ms", st.ms, torch.bool, (NM, g), dev)
    check_operand(kernel, "flags", st.flags, torch.bool, (NFLAGS,), dev)


def zoom_trial(st: LoopState, value: torch.Tensor, slope: torch.Tensor, slope_init: torch.Tensor | None,
               count: int, max_steps: int) -> None:
    """One zoom line-search trial of every running row (CUDA kernel
    ``lbfgs_state``): ``value`` and ``slope`` (G values, or a 0-d tensor
    for one row) are the objective and its slope along the search
    direction at the row's trial step ``fs[F_TRIAL]``; ``count`` is the
    trial's index in the search (0 starts a new search of every row from
    its stored value ``fs[F_LS_VALUE]`` and slope ``slope_init``). Updates
    the state in place: the next trial steps, ``running``, the gradient
    masks (``took``, ``safe_new``, ``safe_take``) and the "some row runs"
    flag. No host sync."""
    inputs = (value, slope) if slope_init is None else (value, slope, slope_init)
    if on_cpu("lbfgs_state", st.fs, *inputs):
        zoom_trial_reference(st, value, slope, slope_init, count, max_steps)
        return
    dev, g = st.fs.device, st.rows
    _check_state("lbfgs_state", st, dev)
    for name, t in (("value", value), ("slope", slope)) + ((("slope_init", slope_init),) if count == 0 else ()):
        if t is None or t.numel() != g:
            raise ValueError(f"lbfgs_state: {name} needs {g} values")
        check_operand("lbfgs_state", name, t, torch.float32, tuple(t.shape), dev)
    call("lbfgs_state", dev, st.fs.data_ptr(), st.is_.data_ptr(), st.ms.data_ptr(), st.flags.data_ptr(), g,
         value.data_ptr(), slope.data_ptr(), None if slope_init is None else slope_init.data_ptr(), count,
         max_steps)


def lbfgs_stop(st: LoopState, finite: torch.Tensor, gnorm: torch.Tensor, max_iter: int, tol: float) -> None:
    """The loop's bookkeeping after a step of the active rows and the stop
    test of the next (CUDA kernel ``lbfgs_stop``): ``finite`` (G bools) says
    each row's new iterate is finite, ``gnorm`` (G values) each row's stored
    gradient norm. Updates ``ok``, ``i``, ``bad``, ``flat``, ``prev``, the
    stored value, ``active``/``running``/``stale`` and the flags in place.
    No host sync."""
    if on_cpu("lbfgs_stop", st.fs, finite, gnorm):
        lbfgs_stop_reference(st, finite, gnorm, max_iter, tol)
        return
    dev, g = st.fs.device, st.rows
    _check_state("lbfgs_stop", st, dev)
    if finite.numel() != g or gnorm.numel() != g:
        raise ValueError(f"lbfgs_stop: finite and gnorm need {g} values")
    check_operand("lbfgs_stop", "finite", finite, torch.bool, tuple(finite.shape), dev)
    check_operand("lbfgs_stop", "gnorm", gnorm, torch.float32, tuple(gnorm.shape), dev)
    call("lbfgs_stop", dev, st.fs.data_ptr(), st.is_.data_ptr(), st.ms.data_ptr(), st.flags.data_ptr(), g,
         finite.data_ptr(), gnorm.data_ptr(), int(max_iter), float(F(tol)))


# ---------------------------------------------------------------- direction


@dataclasses.dataclass
class Memory:
    """The L-BFGS memory of ``m`` slots for a (P,) vector or, row by row, a
    (G, P) matrix: the secant pairs, their ``rho``, and the previous point
    and gradient (optax's ``scale_by_lbfgs`` state)."""
    dw: torch.Tensor           # (m, P) or (m, G, P)
    du: torch.Tensor           # the same
    rho: torch.Tensor          # (m,) or (m, G)
    params: torch.Tensor       # (P,) or (G, P)
    grad: torch.Tensor         # the same

    @property
    def slots(self) -> int:
        return self.dw.shape[0]


def new_memory(theta: torch.Tensor, slots: int) -> Memory:
    """An empty memory for ``theta``'s shape, on its device."""
    z = torch.zeros_like(theta)
    return Memory(theta.new_zeros((slots, *theta.shape)), theta.new_zeros((slots, *theta.shape)),
                  theta.new_zeros((slots, *theta.shape[:-1])), z, z.clone())


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.dot`` of two (P,) vectors, or the (G,) dots of two (G, P)
    matrices' rows (the loops' dots, in torch's order)."""
    return torch.dot(a, b) if a.dim() == 1 else torch.sum(a * b, dim=1)


def lbfgs_direction_reference(grad: torch.Tensor, params: torch.Tensor, mem: Memory,
                              count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`lbfgs_direction` at iteration ``count``: the
    plain loops' two-loop recursion in torch ops. Returns ``(updates,
    slope)``."""
    m = mem.slots
    memory_idx = count % m
    prev_idx = (count - 1) % m
    if count > 0:
        dw = params - mem.params
        du = grad - mem.grad
        vdot = dot(du, dw)
        mem.dw[prev_idx] = dw
        mem.du[prev_idx] = du
        mem.rho[prev_idx] = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
        denom = dot(du, du)
        scale = torch.where(denom > 0.0, vdot / denom, torch.ones_like(vdot))
    else:
        # First step: the capped reciprocal of the gradient norm (the zero
        # secant pair optax stores here is a no-op and is skipped).
        scale = torch.clamp_max(1.0 / torch.linalg.vector_norm(grad, dim=-1), 1.0)
    # Two-loop recursion, oldest slot to newest starting at memory_idx;
    # unwritten slots have rho 0 and change nothing, as in optax.
    order = [(memory_idx + j) % m for j in range(m)]
    vec = grad
    alphas = {}
    for i in reversed(order):
        alpha = mem.rho[i] * dot(mem.dw[i], vec)
        vec = vec - alpha[..., None] * mem.du[i]
        alphas[i] = alpha
    vec = scale[..., None] * vec
    for i in order:
        beta = mem.rho[i] * dot(mem.du[i], vec)
        vec = vec + (alphas[i] - beta)[..., None] * mem.dw[i]
    mem.params.copy_(params)  # in place: a captured step reads them where the next one wrote them
    mem.grad.copy_(grad)
    updates = -vec
    return updates, dot(updates, grad)


def lbfgs_direction(grad: torch.Tensor, params: torch.Tensor, mem: Memory, iters: torch.Tensor,
                    out: tuple[torch.Tensor, torch.Tensor] | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The L-BFGS descent direction ``-P_k g_k`` of a (P,) gradient at
    ``params`` (or of each row of (G, P) ones) and its slope ``<updates,
    grad>`` (0-d, or (G,)), updating ``mem`` in place (CUDA kernel
    ``lbfgs_direction``, one launch). The iteration count is the largest of
    the int32 device tensor ``iters`` (the loop state's ``i`` of every row,
    or a one-element count the host loops fill), so a captured call serves
    every iteration. ``out``: the (updates, slope) tensors to write, else
    new ones."""
    if on_cpu("lbfgs_direction", grad, params, mem.dw, iters):
        updates, slope = lbfgs_direction_reference(grad, params, mem, int(iters.max()))
        if out is None:
            return updates, slope
        out[0].copy_(updates)
        out[1].copy_(slope.reshape(out[1].shape))
        return out
    dev = grad.device
    g = 1 if grad.dim() == 1 else grad.shape[0]
    p, m = grad.shape[-1], mem.slots
    shape = tuple(grad.shape)
    for name, t, want in (("grad", grad, shape), ("params", params, shape), ("dw", mem.dw, (m, *shape)),
                          ("du", mem.du, (m, *shape)), ("rho", mem.rho, (m, *shape[:-1])),
                          ("prev_params", mem.params, shape), ("prev_grad", mem.grad, shape)):
        check_operand("lbfgs_direction", name, t, torch.float32, want, dev)
    check_operand("lbfgs_direction", "iters", iters, torch.int32, (iters.numel(),), dev)
    if iters.numel() < 1 or m > DIRECTION_MAX_SLOTS:
        raise ValueError(f"lbfgs_direction: needs an iteration count and at most {DIRECTION_MAX_SLOTS} slots")
    if out is None:
        out = (torch.empty_like(grad), torch.empty(shape[:-1], dtype=torch.float32, device=dev))
    check_operand("lbfgs_direction", "updates", out[0], torch.float32, shape, dev)
    check_operand("lbfgs_direction", "slope", out[1], torch.float32, tuple(out[1].shape), dev)
    if out[1].numel() != g:
        raise ValueError(f"lbfgs_direction: slope needs {g} values")
    scratch = torch.empty((g, p), dtype=torch.float32, device=dev) if p > DIRECTION_SMEM_FLOATS else None
    call("lbfgs_direction", dev, grad.data_ptr(), params.data_ptr(), mem.dw.data_ptr(), mem.du.data_ptr(),
         mem.rho.data_ptr(), mem.params.data_ptr(), mem.grad.data_ptr(), iters.data_ptr(), iters.numel(), g, p, m,
         out[0].data_ptr(), out[1].data_ptr(), None if scratch is None else scratch.data_ptr())
    return out


# lbfgs_direction.cu's limits: vec in shared memory up to this many floats a
# row (above, a global scratch row), and at most this many memory slots.
DIRECTION_SMEM_FLOATS = 49152
DIRECTION_MAX_SLOTS = 64
