"""Training divergence watchdog: device health stats and the guarded fit.

Port of ``albedo_tpu/utils/watchdog.py`` for the non-checkpointed ALS fit:
:func:`factor_health` (K12, the CUDA kernel ``factor_health``: one pass over
both factor tables; :func:`factor_health_reference` is its plain version),
:func:`health_dict`, the host-side :class:`DivergenceWatchdog` check, and
:func:`guarded_fit` (check the final factors; re-fit once with damped
regularization; raise :class:`TrainingDiverged` if still sick), and
:func:`check_lr_loss` for the ranker's LR fit. Every trip counts in the
process-global ``albedo_watchdog_trips_total{kind=}``, and the
``train.watchdog`` fault site fires inside every check: an armed ``error``
writes a NaN into the checked factors, so a drill runs the real detect and
remediate path.

Tripwire kinds: ``nonfinite`` (any NaN/inf factor), ``norm`` (factor RMS
above an absolute ceiling), ``trajectory`` (RMS grew by more than
``max_growth`` x since the last healthy check).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from albedo_tpu_torch.kernels.build import call, on_cpu
from albedo_tpu_torch.utils import events, faults
from albedo_tpu_torch.utils.faults import FaultInjected

log = logging.getLogger(__name__)

WATCHDOG_FAULT = faults.site("train.watchdog")
HEALTH_BLOCKS = 264  # K12's first-pass grid: two blocks per SM of an H100


def factor_health_reference(user_f: torch.Tensor, item_f: torch.Tensor) -> torch.Tensor:
    """Plain version of K12: per table, the non-finite count, the max |x|
    and the rms over the finite entries (non-finite read as 0), the squares
    summed in float64 as the kernel sums them; then ``[count_u + count_v,
    max(max_u, max_v), max(rms_u, rms_v)]`` (float32, shape (3,))."""

    def stats(x: torch.Tensor):
        finite = torch.isfinite(x)
        safe = torch.where(finite, x, torch.zeros_like(x)).double()
        return (
            float(x.numel() - finite.sum()),
            safe.abs().max() if x.numel() else torch.zeros((), dtype=torch.float64, device=x.device),
            torch.sqrt((safe * safe).sum() / x.numel()).float(),
        )

    un, ua, ur = stats(user_f)
    vn, va, vr = stats(item_f)
    count = torch.tensor(un + vn, dtype=torch.float32, device=user_f.device)
    return torch.stack([count, torch.maximum(ua, va).float(), torch.maximum(ur, vr)])


def factor_health(user_f: torch.Tensor, item_f: torch.Tensor) -> torch.Tensor:
    """K12: health vector ``[nonfinite_count, max_abs, rms]`` over both factor
    tables (float32, shape (3,), on their device; CUDA kernel
    ``factor_health``). Reading it to the host is the caller's
    synchronization point."""
    if on_cpu("factor_health", user_f, item_f):
        return factor_health_reference(user_f, item_f)
    dev = user_f.device
    for name, t in (("user_f", user_f), ("item_f", item_f)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"factor_health: {name} must be a contiguous float32 tensor")
    parts = torch.empty(HEALTH_BLOCKS * 6, dtype=torch.float64, device=dev)
    out = torch.empty(3, dtype=torch.float32, device=dev)
    call("factor_health", dev, user_f.data_ptr(), user_f.numel(), item_f.data_ptr(),
         item_f.numel(), parts.data_ptr(), HEALTH_BLOCKS, out.data_ptr())
    return out


def health_dict(health: torch.Tensor) -> dict:
    """Host-readable form of a :func:`factor_health` vector."""
    h = health.detach().cpu().numpy().astype(np.float64)
    return {
        "nonfinite": int(h[0]),
        "max_abs": float(h[1]),
        "rms": float(h[2]),
    }


class TrainingDiverged(RuntimeError):
    """A divergence tripwire survived remediation; the fit's factors are
    garbage and must not be published."""

    def __init__(self, step: int, kinds: list[str]):
        super().__init__(
            f"training diverged at step {step} ({'/'.join(kinds)}) and the "
            f"damped re-run did not recover; refusing to produce factors"
        )
        self.step = step
        self.kinds = kinds


def damped(als):
    """A remediation estimator: regularization damped UP by ``10x``, with
    float32 gathers (a bf16-gather fit re-runs in full precision)."""
    return dataclasses.replace(
        als, gather_dtype=None, reg_param=float(als.reg_param) * 10.0
    )


@dataclasses.dataclass
class DivergenceWatchdog:
    """Tripwire state across one fit's checks.

    ``check`` returns the tripped kinds (empty = healthy) and records every
    trip in ``trips``. The RMS baseline for the trajectory tripwire only
    advances on healthy checks.
    """

    max_rms: float = 1e4
    max_growth: float = 50.0
    trips: list[dict] = dataclasses.field(default_factory=list)
    _prev_rms: float | None = dataclasses.field(default=None, init=False)

    def check(self, step: int, user_f: np.ndarray, item_f: np.ndarray) -> list[str]:
        user_f = np.asarray(user_f)
        item_f = np.asarray(item_f)
        try:
            WATCHDOG_FAULT.hit()
        except FaultInjected:
            # A drill: the NaN appears as a real divergence would, and the
            # detection and remediation path runs from here.
            user_f = user_f.copy()
            user_f.flat[0] = np.nan
        kinds: list[str] = []
        finite_u = np.isfinite(user_f)
        finite_v = np.isfinite(item_f)
        nonfinite = int(user_f.size - finite_u.sum()) + int(item_f.size - finite_v.sum())
        if nonfinite:
            kinds.append("nonfinite")
        rms_u = float(np.sqrt(np.mean(np.square(np.where(finite_u, user_f, 0.0)))))
        rms_v = float(np.sqrt(np.mean(np.square(np.where(finite_v, item_f, 0.0)))))
        rms = max(rms_u, rms_v)
        if rms > self.max_rms:
            kinds.append("norm")
        if (
            self._prev_rms is not None
            and rms > self.max_growth * max(self._prev_rms, 1e-12)
        ):
            kinds.append("trajectory")
        if kinds:
            for kind in kinds:
                events.watchdog_trips.inc(kind=kind)
            self.trips.append({
                "step": int(step), "kinds": kinds,
                "nonfinite": nonfinite, "rms": rms, "remediated": False,
            })
            log.warning(
                "divergence watchdog tripped at step %d: %s (nonfinite=%d rms=%.3g)",
                step, kinds, nonfinite, rms,
            )
        else:
            self._prev_rms = rms
        return kinds

    def mark_remediated(self) -> None:
        """The damped re-run of the last tripped fit checked healthy."""
        if self.trips:
            self.trips[-1]["remediated"] = True


def guarded_fit(als, matrix, watchdog: DivergenceWatchdog | None = None):
    """Fit with the watchdog on the FINAL factors: check once, remediate once
    via a damped full re-fit, raise :class:`TrainingDiverged` if the re-fit
    is still sick. Returns ``(model, trips)``."""
    wd = watchdog or DivergenceWatchdog()
    model = als.fit(matrix)
    if wd.check(als.max_iter, model.user_factors, model.item_factors):
        log.warning("re-running diverged fit once with damped regularization")
        model = damped(als).fit(matrix)
        if wd.check(als.max_iter, model.user_factors, model.item_factors):
            raise TrainingDiverged(als.max_iter, wd.trips[-1]["kinds"])
        wd.mark_remediated()
    return model, wd.trips


def check_lr_loss(loss: float) -> bool:
    """True when an LR training loss is healthy; a non-finite loss counts a
    ``kind="lr"`` trip (the caller re-runs damped, then raises)."""
    if np.isfinite(loss):
        return True
    events.watchdog_trips.inc(kind="lr")
    log.warning("divergence watchdog tripped: non-finite LR loss %r", loss)
    return False
