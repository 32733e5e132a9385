"""Training divergence watchdog: device health stats and the guarded fit.

Port of ``albedo_tpu/utils/watchdog.py`` for the non-checkpointed ALS fit:
:func:`factor_health` (K12, plain torch reductions on the factors' device),
:func:`health_dict`, the host-side :class:`DivergenceWatchdog` check, and
:func:`guarded_fit` (check the final factors; re-fit once with damped
regularization; raise :class:`TrainingDiverged` if still sick), and
:func:`check_lr_loss` for the ranker's LR fit. The JAX module's
fault-injection site and trip counters are not ported yet.

Tripwire kinds: ``nonfinite`` (any NaN/inf factor), ``norm`` (factor RMS
above an absolute ceiling), ``trajectory`` (RMS grew by more than
``max_growth`` x since the last healthy check).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

log = logging.getLogger(__name__)


def factor_health(user_f: torch.Tensor, item_f: torch.Tensor) -> torch.Tensor:
    """Health vector ``[nonfinite_count, max_abs, rms]`` over both factor
    tables (float32, shape (3,), on their device). Reading it to the host is
    the caller's synchronization point."""

    def stats(x: torch.Tensor):
        finite = torch.isfinite(x)
        safe = torch.where(finite, x, torch.zeros_like(x))
        return (
            (x.numel() - finite.sum()).to(torch.float32),
            safe.abs().max(),
            torch.sqrt(torch.mean(safe * safe)),
        )

    un, ua, ur = stats(user_f)
    vn, va, vr = stats(item_f)
    return torch.stack([un + vn, torch.maximum(ua, va), torch.maximum(ur, vr)])


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
    """A remediation estimator: regularization damped UP by ``10x`` (and
    float32 gathers, the only kind this port has)."""
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
    """True when an LR training loss is healthy; a non-finite loss is a
    ``kind="lr"`` trip (the caller re-runs damped, then raises)."""
    if np.isfinite(loss):
        return True
    log.warning("divergence watchdog tripped: non-finite LR loss %r", loss)
    return False
