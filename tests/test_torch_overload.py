"""The port's overload controller against the JAX package's, step by step.

Both controllers (``serving/overload.py``: AIMD admission limit, CoDel shed,
brownout ladder) get the same sequence of observations on their own fake
clocks; after every step the admission decision, the CoDel decision, the
limit, the ladder level and the per-tier shed counts must be equal. The
controllers are host code with no floating-point reduction, so they agree
exactly.
"""

import numpy as np
import pytest

from albedo_tpu.serving.metrics import MetricsRegistry as JaxMetrics
from albedo_tpu.serving.overload import OverloadConfig as JaxConfig
from albedo_tpu.serving.overload import OverloadController as JaxController
from albedo_tpu_torch.serving.metrics import MetricsRegistry
from albedo_tpu_torch.serving.overload import TIERS, OverloadConfig, OverloadController


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _calm(rng):
    return [("batch", 0.01, 0.0, 0.05) for _ in range(30)] + [("admit", 10, 0.01)] * 10


def _surge(rng):
    ops = []
    for _ in range(40):
        ops += [("batch", 0.6, 0.4, 0.2), ("admit", int(rng.integers(0, 300)), 0.05)]
    return ops


def _surge_then_recover(rng):
    return _surge(rng) + [("idle", 0.4)] * 60 + [("admit", 1, 0.0), ("batch", 0.01, 0.0, 0.1)]


def _codel(rng):
    ops = [("codel", 0.2, 0.1) for _ in range(30)]      # standing delay over target
    ops += [("codel", 0.01, 0.1)] * 3                   # drained: state resets
    ops += [("codel", 0.3, 0.05) for _ in range(40)]
    return ops


def _mixed(rng):
    ops = []
    for _ in range(300):
        kind = rng.integers(0, 4)
        if kind == 0:
            ops.append(("batch", float(rng.uniform(0.0, 0.5)), float(rng.uniform(0.0, 0.5)),
                        float(rng.uniform(0.0, 0.3))))
        elif kind == 1:
            ops.append(("admit", int(rng.integers(0, 300)), float(rng.uniform(0.0, 0.1))))
        elif kind == 2:
            ops.append(("codel", float(rng.uniform(0.0, 0.2)), float(rng.uniform(0.0, 0.3))))
        else:
            ops.append(("idle", float(rng.uniform(0.0, 1.0))))
    return ops


CONFIGS = {
    "default": {},
    "hair_trigger": dict(slo_s=0.05, min_limit=1, max_limit=8, engage_after=2, dwell_s=0.05,
                         recovery_window_s=0.3, codel_target_s=0.02, codel_interval_s=0.2),
}


def _run(ctrl_cls, cfg_cls, metrics_cls, config: dict, ops) -> list:
    clock = FakeClock()
    metrics = metrics_cls()
    ctrl = ctrl_cls(cfg_cls(**config), metrics=metrics, clock=clock)
    trace = []
    for op in ops:
        if op[0] == "batch":
            _, batch_s, head, dt = op
            ctrl.observe_batch(batch_s, head)
            out = None
        elif op[0] == "admit":
            _, outstanding, dt = op
            out = ctrl.admit(outstanding)
        elif op[0] == "codel":
            _, sojourn, dt = op
            out = ctrl.codel_shed(sojourn)
        else:
            _, dt = op
            ctrl.idle_tick()
            out = None
        clock.t += dt
        shed = {t: metrics.overload_shed.value(tier=t) for t in TIERS}
        trace.append((out, ctrl.limit.limit, ctrl.brownout_level, shed,
                      ctrl.price_retry_after(0.1, 5), ctrl.snapshot()))
    return trace


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("sequence", [_calm, _surge, _surge_then_recover, _codel, _mixed],
                         ids=lambda f: f.__name__.strip("_"))
def test_decisions_equal_jax(config, sequence):
    ops = sequence(np.random.default_rng(7))
    want = _run(JaxController, JaxConfig, JaxMetrics, CONFIGS[config], ops)
    got = _run(OverloadController, OverloadConfig, MetricsRegistry, CONFIGS[config], ops)
    assert got == want
    levels = {step[2] for step in got}
    if sequence in (_surge, _surge_then_recover):
        assert max(levels) > 0  # the sequence does drive the ladder


def test_unstressed_controller_is_the_static_queue():
    """The default controller starts at max_limit (the queue bound) at the
    full tier, so an unstressed service admits exactly as the static bounded
    queue does."""
    ctrl = OverloadController(OverloadConfig(max_limit=256))
    assert ctrl.limit.limit == 256 and ctrl.brownout_level == 0
    assert ctrl.admit(255) and not ctrl.admit(256)
