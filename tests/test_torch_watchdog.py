"""The port's divergence watchdog against the JAX package's, on the CPU.

K12's plain version (``factor_health_reference``) against JAX's
``factor_health`` on the same numpy tables: the non-finite count and the
max |x| exactly, the rms to 1e-6 relative (JAX takes the mean of squares in
float32, the port sums them in float64, as the kernel does), on finite
tables and with NaN and +-inf planted. Then the trip counter
(``albedo_watchdog_trips_total{kind=}``) and the ``train.watchdog`` fault
site, against JAX's on the same fit.
"""

import numpy as np
import pytest
import torch

import albedo_tpu.utils.watchdog as j_wd
from albedo_tpu.datasets import synthetic_tables as j_tables
from albedo_tpu.models.als import ImplicitALS as JALS
from albedo_tpu.utils import events as j_events
from albedo_tpu.utils import faults as j_faults
from albedo_tpu_torch.datasets import synthetic_tables as t_tables
from albedo_tpu_torch.models.als import ImplicitALS as TALS
from albedo_tpu_torch.utils import events as t_events
from albedo_tpu_torch.utils import faults as t_faults
from albedo_tpu_torch.utils import watchdog as t_wd

RMS_REL = 1e-6


@pytest.fixture(autouse=True)
def _reset_port_faults():
    t_faults.reset()
    t_events.reset_global_metrics()
    yield
    t_faults.reset()
    t_events.reset_global_metrics()


@pytest.mark.parametrize("plant", [None, "nan", "inf", "-inf", "mixed"])
def test_factor_health_plain_matches_jax(plant):
    rng = np.random.default_rng(3)
    uf = rng.standard_normal((300, 12)).astype(np.float32)
    vf = (rng.standard_normal((170, 12)) * 2).astype(np.float32)
    if plant is not None:
        values = {"nan": [np.nan], "inf": [np.inf], "-inf": [-np.inf], "mixed": [np.nan, np.inf, -np.inf]}[plant]
        for table, count in ((uf, 7), (vf, 3)):
            flat = table.reshape(-1)
            flat[rng.choice(flat.size, size=count, replace=False)] = rng.choice(values, size=count)
    want = np.asarray(j_wd.factor_health(uf, vf), np.float64)
    got = t_wd.factor_health(torch.as_tensor(uf), torch.as_tensor(vf)).numpy().astype(np.float64)
    assert got.dtype == np.float64 and got.shape == (3,)
    np.testing.assert_array_equal(got[:2], want[:2])
    assert abs(got[2] - want[2]) <= RMS_REL * want[2]
    assert t_wd.health_dict(torch.as_tensor(got.astype(np.float32))) == {
        "nonfinite": int(want[0]), "max_abs": float(np.float32(want[1])), "rms": float(np.float32(got[2]))}


def test_trip_counters_match_jax():
    for wd_mod, events in ((j_wd, j_events), (t_wd, t_events)):
        wd = wd_mod.DivergenceWatchdog(max_rms=10.0, max_growth=5.0)
        ok = np.ones((4, 3), np.float32)
        assert wd.check(0, ok, ok) == []
        bad = ok.copy()
        bad[0, 0] = np.nan
        assert wd.check(1, bad * 100.0, ok) == ["nonfinite", "norm", "trajectory"]
        assert not wd_mod.check_lr_loss(float("inf"))
        for kind in ("nonfinite", "norm", "trajectory", "lr"):
            assert events.watchdog_trips.value(kind=kind) == 1, (wd_mod.__name__, kind)


@pytest.mark.parametrize("gather_dtype", [None, "bfloat16"])
def test_watchdog_fault_drill_remediates_as_jax(gather_dtype, monkeypatch):
    """``train.watchdog:error@1`` writes a NaN into the checked factors: the
    fit trips ``nonfinite``, re-fits damped once, and checks healthy. The
    damped re-fit runs with float32 gathers and 10x the regularization, as
    JAX's."""
    j_faults.arm("train.watchdog", kind="error", at=1)
    t_faults.arm("train.watchdog", kind="error", at=1)
    j_matrix = j_tables(n_users=60, n_items=40, mean_stars=5, seed=2).star_matrix(policy="off")
    t_matrix = t_tables(n_users=60, n_items=40, mean_stars=5, seed=2).star_matrix(policy="off")
    fits = []
    fit = TALS.fit

    def recording_fit(self, matrix, *a, **k):
        fits.append((self.gather_dtype, self.reg_param))
        return fit(self, matrix, *a, **k)

    monkeypatch.setattr(TALS, "fit", recording_fit)
    _, j_trips = j_wd.guarded_fit(JALS(rank=4, max_iter=2, seed=0, gather_dtype=gather_dtype), j_matrix)
    _, t_trips = t_wd.guarded_fit(TALS(rank=4, max_iter=2, seed=0, device="cpu", gather_dtype=gather_dtype),
                                  t_matrix)
    assert fits == [(gather_dtype, 0.5), (None, 5.0)]
    assert j_wd.damped(JALS(gather_dtype=gather_dtype)).gather_dtype is None
    assert [(t["kinds"], t["remediated"]) for t in t_trips] == [(t["kinds"], t["remediated"]) for t in j_trips] \
        == [(["nonfinite"], True)]
    assert t_events.watchdog_trips.value(kind="nonfinite") == 1 == j_events.watchdog_trips.value(kind="nonfinite")
    assert t_faults.FAULTS.fired("train.watchdog") == 1
