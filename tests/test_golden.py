"""Golden-trajectory regression tests against pinned f64 baselines."""
import os

import numpy as np
import jax.numpy as jnp
import pytest

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.sim.closedloop import run_preset
from mpc_blaster_tpu.sim.tasks import run_figure8

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load(name):
    path = os.path.join(GOLDEN, name)
    if not os.path.exists(path):
        pytest.skip(f"golden file missing: run scripts/gen_golden.py")
    return np.load(path)


def test_simulation_poc_golden_f64_exact():
    g = _load("simulation_poc_100.npz")
    res = run_preset(cfg.simulation_preset(), n_steps=100,
                     dtype=jnp.float64, with_poc=True)
    # identical code + f64 => tight reproduction (catches any behavior drift)
    np.testing.assert_allclose(np.asarray(res.us), g["us"], atol=1e-8)
    np.testing.assert_allclose(np.asarray(res.xs), g["xs"], atol=1e-8)


def test_flight_golden_f64_exact():
    g = _load("flight_100.npz")
    res = run_preset(cfg.flight_preset(), n_steps=100, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(res.us), g["us"], atol=1e-8)


def test_figure8_golden_f32_tolerance():
    """f32 (device dtype) stays within control-grade tolerance of f64 truth."""
    g = _load("figure8_120.npz")
    res = run_figure8(n_steps=120, dtype=jnp.float32)
    xs32 = np.asarray(res.xs)
    # trajectory-level agreement (position within cm of f64 golden)
    assert np.abs(xs32[:, 0:3] - g["xs"][:, 0:3]).max() < 5e-2
