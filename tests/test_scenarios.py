"""Disturbance-robustness sweep: wind + x0 + target draws."""
import numpy as np
import jax.numpy as jnp
import pytest

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.ocp.spec import build_spec
from mpc_blaster_tpu.sim.scenarios import disturbance_sweep, sample_scenarios

DTYPE = jnp.float64


@pytest.mark.slow
def test_sweep_settles_under_wind():
    preset = cfg.simulation_preset()
    spec = build_spec(preset.ocp, yref=preset.loop.yref, dtype=DTYPE)
    scen = sample_scenarios(batch=8, seed=1, wind_max=0.8)
    res = disturbance_sweep(spec, preset.ocp, scen, n_steps=150, dtype=DTYPE)
    finals = np.asarray(res.final_states)
    assert np.isfinite(finals).all()
    # the integral-free controller carries a steady-state wind offset; all
    # scenarios must still be near their targets and none diverge
    errs = np.asarray(res.pos_err)
    assert errs.max() < 0.6, errs
    assert errs.mean() < 0.3
    assert np.asarray(res.worst_kkt_eq).max() < 1e-3


@pytest.mark.slow
def test_offset_free_rejects_wind():
    """Offset-free MPC (constant-disturbance observer, beyond-reference):
    the same wind sweep that leaves the integral-free controller with
    ~0.2-0.4 m steady offsets settles EVERY scenario to mm level once the
    velocity-residual observer feeds the prediction model (measured:
    4/8 settled, 0.41 m max -> 8/8, 0.003 m max)."""
    preset = cfg.simulation_preset()
    spec = build_spec(preset.ocp, yref=preset.loop.yref, dtype=DTYPE)
    scen = sample_scenarios(batch=8, seed=1, wind_max=0.8)
    res = disturbance_sweep(spec, preset.ocp, scen, n_steps=150,
                            dtype=DTYPE, offset_free=True)
    errs = np.asarray(res.pos_err)
    assert bool(np.asarray(res.settled).all()), errs
    assert errs.max() < 0.02, errs


@pytest.mark.slow
def test_fault_injection_elastic_recovery():
    """Fault injection + elastic recovery (SURVEY.md §5): an unannounced
    30% single-rotor derating diverges under the blind controller (~5.6 m
    drift, measured) but recovers to mm-level hover once the six-channel
    (force+torque) disturbance observer feeds the prediction model —
    fault tolerance without fault identification."""
    from mpc_blaster_tpu.sim.scenarios import fault_sweep

    preset = cfg.simulation_preset()
    spec = build_spec(preset.ocp, yref=preset.loop.yref, dtype=DTYPE)
    derate = np.array([
        [1.0, 1.0, 1.0, 1.0],     # healthy
        [0.8, 0.8, 0.8, 0.8],     # symmetric 20% loss
        [0.7, 1.0, 1.0, 1.0],     # single rotor at 70%
        [0.85, 0.85, 1.0, 1.0],   # one arm weak
    ])
    blind = fault_sweep(spec, preset.ocp, derate, n_steps=150,
                        dtype=DTYPE, offset_free=False)
    rec = fault_sweep(spec, preset.ocp, derate, n_steps=150,
                      dtype=DTYPE, offset_free=True)
    blind_errs = np.asarray(blind.pos_err)
    rec_errs = np.asarray(rec.pos_err)
    # the single-rotor fault defeats the blind controller...
    assert blind_errs[2] > 1.0, blind_errs
    # ...and every fault recovers with the observer
    assert np.isfinite(np.asarray(rec.final_states)).all()
    assert rec_errs.max() < 0.02, rec_errs
    assert bool(np.asarray(rec.settled).all())


def test_scenarios_reproducible():
    a = sample_scenarios(batch=4, seed=7)
    b = sample_scenarios(batch=4, seed=7)
    np.testing.assert_array_equal(np.asarray(a.wind), np.asarray(b.wind))


@pytest.mark.slow
def test_offset_free_no_hunt_both_presets_n30():
    """r5 pin of the corrected r4 finding: the offset-free hunt was a
    SHORT-HORIZON artifact of the N=20-truncated sim config (a
    multi-factor closed-loop stability boundary — neither R_swivel nor a
    QP-only Hessian floor fixes it), NOT a gimbal
    flat-subspace property. Within the stable envelope (N >= 24 at
    dt = 1/30; the preset's native horizon is 60) wind compensation
    settles to centimeters on BOTH presets, R_swivel = 1e-5 included."""
    import dataclasses

    import jax

    from mpc_blaster_tpu.sim.scenarios import offset_free_loop

    wind = jnp.asarray([0.7, -0.5, 0.2], jnp.float32)
    for preset, n, tol in ((cfg.simulation_preset(), 30, 0.05),
                           (cfg.flight_preset(), 20, 0.05)):
        ocp = dataclasses.replace(
            preset.ocp, N=n, Tf=n / 30.0,
            solver=dataclasses.replace(preset.ocp.solver,
                                       qp_backend="riccati", ipm_iters=8))
        spec = build_spec(ocp, yref=preset.loop.yref, dtype=jnp.float32)
        x0 = jnp.zeros(cfg.NX, jnp.float32).at[2].set(3.0)
        res = jax.jit(lambda s, x, o=ocp: offset_free_loop(
            s, o, x, wind, n_steps=250))(spec, x0)
        xs = np.asarray(res.xs)
        assert np.isfinite(xs).all()
        err = np.linalg.norm(xs[-1, 0:3] - np.asarray(spec.yref_x[0, 0:3]))
        assert err < tol, (preset.name, err)
        np.testing.assert_allclose(np.asarray(res.d_hist[-1, 0:3]),
                                   np.asarray(wind), atol=0.05)


def test_offset_free_loop_smoke():
    """Fast sibling of the slow fused-vs-XLA offset-free parity test
    (tests/test_fused_tick.py): the B=1 observer loop on the XLA backend
    learns a constant wind and stays finite."""
    import dataclasses

    import jax

    from mpc_blaster_tpu.sim.scenarios import offset_free_loop

    base = cfg.simulation_preset()
    ocp = dataclasses.replace(
        base.ocp, N=6, Tf=6 / 30.0,
        solver=dataclasses.replace(base.ocp.solver, qp_backend="riccati",
                                   ipm_iters=6))
    spec = build_spec(ocp, yref=base.loop.yref, dtype=jnp.float32)
    wind = jnp.asarray([0.5, -0.3, 0.1], jnp.float32)
    x0 = jnp.zeros(cfg.NX, jnp.float32).at[2].set(3.2)
    res = jax.jit(lambda s, x: offset_free_loop(
        s, ocp, x, wind, n_steps=30))(spec, x0)
    assert bool(jnp.all(jnp.isfinite(res.xs)))
    import numpy as np
    np.testing.assert_allclose(np.asarray(res.d_hist[-1, 0:3]),
                               np.asarray(wind), atol=0.05)
