"""SQP convergence + closed-loop behavior on the reference presets."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu.ocp.spec import build_spec
from mpc_blaster_tpu.sqp.rti import init_rti_state, make_rti_step, sqp_solve
from mpc_blaster_tpu.sim.closedloop import run_preset

DTYPE = jnp.float64


def _hover_setup():
    preset = cfg.simulation_preset()
    ocp = preset.ocp
    x0 = np.zeros(cfg.NX)
    x0[2] = 2.0
    yref = np.zeros(cfg.NY)
    yref[2] = 2.0
    spec = build_spec(ocp, yref=yref, dtype=DTYPE)
    return ocp, spec, jnp.asarray(x0, DTYPE)


def test_sqp_converges_to_hover():
    ocp, spec, x0 = _hover_setup()
    params = BlasterParams.from_config(ocp.model, DTYPE)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    state0 = init_rti_state(ocp, x0, DTYPE)
    state, step_norms = sqp_solve(spec, state0, x0, params, F, ocp.solver,
                                  iters=12)
    # The gimbal chain is nearly cost-free (R_swivel = 1e-5,
    # `simulation_blaster.py:27`) and wiggles at the QP's mu floor; assert
    # convergence of the channels that carry cost: thrusts + vehicle states.
    norms = np.asarray(step_norms)
    assert norms[-1] < 1.0, f"SQP diverged: {norms}"
    # Hover balance: rotor total + T_blast (hard-coded 2.2g quirk, along +z
    # at zero gimbal) = m g  =>  each rotor (9 - 2.2) * 9.81 / 4.
    u0 = np.asarray(state.ubar[0])
    hover_thrust = (9.0 - 2.2) * 9.81 / 4.0
    np.testing.assert_allclose(u0[0:4], hover_thrust, rtol=2e-3)
    # swivel rates live in the flat subspace: only bound-feasibility holds
    assert np.abs(u0[4:6]).max() <= 0.0872665 + 1e-9
    assert np.abs(np.asarray(state.xbar[:, 12:14])).max() < 0.02
    # Iterate stays at the hover state across the horizon.
    np.testing.assert_allclose(np.asarray(state.xbar[:, 2]), 2.0, atol=2e-2)


def test_rti_step_jitted_and_warm():
    ocp, spec, x0 = _hover_setup()
    step = make_rti_step(ocp, dtype=DTYPE)
    state = init_rti_state(ocp, x0, DTYPE)
    u0, state, diag = step(spec, state, x0)
    assert u0.shape == (cfg.NU,)
    assert np.isfinite(np.asarray(u0)).all()
    first = float(diag.step_norm_u)
    # repeated RTI at fixed x0 == SQP: step norms contract after a few iters
    for _ in range(9):
        u1, state, diag2 = step(spec, state, x0)
    assert float(diag2.step_norm_u) < 0.05 * first


def test_closed_loop_simulation_preset_tracks_target():
    preset = cfg.simulation_preset()
    res = run_preset(preset, n_steps=150, dtype=DTYPE)
    xs, us = np.asarray(res.xs), np.asarray(res.us)
    assert np.isfinite(xs).all() and np.isfinite(us).all()
    # target altitude 3.5 (`simulation_blaster.py:48`)
    assert abs(xs[-1, 2] - 3.5) < 0.15, xs[-1, 0:3]
    assert np.abs(xs[-1, 6:9]).max() < 0.1  # settles
    # control bounds respected (`simulation_blaster.py:30`)
    lbu = np.asarray(preset.ocp.bounds.lbu)
    ubu = np.asarray(preset.ocp.bounds.ubu)
    assert (us >= lbu - 1e-6).all() and (us <= ubu + 1e-6).all()
    # state bounds respected at every simulated step (tolerance: the plant
    # is simulated, only the controller's *predicted* states are constrained)
    lbx = np.asarray(preset.ocp.bounds.lbx)
    ubx = np.asarray(preset.ocp.bounds.ubx)
    assert (xs[1:] >= lbx - 2e-2).all() and (xs[1:] <= ubx + 2e-2).all()
    # controller QP stayed healthy
    assert np.asarray(res.kkt_eq).max() < 1e-5


def test_closed_loop_flight_preset():
    preset = cfg.flight_preset()
    res = run_preset(preset, n_steps=120, dtype=DTYPE)
    xs = np.asarray(res.xs)
    assert np.isfinite(xs).all()
    # flight yref (0.5, 1.0, 3.5) (`mavros_blaster_sim.py:61`)
    np.testing.assert_allclose(xs[-1, 0:3], [0.5, 1.0, 3.5], atol=0.25)
    # zero-POC-Jacobian quirk: poc states never move (SURVEY.md §3.4)
    np.testing.assert_allclose(xs[:, 14:17], 0.0, atol=1e-9)


@pytest.mark.slow
def test_closed_loop_f32_close_to_f64():
    """f32 (device dtype) controls stay within 1e-3-grade agreement of f64.

    Uses a well-conditioned cost variant: with the reference's R_swivel=1e-5
    (`simulation_blaster.py:27`) the gimbal subspace is flat to ~1e-6 of the
    position weights, so its optimizer is ill-determined and ANY two solvers
    (or precisions; or HPIPM runs) legitimately diverge there. Bumping the
    swivel weights to 1e-1 makes the optimum well-posed; agreement across
    precisions is then a meaningful numerical-fidelity check.
    """
    import dataclasses
    preset = cfg.simulation_preset()
    cost = dataclasses.replace(
        preset.ocp.cost, r_diag=(5e-2, 5e-2, 5e-2, 5e-2, 1e-1, 1e-1))
    ocp = dataclasses.replace(preset.ocp, cost=cost)
    preset = dataclasses.replace(preset, ocp=ocp)
    # --- single converged solve: the ≤1e-3 control-match criterion ---
    from mpc_blaster_tpu.dynamics.blaster import BlasterParams, blaster_ode
    from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
    x0 = np.zeros(cfg.NX); x0[2] = 3.2
    yref = np.asarray(preset.loop.yref)
    us = {}
    for dt_ in (jnp.float64, jnp.float32):
        spec = build_spec(ocp, yref=yref, dtype=dt_)
        params = BlasterParams.from_config(ocp.model, dt_)
        F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
        st0 = init_rti_state(ocp, jnp.asarray(x0, dt_), dt_)
        st, _ = sqp_solve(spec, st0, jnp.asarray(x0, dt_), params, F,
                          ocp.solver, iters=6)
        us[dt_.__name__] = np.asarray(st.ubar, np.float64)
    rel = np.abs(us["float64"] - us["float32"]) / (
        np.abs(us["float64"]).max(axis=0) + 1.0)
    assert rel.max() < 2e-3, rel.max(axis=0)

    # --- closed loop: feedback amplifies fp noise through the saturated
    # transient; require percent-grade agreement, not per-tick identity ---
    r64 = run_preset(preset, n_steps=60, dtype=jnp.float64)
    r32 = run_preset(preset, n_steps=60, dtype=jnp.float32)
    u64, u32 = np.asarray(r64.us), np.asarray(r32.us)
    assert np.isfinite(u32).all()
    scale = np.abs(u64).max(axis=0) + 1.0
    err = np.abs(u64 - u32) / scale
    assert err[:, 0:4].max() < 3e-2, err.max(axis=0)
    x64, x32 = np.asarray(r64.xs), np.asarray(r32.xs)
    assert np.abs(x64 - x32).max() < 3e-2


def test_closed_loop_f32_reference_weights_stable():
    """With the reference's exact (ill-conditioned) weights, f32 must still
    run stably and track the target, even though the flat gimbal subspace
    is precision-dependent."""
    preset = cfg.simulation_preset()
    r32 = run_preset(preset, n_steps=100, dtype=jnp.float32)
    xs = np.asarray(r32.xs)
    assert np.isfinite(xs).all()
    assert abs(xs[-1, 2] - 3.5) < 0.25


@pytest.mark.slow
def test_warm_started_rti_fewer_iterations():
    """Slack/dual warm starting lets a 6-iteration IPM match the quality of
    the 12-iteration cold solver after the first tick."""
    import dataclasses as dc
    from mpc_blaster_tpu.qp.ipm import IpmWarmStart
    from mpc_blaster_tpu.sqp.rti import rti_step, rti_step_warm

    ocp, spec, x0 = _hover_setup()
    params = BlasterParams.from_config(ocp.model, DTYPE)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    solver6 = dc.replace(ocp.solver, ipm_iters=6)

    st_c = init_rti_state(ocp, x0, DTYPE)
    st_w = init_rti_state(ocp, x0, DTYPE)
    warm = IpmWarmStart.zeros(ocp.N, cfg.NX, cfg.NU, DTYPE)
    # jit once: eight eager (untraced) ticks cost ~90 s of CPU suite time
    step_c = jax.jit(lambda sp, st, x: rti_step(sp, st, x, params, F,
                                                ocp.solver))
    step_w = jax.jit(lambda sp, st, w, x: rti_step_warm(sp, st, w, x,
                                                        params, F, solver6))
    for i in range(8):
        u_c, st_c, diag_c = step_c(spec, st_c, x0)
        u_w, st_w, warm, diag_w = step_w(spec, st_w, warm, x0)
    # same hover decision to control tolerance
    np.testing.assert_allclose(np.asarray(u_w[0:4]), np.asarray(u_c[0:4]),
                               rtol=5e-3)
    # warm path stays dynamics-consistent (flat-subspace dual noise keeps
    # raw stationarity from vanishing; the control decision is what matters)
    assert float(diag_w.qp_kkt_eq) < 1e-3


def test_closed_loop_warm_start_quality():
    """Warm-started 6-iteration loop tracks as well as the cold 12-iter."""
    import dataclasses as dc
    from mpc_blaster_tpu.ocp.spec import build_spec as _bs
    from mpc_blaster_tpu.sim.closedloop import make_closed_loop

    preset = cfg.simulation_preset()
    ocp6 = dc.replace(preset.ocp,
                      solver=dc.replace(preset.ocp.solver, ipm_iters=6))
    spec = _bs(ocp6, yref=preset.loop.yref, dtype=DTYPE)
    run_w = make_closed_loop(ocp6, 120, dtype=DTYPE, warm_start=True)
    res = run_w(spec, jnp.asarray(preset.loop.x0, DTYPE))
    xs = np.asarray(res.xs)
    assert np.isfinite(xs).all()
    assert abs(xs[-1, 2] - 3.5) < 0.15, xs[-1, 0:3]


@pytest.mark.slow
def test_jacobian_reuse_closed_loop():
    """Jacobian-reuse ticks (refresh every 4th) track like full ticks —
    the reference's sim_method_jac_reuse, on device."""
    import functools
    from mpc_blaster_tpu.sqp.rti import (JacCache, rti_step,
                                         rti_step_jacreuse)
    from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics as dd

    preset = cfg.simulation_preset()
    ocp = preset.ocp
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=DTYPE)
    params = BlasterParams.from_config(ocp.model, DTYPE)
    F = dd(blaster_ode, ocp.dt, num_steps=1)
    step_f = jax.jit(lambda st, x: rti_step(spec, st, x, params, F,
                                            ocp.solver))
    step_r = jax.jit(lambda st, c, rf, x: rti_step_jacreuse(
        spec, st, c, rf, x, params, F, ocp.solver))
    x_full = x_reuse = jnp.asarray(preset.loop.x0, DTYPE)
    st_f = init_rti_state(ocp, x_full, DTYPE)
    st_r = init_rti_state(ocp, x_reuse, DTYPE)
    cache = JacCache.zeros(ocp.N, cfg.NX, cfg.NU, DTYPE)
    plant_p = spec.stage_params[0].at[-1].set(2.2 * 9.81)
    plant = jax.jit(lambda x, u: F(x, u, plant_p, params))
    for i in range(60):
        u_f, st_f, _ = step_f(st_f, x_full)
        u_r, st_r, cache, diag = step_r(st_r, cache,
                                        jnp.asarray(i % 4 == 0), x_reuse)
        x_full = plant(x_full, u_f)
        x_reuse = plant(x_reuse, u_r)
    xf, xr = np.asarray(x_full), np.asarray(x_reuse)
    assert np.isfinite(xr).all()
    # both loops reach the same neighborhood of the climb trajectory
    assert abs(xf[2] - xr[2]) < 0.1, (xf[0:3], xr[0:3])
    assert np.abs(xr[3:6]).max() < 0.2


def test_closed_loop_jac_refresh_mode():
    """closed_loop(jac_refresh=4) — the deployed latency composition —
    matches the per-tick-linearized loop on the hover transient."""
    import dataclasses
    from mpc_blaster_tpu.sim.closedloop import make_closed_loop

    preset = cfg.simulation_preset()
    ocp = dataclasses.replace(preset.ocp, N=20, Tf=20 / 30.0)
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=DTYPE)
    x0 = jnp.asarray(preset.loop.x0, DTYPE)
    ref = make_closed_loop(ocp, 40, dtype=DTYPE)(spec, x0)
    jr = make_closed_loop(ocp, 40, dtype=DTYPE, jac_refresh=4)(spec, x0)
    assert np.isfinite(np.asarray(jr.xs)).all()
    # exact defects keep the loops glued: cm-level over the transient
    np.testing.assert_allclose(np.asarray(jr.xs[:, 0:6]),
                               np.asarray(ref.xs[:, 0:6]), atol=2e-2)
    # warm_start + jac_refresh COMPOSE since round 3
    # (test_warm_jacreuse_composition_tracks covers the combined mode)


@pytest.mark.slow
def test_warm_jacreuse_composition_tracks():
    """warm_start + jac_refresh compose (rti_step_warm_jacreuse): the
    shifted-warm Jacobian-reuse loop reaches the hover target like the
    plain loop, with the cache shifted alongside the iterate."""
    import dataclasses
    from mpc_blaster_tpu.sim.closedloop import make_closed_loop

    preset = cfg.simulation_preset()
    ocp = dataclasses.replace(preset.ocp, N=10, Tf=10 / 30.0)
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=DTYPE)
    x0 = jnp.zeros(cfg.NX, DTYPE).at[2].set(2.0)
    sv = dataclasses.replace(ocp.solver, ipm_iters=4, warm_mode="primal",
                             warm_shift=True)
    run = make_closed_loop(dataclasses.replace(ocp, solver=sv), 80,
                           dtype=DTYPE, warm_start=True, jac_refresh=4)
    res = run(spec, x0)
    assert bool(jnp.isfinite(res.xs).all())
    # settles at the 3.5 m target despite 3/4 of ticks reusing stale A/B
    assert abs(float(res.xs[-1, 2]) - 3.5) < 0.05
    ref = make_closed_loop(ocp, 80, dtype=DTYPE)(spec, x0)
    assert abs(float(res.xs[-1, 2]) - float(ref.xs[-1, 2])) < 0.02
