"""Robustness at the reference's iteration envelope (VERDICT r1 missing #5).

The reference configures HPIPM with `qp_solver_iter_max=500`
(`blastermodel.py:279`) and then IGNORES the solve status
(`simulation_blaster.py:80`): its only robustness story is "hope". This
framework fixes the iteration budget (XLA) but must prove the analogous
property explicitly: pathological / near-infeasible initial states still
produce FLIGHT-SAFE controls — finite, inside the control box — with the
failure surfaced through diagnostics instead of exceptions.

Stress batch: states at box corners, 2x outside the position box, at
velocity/omega bounds, gimbal pinned at its asymmetric limits, and random
draws well beyond the operating envelope. Everything runs vmapped in ONE
compiled call at f32 (the device dtype — the stressful one).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu.ocp.spec import build_spec
from mpc_blaster_tpu.sqp.rti import init_rti_state, rti_step, sqp_solve

DTYPE = jnp.float32


def _pathological_batch(ocp):
    """(B, nx) stress states around and beyond the operating envelope."""
    lbx = np.asarray(ocp.bounds.lbx, np.float64)
    ubx = np.asarray(ocp.bounds.ubx, np.float64)
    rows = []
    rows.append(np.zeros(cfg.NX))                     # cold origin
    rows.append(ubx.copy())                           # every state at ub
    rows.append(lbx.copy())                           # every state at lb
    far = np.zeros(cfg.NX)
    far[0:3] = 2.0 * ubx[0:3]                         # 2x outside pos box
    rows.append(far)
    fast = np.zeros(cfg.NX)
    fast[2] = 2.0
    fast[6:9] = ubx[6:9]                              # at velocity bounds
    fast[9:12] = lbx[9:12]                            # at omega bounds
    rows.append(fast)
    gim = np.zeros(cfg.NX)
    gim[2] = 2.0
    gim[12] = ubx[12]                                 # gimbal at +1.22 rad
    gim[13] = lbx[13]
    rows.append(gim)
    rng = np.random.default_rng(0)
    for _ in range(10):
        draw = rng.uniform(1.5 * lbx - 0.5, 1.5 * ubx + 0.5)
        rows.append(draw)
    return np.stack(rows)


@pytest.fixture(scope="module")
def problem():
    preset = cfg.simulation_preset()
    ocp = dataclasses.replace(preset.ocp, N=20, Tf=20 / 30.0)
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=DTYPE)
    params = BlasterParams.from_config(ocp.model, DTYPE)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    return ocp, spec, params, F


def test_pathological_states_flight_safe(problem):
    """Every pathological tick returns u0 finite AND inside the control
    box (the flight-safety invariant: whatever the solver's internal
    distress, the published AttitudeTarget must be actuatable)."""
    ocp, spec, params, F = problem
    x0s = jnp.asarray(_pathological_batch(ocp), DTYPE)

    @jax.jit
    def tick(x0):
        st = init_rti_state(ocp, x0, DTYPE)
        u0, st, diag = rti_step(spec, st, x0, params, F, ocp.solver)
        return u0, diag

    u0s, diags = jax.vmap(tick)(x0s)
    u0s = np.asarray(u0s, np.float64)
    assert np.isfinite(u0s).all(), "non-finite control on stress batch"
    lbu = np.asarray(ocp.bounds.lbu)
    ubu = np.asarray(ocp.bounds.ubu)
    # IPM iterates are strictly interior in du, but the published control
    # is ubar + du around a feasible ubar: allow an epsilon skin.
    eps = 1e-3 * (ubu - lbu)
    assert (u0s >= lbu - eps).all(), (u0s.min(axis=0), lbu)
    assert (u0s <= ubu + eps).all(), (u0s.max(axis=0), ubu)
    # diagnostics must also be finite — failure is SURFACED, not raised
    assert np.isfinite(np.asarray(diags.qp_kkt_eq)).all()
    assert np.isfinite(np.asarray(diags.bound_viol)).all()
    # out-of-box starts are correctly reported as bound violations
    assert float(np.asarray(diags.bound_viol)[3]) > 1.0


@pytest.mark.slow
def test_deep_iteration_budget_stable(problem):
    """The reference's qp_solver_iter_max=500 analog: a DEEP solve budget
    (40 SQP outer x 12 IPM inner = 480 Newton systems) on a hard
    transient must not destabilize — best-iterate selection has to hold
    the converged answer (f32 iterates past convergence wobble; they must
    never win the merit race)."""
    ocp, spec, params, F = problem
    x0 = jnp.asarray(_pathological_batch(ocp)[4], DTYPE)  # at vel bounds

    st0 = init_rti_state(ocp, x0, DTYPE)
    # 20 outer iterations converge this transient (measured: the 8-iter
    # iterate is still ~0.9 N off on stage-0 thrust); the deep run's job
    # is to prove the EXTRA budget is harmless, so compare converged-vs-
    # deep, not unconverged-vs-deep.
    st_short, _ = sqp_solve(spec, st0, x0, params, F, ocp.solver,
                            iters=20)
    st_deep, step_norms = sqp_solve(spec, st0, x0, params, F, ocp.solver,
                                    iters=40)
    assert np.isfinite(np.asarray(st_deep.ubar)).all()
    # the deep budget's extra 20 outer iterations must not move the
    # answer materially (thrust channels; gimbal is weakly determined).
    # This is exactly what sqp_solve's best-merit iterate selection
    # guarantees: the f32 RAW iterates limit-cycle on this problem
    # (gimbal-subspace QP noise proposes near-free ~10 N bang-bang
    # steps; f64 contracts to 1e-9 in 5 iterations) — the returned
    # best-merit iterate is immune to the cycle.
    d = np.abs(np.asarray(st_deep.ubar[:, :4], np.float64)
               - np.asarray(st_short.ubar[:, :4], np.float64))
    assert d.max() < 0.5, d.max()
    # raw step norms stay bounded (no divergence), and in f64 the same
    # problem genuinely contracts — the cycle is an f32 artifact
    norms = np.asarray(step_norms)
    assert norms.max() < 10.0 * max(norms[0], 1.0), norms.max()
    spec64 = build_spec(ocp, yref=cfg.simulation_preset().loop.yref,
                        dtype=jnp.float64)
    params64 = BlasterParams.from_config(ocp.model, jnp.float64)
    st64, norms64 = sqp_solve(spec64, init_rti_state(ocp, x0, jnp.float64),
                              jnp.asarray(x0, jnp.float64), params64, F,
                              ocp.solver, iters=12)
    norms64 = np.asarray(norms64)
    assert norms64[-1] < 1e-6 * norms64[0], (norms64[0], norms64[-1])


def test_closed_loop_recovery_from_outside_box(problem):
    """Start 60% beyond the position box: the closed loop must re-enter
    the box and settle to the target — the practical 'hard tick' case the
    reference would hit after a disturbance (it would just raise on a bad
    integrator status, `simulation_blaster.py:100-101`)."""
    from mpc_blaster_tpu.sim.closedloop import closed_loop

    ocp, spec, params, F = problem
    x0 = np.zeros(cfg.NX)
    x0[0] = 2.4    # box is +-1.5
    x0[1] = -2.4
    x0[2] = 2.0
    res = jax.jit(lambda s, x: closed_loop(s, ocp, x, n_steps=90,
                                           dtype=DTYPE))(
        spec, jnp.asarray(x0, DTYPE))
    xs = np.asarray(res.xs)
    assert np.isfinite(xs).all()
    # back inside the box...
    assert (np.abs(xs[-1, 0:2]) <= 1.5 + 1e-3).all(), xs[-1, 0:3]
    # ...and heading to the hover target
    assert abs(xs[-1, 2] - 3.5) < 0.6, xs[-1, 2]
