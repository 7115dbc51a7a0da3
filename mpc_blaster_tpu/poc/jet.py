"""Ballistic water-jet model with linear drag — closed form.

The reference integrates the 6-state ODE

    p_dot = v,   v_dot = -M_c v + g          (`Jacobian_POC_Solver.py:77`)

with a generated-C acados ERK(4) integrator, 10 substeps per call
(`Jacobian_POC_Solver.py:89-102`). With scalar drag c the ODE is linear with
constant coefficients, so we use the exact solution instead — no
integrator in the hot path at all:

    v(t) = v_inf + (v0 - v_inf) e^{-c t},        v_inf = g / c
    p(t) = p0 + v_inf t + (v0 - v_inf)(1 - e^{-c t}) / c

This is both faster and differentiable to machine precision; an RK4 mode is
kept for validation parity with the reference integrator.
"""
from __future__ import annotations

import jax.numpy as jnp

from mpc_blaster_tpu.core.htm import nozzle_pose
from mpc_blaster_tpu.dynamics.integrators import erk_integrate

GRAVITY = 9.81


def jet_init_conditions(euler, alpha, position, stream_velocity,
                        convention: str = "htm"):
    """Initial jet state [p_nozzle, v_exit] (6,).

    Mirrors `Jacobian_POC_Solver.setInitConditions`
    (`Jacobian_POC_Solver.py:154-165`): the jet leaves the nozzle at
    `stream_velocity` along the nozzle frame's -z axis, rotated to world.
    """
    euler = jnp.asarray(euler)
    alpha = jnp.asarray(alpha)
    position = jnp.asarray(position)
    p, R = nozzle_pose(euler, alpha, position, convention)
    v_exit = R @ jnp.array([0.0, 0.0, -1.0], dtype=R.dtype) * stream_velocity
    return jnp.concatenate([p, v_exit])


def jet_state(t, init, drag: float):
    """Exact jet state at time t >= 0 from init = [p0, v0]."""
    p0, v0 = init[..., 0:3], init[..., 3:6]
    g = jnp.zeros(3, init.dtype).at[2].set(-GRAVITY)
    c = jnp.asarray(drag, init.dtype)
    v_inf = g / c
    decay = jnp.exp(-c * t)
    v = v_inf + (v0 - v_inf) * decay
    p = p0 + v_inf * t + (v0 - v_inf) * (1.0 - decay) / c
    return jnp.concatenate([p, v], axis=-1)


def jet_altitude(t, init, drag: float):
    """z(t) — the root function for time-of-impact (`Jacobian_POC_Solver.py:227-232`)."""
    return jet_state(t, init, drag)[..., 2]


def jet_altitude_rate(t, init, drag: float):
    """dz/dt = v_z(t) — the exact Newton derivative (the reference uses a
    1e-5 forward difference, `Jacobian_POC_Solver.py:141-152`)."""
    return jet_state(t, init, drag)[..., 5]


def _jet_ode(x, u, drag):
    v = x[3:6]
    g = jnp.zeros(3, x.dtype).at[2].set(-GRAVITY)
    return jnp.concatenate([v, -drag * v + g])


def jet_state_rk4(t, init, drag: float, num_steps: int = 10):
    """RK4 reference path mirroring the acados ERK(4, 10) integrator setup
    (`Jacobian_POC_Solver.py:93-95`); used in tests to validate the closed form."""
    return erk_integrate(_jet_ode, init, jnp.zeros(0, init.dtype), t, drag,
                         num_steps=num_steps)
