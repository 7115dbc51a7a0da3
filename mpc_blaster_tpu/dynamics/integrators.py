"""Explicit Runge-Kutta discretization + autodiff sensitivities.

Replaces the acados ERK integrator (C codegen) the reference uses both as OCP
discretization (`blastermodel.py:277`, JSON `sim_method_num_stages=[4]*60`,
`sim_method_num_steps=[1]*60`) and as the plant (`simulation_blaster.py:94-104`).
The classic RK4 Butcher tableau here is exactly acados' 4-stage ERK; `num_steps`
substeps mirror `sim.solver_options.num_steps` (`Jacobian_POC_Solver.py:95`).

Sensitivities (A_k, B_k) come from `jax.jacfwd` of the whole discrete map —
the replacement for acados' forward-sensitivity ERK propagation.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from mpc_blaster_tpu.qp.data import full_precision

Ode = Callable[..., jnp.ndarray]  # f(x, u, *args) -> xdot


def rk4_step(f: Ode, x: jnp.ndarray, u: jnp.ndarray, dt, *args) -> jnp.ndarray:
    """One classic RK4 step (acados ERK, 4 stages)."""
    k1 = f(x, u, *args)
    k2 = f(x + 0.5 * dt * k1, u, *args)
    k3 = f(x + 0.5 * dt * k2, u, *args)
    k4 = f(x + dt * k3, u, *args)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


@full_precision
def erk_integrate(f: Ode, x: jnp.ndarray, u: jnp.ndarray, T, *args,
                  num_steps: int = 1) -> jnp.ndarray:
    """Integrate over [0, T] with `num_steps` RK4 substeps (static count).

    Matches `AcadosSimSolver` with ERK(4, num_steps). `T` may be a traced
    scalar (the POC solver differentiates through it); only `num_steps` must
    be static. The ODE's matmuls (rotations, POC Jacobians) and their
    jacfwd tangents run at `qp.data.MATMUL_PRECISION`.
    """
    dt = T / num_steps
    if num_steps == 1:
        return rk4_step(f, x, u, dt, *args)

    def body(x, _):
        return rk4_step(f, x, u, dt, *args), None

    x_out, _ = jax.lax.scan(body, x, None, length=num_steps)
    return x_out


def discrete_dynamics(f: Ode, dt: float, num_steps: int = 1) -> Callable:
    """Build F(x, u, *args) -> x_next for a fixed shooting interval."""
    def F(x, u, *args):
        return erk_integrate(f, x, u, dt, *args, num_steps=num_steps)
    return F


def discrete_jacobians(F: Callable) -> Callable:
    """Build (x, u, *args) -> (x_next, A, B) with A = dF/dx, B = dF/du.

    A single jacfwd over the concatenated (x, u) tangent space, so XLA shares
    the primal computation across all columns — this is the analog of acados'
    `sens_forw` ERK with seed [I_x | I_u].
    """
    def FAB(x, u, *args):
        x_next = F(x, u, *args)
        A, B = jax.jacfwd(F, argnums=(0, 1))(x, u, *args)
        return x_next, A, B
    return FAB


@partial(jax.jit, static_argnums=(0, 3))
def rollout(F: Callable, x0: jnp.ndarray, us: jnp.ndarray, horizon: int, *args):
    """Open-loop rollout of `horizon` steps under control sequence us (N, nu)."""
    def body(x, u):
        xn = F(x, u, *args)
        return xn, xn
    _, xs = jax.lax.scan(body, x0, us, length=horizon)
    return jnp.concatenate([x0[None], xs], axis=0)
