"""13-state quaternion-attitude quadrotor — second model family.

The reference ships quaternion helpers it never uses (`utils/MathUtils.py`,
imported at `blastermodel.py:4` but dead; the model is Euler-only,
SURVEY.md §2.1#7). This module puts them to work: a singularity-free
13-state rigid-body model (BASELINE.json's "12/13-state quadrotor")

    x = [p(3), q(wxyz 4), v(3), omega(3)],  u = [T1..T4]

    p_dot = v
    q_dot = 1/2 q ⊗ [0, omega]
    v_dot = R(q) e3 (ΣT)/m + g
    w_dot = J^-1 (M(T) - w × J w)

running on the SAME dim-agnostic OCP/QP/SQP stack as the 17-state BLASTER
model — the solver layers take their dimensions from the arrays, so a new
model family is just an ODE + a spec builder.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

import jax.numpy as jnp

from mpc_blaster_tpu.core.rotations import quat_mul, quat_to_rot
from mpc_blaster_tpu.dynamics.blaster import BlasterParams
from mpc_blaster_tpu.ocp.spec import OCPSpec
from mpc_blaster_tpu.sqp.rti import RTIState

QUAD13_NX = 13
QUAD13_NU = 4


@dataclasses.dataclass(frozen=True)
class Quad13Config:
    mass: float = 9.0
    inertia_diag: Tuple[float, float, float] = (0.50781, 0.47314, 0.72975)
    arm_length_x: float = 0.3434
    arm_length_y: float = 0.3475
    yaw_coefficient: float = 0.03
    gravity: float = 9.81
    N: int = 20
    Tf: float = 20 / 30.0
    q_diag: Tuple[float, ...] = (1e3, 1e3, 1e3,           # position
                                 5e2, 5e2, 5e2, 5e2,      # quaternion
                                 5.0, 5.0, 5.0,           # velocity
                                 1e1, 1e1, 1e1)           # omega
    r_diag: Tuple[float, ...] = (5e-2,) * 4
    thrust_max: float = 65.0
    # state box: position/velocity/rate envelopes; quat box wide open
    pos_bound: float = 5.0
    vel_bound: float = 2.0
    rate_bound: float = 1.0

    @property
    def dt(self) -> float:
        return self.Tf / self.N


def quad13_ode(x: jnp.ndarray, u: jnp.ndarray, p: jnp.ndarray,
               params: BlasterParams) -> jnp.ndarray:
    """xdot; `p` is unused (kept for stage-param API compatibility)."""
    del p
    q = x[3:7]
    v = x[7:10]
    omega = x[10:13]
    thrust = u[0:4]

    qn = q / jnp.linalg.norm(q)
    R = quat_to_rot(qn)
    e3 = jnp.zeros(3, x.dtype).at[2].set(1.0)
    g_vec = jnp.zeros(3, x.dtype).at[2].set(-params.gravity)
    v_dot = R @ (e3 * jnp.sum(thrust)) / params.mass + g_vec

    omega_q = jnp.concatenate([jnp.zeros(1, x.dtype), omega])
    q_dot = 0.5 * quat_mul(q, omega_q)

    t1, t2, t3, t4 = thrust
    moments = jnp.stack([
        (t2 + t4 - t1 - t3) * params.arm_length_y,
        (-t1 - t4 + t2 + t3) * params.arm_length_x,
        (-t1 - t2 + t3 + t4) * params.yaw_coefficient,
    ])
    J = params.inertia
    omega_dot = (moments - jnp.cross(omega, J * omega)) / J

    return jnp.concatenate([v, q_dot, v_dot, omega_dot])


def _params(c: Quad13Config, dtype) -> BlasterParams:
    return BlasterParams(
        mass=jnp.asarray(c.mass, dtype),
        inertia=jnp.asarray(c.inertia_diag, dtype),
        arm_length_x=jnp.asarray(c.arm_length_x, dtype),
        arm_length_y=jnp.asarray(c.arm_length_y, dtype),
        yaw_coefficient=jnp.asarray(c.yaw_coefficient, dtype),
        gravity=jnp.asarray(c.gravity, dtype),
    )


def build_quad13_spec(c: Quad13Config, target_pos=(0.0, 0.0, 2.0),
                      dtype=jnp.float32) -> OCPSpec:
    """OCPSpec for hover/waypoint tracking with identity-quat reference."""
    N = c.N
    yref_x = np.zeros((N, QUAD13_NX))
    yref_x[:, 0:3] = np.asarray(target_pos)
    yref_x[:, 3] = 1.0  # identity quaternion
    yref_u = np.zeros((N, QUAD13_NU))
    lbx = np.r_[[-c.pos_bound] * 2, 0.0, [-1.01] * 4,
                [-c.vel_bound] * 3, [-c.rate_bound] * 3]
    ubx = np.r_[[c.pos_bound] * 2, 2 * c.pos_bound, [1.01] * 4,
                [c.vel_bound] * 3, [c.rate_bound] * 3]
    return OCPSpec(
        Q=jnp.asarray(np.diag(c.q_diag), dtype),
        R=jnp.asarray(np.diag(c.r_diag), dtype),
        Q_t=jnp.asarray(10.0 * np.diag(c.q_diag), dtype),
        yref_x=jnp.asarray(yref_x, dtype),
        yref_u=jnp.asarray(yref_u, dtype),
        yref_e=jnp.asarray(yref_x[-1], dtype),
        lbx=jnp.asarray(lbx, dtype),
        ubx=jnp.asarray(ubx, dtype),
        lbu=jnp.zeros(QUAD13_NU, dtype),
        ubu=jnp.full((QUAD13_NU,), c.thrust_max, dtype),
        stage_params=jnp.zeros((N, 1), dtype),
        dt=jnp.asarray(c.dt, dtype),
    )


def init_quad13_rti_state(c: Quad13Config, x0: jnp.ndarray,
                          dtype=jnp.float32) -> RTIState:
    x0 = jnp.asarray(x0, dtype)
    hover = c.mass * c.gravity / 4.0
    u_h = jnp.full((QUAD13_NU,), hover, dtype) + 0.0 * x0[:QUAD13_NU]
    return RTIState(xbar=jnp.tile(x0[None], (c.N + 1, 1)),
                    ubar=jnp.tile(u_h[None], (c.N, 1)))


def make_quad13_rti_step(c: Quad13Config, dtype=jnp.float32, jit: bool = True,
                         solver=None):
    """Jitted RTI tick on the quaternion model (same SQP/QP machinery).

    `solver` (a config.SolverConfig) selects the QP backend and budget;
    the Riccati IPM is dimension-generic, so the 13-state quaternion
    family runs through the same solver as the BLASTER model.
    `lin_backend="fused"` maps to the "quad13" rows-form linearizer
    (`dynamics/fastlin.py::FAMILIES`)."""
    import jax

    from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu.sqp.rti import rti_step
    from mpc_blaster_tpu import config as cfgmod

    params = _params(c, dtype)
    F = discrete_dynamics(quad13_ode, c.dt, num_steps=1)
    if solver is None:
        solver = cfgmod.SolverConfig()
    lin = None
    if solver.lin_backend == "fused":
        from mpc_blaster_tpu.dynamics.fastlin import fast_linearize

        def lin(xbar, ubar, stage_params):
            return fast_linearize(xbar, ubar, stage_params, params, c.dt,
                                  1, family="quad13")
    elif solver.lin_backend != "jacfwd":
        raise ValueError("quad13 supports lin_backend 'jacfwd'/'fused'")

    def step(spec: OCPSpec, state: RTIState, x0: jnp.ndarray):
        return rti_step(spec, state, x0, params, F, solver,
                        linearizer=lin)

    return jax.jit(step) if jit else step


def hover_state(z: float = 2.0, dtype=jnp.float32) -> jnp.ndarray:
    x = jnp.zeros(QUAD13_NX, dtype)
    x = x.at[2].set(z)
    return x.at[3].set(1.0)
