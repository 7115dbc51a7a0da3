"""BLASTER 17-state rigid-body + gimbal + POC dynamics as a pure function.

JAX replacement for the CasADi symbolic model of
`src/scripts/blastermodel.py:47-212`: instead of building an SX expression
graph and generating C, the ODE is a traced jnp function; Jacobians come from
`jax.jacfwd` instead of CasADi autodiff; discretization is in
`integrators.py`.

State/control/parameter layout is identical to the reference (see
`config.py` header; `blastermodel.py:171-210`).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.core.rotations import (
    euler_rates_from_omega,
    euler_zyx_to_rot,
    gimbal_rotation,
)


class BlasterParams(NamedTuple):
    """Physical constants as a pytree (static per-vehicle data).

    Mirrors the `blasterModel.__init__` arguments (`blastermodel.py:16-45`)
    that enter the ODE; cost/bound config lives in `ocp/`.
    """

    mass: jnp.ndarray          # scalar
    inertia: jnp.ndarray       # (3,) diagonal of J
    arm_length_x: jnp.ndarray  # scalar
    arm_length_y: jnp.ndarray  # scalar
    yaw_coefficient: jnp.ndarray  # scalar c
    gravity: jnp.ndarray       # scalar (positive magnitude)

    @staticmethod
    def from_config(model: cfg.ModelConfig, dtype=jnp.float32) -> "BlasterParams":
        return BlasterParams(
            mass=jnp.asarray(model.mass, dtype),
            inertia=jnp.asarray(model.inertia_diag, dtype),
            arm_length_x=jnp.asarray(model.arm_length_x, dtype),
            arm_length_y=jnp.asarray(model.arm_length_y, dtype),
            yaw_coefficient=jnp.asarray(model.yaw_coefficient, dtype),
            gravity=jnp.asarray(model.gravity, dtype),
        )


def pack_stage_params(j_angles, j_euler, j_pos, t_blast) -> jnp.ndarray:
    """(3,2), (3,3), (3,3), scalar -> 25-vector, column-major.

    Matches the CasADi `reshape` packing at `blastermodel.py:203-210` and the
    sim loop's `np.reshape(..., order='F')` at `simulation_blaster.py:67`.
    """
    j_angles = jnp.asarray(j_angles)
    j_euler = jnp.asarray(j_euler)
    j_pos = jnp.asarray(j_pos)
    return jnp.concatenate([
        j_angles.T.reshape(6),
        j_euler.T.reshape(9),
        j_pos.T.reshape(9),
        jnp.atleast_1d(jnp.asarray(t_blast)).reshape(1),
    ])


def unpack_stage_params(p: jnp.ndarray):
    """25-vector -> (J_angles (3,2), J_euler (3,3), J_pos (3,3), t_blast)."""
    j_angles = p[0:6].reshape(2, 3).T
    j_euler = p[6:15].reshape(3, 3).T
    j_pos = p[15:24].reshape(3, 3).T
    return j_angles, j_euler, j_pos, p[24]


def default_stage_params(t_blast: float = 2.2 * 9.81, dtype=jnp.float32) -> jnp.ndarray:
    """acados codegen defaults: zero Jacobians, hard-coded T_blast=2.2*9.81
    (`blastermodel.py:280-282`)."""
    return jnp.zeros(cfg.NP, dtype).at[-1].set(t_blast)


def blaster_ode(x: jnp.ndarray, u: jnp.ndarray, p: jnp.ndarray,
                params: BlasterParams) -> jnp.ndarray:
    """xdot = f(x, u, p): the reference's `f_expl_expr` (`blastermodel.py:124-199`).

    x: (17,) [p, eul, v, omega, alpha, poc]; u: (6,) [T1..T4, a1dot, a2dot];
    p: (25,) stage parameters (POC Jacobians + T_blast).

    LOCKSTEP: `dynamics/fastlin.py::_ode_rows` is this same ODE hand-
    expanded to elementwise row form for the fused linearizer — any model
    change here must be mirrored there (the f64 parity tests in
    tests/test_fastlin.py are the guard).
    """
    eul = x[cfg.IDX_EUL]
    v = x[cfg.IDX_V]
    omega = x[cfg.IDX_OMEGA]
    alpha = x[cfg.IDX_ALPHA]
    thrust = u[0:4]
    alpha_dot = u[4:6]

    j_angles, j_euler, j_pos, t_blast = unpack_stage_params(p)

    R = euler_zyx_to_rot(eul)
    R_gimbal = gimbal_rotation(alpha[0], alpha[1])

    # Translational dynamics (`blastermodel.py:163`): collective thrust along
    # body z plus blast reaction along nozzle z, both rotated to world.
    total_thrust = jnp.sum(thrust)
    e3 = jnp.zeros(3, x.dtype).at[2].set(1.0)
    f_world = R @ (e3 * total_thrust) + R @ (R_gimbal @ (e3 * t_blast))
    g_vec = jnp.zeros(3, x.dtype).at[2].set(-params.gravity)
    v_dot = f_world / params.mass + g_vec

    # Rotational dynamics: rotor mixing (`blastermodel.py:95-101`) and Euler's
    # equation with diagonal inertia (`:164`).
    t1, t2, t3, t4 = thrust[0], thrust[1], thrust[2], thrust[3]
    moments = jnp.stack([
        (t2 + t4 - t1 - t3) * params.arm_length_y,
        (-t1 - t4 + t2 + t3) * params.arm_length_x,
        (-t1 - t2 + t3 + t4) * params.yaw_coefficient,
    ])
    J = params.inertia
    omega_dot = (moments - jnp.cross(omega, J * omega)) / J

    # Attitude kinematics (`blastermodel.py:162`).
    eul_dot = euler_rates_from_omega(eul, omega)

    # POC propagation through the frozen jet linearization (`blastermodel.py:165`).
    poc_dot = j_pos @ v + j_euler @ eul_dot + j_angles @ alpha_dot

    return jnp.concatenate([v, eul_dot, v_dot, omega_dot, alpha_dot, poc_dot])
