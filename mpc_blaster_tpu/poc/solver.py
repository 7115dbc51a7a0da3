"""Point-of-contact solve + Jacobians, fully differentiable.

JAX replacement for `src/scripts/Jacobian_POC_Solver.py`: the
reference Newton-iterates time-of-impact with finite-difference derivatives
over an acados C integrator, then builds dPOC/d(euler, motor, position) from
9 perturbed re-solves at eps=1e-6 (`Jacobian_POC_Solver.py:234-300`). Here:

  - time-of-impact: Newton with the *exact* derivative dz/dT = v_z(T) on the
    closed-form trajectory, a static iteration budget inside jit
    (`lax.fori_loop`), guarded against v_z ~ 0 (the reference can divide by
    ~zero at `Jacobian_POC_Solver.py:150`);
  - Jacobians: one `jax.jacfwd` through the whole solve (the Newton fixpoint
    derivative converges with the iterate), replacing 9 finite-difference
    root-finds;
  - everything vmap-able over scenario batches.

A finite-difference mode reproduces the reference procedure for parity tests.
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.poc.jet import (
    jet_altitude,
    jet_altitude_rate,
    jet_init_conditions,
    jet_state,
)


def time_of_impact(init: jnp.ndarray, drag: float, t0: float = 0.1,
                   iters: int = 12) -> jnp.ndarray:
    """Newton solve for T with z(T) = 0 (`_solveRootFindingProblem`, `:115-139`).

    Keeps the reference's negative-iterate reflection (`:133-134`) so the
    solve converges to the positive root from the 0.1 initial guess.
    """
    def body(_, t):
        f = jet_altitude(t, init, drag)
        fp = jet_altitude_rate(t, init, drag)
        # Guard |v_z| >= 1e-6 against division blow-up near apogee.
        fp = jnp.where(jnp.abs(fp) < 1e-6, jnp.where(fp < 0, -1e-6, 1e-6), fp)
        t_next = t - f / fp
        return jnp.abs(t_next)

    t0 = jnp.asarray(t0, init.dtype)
    return jax.lax.fori_loop(0, iters, body, t0)


@partial(jax.jit, static_argnums=(3, 4, 5, 6))
def solve_poc(euler: jnp.ndarray, alpha: jnp.ndarray, position: jnp.ndarray,
              stream_velocity: float = 150.0, drag: float = 1.0,
              iters: int = 12, convention: str = "htm"):
    """(poc (3,), T_impact) for a vehicle pose + gimbal configuration."""
    init = jet_init_conditions(euler, alpha, position, stream_velocity,
                               convention)
    T = time_of_impact(init, drag, iters=iters)
    poc = jet_state(T, init, drag)[0:3]
    return poc, T


def _poc_only(euler, alpha, position, stream_velocity, drag, iters, convention):
    return solve_poc(euler, alpha, position, stream_velocity, drag, iters,
                     convention)[0]


@partial(jax.jit, static_argnums=(3, 4, 5, 6))
def poc_jacobians(euler: jnp.ndarray, alpha: jnp.ndarray,
                  position: jnp.ndarray, stream_velocity: float = 150.0,
                  drag: float = 1.0, iters: int = 12,
                  convention: str = "htm") -> Tuple[jnp.ndarray, ...]:
    """(J_mot (3,2), J_eul (3,3), J_pos (3,3)) = dPOC/d(alpha, euler, position).

    One jacfwd over all 8 tangent directions replaces the reference's 8
    perturbed Newton re-solves + forward differences
    (`Jacobian_POC_Solver.py:248-300`).
    """
    jac = jax.jacfwd(_poc_only, argnums=(1, 0, 2))
    j_mot, j_eul, j_pos = jac(euler, alpha, position, stream_velocity, drag,
                              iters, convention)
    return j_mot, j_eul, j_pos


def poc_value_and_jacobians(euler: jnp.ndarray, alpha: jnp.ndarray,
                            position: jnp.ndarray,
                            stream_velocity: float = 150.0,
                            drag: float = 1.0, iters: int = 12,
                            convention: str = "htm"):
    """(poc (3,), J_mot, J_eul, J_pos) in ONE forward pass (r5): the
    anchored-stagewise tracking mode needs the POC VALUE at each
    predicted pose alongside its Jacobians — `has_aux` rides the primal
    out of the same jacfwd trace instead of a second Newton solve."""
    def f(e, a, p):
        poc = _poc_only(e, a, p, stream_velocity, drag, iters, convention)
        return poc, poc

    jac = jax.jacfwd(f, argnums=(1, 0, 2), has_aux=True)
    (j_mot, j_eul, j_pos), poc = jac(euler, alpha, position)
    return poc, j_mot, j_eul, j_pos


def poc_jacobians_fd(euler, alpha, position, stream_velocity=150.0, drag=1.0,
                     iters: int = 12, convention: str = "htm", eps: float = 1e-6):
    """Reference-parity finite differences (forward, eps=1e-6
    `Jacobian_POC_Solver.py:37,298-300`), for validation of the autodiff path."""
    euler = jnp.asarray(euler, jnp.result_type(float))
    alpha = jnp.asarray(alpha, jnp.result_type(float))
    position = jnp.asarray(position, jnp.result_type(float))
    poc0 = _poc_only(euler, alpha, position, stream_velocity, drag, iters,
                     convention)

    def col(arg_idx, i, n):
        e = jnp.zeros(n, jnp.result_type(float)).at[i].set(eps)
        args = [euler, alpha, position]
        args[arg_idx] = args[arg_idx] + e
        return (_poc_only(*args, stream_velocity, drag, iters, convention)
                - poc0) / eps

    j_eul = jnp.stack([col(0, i, 3) for i in range(3)], axis=1)
    j_mot = jnp.stack([col(1, i, 2) for i in range(2)], axis=1)
    j_pos = jnp.stack([col(2, i, 3) for i in range(3)], axis=1)
    return j_mot, j_eul, j_pos


def true_poc_traj(xs: jnp.ndarray, stream_velocity: float = 150.0,
                  drag: float = 1.0, iters: int = 12,
                  convention: str = "htm") -> jnp.ndarray:
    """TRUE nonlinear jet impact points along a state trajectory.

    xs: (T, nx) blaster states (uses euler x[3:6], gimbal x[12:14],
    position x[0:3]). Returns (T, 3) impact points — the physical ground
    truth against which the linearized POC *belief* (x[14:17]) should be
    judged. The reference cannot afford this (9 FD re-integrations per
    pose, `Jacobian_POC_Solver.py:248-296`); the closed-form solve makes
    it a vmapped microsecond-scale evaluation.
    """
    f = jax.vmap(lambda x: solve_poc(x[3:6], x[12:14], x[0:3],
                                     stream_velocity, drag, iters,
                                     convention)[0])
    return f(xs)


class PocSolver:
    """Object-style facade with the reference class's workflow.

    Mirrors `Jacobian_POC_Solver.__init__/initialise/solveJacobians/
    getJacobians` (`Jacobian_POC_Solver.py:20-57,177-181,234-296`): construct
    with (stream velocity, drag, Ts); `initialise()` computes the Jacobians at
    the reference's canonical pose (zero angles, z=4, `:57`); the results feed
    the 25-dim OCP stage parameters.
    """

    def __init__(self, stream_velocity: float = 150.0, drag: float = 1.0,
                 ts: float = 1.5e-5, newton_iters: int = 12,
                 convention: str = "htm"):
        del ts  # the closed-form path needs no integrator step size
        self._stream_velocity = float(stream_velocity)
        self._drag = float(drag)
        self._iters = int(newton_iters)
        self._convention = convention
        self._poc = jnp.zeros(3)
        self._T = jnp.zeros(())
        self._j_mot = jnp.zeros((3, 2))
        self._j_eul = jnp.zeros((3, 3))
        self._j_pos = jnp.zeros((3, 3))

    @classmethod
    def from_config(cls, c: cfg.PocSolverConfig) -> "PocSolver":
        return cls(c.stream_velocity, c.drag, newton_iters=c.newton_iters)

    def initialise(self):
        """Reference `initialise()` (`:53-57`): Jacobians at the canonical pose."""
        self.solve_jacobians(jnp.zeros(3), jnp.zeros(2),
                             jnp.array([0.0, 0.0, 4.0]))
        return self

    def solve_jacobians(self, euler, alpha, position):
        euler = jnp.asarray(euler, jnp.result_type(float))
        alpha = jnp.asarray(alpha, jnp.result_type(float))
        position = jnp.asarray(position, jnp.result_type(float))
        self._poc, self._T = solve_poc(
            euler, alpha, position, self._stream_velocity, self._drag,
            self._iters, self._convention)
        self._j_mot, self._j_eul, self._j_pos = poc_jacobians(
            euler, alpha, position, self._stream_velocity, self._drag,
            self._iters, self._convention)
        return self._j_mot, self._j_eul, self._j_pos

    def get_jacobians(self):
        """(J_mot, J_eul, J_pos), the reference's getter ordering (`:177-181`)."""
        return self._j_mot, self._j_eul, self._j_pos

    @property
    def poc(self):
        return self._poc

    @property
    def time_of_impact(self):
        return self._T
