"""OCP specification pytree — the analog of the reference's AcadosOcp.

`blasterModel.generateController()` (`blastermodel.py:214-292`) assembles a
LINEAR_LS tracking OCP with full box bounds and writes it to JSON for C
codegen. Here the same information is a pytree consumed directly by the
jitted SQP-RTI step — no codegen, no serialization, trivially batchable.

Cost (acados LINEAR_LS with Vx = [I;0], Vu = [0;I], W = blkdiag(Q, R),
`blastermodel.py:244-252`):

    sum_k dt * ( 0.5|x_k - yref_x,k|^2_Q + 0.5|u_k - yref_u,k|^2_R )
        + 0.5|x_N - yref_e|^2_{Q_t}

Stage costs are scaled by the shooting interval (acados default cost
scaling; JSON `time_steps`), the terminal cost is not.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.qp.data import full_precision


class OCPSpec(NamedTuple):
    """Per-solve problem data (pytree; leading axes batchable).

    Q: (nx, nx); R: (nu, nu); Q_t: (nx, nx)
    yref_x: (N, nx); yref_u: (N, nu); yref_e: (nx,)
    lbx/ubx: (nx,); lbu/ubu: (nu,)
    stage_params: (N, np) 25-dim POC-Jacobian parameters per stage
    dt: scalar shooting interval
    """

    Q: jnp.ndarray
    R: jnp.ndarray
    Q_t: jnp.ndarray
    yref_x: jnp.ndarray
    yref_u: jnp.ndarray
    yref_e: jnp.ndarray
    lbx: jnp.ndarray
    ubx: jnp.ndarray
    lbu: jnp.ndarray
    ubu: jnp.ndarray
    stage_params: jnp.ndarray
    dt: jnp.ndarray

    @property
    def horizon(self) -> int:
        return self.yref_x.shape[-2]


def build_spec(ocp: cfg.OCPConfig, yref=None, stage_params=None,
               dtype=jnp.float32) -> OCPSpec:
    """Build an OCPSpec from config (+ optional 23-dim yref as the reference
    passes it, `simulation_blaster.py:48,63-78`: stage refs identical, the
    terminal ref is yref[:nx])."""
    N = ocp.N
    if yref is None:
        yref = np.zeros(cfg.NY)
    yref = np.asarray(yref, dtype=np.float64)
    if yref.ndim == 1:
        yref_x = np.tile(yref[:cfg.NX], (N, 1))
        yref_u = np.tile(yref[cfg.NX:], (N, 1))
        yref_e = yref[:cfg.NX]
    else:  # (N, ny) trajectory tracking
        yref_x = yref[:, :cfg.NX]
        yref_u = yref[:, cfg.NX:]
        yref_e = yref[-1, :cfg.NX]
    if stage_params is None:
        # codegen defaults: zero Jacobians + hard-coded T_blast
        # (`blastermodel.py:280-282`)
        t_blast = 2.2 * 9.81 if ocp.quirks.hardcode_t_blast \
            else ocp.model.blast_thruster
        stage_params = np.zeros((N, cfg.NP))
        stage_params[:, -1] = t_blast
    stage_params = np.asarray(stage_params, dtype=np.float64)
    if stage_params.ndim == 1:
        stage_params = np.tile(stage_params, (N, 1))

    return OCPSpec(
        Q=jnp.asarray(ocp.cost.Q(), dtype),
        R=jnp.asarray(ocp.cost.R(), dtype),
        Q_t=jnp.asarray(ocp.cost.Q_t(), dtype),
        yref_x=jnp.asarray(yref_x, dtype),
        yref_u=jnp.asarray(yref_u, dtype),
        yref_e=jnp.asarray(yref_e, dtype),
        lbx=jnp.asarray(ocp.bounds.lbx, dtype),
        ubx=jnp.asarray(ocp.bounds.ubx, dtype),
        lbu=jnp.asarray(ocp.bounds.lbu, dtype),
        ubu=jnp.asarray(ocp.bounds.ubu, dtype),
        stage_params=jnp.asarray(stage_params, dtype),
        dt=jnp.asarray(ocp.dt, dtype),
    )


@full_precision
def stage_cost(spec: OCPSpec, x: jnp.ndarray, u: jnp.ndarray,
               k: int) -> jnp.ndarray:
    """dt * (0.5|x-yref|^2_Q + 0.5|u-uref|^2_R) for diagnostics."""
    ex = x - spec.yref_x[k]
    eu = u - spec.yref_u[k]
    return spec.dt * (0.5 * ex @ spec.Q @ ex + 0.5 * eu @ spec.R @ eu)


@full_precision
def total_cost(spec: OCPSpec, xs: jnp.ndarray, us: jnp.ndarray) -> jnp.ndarray:
    """Full-trajectory objective (the reference prints `get_cost()` per tick,
    `simulation_blaster.py:86`)."""
    ex = xs[:-1] - spec.yref_x
    eu = us - spec.yref_u
    c = 0.5 * spec.dt * (
        jnp.einsum("ki,ij,kj->", ex, spec.Q, ex)
        + jnp.einsum("ki,ij,kj->", eu, spec.R, eu))
    ee = xs[-1] - spec.yref_e
    return c + 0.5 * ee @ spec.Q_t @ ee
