"""LQR terminal-cost synthesis: Q_t as the infinite-horizon cost-to-go.

Why this exists (r5, measured): the reference's terminal weights are an
arbitrary 10x scaling of the stage weights (`simulation_blaster.py:24-27`
qt = 10 * q — not a cost-to-go), and short prediction horizons with such a
terminal cost can be CLOSED-LOOP UNSTABLE even when every per-tick QP is
solved to high accuracy. Measured on the offset-free wind-compensation
loop with sim-preset weights at dt = 1/30 s:

  horizon    preset Q_t                 LQR Q_t (this module)
  N = 10     1.63 m limit cycle         0.115 m settle, eq ~ 2e-9
  N = 12     1.56 m limit cycle         0.081 m settle, eq ~ 3e-10
  N = 20     1.50 m limit cycle         0.37 m (improved, not settled*)
  N >= 24    settles with either Q_t (0.008 m); native N = 60: 0.0003 m

(*) the N = 20-truncated sim config sits on a multi-factor stability
boundary (bounds + weights + horizon interact; no single knob flips
it); deploy the sim preset at N >= 24.

The classical result behind this: with terminal cost equal to the
unconstrained infinite-horizon LQR cost-to-go at the target equilibrium,
the finite-horizon MPC value function is a Lyapunov function for any
horizon on which the tail is constraint-inactive, so shrinking the
horizon cannot destabilize the loop.

This runs at SETUP time on the host (scipy DARE in f64) — it is a
spec-construction utility, not part of the jitted tick.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams
from mpc_blaster_tpu.dynamics.fastlin import fast_linearize
from mpc_blaster_tpu.ocp.spec import OCPSpec


def hover_equilibrium(ocp: cfg.OCPConfig, spec: OCPSpec):
    """(x_eq, u_eq) of the hover trim at the spec's position target.

    The blast thruster (stage param 24, `blastermodel.py:280-281`) pushes
    along the nozzle axis; at gimbal zero that is body +z, so rotor trim
    is (m g - T_blast)/4 each (the reference's own hover-out constant
    0.705 encodes the same trim, `mavros_blaster_sim.py:128-133`)."""
    x_eq = np.zeros(cfg.NX)
    x_eq[0:3] = np.asarray(spec.yref_x[0, 0:3])
    x_eq[14:17] = np.asarray(spec.yref_x[0, 14:17]) * 0.0  # poc free
    tb = float(spec.stage_params[0, -1])
    t_each = (ocp.model.mass * ocp.model.gravity - tb) / 4.0
    u_eq = np.zeros(cfg.NU)
    u_eq[0:4] = t_each
    return x_eq, u_eq


def lqr_terminal_weight(ocp: cfg.OCPConfig, spec: OCPSpec,
                        x_eq=None, u_eq=None, drop=None,
                        dtype=jnp.float32) -> jnp.ndarray:
    """Discrete-are cost-to-go at the hover equilibrium as Q_t.

    Linearizes the discrete dynamics (same RK4 + jvp as the solver's own
    linearizer, `dynamics/fastlin.py`) at (x_eq, u_eq), solves the DARE
    with the dt-SCALED stage weights (dt*Q, dt*R — the scaling build_qp
    applies to stage costs, so P is in the same units as the unscaled
    terminal slot), and returns a (nx, nx) Q_t.

    `drop`: state indices excluded from the DARE (kept at the preset's
    terminal diagonal). Default: the POC rows 14:17 WHEN the spec's POC
    Jacobians are all zero — then poc_{k+1} = poc_k is an uncontrollable
    unit-circle mode with nonzero cost and the DARE has no solution.
    With nonzero Jacobians the POC couples to the controllable states
    and stays in.

    Use: ``spec = spec._replace(Q_t=lqr_terminal_weight(ocp, spec))`` —
    every solver backend picks it up (Q_t is data, not config).
    """
    import scipy.linalg

    if x_eq is None or u_eq is None:
        x_eq_d, u_eq_d = hover_equilibrium(ocp, spec)
        x_eq = x_eq_d if x_eq is None else np.asarray(x_eq, np.float64)
        u_eq = u_eq_d if u_eq is None else np.asarray(u_eq, np.float64)
    if drop is None:
        j_rows = np.asarray(spec.stage_params[0, :24])
        drop = list(range(14, cfg.NX)) if not np.any(j_rows) else []

    params = BlasterParams.from_config(ocp.model, jnp.float32)
    xb = jnp.asarray(np.tile(np.asarray(x_eq, np.float64), (2, 1)),
                     jnp.float32)
    ub = jnp.asarray(np.asarray(u_eq, np.float64)[None], jnp.float32)
    sp = jnp.asarray(np.asarray(spec.stage_params[:1]), jnp.float32)
    _, A, B = fast_linearize(xb, ub, sp, params, ocp.dt, 1)
    A = np.asarray(A[0], np.float64)
    B = np.asarray(B[0], np.float64)

    keep = [i for i in range(cfg.NX) if i not in set(drop)]
    Ak = A[np.ix_(keep, keep)]
    Bk = B[keep]
    dtw = float(spec.dt)
    Qk = dtw * np.asarray(spec.Q, np.float64)[np.ix_(keep, keep)]
    Rk = dtw * np.asarray(spec.R, np.float64)
    P = scipy.linalg.solve_discrete_are(Ak, Bk, Qk, Rk)
    P = 0.5 * (P + P.T)
    Qt = np.asarray(spec.Q_t, np.float64).copy()
    Qt[np.ix_(keep, keep)] = P
    return jnp.asarray(Qt, dtype)
