"""Fused component-form linearization: RK4 + forward sensitivities with
zero small matmuls.

Why this exists: the default linearizer (`sqp/rti.py::_linearize_nodes`,
`jax.vmap(jacfwd(F))`) lowers to dozens of tiny `dot_general`s (3x3
rotations, 3x3 POC Jacobian products, per RK4 stage, per tangent batch).
Each non-fusable op is a separate launch, so at B=1 the linearization
risks being bound by launches rather than arithmetic.

Here the BLASTER ODE (`blaster.py::blaster_ode`, reference
`blastermodel.py:124-199`) is restated with every state component as a
row of a (17, L) array, all products written out as elementwise
multiply-adds. L packs (shooting node s, tangent column j): lane
s*23 + j carries the primal for node s and the seed d/dx_j (j<17) or
d/du_{j-17}. One `jax.jvp` through the RK4 of this elementwise-only
function yields x_next, A = dF/dx and B = dF/du for ALL nodes in a
handful of XLA fusions — the same numbers as `_linearize_nodes` (same
Butcher tableau, same derivative mode), different op schedule only.

Opt-in via `SolverConfig.lin_backend = "fused"` ("jacfwd" stays the
default; both are tested against each other in tests/test_fastlin.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams

NX = cfg.NX  # 17
NU = cfg.NU  # 6
_C = NX + NU  # tangent columns per shooting node


def _ode_rows(X, U, P, params: BlasterParams):
    """blaster_ode with components as rows: X, U, P are tuples of 17, 6
    and 25 (L,) rows -> tuple of 17 Xdot rows. Pure elementwise ops (reference `blastermodel.py:
    124-199`; see `blaster.py::blaster_ode` for the vector form)."""
    phi, th, psi = X[3], X[4], X[5]
    vx, vy, vz = X[6], X[7], X[8]
    w1, w2, w3 = X[9], X[10], X[11]
    a1, a2 = X[12], X[13]
    t1, t2, t3, t4 = U[0], U[1], U[2], U[3]
    ad1, ad2 = U[4], U[5]
    tb = P[24]

    cphi, sphi = jnp.cos(phi), jnp.sin(phi)
    cth, sth = jnp.cos(th), jnp.sin(th)
    cpsi, spsi = jnp.cos(psi), jnp.sin(psi)

    # World-from-body R = Rz(psi) Ry(th) Rx(phi), written out.
    r00 = cpsi * cth
    r01 = cpsi * sth * sphi - spsi * cphi
    r02 = cpsi * sth * cphi + spsi * sphi
    r10 = spsi * cth
    r11 = spsi * sth * sphi + cpsi * cphi
    r12 = spsi * sth * cphi - cpsi * sphi
    r20 = -sth
    r21 = cth * sphi
    r22 = cth * cphi

    # Body-frame force: collective thrust along body z + blast reaction
    # along the nozzle axis Ry(a1)Rx(a2) e3 = [s1 c2, -s2, c1 c2].
    c1, s1 = jnp.cos(a1), jnp.sin(a1)
    c2, s2 = jnp.cos(a2), jnp.sin(a2)
    t_tot = t1 + t2 + t3 + t4
    fb0 = s1 * c2 * tb
    fb1 = -s2 * tb
    fb2 = t_tot + c1 * c2 * tb
    inv_m = 1.0 / params.mass
    vdx = (r00 * fb0 + r01 * fb1 + r02 * fb2) * inv_m
    vdy = (r10 * fb0 + r11 * fb1 + r12 * fb2) * inv_m
    vdz = (r20 * fb0 + r21 * fb1 + r22 * fb2) * inv_m - params.gravity

    # Euler's equation, diagonal inertia; rotor mixing per blaster_ode.
    ly, lx, cy = params.arm_length_y, params.arm_length_x, params.yaw_coefficient
    m0 = (t2 + t4 - t1 - t3) * ly
    m1 = (-t1 - t4 + t2 + t3) * lx
    m2 = (-t1 - t2 + t3 + t4) * cy
    j1, j2, j3 = params.inertia[0], params.inertia[1], params.inertia[2]
    wd1 = (m0 - (w2 * (j3 * w3) - w3 * (j2 * w2))) / j1
    wd2 = (m1 - (w3 * (j1 * w1) - w1 * (j3 * w3))) / j2
    wd3 = (m2 - (w1 * (j2 * w2) - w2 * (j1 * w1))) / j3

    # Attitude kinematics (closed-form E^-1, rotations.py:68-84).
    tth = jnp.tan(th)
    phid = w1 + sphi * tth * w2 + cphi * tth * w3
    thd = cphi * w2 - sphi * w3
    psid = (sphi * w2 + cphi * w3) / cth

    # POC propagation: j_pos@v + j_euler@eul_dot + j_angles@alpha_dot with
    # the column-major 25-vector packing of `blaster.py::unpack_stage_params`
    # (j_angles[i,j] = P[3j+i], j_euler[i,j] = P[6+3j+i], j_pos = P[15+3j+i]).
    euld = (phid, thd, psid)
    vv = (vx, vy, vz)
    aa = (ad1, ad2)
    poc = []
    for i in range(3):
        acc = P[15 + i] * vv[0] + P[18 + i] * vv[1] + P[21 + i] * vv[2]
        acc = acc + P[6 + i] * euld[0] + P[9 + i] * euld[1] + P[12 + i] * euld[2]
        acc = acc + P[i] * aa[0] + P[3 + i] * aa[1]
        poc.append(acc)

    rows = (vx, vy, vz,
            phid, thd, psid,
            vdx, vdy, vdz,
            wd1, wd2, wd3,
            ad1, ad2,
            poc[0], poc[1], poc[2])
    # tuple-in -> tuple-out (r4): X/U/P arrive as TUPLES of rows so the
    # whole RK4+jvp stays one fused elementwise chain — a stacked return
    # here would materialize a (17, L) tensor per RK4 stage.
    return rows


def _ode_rows_dist(X, U, P, params: BlasterParams):
    """Disturbance-augmented BLASTER rows (offset-free MPC prediction
    model, `sim/scenarios.py::_disturbed_ode`): the observer's force and
    torque acceleration estimates ride in SIX EXTRA stage-parameter rows
    (P[25:28] on v_dot, P[28:31] on omega_dot) so they stay *data* — one
    compiled linearizer serves every disturbance estimate without
    recompiling."""
    Xd = _ode_rows(X, U, P, params)
    return (Xd[:6] + tuple(Xd[6 + i] + P[25 + i] for i in range(6))
            + Xd[12:])


def _quad13_rows(X, U, P, params: BlasterParams):
    """`models/quad13.py::quad13_ode` with components as rows: tuples of
    13 X rows and 4 U rows -> tuple of 13 Xdot rows; P unused. Same Hamilton-product q_dot and
    R(q)e3 thrust column as the vector form (core/rotations.py:94-118),
    written elementwise."""
    del P
    qw, qx, qy, qz = X[3], X[4], X[5], X[6]
    vx, vy, vz = X[7], X[8], X[9]
    w1, w2, w3 = X[10], X[11], X[12]
    t1, t2, t3, t4 = U[0], U[1], U[2], U[3]

    qn = jnp.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    iw, ix, iy, iz = qw / qn, qx / qn, qy / qn, qz / qn

    # R(qn) e3 — third column of quat_to_rot
    r02 = 2.0 * (ix * iz + iw * iy)
    r12 = 2.0 * (iy * iz - iw * ix)
    r22 = 2.0 * (iw * iw + iz * iz) - 1.0
    t_tot = (t1 + t2 + t3 + t4) / params.mass
    vdx = r02 * t_tot
    vdy = r12 * t_tot
    vdz = r22 * t_tot - params.gravity

    # q_dot = 0.5 q (x) [0, omega]  (Hamilton, UNnormalized q — matches
    # quad13_ode which multiplies with the raw state quaternion)
    qdw = 0.5 * (-qx * w1 - qy * w2 - qz * w3)
    qdx = 0.5 * (qw * w1 + qy * w3 - qz * w2)
    qdy = 0.5 * (qw * w2 - qx * w3 + qz * w1)
    qdz = 0.5 * (qw * w3 + qx * w2 - qy * w1)

    ly, lx, cy = (params.arm_length_y, params.arm_length_x,
                  params.yaw_coefficient)
    m0 = (t2 + t4 - t1 - t3) * ly
    m1 = (-t1 - t4 + t2 + t3) * lx
    m2 = (-t1 - t2 + t3 + t4) * cy
    j1, j2, j3 = params.inertia[0], params.inertia[1], params.inertia[2]
    wd1 = (m0 - (w2 * (j3 * w3) - w3 * (j2 * w2))) / j1
    wd2 = (m1 - (w3 * (j1 * w1) - w1 * (j3 * w3))) / j2
    wd3 = (m2 - (w1 * (j2 * w2) - w2 * (j1 * w1))) / j3

    rows = (vx, vy, vz,
            qdw, qdx, qdy, qdz,
            vdx, vdy, vdz,
            wd1, wd2, wd3)
    return rows


# Model-family registry for rows-form ODEs (r4): `fast_linearize` below
# dispatches on the family name. All three families share the same 8
# physical constants (mass, g, arms, yaw coefficient, diagonal inertia)
# packed into a BlasterParams.
FAMILIES = {
    "blaster": _ode_rows,
    "blaster_dist": _ode_rows_dist,
    "quad13": _quad13_rows,
}


def _rk4_rows(X, U, P, params, dt, num_steps, ode=_ode_rows):
    """Classic RK4 (acados ERK(4, num_steps); rows layout; num_steps is
    static and small -> plain Python unroll). X is a TUPLE of (L,) rows
    (keeps the whole chain fusion-friendly — see _ode_rows)."""
    h = dt / num_steps
    for _ in range(num_steps):
        k1 = ode(X, U, P, params)
        X2 = tuple(x + (0.5 * h) * k for x, k in zip(X, k1))
        k2 = ode(X2, U, P, params)
        X3 = tuple(x + (0.5 * h) * k for x, k in zip(X, k2))
        k3 = ode(X3, U, P, params)
        X4 = tuple(x + h * k for x, k in zip(X, k3))
        k4 = ode(X4, U, P, params)
        X = tuple(x + (h / 6.0) * (a + 2.0 * b + 2.0 * c + d)
                  for x, a, b, c, d in zip(X, k1, k2, k3, k4))
    return X


def fast_linearize(xbar: jnp.ndarray, ubar: jnp.ndarray,
                   stage_params: jnp.ndarray, params: BlasterParams,
                   dt: float, num_steps: int = 1,
                   family: str = "blaster"):
    """(x_next, A, B) for all shooting nodes — drop-in for
    `sqp/rti.py::_linearize_nodes` (same (N+1,nx)/(N,nu)/(N,np) inputs,
    same RK4 discretization, forward-mode sensitivities via one jvp).
    Dimension-generic over the rows-form `family` (FAMILIES registry).
    """
    dtype = xbar.dtype
    n = ubar.shape[0]
    nx, nu = xbar.shape[-1], ubar.shape[-1]
    np_ = stage_params.shape[-1]
    nc = nx + nu
    ode = FAMILIES[family]
    xs = xbar[:-1]

    # rows as TUPLES (r4): every operand is its own (n*nc,) vector, so
    # XLA sees one long fused elementwise chain with no stacked (nx, L)
    # materialization between RK4 stages (the stacked form was bound by
    # memory traffic at large batch).
    x_re = tuple(jnp.repeat(xs[:, j], nc) for j in range(nx))
    u_re = tuple(jnp.repeat(ubar[:, j], nc) for j in range(nu))
    p_re = tuple(jnp.repeat(stage_params[:, j], nc) for j in range(np_))
    col = jnp.tile(jnp.arange(nc), n)
    # tangent seeds tied to the data (+ 0*x): under shard_map a constant
    # seed is unvarying over the mesh axis and jvp rejects mixing it with
    # the sharded primal
    zero = 0.0 * x_re[0]
    x_du = tuple((col == j).astype(dtype) + zero for j in range(nx))
    u_du = tuple((col == nx + j).astype(dtype) + zero for j in range(nu))

    def f(xr, ur):
        return _rk4_rows(xr, ur, p_re, params, dt, num_steps, ode=ode)

    y, yd = jax.jvp(f, (x_re, u_re), (x_du, u_du))
    y = jnp.stack(y, axis=0).reshape(nx, n, nc)
    yd = jnp.stack(yd, axis=0).reshape(nx, n, nc)
    x_next = y[:, :, 0].T                               # (n, nx)
    a_mat = jnp.transpose(yd[:, :, :nx], (1, 0, 2))     # (n, nx, nx)
    b_mat = jnp.transpose(yd[:, :, nx:], (1, 0, 2))     # (n, nx, nu)
    return x_next, a_mat, b_mat


def make_fused_linearizer(ocp: cfg.OCPConfig, params: BlasterParams,
                          num_steps: int = 1, family: str = "blaster"):
    """Closure matching the `linearizer` hook of `sqp/rti.py::build_qp`."""
    def lin(xbar, ubar, stage_params):
        return fast_linearize(xbar, ubar, stage_params, params, ocp.dt,
                              num_steps, family=family)
    return lin
