"""Soft (slacked) box bounds: the acados ns>0 analog (`qp/soft.py`).

Checks: (1) stiff soft bounds reproduce the hard solution; (2) an
infeasible hard problem is gracefully relaxed with the right violation
magnitude; (3) the penalized optimum matches scipy SLSQP on the explicitly
expanded slack formulation; (4) vmap batching.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpc_blaster_tpu.qp.data import QPData, qp_objective
from mpc_blaster_tpu.qp.ipm import box_qp_solve
from mpc_blaster_tpu.qp.riccati import lqr_solve
from mpc_blaster_tpu.qp.soft import (SoftBounds, SoftPenalty,
                                     soft_box_qp_solve, soft_qp_objective)

from test_qp import random_qp


def all_hard(N, nx, nu):
    return SoftBounds(lx=SoftPenalty.hard((N, nx)),
                      ux=SoftPenalty.hard((N, nx)),
                      lu=SoftPenalty.hard((N, nu)),
                      uu=SoftPenalty.hard((N, nu)))


def bind_controls(data, frac=0.4):
    free = lqr_solve(data)
    lim = frac * float(jnp.max(jnp.abs(free.du)))
    return data._replace(lbu=jnp.full_like(data.lbu, -lim),
                         ubu=jnp.full_like(data.ubu, lim),
                         lbx=jnp.full_like(data.lbx, -5.0),
                         ubx=jnp.full_like(data.ubx, 5.0))


def test_all_hard_matches_box_qp():
    data = bind_controls(random_qp(seed=3))
    soft = all_hard(data.horizon, data.nx, data.nu)
    res = soft_box_qp_solve(data, soft, iters=30)
    ref = box_qp_solve(data, iters=30)
    np.testing.assert_allclose(np.asarray(res.sol.du), np.asarray(ref.du),
                               atol=5e-6)
    assert float(jnp.max(res.t_lx)) == 0.0 and float(jnp.max(res.t_uu)) == 0.0


def test_stiff_soft_matches_hard():
    data = bind_controls(random_qp(seed=4))
    N, nx, nu = data.horizon, data.nx, data.nu
    soft = SoftBounds.state_bounds(N, nx, nu, Zl=1e6, zl=1e3, dtype=data.A.dtype)
    res = soft_box_qp_solve(data, soft, iters=30)
    ref = box_qp_solve(data, iters=30)
    # With huge penalties and a feasible hard problem, violations vanish and
    # the solutions coincide.
    assert float(jnp.max(res.t_lx)) < 1e-5
    assert float(jnp.max(res.t_ux)) < 1e-5
    np.testing.assert_allclose(np.asarray(res.sol.du), np.asarray(ref.du),
                               atol=2e-4)


def test_infeasible_hard_problem_relaxed():
    """State bounds the dynamics cannot satisfy: x0 far outside a tight box
    with weak controls. The soft solve stays finite and reports the
    violation; lam saturates at z + Z t (the soft-penalty gradient)."""
    data = random_qp(N=6, nx=4, nu=2, seed=7)
    big_x0 = jnp.full((4,), 3.0, data.A.dtype)
    data = data._replace(
        dx0=big_x0,
        lbx=jnp.full_like(data.lbx, -0.5),
        ubx=jnp.full_like(data.ubx, 0.5),
        lbu=jnp.full_like(data.lbu, -0.2),
        ubu=jnp.full_like(data.ubu, 0.2),
    )
    Z, z = 10.0, 1.0
    soft = SoftBounds.state_bounds(6, 4, 2, Zl=Z, zl=z, dtype=data.A.dtype)
    res = soft_box_qp_solve(data, soft, iters=40)
    sol = res.sol
    assert np.isfinite(np.asarray(sol.dx)).all()
    assert float(sol.kkt_eq) < 1e-6
    # stage-1 state is pinned near A x0 (controls too weak): upper bound 0.5
    # must be violated, and the reported t must equal the actual violation.
    viol = np.maximum(np.asarray(sol.dx[1:]) - 0.5, 0.0)
    assert viol.max() > 0.5
    np.testing.assert_allclose(np.asarray(res.t_ux), viol, atol=1e-4)
    # dual of a violated soft bound = penalty slope z + Z t
    k, i = np.unravel_index(viol.argmax(), viol.shape)
    lam = float(np.asarray(sol.lam_ux)[k, i])
    assert lam == pytest.approx(z + Z * viol[k, i], rel=1e-3)


def test_soft_matches_scipy_expanded():
    from scipy.optimize import LinearConstraint, minimize
    data = random_qp(N=4, nx=3, nu=2, seed=5)
    free = lqr_solve(data)
    lim = 0.5 * float(jnp.max(jnp.abs(free.du)))
    # Tight state box that WILL be violated at the penalized optimum.
    data = data._replace(lbu=jnp.full_like(data.lbu, -lim),
                         ubu=jnp.full_like(data.ubu, lim),
                         lbx=jnp.full_like(data.lbx, -0.15),
                         ubx=jnp.full_like(data.ubx, 0.15))
    Z, zlin = 5.0, 0.5
    soft = SoftBounds.state_bounds(4, 3, 2, Zl=Z, zl=zlin, dtype=data.A.dtype)
    res = soft_box_qp_solve(data, soft, iters=40)
    ours = float(soft_qp_objective(data, soft, res.sol.dx, res.sol.du))

    # Expanded reference: z = [dx, du, tl, tu]; SLSQP.
    N, nx, nu = 4, 3, 2
    nxs = (N + 1) * nx
    nus = N * nu
    nts = N * nx
    nz = nxs + nus + 2 * nts

    def unpack(zv):
        dx = zv[:nxs].reshape(N + 1, nx)
        du = zv[nxs:nxs + nus].reshape(N, nu)
        tl = zv[nxs + nus:nxs + nus + nts].reshape(N, nx)
        tu = zv[nxs + nus + nts:].reshape(N, nx)
        return dx, du, tl, tu

    def obj(zv):
        dx, du, tl, tu = unpack(zv)
        base = float(qp_objective(data, jnp.asarray(dx), jnp.asarray(du)))
        pen = (zlin * (tl + tu) + 0.5 * Z * (tl ** 2 + tu ** 2)).sum()
        return base + pen

    # Equalities: pinned x0 + dynamics.
    E = np.zeros((nxs, nz)); h = np.zeros(nxs)
    E[:nx, :nx] = np.eye(nx); h[:nx] = np.asarray(data.dx0)
    for k in range(N):
        row = (k + 1) * nx
        E[row:row + nx, (k + 1) * nx:(k + 2) * nx] = np.eye(nx)
        E[row:row + nx, k * nx:(k + 1) * nx] = -np.asarray(data.A[k])
        E[row:row + nx, nxs + k * nu:nxs + (k + 1) * nu] = -np.asarray(data.B[k])
        h[row:row + nx] = np.asarray(data.c[k])
    cons = [LinearConstraint(E, h, h)]
    # Soft state bounds: dx_k + tl_k >= lbx ; dx_k - tu_k <= ubx (stages 1..N)
    G = np.zeros((2 * nts, nz))
    glo = np.zeros(2 * nts); ghi = np.full(2 * nts, np.inf)
    for k in range(N):
        for i in range(nx):
            r1 = k * nx + i
            G[r1, (k + 1) * nx + i] = 1.0
            G[r1, nxs + nus + k * nx + i] = 1.0
            glo[r1] = -0.15
            r2 = nts + k * nx + i
            G[r2, (k + 1) * nx + i] = -1.0
            G[r2, nxs + nus + nts + k * nx + i] = 1.0
            glo[r2] = -0.15
    cons.append(LinearConstraint(G, glo, ghi))
    lb = np.r_[np.full(nxs, -np.inf), np.full(nus, -lim), np.zeros(2 * nts)]
    ub = np.r_[np.full(nxs, np.inf), np.full(nus, lim), np.full(2 * nts, np.inf)]
    z0 = np.zeros(nz); z0[:nx] = np.asarray(data.dx0)
    ref = minimize(obj, z0, method="SLSQP", bounds=list(zip(lb, ub)),
                   constraints=cons, options={"maxiter": 800, "ftol": 1e-12})
    assert ref.success
    assert ours == pytest.approx(ref.fun, abs=1e-5, rel=1e-6)
    # some violation must actually occur (the test is vacuous otherwise)
    assert float(jnp.max(res.t_lx) + jnp.max(res.t_ux)) > 1e-3


def test_soft_vmap_batch():
    datas = [bind_controls(random_qp(N=5, nx=4, nu=2, seed=s), frac=0.3)
             for s in range(3)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)
    soft = SoftBounds.state_bounds(5, 4, 2, Zl=100.0, zl=1.0,
                                   dtype=datas[0].A.dtype)
    batched = jax.jit(jax.vmap(lambda d: soft_box_qp_solve(d, soft, iters=20)))
    out = batched(stacked)
    ref_fn = jax.jit(lambda d: soft_box_qp_solve(d, soft, iters=20))
    for i, d in enumerate(datas):
        ref = ref_fn(d)
        np.testing.assert_allclose(np.asarray(out.sol.du[i]),
                                   np.asarray(ref.sol.du), atol=1e-8)


def test_rti_step_soft_out_of_box_state():
    """Disturbance pushes the vehicle outside the ±1.5 m position box
    (`simulation_blaster.py:28-30`): the soft-bounded RTI tick stays finite,
    reports the violation, and still commands thrust toward the box."""
    from mpc_blaster_tpu import config as cfg
    from mpc_blaster_tpu.dynamics.blaster import BlasterParams, blaster_ode
    from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu.ocp.spec import build_spec
    from mpc_blaster_tpu.sqp.rti import init_rti_state, rti_step_soft

    DTYPE = jnp.float64
    preset = cfg.simulation_preset()
    ocp = preset.ocp
    x0 = np.zeros(cfg.NX)
    x0[0] = 2.4   # 0.9 m outside the x box
    x0[2] = 2.0
    yref = np.zeros(cfg.NY)
    yref[2] = 2.0
    spec = build_spec(ocp, yref=yref, dtype=DTYPE)
    x0 = jnp.asarray(x0, DTYPE)
    params = BlasterParams.from_config(ocp.model, DTYPE)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    state = init_rti_state(ocp, x0, DTYPE)

    soft = SoftBounds.state_bounds(ocp.N, cfg.NX, cfg.NU, Zl=1e3, zl=1e2,
                                   dtype=DTYPE)
    step = jax.jit(lambda sp, st, x, so: rti_step_soft(sp, st, x, params,
                                                       F, ocp.solver, so))
    u0 = None
    for _ in range(6):
        u0, state, diag, res = step(spec, state, x0, soft)
    assert np.isfinite(np.asarray(u0)).all()
    assert float(diag.qp_kkt_eq) < 1e-5
    # early-horizon x positions cannot re-enter the box instantly: the upper
    # x bound must be (softly) violated at stage 1
    assert float(res.t_ux[0, 0]) > 0.5
    # late in the horizon the plan returns inside the box
    assert float(jnp.max(res.t_ux[-10:, 0])) < 0.2
