"""Partial condensing — the HPIPM `qp_solver_cond_N` capability.

The reference selects `PARTIAL_CONDENSING_HPIPM` with `cond_N = N`
(`blastermodel.py:274,284`), i.e. the machinery is wired but no condensing
is actually applied (SURVEY.md §5 "long-context" row). Here the machinery
is real: blocks of M consecutive stages are condensed into one stage of a
shorter OCP QP with horizon Nc = N/M and control dimension M·nu, and the
condensed QP is solved by the same Mehrotra IPM + Riccati (now with cost
cross terms S, `riccati.py`).

Why this trade: the Riccati recursion is inherently sequential in the
horizon, so the XLA QP path is a chain of small fused ops, which risks
being bound by latency rather than arithmetic. Condensing divides the
sequential chain length by M while turning the per-stage work into denser
matmuls (M·nu-square H_uu, (M-1)·nx-row constraint maps). The block maps themselves are built *in parallel
across blocks* (vmap over Nc; the i-recursion inside a block is unrolled —
M is small and static).

Structure of one condensed stage j (block of stages k = jM .. jM+M-1):

    x_{jM+i} = Phi_i X_j + Gamma_i U_j + d_i,  i = 0..M
    (Phi_0 = I, Gamma_0 = 0, d_0 = 0; Abar = Phi_M etc.)

- condensed cost: exact substitution (cross term S_j = Gamma' Q Phi);
- CAVEAT (inherent to condensing, not this implementation): the block maps
  amplify conditioning by the block state-transition gain ||A_jM..A_jM+M||.
  For physical MPC dynamics discretized at control rate (blaster: A ~ I,
  spectral radius ~1) this is benign; for strongly unstable systems
  (rho(A) >> 1) prefer the full-horizon Riccati backend, whose backward
  recursion is unconditionally stable;
- boundary states X_j keep their box bounds;
- interior state boxes become two-sided *general* constraints
  lbx <= Phi_i X_j + Gamma_i U_j + d_i <= ubx, handled in the IPM with the
  standard barrier algebra: their curvature lands as G' diag(sigma) G dense
  updates on the condensed stage Hessian blocks.

Validated scope: f64 and f32, single solves AND closed loops (including
cold transients with violated interior-state rows). f32 needs, in order
of discovery: the row/column equilibrations below (without them the
11-decade H_uu spread of the blaster cost is unsolvable in f32), scale-
meaningful general-constraint slack initialization (see init_pair), and —
decisively — the square-root array-form Riccati Newton core
(qp/sqrt_riccati.py, default for f32 via the `sqrt` flag): the plain
recursion's dense-barrier squaring conditions past 1/eps_f32 whenever
interior state bounds are active, and no equilibration can fix stiffness
that is not axis-aligned. Measured on the sim-preset transient QP: plain
f32 max control error 16.6 (solver diverged in closed loop by 0.2 m at
tick one); sqrt f32 0.29 with the objective 0.12% off f64; f32 figure-8
closed loop at cond_M=5 settles to 0.0301 m vs 0.0297 m in f64. HPIPM
itself is double-precision only; this backend exceeds that boundary.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpc_blaster_tpu.qp.data import QPData, QPSolution, full_precision
from mpc_blaster_tpu.qp.riccati import riccati_factorize, riccati_solve_rhs

_BIG = 1e20


class CondensedQP(NamedTuple):
    """The condensed OCP QP + the block maps needed for expansion.

    Shapes (Nc condensed stages, nx, nU = M*nu, ng = (M-1)*nx):
      Abar (Nc, nx, nx); Bbar (Nc, nx, nU); cbar (Nc, nx)
      Qbar (Nc+1, nx, nx); qbar (Nc+1, nx); Rbar (Nc, nU, nU);
      rbar (Nc, nU); Sbar (Nc, nU, nx)
      lbX/ubX (Nc+1, nx) boundary-state boxes (row 0 unused: X_0 pinned)
      lbU/ubU (Nc, nU)
      Gx (Nc, ng, nx); Gu (Nc, ng, nU); goff (Nc, ng); lbg/ubg (Nc, ng)
      gscale (Nc, ng): row-equilibration factors (duals unscale by gscale)
      uscale (Nc, nU): control-column equilibration (dU_real = uscale*dU;
          Gamma/Bbar/Rbar/Sbar/rbar/lbU/ubU/Gu stored pre-scaled)
      Phi (Nc, M, nx, nx); Gamma (Nc, M, nx, nU); dvec (Nc, M, nx)
      dx0 (nx,)
      Crows (Nc, M*(nx+nu), nU+nx): stage-cost ROW FACTORS, columns
          ordered [U | X], with Crows' Crows = [[Rbar, Sbar],
          [Sbar', Qbar_stage]] (scaled-U space) — the square-root
          backend's Gram-free stage cost (qp/sqrt_riccati.py)
    """

    Abar: jnp.ndarray
    Bbar: jnp.ndarray
    cbar: jnp.ndarray
    Qbar: jnp.ndarray
    qbar: jnp.ndarray
    Rbar: jnp.ndarray
    rbar: jnp.ndarray
    Sbar: jnp.ndarray
    lbX: jnp.ndarray
    ubX: jnp.ndarray
    lbU: jnp.ndarray
    ubU: jnp.ndarray
    Gx: jnp.ndarray
    Gu: jnp.ndarray
    goff: jnp.ndarray
    lbg: jnp.ndarray
    ubg: jnp.ndarray
    gscale: jnp.ndarray
    uscale: jnp.ndarray
    Phi: jnp.ndarray
    Gamma: jnp.ndarray
    dvec: jnp.ndarray
    dx0: jnp.ndarray
    Crows: jnp.ndarray

    @property
    def ncond(self) -> int:
        return self.Abar.shape[-3]

    @property
    def block(self) -> int:
        return self.Phi.shape[-3]


def condense(data: QPData, M: int) -> CondensedQP:
    """Condense blocks of M stages (N % M == 0). All-block-parallel."""
    N, nx, nu = data.horizon, data.nx, data.nu
    if N % M != 0:
        raise ValueError(f"horizon {N} not divisible by block size {M}")
    Nc = N // M
    nU = M * nu
    dtype = data.A.dtype

    A = data.A.reshape(Nc, M, nx, nx)
    B = data.B.reshape(Nc, M, nx, nu)
    c = data.c.reshape(Nc, M, nx)
    Q = data.Q[:-1].reshape(Nc, M, nx, nx)
    q = data.q[:-1].reshape(Nc, M, nx)
    R = data.R.reshape(Nc, M, nu, nu)
    r = data.r.reshape(Nc, M, nu)

    # Block maps, unrolled over the in-block index i (static, small),
    # vectorized over all Nc blocks at once.
    Phi_i = jnp.broadcast_to(jnp.eye(nx, dtype=dtype), (Nc, nx, nx))
    Gam_i = jnp.zeros((Nc, nx, nU), dtype)
    d_i = jnp.zeros((Nc, nx), dtype)
    Phis, Gams, ds = [Phi_i], [Gam_i], [d_i]
    for i in range(M):
        Phi_i = A[:, i] @ Phi_i
        Gam_i = (A[:, i] @ Gam_i).at[:, :, i * nu:(i + 1) * nu].add(B[:, i])
        d_i = jnp.einsum("cij,cj->ci", A[:, i], d_i) + c[:, i]
        Phis.append(Phi_i)
        Gams.append(Gam_i)
        ds.append(d_i)
    Phi = jnp.stack(Phis[:M], axis=1)     # (Nc, M, nx, nx), i = 0..M-1
    Gamma = jnp.stack(Gams[:M], axis=1)   # (Nc, M, nx, nU)
    dvec = jnp.stack(ds[:M], axis=1)      # (Nc, M, nx)

    # Condensed cost (exact substitution; constants dropped).
    Qbar_stage = jnp.einsum("cmji,cmjk,cmkl->cil", Phi, Q, Phi)
    Sbar = jnp.einsum("cmji,cmjk,cmkl->cil", Gamma, Q, Phi)   # (Nc, nU, nx)
    Rcross = jnp.einsum("cmji,cmjk,cmkl->cil", Gamma, Q, Gamma)
    Rblk = jnp.zeros((Nc, nU, nU), dtype)
    for i in range(M):
        Rblk = Rblk.at[:, i * nu:(i + 1) * nu, i * nu:(i + 1) * nu] \
            .set(R[:, i])
    Rbar = Rblk + Rcross
    qd = jnp.einsum("cmij,cmj->cmi", Q, dvec) + q
    qbar_stage = jnp.einsum("cmji,cmj->ci", Phi, qd)
    rbar = r.reshape(Nc, nU) + jnp.einsum("cmji,cmj->ci", Gamma, qd)
    Qbar = jnp.concatenate([Qbar_stage, data.Q[-1][None]], axis=0)
    qbar = jnp.concatenate([qbar_stage, data.q[-1][None]], axis=0)

    # Interior state boxes -> general constraints (i = 1..M-1), row-
    # equilibrated: each row of [Gx | Gu] is scaled to unit norm (bounds and
    # offsets scaled along). Unscaled rows give the IPM barrier weights
    # sigma ~ lam/s spread by ||row||^2 across rows, which wrecks the f32
    # Cholesky of the dense G' diag(sigma) G blocks; with unit rows the
    # sigma spread reflects only activity, the classic Ruiz cure.
    ng = (M - 1) * nx
    Gx = Phi[:, 1:].reshape(Nc, ng, nx)
    Gu = Gamma[:, 1:].reshape(Nc, ng, nU)
    goff = dvec[:, 1:].reshape(Nc, ng)
    lbg = data.lbx[:-1].reshape(Nc, M, nx)[:, 1:].reshape(Nc, ng)
    ubg = data.ubx[:-1].reshape(Nc, M, nx)[:, 1:].reshape(Nc, ng)
    rownorm = jnp.sqrt(jnp.sum(Gx * Gx, axis=-1)
                       + jnp.sum(Gu * Gu, axis=-1))
    rscale = 1.0 / jnp.maximum(rownorm, 1e-8)          # (Nc, ng)
    Gx = Gx * rscale[..., None]
    Gu = Gu * rscale[..., None]
    goff = goff * rscale
    # +-inf bounds stay +-inf under positive scaling
    lbg = lbg * rscale
    ubg = ubg * rscale

    Abar, Bbar, cbar = Phis[M], Gams[M], ds[M]

    # Control-column equilibration. The blaster cost leaves the gimbal
    # chain ~flat (R_swivel = 1e-5, `simulation_blaster.py:27`) while the
    # condensed couplings reach ~1e4, so H_uu spans ~11 decades — f32
    # cannot factor that (the first Newton direction is garbage and the
    # IPM never moves; measured on the sim-preset transient). Scaling
    # dU_i by 1/sqrt of an a-priori curvature estimate
    #   h_i = Rbar_ii + sum_c Bbar_ci^2 Qdiag_{j+1,c}
    # puts H_uu's diagonal at O(1); the solve runs in scaled space and
    # `expand`/dual-scatter undo it (uscale field).
    Qdiag_next = jnp.diagonal(Qbar[1:], axis1=-2, axis2=-1)   # (Nc, nx)
    h = (jnp.diagonal(Rbar, axis1=-2, axis2=-1)
         + jnp.einsum("cji,cj->ci", Bbar ** 2, Qdiag_next))
    uscale = 1.0 / jnp.sqrt(jnp.maximum(h, 1e-12))            # (Nc, nU)
    Bbar = Bbar * uscale[:, None, :]
    Rbar = Rbar * uscale[:, :, None] * uscale[:, None, :]
    Sbar = Sbar * uscale[:, :, None]
    rbar = rbar * uscale
    Gu = Gu * uscale[:, None, :]
    Gamma_s = Gamma * uscale[:, None, None, :]
    lbU = data.lbu.reshape(Nc, nU) / uscale
    ubU = data.ubu.reshape(Nc, nU) / uscale

    # Stage-cost row factors for the square-root backend: every row is an
    # ORIGINAL fine-stage cost factor pushed through the block maps, so
    # the Gram [[Rbar, Sbar], [Sbar', Qbar_stage]] is represented without
    # ever being formed (no squaring -> f32-stable, qp/sqrt_riccati.py).
    #   fine Q_m rows: Lq_m' [Gamma_m | Phi_m]   (Q_m = Lq_m Lq_m')
    #   fine R_m rows: Lr_m' into column block m (uscale-scaled)
    from mpc_blaster_tpu.qp.smallalg import chol_factor
    Lq = chol_factor(Q)                           # (Nc, M, nx, nx) lower
    GP = jnp.concatenate([Gamma_s, jnp.broadcast_to(
        Phi, (Nc, M, nx, nx))], axis=-1)          # (Nc, M, nx, nU+nx)
    Qrows = jnp.einsum("cmki,cmkj->cmij", Lq, GP).reshape(
        Nc, M * nx, nU + nx)
    Lr = chol_factor(R)                           # (Nc, M, nu, nu) lower
    Rrows = jnp.zeros((Nc, M, nu, nU + nx), dtype)
    for i in range(M):
        blk = jnp.swapaxes(Lr[:, i], -1, -2) \
            * uscale[:, None, i * nu:(i + 1) * nu]
        Rrows = Rrows.at[:, i, :, i * nu:(i + 1) * nu].set(blk)
    Crows = jnp.concatenate([Qrows, Rrows.reshape(Nc, M * nu, nU + nx)],
                            axis=-2)

    return CondensedQP(
        Abar=Abar, Bbar=Bbar, cbar=cbar,
        Qbar=Qbar, qbar=qbar, Rbar=Rbar, rbar=rbar, Sbar=Sbar,
        lbX=data.lbx[::M], ubX=data.ubx[::M],
        lbU=lbU, ubU=ubU,
        Gx=Gx, Gu=Gu, goff=goff, lbg=lbg, ubg=ubg, gscale=rscale,
        uscale=uscale,
        Phi=Phi, Gamma=Gamma_s, dvec=dvec, dx0=data.dx0,
        Crows=Crows,
    )


def expand(cqp: CondensedQP, dX: jnp.ndarray, dU: jnp.ndarray):
    """Recover the full trajectory from condensed decision variables.

    dX: (Nc+1, nx) boundary states; dU: (Nc, nU). Returns
    (dx (N+1, nx), du (N, nu)) with the interior states reconstructed from
    the block maps (exactly dynamics-consistent by construction).
    """
    Nc, M = cqp.ncond, cqp.block
    nx = cqp.Abar.shape[-1]
    nu = cqp.Bbar.shape[-1] // M
    dx_blocks = (jnp.einsum("cmij,cj->cmi", cqp.Phi, dX[:-1])
                 + jnp.einsum("cmij,cj->cmi", cqp.Gamma, dU) + cqp.dvec)
    dx = jnp.concatenate([dx_blocks.reshape(Nc * M, nx), dX[-1][None]],
                         axis=0)
    return dx, (dU * cqp.uscale).reshape(Nc * M, nu)


class _CGS(NamedTuple):
    """Condensed-IPM state: boundary-X / U / general slack-dual pairs."""

    dX: jnp.ndarray
    dU: jnp.ndarray
    s_lX: jnp.ndarray
    s_uX: jnp.ndarray
    lam_lX: jnp.ndarray
    lam_uX: jnp.ndarray
    s_lU: jnp.ndarray
    s_uU: jnp.ndarray
    lam_lU: jnp.ndarray
    lam_uU: jnp.ndarray
    s_lg: jnp.ndarray
    s_ug: jnp.ndarray
    lam_lg: jnp.ndarray
    lam_ug: jnp.ndarray


@full_precision
def condensed_qp_solve(data: QPData, M: int, iters: int = 12,
                       mu0: float = 1e-1, alpha_frac: float = 0.995,
                       reg: float = 1e-9, s_min: float = 1e-3,
                       mu_min: float = 1e-12, refine: int = 1,
                       sqrt: bool | None = None) -> QPSolution:
    """Solve the OCP QP via partial condensing with block size M.

    Drop-in alternative to `box_qp_solve` (same QPData in, same QPSolution
    out, duals re-scattered to per-stage shape). Full-precision matmuls for
    the same reason as everywhere else in the QP stack.

    sqrt: use the square-root (array-form QR) Riccati Newton core
    (qp/sqrt_riccati.py). None (default) = on for <=32-bit dtypes, where
    the plain recursion's dense barrier squaring is unsolvable (its
    condition exceeds 1/eps_f32 whenever interior state bounds are
    active/violated — measured on the sim-preset transient); off for f64,
    where the plain path is accurate and cheaper.
    """
    cqp = condense(data, M)
    return _csolve(cqp, data, iters, mu0, alpha_frac, reg, s_min,
                   mu_min, refine, sqrt)


def _csolve(cqp: CondensedQP, data: QPData, iters, mu0, alpha_frac, reg,
            s_min, mu_min, refine=1, sqrt=None):
    Nc, M = cqp.ncond, cqp.block
    nx = cqp.Abar.shape[-1]
    nU = cqp.Bbar.shape[-1]
    dtype = cqp.Abar.dtype
    if sqrt is None:
        sqrt = jnp.finfo(dtype).bits <= 32
    if jnp.finfo(dtype).bits <= 32:
        mu_min = max(mu_min, 1e-7)
        reg = max(reg, 1e-6)
        sigma_max = 1e7
        lam_max = 1e7
    else:
        sigma_max = 1e14
        lam_max = 1e14

    mask_lX = jnp.isfinite(cqp.lbX[1:])
    mask_uX = jnp.isfinite(cqp.ubX[1:])
    mask_lU = jnp.isfinite(cqp.lbU)
    mask_uU = jnp.isfinite(cqp.ubU)
    mask_lg = jnp.isfinite(cqp.lbg)
    mask_ug = jnp.isfinite(cqp.ubg)

    # ----- init: rollout + clamp boundary/controls into their boxes -----
    dU0 = cqp.rbar * 0

    def roll(dX, inp):
        A_k, B_k, c_k, dU_k = inp
        nxt = A_k @ dX + B_k @ dU_k + c_k
        return nxt, nxt
    _, dX_tail = jax.lax.scan(roll, cqp.dx0,
                              (cqp.Abar, cqp.Bbar, cqp.cbar, dU0))

    def clamp_into(v, lb, ub, mask_l, mask_u):
        width = jnp.where(mask_l & mask_u, ub - lb, 1.0)
        inset = 0.1 * width
        lo = jnp.where(mask_l, lb + inset, -_BIG)
        hi = jnp.where(mask_u, ub - inset, _BIG)
        return jnp.clip(v, lo, jnp.maximum(hi, lo))

    dX_tail = clamp_into(dX_tail, cqp.lbX[1:], cqp.ubX[1:], mask_lX, mask_uX)
    dU0 = clamp_into(dU0, cqp.lbU, cqp.ubU, mask_lU, mask_uU)
    dX0_traj = jnp.concatenate([cqp.dx0[None], dX_tail], axis=0)

    def gvals(dX, dU):
        """General-constraint values per condensed stage (uses the block
        START state, rows 0..Nc-1 — including the pinned dX_0)."""
        return (jnp.einsum("cgi,ci->cg", cqp.Gx, dX[:-1])
                + jnp.einsum("cgi,ci->cg", cqp.Gu, dU) + cqp.goff)

    def init_pair(gap, mask, floor=s_min):
        s = jnp.where(mask, jnp.maximum(gap, floor), _BIG)
        lam = jnp.where(mask, mu0 / s, 0.0).astype(dtype)
        return s, lam

    # General-constraint slacks start at >= 0.1 (rows are unit-normalized
    # by gscale, so 0.1 is scale-meaningful) rather than the tiny s_min:
    # this is an infeasible-start IPM, so s != gap is absorbed by the
    # slack residual. With violated interior-state rows clamped to
    # s = 1e-3 the first-iteration barrier puts sigma ~ mu0/s^2 = 1e5 on
    # DENSE (non-axis) directions of G' sigma G; the equilibrated
    # condensed Newton system then conditions at ~3e8, past f32, and the
    # very first direction came out 170% wrong (measured; axis-aligned
    # box sigmas of the same size are harmless — Jacobi equilibration
    # absorbs diagonal spread, not stiff cross-coupling). Floored at 0.1
    # the same direction is 8e-5 accurate and the f32 solve converges.
    v_g0 = gvals(dX0_traj, dU0)
    s_lX, lam_lX = init_pair(dX0_traj[1:] - cqp.lbX[1:], mask_lX)
    s_uX, lam_uX = init_pair(cqp.ubX[1:] - dX0_traj[1:], mask_uX)
    s_lU, lam_lU = init_pair(dU0 - cqp.lbU, mask_lU)
    s_uU, lam_uU = init_pair(cqp.ubU - dU0, mask_uU)
    s_lg, lam_lg = init_pair(v_g0 - cqp.lbg, mask_lg, 0.1)
    s_ug, lam_ug = init_pair(cqp.ubg - v_g0, mask_ug, 0.1)

    st0 = _CGS(dX=dX0_traj, dU=dU0,
               s_lX=s_lX, s_uX=s_uX, lam_lX=lam_lX, lam_uX=lam_uX,
               s_lU=s_lU, s_uU=s_uU, lam_lU=lam_lU, lam_uU=lam_uU,
               s_lg=s_lg, s_ug=s_ug, lam_lg=lam_lg, lam_ug=lam_ug)

    n_ineq = (jnp.sum(mask_lX) + jnp.sum(mask_uX) + jnp.sum(mask_lU)
              + jnp.sum(mask_uU) + jnp.sum(mask_lg) + jnp.sum(mask_ug))
    n_ineq = jnp.maximum(n_ineq.astype(dtype), 1.0)
    eye_x = jnp.eye(nx, dtype=dtype)
    eye_U = jnp.eye(nU, dtype=dtype)
    dX0_zero = cqp.dx0 * 0

    def comp_sum(st):
        return (jnp.sum(jnp.where(mask_lX, st.s_lX * st.lam_lX, 0.0))
                + jnp.sum(jnp.where(mask_uX, st.s_uX * st.lam_uX, 0.0))
                + jnp.sum(jnp.where(mask_lU, st.s_lU * st.lam_lU, 0.0))
                + jnp.sum(jnp.where(mask_uU, st.s_uU * st.lam_uU, 0.0))
                + jnp.sum(jnp.where(mask_lg, st.s_lg * st.lam_lg, 0.0))
                + jnp.sum(jnp.where(mask_ug, st.s_ug * st.lam_ug, 0.0)))

    def max_step(v, dv, mask, tau):
        if v.size == 0:  # M=1: no interior stages, ng == 0
            return jnp.asarray(jnp.inf, dtype)
        ratio = jnp.where(mask & (dv < 0),
                          -tau * v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.min(ratio)

    def iteration(st: _CGS):
        mu_cur = comp_sum(st) / n_ineq
        v_g = gvals(st.dX, st.dU)

        # slack residuals (infeasible start)
        r_slX = jnp.where(mask_lX, st.s_lX - (st.dX[1:] - cqp.lbX[1:]), 0.0)
        r_suX = jnp.where(mask_uX, st.s_uX - (cqp.ubX[1:] - st.dX[1:]), 0.0)
        r_slU = jnp.where(mask_lU, st.s_lU - (st.dU - cqp.lbU), 0.0)
        r_suU = jnp.where(mask_uU, st.s_uU - (cqp.ubU - st.dU), 0.0)
        r_slg = jnp.where(mask_lg, st.s_lg - (v_g - cqp.lbg), 0.0)
        r_sug = jnp.where(mask_ug, st.s_ug - (cqp.ubg - v_g), 0.0)

        sig_X = (jnp.where(mask_lX, st.lam_lX / st.s_lX, 0.0)
                 + jnp.where(mask_uX, st.lam_uX / st.s_uX, 0.0))
        sig_U = (jnp.where(mask_lU, st.lam_lU / st.s_lU, 0.0)
                 + jnp.where(mask_uU, st.lam_uU / st.s_uU, 0.0))
        sig_g = (jnp.where(mask_lg, st.lam_lg / st.s_lg, 0.0)
                 + jnp.where(mask_ug, st.lam_ug / st.s_ug, 0.0))
        sig_X = jnp.minimum(sig_X, sigma_max)
        sig_U = jnp.minimum(sig_U, sigma_max)
        sig_g = jnp.minimum(sig_g, sigma_max)

        # Stage Hessian updates. Box sigmas are diagonal; the general
        # (interior-state) sigmas land as dense G' diag(sig) G blocks —
        # batched matmuls over Nc stages.
        GxS = cqp.Gx * sig_g[:, :, None]          # (Nc, ng, nx)
        Qmod = cqp.Qbar.at[1:].add(sig_X[:, :, None] * eye_x[None])
        Qmod = Qmod.at[:-1].add(jnp.einsum("cgi,cgj->cij", GxS, cqp.Gx))
        Rmod = (cqp.Rbar + sig_U[:, :, None] * eye_U[None]
                + jnp.einsum("cgi,cgj->cij", cqp.Gu * sig_g[:, :, None],
                             cqp.Gu))
        Smod = cqp.Sbar + jnp.einsum("cgi,cgj->cij",
                                     cqp.Gu * sig_g[:, :, None], cqp.Gx)
        if sqrt:
            # Square-root Newton core: stack barrier rows onto the stored
            # cost row factors — the modified Hessians above are still
            # formed (cheap) but used only for residual EVALUATION
            # (refine, merit), never factored.
            from mpc_blaster_tpu.qp.sqrt_riccati import (sqrt_factorize,
                                                         sqrt_solve_rhs)
            from mpc_blaster_tpu.qp.smallalg import chol_factor
            rowsU = jnp.concatenate(
                [jnp.sqrt(sig_U + reg)[..., None] * eye_U[None],
                 jnp.zeros((Nc, nU, nx), dtype)], axis=-1)
            # sig_X applies to stages 1..Nc; stage k's cost carries
            # sig_X[k-1] (k=0's state is pinned), the terminal sig_X[-1]
            # goes into Z_N below.
            sigX_stage = jnp.concatenate(
                [jnp.zeros((1, nx), dtype), sig_X[:-1]], axis=0)
            rowsX = jnp.concatenate(
                [jnp.zeros((Nc, nx, nU), dtype),
                 jnp.sqrt(sigX_stage)[..., None] * eye_x[None]], axis=-1)
            rowsG = jnp.sqrt(sig_g)[..., None] * jnp.concatenate(
                [cqp.Gu, cqp.Gx], axis=-1)
            C = jnp.concatenate([cqp.Crows, rowsU, rowsX, rowsG], axis=-2)
            ZN = jnp.swapaxes(chol_factor(Qmod[-1]), -1, -2)
            fac = sqrt_factorize(cqp.Abar, cqp.Bbar, C, ZN)

            def solve_rhs_fn(c_, q_, r_):
                return sqrt_solve_rhs(fac, cqp.Abar, cqp.Bbar, c_, q_, r_,
                                      dX0_zero)
        else:
            fac = riccati_factorize(cqp.Abar, cqp.Bbar, Qmod, Rmod, reg,
                                    S=Smod)

            def solve_rhs_fn(c_, q_, r_):
                return riccati_solve_rhs(fac, cqp.Abar, cqp.Bbar, c_, q_,
                                         r_, dX0_zero)

        gX_full = (jnp.einsum("cij,cj->ci", cqp.Qbar, st.dX) + cqp.qbar)
        gX_full = gX_full.at[:-1].add(
            jnp.einsum("cji,cj->ci", cqp.Sbar, st.dU))
        gU_full = (jnp.einsum("cij,cj->ci", cqp.Rbar, st.dU) + cqp.rbar
                   + jnp.einsum("cij,cj->ci", cqp.Sbar, st.dX[:-1]))
        r_eq = (cqp.cbar
                + jnp.einsum("cij,cj->ci", cqp.Abar, st.dX[:-1])
                + jnp.einsum("cij,cj->ci", cqp.Bbar, st.dU)
                - st.dX[1:])

        def rhs_grads(T_lX, T_uX, T_lU, T_uU, T_lg, T_ug):
            # lam/s and T/s factors capped at sigma_max, exactly like the
            # full-horizon IPM (qp/ipm.py): with slacks at the eps floor
            # these divides overflow f32 and poison the RHS.
            def slam(lam, s):
                return jnp.minimum(lam / s, sigma_max)

            def cdiv(T, s):
                return jnp.clip(T / s, -sigma_max, sigma_max)

            bX = (- jnp.where(mask_lX, cdiv(T_lX, st.s_lX), 0.0)
                  - jnp.where(mask_lX, slam(st.lam_lX, st.s_lX), 0.0) * r_slX
                  + jnp.where(mask_uX, cdiv(T_uX, st.s_uX), 0.0)
                  + jnp.where(mask_uX, slam(st.lam_uX, st.s_uX), 0.0) * r_suX)
            bU = (- jnp.where(mask_lU, cdiv(T_lU, st.s_lU), 0.0)
                  - jnp.where(mask_lU, slam(st.lam_lU, st.s_lU), 0.0) * r_slU
                  + jnp.where(mask_uU, cdiv(T_uU, st.s_uU), 0.0)
                  + jnp.where(mask_uU, slam(st.lam_uU, st.s_uU), 0.0) * r_suU)
            bg = (- jnp.where(mask_lg, cdiv(T_lg, st.s_lg), 0.0)
                  - jnp.where(mask_lg, slam(st.lam_lg, st.s_lg), 0.0) * r_slg
                  + jnp.where(mask_ug, cdiv(T_ug, st.s_ug), 0.0)
                  + jnp.where(mask_ug, slam(st.lam_ug, st.s_ug), 0.0) * r_sug)
            q_rhs = gX_full.at[1:].add(bX)
            q_rhs = q_rhs.at[:-1].add(jnp.einsum("cgi,cg->ci", cqp.Gx, bg))
            r_rhs = gU_full + bU + jnp.einsum("cgi,cg->ci", cqp.Gu, bg)
            return q_rhs, r_rhs

        def refine_dirs(d_dX, d_dU, q_rhs, r_rhs):
            """One pass of iterative refinement on the reduced Newton solve.

            The dense G'ΣG blocks mix barrier curvatures of ~1/mu into
            every direction, so near convergence the raw Riccati directions
            carry O(cond·eps) error that stalls the IPM ~2 decades early
            (measured). Recover multipliers by the adjoint recursion (the
            x-rows are then exact by construction), form the u-row and
            dynamics residuals, re-solve with the SAME factorization, and
            correct. This is the f32 answer to HPIPM's higher-precision
            accumulation — two extra vector-only scans, no refactorization.
            """
            lamN = Qmod[-1] @ d_dX[-1] + q_rhs[-1]

            def bwd(lam_next, inp):
                A_k, B_k, Qm_k, qr_k, Rm_k, rr_k, Sm_k, dX_k, dU_k = inp
                res_u = (Rm_k @ dU_k + rr_k + Sm_k @ dX_k
                         + B_k.T @ lam_next)
                lam_k = (Qm_k @ dX_k + qr_k + Sm_k.T @ dU_k
                         + A_k.T @ lam_next)
                return lam_k, res_u

            _, res_u = jax.lax.scan(
                bwd, lamN,
                (cqp.Abar, cqp.Bbar, Qmod[:-1], q_rhs[:-1], Rmod, r_rhs,
                 Smod, d_dX[:-1], d_dU),
                reverse=True)
            res_c = (r_eq
                     + jnp.einsum("cij,cj->ci", cqp.Abar, d_dX[:-1])
                     + jnp.einsum("cij,cj->ci", cqp.Bbar, d_dU)
                     - d_dX[1:])
            dd_dX, dd_dU = solve_rhs_fn(res_c, jnp.zeros_like(q_rhs),
                                        res_u)
            return d_dX + dd_dX, d_dU + dd_dU

        def directions(Ts):
            T_lX, T_uX, T_lU, T_uU, T_lg, T_ug = Ts
            q_rhs, r_rhs = rhs_grads(*Ts)
            d_dX, d_dU = solve_rhs_fn(r_eq, q_rhs, r_rhs)
            for _ in range(refine):
                d_dX, d_dU = refine_dirs(d_dX, d_dU, q_rhs, r_rhs)
            dv_g = (jnp.einsum("cgi,ci->cg", cqp.Gx, d_dX[:-1])
                    + jnp.einsum("cgi,ci->cg", cqp.Gu, d_dU))
            d_slX = jnp.where(mask_lX, d_dX[1:] - r_slX, 0.0)
            d_suX = jnp.where(mask_uX, -d_dX[1:] - r_suX, 0.0)
            d_slU = jnp.where(mask_lU, d_dU - r_slU, 0.0)
            d_suU = jnp.where(mask_uU, -d_dU - r_suU, 0.0)
            d_slg = jnp.where(mask_lg, dv_g - r_slg, 0.0)
            d_sug = jnp.where(mask_ug, -dv_g - r_sug, 0.0)

            def dl(lam, s, ds, T, mask):
                # clamp: with s at the eps floor the divide can reach inf,
                # and a_d*inf with a collapsed dual step (a_d=0) is NaN
                return jnp.where(
                    mask, jnp.clip((T - s * lam - lam * ds) / s,
                                   -1e12, 1e12), 0.0)
            d_llX = dl(st.lam_lX, st.s_lX, d_slX, T_lX, mask_lX)
            d_luX = dl(st.lam_uX, st.s_uX, d_suX, T_uX, mask_uX)
            d_llU = dl(st.lam_lU, st.s_lU, d_slU, T_lU, mask_lU)
            d_luU = dl(st.lam_uU, st.s_uU, d_suU, T_uU, mask_uU)
            d_llg = dl(st.lam_lg, st.s_lg, d_slg, T_lg, mask_lg)
            d_lug = dl(st.lam_ug, st.s_ug, d_sug, T_ug, mask_ug)
            return (d_dX, d_dU, (d_slX, d_suX, d_slU, d_suU, d_slg, d_sug),
                    (d_llX, d_luX, d_llU, d_luU, d_llg, d_lug))

        ss = (st.s_lX, st.s_uX, st.s_lU, st.s_uU, st.s_lg, st.s_ug)
        lams = (st.lam_lX, st.lam_uX, st.lam_lU, st.lam_uU,
                st.lam_lg, st.lam_ug)
        mks = (mask_lX, mask_uX, mask_lU, mask_uU, mask_lg, mask_ug)

        def alphas(dss, dls, tau):
            a_p = jnp.asarray(1.0, dtype)
            a_d = jnp.asarray(1.0, dtype)
            for s, ds, lam, dl_, m in zip(ss, dss, lams, dls, mks):
                a_p = jnp.minimum(a_p, max_step(s, ds, m, tau))
                a_d = jnp.minimum(a_d, max_step(lam, dl_, m, tau))
            return jnp.minimum(1.0, a_p), jnp.minimum(1.0, a_d)

        zeros = tuple(jnp.zeros_like(s) for s in
                      (r_slX, r_suX, r_slU, r_suU, r_slg, r_sug))
        # ---- predictor ----
        _, _, aff_s, aff_l = directions(zeros)
        a_p_aff, a_d_aff = alphas(aff_s, aff_l, 1.0)
        mu_aff = 0.0
        for s, ds, lam, dl_, m in zip(ss, aff_s, lams, aff_l, mks):
            mu_aff += jnp.sum(jnp.where(
                m, (s + a_p_aff * ds) * (lam + a_d_aff * dl_), 0.0))
        mu_aff = mu_aff / n_ineq
        sigma = jnp.clip((mu_aff / jnp.maximum(mu_cur, mu_min)) ** 3,
                         0.0, 1.0)
        mu_t = jnp.maximum(sigma * mu_cur, mu_min)

        # ---- corrector (Gondzio clipping) ----
        def target(ds, dl_):
            return jnp.clip(mu_t - ds * dl_, 0.05 * mu_t, 20.0 * mu_t)
        Ts = tuple(jnp.where(m, target(ds, dl_), 0.0)
                   for ds, dl_, m in zip(aff_s, aff_l, mks))
        d_dX, d_dU, dss, dls = directions(Ts)
        a_p, a_d = alphas(dss, dls, alpha_frac)

        eps_s = jnp.asarray(1e-9 if jnp.finfo(dtype).bits <= 32 else 1e-16,
                            dtype)
        new_s = [jnp.where(m, jnp.maximum(s + a_p * ds, eps_s), _BIG)
                 for s, ds, m in zip(ss, dss, mks)]
        new_l = [jnp.clip(lam + a_d * dl_, 0.0, lam_max)
                 for lam, dl_ in zip(lams, dls)]
        return _CGS(
            dX=st.dX + a_p * d_dX, dU=st.dU + a_p * d_dU,
            s_lX=new_s[0], s_uX=new_s[1], lam_lX=new_l[0], lam_uX=new_l[1],
            s_lU=new_s[2], s_uU=new_s[3], lam_lU=new_l[2], lam_uU=new_l[3],
            s_lg=new_s[4], s_ug=new_s[5], lam_lg=new_l[4], lam_ug=new_l[5])

    def merit(st: _CGS):
        """Stationarity via condensed adjoint recursion + eq + comp."""
        lam_Xb = (jnp.where(mask_lX, st.lam_lX, 0.0)
                  - jnp.where(mask_uX, st.lam_uX, 0.0))     # stages 1..Nc
        lam_Ub = (jnp.where(mask_lU, st.lam_lU, 0.0)
                  - jnp.where(mask_uU, st.lam_uU, 0.0))
        lam_gb = (jnp.where(mask_lg, st.lam_lg, 0.0)
                  - jnp.where(mask_ug, st.lam_ug, 0.0))     # (Nc, ng)
        lamN = cqp.Qbar[-1] @ st.dX[-1] + cqp.qbar[-1] - lam_Xb[-1]

        def bwd(lam_next, inp):
            (A_k, B_k, Q_k, q_k, R_k, r_k, S_k, Gx_k, Gu_k, dX_k, dU_k,
             lXb, lUb, lgb) = inp
            stat_u = (R_k @ dU_k + r_k + S_k @ dX_k + B_k.T @ lam_next
                      - lUb - Gu_k.T @ lgb)
            lam_k = (Q_k @ dX_k + q_k + S_k.T @ dU_k + A_k.T @ lam_next
                     - lXb - Gx_k.T @ lgb)
            return lam_k, jnp.max(jnp.abs(stat_u))

        lXb_stage = jnp.concatenate(
            [jnp.zeros((1, nx), dtype), lam_Xb[:-1]], axis=0)
        _, stat_us = jax.lax.scan(
            bwd, lamN,
            (cqp.Abar, cqp.Bbar, cqp.Qbar[:-1], cqp.qbar[:-1], cqp.Rbar,
             cqp.rbar, cqp.Sbar, cqp.Gx, cqp.Gu, st.dX[:-1], st.dU,
             lXb_stage, lam_Ub, lam_gb),
            reverse=True)
        kkt_stat = jnp.max(stat_us)
        kkt_eq = jnp.max(jnp.abs(
            st.dX[1:] - jnp.einsum("cij,cj->ci", cqp.Abar, st.dX[:-1])
            - jnp.einsum("cij,cj->ci", cqp.Bbar, st.dU) - cqp.cbar))
        m = kkt_stat + kkt_eq + comp_sum(st) / n_ineq
        return m, kkt_stat, kkt_eq

    def step_and_select(carry, _):
        st, best, best_m = carry
        st = iteration(st)
        m, _, _ = merit(st)
        better = m < best_m
        best = jax.tree.map(lambda n, b: jnp.where(better, n, b), st, best)
        best_m = jnp.where(better, m, best_m)
        return (st, best, best_m), None

    m0, _, _ = merit(st0)
    (_, best, _), _ = jax.lax.scan(step_and_select, (st0, st0, m0),
                                   None, length=iters)
    _, kkt_stat, kkt_eq = merit(best)

    # ----- expansion back to the full horizon -----
    dx, du = expand(cqp, best.dX, best.dU)
    nu = du.shape[-1]
    N = Nc * M

    def scatter_state_duals(lam_bound, lam_gen):
        """(Nc, nx) boundary + (Nc, ng) interior -> (N, nx) stages 1..N.

        Block j contributes stages jM+1..jM+M: interiors i=1..M-1 from the
        general duals, the block-end boundary jM+M from lam_bound[j]."""
        interior = lam_gen.reshape(Nc, M - 1, nx) if M > 1 \
            else jnp.zeros((Nc, 0, nx), dtype)
        per_block = jnp.concatenate([interior, lam_bound[:, None]], axis=1)
        return per_block.reshape(N, nx)

    # scaled-row multipliers -> original-unit bound multipliers
    lam_lx = scatter_state_duals(
        jnp.where(mask_lX, best.lam_lX, 0.0),
        jnp.where(mask_lg, best.lam_lg * cqp.gscale, 0.0))
    lam_ux = scatter_state_duals(
        jnp.where(mask_uX, best.lam_uX, 0.0),
        jnp.where(mask_ug, best.lam_ug * cqp.gscale, 0.0))
    lam_lu = jnp.where(mask_lU, best.lam_lU / cqp.uscale, 0.0) \
        .reshape(N, nu)
    lam_uu = jnp.where(mask_uU, best.lam_uU / cqp.uscale, 0.0) \
        .reshape(N, nu)

    return QPSolution(
        dx=dx, du=du,
        lam_lx=lam_lx, lam_ux=lam_ux, lam_lu=lam_lu, lam_uu=lam_uu,
        mu=comp_sum(best) / n_ineq, kkt_stat=kkt_stat, kkt_eq=kkt_eq,
        iters=jnp.asarray(iters),
    )
