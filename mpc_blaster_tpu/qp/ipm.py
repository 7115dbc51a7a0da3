"""Box-constrained OCP-QP via Mehrotra predictor-corrector IPM + Riccati.

The HPIPM-class solver (`blastermodel.py:274`) rebuilt for XLA:

  - static iteration budget (`ipm_iters`) inside jit — no data-dependent
    loop counts (XLA requirement); converged problems keep iterating on a
    stationary point, which is wasted-but-correct work and batch-friendly;
  - per iteration ONE Riccati factorization (matrices) + TWO RHS solves
    (Mehrotra predictor + corrector) via `riccati.py`'s factor/solve split —
    the same structure HPIPM uses;
  - infeasible-start formulation: slacks are independent variables, so a
    (possibly bound-violating) warm start from a previous RTI tick is fine;
    slack residuals decay geometrically with the primal step size;
  - separate primal/dual fraction-to-boundary step sizes, computed with
    masked reductions (jnp.where), never host branches.

The plain monotone-mu barrier variant diverges on this problem class: the
BLASTER cost leaves the gimbal chain nearly unpenalized (R_swivel = 1e-5,
`simulation_blaster.py:27`), so a fixed-mu barrier gradient along that
near-null direction produces enormous Newton steps. Mehrotra's
affine-scaling predictor measures how far mu can actually drop and centers
only that much — exactly the cure (and what HPIPM ships).

Bounds may be +-inf; masked entries contribute nothing to the barrier.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpc_blaster_tpu.qp.data import QPData, QPSolution, full_precision
from mpc_blaster_tpu.qp.riccati import riccati_factorize, riccati_solve_rhs

_BIG = 1e20  # slack value standing in for an infinite bound


class _IpmState(NamedTuple):
    dx: jnp.ndarray      # (N+1, nx)
    du: jnp.ndarray      # (N, nu)
    s_lx: jnp.ndarray    # (N, nx)  slacks, states 1..N
    s_ux: jnp.ndarray
    lam_lx: jnp.ndarray
    lam_ux: jnp.ndarray
    s_lu: jnp.ndarray    # (N, nu)
    s_uu: jnp.ndarray
    lam_lu: jnp.ndarray
    lam_uu: jnp.ndarray


def _init_slack(gap, mask, s_min):
    return jnp.where(mask, jnp.maximum(gap, s_min), _BIG)


class IpmWarmStart(NamedTuple):
    """Slack/dual warm start from a previous tick's solve (HPIPM
    warm_start=1 analog). Slacks are absolute bound distances, so they
    transfer across RTI ticks (shift stages yourself before passing).
    `valid` gates blending: 0.0 -> cold start (first tick)."""

    s_lx: jnp.ndarray
    s_ux: jnp.ndarray
    lam_lx: jnp.ndarray
    lam_ux: jnp.ndarray
    s_lu: jnp.ndarray
    s_uu: jnp.ndarray
    lam_lu: jnp.ndarray
    lam_uu: jnp.ndarray
    valid: jnp.ndarray  # scalar 0/1

    @staticmethod
    def zeros(N: int, nx: int, nu: int, dtype=jnp.float32):
        zx = jnp.zeros((N, nx), dtype)
        zu = jnp.zeros((N, nu), dtype)
        return IpmWarmStart(zx, zx, zx, zx, zu, zu, zu, zu,
                            jnp.zeros((), dtype))


_RICCATI_BACKENDS = ("scan", "pscan", "hybrid", "sqrt")


@full_precision
def box_qp_solve(data: QPData, iters: int = 12, mu0: float = 1e-1,
                 alpha_frac: float = 0.995,
                 reg: float = 1e-9, s_min: float = 1e-3,
                 mu_min: float = 1e-12,
                 warm_du: jnp.ndarray | None = None,
                 warm: "IpmWarmStart | None" = None,
                 riccati: str = "scan") -> QPSolution:
    """Solve the box-constrained OCP QP. Fully jit/vmap-compatible.

    warm_du: optional (N, nu) control warm start (RTI shift), used to seed
    the primal trajectory by rolling out the dynamics.
    warm: optional slack/dual warm start (see IpmWarmStart); blended over
    the cold centered init when warm.valid > 0.
    riccati: inner Newton-system solver —
      - "scan":   sequential per-stage Riccati sweeps (`qp/riccati.py`);
                  best throughput when vmapped over a scenario batch.
      - "pscan":  O(log N)-depth associative-scan factorization AND RHS
                  solves (`qp/pscan.py`); latency-oriented, and the mode
                  that shards over a device mesh along the horizon.
      - "hybrid": sequential factorization + O(log N) RHS solves — avoids
                  the pscan factorization's (nx, nx) LU custom calls while
                  still collapsing the 2x2 vector sweeps per iteration.
      - "sqrt":   square-root (array-form QR) factorization
                  (`qp/sqrt_riccati.py`): factorization error at the
                  SQUARE ROOT of the plain recursion's condition number.
                  For box-only QPs the gain is modest (~20% objective-gap
                  reduction on the blaster cold transient in f32 — RHS
                  roundoff in the flat gimbal subspace dominates there);
                  it is decisive for dense barrier terms, which is why
                  the condensed backend defaults to it in f32
                  (`qp/condense.py`). One QR custom call per stage.

    All matmuls inside the solve run at `qp.data.MATMUL_PRECISION`
    ("highest", `full_precision`): reduced-precision matmul defaults (bf16
    passes, TF32 on GPUs) destroy the Riccati/IPM numerics (KKT 0.1->10,
    closed loops drift meters; CLAUDE.md "Numerical facts").
    """
    if riccati not in _RICCATI_BACKENDS:
        raise ValueError(f"riccati={riccati!r}; expected one of "
                         f"{_RICCATI_BACKENDS}")
    return _box_qp_solve_impl(data, iters, mu0, alpha_frac, reg,
                              s_min, mu_min, warm_du, warm, riccati)


def _box_qp_solve_impl(data, iters, mu0, alpha_frac, reg, s_min,
                       mu_min, warm_du, warm, riccati="scan"):
    if riccati == "scan":
        factorize, solve_rhs = riccati_factorize, riccati_solve_rhs
    elif riccati == "sqrt":
        from mpc_blaster_tpu.qp.sqrt_riccati import (
            riccati_factorize_sqrt, sqrt_solve_rhs)
        factorize, solve_rhs = riccati_factorize_sqrt, sqrt_solve_rhs
    else:
        from mpc_blaster_tpu.qp.pscan import (
            riccati_factorize_pscan, riccati_solve_rhs_pscan)
        factorize = (riccati_factorize_pscan if riccati == "pscan"
                     else riccati_factorize)
        solve_rhs = riccati_solve_rhs_pscan
    N, nx, nu = data.horizon, data.nx, data.nu
    dtype = data.A.dtype

    # dtype-aware numerical floors: f32 (the device compute dtype) cannot
    # resolve complementarity products below ~1e-7 against O(1e3) cost
    # weights; driving mu lower produces garbage dual steps and NaNs in the
    # Riccati Cholesky (SURVEY.md §7 "Conditioning in f32").
    if jnp.finfo(dtype).bits <= 32:
        mu_min = max(mu_min, 1e-7)
        reg = max(reg, 1e-6)
        sigma_max = 1e7   # cap barrier curvature so chol(H_uu) stays PD
        lam_max = 1e7
    else:
        sigma_max = 1e14
        lam_max = 1e14

    mask_lx = jnp.isfinite(data.lbx[1:])
    mask_ux = jnp.isfinite(data.ubx[1:])
    mask_lu = jnp.isfinite(data.lbu)
    mask_uu = jnp.isfinite(data.ubu)

    # ----- initial primal point -----
    # Roll out the dynamics, then clamp states/controls strictly inside the
    # box (stage 0 stays pinned). The resulting dynamics residual is carried
    # as the Riccati affine term and decays by (1 - alpha) per iteration
    # (full infeasible-start IPM). Starting *inside* the box instead of with
    # clamped slacks avoids many iterations of thrashing when the rollout
    # violates bounds badly (e.g. cold starts far from the reference).
    # data.r * 0 rather than jnp.zeros: keeps the seed "varying" under
    # shard_map so downstream scan carries type-check.
    du0 = data.r * 0 if warm_du is None else warm_du

    def roll(dx, inp):
        A_k, B_k, c_k, du_k = inp
        nxt = A_k @ dx + B_k @ du_k + c_k
        return nxt, nxt
    _, dx_tail = jax.lax.scan(roll, data.dx0, (data.A, data.B, data.c, du0))

    def clamp_into(v, lb, ub, mask_l, mask_u):
        # Generous 10%-of-width inset: starting *well* inside the box keeps
        # the initial slacks O(width), so the centered duals mu0/s stay
        # moderate and the first Newton systems are not barrier-dominated.
        width = jnp.where(mask_l & mask_u, ub - lb, 1.0)
        inset = 0.1 * width
        lo = jnp.where(mask_l, lb + inset, -_BIG)
        hi = jnp.where(mask_u, ub - inset, _BIG)
        return jnp.clip(v, lo, jnp.maximum(hi, lo))

    dx_tail = clamp_into(dx_tail, data.lbx[1:], data.ubx[1:],
                         mask_lx, mask_ux)
    du0 = clamp_into(du0, data.lbu, data.ubu, mask_lu, mask_uu)
    dx0_traj = jnp.concatenate([data.dx0[None], dx_tail], axis=0)

    # Centered start: s from the actual gap (clamped positive), lam = mu0/s
    # so s*lam = mu0 elementwise.
    s_lx = _init_slack(dx0_traj[1:] - data.lbx[1:], mask_lx, s_min)
    s_ux = _init_slack(data.ubx[1:] - dx0_traj[1:], mask_ux, s_min)
    s_lu = _init_slack(du0 - data.lbu, mask_lu, s_min)
    s_uu = _init_slack(data.ubu - du0, mask_uu, s_min)
    lam_lx = jnp.where(mask_lx, mu0 / s_lx, 0.0).astype(dtype)
    lam_ux = jnp.where(mask_ux, mu0 / s_ux, 0.0).astype(dtype)
    lam_lu = jnp.where(mask_lu, mu0 / s_lu, 0.0).astype(dtype)
    lam_uu = jnp.where(mask_uu, mu0 / s_uu, 0.0).astype(dtype)

    if warm is not None:
        # Blend warm slacks/duals over the cold centered init (per-problem
        # gate so batched solves can mix cold and warm scenarios). A
        # per-entry isfinite guard drops NaN/inf warm entries back to the
        # cold init so a degenerate tick can't poison the warm chain.
        use = (warm.valid > 0.5)

        def blend(w, cold, mask):
            w = jnp.clip(jnp.where(mask, w, _BIG), s_min * 1e-2, _BIG)
            return jnp.where(use & mask & jnp.isfinite(w), w, cold)

        def blend_l(w, cold, mask):
            w = jnp.clip(w, 0.0, lam_max)
            return jnp.where(use & mask & jnp.isfinite(w),
                             jnp.maximum(w, 1e-8), cold)

        s_lx = blend(warm.s_lx, s_lx, mask_lx)
        s_ux = blend(warm.s_ux, s_ux, mask_ux)
        s_lu = blend(warm.s_lu, s_lu, mask_lu)
        s_uu = blend(warm.s_uu, s_uu, mask_uu)
        lam_lx = blend_l(warm.lam_lx, lam_lx, mask_lx)
        lam_ux = blend_l(warm.lam_ux, lam_ux, mask_ux)
        lam_lu = blend_l(warm.lam_lu, lam_lu, mask_lu)
        lam_uu = blend_l(warm.lam_uu, lam_uu, mask_uu)

    state = _IpmState(
        dx=dx0_traj, du=du0,
        s_lx=s_lx, s_ux=s_ux,
        lam_lx=lam_lx, lam_ux=lam_ux,
        s_lu=s_lu, s_uu=s_uu,
        lam_lu=lam_lu, lam_uu=lam_uu,
    )

    n_ineq = (jnp.sum(mask_lx) + jnp.sum(mask_ux)
              + jnp.sum(mask_lu) + jnp.sum(mask_uu)).astype(dtype)
    n_ineq = jnp.maximum(n_ineq, 1.0)
    eye_x = jnp.eye(nx, dtype=dtype)
    eye_u = jnp.eye(nu, dtype=dtype)
    # Derived from varying data (not a fresh constant) so that shard_map's
    # varying-axis typing accepts it as a scan carry seed.
    dx0_zero = data.dx0 * 0

    def comp_sum(st):
        return (jnp.sum(jnp.where(mask_lx, st.s_lx * st.lam_lx, 0.0))
                + jnp.sum(jnp.where(mask_ux, st.s_ux * st.lam_ux, 0.0))
                + jnp.sum(jnp.where(mask_lu, st.s_lu * st.lam_lu, 0.0))
                + jnp.sum(jnp.where(mask_uu, st.s_uu * st.lam_uu, 0.0)))

    def max_step(v, dv, mask, tau):
        ratio = jnp.where(mask & (dv < 0),
                          -tau * v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.min(ratio)

    def iteration(state: _IpmState, _):
        mu_cur = comp_sum(state) / n_ineq

        # Bound residuals (infeasible-start): r_s = s - gap.
        r_slx = jnp.where(mask_lx, state.s_lx - (state.dx[1:] - data.lbx[1:]), 0.0)
        r_sux = jnp.where(mask_ux, state.s_ux - (data.ubx[1:] - state.dx[1:]), 0.0)
        r_slu = jnp.where(mask_lu, state.s_lu - (state.du - data.lbu), 0.0)
        r_suu = jnp.where(mask_uu, state.s_uu - (data.ubu - state.du), 0.0)

        # Diagonal Hessian modification and factorization (once per iter).
        sig_x = jnp.where(mask_lx, state.lam_lx / state.s_lx, 0.0) \
            + jnp.where(mask_ux, state.lam_ux / state.s_ux, 0.0)
        sig_u = jnp.where(mask_lu, state.lam_lu / state.s_lu, 0.0) \
            + jnp.where(mask_uu, state.lam_uu / state.s_uu, 0.0)
        sig_x = jnp.minimum(sig_x, sigma_max)
        sig_u = jnp.minimum(sig_u, sigma_max)
        Qmod = data.Q.at[1:].add(sig_x[:, :, None] * eye_x[None])
        Rmod = data.R + sig_u[:, :, None] * eye_u[None]
        fac = factorize(data.A, data.B, Qmod, Rmod, reg)

        gx_full = jnp.einsum("kij,kj->ki", data.Q, state.dx) + data.q
        gu_full = jnp.einsum("kij,kj->ki", data.R, state.du) + data.r

        # Dynamics residual of the current iterate (nonzero after clamped
        # init; decays by (1 - alpha) per step).
        r_eq = (data.c
                + jnp.einsum("kij,kj->ki", data.A, state.dx[:-1])
                + jnp.einsum("kij,kj->ki", data.B, state.du)
                - state.dx[1:])

        def rhs_grads(T_lx, T_ux, T_lu, T_uu):
            """gbar given per-constraint complementarity targets T.

            The lam/s factors are capped at sigma_max like the Hessian
            barrier diagonal: near-degenerate bounds (s at the eps floor
            with lam large) otherwise push 1e12+-scale entries into the
            Riccati RHS, whose f32 products overflow to inf and poison the
            iterate with NaN (observed systematically at >6 iterations).
            Capping = an inexact Newton step on the degenerate rows; the
            fraction-to-boundary and best-iterate machinery absorb it."""
            slam_lx = jnp.minimum(state.lam_lx / state.s_lx, sigma_max)
            slam_ux = jnp.minimum(state.lam_ux / state.s_ux, sigma_max)
            slam_lu = jnp.minimum(state.lam_lu / state.s_lu, sigma_max)
            slam_uu = jnp.minimum(state.lam_uu / state.s_uu, sigma_max)
            def cdiv(T, s):  # centering force, same cap
                return jnp.clip(T / s, -sigma_max, sigma_max)
            bx = (- jnp.where(mask_lx, cdiv(T_lx, state.s_lx), 0.0)
                  - jnp.where(mask_lx, slam_lx, 0.0) * r_slx
                  + jnp.where(mask_ux, cdiv(T_ux, state.s_ux), 0.0)
                  + jnp.where(mask_ux, slam_ux, 0.0) * r_sux)
            bu = (- jnp.where(mask_lu, cdiv(T_lu, state.s_lu), 0.0)
                  - jnp.where(mask_lu, slam_lu, 0.0) * r_slu
                  + jnp.where(mask_uu, cdiv(T_uu, state.s_uu), 0.0)
                  + jnp.where(mask_uu, slam_uu, 0.0) * r_suu)
            q_rhs = gx_full.at[1:].add(bx)
            r_rhs = gu_full + bu
            return q_rhs, r_rhs

        def directions(q_rhs, r_rhs, T_lx, T_ux, T_lu, T_uu):
            d_dx, d_du = solve_rhs(fac, data.A, data.B, r_eq,
                                   q_rhs, r_rhs, dx0_zero)
            d_slx = jnp.where(mask_lx, d_dx[1:] - r_slx, 0.0)
            d_sux = jnp.where(mask_ux, -d_dx[1:] - r_sux, 0.0)
            d_slu = jnp.where(mask_lu, d_du - r_slu, 0.0)
            d_suu = jnp.where(mask_uu, -d_du - r_suu, 0.0)

            def dl(lam, s, ds, T, mask):
                # clamp: with s at the eps floor the divide can reach inf,
                # and a_d*inf with a collapsed dual step (a_d=0) is NaN
                return jnp.where(
                    mask, jnp.clip((T - s * lam - lam * ds) / s,
                                   -1e12, 1e12), 0.0)
            d_llx = dl(state.lam_lx, state.s_lx, d_slx, T_lx, mask_lx)
            d_lux = dl(state.lam_ux, state.s_ux, d_sux, T_ux, mask_ux)
            d_llu = dl(state.lam_lu, state.s_lu, d_slu, T_lu, mask_lu)
            d_luu = dl(state.lam_uu, state.s_uu, d_suu, T_uu, mask_uu)
            return (d_dx, d_du, d_slx, d_sux, d_slu, d_suu,
                    d_llx, d_lux, d_llu, d_luu)

        def alphas(dirs, tau):
            (_, _, d_slx, d_sux, d_slu, d_suu,
             d_llx, d_lux, d_llu, d_luu) = dirs
            a_p = jnp.minimum(
                jnp.minimum(max_step(state.s_lx, d_slx, mask_lx, tau),
                            max_step(state.s_ux, d_sux, mask_ux, tau)),
                jnp.minimum(max_step(state.s_lu, d_slu, mask_lu, tau),
                            max_step(state.s_uu, d_suu, mask_uu, tau)))
            a_d = jnp.minimum(
                jnp.minimum(max_step(state.lam_lx, d_llx, mask_lx, tau),
                            max_step(state.lam_ux, d_lux, mask_ux, tau)),
                jnp.minimum(max_step(state.lam_lu, d_llu, mask_lu, tau),
                            max_step(state.lam_uu, d_luu, mask_uu, tau)))
            return jnp.minimum(1.0, a_p), jnp.minimum(1.0, a_d)

        # ---- predictor (affine scaling, target 0) ----
        zs_x = jnp.zeros_like(r_slx)
        zs_u = jnp.zeros_like(r_slu)
        q_aff, r_aff = rhs_grads(zs_x, zs_x, zs_u, zs_u)
        aff = directions(q_aff, r_aff, zs_x, zs_x, zs_u, zs_u)
        a_p_aff, a_d_aff = alphas(aff, 1.0)
        (_, _, a_slx, a_sux, a_slu, a_suu,
         a_llx, a_lux, a_llu, a_luu) = aff
        mu_aff = (
            jnp.sum(jnp.where(mask_lx, (state.s_lx + a_p_aff * a_slx)
                              * (state.lam_lx + a_d_aff * a_llx), 0.0))
            + jnp.sum(jnp.where(mask_ux, (state.s_ux + a_p_aff * a_sux)
                                * (state.lam_ux + a_d_aff * a_lux), 0.0))
            + jnp.sum(jnp.where(mask_lu, (state.s_lu + a_p_aff * a_slu)
                                * (state.lam_lu + a_d_aff * a_llu), 0.0))
            + jnp.sum(jnp.where(mask_uu, (state.s_uu + a_p_aff * a_suu)
                                * (state.lam_uu + a_d_aff * a_luu), 0.0))
        ) / n_ineq

        sigma = jnp.clip((mu_aff / jnp.maximum(mu_cur, mu_min)) ** 3, 0.0, 1.0)
        mu_t = jnp.maximum(sigma * mu_cur, mu_min)

        # ---- corrector (centering + second-order correction) ----
        # Gondzio-style safeguard: clip each per-constraint complementarity
        # target mu_t - ds_aff*dlam_aff into [0.05 mu_t, 20 mu_t]. Near a
        # weakly-active bound the raw correction term ~1/s blows up and
        # destabilizes iterations *past* convergence; clipping makes the
        # solved point a fixpoint of further iterations.
        def target(ds, dl_):
            return jnp.clip(mu_t - ds * dl_, 0.05 * mu_t, 20.0 * mu_t)
        T_lx = jnp.where(mask_lx, target(a_slx, a_llx), 0.0)
        T_ux = jnp.where(mask_ux, target(a_sux, a_lux), 0.0)
        T_lu = jnp.where(mask_lu, target(a_slu, a_llu), 0.0)
        T_uu = jnp.where(mask_uu, target(a_suu, a_luu), 0.0)
        q_cor, r_cor = rhs_grads(T_lx, T_ux, T_lu, T_uu)
        dirs = directions(q_cor, r_cor, T_lx, T_ux, T_lu, T_uu)
        a_p, a_d = alphas(dirs, alpha_frac)
        (d_dx, d_du, d_slx, d_sux, d_slu, d_suu,
         d_llx, d_lux, d_llu, d_luu) = dirs

        eps_s = jnp.asarray(1e-9 if jnp.finfo(dtype).bits <= 32 else 1e-16,
                            dtype)

        def upd_s(s, ds, mask):
            return jnp.where(mask, jnp.maximum(s + a_p * ds, eps_s), _BIG)

        def upd_l(lam, dl):
            return jnp.clip(lam + a_d * dl, 0.0, lam_max)

        new = _IpmState(
            dx=state.dx + a_p * d_dx,
            du=state.du + a_p * d_du,
            s_lx=upd_s(state.s_lx, d_slx, mask_lx),
            s_ux=upd_s(state.s_ux, d_sux, mask_ux),
            lam_lx=upd_l(state.lam_lx, d_llx),
            lam_ux=upd_l(state.lam_ux, d_lux),
            s_lu=upd_s(state.s_lu, d_slu, mask_lu),
            s_uu=upd_s(state.s_uu, d_suu, mask_uu),
            lam_lu=upd_l(state.lam_lu, d_llu),
            lam_uu=upd_l(state.lam_uu, d_luu),
        )
        return new, (a_p, a_d)

    kkt_fn = _kkt_residuals if riccati == "scan" else _kkt_residuals_pscan

    def merit(st: _IpmState):
        """KKT merit for best-iterate selection: stationarity + equality +
        complementarity, all -> 0 at the solution."""
        kkt_stat, kkt_eq = kkt_fn(data, st, mask_lx, mask_ux,
                                  mask_lu, mask_uu)
        return kkt_stat + kkt_eq + comp_sum(st) / n_ineq, kkt_stat, kkt_eq

    # Interior-point iterations are not a contraction once converged:
    # weakly-active bounds (s ~ 0 with lam ~ 0) destabilize later iterations.
    # With a static iteration budget we therefore track the best iterate by
    # KKT merit and return THAT, making extra iterations harmless.
    def step_and_select(carry, _):
        state, best, best_m = carry
        state, _aux = iteration(state, None)
        m, _, _ = merit(state)
        better = m < best_m
        best = jax.tree.map(
            lambda n, b: jnp.where(better, n, b), state, best)
        best_m = jnp.where(better, m, best_m)
        return (state, best, best_m), None

    m0, _, _ = merit(state)
    (_, best, _), _ = jax.lax.scan(step_and_select, (state, state, m0),
                                   None, length=iters)

    _, kkt_stat, kkt_eq = merit(best)
    return QPSolution(
        dx=best.dx, du=best.du,
        lam_lx=best.lam_lx, lam_ux=best.lam_ux,
        lam_lu=best.lam_lu, lam_uu=best.lam_uu,
        mu=comp_sum(best) / n_ineq, kkt_stat=kkt_stat, kkt_eq=kkt_eq,
        iters=jnp.asarray(iters),
        s_lx=best.s_lx, s_ux=best.s_ux, s_lu=best.s_lu, s_uu=best.s_uu,
    )


def warm_start_from(sol: QPSolution, shift: bool = False) -> IpmWarmStart:
    """Build the next tick's warm start from a solve's slacks/duals.

    Our rti_step keeps the iterate un-shifted between ticks (acados RTI
    default), so shift=False matches it; use shift=True together with
    `sqp.rti.shift_state`.
    """
    def sh(a):
        if not shift:
            return a
        return jnp.concatenate([a[1:], a[-1:]], axis=0)

    return IpmWarmStart(
        s_lx=sh(sol.s_lx), s_ux=sh(sol.s_ux),
        lam_lx=sh(sol.lam_lx), lam_ux=sh(sol.lam_ux),
        s_lu=sh(sol.s_lu), s_uu=sh(sol.s_uu),
        lam_lu=sh(sol.lam_lu), lam_uu=sh(sol.lam_uu),
        valid=jnp.ones((), sol.dx.dtype),
    )


def warm_start_recenter(warm: IpmWarmStart, mu0: float = 1e-1,
                        mode: str = "centrality",
                        band=(0.1, 10.0)) -> IpmWarmStart:
    """Tame a slack/dual warm start for the next tick (classical RTI
    warm-start conditioning; HPIPM exposes the same idea as
    `warm_start=2` "centered" modes).

    The measured failure of raw warm chains (round 2: ~10x figure-8
    degradation on transients) is that the previous tick's NEAR-ACTIVE
    duals assert an active set the transient has already left — the
    low-iteration solve then fights stale multipliers. Two classical
    repairs, both keeping the (informative) slack geometry:

      mode="primal":      duals fully re-centered at lam = mu0/s — the
                          warm start carries only primal information.
      mode="centrality":  per-entry complementarity products clipped into
                          [band[0]*mu0, band[1]*mu0] by rescaling lam —
                          keeps dual information but bounds how hard a
                          stale multiplier can push.

    Returns a new IpmWarmStart (same `valid`).
    """
    lo, hi = band

    def recenter(s, lam):
        s_safe = jnp.maximum(s, 1e-9)
        if mode == "primal":
            return mu0 / s_safe
        if mode == "centrality":
            prod = jnp.clip(s_safe * lam, lo * mu0, hi * mu0)
            return prod / s_safe
        raise ValueError(f"unknown warm recenter mode {mode!r}")

    return warm._replace(
        lam_lx=recenter(warm.s_lx, warm.lam_lx),
        lam_ux=recenter(warm.s_ux, warm.lam_ux),
        lam_lu=recenter(warm.s_lu, warm.lam_lu),
        lam_uu=recenter(warm.s_uu, warm.lam_uu),
    )


def _kkt_residuals(data: QPData, st: _IpmState, mask_lx, mask_ux,
                   mask_lu, mask_uu):
    """Stationarity (via adjoint recursion, scan) and equality residual."""
    lam_x_bnd = jnp.where(mask_lx, st.lam_lx, 0.0) - jnp.where(
        mask_ux, st.lam_ux, 0.0)                         # (N, nx) stages 1..N
    lam_u_bnd = jnp.where(mask_lu, st.lam_lu, 0.0) - jnp.where(
        mask_uu, st.lam_uu, 0.0)                         # (N, nu)

    lamN = data.Q[-1] @ st.dx[-1] + data.q[-1] - lam_x_bnd[-1]

    def bwd(lam_next, inp):
        A_k, B_k, Q_k, q_k, R_k, r_k, dx_k, du_k, lxb, lub = inp
        stat_u = R_k @ du_k + r_k + B_k.T @ lam_next - lub
        lam_k = Q_k @ dx_k + q_k + A_k.T @ lam_next - lxb
        return lam_k, jnp.max(jnp.abs(stat_u))

    lxb_for_stage = jnp.concatenate(
        [jnp.zeros((1,) + lam_x_bnd.shape[1:], lam_x_bnd.dtype),
         lam_x_bnd[:-1]], axis=0)
    _, stat_us = jax.lax.scan(
        bwd, lamN,
        (data.A, data.B, data.Q[:-1], data.q[:-1], data.R, data.r,
         st.dx[:-1], st.du, lxb_for_stage, lam_u_bnd),
        reverse=True)
    kkt_stat = jnp.max(stat_us)
    kkt_eq = jnp.max(jnp.abs(
        st.dx[1:] - jnp.einsum("kij,kj->ki", data.A, st.dx[:-1])
        - jnp.einsum("kij,kj->ki", data.B, st.du) - data.c))
    return kkt_stat, kkt_eq


def _kkt_residuals_pscan(data: QPData, st: _IpmState, mask_lx, mask_ux,
                         mask_lu, mask_uu):
    """`_kkt_residuals` with the adjoint recursion as an O(log N)
    associative suffix scan of affine maps (latency-mode companion of
    `qp/pscan.py::riccati_solve_rhs_pscan`)."""
    nx = data.nx
    dtype = st.dx.dtype
    lam_x_bnd = jnp.where(mask_lx, st.lam_lx, 0.0) - jnp.where(
        mask_ux, st.lam_ux, 0.0)
    lam_u_bnd = jnp.where(mask_lu, st.lam_lu, 0.0) - jnp.where(
        mask_uu, st.lam_uu, 0.0)

    lamN = data.Q[-1] @ st.dx[-1] + data.q[-1] - lam_x_bnd[-1]
    # lam_k = A_k' lam_{k+1} + v_k for k = 1..N-1 (stage-0 lam unused)
    lxb_for_stage = jnp.concatenate(
        [jnp.zeros((1,) + lam_x_bnd.shape[1:], lam_x_bnd.dtype),
         lam_x_bnd[:-1]], axis=0)
    v = (jnp.einsum("kij,kj->ki", data.Q[:-1], st.dx[:-1]) + data.q[:-1]
         - lxb_for_stage)
    At = data.A.swapaxes(-1, -2)
    Ms = jnp.concatenate([At, jnp.zeros((1, nx, nx), dtype)], axis=0)
    vs = jnp.concatenate([v, lamN[None]], axis=0)

    def comp(earlier, later):
        Me, ve = earlier
        Ml, vl = later
        return Me @ Ml, jnp.einsum("kij,kj->ki", Me, vl) + ve

    _, lams = jax.lax.associative_scan(lambda a, b: comp(b, a), (Ms, vs),
                                       reverse=True)
    lam1 = lams[1:]                                    # lam_1..lam_N
    stat_u = (jnp.einsum("kij,kj->ki", data.R, st.du) + data.r
              + jnp.einsum("kji,kj->ki", data.B, lam1) - lam_u_bnd)
    kkt_stat = jnp.max(jnp.abs(stat_u))
    kkt_eq = jnp.max(jnp.abs(
        st.dx[1:] - jnp.einsum("kij,kj->ki", data.A, st.dx[:-1])
        - jnp.einsum("kij,kj->ki", data.B, st.du) - data.c))
    return kkt_stat, kkt_eq
