"""Soft (slacked) box constraints — the acados ``ns > 0`` machinery.

The reference's acados JSON schema carries the full soft-constraint
apparatus (``idxsbx``/``zl``/``zu``/``Zl``/``Zu`` blocks in
``acados_ocp_blasterModel.json``) but the BLASTER OCP never populates it
(SURVEY.md §7 "soft constraints ... exists in the reference's JSON schema
but is unused"). This module supplies it: per-component bound
softening with an L1+L2 violation penalty

    lb - t_l <= v <= ub + t_u,   t >= 0,
    cost += z·t + 0.5·Z·t²,

solved by the same Mehrotra predictor-corrector + Riccati IPM as
``qp/ipm.py``. The key structural fact (same one HPIPM exploits): the
violation variable t and its nonnegativity dual can be eliminated
*stage-wise and component-wise*, leaving a hard-bound-shaped system with a
modified barrier weight

    sigma_eff = sigma_s (Z + sigma_t) / (Z + sigma_s + sigma_t),
    sigma_s = lam/s,  sigma_t = gam/t,

(hard bound = limit Z -> inf) plus an extra affine RHS term. The Riccati
factorization/solve is completely unchanged — soft bounds cost a handful of
extra elementwise passes per IPM iteration and nothing else, so the
whole thing stays jit/vmap/shard_map-compatible with static shapes.

Derivation sketch for one soft lower bound (upper is the mirror image):
variables (v, t, s, lam, gam) with s = v - lb + t, complementarity pairs
(s, lam) and (t, gam). Newton rows:

    ds - dv - dt = -r_s                       r_s = s - (v - lb + t)
    lam ds + s dlam = T_s - s lam             (target T_s: 0 affine /
    gam dt + t dgam = T_t - t gam              Gondzio-clipped corrector)
    Z dt - dlam - dgam = -r_t                 r_t = z + Z t - lam - gam

Eliminating (ds, dlam, dgam) gives  dt = (w - sigma_s dv)/d  with
d = Z + sigma_s + sigma_t and
w = -r_t + (T_s/s - lam) + (T_t/t - gam) + sigma_s r_s; substituting into
the v-stationarity row leaves  sigma_eff·dv  on the matrix side and
-(T_s/s + sigma_s r_s - sigma_s w/d)  on the RHS — the hard-bound formulas
with the two soft corrections.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpc_blaster_tpu.qp.data import QPData, QPSolution, full_precision
from mpc_blaster_tpu.qp.ipm import _kkt_residuals, _IpmState
from mpc_blaster_tpu.qp.riccati import riccati_factorize, riccati_solve_rhs

_BIG = 1e20


class SoftPenalty(NamedTuple):
    """Per-component softening of one bound group.

    Z: quadratic violation weight (>0 where soft)
    z: linear violation weight (>=0; pure-L2 softening uses z=0)
    soft: boolean mask — which components of this group are soft. Entries
        that are not soft behave exactly like `qp/ipm.py` hard bounds.
    """

    Z: jnp.ndarray
    z: jnp.ndarray
    soft: jnp.ndarray

    @staticmethod
    def hard(shape, dtype=jnp.float32) -> "SoftPenalty":
        return SoftPenalty(Z=jnp.ones(shape, dtype), z=jnp.zeros(shape, dtype),
                           soft=jnp.zeros(shape, bool))


class SoftBounds(NamedTuple):
    """Soft-constraint spec for the four bound groups of the OCP QP.

    lx/ux: (N, nx) state lower/upper (stages 1..N, matching QPData.lbx[1:])
    lu/uu: (N, nu) control lower/upper
    """

    lx: SoftPenalty
    ux: SoftPenalty
    lu: SoftPenalty
    uu: SoftPenalty

    @staticmethod
    def state_bounds(N: int, nx: int, nu: int, Zl, zl, Zu=None, zu=None,
                     idx=None, dtype=jnp.float32) -> "SoftBounds":
        """Soften state bounds only (acados `idxsbx` usage; controls stay
        hard, matching the common acados configuration with empty idxsbu).

        Zl/zl (and optionally Zu/zu, defaulting to the lower weights) are
        scalars or (nx,) vectors; `idx` optionally restricts softening to a
        subset of state components.
        """
        Zu = Zl if Zu is None else Zu
        zu = zl if zu is None else zu

        def expand(w):
            w = jnp.broadcast_to(jnp.asarray(w, dtype), (nx,))
            return jnp.tile(w[None], (N, 1))
        mask = jnp.zeros(nx, bool)
        mask = mask.at[jnp.arange(nx) if idx is None else jnp.asarray(idx)] \
            .set(True)
        mask = jnp.tile(mask[None], (N, 1))
        return SoftBounds(
            lx=SoftPenalty(expand(Zl), expand(zl), mask),
            ux=SoftPenalty(expand(Zu), expand(zu), mask),
            lu=SoftPenalty.hard((N, nu), dtype),
            uu=SoftPenalty.hard((N, nu), dtype),
        )


class _GS(NamedTuple):
    """IPM state of one bound group: slack pair (s, lam) + violation pair
    (t, gam). t/gam are _BIG/0 on non-soft entries (inert in every product)."""

    s: jnp.ndarray
    lam: jnp.ndarray
    t: jnp.ndarray
    gam: jnp.ndarray


class SoftQPSolution(NamedTuple):
    """QPSolution + per-group bound violations (zero where hard/inactive)."""

    sol: QPSolution
    t_lx: jnp.ndarray
    t_ux: jnp.ndarray
    t_lu: jnp.ndarray
    t_uu: jnp.ndarray


def soft_qp_objective(data: QPData, soft: SoftBounds, dx, du) -> jnp.ndarray:
    """Penalized objective 0.5 z'Hz + g'z + sum z·t + 0.5 Z·t² with t taken
    as the actual bound violation of (dx, du) — for tests/diagnostics."""
    def quad(M, v):
        return 0.5 * jnp.einsum("...i,...ij,...j->...", v, M, v)
    obj = jnp.sum(quad(data.Q, dx)) + jnp.sum(data.q * dx)
    obj += jnp.sum(quad(data.R, du)) + jnp.sum(data.r * du)
    for v, b, sgn, pen in (
            (dx[1:], data.lbx[1:], 1.0, soft.lx),
            (dx[1:], data.ubx[1:], -1.0, soft.ux),
            (du, data.lbu, 1.0, soft.lu),
            (du, data.ubu, -1.0, soft.uu)):
        viol = jnp.where(pen.soft & jnp.isfinite(b),
                         jnp.maximum(-sgn * (v - b), 0.0), 0.0)
        obj += jnp.sum(pen.z * viol + 0.5 * pen.Z * viol ** 2)
    return obj


@full_precision
def soft_box_qp_solve(data: QPData, soft: SoftBounds, iters: int = 12,
                      mu0: float = 1e-1, alpha_frac: float = 0.995,
                      reg: float = 1e-9, s_min: float = 1e-3,
                      mu_min: float = 1e-12) -> SoftQPSolution:
    """Solve the OCP QP with per-component soft box bounds.

    Same scoped full-precision-matmul policy as `box_qp_solve` (reduced-
    precision matmul defaults are fatal to the QP numerics; CLAUDE.md
    "Numerical facts").
    """
    return _soft_impl(data, soft, iters, mu0, alpha_frac, reg, s_min,
                      mu_min)


def _soft_impl(data, soft, iters, mu0, alpha_frac, reg, s_min, mu_min):
    N, nx, nu = data.horizon, data.nx, data.nu
    dtype = data.A.dtype
    if jnp.finfo(dtype).bits <= 32:
        mu_min = max(mu_min, 1e-7)
        reg = max(reg, 1e-6)
        sigma_max = 1e7
        lam_max = 1e7
    else:
        sigma_max = 1e14
        lam_max = 1e14

    # Group descriptors: (bound, sign, finite-mask, penalty). sign*(v-b) is
    # the gap (>=0 when satisfied).
    bounds = (data.lbx[1:], data.ubx[1:], data.lbu, data.ubu)
    signs = (1.0, -1.0, 1.0, -1.0)
    masks = tuple(jnp.isfinite(b) for b in bounds)
    pens = (soft.lx, soft.ux, soft.lu, soft.uu)
    softm = tuple(m & p.soft for m, p in zip(masks, pens))

    # ----- initial primal point: rollout + clamp into the *hard* box -----
    # (soft entries may start in violation; their t covers it).
    du0 = data.r * 0

    def roll(dx, inp):
        A_k, B_k, c_k, du_k = inp
        nxt = A_k @ dx + B_k @ du_k + c_k
        return nxt, nxt
    _, dx_tail = jax.lax.scan(roll, data.dx0, (data.A, data.B, data.c, du0))

    def clamp_into(v, lb, ub, hard_l, hard_u, mask_l, mask_u):
        width = jnp.where(mask_l & mask_u, ub - lb, 1.0)
        inset = 0.1 * width
        lo = jnp.where(hard_l, lb + inset, -_BIG)
        hi = jnp.where(hard_u, ub - inset, _BIG)
        return jnp.clip(v, lo, jnp.maximum(hi, lo))

    dx_tail = clamp_into(dx_tail, data.lbx[1:], data.ubx[1:],
                         masks[0] & ~softm[0], masks[1] & ~softm[1],
                         masks[0], masks[1])
    du0 = clamp_into(du0, data.lbu, data.ubu,
                     masks[2] & ~softm[2], masks[3] & ~softm[3],
                     masks[2], masks[3])
    dx0_traj = jnp.concatenate([data.dx0[None], dx_tail], axis=0)

    def group_values(dx, du):
        return (dx[1:], dx[1:], du, du)

    def init_group(v, b, sgn, mask, sm):
        gap = sgn * (v - b)
        # O(1) starting violation slack keeps the centered dual gam = mu0/t
        # moderate whether or not the start violates the soft bound.
        t = jnp.where(sm, jnp.maximum(-gap, 0.0) + 0.1, _BIG)
        s = jnp.where(mask, jnp.maximum(gap + jnp.where(sm, t, 0.0), s_min),
                      _BIG)
        lam = jnp.where(mask, mu0 / s, 0.0).astype(dtype)
        gam = jnp.where(sm, mu0 / t, 0.0).astype(dtype)
        return _GS(s=s, lam=lam, t=t, gam=gam)

    vals0 = group_values(dx0_traj, du0)
    gs0 = tuple(init_group(v, b, sgn, m, sm) for v, b, sgn, m, sm
                in zip(vals0, bounds, signs, masks, softm))

    n_pairs = sum(jnp.sum(m) for m in masks) + sum(jnp.sum(m) for m in softm)
    n_pairs = jnp.maximum(n_pairs.astype(dtype), 1.0)
    eye_x = jnp.eye(nx, dtype=dtype)
    eye_u = jnp.eye(nu, dtype=dtype)
    dx0_zero = data.dx0 * 0

    def comp_sum(gs):
        tot = 0.0
        for g, m, sm in zip(gs, masks, softm):
            tot += jnp.sum(jnp.where(m, g.s * g.lam, 0.0))
            tot += jnp.sum(jnp.where(sm, g.t * g.gam, 0.0))
        return tot

    def max_step(v, dv, mask, tau):
        ratio = jnp.where(mask & (dv < 0),
                          -tau * v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
        return jnp.min(ratio)

    class _St(NamedTuple):
        dx: jnp.ndarray
        du: jnp.ndarray
        gs: tuple

    state0 = _St(dx=dx0_traj, du=du0, gs=gs0)

    def iteration(st: _St):
        vals = group_values(st.dx, st.du)
        mu_cur = comp_sum(st.gs) / n_pairs

        # Per-group residuals and barrier weights.
        r_ss, r_ts, sig_ss, sig_ts, dens, sig_effs = [], [], [], [], [], []
        for g, v, b, sgn, m, sm, pen in zip(st.gs, vals, bounds, signs,
                                            masks, softm, pens):
            t_eff = jnp.where(sm, g.t, 0.0)
            r_s = jnp.where(m, g.s - (sgn * (v - b) + t_eff), 0.0)
            r_t = jnp.where(sm, pen.z + pen.Z * g.t - g.lam - g.gam, 0.0)
            sig_s = jnp.where(m, g.lam / g.s, 0.0)
            sig_t = jnp.where(sm, g.gam / g.t, 0.0)
            den = pen.Z + sig_s + sig_t
            sig_eff = jnp.where(sm, sig_s * (pen.Z + sig_t) / den, sig_s)
            sig_eff = jnp.minimum(sig_eff, sigma_max)
            r_ss.append(r_s); r_ts.append(r_t)
            sig_ss.append(sig_s); sig_ts.append(sig_t)
            dens.append(den); sig_effs.append(sig_eff)

        Qmod = data.Q.at[1:].add(
            (sig_effs[0] + sig_effs[1])[:, :, None] * eye_x[None])
        Rmod = data.R + (sig_effs[2] + sig_effs[3])[:, :, None] * eye_u[None]
        fac = riccati_factorize(data.A, data.B, Qmod, Rmod, reg)

        gx_full = jnp.einsum("kij,kj->ki", data.Q, st.dx) + data.q
        gu_full = jnp.einsum("kij,kj->ki", data.R, st.du) + data.r
        r_eq = (data.c
                + jnp.einsum("kij,kj->ki", data.A, st.dx[:-1])
                + jnp.einsum("kij,kj->ki", data.B, st.du)
                - st.dx[1:])

        def rhs_w(i, T_s, T_t):
            """Soft elimination scalar w and RHS contribution b of group i."""
            g, sgn, m, sm = st.gs[i], signs[i], masks[i], softm[i]
            w = jnp.where(
                sm,
                -r_ts[i] + (T_s / g.s - g.lam)
                + (T_t / jnp.where(sm, g.t, 1.0) - g.gam)
                + sig_ss[i] * r_ss[i], 0.0)
            b = -sgn * jnp.where(
                m, T_s / g.s + sig_ss[i] * r_ss[i]
                - jnp.where(sm, sig_ss[i] * w / dens[i], 0.0), 0.0)
            return w, b

        def directions(Ts, Tts):
            ws_bs = [rhs_w(i, Ts[i], Tts[i]) for i in range(4)]
            bx = ws_bs[0][1] + ws_bs[1][1]
            bu = ws_bs[2][1] + ws_bs[3][1]
            q_rhs = gx_full.at[1:].add(bx)
            r_rhs = gu_full + bu
            d_dx, d_du = riccati_solve_rhs(fac, data.A, data.B, r_eq,
                                           q_rhs, r_rhs, dx0_zero)
            dvs = group_values(d_dx, d_du)
            dgs = []
            for i in range(4):
                g, sgn, m, sm = st.gs[i], signs[i], masks[i], softm[i]
                w = ws_bs[i][0]
                dt = jnp.where(sm, (w - sgn * sig_ss[i] * dvs[i]) / dens[i],
                               0.0)
                ds = jnp.where(m, sgn * dvs[i] + dt - r_ss[i], 0.0)
                dlam = jnp.where(m, (Ts[i] - g.s * g.lam - g.lam * ds) / g.s,
                                 0.0)
                dgam = jnp.where(
                    sm, (Tts[i] - g.t * g.gam - g.gam * dt)
                    / jnp.where(sm, g.t, 1.0), 0.0)
                dgs.append(_GS(s=ds, lam=dlam, t=dt, gam=dgam))
            return d_dx, d_du, tuple(dgs)

        def alphas(dgs, tau):
            a_p = jnp.asarray(1.0, dtype)
            a_d = jnp.asarray(1.0, dtype)
            for g, dg, m, sm in zip(st.gs, dgs, masks, softm):
                a_p = jnp.minimum(a_p, max_step(g.s, dg.s, m, tau))
                a_p = jnp.minimum(a_p, max_step(g.t, dg.t, sm, tau))
                a_d = jnp.minimum(a_d, max_step(g.lam, dg.lam, m, tau))
                a_d = jnp.minimum(a_d, max_step(g.gam, dg.gam, sm, tau))
            return jnp.minimum(1.0, a_p), jnp.minimum(1.0, a_d)

        zeros = tuple(jnp.zeros_like(r) for r in r_ss)
        # ---- predictor (affine scaling, targets 0) ----
        _, _, aff = directions(zeros, zeros)
        a_p_aff, a_d_aff = alphas(aff, 1.0)
        mu_aff = 0.0
        for g, dg, m, sm in zip(st.gs, aff, masks, softm):
            mu_aff += jnp.sum(jnp.where(
                m, (g.s + a_p_aff * dg.s) * (g.lam + a_d_aff * dg.lam), 0.0))
            mu_aff += jnp.sum(jnp.where(
                sm, (g.t + a_p_aff * dg.t) * (g.gam + a_d_aff * dg.gam), 0.0))
        mu_aff = mu_aff / n_pairs

        sigma = jnp.clip((mu_aff / jnp.maximum(mu_cur, mu_min)) ** 3, 0.0, 1.0)
        mu_t = jnp.maximum(sigma * mu_cur, mu_min)

        # ---- corrector (Gondzio-clipped per-constraint targets) ----
        def target(dv1, dv2):
            return jnp.clip(mu_t - dv1 * dv2, 0.05 * mu_t, 20.0 * mu_t)
        Ts = tuple(jnp.where(m, target(dg.s, dg.lam), 0.0)
                   for dg, m in zip(aff, masks))
        Tts = tuple(jnp.where(sm, target(dg.t, dg.gam), 0.0)
                    for dg, sm in zip(aff, softm))
        d_dx, d_du, dgs = directions(Ts, Tts)
        a_p, a_d = alphas(dgs, alpha_frac)

        eps_s = jnp.asarray(1e-9 if jnp.finfo(dtype).bits <= 32 else 1e-16,
                            dtype)
        new_gs = []
        for g, dg, m, sm in zip(st.gs, dgs, masks, softm):
            new_gs.append(_GS(
                s=jnp.where(m, jnp.maximum(g.s + a_p * dg.s, eps_s), _BIG),
                lam=jnp.clip(g.lam + a_d * dg.lam, 0.0, lam_max),
                t=jnp.where(sm, jnp.maximum(g.t + a_p * dg.t, eps_s), _BIG),
                gam=jnp.clip(g.gam + a_d * dg.gam, 0.0, lam_max),
            ))
        return _St(dx=st.dx + a_p * d_dx, du=st.du + a_p * d_du,
                   gs=tuple(new_gs))

    def merit(st: _St):
        shim = _IpmState(
            dx=st.dx, du=st.du,
            s_lx=st.gs[0].s, s_ux=st.gs[1].s,
            lam_lx=st.gs[0].lam, lam_ux=st.gs[1].lam,
            s_lu=st.gs[2].s, s_uu=st.gs[3].s,
            lam_lu=st.gs[2].lam, lam_uu=st.gs[3].lam,
        )
        kkt_stat, kkt_eq = _kkt_residuals(data, shim, *masks)
        # soft stationarity: z + Z t - lam - gam = 0 on soft entries
        r_t_max = 0.0
        for g, sm, pen in zip(st.gs, softm, pens):
            r_t_max = jnp.maximum(r_t_max, jnp.max(jnp.abs(jnp.where(
                sm, pen.z + pen.Z * g.t - g.lam - g.gam, 0.0))))
        m = kkt_stat + kkt_eq + r_t_max + comp_sum(st.gs) / n_pairs
        return m, kkt_stat, kkt_eq

    # Best-iterate selection (same rationale as qp/ipm.py: a static budget
    # past convergence must be harmless).
    def step_and_select(carry, _):
        st, best, best_m = carry
        st = iteration(st)
        m, _, _ = merit(st)
        better = m < best_m
        best = jax.tree.map(lambda n, b: jnp.where(better, n, b), st, best)
        best_m = jnp.where(better, m, best_m)
        return (st, best, best_m), None

    m0, _, _ = merit(state0)
    (_, best, _), _ = jax.lax.scan(step_and_select, (state0, state0, m0),
                                   None, length=iters)

    _, kkt_stat, kkt_eq = merit(best)
    sol = QPSolution(
        dx=best.dx, du=best.du,
        lam_lx=best.gs[0].lam, lam_ux=best.gs[1].lam,
        lam_lu=best.gs[2].lam, lam_uu=best.gs[3].lam,
        mu=comp_sum(best.gs) / n_pairs, kkt_stat=kkt_stat, kkt_eq=kkt_eq,
        iters=jnp.asarray(iters),
        s_lx=best.gs[0].s, s_ux=best.gs[1].s,
        s_lu=best.gs[2].s, s_uu=best.gs[3].s,
    )

    def viol(g, sm):
        return jnp.where(sm, g.t, 0.0)
    return SoftQPSolution(
        sol=sol,
        t_lx=viol(best.gs[0], softm[0]), t_ux=viol(best.gs[1], softm[1]),
        t_lu=viol(best.gs[2], softm[2]), t_uu=viol(best.gs[3], softm[3]),
    )
