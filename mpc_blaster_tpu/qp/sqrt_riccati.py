"""Square-root (array-form) Riccati factorization — f32-stable Newton core.

The plain Riccati recursion (`qp/riccati.py`) forms H_uu = R + B'PB and
P_k = Q + A'PA - H_ux' H_uu^-1 H_ux explicitly. With interior-point
barrier curvature on DENSE rows (partial condensing's general constraints,
`qp/condense.py`) the modified Hessians condition at ~sigma_max/reg ~ 1e10+
and the final subtraction cancels catastrophically in f32 — measured: the
first Newton direction of the sim-preset transient QP came out 170% wrong,
and iterative refinement *diverges* because cond * eps_f32 > 1. HPIPM's
answer is double precision (it is f64-only); the f32 answer here is the
classical square-root array algorithm [Kailath, "Linear Estimation"; the
LQR dual of square-root Kalman filtering]:

    Per stage, stack rows F with  F'F = [[Rmod, Smod], [Smod', Qmod]]
    (cost factors + barrier rows — each row an ORIGINAL data row times a
    sqrt-sigma, so the Gram is never formed) on top of Z_{k+1} [B | A]
    (Z = upper Cholesky factor of the value Hessian, P = Z'Z), and QR:

        F = O [ Ruu  Rux ]     =>  H_uu = Ruu' Ruu   (never formed)
              [  0   Z_k ]         K    = -Ruu^-1 Rux (triangular solve)
                                   P_k  = Z_k' Z_k    (never formed)

    The subtraction Q + A'PA - Hux'Huu^-1 Hux happens *inside* the
    orthogonal transform, on quantities whose condition number is the
    SQUARE ROOT of the plain recursion's — 1e10 -> 1e5, comfortably f32.

Interface mirrors `riccati_factorize`/`riccati_solve_rhs` (one factor,
many RHS solves — the Mehrotra predictor/corrector split), with the
stage cost supplied as row factors C_k instead of (Q, R, S) matrices.

Cost: one QR of an (m + nx) x (nu + nx) stack per stage, sequential over
the horizon. jnp.linalg.qr lowers to a custom call — this backend
trades kernel-fusion speed for numerical range, which is the right trade
for the condensed (offline/long-horizon) path; the hot RTI path keeps the
fused plain recursion, whose 6x6 axis-aligned blocks equilibrate fine.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular


class SqrtRiccatiFactor(NamedTuple):
    K: jnp.ndarray     # (N, nu, nx) feedback gains
    Ruu: jnp.ndarray   # (N, nu, nu) upper-tri, H_uu = Ruu' Ruu
    Z: jnp.ndarray     # (N+1, nx, nx) value factors, P_k = Z_k' Z_k


def sqrt_factorize(A: jnp.ndarray, B: jnp.ndarray, C: jnp.ndarray,
                   ZN: jnp.ndarray) -> SqrtRiccatiFactor:
    """Matrix-only backward pass on row factors.

    A (N, nx, nx); B (N, nx, nu); C (N, m, nu+nx) stage-cost row factors
    with C_k' C_k = [[Rmod_k, Smod_k], [Smod_k', Qmod_k]] (columns ordered
    [u | x]); ZN (nx, nx) terminal factor with P_N = ZN' ZN.
    """
    nu = B.shape[-1]

    def bwd(Z_next, inputs):
        A_k, B_k, C_k = inputs
        BA = jnp.concatenate([B_k, A_k], axis=-1)      # (nx, nu+nx)
        F = jnp.concatenate([C_k, Z_next @ BA], axis=-2)
        R = jnp.linalg.qr(F, mode="r")                 # (nu+nx, nu+nx)
        Ruu = R[:nu, :nu]
        Rux = R[:nu, nu:]
        Z_k = R[nu:, nu:]
        K_k = -solve_triangular(Ruu, Rux, lower=False)
        return Z_k, (K_k, Ruu, Z_next)

    Z0, (Ks, Ruus, Z_nexts) = jax.lax.scan(bwd, ZN, (A, B, C),
                                           reverse=True)
    Zs = jnp.concatenate([Z0[None], Z_nexts], axis=0)
    return SqrtRiccatiFactor(K=Ks, Ruu=Ruus, Z=Zs)


def riccati_factorize_sqrt(A, B, Q, R, reg: float = 0.0
                           ) -> SqrtRiccatiFactor:
    """Drop-in analog of `riccati.riccati_factorize` on the sqrt core.

    For the box-constrained IPM the modified stage Hessians (Q, R) are the
    benign data Hessians plus DIAGONAL barrier terms, so forming them
    involves no cancellation; the f32 hazard is the value recursion's
    subtraction at |P| ~ sigma_max, which the QR array form absorbs.
    Cost factors come from the Jacobi-equilibrated unrolled Cholesky
    (smallalg.chol_factor) — diagonal spread is free there.

    Pair with `sqrt_solve_rhs` (same call signature as
    `riccati.riccati_solve_rhs`). Select via box_qp_solve(riccati="sqrt").
    """
    N = A.shape[0]
    nx, nu = A.shape[-1], B.shape[-1]
    dtype = A.dtype
    from mpc_blaster_tpu.qp.smallalg import chol_factor
    I_u = jnp.eye(nu, dtype=dtype)
    Lr = chol_factor(R + reg * I_u[None])
    Lq = chol_factor(Q[:-1])
    rows_r = jnp.concatenate(
        [jnp.swapaxes(Lr, -1, -2), jnp.zeros((N, nu, nx), dtype)], axis=-1)
    rows_q = jnp.concatenate(
        [jnp.zeros((N, nx, nu), dtype), jnp.swapaxes(Lq, -1, -2)], axis=-1)
    C = jnp.concatenate([rows_r, rows_q], axis=-2)
    ZN = jnp.swapaxes(chol_factor(Q[-1]), -1, -2)
    return sqrt_factorize(A, B, C, ZN)


def _h_solve(Ruu, v):
    """H_uu^-1 v via two triangular solves (H_uu = Ruu' Ruu)."""
    y = solve_triangular(Ruu, v, lower=False, trans=1)
    return solve_triangular(Ruu, y, lower=False)


def sqrt_solve_rhs(fac: SqrtRiccatiFactor, A, B, c, q, r, dx0
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Vector-only backward + forward pass for a given RHS (q, r, c, dx0).

    Same recursion as `riccati.riccati_solve_rhs`, with P products formed
    as Z'(Z v) and H_uu solves as triangular solves against Ruu.
    """
    def bwd(p_next, inputs):
        A_k, B_k, c_k, q_k, r_k, K_k, Ruu_k, Z_next = inputs
        Pc_p = Z_next.T @ (Z_next @ c_k) + p_next
        G_u = r_k + B_k.T @ Pc_p
        k_k = -_h_solve(Ruu_k, G_u)
        p_k = q_k + A_k.T @ Pc_p + K_k.T @ G_u
        return p_k, k_k

    _, ks = jax.lax.scan(
        bwd, q[-1], (A, B, c, q[:-1], r, fac.K, fac.Ruu, fac.Z[1:]),
        reverse=True)

    # forward rollout (emit the new carry — see riccati.py's XLA-CPU note)
    def fwd(dx, inputs):
        A_k, B_k, c_k, K_k, k_k = inputs
        du = K_k @ dx + k_k
        dx_next = A_k @ dx + B_k @ du + c_k
        return dx_next, (dx_next, du)

    _, (dx_tail, dus) = jax.lax.scan(fwd, dx0, (A, B, c, fac.K, ks))
    dx_all = jnp.concatenate([dx0[None], dx_tail], axis=0)
    return dx_all, dus
