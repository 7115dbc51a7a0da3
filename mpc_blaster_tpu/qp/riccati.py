"""Equality-constrained LQR via backward Riccati sweep (`lax.scan`).

This is the factorization core of the HPIPM replacement: HPIPM solves each
interior-point Newton system with a Riccati-based block factorization over
the horizon (SURVEY.md §2.2); here that recursion is a `lax.scan` of small
dense ops, jit-fused end to end, `vmap`-able over scenario batches.

Split into a *factor* pass (matrices only: feedback gains K, Cholesky
factors of H_uu, value Hessians P) and a *solve* pass (vectors only:
feedforwards from gradients + affine defects). The interior-point method
factors once per iteration and solves twice (Mehrotra predictor+corrector)
— exactly the split HPIPM exploits.

Solves  min  sum_k 0.5 dx'Q_k dx + q_k'dx + 0.5 du'R_k du + r_k'du
             + 0.5 dx_N'Q_N dx_N + q_N'dx_N
        s.t. dx_{k+1} = A_k dx_k + B_k du_k + c_k,   dx_0 given.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from mpc_blaster_tpu.qp.data import QPData, QPSolution, full_precision
from mpc_blaster_tpu.qp.smallalg import spd_inverse


class RiccatiFactor(NamedTuple):
    K: jnp.ndarray      # (N, nu, nx) feedback gains
    Hinv: jnp.ndarray   # (N, nu, nu) inverses of H_uu
    P: jnp.ndarray      # (N+1, nx, nx) value Hessians


def riccati_factorize(A, B, Q, R, reg: float = 0.0, S=None) -> RiccatiFactor:
    """Matrix-only backward pass: P_k, K_k, inv(H_uu)_k.

    H_uu is inverted via the unrolled small-Cholesky (smallalg.py): XLA
    lowers jnp.linalg.cholesky/triangular_solve of 6x6 blocks to custom
    calls, while the unrolled form fuses into the scan body.

    S (optional, (N, nu, nx)): cost cross terms 'u S x' — produced by
    partial condensing (`qp/condense.py`); H_ux becomes S + B'PA and
    nothing else changes (the solve pass is cross-term-agnostic).
    """
    nu = B.shape[-1]
    I_u = jnp.eye(nu, dtype=B.dtype)
    if S is None:
        S = jnp.zeros(B.shape[:-2] + (nu, A.shape[-1]), B.dtype)

    def bwd(P_next, inputs):
        A_k, B_k, Q_k, R_k, S_k = inputs
        PA = P_next @ A_k
        PB = P_next @ B_k
        H_uu = R_k + B_k.T @ PB + reg * I_u
        H_ux = S_k + B_k.T @ PA
        Hinv = spd_inverse(H_uu)
        K_k = -(Hinv @ H_ux)
        P_k = Q_k + A_k.T @ PA + H_ux.T @ K_k
        P_k = 0.5 * (P_k + P_k.T)
        return P_k, (K_k, Hinv, P_next)

    P0, (Ks, Hinvs, P_nexts) = jax.lax.scan(
        bwd, Q[-1], (A, B, Q[:-1], R, S), reverse=True)
    Ps = jnp.concatenate([P0[None], P_nexts], axis=0)
    return RiccatiFactor(K=Ks, Hinv=Hinvs, P=Ps)


def riccati_solve_rhs(fac: RiccatiFactor, A, B, c, q, r, dx0
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Vector-only backward + forward pass for a given RHS (q, r, c, dx0)."""
    def bwd(p_next, inputs):
        A_k, B_k, c_k, q_k, r_k, K_k, Hinv_k, P_next = inputs
        Pc_p = P_next @ c_k + p_next
        G_u = r_k + B_k.T @ Pc_p
        k_k = -(Hinv_k @ G_u)
        p_k = q_k + A_k.T @ Pc_p + K_k.T @ G_u
        return p_k, k_k

    _, ks = jax.lax.scan(
        bwd, q[-1], (A, B, c, q[:-1], r, fac.K, fac.Hinv, fac.P[1:]),
        reverse=True)

    # NOTE: the forward scan must emit the *new* carry (dx_next), never the
    # incoming carry value: emitting the carry input as a ys output triggers
    # a buffer-aliasing miscompilation under vmap on the XLA CPU backend
    # (observed with heterogeneous batch=4: the stacked ys of one batch
    # element violate the scan recursion itself). Emitting dx_next and
    # prepending dx0 is equivalent and compiles correctly everywhere.
    def fwd(dx, inputs):
        A_k, B_k, c_k, K_k, k_k = inputs
        du = K_k @ dx + k_k
        dx_next = A_k @ dx + B_k @ du + c_k
        return dx_next, (dx_next, du)

    _, (dx_tail, dus) = jax.lax.scan(fwd, dx0, (A, B, c, fac.K, ks))
    dx_all = jnp.concatenate([dx0[None], dx_tail], axis=0)
    return dx_all, dus


def riccati_solve(A, B, c, Q, q, R, r, dx0, reg: float = 0.0
                  ) -> Tuple[jnp.ndarray, jnp.ndarray, RiccatiFactor]:
    """Full solve: factorize + RHS. Returns (dx (N+1,nx), du (N,nu), factor)."""
    fac = riccati_factorize(A, B, Q, R, reg)
    dx, du = riccati_solve_rhs(fac, A, B, c, q, r, dx0)
    return dx, du, fac


@full_precision
def lqr_solve(data: QPData, reg: float = 0.0) -> QPSolution:
    """Solve the unconstrained (equality-only) OCP QP (full-precision
    matmuls: reduced-precision defaults such as TF32 are fatal to Riccati
    numerics)."""
    dx, du, _ = riccati_solve(data.A, data.B, data.c, data.Q, data.q,
                              data.R, data.r, data.dx0, reg)
    return QPSolution(dx=dx, du=du)


def lqr_kkt_residuals(data: QPData, dx: jnp.ndarray, du: jnp.ndarray):
    """(stationarity_inf, equality_inf) for the equality-only QP.

    Costates are recovered by the adjoint recursion lam_N = Q_N dx_N + q_N,
    lam_k = Q_k dx_k + q_k + A_k' lam_{k+1}; the nontrivial stationarity
    rows are the control rows R_k du_k + r_k + B_k' lam_{k+1} = 0.
    """
    lam = data.Q[-1] @ dx[-1] + data.q[-1]
    stat = jnp.zeros((), dx.dtype)
    for k in range(data.horizon - 1, -1, -1):  # small N; test-only helper
        stat_u = data.R[k] @ du[k] + data.r[k] + data.B[k].T @ lam
        stat = jnp.maximum(stat, jnp.max(jnp.abs(stat_u)))
        lam = data.Q[k] @ dx[k] + data.q[k] + data.A[k].T @ lam
    eq = jnp.max(jnp.abs(
        dx[1:] - jnp.einsum("kij,kj->ki", data.A, dx[:-1])
        - jnp.einsum("kij,kj->ki", data.B, du) - data.c))
    eq = jnp.maximum(eq, jnp.max(jnp.abs(dx[0] - data.dx0)))
    return stat, eq
