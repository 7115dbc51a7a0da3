"""Horizon-parallel LQR via associative scan — sequence parallelism.

The reference's only answer to horizon growth is HPIPM partial condensing
(`blastermodel.py:284`, with cond_N = N i.e. none, SURVEY.md §5
"long-context" row). The answer here: the backward value recursion of
the LQR is an *associative* operation on conditional-value-function
elements (Särkkä & García-Fernández, temporal parallelization of LQR/
smoothers), so `jax.lax.associative_scan` evaluates it in O(log N) depth —
and when the stage axis is sharded over a device mesh, XLA turns the scan
tree into collectives: the direct analog of sequence parallelism in
transformer training.

Element e = (A, b, C, eta, J) represents the span value function
  V_e(x, z) = 1/2 x'Jx - eta'x + max_lam [lam'(z - Ax - b) - 1/2 lam'C lam]
Stage init (integrating out u):
  A_e = A_k, b_e = c_k - B R^-1 r, C_e = B R^-1 B', J_e = Q_k, eta_e = -q_k
Terminal element: (0, 0, 0, -q_N, Q_N).
Suffix-combining stages k..N gives V_k: P_k = J, p_k = -eta.

The forward rollout is likewise an associative prefix scan of affine maps
(F, g) with F_k = A_k + B_k K_k.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from mpc_blaster_tpu.qp.data import QPData, QPSolution, full_precision
from mpc_blaster_tpu.qp.riccati import RiccatiFactor
from mpc_blaster_tpu.qp.smallalg import chol_inverse


class _Elem(NamedTuple):
    A: jnp.ndarray    # (..., nx, nx)
    b: jnp.ndarray    # (..., nx)
    C: jnp.ndarray    # (..., nx, nx)
    eta: jnp.ndarray  # (..., nx)
    J: jnp.ndarray    # (..., nx, nx)


def _combine(e1: _Elem, e2: _Elem) -> _Elem:
    """Combine earlier-span e1 with later-span e2 (associative)."""
    nx = e1.A.shape[-1]
    I = jnp.eye(nx, dtype=e1.A.dtype)
    # D = (I + C1 J2)^-1 ; its transpose-relation gives (I + J2 C1)^-1 = D'
    # for symmetric C1, J2 via J2 D = D'^... use two solves for clarity.
    M = I + e1.C @ e2.J
    D = jnp.linalg.solve(M, jnp.broadcast_to(I, M.shape))
    A = e2.A @ D @ e1.A
    b = (e2.A @ (D @ (e1.b[..., None]
                      + e1.C @ e2.eta[..., None])))[..., 0] + e2.b
    C = e2.A @ D @ e1.C @ e2.A.swapaxes(-1, -2) + e2.C
    # (I + J2 C1)^-1 = D^T for symmetric C1, J2
    Dt = D.swapaxes(-1, -2)
    eta = (e1.A.swapaxes(-1, -2) @ (Dt @ (e2.eta[..., None]
           - e2.J @ e1.b[..., None])))[..., 0] + e1.eta
    J = e1.A.swapaxes(-1, -2) @ Dt @ e2.J @ e1.A + e1.J
    J = 0.5 * (J + J.swapaxes(-1, -2))
    return _Elem(A=A, b=b, C=C, eta=eta, J=J)


def backward_pass_pscan(A, B, c, Q, q, R, r, reg: float = 0.0
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(P (N+1, nx, nx), p (N+1, nx)) via O(log N) associative suffix scan."""
    N, nx, nu = A.shape[0], A.shape[-1], B.shape[-1]
    dtype = A.dtype
    Rreg = R + reg * jnp.eye(nu, dtype=dtype)
    Rinv = chol_inverse(Rreg)
    BRinv = B @ Rinv                                  # (N, nx, nu)
    C = BRinv @ B.swapaxes(-1, -2)                    # (N, nx, nx)
    b = c - (BRinv @ r[..., None])[..., 0]            # (N, nx)
    elems = _Elem(
        A=jnp.concatenate([A, jnp.zeros((1, nx, nx), dtype)], axis=0),
        b=jnp.concatenate([b, jnp.zeros((1, nx), dtype)], axis=0),
        C=jnp.concatenate([C, jnp.zeros((1, nx, nx), dtype)], axis=0),
        eta=jnp.concatenate([-q[:-1], -q[-1:]], axis=0),
        J=Q,
    )
    # reverse=True feeds the operator (later-combined, earlier); our combine
    # signature is (earlier, later), hence the swap.
    suffix = jax.lax.associative_scan(lambda a, b: _combine(b, a), elems,
                                      reverse=True)
    P = suffix.J
    p = -suffix.eta
    return P, p


@full_precision
def lqr_solve_pscan(data: QPData, reg: float = 0.0) -> QPSolution:
    """Equality-only OCP QP solved with O(log N) parallel depth.

    Same solution as `riccati.lqr_solve`; preferable when the horizon axis
    is long and/or sharded over a mesh ("hp" sequence parallelism).
    """
    dx, du = eqp_solve_pscan(data.A, data.B, data.c, data.Q, data.q,
                             data.R, data.r, data.dx0, reg)
    return QPSolution(dx=dx, du=du)


def eqp_solve_pscan(A, B, c, Q, q, R, r, dx0, reg: float = 0.0):
    """Equality-constrained LQR solve with O(log N) parallel depth.

    Same solution as `riccati.lqr_solve`; used standalone by
    `lqr_solve_pscan`. The IPM's `riccati="pscan"` mode (`qp/ipm.py`) does
    NOT call this whole-solve entry (it would re-factorize on both the
    Mehrotra predictor and corrector solves); it uses the factor/solve
    split below (`riccati_factorize_pscan` + `riccati_solve_rhs_pscan`):
    at batch=1 the sequential per-stage Riccati sweeps dominate solve
    latency, and the associative-scan tree cuts that critical path from
    O(N) to O(log N) — the parallel answer to HPIPM's tuned sequential kernels.
    """
    nx, nu = A.shape[-1], B.shape[-1]
    dtype = A.dtype
    P, p = backward_pass_pscan(A, B, c, Q, q, R, r, reg)

    # Per-stage gains from (P_{k+1}, p_{k+1}) — all stages in parallel.
    P1, p1 = P[1:], p[1:]
    Huu = R + jnp.einsum("kji,kjl,klm->kim", B, P1, B) \
        + reg * jnp.eye(nu, dtype=dtype)
    Hux = jnp.einsum("kji,kjl,klm->kim", B, P1, A)
    Hinv = chol_inverse(Huu)
    K = -(Hinv @ Hux)
    Gu = r + jnp.einsum("kji,kj->ki", B,
                        jnp.einsum("kij,kj->ki", P1, c) + p1)
    kff = -(Hinv @ Gu[..., None])[..., 0]

    # Forward rollout as an associative prefix scan of affine maps.
    F = A + B @ K
    g = (B @ kff[..., None])[..., 0] + c

    def compose(m1, m2):
        F1, g1 = m1
        F2, g2 = m2
        return F2 @ F1, (F2 @ g1[..., None])[..., 0] + g2

    Fs, gs = jax.lax.associative_scan(compose, (F, g))
    dx_tail = jnp.einsum("kij,j->ki", Fs, dx0) + gs
    dx = jnp.concatenate([dx0[None], dx_tail], axis=0)
    du = jnp.einsum("kij,kj->ki", K, dx[:-1]) + kff
    return dx, du


# --------- factor/solve split for the IPM (one factor, many RHS) ---------

class _MatElem(NamedTuple):
    """Matrix-only part of the value-function element (factorization)."""

    A: jnp.ndarray    # (N+1, nx, nx)
    C: jnp.ndarray    # (N+1, nx, nx)
    J: jnp.ndarray    # (N+1, nx, nx)


def _combine_mat(e1: _MatElem, e2: _MatElem) -> _MatElem:
    """Matrix rows of `_combine` (earlier e1, later e2): b/eta drop out."""
    nx = e1.A.shape[-1]
    I = jnp.eye(nx, dtype=e1.A.dtype)
    M = I + e1.C @ e2.J
    D = jnp.linalg.solve(M, jnp.broadcast_to(I, M.shape))
    A = e2.A @ D @ e1.A
    C = e2.A @ D @ e1.C @ e2.A.swapaxes(-1, -2) + e2.C
    J = e1.A.swapaxes(-1, -2) @ D.swapaxes(-1, -2) @ e2.J @ e1.A + e1.J
    J = 0.5 * (J + J.swapaxes(-1, -2))
    return _MatElem(A=A, C=C, J=J)


def riccati_factorize_pscan(A, B, Q, R, reg: float = 0.0) -> RiccatiFactor:
    """O(log N)-depth Riccati factorization via matrix-only associative scan.

    Produces the same `RiccatiFactor` (gains K, inverses of H_uu, value
    Hessians P) as `riccati.riccati_factorize`, so the two RHS solves of a
    Mehrotra IPM iteration can reuse one factorization regardless of
    backend. The per-element combine solves an (nx, nx) system; that
    is a batched LU custom call per tree level — heavier per step
    than the sequential sweep's body, but only log2(N) levels deep.
    """
    N, nx, nu = A.shape[0], A.shape[-1], B.shape[-1]
    dtype = A.dtype
    Rreg = R + reg * jnp.eye(nu, dtype=dtype)
    Rinv = chol_inverse(Rreg)
    BRinv = B @ Rinv
    C = BRinv @ B.swapaxes(-1, -2)
    elems = _MatElem(
        A=jnp.concatenate([A, jnp.zeros((1, nx, nx), dtype)], axis=0),
        C=jnp.concatenate([C, jnp.zeros((1, nx, nx), dtype)], axis=0),
        J=Q,
    )
    suffix = jax.lax.associative_scan(lambda a, b: _combine_mat(b, a),
                                      elems, reverse=True)
    P = suffix.J                                       # (N+1, nx, nx)

    # Per-stage gains from P_{k+1}, all stages in parallel.
    P1 = P[1:]
    Huu = R + jnp.einsum("kji,kjl,klm->kim", B, P1, B) \
        + reg * jnp.eye(nu, dtype=dtype)
    Hux = jnp.einsum("kji,kjl,klm->kim", B, P1, A)
    Hinv = chol_inverse(Huu)
    K = -(Hinv @ Hux)
    return RiccatiFactor(K=K, Hinv=Hinv, P=P)


def riccati_solve_rhs_pscan(fac: RiccatiFactor, A, B, c, q, r, dx0
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """O(log N)-depth RHS solve against an existing `RiccatiFactor`.

    Same solution as `riccati.riccati_solve_rhs`. Given the factor, both
    the backward costate recursion p_k = F_k' p_{k+1} + h_k (with
    F_k = A_k + B_k K_k closed-loop) and the forward rollout are affine
    recursions, i.e. associative prefix/suffix scans of (matrix, vector)
    pairs — each tree level is one batched (nx, nx) matmul, so the
    critical path is 2 log2(N) matmuls instead of 2N sequential matvecs.
    This is what makes the IPM's "pscan"/"hybrid" modes latency-optimal at
    batch=1 (`qp/ipm.py::box_qp_solve`).
    """
    K, Hinv, P = fac.K, fac.Hinv, fac.P
    nx = A.shape[-1]
    dtype = A.dtype
    F = A + B @ K                                       # (N, nx, nx)
    Pc = jnp.einsum("kij,kj->ki", P[1:], c)
    h = q[:-1] + jnp.einsum("kij,ki->kj", K, r) \
        + jnp.einsum("kij,ki->kj", F, Pc)               # F' (P1 c) etc.

    # suffix scan of affine maps p_k = Ft_k p_{k+1} + h_k, p_N = q_N
    Ft = F.swapaxes(-1, -2)
    Ms = jnp.concatenate([Ft, jnp.zeros((1, nx, nx), dtype)], axis=0)
    vs = jnp.concatenate([h, q[-1:]], axis=0)

    def comp_affine(earlier, later):
        Me, ve = earlier
        Ml, vl = later
        return Me @ Ml, jnp.einsum("kij,kj->ki", Me, vl) + ve

    _, ps = jax.lax.associative_scan(
        lambda a, b: comp_affine(b, a), (Ms, vs), reverse=True)
    p1 = ps[1:]                                         # p_1..p_N

    Gu = r + jnp.einsum("kji,kj->ki", B, Pc + p1)
    kff = -(Hinv @ Gu[..., None])[..., 0]

    # forward prefix scan of affine maps dx_{k+1} = F_k dx_k + g_k
    g = (B @ kff[..., None])[..., 0] + c

    def comp_fwd(m1, m2):
        F1, g1 = m1
        F2, g2 = m2
        return F2 @ F1, (F2 @ g1[..., None])[..., 0] + g2

    Fs, gs = jax.lax.associative_scan(comp_fwd, (F, g))
    dx_tail = jnp.einsum("kij,j->ki", Fs, dx0) + gs
    dx = jnp.concatenate([dx0[None], dx_tail], axis=0)
    du = jnp.einsum("kij,kj->ki", K, dx[:-1]) + kff
    return dx, du
