"""Unrolled small-matrix algebra for the Riccati hot path.

XLA lowers `jnp.linalg.cholesky` / triangular solves to custom calls,
which cannot fuse with their neighbours, for tiny (nu=6) blocks and under
vmap over scenario batches alike. These routines unroll the factorization
at trace time into plain elementwise ops (n^3/3 multiplies for n=6 is 72
flops), which XLA fuses and vectorizes over any leading batch dims — the
moral equivalent of BLASFEO's fixed-size panel kernels inside HPIPM
(SURVEY.md §2.2).
"""
from __future__ import annotations

import jax.numpy as jnp


def chol_unrolled(M: jnp.ndarray):
    """Lower-Cholesky of SPD (..., n, n), entries as a python list-of-lists
    of (...,) arrays, plus the minimum raw pivot (the definiteness
    certificate). n must be small (trace-time unrolled).

    Pivots are floored at 1e-12 so an epsilon-negative pivot (f32
    cancellation) cannot emit NaN; callers should inspect min_pivot to
    detect an indefinite input (negative pivots mean the "factor" is
    garbage even though it is finite)."""
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    min_piv = None
    for j in range(n):
        s = M[..., j, j]
        for p in range(j):
            s = s - L[j][p] * L[j][p]
        min_piv = s if min_piv is None else jnp.minimum(min_piv, s)
        d = jnp.sqrt(jnp.maximum(s, 1e-12))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = M[..., i, j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            L[i][j] = s * inv_d
    return L, min_piv


def chol_factor(M: jnp.ndarray) -> jnp.ndarray:
    """Dense lower-Cholesky factor L (M = L L') of a PSD (..., n, n).

    Unrolled at trace time (small n), batched over leading dims,
    Jacobi-equilibrated (factor the unit-diagonal rescaling, then scale
    the rows back — D L_scaled is still lower-triangular) so diagonal
    scale spread costs no f32 accuracy. Pivots are floored at 1e-12
    (chol_unrolled), so exactly-singular PSD inputs (e.g. a zero cost
    row) yield a finite factor whose Gram differs from M only by ~1e-12
    on the null directions — the use case is row-stacked square-root
    cost factors (qp/sqrt_riccati.py), where that bias is a harmless
    regularization.
    """
    n = M.shape[-1]
    diag = jnp.diagonal(M, axis1=-2, axis2=-1)
    d = jnp.sqrt(jnp.maximum(diag, 1e-30))
    L, _ = chol_unrolled(M / (d[..., :, None] * d[..., None, :]))
    zero = L[0][0] * 0
    rows = [jnp.stack([L[i][j] if j <= i else zero for j in range(n)],
                      axis=-1) for i in range(n)]
    return jnp.stack(rows, axis=-2) * d[..., :, None]


def chol_inverse(M: jnp.ndarray) -> jnp.ndarray:
    """Inverse of an SPD (..., n, n) via unrolled Cholesky: M^-1 = L^-T L^-1.

    Jacobi-equilibrated and FAIL-SAFE: the matrix is scaled to unit
    diagonal before factorization (the IPM's barrier-modified Hessians mix
    diagonal scales across ~14 orders of magnitude — R_swivel*dt ~ 3e-7
    against barrier sigmas capped at 1e7 — and an unequilibrated f32
    Cholesky loses every digit of the small block), and if the input is
    detected indefinite (negative pivot, or a non-positive diagonal: f32
    cancellation degrades the Riccati P's small eigendirections at
    |P| ~ 1e7 scale), the ZERO matrix is returned instead of a garbage
    inverse. Zero is the IPM-safe sentinel: the Riccati gain for that
    stage collapses to K = 0 (feedback frozen, P recursion stays finite)
    instead of exploding the whole factorization to inf/NaN — the same
    role as HPIPM's on-failure regularization, chosen to be vectorizable
    per batch element."""
    diag = jnp.diagonal(M, axis1=-2, axis2=-1)
    diag_ok = jnp.all(diag > 0.0, axis=-1)
    d = jnp.sqrt(jnp.maximum(diag, 1e-30))
    M = M / (d[..., :, None] * d[..., None, :])
    n = M.shape[-1]
    L, min_piv = chol_unrolled(M)
    ok = diag_ok & (min_piv > 1e-10)
    # invert the lower-triangular factor
    Li = [[None] * n for _ in range(n)]
    for j in range(n):
        Li[j][j] = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = L[i][j] * Li[j][j]
            for k in range(j + 1, i):
                s = s + L[i][k] * Li[k][j]
            Li[i][j] = -s / L[i][i]
    rows = []
    for i in range(n):
        cols = []
        for j in range(n):
            s = None
            for k in range(max(i, j), n):
                term = Li[k][i] * Li[k][j]
                s = term if s is None else s + term
            cols.append(s)
        rows.append(jnp.stack(cols, axis=-1))
    inv = jnp.stack(rows, axis=-2)
    inv = inv / (d[..., :, None] * d[..., None, :])
    return jnp.where(ok[..., None, None], inv, 0.0)


def spd_inverse(M: jnp.ndarray, base: int = 8) -> jnp.ndarray:
    """Inverse of an SPD (..., n, n) matrix, compile-size-bounded.

    For n <= base, the fully-unrolled Cholesky (`chol_inverse`) is optimal:
    ~n^3/3 scalar ops that XLA fuses into the surrounding graph. But the
    unrolled form emits O(n^3) *individual HLO ops*, which explodes compile
    time/memory for the (M*nu)-sized Hessians of partial condensing
    (`qp/condense.py`: n = 30 -> ~30k scalar ops -> multi-GB XLA compiles,
    measured). Above `base` we recurse on the 2x2 block Schur complement

        inv([[A, B], [B', C]]) via Ai = inv(A), S = C - B' Ai B

    which emits a handful of dense matmuls per level (log2(n/base)
    levels) and keeps the scalar unrolling at the leaves. Schur complements
    of SPD matrices are SPD, so the recursion is well-posed.

    The whole matrix is Jacobi-equilibrated ONCE at the top before the
    recursion (unit diagonal => every off-diagonal entry of an SPD matrix
    is <= 1 in magnitude, and so is every Schur complement's). Without
    this, S = C - B' A^-1 B is formed in raw scale: the condensed IPM's
    barrier-modified Hessians span ~14 decades and the f32 cancellation
    in that subtraction destroyed the Newton directions whenever state
    boxes were active (measured: kkt_stat ~7e2 vs ~1 on the same QP on
    the full-horizon path, whose 6x6 blocks are leaf-equilibrated).
    """
    n = M.shape[-1]
    if n <= base:
        return chol_inverse(M)
    diag = jnp.diagonal(M, axis1=-2, axis2=-1)
    d = jnp.sqrt(jnp.maximum(diag, 1e-30))
    inv = _spd_inverse_rec(M / (d[..., :, None] * d[..., None, :]), base)
    return inv / (d[..., :, None] * d[..., None, :])


def _spd_inverse_rec(M: jnp.ndarray, base: int) -> jnp.ndarray:
    n = M.shape[-1]
    if n <= base:
        return chol_inverse(M)
    h = n // 2
    A = M[..., :h, :h]
    B = M[..., :h, h:]
    C = M[..., h:, h:]
    Ai = _spd_inverse_rec(A, base)
    AiB = Ai @ B
    S = C - jnp.swapaxes(B, -1, -2) @ AiB
    Si = _spd_inverse_rec(S, base)
    AiB_Si = AiB @ Si
    TL = Ai + AiB_Si @ jnp.swapaxes(AiB, -1, -2)
    TR = -AiB_Si
    BL = jnp.swapaxes(TR, -1, -2)
    top = jnp.concatenate([TL, TR], axis=-1)
    bot = jnp.concatenate([BL, Si], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)
