"""Block-structured OCP-QP data as stacked pytrees.

This is the JAX analog of the OCP-QP interface acados hands to HPIPM
(`blastermodel.py:274` `PARTIAL_CONDENSING_HPIPM`): per-stage quadratic cost,
affine dynamics, and box bounds on states and controls, all stacked along a
leading horizon axis so `lax.scan` streams over stages and
`vmap` batches over scenarios.

All quantities are in "delta" form around a linearization trajectory
((xbar, ubar)): the decision variables are dx_k = x_k - xbar_k,
du_k = u_k - ubar_k. Stage 0 state is pinned: dx_0 = dx0 (the acados
x0-equality-bound trick, `simulation_blaster.py:60-61`, JSON `nbxe_0=17`).
State box bounds therefore apply at stages 1..N, control bounds at 0..N-1.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

# Matmul precision of every matmul on the controller's path. Reduced-
# precision matmul defaults (bf16 passes, TF32 on GPUs) wreck the
# Riccati/IPM numerics (CLAUDE.md "Numerical facts"); the blocks are 17x17
# at most, so full-precision f32 costs nothing that matters.
MATMUL_PRECISION = "highest"


def full_precision(fn):
    """Trace `fn` under `jax.default_matmul_precision(MATMUL_PRECISION)`.

    Applied where the matmuls are: the ODE integrator
    (`dynamics/integrators.py::erk_integrate`: plant, jacfwd linearizer,
    defects), the QP build (`sqp/rti.py`), the QP solvers' public entries,
    `qp_objective` and the OCP cost (`ocp/spec.py`)."""
    @functools.wraps(fn)
    def scoped(*args, **kwargs):
        with jax.default_matmul_precision(MATMUL_PRECISION):
            return fn(*args, **kwargs)
    return scoped


class QPData(NamedTuple):
    """One OCP-structured QP. Shapes (N = horizon, nx, nu):

    A: (N, nx, nx)     discrete dynamics Jacobians
    B: (N, nx, nu)
    c: (N, nx)         affine defect: dx_{k+1} = A dx + B du + c
    Q: (N+1, nx, nx)   state Hessians (incl. terminal)
    q: (N+1, nx)       state gradients
    R: (N, nu, nu)     control Hessians
    r: (N, nu)         control gradients
    lbx/ubx: (N+1, nx) delta-form state bounds (row 0 unused; +-inf allowed)
    lbu/ubu: (N, nu)   delta-form control bounds
    dx0: (nx,)         pinned initial state delta
    """

    A: jnp.ndarray
    B: jnp.ndarray
    c: jnp.ndarray
    Q: jnp.ndarray
    q: jnp.ndarray
    R: jnp.ndarray
    r: jnp.ndarray
    lbx: jnp.ndarray
    ubx: jnp.ndarray
    lbu: jnp.ndarray
    ubu: jnp.ndarray
    dx0: jnp.ndarray

    @property
    def horizon(self) -> int:
        return self.A.shape[-3]

    @property
    def nx(self) -> int:
        return self.A.shape[-1]

    @property
    def nu(self) -> int:
        return self.B.shape[-1]


class QPSolution(NamedTuple):
    """Primal/dual solution + solver diagnostics.

    dx: (N+1, nx); du: (N, nu); lam_*: bound multipliers matching the bound
    shapes; stats are per-solve scalars (the reference captures but ignores
    solver status, `simulation_blaster.py:80` — we surface it, SURVEY.md §5).
    """

    dx: jnp.ndarray
    du: jnp.ndarray
    lam_lx: Optional[jnp.ndarray] = None
    lam_ux: Optional[jnp.ndarray] = None
    lam_lu: Optional[jnp.ndarray] = None
    lam_uu: Optional[jnp.ndarray] = None
    mu: Optional[jnp.ndarray] = None
    kkt_stat: Optional[jnp.ndarray] = None
    kkt_eq: Optional[jnp.ndarray] = None
    iters: Optional[jnp.ndarray] = None
    # final slacks (for warm-starting the next RTI tick's solve)
    s_lx: Optional[jnp.ndarray] = None
    s_ux: Optional[jnp.ndarray] = None
    s_lu: Optional[jnp.ndarray] = None
    s_uu: Optional[jnp.ndarray] = None


@full_precision
def qp_objective(data: QPData, dx: jnp.ndarray, du: jnp.ndarray) -> jnp.ndarray:
    """0.5 z'Hz + g'z for diagnostics and tests."""
    def quad(M, v):
        return 0.5 * jnp.einsum("...i,...ij,...j->...", v, M, v)
    obj = jnp.sum(quad(data.Q, dx)) + jnp.sum(data.q * dx)
    obj += jnp.sum(quad(data.R, du)) + jnp.sum(data.r * du)
    return obj
