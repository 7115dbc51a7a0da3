"""Gauss-Newton SQP-RTI: one linearize -> QP -> update per control tick.

The reference delegates this to acados' `nlp_solver_type='SQP_RTI'`
(`blastermodel.py:278`): per tick, ERK-linearize each shooting node, build
the Gauss-Newton QP, solve with HPIPM, take a full step
(`nlp_solver_step_length=1.0`, JSON). Here the whole tick is ONE jitted
function — linearization (vmapped jacfwd over nodes), QP (Riccati IPM), and
update fuse into a single XLA executable with no host round-trips
(SURVEY.md §7).

Multi-iteration SQP (the reference's `SQP` mode with up to
`nlp_solver_max_iter=100`) is `sqp_solve`: a lax.scan of RTI iterations at a
fixed initial state.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu.ocp.spec import OCPSpec
from mpc_blaster_tpu.qp.data import QPData, full_precision
from mpc_blaster_tpu.qp.ipm import box_qp_solve


class RTIState(NamedTuple):
    """Warm-start iterate carried between ticks (acados keeps its internal
    iterate between `solve()` calls the same way)."""

    xbar: jnp.ndarray  # (N+1, nx)
    ubar: jnp.ndarray  # (N, nu)


class RTIDiagnostics(NamedTuple):
    """Per-solve stats (the reference ignores solver status,
    `simulation_blaster.py:80`; we surface it, SURVEY.md §5)."""

    qp_kkt_stat: jnp.ndarray
    qp_kkt_eq: jnp.ndarray
    qp_mu: jnp.ndarray
    step_norm_x: jnp.ndarray
    step_norm_u: jnp.ndarray
    bound_viol: jnp.ndarray  # worst primal box violation of the new iterate


def _bound_violation(spec: OCPSpec, state: RTIState) -> jnp.ndarray:
    """Worst box-bound violation of an iterate (0 when feasible)."""
    vx = jnp.maximum(spec.lbx[None] - state.xbar,
                     state.xbar - spec.ubx[None])
    vu = jnp.maximum(spec.lbu[None] - state.ubar,
                     state.ubar - spec.ubu[None])
    return jnp.maximum(jnp.maximum(jnp.max(vx), jnp.max(vu)), 0.0)


def diag_converged(diag: RTIDiagnostics, solver: cfg.SolverConfig
                   ) -> jnp.ndarray:
    """Per-solve health flag against the configured acceptance tolerances.

    The acados JSON sets `nlp_solver_tol_{stat,eq,ineq,comp} = 1e-6` as its
    acceptance test (`blastermodel.py:285-287` semantics); this is the
    same test on our static-budget solves. Note: the QP's dx/du scale is
    the *delta* iterate, so tol_stat applies to the QP stationarity
    residual (cost-weight units, O(1e3) weights — 1e-6 relative is
    demanding; loosen per deployment). Returns a traced bool (vmappable).
    """
    return ((diag.qp_kkt_stat < solver.tol_stat)
            & (diag.qp_kkt_eq < solver.tol_eq)
            & (diag.bound_viol < solver.tol_ineq)
            & (diag.qp_mu < solver.tol_comp))


def init_rti_state(ocp: cfg.OCPConfig, x0, dtype=jnp.float32) -> RTIState:
    """Constant-state, hover-thrust initial trajectory."""
    x0 = jnp.asarray(x0, dtype)
    N = ocp.N
    hover = ocp.model.mass * ocp.model.gravity / 4.0
    u_hover = jnp.zeros(cfg.NU, dtype).at[0:4].set(hover)
    u_hover = jnp.clip(u_hover, jnp.asarray(ocp.bounds.lbu, dtype),
                       jnp.asarray(ocp.bounds.ubu, dtype))
    # + 0*x0[:NU] ties ubar to x0 so shard_map varying-axis typing treats
    # the whole warm-start state as sharded data, not a broadcast constant.
    u_hover = u_hover + 0.0 * x0[: cfg.NU]
    return RTIState(xbar=jnp.tile(x0[None], (N + 1, 1)),
                    ubar=jnp.tile(u_hover[None], (N, 1)))


def _linearize_nodes(F, xbar, ubar, stage_params, params):
    """Vectorized (x_next, A, B) across all shooting nodes — one jacfwd over
    the whole stacked horizon replaces acados' per-node sensitivity ERK.

    F's integrator runs at "highest" matmul precision
    (`integrators.erk_integrate`): at the GPU default (TF32) the 3x3
    rotation/POC products gave A/B 50x further from float64 than the
    matmul-free fused linearizer (measured on an H100)."""
    def FAB(x, u, p):
        xn = F(x, u, p, params)
        A, B = jax.jacfwd(F, argnums=(0, 1))(x, u, p, params)
        return xn, A, B
    return jax.vmap(FAB)(xbar[:-1], ubar, stage_params)


def make_linearizer(ocp: cfg.OCPConfig, params: BlasterParams,
                    num_steps: int = 1):
    """Resolve `solver.lin_backend` to a `linearizer` hook (or None for the
    default jacfwd path). Validates the static string at trace time."""
    lb = ocp.solver.lin_backend
    if lb == "fused":
        from mpc_blaster_tpu.dynamics.fastlin import make_fused_linearizer
        return make_fused_linearizer(ocp, params, num_steps)
    if lb != "jacfwd":
        raise ValueError(f"unknown lin_backend {lb!r} "
                         "(expected 'jacfwd' or 'fused')")
    return None


def qp_hessian_R(spec: OCPSpec, solver) -> jnp.ndarray:
    """The R used for the QP's Gauss-Newton HESSIAN only (r5).

    `solver.qp_r_floor` raises selected diagonal entries to a minimum —
    proximal (Levenberg-style) damping of weakly-determined control
    subspaces. The QP GRADIENT always keeps the true `spec.R`, so the
    damping vanishes at convergence (du -> 0) and stationary points of
    the reported cost are unchanged. Motivating case: the sim preset's
    R_swivel=1e-5 leaves the gimbal's lateral blast-force channel a
    near-free actuator, and offset-free wind compensation limit-cycles
    through it (CLAUDE.md r4 finding); flooring the two swivel-rate
    entries stops the hunt without touching the reported cost."""
    if solver is None or solver.qp_r_floor is None:
        return spec.R
    fl = jnp.asarray(solver.qp_r_floor, spec.R.dtype)
    d = jnp.diagonal(spec.R)
    return spec.R + jnp.diag(jnp.maximum(fl - d, 0.0))


@full_precision
def _assemble_qp(spec: OCPSpec, state: RTIState, x0: jnp.ndarray, x_pred,
                 A, B, solver) -> QPData:
    """Delta-form Gauss-Newton QP around the iterate, given the shooting
    nodes' forward predictions and Jacobians."""
    xbar, ubar = state.xbar, state.ubar
    dtw = spec.dt
    Qs = jnp.concatenate([
        jnp.tile((dtw * spec.Q)[None], (spec.horizon, 1, 1)),
        spec.Q_t[None]], axis=0)
    q_stage = dtw * (xbar[:-1] - spec.yref_x) @ spec.Q.T
    q_term = ((xbar[-1] - spec.yref_e) @ spec.Q_t.T)[None]
    Rs = jnp.tile((dtw * qp_hessian_R(spec, solver))[None],
                  (spec.horizon, 1, 1))
    return QPData(
        A=A, B=B, c=x_pred - xbar[1:],          # shooting defects
        Q=Qs, q=jnp.concatenate([q_stage, q_term], axis=0),
        R=Rs, r=dtw * (ubar - spec.yref_u) @ spec.R.T,
        lbx=spec.lbx[None] - xbar, ubx=spec.ubx[None] - xbar,
        lbu=spec.lbu[None] - ubar, ubu=spec.ubu[None] - ubar,
        dx0=x0 - xbar[0],
    )


def build_qp(spec: OCPSpec, state: RTIState, x0: jnp.ndarray,
             F, params: BlasterParams, linearizer=None,
             solver=None) -> QPData:
    """Linearize dynamics + cost around the iterate -> delta-form QP.

    `linearizer`, when given, replaces the jacfwd `_linearize_nodes` with a
    `(xbar, ubar, stage_params) -> (x_next, A, B)` callable (the fused
    component-form backend, `dynamics/fastlin.py`). `solver` feeds the
    optional QP-only Hessian floor (`qp_hessian_R`)."""
    if linearizer is not None:
        x_pred, A, B = linearizer(state.xbar, state.ubar, spec.stage_params)
    else:
        x_pred, A, B = _linearize_nodes(F, state.xbar, state.ubar,
                                        spec.stage_params, params)
    return _assemble_qp(spec, state, x0, x_pred, A, B, solver)


def solve_qp_backend(qp: QPData, solver: cfg.SolverConfig, warm=None):
    """Dispatch to the configured QP backend (trace-time branch).

    "riccati" is the full-horizon Riccati IPM (the reference's effective
    cond_N=N HPIPM configuration); "condensed" applies real partial
    condensing with block size `solver.cond_M` before solving
    (`qp/condense.py`). `warm` (qp.ipm.IpmWarmStart) is honored by the
    riccati backend; condensed solves are cold (the condensed QP's slack
    geometry doesn't transfer across ticks)."""
    if solver.qp_backend == "condensed":
        if warm is not None:
            raise ValueError("qp_backend='condensed' does not support "
                             "slack/dual warm starts")
        from mpc_blaster_tpu.qp.condense import condensed_qp_solve
        return condensed_qp_solve(qp, M=solver.cond_M,
                                  iters=solver.ipm_iters,
                                  mu0=solver.ipm_mu0,
                                  alpha_frac=solver.ipm_alpha_frac,
                                  reg=solver.ipm_reg)
    return box_qp_solve(qp, iters=solver.ipm_iters, mu0=solver.ipm_mu0,
                        alpha_frac=solver.ipm_alpha_frac, reg=solver.ipm_reg,
                        riccati=solver.riccati, warm=warm)


def rti_step(spec: OCPSpec, state: RTIState, x0: jnp.ndarray,
             params: BlasterParams, F, solver: cfg.SolverConfig,
             linearizer=None
             ) -> Tuple[jnp.ndarray, RTIState, RTIDiagnostics]:
    """One real-time iteration. Returns (u0, updated iterate, diagnostics)."""
    qp = build_qp(spec, state, x0, F, params, linearizer=linearizer,
                  solver=solver)
    sol = solve_qp_backend(qp, solver)
    new_state = RTIState(xbar=state.xbar + sol.dx, ubar=state.ubar + sol.du)
    diag = RTIDiagnostics(
        qp_kkt_stat=sol.kkt_stat, qp_kkt_eq=sol.kkt_eq, qp_mu=sol.mu,
        step_norm_x=jnp.max(jnp.abs(sol.dx)),
        step_norm_u=jnp.max(jnp.abs(sol.du)),
        bound_viol=_bound_violation(spec, new_state),
    )
    return new_state.ubar[0], new_state, diag


class JacCache(NamedTuple):
    """Cached discrete dynamics Jacobians for Jacobian-reuse RTI ticks."""

    A: jnp.ndarray  # (N, nx, nx)
    B: jnp.ndarray  # (N, nx, nu)

    @staticmethod
    def zeros(N, nx, nu, dtype=jnp.float32):
        return JacCache(A=jnp.zeros((N, nx, nx), dtype),
                        B=jnp.zeros((N, nx, nu), dtype))


def build_qp_jacreuse(spec: OCPSpec, state: RTIState, x0: jnp.ndarray,
                      F, params: BlasterParams, cache: JacCache,
                      refresh, linearizer=None, solver=None) -> tuple:
    """build_qp with optional Jacobian reuse (the reference's
    `sim_method_jac_reuse` option, JSON `sim_method_jac_reuse=[0]*60`).

    When `refresh` (traced bool) is False, A/B come from `cache` and only
    the exact forward evaluations (defects) are recomputed — the shooting
    defects stay exact, the Gauss-Newton direction becomes slightly inexact
    (standard inexact-SQP; fine for warm closed loops). Linearization is
    ~70% of the RTI tick cost, so reusing it most ticks nearly doubles
    throughput. Returns (QPData, new_cache).
    """
    xbar, ubar = state.xbar, state.ubar

    def full(_):
        if linearizer is not None:
            return linearizer(xbar, ubar, spec.stage_params)
        return _linearize_nodes(F, xbar, ubar, spec.stage_params, params)

    def reuse(cache):
        x_pred = jax.vmap(lambda x, u, p: F(x, u, p, params))(
            xbar[:-1], ubar, spec.stage_params)
        return x_pred, cache.A, cache.B

    x_pred, A, B = jax.lax.cond(refresh, full, reuse, cache)
    return (_assemble_qp(spec, state, x0, x_pred, A, B, solver),
            JacCache(A=A, B=B))


def rti_step_jacreuse(spec: OCPSpec, state: RTIState, cache: JacCache,
                      refresh, x0: jnp.ndarray, params: BlasterParams, F,
                      solver: cfg.SolverConfig, linearizer=None):
    """RTI tick with Jacobian reuse. Returns (u0, state, cache, diag)."""
    qp, cache = build_qp_jacreuse(spec, state, x0, F, params, cache, refresh,
                                  linearizer=linearizer, solver=solver)
    sol = solve_qp_backend(qp, solver)
    new_state = RTIState(xbar=state.xbar + sol.dx, ubar=state.ubar + sol.du)
    diag = RTIDiagnostics(
        qp_kkt_stat=sol.kkt_stat, qp_kkt_eq=sol.kkt_eq, qp_mu=sol.mu,
        step_norm_x=jnp.max(jnp.abs(sol.dx)),
        step_norm_u=jnp.max(jnp.abs(sol.du)),
        bound_viol=_bound_violation(spec, new_state),
    )
    return new_state.ubar[0], new_state, cache, diag


def rti_step_warm(spec: OCPSpec, state: RTIState, warm, x0: jnp.ndarray,
                  params: BlasterParams, F, solver: cfg.SolverConfig,
                  linearizer=None):
    """RTI tick with slack/dual warm starting (HPIPM warm_start=1 analog).

    Returns (u0, new_state, warm_out, diag). Pass `warm_out` into the next
    tick; seed the first tick with `IpmWarmStart.zeros(...)` (valid=0 ->
    cold).

    CAVEAT (measured): on aggressive transients the
    previous tick's near-active duals mislead low-iteration RAW warm
    solves — altitude steps overshoot and figure-8 tracking degrades
    ~10x vs per-tick cold starts. This mirrors why the reference runs
    HPIPM with `qp_solver_warm_start=0` (acados JSON). Conditioning
    repairs exist as `solver.warm_mode` ("primal"/"centrality",
    `qp/ipm.py::warm_start_recenter`) and `solver.warm_shift` (classical
    RTI time-shift of the iterate + slack/dual state); measure against
    the cold rt6 loop before deploying (bench.py's warm A/B rows).
    """
    from mpc_blaster_tpu.qp.ipm import warm_start_from, warm_start_recenter

    qp = build_qp(spec, state, x0, F, params, linearizer=linearizer,
                  solver=solver)
    sol = solve_qp_backend(qp, solver, warm=warm)
    new_state = RTIState(xbar=state.xbar + sol.dx, ubar=state.ubar + sol.du)
    diag = RTIDiagnostics(
        qp_kkt_stat=sol.kkt_stat, qp_kkt_eq=sol.kkt_eq, qp_mu=sol.mu,
        step_norm_x=jnp.max(jnp.abs(sol.dx)),
        step_norm_u=jnp.max(jnp.abs(sol.du)),
        bound_viol=_bound_violation(spec, new_state),
    )
    u0 = new_state.ubar[0]
    warm_out = warm_start_from(sol, shift=solver.warm_shift)
    if solver.warm_mode != "full":
        warm_out = warm_start_recenter(warm_out, mu0=solver.ipm_mu0,
                                       mode=solver.warm_mode)
    if solver.warm_shift:
        new_state = shift_state(new_state)
    return u0, new_state, warm_out, diag


def rti_step_soft(spec: OCPSpec, state: RTIState, x0: jnp.ndarray,
                  params: BlasterParams, F, solver: cfg.SolverConfig,
                  soft, linearizer=None):
    """RTI tick with soft (slacked) state bounds — the acados ns>0 analog
    (`qp/soft.py`). Use when disturbances can push the state outside the
    hard box (the sim preset's position box is ±1.5 m,
    `simulation_blaster.py:28-30`): a hard QP becomes infeasible there,
    while the soft QP degrades gracefully with L1+L2-penalized violations.

    `soft` is a `qp.soft.SoftBounds` in *delta* units — the box is affine
    in the iterate, so penalties (which are shift-invariant) transfer
    directly. Returns (u0, new_state, diag, violations). Every backend
    uses the XLA soft solver (`qp/soft.py`).
    """
    from mpc_blaster_tpu.qp.soft import soft_box_qp_solve

    qp = build_qp(spec, state, x0, F, params, linearizer=linearizer,
                  solver=solver)
    res = soft_box_qp_solve(qp, soft, iters=solver.ipm_iters,
                            mu0=solver.ipm_mu0,
                            alpha_frac=solver.ipm_alpha_frac,
                            reg=solver.ipm_reg)
    sol = res.sol
    new_state = RTIState(xbar=state.xbar + sol.dx, ubar=state.ubar + sol.du)
    diag = RTIDiagnostics(
        qp_kkt_stat=sol.kkt_stat, qp_kkt_eq=sol.kkt_eq, qp_mu=sol.mu,
        step_norm_x=jnp.max(jnp.abs(sol.dx)),
        step_norm_u=jnp.max(jnp.abs(sol.du)),
        bound_viol=_bound_violation(spec, new_state),
    )
    return new_state.ubar[0], new_state, diag, res


class WatchdogState(NamedTuple):
    """Running health state of `rti_step_warm_guarded` (r4): an EMA of
    the accepted ticks' KKT equality residual, a downgrade counter, and
    the cold-hold hysteresis countdown."""

    ema_eq: jnp.ndarray   # scalar EMA of accepted qp_kkt_eq
    trips: jnp.ndarray    # int32: number of warm->cold downgrades
    hold: jnp.ndarray     # int32: remaining ticks of forced-cold solves

    @staticmethod
    def init(dtype=jnp.float32) -> "WatchdogState":
        return WatchdogState(ema_eq=jnp.asarray(0.0, dtype),
                             trips=jnp.asarray(0, jnp.int32),
                             hold=jnp.asarray(0, jnp.int32))


def rti_step_warm_guarded(spec: OCPSpec, state: RTIState, warm,
                          wd: WatchdogState, x0: jnp.ndarray,
                          params: BlasterParams, F,
                          solver: cfg.SolverConfig, linearizer=None,
                          jump: float = 30.0,
                          floor: float = 0.5, ema_rate: float = 0.9,
                          viol_cap: float = 0.25, hold_ticks: int = 10):
    """`rti_step_warm` with an ONLINE divergence watchdog (r4; makes the
    measured-best "fastest" warm profile safely defaultable instead of
    opt-in).

    Failure mode being guarded: a low-iteration warm chain whose carried
    slacks/duals mislead the solve on an aggressive transient — measured
    in r3 as a 200 m altitude-step blowup for raw (unshifted) chains,
    the same reason the reference disables HPIPM warm starts
    (`qp_solver_warm_start=0`, acados JSON). The time-shift repairs the
    measured cases; the watchdog catches the residual tail risk online.

    Rule (calibrated against measured healthy altitude-climb chains,
    riccati f32 warm4: eq <= 0.21 at N=20 / 0.42 at N=10, bound_viol
    <= 0.081 / 0.30, all finite): trip when u0/diagnostics are
    nonfinite, OR the QP equality residual jumps above
    max(jump * EMA(accepted eq), floor=0.5), OR the new iterate's box
    violation exceeds `viol_cap` (0.25). Calibration data: the deployed
    shifted-primal chain measures eq <= 0.20 and viol == 0 through the
    whole climb; the cold chain viol <= 0.20; a DEGRADING raw chain
    crosses 0.30 within 3 ticks of onset. Early tripping is
    load-bearing: once a degraded chain drives the PLANT outside the
    state box (attitude/velocity), the hard QP is infeasible at x0 and
    no hard-bound controller recovers (measured: cold restarts from
    such a state still diverge) — recovery there is the soft-bound
    solver's job, not the watchdog's. A false trip costs one redo
    solve and a few held-cold ticks, nothing else.

    On a trip the SAME tick is recomputed COLD (warm input invalidated:
    valid=0 -> per-entry cold blend; identical compiled program, no
    second variant) with the carried iterate sanitized (nonfinite xbar
    rows -> x0, ubar box-clipped), and the chain then STAYS COLD for
    `hold_ticks` further ticks before warm solves resume. The hysteresis
    is load-bearing: a per-tick redo alone cannot stabilize a chain
    that re-degrades every tick (measured on the raw N=10 chain:
    restart-every-tick left 3 m violations and an oscillating loop,
    while the carried-iterate cold chain — which the hold reproduces —
    converges cleanly).

    Returns (u0, new_state, warm_out, wd_out, diag) — diag of the
    ACCEPTED solve.
    """
    force_cold = wd.hold > 0
    warm_in = warm._replace(
        valid=jnp.where(force_cold, jnp.zeros_like(warm.valid),
                        warm.valid))
    u0, st1, warm1, diag1 = rti_step_warm(
        spec, state, warm_in, x0, params, F, solver,
        linearizer=linearizer)
    thresh = jnp.maximum(jump * wd.ema_eq, floor)
    bad = (~jnp.all(jnp.isfinite(u0))
           | ~jnp.isfinite(diag1.qp_kkt_eq)
           | (diag1.qp_kkt_eq > thresh)
           | (diag1.bound_viol > viol_cap))

    def redo(_):
        warm_cold = warm._replace(valid=jnp.zeros_like(warm.valid))
        xb = jnp.where(jnp.isfinite(state.xbar), state.xbar,
                       jnp.where(jnp.isfinite(x0), x0, 0.0)[None, :])
        ub = jnp.clip(jnp.where(jnp.isfinite(state.ubar),
                                state.ubar, 0.0),
                      spec.lbu[None], spec.ubu[None])
        return rti_step_warm(spec, RTIState(xbar=xb, ubar=ub),
                             warm_cold, x0, params, F, solver,
                             linearizer=linearizer)

    def keep(_):
        return u0, st1, warm1, diag1

    u0g, stg, warmg, diagg = jax.lax.cond(bad, redo, keep, None)
    eq_acc = diagg.qp_kkt_eq
    ema_new = jnp.where(
        bad | (wd.ema_eq <= 0.0), eq_acc,
        ema_rate * wd.ema_eq + (1.0 - ema_rate) * eq_acc)
    # escalating hold: a chain that keeps tripping is structurally
    # unsuited to warm starts on this trajectory — each trip lengthens
    # the cold period by 2 ticks/trip, asymptotically pinning a repeat
    # offender cold (measured: fixed 10-tick holds let the raw chain
    # re-degrade on every resume)
    hold_on_trip = hold_ticks + 2 * wd.trips
    hold_new = jnp.where(bad, hold_on_trip.astype(jnp.int32),
                         jnp.maximum(wd.hold - 1, 0))
    wd_new = WatchdogState(ema_eq=ema_new,
                           trips=wd.trips + bad.astype(jnp.int32),
                           hold=hold_new)
    return u0g, stg, warmg, wd_new, diagg


def shift_state(state: RTIState) -> RTIState:
    """Shift the iterate one stage forward (classic RTI warm start)."""
    return RTIState(
        xbar=jnp.concatenate([state.xbar[1:], state.xbar[-1:]], axis=0),
        ubar=jnp.concatenate([state.ubar[1:], state.ubar[-1:]], axis=0),
    )


def rti_step_warm_jacreuse(spec: OCPSpec, state: RTIState, warm,
                           cache: JacCache, refresh, x0: jnp.ndarray,
                           params: BlasterParams, F,
                           solver: cfg.SolverConfig, linearizer=None):
    """Compose the two deployment accelerators: slack/dual warm chains
    (with the shift/conditioning of `rti_step_warm`) AND Jacobian reuse
    (`rti_step_jacreuse`). Defects stay exact every tick; A/B refresh
    every jac_refresh-th tick; carried slacks/duals are conditioned per
    `solver.warm_mode`/`warm_shift`. When the iterate is time-shifted,
    the Jacobian cache rows are shifted WITH it (stage k's new
    linearization point is old stage k+1), keeping the stale model
    aligned with the trajectory it linearizes.

    Returns (u0, new_state, warm_out, new_cache, diag).
    """
    from mpc_blaster_tpu.qp.ipm import warm_start_from, warm_start_recenter

    qp, cache = build_qp_jacreuse(spec, state, x0, F, params, cache,
                                  refresh, linearizer=linearizer,
                                  solver=solver)
    sol = solve_qp_backend(qp, solver, warm=warm)
    new_state = RTIState(xbar=state.xbar + sol.dx, ubar=state.ubar + sol.du)
    diag = RTIDiagnostics(
        qp_kkt_stat=sol.kkt_stat, qp_kkt_eq=sol.kkt_eq, qp_mu=sol.mu,
        step_norm_x=jnp.max(jnp.abs(sol.dx)),
        step_norm_u=jnp.max(jnp.abs(sol.du)),
        bound_viol=_bound_violation(spec, new_state),
    )
    u0 = new_state.ubar[0]
    warm_out = warm_start_from(sol, shift=solver.warm_shift)
    if solver.warm_mode != "full":
        warm_out = warm_start_recenter(warm_out, mu0=solver.ipm_mu0,
                                       mode=solver.warm_mode)
    if solver.warm_shift:
        new_state = shift_state(new_state)
        cache = JacCache(
            A=jnp.concatenate([cache.A[1:], cache.A[-1:]], axis=0),
            B=jnp.concatenate([cache.B[1:], cache.B[-1:]], axis=0))
    return u0, new_state, warm_out, cache, diag


@dataclasses.dataclass(frozen=True)
class RTIController:
    """Bundles static config + jitted step for convenient host-side use."""

    ocp: cfg.OCPConfig
    dtype: object = jnp.float32
    num_steps: int = 1  # integrator substeps per shooting node (acados: 1)

    def make(self):
        return make_rti_step(self.ocp, dtype=self.dtype,
                             num_steps=self.num_steps)


def make_rti_step(ocp: cfg.OCPConfig, dtype=jnp.float32, num_steps: int = 1,
                  jit: bool = True):
    """Build `step(spec, state, x0) -> (u0, state, diag)` closed over statics."""
    params = BlasterParams.from_config(ocp.model, dtype)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=num_steps)
    solver = ocp.solver
    lin = make_linearizer(ocp, params, num_steps=num_steps)

    def step(spec: OCPSpec, state: RTIState, x0: jnp.ndarray):
        return rti_step(spec, state, x0, params, F, solver, linearizer=lin)

    return jax.jit(step) if jit else step


def sqp_solve(spec: OCPSpec, state: RTIState, x0: jnp.ndarray,
              params: BlasterParams, F, solver: cfg.SolverConfig,
              iters: int = 10, linearizer=None):
    """Multi-iteration SQP at fixed x0 (acados `SQP` mode semantics:
    `nlp_solver_max_iter` full Gauss-Newton steps, `blastermodel.py` JSON).
    Returns the best iterate by L1 exact-penalty merit + per-iteration
    step norms.

    BEST-ITERATE SELECTION (same philosophy as the inner IPM): in f32,
    full-step Gauss-Newton on states pinned at their velocity/omega
    bounds limit-cycles — the QP's f32 noise in the near-free gimbal
    subspace (R_swivel*dt ~ 3e-7) proposes ~10 N bang-bang steps that
    cost nothing, so the LAST iterate is a lottery (measured: f64
    contracts to 1e-9 in 5 iterations on the same problem, f32 bounces
    at step-norm ~10 forever). Tracking the best L1-merit iterate
    (true cost + 1e4 * |dynamics defect|_1, an exact penalty above the
    multiplier scale) makes ANY iteration budget safe — the deep-budget
    analog of the reference's qp_solver_iter_max=500 never returns a
    worse answer than it has seen. acados' own default is FIXED_STEP
    (no globalization); in its f64-only world that converges."""
    from mpc_blaster_tpu.ocp.spec import total_cost

    def defect_l1(st):
        xs_next = jax.vmap(lambda x, u, p: F(x, u, p, params))(
            st.xbar[:-1], st.ubar, spec.stage_params)
        d = jnp.sum(jnp.abs(xs_next - st.xbar[1:]))
        return d + jnp.sum(jnp.abs(st.xbar[0] - x0))

    def merit(st):
        return total_cost(spec, st.xbar, st.ubar) + 1e4 * defect_l1(st)

    def body(carry, _):
        st, best, best_m = carry
        _, st_new, diag = rti_step(spec, st, x0, params, F, solver,
                                   linearizer=linearizer)
        m = merit(st_new)
        better = m < best_m
        best = jax.tree.map(lambda n, b: jnp.where(better, n, b),
                            st_new, best)
        best_m = jnp.where(better, m, best_m)
        return (st_new, best, best_m), diag.step_norm_u

    m0 = merit(state)
    (_, best, _), step_norms = jax.lax.scan(
        body, (state, state, m0), None, length=iters)
    return best, step_norms
