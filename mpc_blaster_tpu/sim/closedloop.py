"""Closed-loop NMPC simulation, fully on-device.

The reference's offline sim (`simulation_blaster.py:56-107`) runs a Python
for-loop making ~2+2N ctypes calls into C per tick (SURVEY.md §1). Here the
whole Nsim-tick rollout is ONE `lax.scan` inside jit: controller tick (RTI)
and plant step stay on device; nothing crosses the host boundary until the
trajectories come back at the end.

The plant is the same RK4 model (perfect-model simulation, exactly like the
reference using a second AcadosSimSolver of the same ODE,
`simulation_blaster.py:94-104`), with its own stage parameters: the sim
entry point sets the integrator's T_blast to 2.2*9.81
(`simulation_blaster.py:82-84`).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu.ocp.spec import OCPSpec, build_spec
from mpc_blaster_tpu.sqp.rti import (
    RTIState,
    init_rti_state,
    rti_step,
)


class ClosedLoopResult(NamedTuple):
    xs: jnp.ndarray        # (Nsim+1, nx) simX analog (`simulation_blaster.py:44`)
    us: jnp.ndarray        # (Nsim, nu)   simU analog
    costs: jnp.ndarray     # (Nsim,) controller objective per tick
    kkt_stat: jnp.ndarray  # (Nsim,)
    kkt_eq: jnp.ndarray    # (Nsim,)


def closed_loop(spec: OCPSpec, ocp: cfg.OCPConfig, x0: jnp.ndarray,
                n_steps: int, plant_params: Optional[jnp.ndarray] = None,
                dtype=jnp.float32, plant_substeps: int = 1,
                rti0: Optional[RTIState] = None,
                poc_mode: str = "frozen",
                poc_cfg: Optional[cfg.PocSolverConfig] = None,
                warm_start: bool = False,
                jac_refresh: int = 1) -> ClosedLoopResult:
    """Run `n_steps` control ticks from x0. jit-compiled end to end.

    poc_mode:
      - "frozen": stage parameters from `spec` are used unchanged for the
        whole run — the reference's behavior (`simulation_blaster.py:37-39`
        computes POC Jacobians once before the loop; SURVEY.md §3.1).
      - "online": the jet POC Jacobians are re-linearized at the CURRENT
        vehicle pose every tick, on device, inside the scan — a capability
        the reference lacks (its FD pipeline was too slow to run per tick;
        our closed-form jacfwd solve costs microseconds).

    warm_start=True carries IPM slack/dual warm starts between ticks
    (HPIPM warm_start=1 analog); pair with reduced solver.ipm_iters AND
    solver.warm_shift=True (raw unshifted chains diverge on transients
    — measured; see SolverConfig.warm_mode).

    jac_refresh > 1 (composable with warm_start) re-linearizes
    the dynamics Jacobians only every jac_refresh-th tick while keeping
    EXACT shooting defects every tick — the reference's own
    `sim_method_jac_reuse` precedent, here composed with any QP backend.
    Tracking quality is unchanged at jac_refresh<=4 (measured, fig-8),
    because the defects stay exact: only the Gauss-Newton model is stale.
    """
    # warm_start and jac_refresh compose (rti_step_warm_jacreuse): the
    # two accelerators are orthogonal — carried slacks/duals cut IPM
    # iterations, Jacobian reuse cuts linearization cost.
    params = BlasterParams.from_config(ocp.model, dtype)
    # The controller's integrator substep count feeds BOTH the forward map
    # and the linearizer — one site so they can never desynchronize
    # (acados uses 1 ERK step per shooting node: JSON sim_method_num_steps).
    ctrl_substeps = 1
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=ctrl_substeps)
    F_plant = discrete_dynamics(blaster_ode, ocp.dt, num_steps=plant_substeps)
    solver = ocp.solver
    from mpc_blaster_tpu.sqp.rti import make_linearizer
    lin = make_linearizer(ocp, params, num_steps=ctrl_substeps)
    x0 = jnp.asarray(x0, dtype)
    if plant_params is None:
        # `simulation_blaster.py:82-84`: plant uses the controller's stage-0
        # parameters but with T_blast pinned to 2.2*9.81.
        plant_params = spec.stage_params[0].at[-1].set(2.2 * 9.81)
    plant_params = jnp.asarray(plant_params, dtype)
    if rti0 is None:
        rti0 = init_rti_state(ocp, x0, dtype)

    from mpc_blaster_tpu.ocp.spec import total_cost

    if poc_mode in ("online", "online_stagewise"):
        from mpc_blaster_tpu.dynamics.blaster import pack_stage_params
        from mpc_blaster_tpu.poc.solver import poc_jacobians
        pc = poc_cfg or cfg.PocSolverConfig()
        t_blast = spec.stage_params[0, -1]

        def _params_at(x):
            j_mot, j_eul, j_pos = poc_jacobians(
                x[3:6], x[12:14], x[0:3], pc.stream_velocity, pc.drag,
                pc.newton_iters)
            return pack_stage_params(j_mot, j_eul, j_pos,
                                     t_blast).astype(dtype)

        if poc_mode == "online":
            def stage_params_for(x, state):
                return jnp.tile(_params_at(x)[None], (spec.horizon, 1))
        else:
            # per-stage: node k linearized at its predicted pose xbar[k]
            # (the full use of the reference model's 25-dim per-stage
            # parameters, `blastermodel.py:203-210`)
            def stage_params_for(x, state):
                return jax.vmap(_params_at)(state.xbar[:-1])
    elif poc_mode == "frozen":
        def stage_params_for(x, state):
            return spec.stage_params
    else:
        raise ValueError(f"unknown poc_mode {poc_mode!r}")

    if warm_start and solver.warm_watchdog and jac_refresh > 1:
        raise ValueError("warm_watchdog does not compose with "
                         "jac_refresh>1 (the guarded tick has no "
                         "jac-reuse variant); use jac_refresh=1")
    if warm_start and jac_refresh > 1:
        from mpc_blaster_tpu.qp.ipm import IpmWarmStart
        from mpc_blaster_tpu.sqp.rti import (JacCache,
                                             rti_step_warm_jacreuse)
        warm0 = IpmWarmStart.zeros(spec.horizon, x0.shape[0],
                                   rti0.ubar.shape[-1], dtype)
        warm0 = jax.tree.map(lambda a: a + 0.0 * x0[0], warm0)
        cache0 = JacCache.zeros(spec.horizon, x0.shape[0],
                                rti0.ubar.shape[-1], dtype)
        cache0 = jax.tree.map(lambda a: a + 0.0 * x0[0], cache0)

        def tick(carry, k):
            state, warm, cache, x = carry
            spec_t = spec._replace(stage_params=stage_params_for(x, state))
            refresh = (k % jac_refresh) == 0
            u0, state_new, warm_new, cache, diag = rti_step_warm_jacreuse(
                spec_t, state, warm, cache, refresh, x, params, F, solver,
                linearizer=lin)
            x_next = F_plant(x, u0, plant_params, params)
            cost = total_cost(spec_t, state_new.xbar, state_new.ubar)
            out = (x_next, u0, cost, diag.qp_kkt_stat, diag.qp_kkt_eq)
            return (state_new, warm_new, cache, x_next), out

        (_, _, _, _), (xs, us, costs, stat, eq) = jax.lax.scan(
            tick, (rti0, warm0, cache0, x0), jnp.arange(n_steps))
    elif warm_start and solver.warm_watchdog:
        # guarded warm chain (r4): per-tick divergence watchdog that
        # recomputes a tripped tick cold (rti_step_warm_guarded) — the
        # deployment default behind deployed_solver("fastest")
        from mpc_blaster_tpu.qp.ipm import IpmWarmStart
        from mpc_blaster_tpu.sqp.rti import (WatchdogState,
                                             rti_step_warm_guarded)
        warm0 = IpmWarmStart.zeros(spec.horizon, x0.shape[0],
                                   rti0.ubar.shape[-1], dtype)
        warm0 = jax.tree.map(lambda a: a + 0.0 * x0[0], warm0)
        wd0 = WatchdogState.init(dtype)
        wd0 = jax.tree.map(
            lambda a: a + (0.0 * x0[0]).astype(a.dtype), wd0)

        def tick(carry, _):
            state, warm, wd, x = carry
            spec_t = spec._replace(stage_params=stage_params_for(x, state))
            u0, state_new, warm_new, wd, diag = rti_step_warm_guarded(
                spec_t, state, warm, wd, x, params, F, solver,
                linearizer=lin)
            x_next = F_plant(x, u0, plant_params, params)
            cost = total_cost(spec_t, state_new.xbar, state_new.ubar)
            out = (x_next, u0, cost, diag.qp_kkt_stat, diag.qp_kkt_eq)
            return (state_new, warm_new, wd, x_next), out

        (_, _, _, _), (xs, us, costs, stat, eq) = jax.lax.scan(
            tick, (rti0, warm0, wd0, x0), None, length=n_steps)
    elif warm_start:
        from mpc_blaster_tpu.qp.ipm import IpmWarmStart
        from mpc_blaster_tpu.sqp.rti import rti_step_warm
        warm0 = IpmWarmStart.zeros(spec.horizon, x0.shape[0],
                                   rti0.ubar.shape[-1], dtype)
        # tie to varying data for shard_map typing
        warm0 = jax.tree.map(lambda a: a + 0.0 * x0[0], warm0)

        def tick(carry, _):
            state, warm, x = carry
            spec_t = spec._replace(stage_params=stage_params_for(x, state))
            u0, state_new, warm_new, diag = rti_step_warm(
                spec_t, state, warm, x, params, F, solver, linearizer=lin)
            x_next = F_plant(x, u0, plant_params, params)
            cost = total_cost(spec_t, state_new.xbar, state_new.ubar)
            out = (x_next, u0, cost, diag.qp_kkt_stat, diag.qp_kkt_eq)
            return (state_new, warm_new, x_next), out

        (_, _, _), (xs, us, costs, stat, eq) = jax.lax.scan(
            tick, (rti0, warm0, x0), None, length=n_steps)
    elif jac_refresh > 1:
        # Jacobian-reuse deployed loop (the reference's sim_method_jac_reuse
        # precedent): exact defects every tick, A/B refreshed every
        # jac_refresh-th tick — shaves the linearization off the reused
        # ticks.
        from mpc_blaster_tpu.sqp.rti import JacCache, rti_step_jacreuse
        cache0 = JacCache.zeros(spec.horizon, x0.shape[0],
                                rti0.ubar.shape[-1], dtype)
        cache0 = jax.tree.map(lambda a: a + 0.0 * x0[0], cache0)

        def tick(carry, k):
            state, cache, x = carry
            spec_t = spec._replace(stage_params=stage_params_for(x, state))
            refresh = (k % jac_refresh) == 0
            u0, state_new, cache, diag = rti_step_jacreuse(
                spec_t, state, cache, refresh, x, params, F, solver,
                linearizer=lin)
            x_next = F_plant(x, u0, plant_params, params)
            cost = total_cost(spec_t, state_new.xbar, state_new.ubar)
            out = (x_next, u0, cost, diag.qp_kkt_stat, diag.qp_kkt_eq)
            return (state_new, cache, x_next), out

        (_, _, _), (xs, us, costs, stat, eq) = jax.lax.scan(
            tick, (rti0, cache0, x0), jnp.arange(n_steps))
    else:
        def tick(carry, _):
            state, x = carry
            spec_t = spec._replace(stage_params=stage_params_for(x, state))
            u0, state_new, diag = rti_step(spec_t, state, x, params, F,
                                           solver, linearizer=lin)
            x_next = F_plant(x, u0, plant_params, params)
            cost = total_cost(spec_t, state_new.xbar, state_new.ubar)
            out = (x_next, u0, cost, diag.qp_kkt_stat, diag.qp_kkt_eq)
            return (state_new, x_next), out

        (_, _), (xs, us, costs, stat, eq) = jax.lax.scan(
            tick, (rti0, x0), None, length=n_steps)
    xs = jnp.concatenate([x0[None], xs], axis=0)
    return ClosedLoopResult(xs=xs, us=us, costs=costs, kkt_stat=stat,
                            kkt_eq=eq)


def make_closed_loop(ocp: cfg.OCPConfig, n_steps: int, dtype=jnp.float32,
                     plant_substeps: int = 1, poc_mode: str = "frozen",
                     poc_cfg: Optional[cfg.PocSolverConfig] = None,
                     warm_start: bool = False, jac_refresh: int = 1):
    """jit-compiled closed-loop runner with static config."""
    fn = partial(closed_loop, ocp=ocp, n_steps=n_steps, dtype=dtype,
                 plant_substeps=plant_substeps, poc_mode=poc_mode,
                 poc_cfg=poc_cfg, warm_start=warm_start,
                 jac_refresh=jac_refresh)

    @jax.jit
    def run(spec: OCPSpec, x0: jnp.ndarray):
        return fn(spec, x0=x0)

    return run


def preset_stage_params(preset: cfg.Preset, dtype=jnp.float32):
    """Stage parameters exactly as the reference entry point supplies them.

    - simulation: POC Jacobians solved once at the canonical pose before the
      loop and held constant (`simulation_blaster.py:37-39,65-69`;
      `Jacobian_POC_Solver.initialise` evaluates at zero angles, z=4);
    - flight: never set -> codegen defaults (zero Jacobians + hard-coded
      T_blast, `mavros_blaster_sim.py:76-83`).
    """
    quirks = preset.ocp.quirks
    if quirks.zero_poc_jacobians or not quirks.constant_poc_jacobians:
        return None  # build_spec applies the codegen defaults
    from mpc_blaster_tpu.dynamics.blaster import pack_stage_params
    from mpc_blaster_tpu.poc.solver import PocSolver

    solver = PocSolver.from_config(preset.poc).initialise()
    j_mot, j_eul, j_pos = solver.get_jacobians()
    t_blast = (2.2 * 9.81 if quirks.hardcode_t_blast
               else preset.ocp.model.blast_thruster)
    p = pack_stage_params(j_mot, j_eul, j_pos, t_blast)
    return jnp.asarray(p, dtype)


def run_preset(preset: cfg.Preset, n_steps: Optional[int] = None,
               dtype=jnp.float32, stage_params=None,
               with_poc: bool = False,
               poc_mode: str = "frozen") -> ClosedLoopResult:
    """Convenience entry: reproduce a reference entry point end to end.

    with_poc=True computes the POC Jacobians through the jet solver first,
    exactly like `simulation_blaster.py` (slower first call; jit-cached).
    poc_mode="online" re-linearizes POC at the live pose every tick
    (beyond-reference capability).
    """
    n = n_steps if n_steps is not None else preset.loop.n_steps
    if stage_params is None and (with_poc or poc_mode == "online"):
        stage_params = preset_stage_params(preset, dtype)
    spec = build_spec(preset.ocp, yref=preset.loop.yref,
                      stage_params=stage_params, dtype=dtype)
    run = make_closed_loop(preset.ocp, n, dtype=dtype, poc_mode=poc_mode,
                           poc_cfg=preset.poc)
    return run(spec, jnp.asarray(preset.loop.x0, dtype))
