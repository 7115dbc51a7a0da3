"""Task library: waypoint tracking, figure-8, blasting — BASELINE.md configs.

The reference only ever tracks a fixed setpoint (`simulation_blaster.py:48`,
`mavros_blaster_sim.py:61`). These tasks exercise the same controller on the
benchmark configurations: a time-varying figure-8 reference (config 2) and
the nozzle-pointing blasting task with live POC Jacobians (config 3). The
tracking loop streams a waypoint window over the horizon with
`lax.dynamic_slice` inside the scan — fully on-device, no host round-trips.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu.ocp.spec import OCPSpec, build_spec, total_cost
from mpc_blaster_tpu.sqp.rti import RTIState, init_rti_state, rti_step


class TrackingResult(NamedTuple):
    xs: jnp.ndarray      # (Nsim+1, nx)
    us: jnp.ndarray      # (Nsim, nu)
    refs: jnp.ndarray    # (Nsim, nx) stage-0 reference per tick
    kkt_stat: jnp.ndarray
    kkt_eq: jnp.ndarray


def figure8_refs(n_points: int, dt: float, amplitude_x: float = 1.0,
                 amplitude_y: float = 0.75, period_s: float = 12.0,
                 z: float = 2.0) -> np.ndarray:
    """(n_points, nx) state references along a lemniscate at altitude z."""
    t = np.arange(n_points) * dt
    w = 2.0 * np.pi / period_s
    refs = np.zeros((n_points, cfg.NX))
    refs[:, 0] = amplitude_x * np.sin(w * t)
    refs[:, 1] = amplitude_y * np.sin(2.0 * w * t)
    refs[:, 2] = z
    # velocity feedforward (consistent reference derivative)
    refs[:, 6] = amplitude_x * w * np.cos(w * t)
    refs[:, 7] = amplitude_y * 2.0 * w * np.cos(2.0 * w * t)
    return refs


def make_tracking_loop(ocp: cfg.OCPConfig, n_steps: int, dtype=jnp.float32,
                       plant_substeps: int = 1, warm_start: bool = False,
                       poc_mode: str = "frozen", plant_poc: str = "linear",
                       poc_cfg: Optional[cfg.PocSolverConfig] = None):
    """run(spec, x0, ref_traj) with ref_traj (n_steps + N + 1, nx).

    Per tick i the controller tracks stage references ref_traj[i+1 : i+N+1]
    (terminal = last of the window), mirroring how the reference would be
    fed in a receding-horizon deployment.

    warm_start=True carries IPM slack/dual warm starts between ticks; pair
    with reduced `ocp.solver.ipm_iters` for the latency-critical
    deployment loop (`config.deployed_solver("fastest")`).

    poc_mode: "frozen" keeps the POC Jacobians in `spec` fixed for the run
    (the reference's behavior, `simulation_blaster.py:37-39`); "online"
    re-linearizes the jet at the live pose every tick inside the scan
    (beyond-reference; see `sim/closedloop.py`); "online_stagewise"
    additionally linearizes EACH shooting node at its predicted pose
    along the RTI iterate's xbar (a vmap over stages — the full use of
    the per-stage 25-dim parameter design the reference model carries,
    `blastermodel.py:203-210` + `simulation_blaster.py:65-69`, which the
    reference only ever fills with one constant Jacobian set).

    plant_poc: "linear" propagates the plant's POC states with the same
    linearized poc_dot the controller model uses (the reference's sim,
    where plant == model); "exact" overwrites the plant POC after each
    step with the TRUE nonlinear jet impact point at the new pose
    (`poc/solver.solve_poc`) — physically, the impact point is a function
    of the pose, not a state with memory, so "exact" is the honest plant
    for judging real blasting accuracy and is what the bench's blast-scan
    rows report.
    """
    params = BlasterParams.from_config(ocp.model, dtype)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    F_plant = discrete_dynamics(blaster_ode, ocp.dt,
                                num_steps=plant_substeps)
    solver = ocp.solver
    N = ocp.N
    pc = poc_cfg or cfg.PocSolverConfig()
    from mpc_blaster_tpu.sqp.rti import make_linearizer
    lin = make_linearizer(ocp, params)

    if poc_mode in ("online", "online_stagewise", "stagewise_anchored"):
        from mpc_blaster_tpu.dynamics.blaster import pack_stage_params
        from mpc_blaster_tpu.poc.solver import (poc_jacobians,
                                                poc_value_and_jacobians)

        def _params_at(x, t_blast):
            j_mot, j_eul, j_pos = poc_jacobians(
                x[3:6], x[12:14], x[0:3], pc.stream_velocity, pc.drag,
                pc.newton_iters)
            return pack_stage_params(j_mot, j_eul, j_pos,
                                     t_blast).astype(dtype)

        def _params_and_poc_at(x, t_blast):
            poc, j_mot, j_eul, j_pos = poc_value_and_jacobians(
                x[3:6], x[12:14], x[0:3], pc.stream_velocity, pc.drag,
                pc.newton_iters)
            return (pack_stage_params(j_mot, j_eul, j_pos,
                                      t_blast).astype(dtype),
                    poc.astype(dtype))

        if poc_mode == "online":
            def relinearize(spec, x, state):
                p = _params_at(x, spec.stage_params[0, -1])
                return jnp.tile(p[None], (N, 1)), state
        elif poc_mode == "online_stagewise":
            def relinearize(spec, x, state):
                # stage k linearized at its PREDICTED pose xbar[k]
                return jax.vmap(_params_at, in_axes=(0, None))(
                    state.xbar[:-1], spec.stage_params[0, -1]), state
        else:
            # stagewise_anchored (r5): per-stage Jacobians AND the
            # iterate's POC rows re-anchored to the EXACT jet impact
            # point at each predicted pose. The POC "state" is redundant
            # (an algebraic function of pose); linear propagation drifts
            # O(dpose^2) from the true map across the horizon, so the QP
            # was optimizing the wrong poc positions on aggressive
            # sweeps. Re-anchoring projects the redundant coordinate
            # back onto the jet manifold every tick — the defects then
            # vanish to first order around TRUE poc values and the cost
            # acts on the real washing error. Same per-stage jet solves
            # as online_stagewise (the value rides the jacfwd trace via
            # has_aux — no extra Newton solves).
            def relinearize(spec, x, state):
                ps, pocs = jax.vmap(_params_and_poc_at,
                                    in_axes=(0, None))(
                    state.xbar[:-1], spec.stage_params[0, -1])
                from mpc_blaster_tpu.poc.solver import solve_poc
                pocN, _ = solve_poc(state.xbar[-1, 3:6],
                                    state.xbar[-1, 12:14],
                                    state.xbar[-1, 0:3],
                                    pc.stream_velocity, pc.drag,
                                    pc.newton_iters)
                xbar = state.xbar.at[:-1, 14:17].set(pocs)
                xbar = xbar.at[-1, 14:17].set(pocN.astype(dtype))
                # row 0 must stay the MEASURED state: the x0 pin works on
                # xbar[0] and the plant's exact POC is the measurement
                xbar = xbar.at[0, 14:17].set(state.xbar[0, 14:17])
                return ps, state._replace(xbar=xbar)
    elif poc_mode == "frozen":
        def relinearize(spec, x, state):
            return spec.stage_params, state
    else:
        raise ValueError(f"unknown poc_mode {poc_mode!r}")

    if plant_poc == "exact":
        from mpc_blaster_tpu.poc.solver import solve_poc

        def plant_step(x, u0, plant_params):
            xn = F_plant(x, u0, plant_params, params)
            poc, _ = solve_poc(xn[3:6], xn[12:14], xn[0:3],
                               pc.stream_velocity, pc.drag, pc.newton_iters)
            return xn.at[14:17].set(poc.astype(dtype))
    elif plant_poc == "linear":
        def plant_step(x, u0, plant_params):
            return F_plant(x, u0, plant_params, params)
    else:
        raise ValueError(f"unknown plant_poc {plant_poc!r}")

    @jax.jit
    def run(spec: OCPSpec, x0: jnp.ndarray, ref_traj: jnp.ndarray
            ) -> TrackingResult:
        x0 = jnp.asarray(x0, dtype)
        ref_traj = jnp.asarray(ref_traj, dtype)
        rti0 = init_rti_state(ocp, x0, dtype)
        plant_params = spec.stage_params[0]

        def window_spec(i, x, state):
            window = jax.lax.dynamic_slice(
                ref_traj, (i + 1, 0), (N, cfg.NX))
            stage_params, state = relinearize(spec, x, state)
            return spec._replace(
                yref_x=window, yref_e=window[-1],
                stage_params=stage_params), window, state

        if warm_start:
            from mpc_blaster_tpu.qp.ipm import IpmWarmStart
            from mpc_blaster_tpu.sqp.rti import rti_step_warm
            warm0 = IpmWarmStart.zeros(N, cfg.NX, cfg.NU, dtype)
            warm0 = jax.tree.map(lambda a: a + 0.0 * x0[0], warm0)

            def tick(carry, i):
                state, warm, x = carry
                spec_i, window, state = window_spec(i, x, state)
                u0, state_new, warm_new, diag = rti_step_warm(
                    spec_i, state, warm, x, params, F, solver,
                    linearizer=lin)
                x_next = plant_step(x, u0, plant_params)
                out = (x_next, u0, window[0], diag.qp_kkt_stat,
                       diag.qp_kkt_eq)
                return (state_new, warm_new, x_next), out

            _, (xs, us, refs, stat, eq) = jax.lax.scan(
                tick, (rti0, warm0, x0), jnp.arange(n_steps))
        else:
            def tick(carry, i):
                state, x = carry
                spec_i, window, state = window_spec(i, x, state)
                u0, state_new, diag = rti_step(spec_i, state, x, params, F,
                                               solver, linearizer=lin)
                x_next = plant_step(x, u0, plant_params)
                out = (x_next, u0, window[0], diag.qp_kkt_stat,
                       diag.qp_kkt_eq)
                return (state_new, x_next), out

            _, (xs, us, refs, stat, eq) = jax.lax.scan(
                tick, (rti0, x0), jnp.arange(n_steps))
        xs = jnp.concatenate([x0[None], xs], axis=0)
        return TrackingResult(xs=xs, us=us, refs=refs, kkt_stat=stat,
                              kkt_eq=eq)

    return run


def run_figure8(preset: Optional[cfg.Preset] = None, n_steps: int = 240,
                dtype=jnp.float32, warm_start: bool = False,
                **fig_kwargs) -> TrackingResult:
    """BASELINE config 2: figure-8 waypoint tracking, single trajectory."""
    preset = preset or cfg.simulation_preset()
    ocp = preset.ocp
    refs = figure8_refs(n_steps + ocp.N + 1, ocp.dt, **fig_kwargs)
    spec = build_spec(ocp, dtype=dtype)
    run = make_tracking_loop(ocp, n_steps, dtype=dtype,
                             warm_start=warm_start)
    x0 = np.zeros(cfg.NX)
    x0[0:3] = refs[0, 0:3]
    x0[6:9] = refs[0, 6:9]
    return run(spec, jnp.asarray(x0, dtype), jnp.asarray(refs, dtype))


def run_blasting(preset: Optional[cfg.Preset] = None, n_steps: int = 200,
                 dtype=jnp.float32):
    """BASELINE config 3: nozzle-pointing task with live POC Jacobians.

    Full pipeline: jet POC solve + Jacobians at the hover pose -> 25-dim
    stage parameters -> NMPC drives position AND point-of-contact targets
    (the reference's `simulation_blaster.py` wiring, but with the POC
    linearized at the actual operating pose instead of the canonical one).
    """
    from mpc_blaster_tpu.dynamics.blaster import pack_stage_params
    from mpc_blaster_tpu.poc.solver import PocSolver
    from mpc_blaster_tpu.sim.closedloop import make_closed_loop

    preset = preset or cfg.simulation_preset()
    ocp = preset.ocp
    solver = PocSolver.from_config(preset.poc)
    # Linearize at the task's hover pose (z = 3.5 target altitude).
    solver.solve_jacobians(jnp.zeros(3), jnp.zeros(2),
                           jnp.asarray([0.0, 0.0, 3.5]))
    j_mot, j_eul, j_pos = solver.get_jacobians()
    t_blast = 2.2 * 9.81 if ocp.quirks.hardcode_t_blast \
        else ocp.model.blast_thruster
    p = pack_stage_params(j_mot, j_eul, j_pos, t_blast)
    spec = build_spec(ocp, yref=preset.loop.yref,
                      stage_params=np.asarray(p), dtype=dtype)
    run = make_closed_loop(ocp, n_steps, dtype=dtype)
    return run(spec, jnp.asarray(preset.loop.x0, dtype)), solver


def blast_scan_refs(n_points: int, dt: float,
                    center=(-0.6, 0.0), amp_x: float = 0.7,
                    amp_y: float = 0.3, period_s: float = 40.0,
                    hover=(0.0, 0.0, 3.5), z_end: Optional[float] = None,
                    t_ramp_s: float = 6.0,
                    carry_frac: float = 0.0) -> np.ndarray:
    """(n_points, nx) refs: hover in place, sweep the jet's point of
    contact along a ground lemniscate (a raster "washing" pattern).

    The sweep runs toward -x: positive gimbal pitch alpha1 tilts the jet
    toward -x (R_y convention, `core/htm.py`) and the alpha1 box is
    asymmetric (-0.17..+1.22 rad, `config.py` bounds) — +x reach is ~0.6 m
    from z=3.5 while -x reach is ~9 m. Amplitudes/period default to rates
    the +-0.087 rad/s gimbal-rate bounds can follow at z >= 1.5.

    z_end (optional): ramp the hover altitude from hover[2] to z_end over
    t_ramp_s (descend-while-washing — the approach maneuver that makes any
    frozen POC linearization stale: dPOC/d(alpha, euler) scales ~z).

    carry_frac (r5): CO-MOVING hover reference — the position reference
    (plus a matching velocity feedforward) follows carry_frac of the POC
    sweep's deviation from its center, so the VEHICLE carries the
    low-frequency raster and the gimbal only the remainder. Why: on
    aggressive scans at low altitude the +-0.0872 rad/s gimbal-rate box
    cannot follow the commanded POC speed alone, and the fixed hover
    reference (position weight == POC weight, 1e3) charges the optimizer
    for exactly the translation that would help — the 0.14 m r4 plateau
    was this POSED-PROBLEM trade-off, not linearization error (measured:
    per-stage re-anchoring to the exact jet map changed nothing, while
    carry_frac=0.6 took the aggressive scan 0.140 -> 0.023 m. On gentle
    scans the gimbal alone is cheaper: 0.005 -> 0.016 m, so carry stays
    off there — `select_carry_frac`).
    """
    t = np.arange(n_points) * dt
    w = 2.0 * np.pi / period_s
    refs = np.zeros((n_points, cfg.NX))
    refs[:, 0:2] = hover[0:2]
    if z_end is None:
        refs[:, 2] = hover[2]
    else:
        frac = np.minimum(t / t_ramp_s, 1.0)
        refs[:, 2] = hover[2] + (z_end - hover[2]) * frac
        refs[:, 8] = np.where(frac < 1.0, (z_end - hover[2]) / t_ramp_s, 0.0)
    refs[:, 14] = center[0] + amp_x * np.sin(w * t)
    refs[:, 15] = center[1] + amp_y * np.sin(2.0 * w * t)
    if carry_frac:
        dev = refs[:, 14:16] - np.asarray(center)[None]
        refs[:, 0:2] += carry_frac * dev
        refs[:-1, 6:8] += carry_frac * np.diff(refs[:, 14:16],
                                               axis=0) / dt
    return refs


def select_poc_mode(amp_x: float = 0.7, amp_y: float = 0.3,
                    period_s: float = 40.0, hover=(0.0, 0.0, 3.5),
                    z_end: Optional[float] = None,
                    t_ramp_s: float = 6.0, **_ignored) -> str:
    """POC-linearization mode decision rule (r4; the bench-backed answer
    to "three POC modes and no guidance").

    The discriminant is the LINEARIZATION STALENESS RATE: how fast the
    commanded maneuver moves the jet geometry away from any fixed
    linearization point, approximated from the scan parameters as

        rate = w*(amp_x + 2*amp_y) + |z0 - z_end| / t_ramp   [m/s]

    (lemniscate sweep speed of the POC reference + descent rate; the
    jet Jacobians scale ~z and ~gimbal deflection, both driven by these
    two terms).

    Measured calibration (f32 closed loops, true-POC error):
      - gentle default scan (rate ~= 0.54 m/s): frozen/anchored 0.0050 m
        BEATS stagewise 0.0081 m — per-stage re-linearization only adds
        jet-solve noise when the pose barely leaves the anchor.
      - aggressive scan (rate ~= 1.10 m/s): stagewise 0.1386 m beats
        online 0.1601 m beats frozen 0.2881 m — staleness dominates.
    The threshold 0.8 m/s splits the two measured regimes with ~45%
    margin to each. "online" (anchored-at-current-pose, one jet solve
    per tick) is never the winner in either regime, so the selector
    returns only "frozen" or "online_stagewise"; pick "online" manually
    for a cheaper middle ground on aggressive scans where the N
    per-stage jet solves of stagewise are too expensive.
    """
    w = 2.0 * np.pi / period_s
    descent = 0.0 if z_end is None else abs(hover[2] - z_end) / t_ramp_s
    rate = w * (amp_x + 2.0 * amp_y) + descent
    return "online_stagewise" if rate > 0.8 else "frozen"


def select_carry_frac(amp_x: float = 0.7, amp_y: float = 0.3,
                      period_s: float = 40.0, hover=(0.0, 0.0, 3.5),
                      z_end: Optional[float] = None,
                      t_ramp_s: float = 6.0, **_ignored) -> float:
    """Co-moving-reference decision (r5): same staleness-rate
    discriminant as `select_poc_mode`. Fast sweeps exceed the gimbal's
    rate authority, so the vehicle should carry part of the raster
    (carry_frac=0.6 measured best on the aggressive bench profile:
    0.140 -> 0.023 m; 1.0 over-drives the vehicle, 0.084 m); gentle
    sweeps are cheaper on the gimbal alone (carry hurts: 0.005 ->
    0.016 m) so carry stays off below the same 0.8 m/s threshold."""
    w = 2.0 * np.pi / period_s
    descent = 0.0 if z_end is None else abs(hover[2] - z_end) / t_ramp_s
    rate = w * (amp_x + 2.0 * amp_y) + descent
    return 0.6 if rate > 0.8 else 0.0


def run_blast_scan(preset: Optional[cfg.Preset] = None, n_steps: int = 240,
                   dtype=jnp.float32, poc_mode: str = "auto",
                   plant_poc: str = "exact", frozen_at: str = "hover",
                   **scan_kwargs) -> TrackingResult:
    """Blast-scan showcase: the drone hovers while the water jet traces a
    figure-8 on the ground, judged against the TRUE nonlinear impact point.

    This is where online POC re-linearization (beyond-reference; the
    reference computes the jet Jacobians once before the loop,
    `simulation_blaster.py:37-39`, because its FD pipeline is too slow to
    run per tick) pays off: the sweep drives the gimbal across its range,
    where the frozen dPOC/d(alpha, euler, p) taken at the hover pose is
    badly stale. The plant reports the exact jet impact point each tick
    (`plant_poc="exact"`), so `result.xs[:, 14:17]` IS the true POC and
    `|xs[1:, 14:16] - refs[:, 14:16]|` is the physical washing error.

    frozen_at: where the frozen linearization is taken. "hover" = the
    task's own start pose (charitable); "canonical" = the reference's
    exact behavior (`Jacobian_POC_Solver.initialise`: zero angles, z=4).

    poc_mode="auto" (default since r4) applies `select_poc_mode`'s
    staleness-rate rule to the scan parameters — frozen on gentle scans,
    per-stage online on aggressive ones (each measured best in its
    regime; see the selector docstring for the numbers).
    """
    from mpc_blaster_tpu.dynamics.blaster import pack_stage_params
    from mpc_blaster_tpu.poc.solver import PocSolver, solve_poc

    if poc_mode == "auto":
        poc_mode = select_poc_mode(**scan_kwargs)
    if scan_kwargs.get("carry_frac") == "auto":
        scan_kwargs = dict(scan_kwargs,
                           carry_frac=select_carry_frac(**{
                               k: v for k, v in scan_kwargs.items()
                               if k != "carry_frac"}))
    preset = preset or cfg.simulation_preset()
    ocp = preset.ocp
    hover = scan_kwargs.get("hover", (0.0, 0.0, 3.5))
    refs = blast_scan_refs(n_steps + ocp.N + 1, ocp.dt, **scan_kwargs)

    solver = PocSolver.from_config(preset.poc)
    lin_pos = ((0.0, 0.0, 4.0) if frozen_at == "canonical" else hover)
    solver.solve_jacobians(jnp.zeros(3), jnp.zeros(2),
                           jnp.asarray(lin_pos, jnp.float64))
    j_mot, j_eul, j_pos = solver.get_jacobians()
    t_blast = 2.2 * 9.81 if ocp.quirks.hardcode_t_blast \
        else ocp.model.blast_thruster
    p = pack_stage_params(j_mot, j_eul, j_pos, t_blast)
    spec = build_spec(ocp, stage_params=np.asarray(p), dtype=dtype)

    run = make_tracking_loop(ocp, n_steps, dtype=dtype, poc_mode=poc_mode,
                             plant_poc=plant_poc, poc_cfg=preset.poc)
    x0 = np.zeros(cfg.NX)
    x0[0:3] = hover
    poc0, _ = solve_poc(jnp.zeros(3), jnp.zeros(2),
                        jnp.asarray(hover, jnp.float64),
                        preset.poc.stream_velocity, preset.poc.drag,
                        preset.poc.newton_iters)
    x0[14:17] = np.asarray(poc0)
    return run(spec, jnp.asarray(x0, dtype), jnp.asarray(refs, dtype))
