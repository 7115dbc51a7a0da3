"""Scenario generation + disturbance-robustness sweeps (BASELINE config 4).

The reference simulates exactly one nominal trajectory with a perfect model
(`simulation_blaster.py:56-107`). Production controller validation needs
fans of perturbed scenarios: initial-state draws, constant wind (model
mismatch: the controller's model does NOT see it), and target offsets. The
whole sweep — every scenario's full closed loop — is one vmapped/shardable
on-device computation.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.dynamics.blaster import BlasterParams, blaster_ode
from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu.ocp.spec import OCPSpec
from mpc_blaster_tpu.sqp.rti import init_rti_state, rti_step


class ScenarioBatch(NamedTuple):
    x0: jnp.ndarray        # (B, nx) initial states
    wind: jnp.ndarray      # (B, 3) constant wind acceleration [m/s^2]
    target: jnp.ndarray    # (B, 3) position targets


class SweepResult(NamedTuple):
    final_states: jnp.ndarray   # (B, nx)
    pos_err: jnp.ndarray        # (B,) final position error
    worst_kkt_eq: jnp.ndarray   # (B,)
    settled: jnp.ndarray        # (B,) bool: err < 0.25 m


def sample_scenarios(batch: int, seed: int = 0,
                     pos_spread: float = 0.4,
                     wind_max: float = 1.0,
                     target_spread: float = 0.3,
                     base_target=(0.0, 0.0, 3.5)) -> ScenarioBatch:
    rng = np.random.default_rng(seed)
    x0 = np.zeros((batch, cfg.NX), np.float32)
    x0[:, 0:2] = rng.uniform(-pos_spread, pos_spread, (batch, 2))
    x0[:, 2] = rng.uniform(0.0, 0.5, batch)
    wind = rng.uniform(-wind_max, wind_max, (batch, 3)).astype(np.float32)
    wind[:, 2] *= 0.3  # vertical gusts weaker
    target = (np.asarray(base_target, np.float32)
              + rng.uniform(-target_spread, target_spread,
                            (batch, 3)).astype(np.float32))
    target[:, 2] = np.clip(target[:, 2], 1.0, 4.5)
    return ScenarioBatch(x0=jnp.asarray(x0), wind=jnp.asarray(wind),
                         target=jnp.asarray(target))


def _windy_plant_ode(x, u, p, params, wind):
    """Plant-side model mismatch: constant wind acceleration on v."""
    xdot = blaster_ode(x, u, p, params)
    return xdot.at[cfg.IDX_V].add(wind)


def _disturbed_ode(x, u, p, params, d_v, d_w):
    """Controller-side disturbance model: force (v_dot) + torque
    (omega_dot) acceleration offsets — the 6-channel observer target."""
    xdot = blaster_ode(x, u, p, params)
    return xdot.at[cfg.IDX_V].add(d_v).at[9:12].add(d_w)


def dist_param_ode(x, u, p, params):
    """`_disturbed_ode` with the 6 disturbance channels carried as EXTRA
    STAGE-PARAMETER rows p[25:31] (vector-form twin of
    `dynamics/fastlin.py::_ode_rows_dist`): disturbance estimates stay
    *data*, so one compiled linearizer serves every estimate without
    recompiling."""
    xdot = blaster_ode(x, u, p, params)
    return xdot.at[cfg.IDX_V].add(p[25:28]).at[9:12].add(p[28:31])


class OffsetFreeResult(NamedTuple):
    xs: jnp.ndarray        # (n_steps+1, nx)
    us: jnp.ndarray        # (n_steps, nu)
    d_hist: jnp.ndarray    # (n_steps, 6) force+torque disturbance estimates
    kkt_eq: jnp.ndarray    # (n_steps,)


def offset_free_loop(spec: OCPSpec, ocp: cfg.OCPConfig, x0, wind,
                     n_steps: int = 120, dtype=jnp.float32,
                     observer_gain: float = 0.5,
                     derate=None) -> OffsetFreeResult:
    """B=1 offset-free deployment loop (Pannocchia/Rawlings constant-
    disturbance observer) with the disturbance estimates riding the
    stage-parameter rows p[25:31] ("blaster_dist" model family).

    This is the single-trajectory twin of `disturbance_sweep(offset_free=
    True)` built for the deployed latency path: the tick linearizes the
    disturbance-augmented model with the rows-form "blaster_dist"
    linearizer (`dynamics/fastlin.py`), whatever the QP backend.

    wind: (3,) constant plant wind acceleration (controller blind to it);
    derate: optional (4,) rotor effectiveness for fault recovery.

    HORIZON CAVEAT (r5 correction of the r4 'gimbal weight' story): wind
    compensation on the sim preset needs an adequate horizon. The
    N=20-truncated sim config (0.667 s) is CLOSED-LOOP UNSTABLE under
    compensation — a position/velocity limit cycle with the wind
    estimate exact — and r5 measurement shows it is NOT the gimbal
    weight: raising R_swivel to 10, flooring the QP Hessian
    (SolverConfig.qp_r_floor), soft bounds and an LQR terminal each
    improve but none settles it; no single sim->flight knob flips it.
    Within the
    stable envelope the loop settles to centimeters on BOTH presets:
    N >= 24 at dt=1/30 (native N=60: 0.3 mm). At genuinely short
    horizons (N <= 12) the DARE terminal cost restores stability
    (`ocp/terminal.py::lqr_terminal_weight`, measured 1.6 m hunt ->
    0.08 m settle at N=12). Transient hard-QP infeasibility (plant
    outside the +-1 m/s velocity box on 60% of ticks) is a measured
    co-driver at N=20 — `rti_step_soft` cuts QP eq residuals 10x there.
    """
    from mpc_blaster_tpu.dynamics.fastlin import fast_linearize

    params = BlasterParams.from_config(ocp.model, dtype)
    solver = ocp.solver
    F = discrete_dynamics(dist_param_ode, ocp.dt, num_steps=1)

    def lin(xbar, ubar, stage_params):
        return fast_linearize(xbar, ubar, stage_params, params,
                              ocp.dt, 1, family="blaster_dist")

    x0 = jnp.asarray(x0, dtype)
    wind = jnp.asarray(wind, dtype)
    dr = (jnp.ones(4, dtype) if derate is None
          else jnp.asarray(derate, dtype))
    # controller stage params: 25 reference rows + 6 disturbance rows
    sp0 = jnp.concatenate(
        [spec.stage_params,
         jnp.zeros((spec.horizon, 6), dtype)], axis=1)
    plant_p = spec.stage_params[0].at[-1].set(2.2 * 9.81)
    F_plant = discrete_dynamics(
        lambda xx, uu, pp, par: _windy_plant_ode(xx, uu, pp, par, wind),
        ocp.dt, num_steps=1)  # same plant as disturbance_sweep

    def plant(x, u):
        u_eff = u.at[0:4].multiply(dr)
        return F_plant(x, u_eff, plant_p, params)

    st0 = init_rti_state(ocp, x0, dtype)
    d0 = jnp.zeros(6, dtype)

    def tick(carry, _):
        st, x, d_est, vw_pred = carry
        d_est = d_est.at[0:3].add(
            observer_gain * (x[6:9] - vw_pred[0:3]) / ocp.dt)
        d_est = d_est.at[3:6].add(
            observer_gain * (x[9:12] - vw_pred[3:6]) / ocp.dt)
        sp = sp0.at[:, 25:31].set(d_est[None, :])
        spec_t = spec._replace(stage_params=sp)
        u0, st, diag = rti_step(spec_t, st, x, params, F, solver,
                                linearizer=lin)
        x_next = plant(x, u0)
        pred = F(x, u0, sp[0], params)
        return (st, x_next, d_est, pred[6:12]), (x_next, u0, d_est,
                                                 diag.qp_kkt_eq)

    (_, _, _, _), (xs, us, ds, eqs) = jax.lax.scan(
        tick, (st0, x0, d0, x0[6:12]), None, length=n_steps)
    return OffsetFreeResult(xs=jnp.concatenate([x0[None], xs], axis=0),
                            us=us, d_hist=ds, kkt_eq=eqs)


def fault_sweep(spec: OCPSpec, ocp: cfg.OCPConfig,
                derate: jnp.ndarray, n_steps: int = 150,
                dtype=jnp.float32, offset_free: bool = False,
                observer_gain: float = 0.5,
                hover=(0.0, 0.0, 3.5)) -> SweepResult:
    """Fault injection + elastic recovery (SURVEY.md §5: the reference's
    only failure handling is raising on a bad integrator status).

    derate: (B, 4) per-scenario rotor effectiveness in (0, 1] — the plant
    multiplies each rotor's commanded thrust by it (partial actuator
    failure); the controller is NOT told. offset_free=True runs the same
    constant-disturbance observer as `disturbance_sweep`: a thrust
    deficit shows up as an unmodeled acceleration, the observer folds it
    into the prediction model, and the NMPC re-trims the healthy rotors —
    recovery without fault identification.

    The observer here is SIX-channel (force + torque): a derated rotor
    produces both a thrust deficit and a constant moment imbalance, so
    v_dot AND omega_dot residuals innovate their own estimates and both
    enter the prediction model. The force-only observer of
    `disturbance_sweep` stabilizes symmetric deratings but diverges on a
    30% single-rotor loss (measured: 5.6 m drift) — the torque channels
    are what make single-rotor faults recoverable.
    """
    params = BlasterParams.from_config(ocp.model, dtype)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    solver = ocp.solver
    # solver.lin_backend is honored only on the NOMINAL prediction model:
    # the fused component-form linearizer (dynamics/fastlin.py) hard-codes
    # the blaster ODE, so the observer-augmented model (offset_free=True)
    # must use the generic jacfwd path.
    from mpc_blaster_tpu.sqp.rti import make_linearizer
    lin_nom = None if offset_free else make_linearizer(ocp, params)
    plant_p = spec.stage_params[0].at[-1].set(2.2 * 9.81)
    target = jnp.asarray(hover, dtype)

    def plant(x, u, dr):
        u_eff = u.at[0:4].multiply(dr)
        return F(x, u_eff, plant_p, params)

    def ctrl_F(d_v, d_w):
        return discrete_dynamics(
            lambda xx, uu, pp, par: _disturbed_ode(xx, uu, pp, par,
                                                   d_v, d_w),
            ocp.dt, num_steps=1)

    def one(dr):
        x0 = jnp.zeros(cfg.NX, dtype).at[0:3].set(target)
        spec_i = spec._replace(
            yref_x=spec.yref_x.at[:, 0:3].set(target[None, :]),
            yref_e=spec.yref_e.at[0:3].set(target))
        st0 = init_rti_state(ocp, x0, dtype)
        d0 = jnp.zeros(3, dtype)

        def tick(carry, _):
            st, x, d_v, d_w, vw_pred = carry
            if offset_free:
                d_v = d_v + observer_gain * (x[6:9] - vw_pred[0:3]) / ocp.dt
                d_w = d_w + observer_gain * (x[9:12] - vw_pred[3:6]) / ocp.dt
                F_c = ctrl_F(d_v, d_w)
            else:
                F_c = F
            u0, st, diag = rti_step(spec_i, st, x, params, F_c, solver,
                                    linearizer=lin_nom)
            x_next = plant(x, u0, dr)
            pred = F_c(x, u0, plant_p, params)
            return (st, x_next, d_v, d_w, pred[6:12]), diag.qp_kkt_eq

        (_, x_fin, _, _, _), eqs = jax.lax.scan(
            tick, (st0, x0, d0, d0, x0[6:12]), None, length=n_steps)
        err = jnp.linalg.norm(x_fin[0:3] - target)
        return x_fin, err, jnp.max(eqs)

    finals, errs, kkts = jax.jit(jax.vmap(one))(jnp.asarray(derate, dtype))
    return SweepResult(final_states=finals, pos_err=errs,
                       worst_kkt_eq=kkts, settled=errs < 0.25)


def disturbance_sweep(spec: OCPSpec, ocp: cfg.OCPConfig,
                      scenarios: ScenarioBatch, n_steps: int = 120,
                      dtype=jnp.float32,
                      offset_free: bool = False,
                      observer_gain: float = 0.5) -> SweepResult:
    """Closed loop per scenario: controller is blind to the wind and the
    per-scenario target enters through yref. Fully vmapped; jit once.

    offset_free=True turns on offset-free MPC (Pannocchia/Rawlings-style
    constant-disturbance observer — beyond-reference; the reference has
    no state feedback at all in flight, SURVEY.md §3.4): each tick the
    velocity prediction residual innovates an acceleration-disturbance
    estimate d, and the controller's prediction model becomes
    v_dot + d — the NMPC then plans against the estimated wind and the
    steady-state offset vanishes. The estimator runs inside the scan on
    device; the QP sees it only through the linearization (defects), so
    no solver surface changes.
    """
    params = BlasterParams.from_config(ocp.model, dtype)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    solver = ocp.solver
    # same nominal-model-only rule as fault_sweep (see comment there)
    from mpc_blaster_tpu.sqp.rti import make_linearizer
    lin_nom = None if offset_free else make_linearizer(ocp, params)
    plant_p = spec.stage_params[0].at[-1].set(2.2 * 9.81)

    def plant(x, u, wind):
        return discrete_dynamics(
            lambda xx, uu, pp, par: _windy_plant_ode(xx, uu, pp, par, wind),
            ocp.dt, num_steps=1)(x, u, plant_p, params)

    def ctrl_F(d_est):
        """Controller prediction model with the disturbance estimate."""
        return discrete_dynamics(
            lambda xx, uu, pp, par: _windy_plant_ode(xx, uu, pp, par,
                                                     d_est),
            ocp.dt, num_steps=1)

    def one(x0, wind, target):
        spec_i = spec._replace(
            yref_x=spec.yref_x.at[:, 0:3].set(target[None, :]),
            yref_e=spec.yref_e.at[0:3].set(target))
        st0 = init_rti_state(ocp, x0, dtype)
        d0 = jnp.zeros(3, dtype)

        def tick(carry, _):
            st, x, d_est, v_pred = carry
            if offset_free:
                # innovation: the part of v_dot the model didn't predict
                d_est = d_est + observer_gain * (x[6:9] - v_pred) / ocp.dt
                F_c = ctrl_F(d_est)
            else:
                F_c = F
            u0, st, diag = rti_step(spec_i, st, x, params, F_c, solver,
                                    linearizer=lin_nom)
            x_next = plant(x, u0, wind)
            v_pred_next = F_c(x, u0, plant_p, params)[6:9]
            return (st, x_next, d_est, v_pred_next), diag.qp_kkt_eq

        # seed v_pred with the measured v: zero innovation at tick 0
        (_, x_fin, _, _), eqs = jax.lax.scan(
            tick, (st0, x0, d0, x0[6:9]), None, length=n_steps)
        err = jnp.linalg.norm(x_fin[0:3] - target)
        return x_fin, err, jnp.max(eqs)

    finals, errs, kkts = jax.jit(jax.vmap(one))(
        jnp.asarray(scenarios.x0, dtype), jnp.asarray(scenarios.wind, dtype),
        jnp.asarray(scenarios.target, dtype))
    return SweepResult(final_states=finals, pos_err=errs,
                       worst_kkt_eq=kkts, settled=errs < 0.25)
