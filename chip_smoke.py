"""Prove that the BLASTER NMPC runs on an NVIDIA GPU through its own entry
points, and that what it computes there is right.

    python chip_smoke.py          # one card: phases 1-5
    python chip_smoke.py --four   # four cards: the device-mesh path only

Run it from the root of a checkout, as the only JAX process on the card(s):
a JAX process reserves most of a card's memory when it starts.

Every phase runs an entry point on the card in float32 and the same entry
point on the host CPU backend in float64, in this process, and compares
the two within a tolerance printed beside the comparison. It compares
objectives, thrust channels and closed-loop positions, not raw gimbal
rates: the BLASTER cost leaves the gimbal subspace nearly flat, so its
optima are weakly determined. A failed comparison or an error in any phase
makes the script exit non-zero without a result line. The last line of a
passing run is one JSON object naming the device JAX used.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

# The float64 reference runs on the host CPU backend in this process, so
# keep that backend available when the platform list is pinned.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mpc_blaster_tpu import config as cfg  # noqa: E402
from mpc_blaster_tpu.ocp.spec import build_spec, total_cost  # noqa: E402
from mpc_blaster_tpu.qp.data import MATMUL_PRECISION  # noqa: E402
from mpc_blaster_tpu.sqp.rti import init_rti_state, make_rti_step  # noqa: E402
from mpc_blaster_tpu.utils.cache import enable_compile_cache  # noqa: E402
from mpc_blaster_tpu.utils.timing import (  # noqa: E402
    call_times, card_identity)

F32, F64 = jnp.float32, jnp.float64
CARD_VS_CPU = "card float32 vs cpu float64"
MESH_VS_ONE = "4-device vs 1-device mesh, both float32"


def require_gpu(devices) -> None:
    """Exit non-zero, naming what JAX found, unless it found a GPU."""
    d = devices[0]
    if d.platform != "gpu":
        sys.exit(f"chip_smoke: needs an NVIDIA GPU; JAX found "
                 f"{len(devices)} {d.platform} device(s) ({d.device_kind})")


@contextlib.contextmanager
def on(device, x64: bool):
    """Run the enclosed entry point on `device`, with 64-bit types on or
    off (the card runs float32, as deployed; the reference float64)."""
    with jax.enable_x64(x64), jax.default_device(device):
        yield


class Report:
    """Collects comparisons; any failure fails the run."""

    def __init__(self, card: str):
        self.card = card
        self.failures: list[str] = []

    def _line(self, phase, text, ok):
        print(f"[{phase}] {text} -> {'PASS' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failures.append(f"[{phase}] {text}")

    def close(self, phase, what, got, want, tol, rel=False, unit="",
              vs=CARD_VS_CPU):
        """Max |card - reference| (relative to max |reference| when
        `rel`) within `tol`; the card's values must be finite."""
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        finite = bool(np.isfinite(got).all())
        err = float(np.max(np.abs(got - want))) if got.size else 0.0
        if rel:
            err /= max(float(np.max(np.abs(want))), 1e-30)
        kind = "rel" if rel else "abs"
        self._line(phase, f"{what}: {kind} |card-ref| = {err:.3e}{unit}, "
                   f"tol {tol:.1e}{unit} ({vs}, qp matmul precision "
                   f"{MATMUL_PRECISION}{'' if finite else ', NON-FINITE'})",
                   finite and err <= tol)

    def spread(self, phase, what, got, want, tol_median, tol_p99,
               rel=False, unit="", vs=CARD_VS_CPU):
        """Per-sample (first axis) max |card - reference| (relative to
        the sample's max |reference| when `rel`): the median within
        `tol_median` and the 99th percentile within `tol_p99`; every card
        value finite."""
        got = np.asarray(got, np.float64).reshape(len(got), -1)
        want = np.asarray(want, np.float64).reshape(len(want), -1)
        finite = bool(np.isfinite(got).all())
        err = np.max(np.abs(got - want), axis=1)
        if rel:
            err = err / np.maximum(np.max(np.abs(want), axis=1), 1e-30)
        med, p99 = np.percentile(err, [50, 99])
        kind = "rel" if rel else "abs"
        self._line(phase, f"{what}: {kind} |card-ref| over {len(err)} "
                   f"samples: median {med:.3e}{unit} (tol "
                   f"{tol_median:.1e}), p99 {p99:.3e}{unit} (tol "
                   f"{tol_p99:.1e}), max {err.max():.3e}{unit} ({vs}, qp "
                   f"matmul precision {MATMUL_PRECISION}"
                   f"{'' if finite else ', NON-FINITE'})",
                   finite and med <= tol_median and p99 <= tol_p99)

    def holds(self, phase, what, ok):
        self._line(phase, what, bool(ok))


def _sim_ocp(N: int, solver=None) -> cfg.OCPConfig:
    """The simulation preset's OCP at horizon N with dt = 1/30 s."""
    ocp = dataclasses.replace(cfg.simulation_preset().ocp, N=N, Tf=N / 30.0)
    if solver is not None:
        ocp = dataclasses.replace(ocp, solver=solver)
    return ocp


def _poc_params(dtype):
    from mpc_blaster_tpu.sim.closedloop import preset_stage_params
    return preset_stage_params(cfg.simulation_preset(), dtype)


# --------------------------------------------------------------- phase 1 ---
def phase_deployed_tick(rep, dev, ref, N=60, ticks=30, loop_steps=150):
    """B=1 ticks of every deployed profile: `make_rti_step` driven tick by
    tick against the plant model (cold profiles), and the warm,
    watchdog-guarded closed loop (`fastest`).

    Single ticks at a fixed state are compared only inside a closed loop:
    a float32 IPM solve lands now and then on a visibly different best
    iterate than float64 (weakly active bounds, the flat gimbal
    subspace), and the plant's feedback is what contracts that noise."""
    from mpc_blaster_tpu.dynamics.blaster import BlasterParams, blaster_ode
    from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu.sim.closedloop import make_closed_loop

    preset = cfg.simulation_preset()
    # (positions m, objective median, objective p99): `safe` plans land
    # now and then on another best iterate in float32 (a 0.14 relative
    # objective p99 read on the CPU in float32 alone), `fast` ones not
    limits = {"safe": (5e-3, 1e-3, 0.25), "fast": (2e-3, 1e-3, 1e-2)}
    for profile, (tol_x, tol_med, tol_p99) in limits.items():
        ocp = _sim_ocp(N, cfg.deployed_solver(profile))

        def run(dtype):
            spec = build_spec(ocp, yref=preset.loop.yref,
                              stage_params=_poc_params(dtype), dtype=dtype)
            step = make_rti_step(ocp, dtype=dtype)
            params = BlasterParams.from_config(ocp.model, dtype)
            plant = jax.jit(discrete_dynamics(blaster_ode, ocp.dt))
            p_plant = spec.stage_params[0].at[-1].set(2.2 * 9.81)
            x = jnp.asarray(preset.loop.x0, dtype)
            st = init_rti_state(ocp, x, dtype)
            xs, objs = [], []
            for _ in range(ticks):
                u0, st, _ = step(spec, st, x)
                objs.append(float(total_cost(spec, st.xbar, st.ubar)))
                x = plant(x, u0, p_plant, params)
                xs.append(np.asarray(x))
            return np.asarray(xs), np.asarray(objs)

        with on(dev, False):
            x_c, o_c = run(F32)
        with on(ref, True):
            x_r, o_r = run(F64)
        rep.close("1", f"{profile} N={N}, {ticks} ticks with the plant: "
                  "positions", x_c[:, 0:3], x_r[:, 0:3], tol=tol_x,
                  unit=" m")
        rep.spread("1", f"{profile} N={N}: planned objective per tick",
                   o_c, o_r, tol_med, tol_p99, rel=True)

    ocp = _sim_ocp(N, cfg.deployed_solver("fastest"))

    def run_warm(dtype):
        spec = build_spec(ocp, yref=preset.loop.yref,
                          stage_params=_poc_params(dtype), dtype=dtype)
        loop = make_closed_loop(ocp, loop_steps, dtype=dtype,
                                warm_start=True)
        res = loop(spec, jnp.asarray(preset.loop.x0, dtype))
        return np.asarray(res.xs[:, 0:3]), np.asarray(res.kkt_eq)

    with on(dev, False):
        p_c, eq_c = run_warm(F32)
    with on(ref, True):
        p_r, _ = run_warm(F64)
    settled = loop_steps * 4 // 5
    rep.close("1", f"fastest N={N} warm guarded loop, {loop_steps} steps: "
              "positions", p_c, p_r, tol=0.025, unit=" m")
    rep.close("1", f"fastest N={N} warm guarded loop: settled positions "
              f"(steps {settled}..{loop_steps})", p_c[settled:],
              p_r[settled:], tol=1e-3, unit=" m")
    rep.holds("1", f"fastest loop kkt_eq finite, max {eq_c.max():.2e}",
              np.isfinite(eq_c).all())


# --------------------------------------------------------------- phase 2 ---
def phase_closed_loop(rep, dev, ref, N=60, n_steps=300, fig8_steps=240):
    """`run_preset` of the simulation preset with POC Jacobians, and the
    figure-8 at the `safe` profile."""
    from mpc_blaster_tpu.sim.closedloop import run_preset
    from mpc_blaster_tpu.sim.tasks import run_figure8

    base = cfg.simulation_preset()
    preset = dataclasses.replace(base, ocp=_sim_ocp(N))

    def run(dtype):
        res = run_preset(preset, n_steps=n_steps, dtype=dtype, with_poc=True)
        return np.asarray(res.xs), np.asarray(res.kkt_eq)

    with on(dev, False):
        xs_c, eq_c = run(F32)
    with on(ref, True):
        xs_r, _ = run(F64)
    rep.close("2", f"run_preset N={N}, {n_steps} steps: positions",
              xs_c[:, 0:3], xs_r[:, 0:3], tol=0.01, unit=" m")
    rep.holds("2", f"run_preset final z = {xs_c[-1, 2]:.4f} m "
              "(target 3.5, tol 0.05)", abs(xs_c[-1, 2] - 3.5) < 0.05)
    rep.holds("2", f"run_preset max kkt_eq after tick 10 = "
              f"{eq_c[10:].max():.2e} (tol 5e-2), all finite",
              np.isfinite(xs_c).all() and np.isfinite(eq_c).all()
              and eq_c[10:].max() < 5e-2)

    fig_preset = dataclasses.replace(
        base, ocp=_sim_ocp(N, cfg.deployed_solver("safe")))
    settle = max(fig8_steps // 4, 1)

    def fig8(dtype):
        res = run_figure8(fig_preset, n_steps=fig8_steps, dtype=dtype)
        xs, refs = np.asarray(res.xs), np.asarray(res.refs)
        err = np.linalg.norm(xs[1:, 0:2] - refs[:, 0:2], axis=1)
        return float(err[settle:].max())

    with on(dev, False):
        e_c = fig8(F32)
    with on(ref, True):
        e_r = fig8(F64)
    rep.close("2", f"figure-8 safe N={N}, {fig8_steps} steps: settle error "
              f"{e_c:.4f} m (ref {e_r:.4f} m)", e_c, e_r, tol=1e-3,
              unit=" m")


# --------------------------------------------------------------- phase 3 ---
def scenario_draws(B: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x0s = np.zeros((B, cfg.NX))
    x0s[:, 0:3] = rng.uniform(-0.4, 0.4, (B, 3))
    x0s[:, 2] += 2.0
    return x0s


def phase_batched(rep, dev, ref, B=4096, N=20, ticks=10, n_check=8):
    """`batched_rti_step` over B Monte-Carlo draws at the `safe` profile,
    `ticks` chained ticks at fixed initial states; `n_check` sampled
    scenarios against B=1 ticks on the CPU.

    A float32 IPM solve of these QPs lands a few percent of scenarios on
    a visibly different best iterate than float64 (weakly active bounds,
    the flat gimbal subspace), and chained ticks at a fixed x0 are SQP
    iterations, which limit-cycle in float32 where float64 contracts
    (CLAUDE.md "Numerical facts"). So the sampled scenarios are compared
    by the median error, tightly, and by the 99th percentile, loosely."""
    from mpc_blaster_tpu.parallel.mesh import batched_rti_step

    preset = cfg.simulation_preset()
    ocp = _sim_ocp(N, cfg.deployed_solver("safe"))
    x0s = scenario_draws(B)
    pick = np.random.default_rng(1).choice(B, size=min(n_check, B),
                                           replace=False)
    cost = jax.vmap(total_cost, in_axes=(None, 0, 0))

    with on(dev, False):
        spec = build_spec(ocp, yref=preset.loop.yref, dtype=F32)
        xs = jnp.asarray(x0s, F32)
        states = jax.vmap(lambda x: init_rti_state(ocp, x, F32))(xs)
        step = batched_rti_step(ocp, dtype=F32)
        card = []
        for _ in range(ticks):
            u0s, states, diags = step(spec, states, xs)
            card.append((np.asarray(u0s),
                         np.asarray(cost(spec, states.xbar, states.ubar))))
        eq = np.asarray(diags.qp_kkt_eq)
    rep.holds("3", f"batched B={B} N={N}, {ticks} ticks: all u0 finite, "
              f"max kkt_eq {eq.max():.2e}",
              all(np.isfinite(u).all() and np.isfinite(o).all()
                  for u, o in card) and np.isfinite(eq).all())

    with on(ref, True):
        spec = build_spec(ocp, yref=preset.loop.yref, dtype=F64)
        step1 = make_rti_step(ocp, dtype=F64)
        ref_out = []
        for i in pick:
            x = jnp.asarray(x0s[i], F64)
            st = init_rti_state(ocp, x, F64)
            per_tick = []
            for _ in range(ticks):
                u0, st, _ = step1(spec, st, x)
                per_tick.append((np.asarray(u0),
                                 float(total_cost(spec, st.xbar, st.ubar))))
            ref_out.append(per_tick)
    for k, thrust_tol, obj_tol in ((0, (0.03, 0.3), (1e-3, 0.02)),
                                   (ticks - 1, (0.5, 2.0), (3e-2, 0.15))):
        u_r = np.asarray([r[k][0][:4] for r in ref_out])
        o_r = np.asarray([r[k][1] for r in ref_out])
        rep.spread("3", f"batched tick {k + 1} vs B=1 cpu: thrust u0[0:4]",
                   card[k][0][pick, :4], u_r, *thrust_tol, unit=" N")
        rep.spread("3", f"batched tick {k + 1} vs B=1 cpu: objective",
                   card[k][1][pick], o_r, *obj_tol, rel=True)


# --------------------------------------------------------------- phase 4 ---
def phase_other_paths(rep, dev, ref, flight_ticks=5, soft_N=20,
                      soft_ticks=30, of_N=30, of_steps=250, q13_N=20,
                      q13_ticks=10):
    """The paths that used to run the removed IPM kernel: the flight node, the soft
    tick, the offset-free loop and the quad13 tick."""
    from mpc_blaster_tpu.io.flight import FlightNode
    from mpc_blaster_tpu.sim.scenarios import offset_free_loop

    def flight(dtype):
        node = FlightNode(cfg.flight_preset(), dtype=dtype)
        node.run(flight_ticks)
        return node.adapter.messages

    with on(dev, False):
        msgs = flight(F32)
    with on(ref, True):
        msgs_r = flight(F64)
    quat_err = max(abs(float(np.linalg.norm(m.orientation)) - 1.0)
                   for m in msgs)
    rep.holds("4", f"FlightNode {flight_ticks} ticks: {len(msgs)} messages, "
              f"type_mask {sorted({m.type_mask for m in msgs})}, "
              f"max | |q|-1 | {quat_err:.1e} (tol 1e-5), shutdown thrust "
              f"{msgs[-1].thrust}",
              len(msgs) == flight_ticks + 1
              and all(m.type_mask == 7 for m in msgs)
              and quat_err < 1e-5 and msgs[-1].thrust == 0.705)
    rep.close("4", "FlightNode normalized thrust setpoints",
              [m.thrust for m in msgs], [m.thrust for m in msgs_r],
              tol=5e-3)

    # soft tick from outside the hard position box (x = 1.6 m > 1.5 m)
    from mpc_blaster_tpu.dynamics.blaster import BlasterParams, blaster_ode
    from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu.qp.soft import SoftBounds
    from mpc_blaster_tpu.sqp.rti import make_linearizer, rti_step_soft

    preset = cfg.simulation_preset()
    ocp = _sim_ocp(soft_N, cfg.deployed_solver("safe"))

    def soft(dtype):
        params = BlasterParams.from_config(ocp.model, dtype)
        F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
        lin = make_linearizer(ocp, params)
        sb = SoftBounds.state_bounds(ocp.N, cfg.NX, cfg.NU, Zl=1e3, zl=1e2,
                                     dtype=dtype)
        spec = build_spec(ocp, yref=preset.loop.yref, dtype=dtype)
        p_plant = spec.stage_params[0]

        @jax.jit
        def tick(st, x):
            u0, st, _, res = rti_step_soft(spec, st, x, params, F,
                                           ocp.solver, sb, linearizer=lin)
            return st, F(x, u0, p_plant, params), res.t_ux[0, 0]

        x = jnp.zeros(cfg.NX, dtype).at[0].set(1.6).at[2].set(2.0)
        st = init_rti_state(ocp, x, dtype)
        xs, viol = [], []
        for _ in range(soft_ticks):
            st, x, v = tick(st, x)
            xs.append(np.asarray(x))
            viol.append(float(v))
        return np.asarray(xs), np.asarray(viol)

    with on(dev, False):
        x_c, v_c = soft(F32)
    with on(ref, True):
        x_r, v_r = soft(F64)
    rep.close("4", f"rti_step_soft N={soft_N}, {soft_ticks} ticks from "
              "outside the box, with the plant: positions", x_c[:, 0:3],
              x_r[:, 0:3], tol=0.02, unit=" m")
    rep.spread("4", f"rti_step_soft N={soft_N}: planned stage-1 upper-x "
               "violation per tick", v_c, v_r, 1e-3, 0.1, unit=" m")

    ocp_of = _sim_ocp(of_N, cfg.deployed_solver("safe"))

    def offset_free(dtype):
        spec = build_spec(ocp_of, yref=preset.loop.yref, dtype=dtype)
        x0 = jnp.zeros(cfg.NX, dtype).at[2].set(3.0)
        wind = jnp.asarray([0.7, -0.5, 0.2], dtype)
        run = jax.jit(lambda s, x: offset_free_loop(
            s, ocp_of, x, wind, n_steps=of_steps, dtype=dtype))
        res = run(spec, x0)
        return np.asarray(res.xs[:, 0:3]), np.asarray(res.d_hist[-1])

    with on(dev, False):
        p_c, d_c = offset_free(F32)
    with on(ref, True):
        p_r, d_r = offset_free(F64)
    # the wind transient runs through the flat gimbal subspace, where f32
    # and f64 take visibly different (equally good) paths; the settled
    # loop must agree closely
    settled = of_steps * 4 // 5
    rep.close("4", f"offset_free_loop N={of_N}, {of_steps} steps: transient "
              "positions", p_c, p_r, tol=0.05, unit=" m")
    rep.close("4", f"offset_free_loop N={of_N}: settled positions (steps "
              f"{settled}..{of_steps})", p_c[settled:], p_r[settled:],
              tol=1e-3, unit=" m")
    rep.close("4", f"offset_free_loop N={of_N}: final disturbance estimate",
              d_c, d_r, tol=1e-3, unit=" m/s^2")

    from mpc_blaster_tpu.models.quad13 import (Quad13Config, _params,
                                               build_quad13_spec, hover_state,
                                               init_quad13_rti_state,
                                               make_quad13_rti_step,
                                               quad13_ode)

    qc = Quad13Config(N=q13_N, Tf=q13_N / 30.0)

    def quad13(dtype):
        spec = build_quad13_spec(qc, dtype=dtype)
        step = make_quad13_rti_step(qc, dtype=dtype,
                                    solver=cfg.deployed_solver("safe"))
        F = discrete_dynamics(quad13_ode, qc.dt, num_steps=1)
        params = _params(qc, dtype)
        x = hover_state(1.5, dtype)
        st = init_quad13_rti_state(qc, x, dtype)
        for _ in range(q13_ticks):
            u0, st, _ = step(spec, st, x)
            x = F(x, u0, jnp.zeros(1, dtype), params)
        return np.asarray(u0), np.asarray(x)

    with on(dev, False):
        u_c, x_c = quad13(F32)
    with on(ref, True):
        u_r, x_r = quad13(F64)
    rep.close("4", f"quad13 N={q13_N} {q13_ticks}-tick loop: thrust u0",
              u_c, u_r, tol=1e-3, unit=" N")
    rep.close("4", f"quad13 N={q13_N} {q13_ticks}-tick loop: position",
              x_c[0:3], x_r[0:3], tol=1e-4, unit=" m")


# --------------------------------------------------------------- phase 5 ---
def linearizer_errors(dev, ref, N=60):
    """Max |A,B| error of the jacfwd and the component-form linearizers
    on `dev` (float32) against jacfwd on the CPU in float64, relative to
    max |A,B|."""
    from mpc_blaster_tpu.dynamics.blaster import BlasterParams, blaster_ode
    from mpc_blaster_tpu.dynamics.fastlin import fast_linearize
    from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu.sqp.rti import _linearize_nodes

    ocp = _sim_ocp(N)
    rng = np.random.default_rng(2)
    xbar = rng.uniform(-0.1, 0.1, (N + 1, cfg.NX))
    xbar[:, 2] += 2.0
    ubar = 22.0 + rng.uniform(-1.0, 1.0, (N, cfg.NU))
    ubar[:, 4:] = rng.uniform(-0.05, 0.05, (N, 2))

    def lin(dtype, which):
        params = BlasterParams.from_config(ocp.model, dtype)
        sp = jnp.tile(jnp.asarray(_poc_params(dtype))[None], (N, 1))
        xb, ub = jnp.asarray(xbar, dtype), jnp.asarray(ubar, dtype)
        if which == "jacfwd":
            F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
            f = jax.jit(lambda a, b, c: _linearize_nodes(F, a, b, c, params))
        else:
            f = jax.jit(lambda a, b, c: fast_linearize(a, b, c, params,
                                                       ocp.dt, 1))
        _, A, Bm = f(xb, ub, sp)
        return np.concatenate([np.asarray(A), np.asarray(Bm)], axis=-1)

    with on(ref, True):
        ab_ref = lin(F64, "jacfwd")
    scale = float(np.abs(ab_ref).max())
    out = {}
    for which in ("jacfwd", "fused"):
        with on(dev, False):
            ab = lin(F32, which)
        out[which] = float(np.abs(ab - ab_ref).max()) / scale
    return out


def phase_info(rep, dev, ref, Ns=(20, 30, 60), B=4096, N_batch=20,
               samples=200):
    """Information only: the linearizers' float32 error, B=1 tick
    latency per horizon, batched solves/s, compile times and memory."""
    from mpc_blaster_tpu.parallel.mesh import batched_rti_step

    card = rep.card
    errs = linearizer_errors(dev, ref, N=max(Ns))
    print(f"[5] linearizer A/B rel error vs cpu float64 at N={max(Ns)} "
          f"(card float32, jacfwd at matmul precision {MATMUL_PRECISION}): "
          f"jacfwd "
          f"{errs['jacfwd']:.3e}, fused {errs['fused']:.3e}", flush=True)
    rep.holds("5", "linearizer A/B errors finite",
              all(np.isfinite(v) for v in errs.values()))

    preset = cfg.simulation_preset()
    with on(dev, False):
        for N in Ns:
            ocp = _sim_ocp(N, cfg.deployed_solver("safe"))
            spec = build_spec(ocp, yref=preset.loop.yref,
                              stage_params=_poc_params(F32), dtype=F32)
            x0 = jnp.asarray(preset.loop.x0, F32)
            st = init_rti_state(ocp, x0, F32)
            t0 = time.perf_counter()
            tick = make_rti_step(ocp, dtype=F32).lower(spec, st, x0).compile()
            t_compile = time.perf_counter() - t0
            ts = call_times(lambda: tick(spec, st, x0), reps=samples,
                            warmup=10)
            p50, p90 = np.percentile(ts, 50), np.percentile(ts, 90)
            print(f"[5] B=1 safe tick N={N}: p50 {p50 * 1e3:.4f} ms, "
                  f"p90 {p90 * 1e3:.4f} ms over {samples} ticks "
                  f"(host clock around block_until_ready), compile "
                  f"{t_compile:.2f} s | card: {card}", flush=True)
            if N == max(Ns):
                print(f"[5] N={N} tick memory_analysis: "
                      f"{tick.memory_analysis()}", flush=True)

        ocp = _sim_ocp(N_batch, cfg.deployed_solver("safe"))
        spec = build_spec(ocp, yref=preset.loop.yref, dtype=F32)
        xs = jnp.asarray(scenario_draws(B), F32)
        states = jax.vmap(lambda x: init_rti_state(ocp, x, F32))(xs)
        t0 = time.perf_counter()
        bstep = batched_rti_step(ocp, dtype=F32).lower(
            spec, states, xs).compile()
        t_compile = time.perf_counter() - t0
        ts = call_times(lambda: bstep(spec, states, xs), reps=20, warmup=3)
        print(f"[5] batched B={B} N={N_batch} safe tick "
              f"({ocp.solver.ipm_iters} IPM iterations): "
              f"{B / np.median(ts):.1f} solves/s (median of 20 ticks, "
              f"{np.median(ts) * 1e3:.3f} ms/tick), compile "
              f"{t_compile:.2f} s | card: {card}", flush=True)
        print(f"[5] batched tick memory_analysis: "
              f"{bstep.memory_analysis()}", flush=True)
        stats = dev.memory_stats() or {}
        print(f"[5] peak_bytes_in_use: {stats.get('peak_bytes_in_use')} "
              f"| card: {card}", flush=True)


# ------------------------------------------------------------ four cards ---
def four_cards(rep, devices, B=4096, N=20, ticks=3, sweep_B=256,
               sweep_N=10, sweep_steps=20, N_sp=64):
    """The device-mesh path on a plain 1-D "dp" mesh of four devices,
    each call checked against the same call on a one-device mesh.

    The per-device shards compile to other batch shapes than the
    one-device program, and float32 IPM solves amplify that rounding in
    a few percent of scenarios (see `phase_batched`): per-scenario results
    are compared by median (tight) and 99th percentile (loose), the pmean of
    the sweep exactly against the host's mean of the gathered shards, and
    a pmax (a worst case over scenarios) only for being finite."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mpc_blaster_tpu.dynamics.blaster import BlasterParams, blaster_ode
    from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu.parallel.mesh import (make_mesh, sharded_rti_step,
                                               sharded_sweep)
    from mpc_blaster_tpu.qp.data import qp_objective
    from mpc_blaster_tpu.qp.pscan import lqr_solve_pscan
    from mpc_blaster_tpu.qp.riccati import lqr_solve
    from mpc_blaster_tpu.sqp.rti import build_qp

    n = 4
    mesh4, mesh1 = make_mesh(n), make_mesh(1)
    preset = cfg.simulation_preset()
    safe = cfg.deployed_solver("safe")

    def shard_shapes(arr):
        return sorted({tuple(s.data.shape) for s in arr.addressable_shards})

    def shard_devices(arr):
        return len({s.device for s in arr.addressable_shards})

    # 1. scenario batch sharded over "dp"
    ocp = _sim_ocp(N, safe)
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=F32)
    xs = jnp.asarray(scenario_draws(B), F32)
    outs = {}
    for name, mesh in (("4", mesh4), ("1", mesh1)):
        step = sharded_rti_step(ocp, mesh, dtype=F32)
        st = jax.vmap(lambda x: init_rti_state(ocp, x, F32))(xs)
        per_tick = []
        t0 = time.perf_counter()
        for _ in range(ticks):
            u0s, st, mean_step, worst_kkt = step(spec, st, xs)
            per_tick.append((u0s, float(mean_step), float(worst_kkt)))
        outs[name] = (per_tick, st, time.perf_counter() - t0)
    u4, st4 = outs["4"][0][0][0], outs["4"][1]
    rep.holds("4x", f"sharded_rti_step B={B} N={N}: u0 shards "
              f"{shard_shapes(u4)} on {shard_devices(u4)} devices, xbar "
              f"shards {shard_shapes(st4.xbar)}",
              shard_shapes(u4) == [(B // n, cfg.NU)]
              and shard_devices(u4) == n
              and shard_shapes(st4.xbar) == [(B // n, N + 1, cfg.NX)])
    for k, tol_med, tol_p99 in ((0, 0.02, 0.5), (ticks - 1, 0.3, 4.0)):
        u4k, u1k = outs["4"][0][k][0], outs["1"][0][k][0]
        rep.spread("4x", f"sharded_rti_step tick {k + 1}: u0", u4k, u1k,
                   tol_med, tol_p99, unit=" N", vs=MESH_VS_ONE)
    (_, ms4, wk4), (_, ms1, wk1) = outs["4"][0][0], outs["1"][0][0]
    rep.close("4x", "sharded_rti_step tick 1: pmean step norm", ms4, ms1,
              tol=1e-4, rel=True, vs=MESH_VS_ONE)
    # a max over scenarios rides the float32 outliers: shown, not compared
    rep.holds("4x", f"sharded_rti_step tick 1: pmax kkt_stat {wk4:.3e} "
              f"finite (1-device mesh {wk1:.3e})", np.isfinite(wk4))
    print(f"[4x] sharded_rti_step {ticks} ticks incl. compile: 4 devices "
          f"{outs['4'][2]:.2f} s, 1 device {outs['1'][2]:.2f} s "
          f"| card: {rep.card}", flush=True)

    # 2. closed-loop sweep with pmean/pmax reductions
    ocp_s = _sim_ocp(sweep_N, safe)
    spec_s = build_spec(ocp_s, yref=preset.loop.yref, dtype=F32)
    xs_s = jnp.asarray(scenario_draws(sweep_B, seed=3), F32)
    sw = {name: sharded_sweep(ocp_s, mesh, n_steps=sweep_steps,
                              dtype=F32)(spec_s, xs_s)
          for name, mesh in (("4", mesh4), ("1", mesh1))}
    fin4 = np.asarray(sw["4"][0])
    rep.holds("4x", f"sharded_sweep B={sweep_B}: finals shards "
              f"{shard_shapes(sw['4'][0])}",
              shard_shapes(sw["4"][0]) == [(sweep_B // n, cfg.NX)])
    rep.spread("4x", f"sharded_sweep {sweep_steps} steps: final positions",
               fin4[:, 0:3], np.asarray(sw["1"][0])[:, 0:3], 0.05, 1.0,
               unit=" m", vs=MESH_VS_ONE)
    host_mean = float(np.mean(np.linalg.norm(
        fin4[:, 0:3] - np.asarray(spec_s.yref_x[-1, 0:3]), axis=1)))
    rep.close("4x", "sharded_sweep pmean position error vs host mean of "
              "the gathered shards", float(sw["4"][2]), host_mean,
              tol=1e-5, rel=True, vs="4-device collective vs host")
    rep.holds("4x", f"sharded_sweep pmax kkt_eq {float(sw['4'][3]):.3e} "
              f"finite (1-device mesh {float(sw['1'][3]):.3e})",
              np.isfinite(float(sw["4"][3])))

    # 3. horizon-sharded parallel-scan Riccati solve vs the sequential one
    ocp_sp = _sim_ocp(N_sp)
    spec_sp = build_spec(ocp_sp, yref=preset.loop.yref, dtype=F32)
    params = BlasterParams.from_config(ocp_sp.model, F32)
    F = discrete_dynamics(blaster_ode, ocp_sp.dt, num_steps=1)
    qp = build_qp(spec_sp, init_rti_state(ocp_sp, xs[0], F32), xs[0], F,
                  params)
    shard = NamedSharding(mesh4, P("dp"))
    qp_sh = qp._replace(**{k: jax.device_put(getattr(qp, k), shard)
                           for k in ("A", "B", "c", "R", "r")})
    sol_sp = jax.jit(lqr_solve_pscan)(qp_sh)
    sol = lqr_solve(jax.device_put(qp, devices[0]))
    rep.holds("4x", f"pscan N={N_sp}: A shards {shard_shapes(qp_sh.A)}",
              shard_shapes(qp_sh.A) == [(N_sp // n, cfg.NX, cfg.NX)])

    def qobj(s):
        return float(qp_objective(qp, s.dx, s.du))

    vs = "horizon-sharded pscan vs sequential lqr_solve, both float32"
    rep.close("4x", f"pscan N={N_sp}: du", np.asarray(sol_sp.du),
              np.asarray(sol.du), tol=1e-3, rel=True, vs=vs)
    rep.close("4x", f"pscan N={N_sp}: objective", qobj(sol_sp), qobj(sol),
              tol=1e-5, rel=True, vs=vs)


PHASES = (("1 deployed B=1 ticks", phase_deployed_tick),
          ("2 closed loop + figure-8", phase_closed_loop),
          ("3 batched Monte-Carlo tick", phase_batched),
          ("4 flight node, soft, offset-free, quad13", phase_other_paths),
          ("5 timing and memory (information)", phase_info))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card device-mesh path")
    args = ap.parse_args(argv)

    card = card_identity()
    print(f"card: {card}", flush=True)
    devices = jax.devices()
    require_gpu(devices)
    if args.four and len(devices) < 4:
        sys.exit(f"chip_smoke: --four needs 4 GPUs; JAX found "
                 f"{len(devices)}")
    print(f"jax {jax.__version__}: {len(devices)} x "
          f"{devices[0].device_kind} ({devices[0].platform}); compile "
          f"cache {enable_compile_cache()}", flush=True)

    rep = Report(card)
    dev, ref = devices[0], jax.devices("cpu")[0]
    if args.four:
        phases = (("four-card mesh", lambda r, d, c: four_cards(r, devices)),)
    else:
        phases = PHASES
    for name, fn in phases:
        t0 = time.perf_counter()
        print(f"== phase {name}", flush=True)
        try:
            fn(rep, dev, ref)
        except Exception:
            traceback.print_exc()
            rep.failures.append(f"phase {name} raised")
        print(f"== phase {name}: {time.perf_counter() - t0:.1f} s "
              f"| card: {card}", flush=True)
    if rep.failures:
        print("chip_smoke FAILED:\n  " + "\n  ".join(rep.failures),
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
