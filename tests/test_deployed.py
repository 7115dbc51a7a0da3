"""Deployed solver profiles on the XLA Riccati IPM, the removed Pallas
backends, and the compile-cache helper."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.ocp.spec import build_spec, total_cost
from mpc_blaster_tpu.sqp.rti import init_rti_state, make_rti_step

DTYPE = jnp.float32
N = 8


def _ocp(solver):
    return dataclasses.replace(cfg.simulation_preset().ocp, N=N,
                               Tf=N / 30.0, solver=solver)


def _explicit(profile):
    """The profile's settings spelled out on the XLA Riccati backend."""
    kw = dict(qp_backend="riccati", riccati="scan", lin_backend="fused")
    if profile == "safe":
        return cfg.SolverConfig(ipm_iters=6, **kw)
    if profile == "fast":
        return cfg.SolverConfig(ipm_iters=4, **kw)
    return cfg.SolverConfig(ipm_iters=3, warm_mode="primal", warm_shift=True,
                            warm_watchdog=True, **kw)


@pytest.mark.parametrize("profile", ["safe", "fast", "fastest"])
def test_deployed_profile_closed_loop_matches_explicit_riccati(profile):
    """Each deployed profile runs a short f32 closed loop on the XLA path
    (warm and watchdog-guarded for "fastest") and reproduces the same loop
    built from an explicit riccati configuration."""
    from mpc_blaster_tpu.sim.closedloop import make_closed_loop

    preset = cfg.simulation_preset()
    warm = profile == "fastest"
    x0 = jnp.zeros(cfg.NX, DTYPE).at[2].set(3.0)
    runs = []
    for solver in (cfg.deployed_solver(profile), _explicit(profile)):
        assert solver.qp_backend == "riccati"
        ocp = _ocp(solver)
        spec = build_spec(ocp, yref=preset.loop.yref, dtype=DTYPE)
        res = make_closed_loop(ocp, 12, dtype=DTYPE, warm_start=warm)(
            spec, x0)
        runs.append(res)
    a, b = runs
    assert np.isfinite(np.asarray(a.xs)).all()
    np.testing.assert_allclose(np.asarray(a.xs), np.asarray(b.xs),
                               rtol=0, atol=1e-6)
    # the loop holds the 3.5 m hover target from 3.0 m without blowing up
    assert float(jnp.max(a.kkt_eq)) < 0.5
    assert abs(float(a.xs[-1, 2]) - 3.0) < 0.5


@pytest.mark.parametrize("profile", ["safe", "fast", "fastest", "jacfwd"])
def test_closed_loop_matmuls_all_at_highest_precision(profile):
    """Every matmul of a closed loop — plant, linearizer, QP build, solve —
    and of the reported cost is lowered at HIGHEST precision, so a GPU
    never runs them in TF32 (the default there for float32)."""
    from mpc_blaster_tpu.sim.closedloop import make_closed_loop

    solver = (dataclasses.replace(_explicit("safe"), lin_backend="jacfwd")
              if profile == "jacfwd" else cfg.deployed_solver(profile))
    ocp = _ocp(solver)
    preset = cfg.simulation_preset()
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=DTYPE)
    x0 = jnp.zeros(cfg.NX, DTYPE).at[2].set(3.0)
    st = init_rti_state(ocp, x0, DTYPE)
    texts = (
        make_closed_loop(ocp, 3, dtype=DTYPE,
                         warm_start=profile == "fastest").lower(
            spec, x0).as_text(),
        jax.jit(total_cost).lower(spec, st.xbar, st.ubar).as_text())
    for text in texts:
        dots = [ln for ln in text.splitlines() if "dot_general" in ln]
        assert dots
        assert all("precision = [HIGHEST, HIGHEST]" in ln for ln in dots), (
            [ln for ln in dots if "HIGHEST" not in ln][:3])


@pytest.mark.parametrize("backend", ["pallas", "pallas_fused"])
def test_removed_pallas_backends_raise(backend):
    """The removed kernel backends are gone: naming one fails when the config
    (or any copy of it a step constructor makes) is built."""
    with pytest.raises(ValueError, match="qp_backend"):
        cfg.SolverConfig(qp_backend=backend)
    with pytest.raises(ValueError, match="qp_backend"):
        dataclasses.replace(cfg.deployed_solver("safe"), qp_backend=backend)


def test_batched_rti_step_equals_single_ticks():
    """batched_rti_step at B=4 equals four independent make_rti_step
    ticks (one vmapped XLA path, no backend switch). f64, so f32 IPM
    noise cannot hide a batching error."""
    from mpc_blaster_tpu.parallel.mesh import batched_rti_step

    f64 = jnp.float64
    preset = cfg.simulation_preset()
    ocp = _ocp(cfg.deployed_solver("safe"))
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=f64)
    rng = np.random.default_rng(0)
    x0s = np.zeros((4, cfg.NX))
    x0s[:, 0:3] = rng.uniform(-0.3, 0.3, (4, 3))
    x0s[:, 2] += 2.0
    x0s = jnp.asarray(x0s, f64)
    states = jax.vmap(lambda x: init_rti_state(ocp, x, f64))(x0s)
    u0s, new_states, diags = batched_rti_step(ocp, dtype=f64)(
        spec, states, x0s)
    step = make_rti_step(ocp, dtype=f64)
    for i in range(4):
        u0, st, diag = step(spec, init_rti_state(ocp, x0s[i], f64), x0s[i])
        np.testing.assert_allclose(np.asarray(u0s[i]), np.asarray(u0),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(np.asarray(new_states.xbar[i]),
                                   np.asarray(st.xbar), rtol=1e-9,
                                   atol=1e-9)
        assert abs(float(diags.qp_kkt_eq[i]) - float(diag.qp_kkt_eq)) \
            < 1e-9


def test_quad13_tick_deployed_settings():
    """quad13 under the safe profile's settings (fused rows-form
    linearizer, XLA IPM): a climb tick is finite, consistent, and agrees
    with the jacfwd linearizer's tick."""
    from mpc_blaster_tpu.models.quad13 import (
        Quad13Config, build_quad13_spec, hover_state,
        init_quad13_rti_state, make_quad13_rti_step)

    qc = Quad13Config(N=N, Tf=N / 30.0)
    spec = build_quad13_spec(qc, target_pos=(0.0, 0.0, 1.4), dtype=DTYPE)
    x0 = hover_state(1.0, DTYPE)
    st = init_quad13_rti_state(qc, x0, DTYPE)
    safe = cfg.deployed_solver("safe")
    outs = []
    for solver in (safe, dataclasses.replace(safe, lin_backend="jacfwd")):
        u0, _, diag = make_quad13_rti_step(qc, dtype=DTYPE,
                                           solver=solver)(spec, st, x0)
        assert np.isfinite(np.asarray(u0)).all()
        assert float(diag.qp_kkt_eq) < 1e-2
        outs.append(np.asarray(u0))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-3, atol=1e-2)
    # a climb from 1.0 m to 1.4 m asks for more than hover thrust
    assert outs[0].sum() > qc.mass * qc.gravity


def test_soft_tick_deployed_settings():
    """rti_step_soft under the safe profile from outside the hard box:
    finite, and the soft QP reports the stage-1 violation."""
    from mpc_blaster_tpu.dynamics.blaster import BlasterParams, blaster_ode
    from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu.qp.soft import SoftBounds
    from mpc_blaster_tpu.sqp.rti import make_linearizer, rti_step_soft

    ocp = _ocp(cfg.deployed_solver("safe"))
    yref = np.zeros(cfg.NY)
    yref[2] = 2.0
    spec = build_spec(ocp, yref=yref, dtype=DTYPE)
    params = BlasterParams.from_config(ocp.model, DTYPE)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    lin = make_linearizer(ocp, params)
    soft = SoftBounds.state_bounds(N, cfg.NX, cfg.NU, Zl=1e3, zl=1e2,
                                   dtype=DTYPE)
    x0 = jnp.zeros(cfg.NX, DTYPE).at[0].set(2.4).at[2].set(2.0)
    st = init_rti_state(ocp, x0, DTYPE)
    step = jax.jit(lambda sp, s, x: rti_step_soft(
        sp, s, x, params, F, ocp.solver, soft, linearizer=lin))
    for _ in range(3):
        u0, st, diag, res = step(spec, st, x0)
    assert np.isfinite(np.asarray(u0)).all()
    assert np.isfinite(float(total_cost(spec, st.xbar, st.ubar)))
    assert float(res.t_ux[0, 0]) > 0.5


def test_offset_free_tick_deployed_settings():
    """offset_free_loop under the safe profile: the loop runs on the
    rows-form "blaster_dist" linearizer and its observer picks up the
    wind direction."""
    from mpc_blaster_tpu.sim.scenarios import offset_free_loop

    preset = cfg.simulation_preset()
    ocp = _ocp(cfg.deployed_solver("safe"))
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=DTYPE)
    x0 = jnp.zeros(cfg.NX, DTYPE).at[2].set(3.5)
    wind = jnp.asarray([0.7, -0.5, 0.0], DTYPE)
    res = jax.jit(lambda s, x: offset_free_loop(
        s, ocp, x, wind, n_steps=20, dtype=DTYPE))(spec, x0)
    assert np.isfinite(np.asarray(res.xs)).all()
    d = np.asarray(res.d_hist[-1, 0:2])
    assert d[0] > 0.1 and d[1] < -0.1


def test_qp_r_floor_moves_hessian_only():
    """SolverConfig.qp_r_floor raises the QP's control Hessian only: the
    gradient keeps the true R, a zero floor is a bitwise no-op, and a
    floor on the swivel rates lifts exactly those diagonal entries."""
    from mpc_blaster_tpu.dynamics.blaster import BlasterParams, blaster_ode
    from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
    from mpc_blaster_tpu.sqp.rti import build_qp

    preset = cfg.simulation_preset()
    ocp = _ocp(cfg.deployed_solver("safe"))
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=jnp.float64)
    params = BlasterParams.from_config(ocp.model, jnp.float64)
    F = discrete_dynamics(blaster_ode, ocp.dt, num_steps=1)
    x0 = jnp.zeros(cfg.NX, jnp.float64).at[2].set(2.0)
    st = init_rti_state(ocp, x0, jnp.float64)
    base = cfg.deployed_solver("safe")
    floors = {"none": None, "zero": (0.0,) * cfg.NU,
              "swivel": (0.0,) * 4 + (1.0, 1.0)}
    qps = {k: build_qp(spec, st, x0, F, params, solver=dataclasses.replace(
        base, qp_r_floor=v)) for k, v in floors.items()}
    for k in ("zero", "swivel"):
        np.testing.assert_array_equal(np.asarray(qps[k].r),
                                      np.asarray(qps["none"].r))
    np.testing.assert_array_equal(np.asarray(qps["zero"].R),
                                  np.asarray(qps["none"].R))
    d_none = np.diagonal(np.asarray(qps["none"].R), axis1=1, axis2=2)
    d_sw = np.diagonal(np.asarray(qps["swivel"].R), axis1=1, axis2=2)
    np.testing.assert_array_equal(d_sw[:, :4], d_none[:, :4])
    np.testing.assert_allclose(d_sw[:, 4:], float(spec.dt) * 1.0)


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    from mpc_blaster_tpu.utils.cache import compile_cache_dir

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    from mpc_blaster_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = cache.compile_cache_dir()
    assert path == os.path.join(checkout, ".jax_cache")
    assert path == cache.compile_cache_dir()  # no pid, time or temp name
