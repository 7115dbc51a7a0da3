"""Task library: figure-8 tracking, blasting with live POC Jacobians."""
import numpy as np
import jax.numpy as jnp
import pytest

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.sim.tasks import figure8_refs, run_blasting, run_figure8
from mpc_blaster_tpu.sim.closedloop import run_preset

DTYPE = jnp.float64


def test_figure8_refs_shape_and_geometry():
    refs = figure8_refs(100, 1 / 30.0, amplitude_x=1.0, amplitude_y=0.75,
                        period_s=12.0, z=2.0)
    assert refs.shape == (100, cfg.NX)
    assert abs(refs[:, 0]).max() <= 1.0 + 1e-9
    np.testing.assert_allclose(refs[:, 2], 2.0)
    # velocity feedforward is the time derivative of position (spot check)
    dt = 1 / 30.0
    v_fd = np.gradient(refs[:, 0], dt)
    np.testing.assert_allclose(refs[5:-5, 6], v_fd[5:-5], atol=2e-3)


def test_figure8_tracking_error_bounded():
    res = run_figure8(n_steps=200, dtype=DTYPE)
    xs, refs = np.asarray(res.xs), np.asarray(res.refs)
    assert np.isfinite(xs).all()
    err = np.linalg.norm(xs[1:, 0:2] - refs[:, 0:2], axis=1)
    # after settling, stay within 15 cm of the moving reference
    assert err[60:].max() < 0.15, err[60:].max()
    assert abs(xs[1:, 2] - 2.0).max() < 0.1


def test_blasting_task_poc_converges():
    res, solver = run_blasting(n_steps=150, dtype=DTYPE)
    xs = np.asarray(res.xs)
    assert np.isfinite(xs).all()
    # position target (0, 0, 3.5); POC target (0.2, 0, 0)
    # (`simulation_blaster.py:48`) — with live Jacobians both are pulled
    # toward their references; poc x must move from 0 toward positive.
    assert abs(xs[-1, 2] - 3.5) < 0.2
    assert xs[-1, 14] > 0.02
    # POC Jacobian at the operating pose: x/y translations map ~1:1
    j_pos = np.asarray(solver.get_jacobians()[2])
    np.testing.assert_allclose(j_pos[0, 0], 1.0, atol=1e-6)


def test_run_preset_with_poc_pipeline():
    """Full simulation_blaster.py parity path: PocSolver -> params -> loop."""
    preset = cfg.simulation_preset()
    res = run_preset(preset, n_steps=60, dtype=DTYPE, with_poc=True)
    xs = np.asarray(res.xs)
    assert np.isfinite(xs).all()
    # with nonzero Jacobians the POC states actually move
    assert np.abs(xs[:, 14:17]).max() > 1e-4


@pytest.mark.slow
def test_online_poc_relinearization():
    """poc_mode='online' (beyond-reference): re-linearize POC every tick;
    runs stably and keeps the POC states evolving."""
    preset = cfg.simulation_preset()
    res = run_preset(preset, n_steps=30, dtype=DTYPE, poc_mode="online")
    xs = np.asarray(res.xs)
    assert np.isfinite(xs).all()
    assert np.abs(xs[:, 14:17]).max() > 1e-4
    # online linearizes at the live pose (starting at z=0), frozen at the
    # reference's canonical pose (z=4): the POC propagation must differ
    frozen = run_preset(preset, n_steps=30, dtype=DTYPE, with_poc=True)
    d = np.abs(np.asarray(frozen.xs)[:, 14] - xs[:, 14])
    assert d.max() > 1e-3


@pytest.mark.slow
def test_blast_scan_true_poc_showcase():
    """The flagship demo (descend-while-washing): under the reference's
    exact configuration — POC Jacobians frozen at the canonical pose AND
    the POC belief propagated by that same linearization with no
    re-evaluation (`simulation_blaster.py:37-39`, SURVEY.md §3.1) — the
    controller *believes* mm-level washing accuracy while the TRUE
    nonlinear jet impact point silently drifts by >5 cm as the altitude
    ramp invalidates the linearization. Per-tick nonlinear POC evaluation
    (plant_poc='exact': poc = solve_poc(pose) each tick, affordable only
    because our closed-form jacfwd solve replaces the reference's 9 FD
    re-integrations) collapses the TRUE error to the mm level.

    Full-scale numbers (N=60, 360 ticks, measured): reference config
    believes 3.5 mm while truly off 135 mm mean / 195 mm max; anchored
    config truly 4.9 mm mean. This test runs a shortened N=30 variant.
    """
    import dataclasses
    from mpc_blaster_tpu.poc.solver import true_poc_traj
    from mpc_blaster_tpu.sim.tasks import run_blast_scan

    preset = cfg.simulation_preset()
    preset = dataclasses.replace(
        preset, ocp=dataclasses.replace(preset.ocp, N=30, Tf=1.0))
    kw = dict(n_steps=200, dtype=DTYPE, frozen_at="canonical",
              z_end=1.5, t_ramp_s=4.0)

    ref_cfg = run_blast_scan(poc_mode="frozen", plant_poc="linear",
                             preset=preset, **kw)
    anchored = run_blast_scan(poc_mode="frozen", plant_poc="exact",
                              preset=preset, **kw)
    s = 60  # settle
    for res in (ref_cfg, anchored):
        assert np.isfinite(np.asarray(res.xs)).all()

    def true_err(res):
        tp = np.asarray(true_poc_traj(res.xs))
        refs = np.asarray(res.refs)
        return np.linalg.norm(tp[1:, 0:2] - refs[:, 14:16], axis=1)

    def belief_err(res):
        xs, refs = np.asarray(res.xs), np.asarray(res.refs)
        return np.linalg.norm(xs[1:, 14:16] - refs[:, 14:16], axis=1)

    # the reference config's belief is a comfortable illusion ...
    assert belief_err(ref_cfg)[s:].mean() < 0.02
    # ... while the TRUE impact point has drifted an order of magnitude
    assert true_err(ref_cfg)[s:].mean() > 0.05
    # per-tick nonlinear POC evaluation makes truth == belief, at mm level
    anchored_true = true_err(anchored)
    np.testing.assert_allclose(anchored_true, belief_err(anchored),
                               atol=1e-6)
    assert anchored_true[s:].mean() < 0.02
    # headline: >=4x physical washing-accuracy improvement
    assert true_err(ref_cfg)[s:].mean() > 4.0 * anchored_true[s:].mean()


def test_poc_mode_selector_picks_measured_winners():
    """The r4 decision rule must pick the measured-best mode on BOTH
    bench scan profiles (bench.py blast rows: gentle -> frozen 0.0050
    beats stagewise 0.0081; aggressive -> stagewise 0.1386 beats frozen
    0.2881)."""
    from mpc_blaster_tpu.sim.tasks import select_poc_mode

    # gentle default scan (bench kwb config)
    assert select_poc_mode(z_end=1.5, t_ramp_s=6.0) == "frozen"
    # aggressive scan (bench kwa config)
    assert select_poc_mode(z_end=1.2, t_ramp_s=4.0, amp_x=1.1,
                           amp_y=0.45, period_s=24.0) == "online_stagewise"
    # pure hover wash with no descent: frozen
    assert select_poc_mode() == "frozen"
    # extra kwargs from run_blast_scan's scan_kwargs are tolerated
    assert select_poc_mode(center=(-0.6, 0.0), hover=(0.0, 0.0, 3.5),
                           z_end=1.5, t_ramp_s=6.0) == "frozen"


def test_carry_frac_selector_and_refs():
    """r5: the co-moving-reference decision rule + feedforward geometry.
    Measured calibration (aggressive bench profile): carry 0.0 -> 0.140 m, 0.3 -> 0.039, 0.6 -> 0.023
    (best), 1.0 -> 0.084 (over-driven); gentle profile: carry 0.6 HURTS
    (0.005 -> 0.016) so it stays off below the 0.8 m/s staleness rate."""
    from mpc_blaster_tpu.sim.tasks import (blast_scan_refs,
                                           select_carry_frac)

    assert select_carry_frac(z_end=1.5, t_ramp_s=6.0) == 0.0
    assert select_carry_frac(z_end=1.2, t_ramp_s=4.0, amp_x=1.1,
                             amp_y=0.45, period_s=24.0) == 0.6

    dt = 1.0 / 30.0
    kw = dict(amp_x=1.1, amp_y=0.45, period_s=24.0, z_end=1.2,
              t_ramp_s=4.0)
    r0 = blast_scan_refs(200, dt, **kw)
    rc = blast_scan_refs(200, dt, carry_frac=0.6, **kw)
    # position ref follows 0.6x the poc deviation from its center
    dev = r0[:, 14:16] - np.array([-0.6, 0.0])[None]
    np.testing.assert_allclose(rc[:, 0:2] - r0[:, 0:2], 0.6 * dev,
                               atol=1e-9)
    # velocity feedforward is the time derivative of the added motion
    np.testing.assert_allclose(
        rc[:-1, 6:8] - r0[:-1, 6:8],
        0.6 * np.diff(r0[:, 14:16], axis=0) / dt, atol=1e-6)
    # poc refs and altitude untouched
    np.testing.assert_array_equal(rc[:, 14:17], r0[:, 14:17])
    np.testing.assert_array_equal(rc[:, 2], r0[:, 2])


@pytest.mark.slow
def test_carry_improves_aggressive_scan():
    """r5 headline A/B at reduced length: the co-moving reference must
    beat the fixed hover reference by >=2x true-POC error on the
    aggressive profile (full-length measured: 6x, 0.140 -> 0.023)."""
    from mpc_blaster_tpu.poc.solver import true_poc_traj
    from mpc_blaster_tpu.sim.tasks import run_blast_scan

    kw = dict(n_steps=150, dtype=jnp.float32, z_end=1.2, t_ramp_s=4.0,
              amp_x=1.1, amp_y=0.45, period_s=24.0,
              frozen_at="canonical")

    def err(carry):
        res = run_blast_scan(poc_mode="online_stagewise",
                             plant_poc="exact", carry_frac=carry, **kw)
        tp = np.asarray(true_poc_traj(res.xs))
        refs_b = np.asarray(res.refs)
        terr = np.linalg.norm(tp[1:, 0:2] - refs_b[:, 14:16], axis=1)
        return terr[60:].mean()

    e0, ec = err(0.0), err(0.6)
    assert ec < 0.5 * e0, (e0, ec)
    assert ec < 0.08, ec
