"""Generate golden closed-loop trajectories (f64 CPU) for regression tests.

The reference repo has no recorded outputs to compare against (SURVEY.md
§6: per-tick times printed and discarded, no benchmark artifacts), so the
golden baseline is this framework's own f64 CPU solution, pinned once and
committed; tests then (a) detect behavioral regressions exactly and (b)
check f32 device runs stay within control tolerance of the pinned f64 truth.

Usage: python scripts/gen_golden.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from mpc_blaster_tpu import config as cfg  # noqa: E402
from mpc_blaster_tpu.sim.closedloop import run_preset  # noqa: E402
from mpc_blaster_tpu.sim.tasks import run_figure8  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "tests", "golden")


def main():
    os.makedirs(OUT, exist_ok=True)

    # simulation preset with the full POC pipeline, 100 ticks
    res = run_preset(cfg.simulation_preset(), n_steps=100,
                     dtype=jnp.float64, with_poc=True)
    np.savez(os.path.join(OUT, "simulation_poc_100.npz"),
             xs=np.asarray(res.xs), us=np.asarray(res.us))

    # flight preset, 100 ticks
    res = run_preset(cfg.flight_preset(), n_steps=100, dtype=jnp.float64)
    np.savez(os.path.join(OUT, "flight_100.npz"),
             xs=np.asarray(res.xs), us=np.asarray(res.us))

    # figure-8 tracking, 120 ticks
    res = run_figure8(n_steps=120, dtype=jnp.float64)
    np.savez(os.path.join(OUT, "figure8_120.npz"),
             xs=np.asarray(res.xs), us=np.asarray(res.us),
             refs=np.asarray(res.refs))
    print("golden trajectories written to", OUT)


if __name__ == "__main__":
    main()
