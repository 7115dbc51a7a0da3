"""Flagship demo: descend-while-washing with TRUE-POC accounting.

The quadrotor descends from 3.5 m to 1.5 m while the water jet traces a
figure-8 on the ground. Three controller configurations:

  reference-config : POC Jacobians frozen at the canonical pose AND the
                     POC belief propagated by that same linearization —
                     exactly the reference's `simulation_blaster.py`
                     behavior (Jacobians solved once before the loop,
                     `:37-39`; plant == model). Its *belief* tracks at
                     mm level while the TRUE impact point drifts >10 cm.
  anchored         : per-tick nonlinear POC evaluation (closed-form jet
                     solve at the live pose) replaces the drifting belief.
  online+anchored  : additionally re-linearizes dPOC/d(alpha,euler,p) at
                     the live pose every tick.

Writes docs/blast_scan.png and prints a JSON summary.

Runs in float32 on a GPU and in float64 elsewhere (CPU, ~2 min):
    python examples/blast_scan_demo.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

ON_GPU = jax.devices()[0].platform == "gpu"
if not ON_GPU:
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mpc_blaster_tpu.poc.solver import true_poc_traj  # noqa: E402
from mpc_blaster_tpu.utils.cache import enable_compile_cache  # noqa: E402
from mpc_blaster_tpu.sim.plots import plot_blast_scan  # noqa: E402
from mpc_blaster_tpu.sim.tasks import run_blast_scan  # noqa: E402


def main():
    enable_compile_cache()
    dtype = jnp.float32 if ON_GPU else jnp.float64
    # 1260 ticks = 42 s = one full lemniscate period after the descent
    kw = dict(n_steps=1260, dtype=dtype, z_end=1.5, t_ramp_s=6.0)
    configs = {
        "reference-config": dict(poc_mode="frozen", plant_poc="linear",
                                 frozen_at="canonical"),
        "anchored": dict(poc_mode="frozen", plant_poc="exact",
                         frozen_at="canonical"),
        "online+anchored": dict(poc_mode="online", plant_poc="exact"),
    }
    results, summary = {}, {}
    for label, c in configs.items():
        res = run_blast_scan(**c, **kw)
        results[label] = res
        tp = np.asarray(true_poc_traj(jnp.asarray(res.xs)))
        refs = np.asarray(res.refs)
        terr = np.linalg.norm(tp[1:, 0:2] - refs[:, 14:16], axis=1)
        berr = np.linalg.norm(np.asarray(res.xs)[1:, 14:16]
                              - refs[:, 14:16], axis=1)
        summary[label] = {
            "true_poc_err_mean_m": round(float(terr[90:].mean()), 4),
            "true_poc_err_max_m": round(float(terr[90:].max()), 4),
            "believed_err_mean_m": round(float(berr[90:].mean()), 4),
        }
        print(f"{label}: {summary[label]}", flush=True)

    out = os.path.join(os.path.dirname(__file__), "..", "docs",
                       "blast_scan.png")
    plot_blast_scan(results, path=os.path.abspath(out), settle=90)
    summary["improvement_x"] = round(
        summary["reference-config"]["true_poc_err_mean_m"]
        / summary["anchored"]["true_poc_err_mean_m"], 1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
