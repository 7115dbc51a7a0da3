"""Offset-free deployment demo (r4): constant wind the controller cannot
see, learned online by the force+torque observer, compensated through the
"blaster_dist" prediction model (the disturbance estimates ride
stage-parameter rows 25:31 as *data*, so one compiled tick serves every
estimate).

The reference flight node has no state feedback at all (it integrates its
own model open-loop, `mavros_blaster_sim.py:109-118`); this is the
capability gap that matters most in real wind. The demo runs the sim
preset at N=30 (see the comment in main() for the horizon-stability
correction).

Run (~2 min on the CPU):  python examples/offset_free_demo.py
"""
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.ocp.spec import build_spec
from mpc_blaster_tpu.sim.scenarios import offset_free_loop
from mpc_blaster_tpu.utils.cache import enable_compile_cache


def main():
    enable_compile_cache()
    # SIM preset at N=30 — inside its stable envelope. (r5 correction:
    # the r4 claim that the sim preset's R_swivel=1e-5 makes wind
    # compensation hunt was wrong — the hunt is a SHORT-HORIZON artifact
    # of truncating the preset to N=20; neither raising R_swivel nor a
    # QP-only Hessian floor fixes N=20, while N >= 24 settles to
    # millimeters with the original weights. For genuinely short
    # horizons use the DARE terminal cost,
    # `ocp/terminal.py::lqr_terminal_weight`. See CLAUDE.md.)
    preset = cfg.simulation_preset()
    n = 30
    wind = jnp.asarray([0.7, -0.5, 0.2], jnp.float32)  # m/s^2, unseen
    x0 = jnp.zeros(cfg.NX, jnp.float32).at[2].set(3.0)
    out = {}

    ocp = dataclasses.replace(
        preset.ocp, N=n, Tf=n / 30.0,
        solver=dataclasses.replace(preset.ocp.solver,
                                   qp_backend="riccati", ipm_iters=8))
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=jnp.float32)
    target = np.asarray(spec.yref_x[0, 0:3])
    for name, gain in (("blind", 0.0), ("offset_free", 0.5)):
        res = jax.jit(lambda s, x, g=gain: offset_free_loop(
            s, ocp, x, wind, n_steps=250, observer_gain=g))(spec, x0)
        xs = np.asarray(res.xs)
        err = float(np.linalg.norm(xs[-1, 0:3] - target))
        out[name] = {
            "final_pos_err_m": round(err, 4),
            "wind_estimate": [round(float(v), 3)
                              for v in np.asarray(res.d_hist[-1, 0:3])],
            "finite": bool(np.isfinite(xs).all()),
        }
        print(f"{name}: settle err {err:.3f} m, "
              f"d_est {out[name]['wind_estimate']}", flush=True)

    # the observer must beat the blind loop by a wide margin
    # (measured: 0.005 m vs 0.231 m steady offset, sim preset N=30)
    assert out["offset_free"]["final_pos_err_m"] \
        < 0.2 * out["blind"]["final_pos_err_m"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
