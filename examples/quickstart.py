"""Quickstart: the three reference workflows + two beyond-reference ones.

Run:  python examples/quickstart.py
(JAX picks the accelerator if there is one; JAX_PLATFORMS=cpu pins the CPU)
"""
import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.utils.cache import enable_compile_cache
from mpc_blaster_tpu.poc.solver import PocSolver
from mpc_blaster_tpu.sim.closedloop import run_preset
from mpc_blaster_tpu.sim.tasks import run_figure8
from mpc_blaster_tpu.sim.scenarios import disturbance_sweep, sample_scenarios
from mpc_blaster_tpu.ocp.spec import build_spec
from mpc_blaster_tpu.io.flight import FlightNode


def main():
    enable_compile_cache()
    # 1. The jet POC solve (Jacobian_POC_Solver.py workflow)
    solver = PocSolver(150.0, 1.0).initialise()
    j_mot, j_eul, j_pos = solver.get_jacobians()
    print("POC:", np.asarray(solver.poc).round(4),
          "impact T:", float(solver.time_of_impact))

    # 2. The offline closed-loop sim (simulation_blaster.py workflow)
    res = run_preset(cfg.simulation_preset(), n_steps=120, with_poc=True)
    print("sim preset: z(end) = %.3f (target 3.5), worst QP eq residual %.1e"
          % (float(res.xs[-1, 2]), float(jnp.max(res.kkt_eq))))

    # 3. The flight node (mavros_blaster_sim.py workflow, ROS-free)
    node = FlightNode()
    node.run(n_steps=10)
    print("flight node: %d AttitudeTarget msgs, final thrust setpoint %.3f"
          % (len(node.adapter.messages), node.adapter.messages[-1].thrust))

    # 4. Beyond reference: figure-8 waypoint tracking
    trk = run_figure8(n_steps=120)
    err = np.linalg.norm(np.asarray(trk.xs)[1:, 0:2]
                         - np.asarray(trk.refs)[:, 0:2], axis=1)
    print("figure-8: worst xy tracking error after settle = %.3f m"
          % err[40:].max())

    # 5. Beyond reference: wind-disturbance robustness sweep
    preset = cfg.simulation_preset()
    spec = build_spec(preset.ocp, yref=preset.loop.yref)
    scen = sample_scenarios(batch=8, seed=0, wind_max=0.8)
    sweep = disturbance_sweep(spec, preset.ocp, scen, n_steps=100)
    print("wind sweep: %d/%d scenarios settled within 25 cm, max err %.3f m"
          % (int(np.sum(np.asarray(sweep.settled))), 8,
             float(np.max(np.asarray(sweep.pos_err)))))

    # 6. Beyond reference: offset-free MPC (disturbance observer) — the
    # same sweep with the velocity-residual observer feeding the
    # prediction model: every scenario settles to mm level.
    sweep_of = disturbance_sweep(spec, preset.ocp, scen, n_steps=150,
                                 offset_free=True)
    print("wind sweep (offset-free): %d/%d settled, max err %.3f m"
          % (int(np.sum(np.asarray(sweep_of.settled))), 8,
             float(np.max(np.asarray(sweep_of.pos_err)))))


if __name__ == "__main__":
    main()
