"""Deployment profiles demo: the latency/quality trade-offs by name, plus
the PX4-wire flight shell.

Profiles (config.deployed_solver; all three run the XLA Riccati IPM with
the component-form linearizer):

  safe     cold 6-iteration ticks
  fast     cold 4-iteration ticks
  fastest  3-iteration shifted primal-recentered warm chain + watchdog

All three pass the altitude-step transient stress that diverges RAW
(unshifted) warm chains by hundreds of meters — the shift is the
load-bearing repair (see ROADMAP.md's warm-start decision table), and
since r4 "fastest" additionally carries the ONLINE divergence watchdog
(SolverConfig.warm_watchdog -> sqp/rti.py::rti_step_warm_guarded): a
tick whose diagnostics jump is recomputed cold and the chain held cold
with escalating holds, so the profile is safe by construction.

Run (~2 min on the CPU):  python examples/deployed_profiles_demo.py
"""
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.ocp.spec import build_spec
from mpc_blaster_tpu.sim.closedloop import make_closed_loop
from mpc_blaster_tpu.utils.cache import enable_compile_cache


def main():
    enable_compile_cache()
    dtype = jnp.float32
    preset = cfg.simulation_preset()
    ocp = dataclasses.replace(preset.ocp, N=20, Tf=20 / 30.0)
    spec = build_spec(ocp, yref=preset.loop.yref, dtype=dtype)
    x0 = jnp.zeros(cfg.NX, dtype).at[2].set(0.5)  # 3 m altitude step

    out = {}
    for profile in ("safe", "fast", "fastest"):
        solver = cfg.deployed_solver(profile)
        ocp_p = dataclasses.replace(ocp, solver=solver)
        run = make_closed_loop(ocp_p, 150, dtype=dtype,
                               warm_start=solver.warm_shift)
        res = run(spec, x0)
        z = np.asarray(res.xs[:, 2])
        out[profile] = {
            "iters": solver.ipm_iters,
            "warm": bool(solver.warm_shift),
            "overshoot_m": round(float(max(z.max() - 3.5, 0.0)), 4),
            "settle_err_m": round(float(abs(z[100:] - 3.5).max()), 4),
            "finite": bool(np.isfinite(np.asarray(res.xs)).all()),
        }
        print(f"{profile}: {out[profile]}")

    # The same controller drives the PX4-byte-compatible flight shell:
    from mpc_blaster_tpu.io.flight import FlightNode
    from mpc_blaster_tpu.io.transport import UdpAttitudeAdapter, UdpEndpoint
    endpoint = UdpEndpoint(wire="mavlink2").start()
    adapter = UdpAttitudeAdapter(("127.0.0.1", endpoint.port),
                                 recv_port=0, wire="mavlink2")
    node = FlightNode(dtype=dtype, adapter=adapter)
    node.run(n_steps=5)
    import time
    time.sleep(0.3)
    out["mavlink_frames"] = len(endpoint.received)
    print(f"PX4-wire loopback: {len(endpoint.received)} SET_ATTITUDE_TARGET "
          f"frames received, {endpoint.bad_frames} bad")
    adapter.close()
    endpoint.stop()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
