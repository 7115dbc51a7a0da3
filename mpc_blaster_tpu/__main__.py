"""Build-sanity smoke run: `python -m mpc_blaster_tpu`.

Parity with the reference's `python blastermodel.py` (`blastermodel.py:294-318`):
construct the smoke-preset model + controller, run one RTI tick, and print
the body rotation at a sample attitude (the reference prints the symbolic R).
No codegen, no compilers shelling out — one jit compile.
"""
import numpy as np

import jax
import jax.numpy as jnp

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.core.rotations import euler_zyx_to_rot
from mpc_blaster_tpu.ocp.spec import build_spec
from mpc_blaster_tpu.sqp.rti import init_rti_state, make_rti_step


def main():
    preset = cfg.smoke_preset()
    ocp = preset.ocp
    print(f"BLASTER MPC smoke build: N={ocp.N} Tf={ocp.Tf} "
          f"mass={ocp.model.mass} on {jax.devices()[0]}")
    spec = build_spec(ocp)
    step = make_rti_step(ocp)
    x0 = jnp.zeros(cfg.NX).at[2].set(1.0)
    state = init_rti_state(ocp, x0)
    u0, state, diag = step(spec, state, x0)
    print("one RTI tick: u0 =", np.asarray(u0).round(4),
          " qp_eq = %.2e" % float(diag.qp_kkt_eq))
    R = euler_zyx_to_rot(jnp.asarray([0.1, -0.2, 0.3]))
    print("R(0.1, -0.2, 0.3) =\n", np.asarray(R).round(5))


if __name__ == "__main__":
    main()
