"""mpc_blaster_tpu — an accelerator-resident nonlinear MPC framework for the
BLASTER quadrotor.

A from-scratch JAX/XLA re-design of the capability surface of the
reference `sml93/mpc_blaster` (CasADi + acados + HPIPM + BLASFEO + ROS):

  - ``core``      rotations, quaternions, nozzle homogeneous-transform chain
  - ``dynamics``  the 17-state rigid-body + gimbal + point-of-contact ODE as a
                  pure function, RK4 discretization, autodiff sensitivities
  - ``poc``       ballistic water-jet point-of-contact solve + Jacobians
                  (closed-form linear-drag trajectory + differentiable Newton)
  - ``ocp``       OCP specification (LINEAR_LS cost, box bounds, horizon)
  - ``qp``        block-structured box-constrained QP: Riccati + primal-dual
                  interior point (the HPIPM replacement)
  - ``sqp``       Gauss-Newton SQP-RTI controller
  - ``sim``       closed-loop simulation harnesses (lax.scan, fully on-device)
  - ``parallel``  vmap/shard_map scenario batching over device meshes
  - ``io``        host-side adapters where the reference's ROS/MAVROS shell sat
  - ``runtime``   native C++ real-time executor + CPU QP fallback (ctypes)
"""

__version__ = "0.1.0"

from mpc_blaster_tpu import config as config  # noqa: F401
