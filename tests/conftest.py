"""Test configuration: run everything on a virtual 8-device CPU mesh with f64.

The reference has no tests at all (see SURVEY.md §4); our strategy is:
  - unit tests of dynamics/kinematics vs scipy f64 references,
  - FD-vs-autodiff Jacobian checks,
  - QP KKT-residual tests,
  - SQP convergence + golden closed-loop trajectories,
  - sharding tests on a fake 8-device CPU mesh.

The platform is pinned to the CPU here as well as by the documented
`JAX_PLATFORMS=cpu`, so a plain `pytest` never touches an accelerator.
Tests that need the card carry the `gpu` marker and run inside
`chip_smoke.py`'s process on the card (one JAX process per card).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Opt-in persistent compilation cache for repeat local runs (the XLA:CPU
# AOT loader warns noisily when reloading, so it stays off by default;
# enable with MPC_TEST_CACHE=1 when iterating).
if os.environ.get("MPC_TEST_CACHE"):
    from mpc_blaster_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
