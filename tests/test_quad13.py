"""13-state quaternion quadrotor model on the generic solver stack."""
import numpy as np
import jax.numpy as jnp

from mpc_blaster_tpu.dynamics.blaster import BlasterParams
from mpc_blaster_tpu.dynamics.integrators import discrete_dynamics
from mpc_blaster_tpu.models.quad13 import (
    QUAD13_NU,
    QUAD13_NX,
    Quad13Config,
    build_quad13_spec,
    hover_state,
    init_quad13_rti_state,
    make_quad13_rti_step,
    quad13_ode,
)

DTYPE = jnp.float64


def test_quad13_hover_equilibrium():
    c = Quad13Config()
    from mpc_blaster_tpu.models.quad13 import _params
    params = _params(c, DTYPE)
    x = hover_state(2.0, DTYPE)
    u = jnp.full((QUAD13_NU,), c.mass * c.gravity / 4.0, DTYPE)
    xdot = np.asarray(quad13_ode(x, u, jnp.zeros(1, DTYPE), params))
    np.testing.assert_allclose(xdot, 0.0, atol=1e-12)


def test_quad13_quaternion_norm_preserved_short_term():
    c = Quad13Config()
    from mpc_blaster_tpu.models.quad13 import _params
    params = _params(c, DTYPE)
    F = discrete_dynamics(quad13_ode, c.dt, num_steps=1)
    x = hover_state(2.0, DTYPE).at[10].set(0.3)  # roll rate
    u = jnp.full((QUAD13_NU,), c.mass * c.gravity / 4.0, DTYPE)
    for _ in range(30):
        x = F(x, u, jnp.zeros(1, DTYPE), params)
    assert abs(float(jnp.linalg.norm(x[3:7])) - 1.0) < 1e-6


def test_quad13_rti_converges_to_hover():
    c = Quad13Config()
    spec = build_quad13_spec(c, target_pos=(0.0, 0.0, 2.0), dtype=DTYPE)
    step = make_quad13_rti_step(c, dtype=DTYPE)
    x0 = hover_state(1.5, DTYPE)  # start 0.5 m below target
    st = init_quad13_rti_state(c, x0, DTYPE)
    from mpc_blaster_tpu.models.quad13 import _params
    params = _params(c, DTYPE)
    F = discrete_dynamics(quad13_ode, c.dt, num_steps=1)
    x = x0
    for _ in range(60):
        u0, st, diag = step(spec, st, x)
        x = F(x, u0, jnp.zeros(1, DTYPE), params)
    x = np.asarray(x)
    assert abs(x[2] - 2.0) < 0.05, x[0:3]
    assert abs(np.linalg.norm(x[3:7]) - 1.0) < 1e-3
    np.testing.assert_allclose(x[7:10], 0.0, atol=0.05)
