"""Scenario-parallel scaling: vmap batching + shard_map over device meshes.

The reference is single-process/single-thread (SURVEY.md §2.3) — its only
scaling story is BLASFEO assembly inside one QP. This framework scales
along the *scenario* axis (disturbance draws, waypoint targets, gain
sweeps; BASELINE.md configs 4-5):

  - `vmap` turns the single-trajectory RTI tick into a batched tick whose
    tiny per-scenario matrices batch into wide device ops;
  - `shard_map` over a 1-D "dp" device mesh splits the batch across
    devices; per-scenario QP solves are fully local (zero communication),
    and only sweep *reductions* (mean cost, max KKT residual) cross the
    device interconnect via pmean/pmax.

Multi-host: `jax.distributed.initialize()` + the same code — jax.devices()
then spans hosts and shard_map shards globally.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from mpc_blaster_tpu import config as cfg
from mpc_blaster_tpu.ocp.spec import OCPSpec
from mpc_blaster_tpu.sqp.rti import RTIState, make_rti_step


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp") -> Mesh:
    """1-D data-parallel mesh over the first n_devices devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    import numpy as np
    return Mesh(np.asarray(devs), (axis,))


def batched_rti_step(ocp: cfg.OCPConfig, dtype=jnp.float32, jit: bool = True):
    """vmap the RTI tick over a scenario batch.

    Returns step(spec, states, x0s) -> (u0s, states, diags); `spec` is
    shared (broadcast), states/x0s carry a leading batch axis. Use
    jax.vmap over spec too if per-scenario costs/targets differ.
    """
    step = make_rti_step(ocp, dtype=dtype, jit=False)
    batched = jax.vmap(step, in_axes=(None, 0, 0))
    return jax.jit(batched) if jit else batched


def batched_rti_step_per_scenario_spec(ocp: cfg.OCPConfig, dtype=jnp.float32,
                                       jit: bool = True):
    """Like `batched_rti_step` but with per-scenario OCPSpec (targets/gains
    sweeps: BASELINE.md config 5)."""
    step = make_rti_step(ocp, dtype=dtype, jit=False)
    batched = jax.vmap(step, in_axes=(0, 0, 0))
    return jax.jit(batched) if jit else batched


def sharded_rti_step(ocp: cfg.OCPConfig, mesh: Mesh, dtype=jnp.float32,
                     axis: str = "dp"):
    """shard_map the batched tick over the mesh's data axis.

    The batch axis of (states, x0s) is sharded; the OCPSpec is replicated.
    Per-shard computation is completely local; the returned diagnostics
    include a psum'd global mean cost-to-go proxy so callers see one number
    per sweep without gathering trajectories.
    """
    step = make_rti_step(ocp, dtype=dtype, jit=False)
    vstep = jax.vmap(step, in_axes=(None, 0, 0))

    def shard_fn(spec, states, x0s):
        u0s, new_states, diags = vstep(spec, states, x0s)
        # Global reductions: mean step norm + worst KKT residual.
        mean_step = jax.lax.pmean(jnp.mean(diags.step_norm_u), axis)
        worst_kkt = jax.lax.pmax(jnp.max(diags.qp_kkt_stat), axis)
        return u0s, new_states, mean_step, worst_kkt

    state_specs = RTIState(xbar=P(axis), ubar=P(axis))
    diag_out = (P(axis), state_specs, P(), P())
    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), state_specs, P(axis)),
        out_specs=diag_out,
    )
    return jax.jit(fn)


def sharded_sweep(ocp: cfg.OCPConfig, mesh: Mesh, n_steps: int,
                  dtype=jnp.float32, axis: str = "dp"):
    """Closed-loop scenario sweep sharded across devices.

    run(spec, x0s) -> (final states (B, nx), mean final position error,
    solves/s is measured by the caller). The whole Nsim x batch rollout
    stays on device; only scalar reductions communicate.
    """
    from mpc_blaster_tpu.sim.closedloop import closed_loop

    def one(spec, x0):
        res = closed_loop(spec, ocp, x0, n_steps, dtype=dtype)
        return res.xs[-1], res.us[0], jnp.max(res.kkt_eq)

    vone = jax.vmap(one, in_axes=(None, 0))

    def shard_fn(spec, x0s):
        finals, u0s, kkts = vone(spec, x0s)
        err = finals[:, 0:3] - spec.yref_x[-1, 0:3]
        mean_err = jax.lax.pmean(jnp.mean(jnp.linalg.norm(err, axis=-1)), axis)
        worst_kkt = jax.lax.pmax(jnp.max(kkts), axis)
        return finals, u0s, mean_err, worst_kkt

    fn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=(P(axis), P(axis), P(), P()),
    )
    return jax.jit(fn)
